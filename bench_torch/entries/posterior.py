"""Posterior cells: the window drives the scale-out example's calls,
``kernel_features`` over the training and test rows, then
``parallel.blocked.gp_posterior_large`` with the configuration's CG
settings. A unit is one posterior, mean and variance at every test point.

Set-up draws a pool of inputs (rows, targets and theta) from the seed and
puts them on the device; unit j takes draw j of the pool, round and round.

The check takes one posterior of the window, drawn from the seed, and the
reference's exact posterior of the same draw (a dense float64 Cholesky of
the Gram of the reference's own features):

* ``mean``: the worst gap over test points, relative to that point's
  reference mean or the median one's magnitude, whichever is larger;
* ``var``: the same for the variances.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import reference as R
from .. import traffic
from .train import program_spec

POOL = 12
WARM_CG_ITERS = 2


class Entry:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, int(seed), torch.device(device)
        self.spec = program_spec(cfg)
        self.post = cfg["posterior"]
        dev = self.device
        self.pool = []
        for j in range(int(wl.get("pool", POOL))):
            X, Y, theta = traffic.posterior_data(cfg, seed, j)
            self.pool.append((X, Y, theta, torch.as_tensor(X, device=dev),
                              torch.as_tensor(Y, device=dev), torch.as_tensor(theta, device=dev)))
        X, Y, theta = traffic.posterior_data(cfg, seed, 1 << 20)
        self.warm = (X, Y, theta, torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev),
                     torch.as_tensor(theta, device=dev))

    def run(self, draw, cg_maxiter: int = None) -> dict:
        from dqgp_tpu_torch.models.kernels.quantum_kernel import kernel_features
        from dqgp_tpu_torch.parallel.blocked import gp_posterior_large

        p, n = self.post, self.post["train_rows"]
        maxiter = p["cg_maxiter"] if cg_maxiter is None else cg_maxiter
        _, _, _, X, Y, theta = draw
        F = kernel_features(self.spec, X, theta)
        mean, var, res = gp_posterior_large(
            self.spec, F[:n], Y, F[n:], noise_std=p["noise_std"], jitter=p["jitter"],
            block=p["block"], cg_tol=p["cg_tol"], cg_maxiter=maxiter,
            precond_rank=p["precond_rank"])
        return {"cg_iterations": int(res.iterations), "residual": float(res.residual_norm),
                "mean": mean, "var": var,
                "finite": bool(torch.isfinite(mean).all() and torch.isfinite(var).all())}

    def warm_up(self) -> None:
        # every CG iteration has the same shapes: two of each solve build
        # them all
        self.run(self.warm, cg_maxiter=WARM_CG_ITERS)

    def unit(self, j: int) -> dict:
        out = self.run(self.pool[j % len(self.pool)])
        out["draw"] = j % len(self.pool)
        return out

    def work(self, result: dict) -> int:
        return 1

    def describe(self, results) -> str:
        return f"CG iterations {[r['cg_iterations'] for r in results]}"

    def check(self, results, limits: dict) -> dict:
        pick = int(traffic.rng_for(self.seed, 2).integers(len(results)))
        res = results[pick]
        mean = res["mean"].double().cpu().numpy()
        var = res["var"].double().cpu().numpy()
        for r in results:  # the program's outputs leave the device first
            r.pop("mean", None), r.pop("var", None)
        X, Y, theta = self.pool[res["draw"]][:3]
        self.pool = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None
        ref_mean, ref_var = exact_posterior(self.cfg, self.post, X, Y, theta, self.device)
        return {"mean": {"value": worst_gap(mean, ref_mean), "limit": limits["mean"]},
                "var": {"value": worst_gap(var, ref_var), "limit": limits["var"]}}


def worst_gap(got: np.ndarray, want: np.ndarray) -> float:
    scale = np.maximum(np.abs(want), np.median(np.abs(want)))
    return float(np.max(np.abs(got - want) / scale))


def exact_posterior(cfg: dict, p: dict, X, Y, theta, device, real=torch.float32,
                    gp=torch.float64):
    """The reference's posterior of one draw: its own features in ``real``,
    the Grams and the dense solve in ``gp``."""
    n = p["train_rows"]
    circ = R.Circuit(cfg["circuit"], device)
    F = circ.features(torch.as_tensor(X, device=device),
                      torch.as_tensor(theta, device=device), real).to(gp)
    Ftr, Fte = F[:n], F[n:]
    K = R.gram(cfg["kernel"], Ftr, Ftr)
    Ks = R.gram(cfg["kernel"], Fte, Ftr)
    mean, var = R.posterior(K, Ks, torch.ones(len(Fte), dtype=gp, device=device),
                            torch.as_tensor(Y, device=device).to(gp),
                            p["noise_std"] ** 2 + p["jitter"])
    return mean.double().cpu().numpy(), var.double().cpu().numpy()
