"""Training cells: the window drives ``dqgp_tpu_torch.driver.train``, the
entry the port's CLI calls. A unit is one training run of the workload's
``iters`` iterations from a seeded start; its stopping rules are evaluated
but cannot fire (``tolerance=0``, ``cv_patience=iters``), so every run does
the same work.

The check follows the first ``ref_steps`` iterations of one run of the
window, drawn from the seed, with the plain reference:

* ``loss``: every agent's NLL at the run's own z of each step, the worst
  gap over agents and steps, relative to that agent's reference NLL or the
  median agent's, whichever is larger;
* ``cv``: the mean CV NLPD at the run's own z of each step, the worst gap,
  relative to max(|reference|, 1);
* ``step``: the consensus' change after each of the steps, from the
  seeded start, as the run's z and the reference's own chain (its own
  gradients and updates) give it: the gap of the norms relative to the
  reference's norm; the first is the first gradient as the consensus takes
  it, the last the parameters' change after them all;
* ``cond`` (where the configuration computes condition numbers): the
  host backfill's value of every agent at each step's z against the
  reference's float64 eigenvalues, relative, where the reference reads
  below 1e8; above it, 0 in the same bucket (1e12, 1e15) and 1 otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import reference as R
from .. import traffic

BUCKETS = (1e8, 1e12, 1e15)
COND_CHUNK = 16  # the z rows a chunk of driver.host_condition_numbers


def program_spec(cfg: dict):
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec

    c, k = cfg["circuit"], cfg["kernel"]
    circuit = build_circuit(c["family"], c["qubits"], c["features"], c["layers"])
    if circuit.num_gates != len(c["gates"]) or circuit.num_parameters != c["parameters"]:
        raise RuntimeError(f"the program's {c['family']} circuit is not the configuration's")
    if (k["length_scale"], k["nu"]) != (1.0, 1.5):
        raise ValueError("the program's Matern takes its defaults, length 1 and nu 1.5")
    return QuantumKernelSpec(circuit=circuit, kernel_type=k["type"], outer_kernel=k["outer"],
                             measurement=k["measurement"])


class Entry:
    """One training cell: its data, the program's settings, and its runs."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, overrides=None):
        from dqgp_tpu_torch.driver import TrainConfig

        self.cfg, self.wl, self.seed, self.device = cfg, wl, int(seed), torch.device(device)
        self.spec = program_spec(cfg)
        self.splits, self.X, self.Y = traffic.training_data(cfg, seed)
        tr = cfg["train"]
        self.iters = int(wl.get("iters", tr["max_iter"]))
        settings = dict(max_iter=self.iters, tolerance=0.0, cv_patience=self.iters,
                        rho=tr["rho"], L=tr["L"], noise_std=tr["noise_std"],
                        cv_folds=tr["cv_folds"], grad_method=tr["grad_method"],
                        gp_dtype=tr["gp_dtype"], cv_dtype=tr["cv_dtype"],
                        cv_max_samples=tr["cv_max_samples"], compute_cond=tr["compute_cond"],
                        shift_value=tr["shift"], chain_iters=int(wl.get("chain_iters", 1)),
                        verbose=False)
        settings.update(overrides or {})
        self.settings = settings
        self.TrainConfig = TrainConfig

    def run(self, admm_seed: int, iters: int = None) -> dict:
        """One training run (of ``iters`` iterations, or the workload's);
        what the check and the metrics read of it."""
        from dqgp_tpu_torch.driver import train

        settings = dict(self.settings)
        if iters is not None:
            settings.update(max_iter=iters, cv_patience=iters)
        cfg = self.TrainConfig(seed=int(admm_seed), **settings)
        r = train(self.spec, self.splits, self.X, self.Y, cfg, device=self.device)
        nll = np.array([h["agent_losses"] for h in r.nll_history], np.float64)
        return {
            "admm_seed": int(admm_seed),
            "iterations": int(r.iterations),
            "z": np.array([h["consensus_params"] for h in r.cv_history], np.float64),
            "nll": nll,
            "cv": np.array([h["consensus_cv_score"] for h in r.cv_history], np.float64),
            "cond": np.array([h["condition_numbers"] for h in r.nll_history], np.float64),
            "cond_backfill_s": r.cond_backfill_time,
            "finite": bool(np.all(np.isfinite(nll))),
        }

    def warm_iterations(self) -> int:
        """The warm-up run's iterations: the step and the CV twice, a capture
        and a replay where the run chains iterations, and where it
        backfills condition numbers, the backfill's chunks of a whole run
        (a full one and the run's last, shorter one)."""
        n = max(2, self.settings["chain_iters"] + 1)
        if self.settings["compute_cond"]:
            n = max(n, COND_CHUNK + self.iters % COND_CHUNK)
        return min(n, self.iters)

    def warm_up(self) -> None:
        self.run(traffic.small_seed(self.seed, 3), self.warm_iterations())

    def unit(self, j: int) -> dict:
        return self.run(traffic.small_seed(self.seed, 4, j))

    def work(self, result: dict) -> int:
        """Iterations a unit completed."""
        return result["iterations"]

    def describe(self, results) -> str:
        backfill = [r["cond_backfill_s"] for r in results if r["cond_backfill_s"] is not None]
        return f"backfill s {backfill}" if backfill else "no backfill"

    def check(self, results, limits: dict) -> dict:
        """The numbers compared, each {"value", "limit"}, for one run of
        the window drawn from the seed."""
        pick = int(traffic.rng_for(self.seed, 2).integers(len(results)))
        return compare(self.cfg, self.wl, self.splits, self.X, self.Y, results[pick],
                       self.device, limits)


def cv_rows(X, Y, cfg, admm_seed):
    """The rows the program's CV scores: all, or its seeded subsample
    (``RandomState(seed).choice``, as the upstream driver draws it)."""
    n = cfg["train"]["cv_max_samples"]
    if n and len(X) > n:
        sel = np.random.RandomState(admm_seed).choice(len(X), n, replace=False)
        return X[sel], Y[sel]
    return X, Y


def _bucket(c: float) -> int:
    return sum(c >= b for b in BUCKETS) if np.isfinite(c) else len(BUCKETS)


def compare(cfg, wl, splits, X, Y, res: dict, device, limits: dict) -> dict:
    """The reference against one run's first ``ref_steps`` iterations."""
    steps = int(wl["ref_steps"])
    kernel, tr = cfg["kernel"], cfg["train"]
    circ = R.Circuit(cfg["circuit"], device)
    ag = R.Agents(splits, device)
    admm = {"rho": tr["rho"], "L": tr["L"], "noise_std": tr["noise_std"]}
    chain = R.follow(circ, kernel, ag, admm, res["admm_seed"], steps)
    out = {}

    loss = 0.0
    for k in range(steps):
        zk = torch.as_tensor(res["z"][k], device=device)
        if np.array_equal(res["z"][k], chain["z"][k]):
            ref = chain["nll"][k]
        else:
            ref = R.agent_nll(circ, kernel, ag, zk, tr["noise_std"])[0].cpu().numpy()
        scale = np.maximum(np.abs(ref), np.median(np.abs(ref)))
        loss = max(loss, float(np.max(np.abs(res["nll"][k] - ref) / scale)))
    out["loss"] = loss

    Xc, Yc = cv_rows(X, Y, cfg, res["admm_seed"])
    cv = 0.0
    for k in range(steps):
        ref = R.cv_score(circ, kernel, Xc, Yc, res["z"][k], tr["noise_std"], tr["cv_folds"],
                         res["admm_seed"] + k + 1, device=device)
        cv = max(cv, abs(res["cv"][k] - ref) / max(abs(ref), 1.0))
    out["cv"] = float(cv)

    mine = R.change_norms(res["z"][: steps + 1])
    ref = R.change_norms(chain["z"])
    out["step"] = float(max(abs(a - b) / max(b, 1e-12) for a, b in zip(mine, ref)))

    if tr["compute_cond"]:
        want = R.condition_numbers(circ, kernel, ag, res["z"][:steps], device)
        got = res["cond"][:steps]
        gap = 0.0
        for g, w in zip(got.ravel(), want.ravel()):
            if w < BUCKETS[0]:
                gap = max(gap, abs(g - w) / w)
            elif _bucket(g) != _bucket(w):
                gap = max(gap, 1.0)
        out["cond"] = float(gap)
    return {k: {"value": v, "limit": limits[k]} for k, v in out.items()}
