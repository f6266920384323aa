"""BASELINE config #7 (beyond the reference's reach): GP posterior at
n = 50,000 samples with a 10-qubit circuit, through the matrix-free CG
posterior and the Gram-free blocked Cholesky NLL; the 50k x 50k Gram is
never materialized. The port's counterpart of ``examples/scale_out_50k.py``:
the same spec, seeded data, float32 types and calls.

    python -m dqgp_tpu_torch.examples.scale_out_50k [N] [--device cpu]

Run with a smaller N first (20000). ``run(N, device)`` returns the numbers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import config
from ..models.circuits import build_circuit
from ..models.kernels import QuantumKernelSpec
from ..models.kernels.quantum_kernel import kernel_features
from ..parallel.blocked import gp_posterior_large, nll_large

M = 512          # test points
CG_TOL = 1e-5
NLL_ROWS = 36 * 1024


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(N: int = 50_000, device="cuda", verbose: bool = True) -> dict:
    """The example on ``device`` (the card unless the caller asks for the
    CPU). Returns the posterior (mean, var on the M test points), the CG
    alpha solve's iterations, residual and whether it reached ``CG_TOL``,
    the exact NLL of the first min(N, 36,864) rows with its components, and
    each part's seconds."""
    dev = config.resolve_device(device)
    log = print if verbose else (lambda *a, **k: None)
    spec = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", num_qubits=10, num_features=2, num_layers=2),
        kernel_type="projected",
        outer_kernel="matern",
    )
    log(f"N={N}, qubits=10, P={spec.num_parameters}")

    rng = np.random.RandomState(0)
    X_np = rng.uniform(-0.99, 0.99, (N + M, 2)).astype(np.float32)
    theta = torch.as_tensor(rng.uniform(0, np.pi, spec.num_parameters).astype(np.float32),
                            device=dev)
    X = torch.as_tensor(X_np, device=dev)

    t0 = time.perf_counter()
    F = kernel_features(spec, X, theta)  # one batched feature pass
    _sync(dev)
    features_s = time.perf_counter() - t0
    log(f"features for {N + M} samples: {features_s:.2f}s -> {tuple(F.shape)}")

    F_tr, F_te = F[:N], F[N:]
    Y = torch.as_tensor((np.sin(3 * X_np[:N, 0]) + 0.1 * rng.randn(N)).astype(np.float32),
                        device=dev)

    t0 = time.perf_counter()
    mean, var, res = gp_posterior_large(
        spec, F_tr, Y, F_te, noise_std=0.1, block=4096, cg_tol=CG_TOL, cg_maxiter=600,
        precond_rank=256,
    )
    _sync(dev)
    posterior_s = time.perf_counter() - t0
    converged = res.residual_norm <= CG_TOL
    log(f"CG posterior (mean+var for {M} test pts): {posterior_s:.2f}s, "
        f"{res.iterations} CG iters, residual {res.residual_norm:.2e}"
        + ("" if converged else f" (did not reach cg_tol={CG_TOL:.0e})"))

    n_chol = min(N, NLL_ROWS)
    t0 = time.perf_counter()
    nll, comps = nll_large(spec, F_tr[:n_chol], Y[:n_chol], noise_std=0.1, block=1024)
    nll = float(nll)
    nll_s = time.perf_counter() - t0
    log(f"exact NLL via gram-free blocked Cholesky (n={n_chol}): {nll:.2f} ({nll_s:.2f}s)")
    return {"N": N, "mean": mean, "var": var, "cg_iterations": res.iterations,
            "cg_residual": res.residual_norm, "cg_converged": converged,
            "n_chol": n_chol, "nll": nll, "nll_terms": {k: float(v) for k, v in comps.items()},
            "features_s": features_s, "posterior_s": posterior_s, "nll_s": nll_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("N", type=int, nargs="?", default=50_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.N, args.device)


if __name__ == "__main__":
    main()
