"""ADMM training orchestrator — port of ``dqgp_tpu/driver.py``'s
per-iteration mode (reference: main.py:2403-2784).

Each iteration runs the consensus step and then scores its z with k-fold CV
on the same device; the host keeps the bookkeeping: CV model selection with
patience, ground-truth tracking, metrics history and checkpoints.

Stopping rules (main.py:2767-2784): consensus ``all(||z - theta_i||_2 < tol)``
(Euclidean norm — a reference quirk, NOT the Riemannian distance), CV patience
exhaustion, or max_iter; on the latter two the best-CV z is restored.

Nothing here catches a failure of device work: an exception propagates and
the run fails (the JAX driver's fallbacks to other dispatch modes have no
counterpart here). The GP side is direct float64. The gradient is the
central difference, materialized ("central") or streamed one parameter at a
time ("streamed", the scale-out path); CV can model-select on a seeded
subsample of the training rows (``cv_max_samples``), as the JAX driver does.
The JAX driver's other dtype modes, its "autodiff" gradient, host condition
numbers, meshes and chained dispatch are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config
from . import manifold as M
from .models.gp.cv import (
    aggregate_cv_scores,
    cv_fold_scores_impl,
    k_fold_cross_validation_consensus,
    kfold_pad_indices,
)
from .models.kernels.quantum_kernel import QuantumKernelSpec
from .parallel.consensus import make_admm_step, make_agent_batch


@dataclasses.dataclass
class TrainConfig:
    rho: float = 100.0
    L: float = 100.0
    noise_std: float = 0.1
    max_iter: int = 100
    tolerance: float = 1e-6
    shift_value: float = float(np.pi / 8)
    cv_folds: int = 5
    cv_patience: int = 50
    seed: int = 42
    parity_round: bool = True       # 4-decimal quantization (reference quirk)
    compute_cond: bool = True       # per-iteration condition numbers: f64
                                    # eigvalsh of each agent's step Gram, on
                                    # the step's device (the JAX "device" mode)
    psd_fallback: bool = True       # eigh-pinv rescue of failed factorizations
    grad_method: str = "central"    # "central" (parity) | "streamed" (parity,
                                    # O(A N^2) memory)
    run_cv: bool = True             # per-iteration k-fold CV model selection
    cv_max_samples: Optional[int] = None  # subsample X_train for CV beyond
                                    # this size (the dense fold Grams are
                                    # O(n^2); scale-out runs cap the CV set)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    verbose: bool = True


@dataclasses.dataclass
class TrainResult:
    z: np.ndarray
    z_best_cv: Optional[np.ndarray]
    cv_best: float
    theta: np.ndarray
    psi: np.ndarray
    iterations: int
    converged_by: str
    nll_history: List[Dict]
    cv_history: List[Dict]
    error_history: List[float]
    z_best_gt: Optional[np.ndarray]
    error_best: float
    total_time: float


def init_admm_state(n_agents: int, num_parameters: int, seed: int, rho: float,
                    parity_round: bool = True):
    """theta, psi ~ U(0,1) rounded 4dp; z = circular mean (main.py:2403-2461).

    Uses numpy's legacy global RNG exactly as the reference does after
    ``np.random.seed(args.seed)`` so fixed seeds reproduce its initial state.
    """
    np.random.seed(seed)
    theta = np.round(np.random.rand(n_agents, num_parameters), 4)
    psi = np.round(np.random.rand(n_agents, num_parameters), 4)
    z = M.np_circular_mean(theta + psi / rho)
    if parity_round:
        z = np.round(z, 4)
    return theta, psi, z


def save_checkpoint(path: str, iteration: int, theta, psi, z, cv_best, z_best_cv,
                    patience_counter: int, extra: Optional[Dict] = None):
    """Checkpoint in the JAX package's npz layout (driver.py:140-154), so
    either package can resume the other's runs."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        iteration=iteration,
        theta=np.asarray(theta),
        psi=np.asarray(psi),
        z=np.asarray(z),
        cv_best=cv_best,
        z_best_cv=(np.asarray(z_best_cv) if z_best_cv is not None else np.zeros(0)),
        patience_counter=patience_counter,
        extra=json.dumps(extra or {}),
    )


def load_checkpoint(path: str):
    d = np.load(path, allow_pickle=False)
    z_best_cv = d["z_best_cv"] if d["z_best_cv"].size else None
    return {
        "iteration": int(d["iteration"]),
        "theta": d["theta"],
        "psi": d["psi"],
        "z": d["z"],
        "cv_best": float(d["cv_best"]),
        "z_best_cv": z_best_cv,
        "patience_counter": int(d["patience_counter"]),
        "extra": json.loads(str(d["extra"])),
    }


def _warn_device_cond_floor(compute_cond: bool, device: torch.device) -> None:
    """The step's Gram is BUILT in float32, so its exact f64 eigvalsh cannot
    resolve condition numbers beyond ~1e7-1e8: on the card they are floors,
    not measurements of the reference's 1e12/1e15 buckets. Say so once."""
    if compute_cond and device.type != "cpu":
        print("Warning: condition numbers on the device come from the f32-built "
              "step Gram: values beyond ~1e7-1e8 saturate (f32 Gram "
              "representation error). Reported values are lower bounds; exact "
              "f64 buckets need the JAX package's cond_mode='host', which is "
              "not ported yet.")


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def train(
    spec: QuantumKernelSpec,
    agent_data_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
    X_train: np.ndarray,
    Y_train: np.ndarray,
    cfg: TrainConfig,
    ground_truth_params: Optional[np.ndarray] = None,
    resume_from: Optional[str] = None,
    *,
    device,
) -> TrainResult:
    """Run the distributed Riemannian-ADMM optimization on ``device``."""
    device = torch.device(device)
    config.set_precision_policy()
    n_agents = len(agent_data_splits)
    log = print if cfg.verbose else (lambda *a, **k: None)

    _warn_device_cond_floor(cfg.compute_cond, device)

    batch = make_agent_batch(agent_data_splits, device)
    step = make_admm_step(
        spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
        shift_value=cfg.shift_value, parity_round=cfg.parity_round,
        compute_cond=cfg.compute_cond, psd_fallback=cfg.psd_fallback,
        grad_method=cfg.grad_method,
    )

    if resume_from:
        ck = load_checkpoint(resume_from)
        theta, psi, z = ck["theta"], ck["psi"], ck["z"]
        start_iter = ck["iteration"]
        cv_best, z_best_cv = ck["cv_best"], ck["z_best_cv"]
        patience_counter = ck["patience_counter"]
        log(f"Resumed from {resume_from} at iteration {start_iter}")
    else:
        theta, psi, z = init_admm_state(n_agents, spec.num_parameters, cfg.seed,
                                        cfg.rho, cfg.parity_round)
        start_iter = 0
        cv_best, z_best_cv, patience_counter = float("inf"), None, 0
    theta = torch.as_tensor(theta, dtype=torch.float64, device=device)
    psi = torch.as_tensor(psi, dtype=torch.float64, device=device)

    X_cv, Y_cv = np.asarray(X_train), np.asarray(Y_train)
    if cfg.run_cv and cfg.cv_max_samples and len(X_cv) > cfg.cv_max_samples:
        # the dense fold Grams are O(n^2): model-select on a seeded subsample,
        # drawn as dqgp_tpu/driver.py:521-529 draws it
        sel = np.random.RandomState(cfg.seed).choice(
            len(X_cv), cfg.cv_max_samples, replace=False)
        X_cv, Y_cv = X_cv[sel], Y_cv[sel]
        log(f"CV model selection on a {cfg.cv_max_samples}-sample subset "
            f"of {len(X_train)} training rows")
    X_t = torch.as_tensor(X_cv, device=device)
    Y_t = torch.as_tensor(Y_cv, device=device)

    nll_history: List[Dict] = []
    cv_history: List[Dict] = []
    error_history: List[float] = []
    z_best_gt, error_best = None, float("inf")
    converged_by = "max_iter"
    z_prev = np.asarray(z, np.float64)

    it = start_iter
    t0 = time.time()
    while True:
        it += 1
        it_start = time.time()
        out = step(theta, psi, batch)
        if cfg.run_cv:
            fold_scores = [_to_np(s) for s in cv_fold_scores_impl(
                spec, X_t, Y_t, out.z,
                *kfold_pad_indices(len(X_cv), cfg.cv_folds, cfg.seed + it, device),
                noise_std=float(cfg.noise_std),
            )]
        theta, psi = out.theta, out.psi
        z_row = _to_np(out.z)
        # Euclidean consensus norms (reference quirk)
        theta_z_norms = _to_np(torch.linalg.norm(out.z[None, :] - theta, dim=1))
        nll = _to_np(out.nll)
        conds = _to_np(out.condition_number)
        lds, quads, consts = (_to_np(out.log_det_term), _to_np(out.quadratic_term),
                              _to_np(out.constant_term))
        it_time = time.time() - it_start

        valid = nll[np.isfinite(nll)]
        nll_history.append({
            "iteration": it,
            "solver": "float64",
            "iter_time": float(it_time),
            "agent_losses": nll.tolist(),
            "condition_numbers": conds.tolist(),
            "nll_components": [
                {
                    "log_det_term": float(lds[i]),
                    "quadratic_term": float(quads[i]),
                    "constant_term": float(consts[i]),
                    "total": float(nll[i]),
                }
                for i in range(n_agents)
            ],
            "total_nll": float(valid.sum()) if valid.size else float("inf"),
            "avg_nll": float(valid.mean()) if valid.size else float("inf"),
            "min_nll": float(valid.min()) if valid.size else float("inf"),
            "max_nll": float(valid.max()) if valid.size else float("inf"),
        })

        # --- per-iteration CV model selection (main.py:2645-2716) ---------
        if cfg.run_cv:
            if np.all(np.isfinite(fold_scores[0])):
                cv = aggregate_cv_scores(*fold_scores, cfg.cv_folds)
                cv_solver = "float64"
            else:
                # the fold batch flags failed factorizations as NaN; the
                # reference's f64 CV would have rescued them — re-score
                # through the full fallback chain
                log("  CV fold solve flagged fold(s); re-scoring this "
                    "iteration's CV in float64")
                cv = k_fold_cross_validation_consensus(
                    spec, X_t, Y_t, z_row, cfg.noise_std,
                    k_folds=cfg.cv_folds, random_seed=cfg.seed + it, rescue=True,
                )
                cv_solver = "float64-rescue"
            cv_score = cv["mean_nlpd"]
            if cv_score < cv_best:
                cv_best = cv_score
                z_best_cv = z_row.copy()
                patience_counter = 0
            else:
                patience_counter += 1
            cv_history.append({
                "iteration": it,
                "solver": cv_solver,
                "consensus_cv_score": cv_score,
                "cv_score_std": cv["std_nlpd"],
                "cv_r2": cv["mean_r2"],
                "valid_folds": cv["valid_folds"],
                "total_folds": cv["total_folds"],
                "consensus_params": z_row.copy(),
            })

        # --- convergence metrics (main.py:2718-2726) ----------------------
        max_norm = float(theta_z_norms.max())
        z_change = float(np.linalg.norm(z_row - z_prev))
        z_prev = np.asarray(z_row, np.float64)
        z = z_row

        if ground_truth_params is not None:
            param_error = M.np_distance(z_row, ground_truth_params)
            error_history.append(float(np.round(param_error, 4)))
            if param_error < error_best:
                error_best = param_error
                z_best_gt = z_row.copy()

        cvs = cv_history[-1]["consensus_cv_score"] if cv_history else float("nan")
        log(
            f"iter {it:4d}  nll_sum={nll_history[-1]['total_nll']:.4f}  "
            f"cv_nlpd={cvs:.4f}  max||z-th||={max_norm:.6f}  "
            f"dz={z_change:.6f}  {it_time:.3f}s"
        )

        if cfg.checkpoint_dir and it % cfg.checkpoint_every == 0:
            save_checkpoint(
                os.path.join(cfg.checkpoint_dir, f"ckpt_{it:05d}.npz"),
                it, _to_np(theta), _to_np(psi), z_row, cv_best, z_best_cv,
                patience_counter,
            )

        # --- stopping (main.py:2767-2784) ---------------------------------
        stop = None
        if np.all(theta_z_norms < cfg.tolerance):
            stop = "consensus"
        elif cfg.run_cv and patience_counter >= cfg.cv_patience:
            stop = "cv_patience"
        elif it >= cfg.max_iter:
            stop = "max_iter"
        if stop is not None:
            converged_by = stop
            if stop in ("cv_patience", "max_iter") and z_best_cv is not None:
                z = z_best_cv.copy()
            break

    total_time = time.time() - t0
    log(f"ADMM done ({converged_by}) after {it} iterations in {total_time:.2f}s "
        f"({total_time / max(it - start_iter, 1):.3f}s/iter)")

    return TrainResult(
        z=np.asarray(z),
        z_best_cv=(np.asarray(z_best_cv) if z_best_cv is not None else None),
        cv_best=cv_best,
        theta=_to_np(theta),
        psi=_to_np(psi),
        iterations=it,
        converged_by=converged_by,
        nll_history=nll_history,
        cv_history=cv_history,
        error_history=error_history,
        z_best_gt=(np.asarray(z_best_gt) if z_best_gt is not None else None),
        error_best=error_best,
        total_time=total_time,
    )
