"""ADMM training orchestrator — port of ``dqgp_tpu/driver.py`` (reference:
main.py:2403-2784).

Each iteration runs the consensus step and then scores its z with k-fold CV
on the same device; the host keeps the bookkeeping (``record_iteration``):
CV model selection with patience, ground-truth tracking, metrics history and
checkpoints. Everything the host reads of an iteration comes back as one
packed float64 row. The loop runs chunks of ``chain_iters`` iterations
(``_ChunkRunner``) with one fetch of their rows a chunk:

* ``chain_iters=1``: one iteration a chunk, run eagerly with the full
  fallback;
* ``chain_iters=k>1``: k iterations a chunk. On CUDA the k steps and CV passes are captured once in a CUDA graph
  after one eager warm-up iteration, and each chunk is one replay; on a CPU
  device the same chunk runs eagerly. The chunk's step flags a failed
  factorization (NaN) instead of rescuing it, which would need the host; a
  flagged row is re-run eagerly with the full eigh-pinv fallback from its
  pre-row state and chunking restarts from there, as the JAX driver's
  ``redo64`` does, so the trajectory is the per-iteration loop's. Rows past
  a stop are discarded.

Condition numbers are reporting only (``cond_mode``): "device" computes them
in the step from the float32-built Gram; "host" drops them from the step and
backfills exact float64 values after training (``host_condition_numbers``);
"auto" is "device" on a CPU device and "host" elsewhere; ``compute_cond=False``
turns them off.

Stopping rules (main.py:2767-2784): consensus ``all(||z - theta_i||_2 < tol)``
(Euclidean norm — a reference quirk, NOT the Riemannian distance), CV patience
exhaustion, or max_iter; on the latter two the best-CV z is restored.

Nothing here catches a failure of device work: an exception propagates and
the run fails (the JAX driver's fallbacks to other dispatch modes have no
counterpart here). The gradient is the central difference, materialized
("central") or streamed one parameter at a time ("streamed", the scale-out
path), or exact by autograd ("autodiff"); CV can model-select on a seeded
subsample of the training rows (``cv_max_samples``). Meshes are not ported:
the port trains on one device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config
from . import manifold as M
from . import tracing
from .models.gp.cv import (
    FoldIndexBuffers,
    aggregate_cv_scores,
    cv_fold_scores_impl,
    k_fold_cross_validation_consensus,
)
from .models.kernels.quantum_kernel import QuantumKernelSpec, grams_at_rows
from .ops import cuda_circuit, cuda_eig
from .parallel.consensus import make_admm_step, make_agent_batch

COND_MODES = ("auto", "device", "host")


@dataclasses.dataclass
class TrainConfig:
    """The JAX driver's ``TrainConfig``, field for field (names and
    defaults). The port honours all of them but the mesh fields
    (``n_mesh_devices``, ``data_mesh_cols``, ``solve_2d``), which take only
    their defaults."""

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
    compute_cond: bool = True       # per-iteration condition numbers (eigvalsh)
    cond_mode: str = "auto"         # where they compute: "device" in the step
                                    # (f64 eigvalsh of the f32-built Gram:
                                    # values beyond ~1e7-1e8 are floors);
                                    # "host" after training, from each agent's
                                    # float64 Gram (complex128 states) on the
                                    # training device; "auto" = device on a
                                    # CPU device, host elsewhere
    gp_dtype: str = "auto"          # GP linalg dtype: "auto" = "float64";
                                    # "float32"; "mixed" is not ported
    cv_dtype: str = "auto"          # CV fold dtype, same modes as gp_dtype
    psd_fallback: bool = True       # eigh-pinv rescue of failed factorizations
    grad_method: str = "central"    # "central" (parity) | "streamed" (parity,
                                    # O(N^2) memory) | "autodiff" (exact)
    run_cv: bool = True             # per-iteration k-fold CV model selection
    cv_max_samples: Optional[int] = None  # subsample X_train for CV beyond
                                    # this size (the dense fold Grams are
                                    # O(n^2); scale-out runs cap the CV set)
    chain_iters: int = 1            # >1: this many iterations per dispatch
                                    # and one fetch (a CUDA-graph replay on
                                    # the card); the trajectory and stopping
                                    # iteration are the per-iteration loop's
    n_mesh_devices: Optional[int] = None  # meshes: not ported (None only)
    data_mesh_cols: Optional[int] = None  # not ported (None only)
    solve_2d: str = "replicated"    # not ported ("replicated" only)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    verbose: bool = True
    verbose_agents: bool = False    # reference-style per-agent NLL/cond report


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
    chain_stats: Optional[Dict] = None  # chained dispatch: see _ChunkRunner
    cond_backfill_time: Optional[float] = None  # s of the host-mode backfill
                                    # after training (None: no backfill)


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


def host_condition_numbers(
    spec: QuantumKernelSpec,
    agent_data_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
    z_rows: np.ndarray,
    chunk: int = 16,
    *,
    device,
) -> np.ndarray:
    """Per-agent condition numbers of the noise-free Gram at each parameter
    row: the port of ``dqgp_tpu/driver.py::host_condition_numbers``.

    For every agent its true n_i x n_i Gram (no shard padding) at wrap(z),
    built in float64 from complex128 states, then max|w| / max(min|w|, tiny)
    over its eigenvalues w: the reference's ``np.linalg.cond`` on its
    double-precision Grams (agent_riemannian.py:411), which resolves its
    1e12/1e15 buckets where the step's float32-built Gram floors at
    ~1e7-1e8. The rows go in chunks of ``chunk``, each chunk's rows x n_i
    samples through one feature call (``grams_at_rows``).

    It runs on ``device``: on the card through K1's and K2's float64
    instantiations, then one call a chunk of the batched eigenvalue kernel's
    wrapper (``ops/cuda_eig.py``) for all agents: one launch for every agent
    whose n_i the kernel takes; an agent above its limit, and every agent on
    the CPU, goes through eigvalsh an agent at a time. The JAX package sends
    this work to the CPU because a TPU emulates float64; the card computes
    float64 natively.

    z_rows: (T, P). Returns (T, A) float64."""
    device = torch.device(device)
    Z = np.asarray(z_rows, np.float64).reshape(-1, np.shape(z_rows)[-1])
    out = np.empty((Z.shape[0], len(agent_data_splits)), np.float64)
    tiny = torch.finfo(torch.float64).tiny
    step = max(1, int(chunk))
    # wrap as the step does: with parity rounding a component can be
    # 3.1416 > pi, and circuit angles are affine in theta, not pi-periodic
    Zw = M.wrap(torch.as_tensor(Z, device=device))
    Xs = [torch.as_tensor(np.asarray(X_i, np.float64), device=device)
          for X_i, _ in agent_data_splits]
    conds = []
    for s in range(0, Z.shape[0], step):
        with tracing.span("driver.backfill_chunk"):
            w = cuda_eig.gram_extremes(grams_at_rows(spec, X_i, Zw[s:s + step]) for X_i in Xs)
            conds.append(w[:, 0] / torch.clamp(w[:, 1], min=tiny))
    # one read at the end, so that the host builds the next chunk's Grams
    # while the card reduces this one's
    with tracing.span("sync.backfill"):
        for s, cond in zip(range(0, Z.shape[0], step), conds):
            out[s:s + step] = cond.reshape(len(Xs), -1).T.cpu().numpy()
    # the kernel reads NaN where a Gram has a non-finite entry; eigvalsh
    # raises on such a Gram
    kernel = [cuda_eig.takes_kernel(X_i.shape[0], device) for X_i in Xs]
    if np.isnan(out[:, kernel]).any():
        raise torch.linalg.LinAlgError(
            "host_condition_numbers: a Gram has a non-finite entry (linalg.eigh fails to "
            "converge on it)")
    return out


def resolve_cond_mode(cfg: TrainConfig, device: torch.device) -> str:
    """"device" | "host" | "off", as dqgp_tpu/driver.py:312-321 resolves it,
    with the training device in place of JAX's default backend."""
    if cfg.cond_mode not in COND_MODES:
        raise ValueError(
            f"cond_mode must be 'auto', 'device', or 'host', got {cfg.cond_mode!r}")
    mode = cfg.cond_mode
    if mode == "auto":
        mode = "device" if device.type == "cpu" else "host"
    return mode if cfg.compute_cond else "off"


_warned_cond_floor = []


def _warn_device_cond_floor(cond_mode: str, device: torch.device) -> None:
    """With cond_mode="device" off the CPU the condition numbers come from
    the f32-built step Gram, whose representation error floors resolvable
    values at ~1e7-1e8: readings in the reference's 1e12/1e15 buckets would
    be lower bounds. Say so once a process (dqgp_tpu/driver.py:271-282)."""
    if cond_mode == "device" and device.type != "cpu" and not _warned_cond_floor:
        _warned_cond_floor.append(True)
        print("Warning: cond_mode='device' off the CPU: condition numbers beyond "
              "~1e7-1e8 saturate (f32 Gram representation error). Reported values "
              "are lower bounds; use cond_mode='auto'/'host' for exact f64 buckets.")


def _check_unported(cfg: TrainConfig) -> None:
    for name, default in (("n_mesh_devices", None), ("data_mesh_cols", None),
                          ("solve_2d", "replicated")):
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"TrainConfig.{name}={getattr(cfg, name)!r}: meshes are not ported "
                f"(ROADMAP Queue 1 item 11, multi-device); the port trains on one "
                f"device and takes only {name}={default!r}")


def check_config(cfg: TrainConfig) -> TrainConfig:
    """Raise on a field the port does not have (meshes: NotImplementedError;
    "mixed" dtypes: ValueError); return ``cfg`` with its dtype modes
    resolved."""
    _check_unported(cfg)
    return dataclasses.replace(cfg, gp_dtype=config.resolve_dtype_mode(cfg.gp_dtype),
                               cv_dtype=config.resolve_dtype_mode(cfg.cv_dtype))


def _cond_status(c: float, compute_cond: bool) -> str:
    """The reference's buckets (main.py:2557-2643)."""
    if not compute_cond:
        return "n/a"
    if not np.isfinite(c):
        return "Poor"
    return "Good" if c < 1e12 else ("Moderate" if c < 1e15 else "Poor")


class _RowLayout:
    """One iteration as one float64 row: [z (P) | ||z - theta_i|| (A) | nll
    (A) | cond (A) | logdet (A) | quad (A) | const (A) | CV nlpd, r2, rmse
    (3k, with CV) | theta (A*P) | psi (A*P)], as the JAX driver packs its
    fetch (driver.py:409-445)."""

    def __init__(self, n_agents: int, n_params: int, n_scores: int):
        self.A, self.P, self.S = n_agents, n_params, n_scores
        self.width = n_params + 6 * n_agents + n_scores + 2 * n_agents * n_params

    def pack(self, out, scores=None) -> torch.Tensor:
        f64 = torch.float64
        # Euclidean consensus norms (reference quirk)
        norms = torch.linalg.norm(out.z[None, :].to(f64) - out.theta.to(f64), dim=1)
        parts = [out.z, norms, out.nll, out.condition_number, out.log_det_term,
                 out.quadratic_term, out.constant_term, *(() if scores is None else scores),
                 out.theta, out.psi]
        return torch.cat([p.reshape(-1).to(f64) for p in parts])

    def unpack(self, row: np.ndarray):
        """(z, sec (6, A): norms, nll, cond, logdet, quad, const; fold scores
        (3, k) or None; theta (A, P); psi (A, P))."""
        A, P, S = self.A, self.P, self.S
        z = row[:P]
        sec = row[P:P + 6 * A].reshape(6, A)
        scores = row[P + 6 * A:P + 6 * A + S].reshape(3, -1) if S else None
        state = row[P + 6 * A + S:]
        return z, sec, scores, state[:A * P].reshape(A, P), state[A * P:].reshape(A, P)


class _ChunkRunner:
    """``k`` iterations of step + CV per dispatch; their packed rows land in
    one (k, width) float64 buffer that the caller fetches once.

    ``iteration(theta, psi, j)`` runs iteration j of the chunk and returns
    (step output, packed row). With ``capture`` (chain_iters > 1 on CUDA) the
    first chunk runs one eager warm-up iteration on the capture stream (it
    builds the kernels, uploads the gate and coefficient tables and creates
    the solver handles, none of which a capture may do; its result is
    discarded), then captures the chunk's k iterations in one CUDA graph;
    every chunk is then one replay that reads the static theta, psi and
    fold-index buffers and writes the row buffer. Without it the chunk runs
    eagerly (one iteration a chunk, or a CPU device).

    ``stats``: the graph's replays, the launches that one replay makes of
    each hand kernel (the wrappers count Python calls, so they count the
    capture and no replay), the seconds of the first chunk's warm-up and
    capture (the ``driver.capture`` span's), and the peak bytes allocated
    during capture (the graph pool's peak)."""

    def __init__(self, iteration, k: int, width: int, device: torch.device,
                 capture: bool):
        self.iteration, self.k, self.width = iteration, k, width
        self.device, self.capture = device, capture
        self.graph = None
        self.stats: Dict = {"chain_iters": k, "captured": capture, "replays": 0}

    def _body(self, theta, psi, rows):
        for j in range(self.k):
            out, row = self.iteration(theta, psi, j)
            rows[j].copy_(row)
            theta, psi = out.theta, out.psi
        return theta, psi

    def _capture(self, theta, psi) -> None:
        dev = self.device
        with tracing.span("driver.capture") as span:
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.iteration(theta, psi, 0)   # warm-up, discarded
            torch.cuda.synchronize(dev)
            warmup_s = span.elapsed
            self.theta_in, self.psi_in = theta.clone(), psi.clone()
            self.rows = torch.empty((self.k, self.width), dtype=torch.float64, device=dev)
            before = cuda_circuit.launch_counts()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream):
                self.theta_out, self.psi_out = self._body(self.theta_in, self.psi_in, self.rows)
            torch.cuda.synchronize(dev)
        after = cuda_circuit.launch_counts()
        self.stats.update(
            warmup_s=warmup_s, capture_s=span.elapsed - warmup_s,
            launches_per_replay={n: after[n] - before[n] for n in after if after[n] != before[n]},
            graph_pool_peak_bytes=torch.cuda.max_memory_allocated(dev) - base)

    def run(self, theta, psi):
        """(rows (k, width) float64 on the device, theta and psi after the
        k-th row); the caller fetches the rows. A captured chunk's rows are
        the graph's own buffer, which the next replay overwrites: fetch
        them before the next ``run``."""
        if not self.capture:
            rows = torch.empty((self.k, self.width), dtype=torch.float64, device=self.device)
            theta, psi = self._body(theta, psi, rows)
            return rows, theta, psi
        if self.graph is None:
            self._capture(theta, psi)
        self.theta_in.copy_(theta)
        self.psi_in.copy_(psi)
        self.graph.replay()
        self.stats["replays"] += 1
        return self.rows, self.theta_out.clone(), self.psi_out.clone()


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
    tracing.new_unit()
    device = torch.device(device)
    config.set_precision_policy()
    cfg = check_config(cfg)
    n_agents = len(agent_data_splits)
    P = spec.num_parameters
    log = print if cfg.verbose else (lambda *a, **k: None)

    cond_mode = resolve_cond_mode(cfg, device)
    chain_k = max(1, int(cfg.chain_iters))
    if cond_mode == "device" and chain_k > 1 and device.type == "cuda":
        raise ValueError(
            "cond_mode='device' with chain_iters > 1 on CUDA: torch's eigvalsh checks "
            "its info on the host, which a CUDA graph cannot capture; use "
            "cond_mode='auto'/'host' (the exact float64 backfill) or chain_iters=1")
    _warn_device_cond_floor(cond_mode, device)
    cond_pending: List[Tuple[int, np.ndarray]] = []  # (history index, z row)

    if resume_from:
        ck = load_checkpoint(resume_from)
        theta, psi, z = ck["theta"], ck["psi"], ck["z"]
        start_iter = ck["iteration"]
        cv_best, z_best_cv = ck["cv_best"], ck["z_best_cv"]
        patience_counter = ck["patience_counter"]
        log(f"Resumed from {resume_from} at iteration {start_iter}")
    else:
        theta, psi, z = init_admm_state(n_agents, P, cfg.seed, cfg.rho, cfg.parity_round)
        start_iter = 0
        cv_best, z_best_cv, patience_counter = float("inf"), None, 0

    # the run's one-time start: the agent batch, the steps, the uploads, the
    # CV subsample and the fold buffers
    with tracing.span("driver.start"):
        batch = make_agent_batch(agent_data_splits, device)
        step_kw = dict(rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                       shift_value=cfg.shift_value, parity_round=cfg.parity_round,
                       compute_cond=cond_mode == "device", gp_dtype=cfg.gp_dtype,
                       grad_method=cfg.grad_method)
        step = make_admm_step(spec, psd_fallback=cfg.psd_fallback, **step_kw)

        # chain_k > 1: the chunk's step flags failed factorizations (NaN), and
        # the eager step (full fallback) re-runs a flagged row; one iteration a
        # chunk runs the eager step itself
        flags = chain_k > 1
        chunk_step = make_admm_step(spec, psd_fallback=False, **step_kw) if flags else step
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
        folds = FoldIndexBuffers(len(X_cv), cfg.cv_folds, chain_k, device) if cfg.run_cv else None
        layout = _RowLayout(n_agents, P, 3 * cfg.cv_folds if cfg.run_cv else 0)

    def make_iteration(step_fn):
        """Step + CV pass ``j`` of the fold buffer -> (step output, row)."""
        def iteration(theta, psi, j):
            with tracing.span("consensus.step"):
                out = step_fn(theta, psi, batch)
            scores = None
            if cfg.run_cv:
                with tracing.span("cv.scores"):
                    scores = cv_fold_scores_impl(spec, X_t, Y_t, out.z, *folds.folds(j),
                                                 noise_std=float(cfg.noise_std),
                                                 cv_dtype=cfg.cv_dtype)
            return out, layout.pack(out, scores)
        return iteration

    nll_history: List[Dict] = []
    cv_history: List[Dict] = []
    error_history: List[float] = []
    z_best_gt, error_best = None, float("inf")
    converged_by = "max_iter"
    z_prev = np.asarray(z, np.float64)

    def record_iteration(it, z_row, sec, fold_scores, it_time, th_row, ps_row,
                         solver=None):
        """All host bookkeeping of one completed iteration, the same for
        both dispatch modes (dqgp_tpu/driver.py:597-777); returns the stop
        reason ('consensus' | 'cv_patience' | 'max_iter') or None."""
        nonlocal cv_best, z_best_cv, patience_counter, z_prev, z_best_gt, error_best

        theta_z_norms, nll, conds, lds, quads, consts = sec
        if cond_mode == "host":
            if cfg.verbose and cfg.verbose_agents:
                # the per-agent report below prints this row's values now
                conds = host_condition_numbers(spec, agent_data_splits, z_row[None, :],
                                               chunk=1, device=device)[0]
            else:
                cond_pending.append((len(nll_history), np.array(z_row, copy=True)))
        valid = nll[np.isfinite(nll)]
        nll_history.append({
            "iteration": it,
            "solver": solver if solver is not None else cfg.gp_dtype,
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
            cv_dtype_iter, cv_rescue = cfg.cv_dtype, False
            if not np.all(np.isfinite(fold_scores[0])):
                # the fold batch flags failed factorizations as NaN; the
                # reference's f64 CV would have rescued them — re-score in
                # float64, through the full fallback chain where the flagged
                # pass was float64 already (dqgp_tpu/driver.py:664-680)
                log("  CV fold solve flagged fold(s); re-scoring this "
                    "iteration's CV in float64")
                fold_scores = None
                cv_rescue = cfg.cv_dtype == "float64"
                cv_dtype_iter = "float64"
            if fold_scores is not None:
                cv = aggregate_cv_scores(*fold_scores, cfg.cv_folds)
                cv_solver = cfg.cv_dtype
            else:
                cv = k_fold_cross_validation_consensus(
                    spec, X_t, Y_t, z_row, cfg.noise_std, k_folds=cfg.cv_folds,
                    random_seed=cfg.seed + it, cv_dtype=cv_dtype_iter, rescue=cv_rescue)
                cv_solver = "float64-rescue" if cv_rescue else cv_dtype_iter
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
        if cfg.verbose and cfg.verbose_agents:
            for i in range(n_agents):
                log(f"    Agent {i+1}: NLL={nll[i]:.6f} "
                    f"[LogDet={lds[i]:.4f}, Quad={quads[i]:.4f}, "
                    f"Const={consts[i]:.4f}]  cond={conds[i]:.2e} "
                    f"({_cond_status(conds[i], cfg.compute_cond)})")

        if cfg.checkpoint_dir and it % cfg.checkpoint_every == 0:
            save_checkpoint(
                os.path.join(cfg.checkpoint_dir, f"ckpt_{it:05d}.npz"),
                it, th_row, ps_row, z_row, cv_best, z_best_cv, patience_counter,
            )

        # --- stopping (main.py:2767-2784) ---------------------------------
        if np.all(theta_z_norms < cfg.tolerance):
            return "consensus"
        if cfg.run_cv and patience_counter >= cfg.cv_patience:
            return "cv_patience"
        if it >= cfg.max_iter:
            return "max_iter"
        return None

    chunks = _ChunkRunner(make_iteration(chunk_step), chain_k, layout.width, device,
                          capture=flags and device.type == "cuda")

    it = start_iter
    total_time = 0.0
    while True:
        with tracing.span("driver.iteration") as chunk:
            with tracing.span("driver.dispatch"):
                if cfg.run_cv:  # seed + iter (main.py:2665), one upload a chunk
                    folds.fill([cfg.seed + it + 1 + j for j in range(chain_k)])
                rows, th_next, ps_next = chunks.run(theta, psi)
            with tracing.span("sync.fetch"):
                rows = rows.cpu().numpy()   # the chunk's one fetch
            t_row = chunk.elapsed / chain_k
            stop, redo = None, False
            for j in range(chain_k):
                z_row, sec, fold_scores, th_row, ps_row = layout.unpack(rows[j])
                if flags and cfg.psd_fallback and not np.all(np.isfinite(sec[1])):
                    # A flagged agent poisons the later rows (NaN theta/psi):
                    # re-run THIS iteration's step with the full fallback from
                    # the pre-row state, then restart chunking from there. z and
                    # the row's CV scores stand (z reads only the old state).
                    redo = True
                    if j > 0:
                        _, _, _, th_prev, ps_prev = layout.unpack(rows[j - 1])
                        theta = torch.as_tensor(th_prev, device=device)
                        psi = torch.as_tensor(ps_prev, device=device)
                    log("  non-finite agent NLL in the chunk's step; re-running this "
                        "iteration with the eigh-pinv fallback")
                    with tracing.span("driver.dispatch"):
                        out = step(theta, psi, batch)
                        kept = None if fold_scores is None else torch.as_tensor(
                            fold_scores, device=device)
                        row = layout.pack(out, kept)
                    with tracing.span("sync.fetch"):
                        row = _to_np(row)
                    z_row, sec, fold_scores, th_row, ps_row = layout.unpack(row)
                    th_next, ps_next = out.theta, out.psi
                it += 1
                z = z_row
                with tracing.span("driver.record"):
                    stop = record_iteration(
                        it, z_row, sec, fold_scores, t_row, th_row, ps_row,
                        solver=f"{cfg.gp_dtype}-rescue" if redo else None)
                if stop is not None or redo:
                    break
            theta, psi = th_next, ps_next
            if stop is not None:
                # a stop inside the chunk: the rows after it are discarded
                theta, psi = th_row, ps_row
                converged_by = stop
                if stop in ("cv_patience", "max_iter") and z_best_cv is not None:
                    z = z_best_cv.copy()
        total_time += chunk.elapsed
        if stop is not None:
            break

    log(f"ADMM done ({converged_by}) after {it} iterations in {total_time:.2f}s "
        f"({total_time / max(it - start_iter, 1):.3f}s/iter)")

    cond_time = None
    if cond_pending:
        # host cond mode: one batched float64 pass over every recorded
        # iteration, then backfill the history rows (reporting-only values;
        # nothing in the training control flow reads them)
        with tracing.span("driver.backfill") as backfill:
            conds_all = host_condition_numbers(spec, agent_data_splits,
                                               np.stack([zr for _, zr in cond_pending]),
                                               device=device)
            for (hist_idx, _), crow in zip(cond_pending, conds_all):
                nll_history[hist_idx]["condition_numbers"] = crow.tolist()
        cond_time = backfill.elapsed
        log(f"condition numbers (exact f64, on {device.type}) for {len(cond_pending)} "
            f"iterations in {cond_time:.2f}s")

    return TrainResult(
        z=np.asarray(z),
        z_best_cv=(np.asarray(z_best_cv) if z_best_cv is not None else None),
        cv_best=cv_best,
        theta=np.asarray(theta) if isinstance(theta, np.ndarray) else _to_np(theta),
        psi=np.asarray(psi) if isinstance(psi, np.ndarray) else _to_np(psi),
        iterations=it,
        converged_by=converged_by,
        nll_history=nll_history,
        cv_history=cv_history,
        error_history=error_history,
        z_best_gt=(np.asarray(z_best_gt) if z_best_gt is not None else None),
        error_best=error_best,
        total_time=total_time,
        chain_stats=chunks.stats if flags else None,
        cond_backfill_time=cond_time,
    )
