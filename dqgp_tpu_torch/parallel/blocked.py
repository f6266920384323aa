"""Scale-out GP posterior: a matrix-free conjugate-gradient solve.

Port of the single-device CG posterior of ``dqgp_tpu/parallel/blocked.py``
(BASELINE config #7: ~50k training rows, where the dense N x N Gram no longer
fits). Per-sample features are small (N x 3n floats), only the Gram is huge,
so:

* features are computed once (one circuit-kernel launch);
* the Gram is never materialized — ``gram_matvec`` streams column blocks of
  K, one outer-kernel tile and one matmul per block;
* the posterior solves are preconditioned conjugate gradients on
  (K + sigma^2 I), batched over right-hand sides, with a rank-k
  pivoted-Cholesky/Woodbury preconditioner (Jacobi at rank 0).

The CG loop tests convergence after every iteration (one scalar read per
iteration on the card), so it stops at the iteration the JAX package's
``lax.while_loop`` stops at. Square-Gram regularization on this path needs
the JAX package's low-rank eigenvalue clip (LOBPCG), which is not ported:
a spec with ``regularization`` set raises. The mesh-sharded variants,
``nll_large`` and the Gram-free blocked Cholesky are not ported either.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from .. import config
from ..models.gp.metrics import outer_diag
from ..models.kernels.quantum_kernel import (
    QuantumKernelSpec,
    gram_from_features,
    kernel_features,
)


def _check_no_regularization(spec: QuantumKernelSpec) -> None:
    if spec.regularization is not None:
        raise NotImplementedError(
            f"regularization={spec.regularization!r} on the CG posterior needs "
            "the low-rank eigenvalue clip (make_lowrank_regularizer, LOBPCG), "
            "which is not ported yet")


def _pad_rows(F: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    n = F.shape[0]
    n_pad = ((n + block - 1) // block) * block
    if n_pad != n:
        F = torch.cat([F, F.new_zeros((n_pad - n,) + tuple(F.shape[1:]))], dim=0)
    return F, n_pad


def _k_diag(spec: QuantumKernelSpec, F: torch.Tensor, dtype) -> torch.Tensor:
    """diag(K) from features: fidelity kernels are 1 on the diagonal; outer
    kernels delegate to ``outer_diag``."""
    if spec.kernel_type == "fidelity":
        return torch.ones((F.shape[0],), dtype=dtype, device=F.device)
    return outer_diag(spec.outer_kernel, F, spec.outer_params).to(dtype)


def gram_matvec(
    spec: QuantumKernelSpec,
    F: torch.Tensor,          # (N, D) features (rows may be zero-padded)
    v: torch.Tensor,          # (N, R) right-hand sides
    row_mask: torch.Tensor,   # (N,) 1 for real rows
    block: int = 2048,
) -> torch.Tensor:
    """(K o mask) @ v without materializing K; O(N * block) live memory."""
    # the tile width is clamped to N rounded up to a multiple of 256, as the
    # JAX package clamps it
    block = min(block, max(256, -(-F.shape[0] // 256) * 256))
    Fp, n_pad = _pad_rows(F, block)
    mp, _ = _pad_rows(row_mask[:, None], block)
    vp, _ = _pad_rows(v, block)
    out = torch.zeros((n_pad, v.shape[-1]), dtype=v.dtype, device=v.device)
    for s in range(0, n_pad, block):
        # K[:, j_block]: (N, block), one outer-kernel tile per step
        K_cols = gram_from_features(spec, Fp, Fp[s:s + block])
        K_cols = K_cols * (mp * mp[s:s + block].transpose(0, 1))
        out += K_cols @ vp[s:s + block]
        del K_cols
    return out[: F.shape[0]]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,          # (N, R)
    tol: float = 1e-6,
    maxiter: int = 256,
    diag_precond: Optional[Union[torch.Tensor, Callable]] = None,
) -> CGResult:
    """Preconditioned CG, batched over right-hand-side columns.

    ``diag_precond`` may be a diagonal (Jacobi) or any callable applying an
    SPD approximate inverse (the pivoted-Cholesky/Woodbury preconditioner
    below). Stops when the largest relative residual over the columns is at
    most ``tol``, or after ``maxiter`` iterations."""
    if callable(diag_precond):
        precond = diag_precond
    elif diag_precond is not None:
        Minv = 1.0 / diag_precond[:, None]

        def precond(r):
            return r * Minv
    else:
        def precond(r):
            return r

    def colsum(x):
        return torch.sum(x, dim=0, keepdim=True)

    b_norm = torch.sqrt(colsum(b * b)) + 1e-30

    def rel_residual(r) -> float:
        return float(torch.max(torch.sqrt(colsum(r * r)) / b_norm))

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    it = 0
    while it < maxiter and rel_residual(r) > tol:
        Ap = matvec(p)
        rz = colsum(r * z)
        alpha = rz / (colsum(p * Ap) + 1e-30)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        beta = colsum(r_new * z_new) / (rz + 1e-30)
        p = z_new + beta * p
        r, z = r_new, z_new
        it += 1
    return CGResult(x, it, rel_residual(r))


def pivoted_cholesky(
    spec: QuantumKernelSpec,
    F: torch.Tensor,          # (N, D) features
    rank: int,
    jitter: float = 1e-12,
) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky of K from features, matrix-free.

    Greedy diagonal pivoting; each step evaluates ONE kernel row (N kernel
    entries). Returns L with K ~ L^T L, L: (rank, N). The pivot never leaves
    the device (no host read per step)."""
    n = F.shape[0]
    # single-precision features (f32, or c64 fidelity states) keep the
    # preconditioner in f32
    dtype = torch.float32 if F.dtype in (torch.float32, torch.complex64) else torch.float64
    d = _k_diag(spec, F, dtype)
    L = torch.zeros((rank, n), dtype=dtype, device=F.device)
    for j in range(rank):
        i = torch.argmax(d).reshape(1)
        row = gram_from_features(spec, F, F.index_select(0, i))[:, 0].to(dtype)
        row = row - L.transpose(0, 1) @ L.index_select(1, i)[:, 0]
        d_i = d.index_select(0, i)
        l_j = row / torch.sqrt(torch.clamp(d_i, min=jitter))
        # zero any contribution once the residual diagonal is exhausted
        l_j = torch.where(d_i > jitter, l_j, torch.zeros_like(l_j))
        L[j] = l_j
        d = torch.clamp(d - l_j * l_j, min=0.0)
    return L


def woodbury_preconditioner(L: torch.Tensor, sigma2: float):
    """Callable applying (sigma^2 I + L^T L)^{-1} via Woodbury.

    L: (rank, N) from ``pivoted_cholesky``. Cost per application: two
    (rank x N) matmuls and one small triangular solve pair."""
    rank = L.shape[0]
    small = sigma2 * torch.eye(rank, dtype=L.dtype, device=L.device) + L @ L.transpose(0, 1)
    chol = torch.linalg.cholesky(small)

    def apply(r):
        # (sigma^2 I + U U^T)^{-1} r,  U = L^T
        Lr = L @ r                                                # (rank, R)
        corr = L.transpose(0, 1) @ torch.cholesky_solve(Lr, chol)  # (N, R)
        return (r - corr) / sigma2

    return apply


def _cg_setup(
    spec: QuantumKernelSpec,
    F_train: torch.Tensor,
    y_train: torch.Tensor,
    sigma2: float,
    block: int,
    cg_tol: float,
    cg_maxiter: int,
    precond_rank: int,
    dtype,
):
    """Shared per-(F_train) CG state: the matvec closure, the preconditioner
    (rank-k pivoted-Cholesky/Woodbury, or Jacobi at rank 0), and the alpha
    solve. Used by ``gp_posterior_large`` and ``make_cg_predictor``."""
    _check_no_regularization(spec)
    n = F_train.shape[0]
    mask = torch.ones((n,), dtype=dtype, device=F_train.device)

    def A(v):
        return gram_matvec(spec, F_train, v, mask, block) + sigma2 * v

    if precond_rank > 0:
        Lp = pivoted_cholesky(spec, F_train, min(precond_rank, n))
        precond = woodbury_preconditioner(Lp.to(dtype), sigma2)
    else:
        precond = _k_diag(spec, F_train, dtype) + sigma2

    res = cg_solve(A, y_train[:, None].to(dtype), cg_tol, cg_maxiter, precond)
    return A, precond, res


def gp_posterior_large(
    spec: QuantumKernelSpec,
    F_train: torch.Tensor,    # (N, D)
    y_train: torch.Tensor,    # (N,)
    F_test: torch.Tensor,     # (M, D)
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 2048,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 512,
    precond_rank: int = 64,
    test_chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, CGResult]:
    """Posterior mean and variance diagonal at scale, matrix-free.

    mean = K_*^T alpha with alpha from CG on (K + sigma^2 I); var = k(x,x) -
    k_*^T (K + sigma^2 I)^{-1} k_* with the k_* solves batched through the
    same CG (exact GP math; accuracy is set by cg_tol). Test points go
    ``test_chunk`` at a time, so the CG state stays (N, test_chunk).

    Returns (mean, var, res) with ``res`` the alpha solve's CGResult."""
    dtype = y_train.dtype
    sigma2 = noise_std**2 + jitter
    A, precond, res = _cg_setup(spec, F_train, y_train, sigma2, block,
                                cg_tol, cg_maxiter, precond_rank, dtype)
    alpha = res.x[:, 0]

    means, vars_ = [], []
    for s in range(0, F_test.shape[0], test_chunk):
        F_c = F_test[s:s + test_chunk]
        K_ts = gram_from_features(spec, F_train, F_c).to(dtype)  # (N, m)
        means.append(K_ts.transpose(0, 1) @ alpha)
        sol = cg_solve(A, K_ts, cg_tol, cg_maxiter, precond)
        vars_.append(torch.clamp(
            _k_diag(spec, F_c, dtype) - torch.sum(K_ts * sol.x, dim=0), min=1e-10))
    return torch.cat(means), torch.cat(vars_), res


def make_cg_predictor(
    spec: QuantumKernelSpec,
    X_train,
    Y_train,
    theta,
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 4096,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 400,
    precond_rank: int = 64,
    test_chunk: int = 512,
    device="cuda",
) -> Callable:
    """CG-posterior predictor with the expensive per-(X_train, theta) state
    computed ONCE: training features, the pivoted-Cholesky/Woodbury
    preconditioner, and the alpha solve. The returned callable evaluates
    (mean, var) for any X_eval, ``test_chunk`` rows at a time.

    Runs on ``device``, the card unless the caller asks for the CPU; with
    no CUDA device and no ``device="cpu"`` it raises. Inputs may be numpy
    arrays or tensors on any device. The solves are float64 on every
    device, the GP side's type (``config.GP_DTYPE``). The JAX package solves
    in float32 off the CPU (dqgp_tpu/parallel/blocked.py:1208-1213, for a
    TPU's HBM and its emulated float64); on BASELINE config #7 a float32 CG
    leaves the posterior mean 5e-3 from the dense float64 one at 4,096 rows
    and does not converge in 400 iterations at 49,999. Features are float32
    from the circuit kernel, upcast; fidelity features stay complex.

    Non-converged solves warn: the alpha solve at set-up, the variance
    solves once per predict() call. ``predict.alpha_result`` holds the alpha
    solve's CGResult, ``predict.variance_results`` the last call's."""
    dev = config.resolve_device(device)
    _check_no_regularization(spec)
    dtype = config.GP_DTYPE
    if spec.kernel_type == "fidelity":
        fdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    else:
        fdtype = dtype
    theta32 = torch.as_tensor(theta, device=dev).to(torch.float32)

    def feats(X):
        X32 = torch.as_tensor(X, device=dev).to(torch.float32)
        return kernel_features(spec, X32, theta32).to(fdtype)

    F_tr = feats(X_train)
    y = torch.as_tensor(Y_train, device=dev).to(dtype)
    sigma2 = noise_std**2 + jitter

    A, precond, res = _cg_setup(spec, F_tr, y, sigma2, block,
                                cg_tol, cg_maxiter, precond_rank, dtype)
    alpha = res.x[:, 0]
    # residual_norm is relative to ||b||; a loose 30x band avoids false
    # alarms from a last-iteration overshoot (as the JAX package's)
    if res.residual_norm > 30 * cg_tol:
        warnings.warn(
            f"CG alpha solve did not converge: relative residual "
            f"{res.residual_norm:.2e} after {res.iterations} iterations "
            f"(cg_tol={cg_tol:.1e}); posterior mean/var will be inaccurate. "
            f"Raise cg_maxiter or precond_rank.", RuntimeWarning)

    def predict(X_eval) -> Tuple[torch.Tensor, torch.Tensor]:
        F_ev = feats(X_eval)
        means, vars_, sols = [], [], []
        for s in range(0, F_ev.shape[0], test_chunk):
            F_c = F_ev[s:s + test_chunk]
            K_ts = gram_from_features(spec, F_tr, F_c).to(dtype)  # (N, m)
            means.append(K_ts.transpose(0, 1) @ alpha)
            sol = cg_solve(A, K_ts, cg_tol, cg_maxiter, precond)
            sols.append(sol._replace(x=None))
            vars_.append(torch.clamp(
                _k_diag(spec, F_c, dtype) - torch.sum(K_ts * sol.x, dim=0), min=1e-10))
        predict.variance_results = sols
        worst = max((r.residual_norm for r in sols), default=0.0)
        if worst > 30 * cg_tol:
            warnings.warn(
                f"CG variance solve did not converge: worst relative "
                f"residual {worst:.2e} (cg_tol={cg_tol:.1e}); predictive "
                f"variances will be inaccurate.", RuntimeWarning)
        return torch.cat(means), torch.cat(vars_)

    predict.alpha_result = res
    predict.variance_results = []
    return predict


def predict_quantum_gp_large(
    spec: QuantumKernelSpec,
    X_train,
    Y_train,
    X_test,
    theta,
    noise_std: float,
    device="cuda",
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in twin of ``predict_quantum_gp`` for training sets whose dense
    Gram no longer fits (one-shot form of ``make_cg_predictor``, on
    ``device``: the card unless the caller asks for the CPU)."""
    return make_cg_predictor(spec, X_train, Y_train, theta, noise_std,
                             device=device, **kwargs)(X_test)
