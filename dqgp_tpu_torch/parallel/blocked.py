"""Scale-out GP: the matrix-free CG posterior, the low-rank eigenvalue clip
and the Gram-free blocked Cholesky.

Port of the single-device parts of ``dqgp_tpu/parallel/blocked.py``
(BASELINE config #7: ~50k training rows, where the dense N x N Gram no longer
fits). Per-sample features are small (N x 3n floats), only the Gram is huge,
so:

* features are computed once (one circuit-kernel launch);
* the Gram is never materialized — ``gram_matvec`` streams column blocks of
  K, one outer-kernel tile and one matmul per block;
* the posterior solves are preconditioned conjugate gradients on
  (K + sigma^2 I), batched over right-hand sides, with a rank-k
  pivoted-Cholesky/Woodbury preconditioner (Jacobi at rank 0);
* square-Gram regularization (``spec.regularization``) is the low-rank
  eigenvalue clip: K's bottom eigenpairs from a matrix-free LOBPCG
  (``ops/lobpcg.py``) on the flipped operator c I - K;
* the exact NLL at scale (``nll_large``) comes from a blocked Cholesky
  factor whose panels are generated from the features as they are needed.

The CG loop tests convergence after every iteration (one scalar read per
iteration on the card), so it stops at the iteration the JAX package's
``lax.while_loop`` stops at. The mesh-sharded variants are not ported.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from .. import config, tracing
from ..models.gp.metrics import outer_diag
from ..models.kernels.quantum_kernel import (
    QuantumKernelSpec,
    gram_from_features,
    kernel_features,
)
from ..ops.lobpcg import lobpcg_standard


class LowRankRegularizer(NamedTuple):
    """Low-rank correction representing squlearn's square-Gram regularization
    matrix-free: K_reg = K + V diag(w) V^T + shift * I.

    * thresholding — w_i = -lambda_i for the captured negative eigenvalues
      (subtracting the negative spectrum == eigenvalue clip at 0), shift = 0.
    * tikhonov     — w = 0, shift = max(0, -lambda_min) (the reference adds
      the most negative eigenvalue to the diagonal, main.py:2011-2013 /
      regularize_gram).

    Exact when ``rank`` >= the number of negative eigenvalues. ``saturated``
    is True when every captured pair was negative: the rank budget may have
    missed further negatives, and a larger rank is the retry.

    Accuracy: the eigenpairs come from LOBPCG, not an exact eigh. On
    feature Grams the float64 LOBPCG stops at ``lobpcg_iters`` before its
    tolerance, and lambda_min is a Ritz value above eigh's by ~1e-8 to 1e-7
    of lambda_max (measured at 200-4,096 rows). NLLs amplify a tikhonov
    shift error by ~tr(C^-1)/2, so do not hold NLLs to the dense clip's
    tighter than ~1e-4 absolute.
    """

    V: torch.Tensor           # (N, r) captured eigenvectors
    w: torch.Tensor           # (r,) correction weights (0 for non-negative pairs)
    shift: torch.Tensor       # scalar diagonal shift (tikhonov)
    lambda_min: torch.Tensor  # smallest captured eigenvalue of K
    saturated: torch.Tensor   # bool: rank budget possibly insufficient

    def matvec(self, Kv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """K_reg @ v given K @ v (v: (N,) or (N, R))."""
        v2 = v[:, None] if v.ndim == 1 else v
        corr = self.V @ (self.w[:, None] * (self.V.T @ v2))
        return Kv + corr.reshape(Kv.shape) + self.shift * v

    def diag_correction(self) -> torch.Tensor:
        """diag(K_reg) - diag(K): (N,)."""
        return torch.sum(self.V * self.V * self.w[None, :], dim=1) + self.shift


def make_lowrank_regularizer_from_matvec(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    method: str,
    rank: int = 16,
    lobpcg_iters: int = 200,
    power_iters: int = 24,
    dtype=torch.float32,
    device="cuda",
) -> LowRankRegularizer:
    """Low-rank eigenvalue clip from a symmetric matvec on ``device`` (the
    card unless the caller asks for the CPU).

    Finds the ``rank`` smallest eigenpairs of K via LOBPCG on (c I - K)
    (c >= lambda_max from power iteration, so the operator is PSD and its
    TOP eigenpairs are K's bottom ones), then builds the correction for
    ``method`` ('thresholding' | 'tikhonov'). LOBPCG needs 5 * rank < n:
    rank is clamped to n // 5, and where that still equals n / 5 (n <= 80
    and a multiple of 5) LOBPCG raises, as in the JAX package."""
    if method not in ("thresholding", "tikhonov"):
        raise ValueError(f"Unknown regularization {method!r}")
    dev = config.resolve_device(device)
    rank = int(min(rank, max(1, n // 5)))

    # lambda_max upper bound: power iteration + a safety margin
    v0 = (torch.ones((n, 1), dtype=dtype, device=dev)
          + torch.linspace(0, 0.5, n, dtype=dtype, device=dev)[:, None])
    v = v0 / torch.linalg.norm(v0)
    tiny = torch.finfo(dtype).tiny
    for _ in range(power_iters):
        w_ = matvec(v)
        v = w_ / torch.clamp(torch.linalg.norm(w_), min=tiny)
    lam_max = torch.sum(v * matvec(v))
    c = 1.05 * torch.abs(lam_max) + 1e-3

    def flipped(X):
        return c * X - matvec(X)

    # deterministic full-rank start block
    i = torch.arange(n, dtype=dtype, device=dev)[:, None]
    j = torch.arange(rank, dtype=dtype, device=dev)[None, :]
    X0 = torch.cos(i * (j + 1) * 0.37 + j) + 1e-3
    theta, U, _ = lobpcg_standard(flipped, X0, m=lobpcg_iters)
    lam = c - theta                                   # ascending smallest of K
    neg = lam < 0.0
    if method == "thresholding":
        w = torch.where(neg, -lam, torch.zeros_like(lam)).to(dtype)
        shift = torch.zeros((), dtype=dtype, device=dev)
    else:  # tikhonov
        w = torch.zeros_like(lam).to(dtype)
        shift = torch.clamp(-torch.min(lam), min=0.0).to(dtype)
    return LowRankRegularizer(V=U.to(dtype), w=w, shift=shift,
                              lambda_min=torch.min(lam).to(dtype), saturated=torch.all(neg))


def make_lowrank_regularizer(
    spec: QuantumKernelSpec,
    F: torch.Tensor,
    rank: int = 16,
    block: int = 2048,
    lobpcg_iters: int = 200,
    dtype=torch.float32,
) -> LowRankRegularizer:
    """``make_lowrank_regularizer_from_matvec`` on the feature-factored Gram
    of ``F`` (the training Gram only: squlearn regularizes square Grams,
    never the cross Grams), on F's device."""
    n = F.shape[0]
    mask = torch.ones((n,), dtype=dtype, device=F.device)

    def mv(v):
        return gram_matvec(spec, F, v.to(dtype), mask, block)

    return make_lowrank_regularizer_from_matvec(
        mv, n, spec.regularization, rank=rank, lobpcg_iters=lobpcg_iters,
        dtype=dtype, device=F.device)


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
    with tracing.span("blocked.gram_matvec"):
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
        with tracing.span("sync.cg_residual"):
            return float(torch.max(torch.sqrt(colsum(r * r)) / b_norm))

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    it = 0
    residual = rel_residual(r)
    while it < maxiter and residual > tol:
        # an iteration ends in the host's read of its residual
        with tracing.span("blocked.cg_iteration"):
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
            residual = rel_residual(r)
    return CGResult(x, it, residual)


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
    solve. Used by ``gp_posterior_large`` and ``make_cg_predictor``.

    ``spec.regularization`` is honored via the low-rank eigenvalue clip:
    the matvec becomes K_reg @ v (+ sigma^2 v). The correction's magnitude
    is ~|lambda_min| (roundoff scale), so the Woodbury preconditioner built
    from the unregularized K is kept; Jacobi adds the diagonal correction."""
    n = F_train.shape[0]
    mask = torch.ones((n,), dtype=dtype, device=F_train.device)

    with tracing.span("blocked.setup"):
        reg = None
        if spec.regularization is not None:
            reg = make_lowrank_regularizer(spec, F_train, block=block, dtype=dtype)
        if precond_rank > 0:
            Lp = pivoted_cholesky(spec, F_train, min(precond_rank, n))
            precond = woodbury_preconditioner(Lp.to(dtype), sigma2)
        else:
            precond = _k_diag(spec, F_train, dtype) + sigma2
            if reg is not None:
                precond = precond + reg.diag_correction()

    def A(v):
        Kv = gram_matvec(spec, F_train, v, mask, block)
        if reg is not None:
            Kv = reg.matvec(Kv, v)
        return Kv + sigma2 * v

    with tracing.span("blocked.alpha_solve"):
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
    tracing.new_unit()
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
        with tracing.span("blocked.var_solve"):
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
    tracing.new_unit()  # the set-up's spans and every predict() call's
    dev = config.resolve_device(device)
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
            with tracing.span("blocked.var_solve"):
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


# ---------------------------------------------------------------------------
# Gram-free blocked Cholesky: exact logdet/NLL at scale
# ---------------------------------------------------------------------------


def gram_free_blocked_cholesky(
    spec: QuantumKernelSpec,
    F: torch.Tensor,          # (N, D) features
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 1024,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky factor of (K + sigma^2 I) without materializing K, on F's
    device.

    Left-looking blocked factorization: each column panel's Gram block is
    generated from the (tiny) feature matrix when it is factored, and only
    its rows from the panel's diagonal block down (the rows a lower factor
    needs). The factor is one preallocated (n_pad, n_pad) buffer written in
    place a panel at a time, so peak memory is the factor plus one
    (n_pad, block) panel, its correction L[kB:, :kB] @ L[kB:(k+1)B, :kB]^T
    and the outer kernel's temporaries for it. (The JAX package stores the
    factor as panel slabs so that XLA updates it in place.)

    Returns (L, logdet): L is (n_pad, n_pad) with N padded up to a multiple
    of ``block``; padded rows are an identity block, so logdet is the
    unpadded system's. A panel that is not positive definite makes L and
    logdet NaN from there on, as a failed float Cholesky does in the JAX
    package."""
    L, logdet, _ = _gram_free_blocked_cholesky_factor(spec, F, noise_std, jitter, block, dtype)
    return L, logdet


def _gram_free_blocked_cholesky_factor(
    spec: QuantumKernelSpec,
    F: torch.Tensor,
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 1024,
    dtype=torch.float32,
):
    if dtype == torch.float32:
        config.check_full_precision_matmul()  # no TF32 in the factor's products
    n = F.shape[0]
    # the clip is built on the unpadded rows; its V is then zero-padded, so
    # padded rows stay an identity block
    reg = None
    if spec.regularization is not None:
        reg = make_lowrank_regularizer(spec, F, block=block, dtype=dtype)
    Fp, n_pad = _pad_rows(F, block)
    mask = _pad_rows(torch.ones((n, 1), dtype=dtype, device=F.device), block)[0][:, 0]
    if reg is not None:
        reg = reg._replace(V=_pad_rows(reg.V, block)[0])
    sigma2 = noise_std**2 + jitter

    L = torch.zeros((n_pad, n_pad), dtype=dtype, device=F.device)
    for s in range(0, n_pad, block):
        e = s + block
        m_k = mask[s:e]
        # the panel's rows s.. of K[:, s:e], regularized and masked
        P = gram_from_features(spec, Fp[s:], Fp[s:e]).to(dtype)
        if reg is not None:
            P += (reg.V[s:] * reg.w[None, :]) @ reg.V[s:e].T
            if spec.regularization == "tikhonov":
                P[:block].diagonal().add_(reg.shift * m_k)
        P *= mask[s:, None] * m_k[None, :]
        P[:block].diagonal().add_(sigma2 * m_k + (1.0 - m_k))
        if s:
            P -= L[s:, :s] @ L[s:e, :s].T
        L_kk, info = torch.linalg.cholesky_ex(P[:block])
        L_kk = torch.where(info == 0, L_kk, torch.full_like(L_kk, float("nan")))
        L[s:e, s:e] = L_kk
        if e < n_pad:
            # P[block:] @ L_kk^{-T}
            L[e:, s:e] = torch.linalg.solve_triangular(L_kk.T, P[block:], upper=True,
                                                       left=False)
        del P
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return L, logdet, n_pad


def nll_large(
    spec: QuantumKernelSpec,
    F: torch.Tensor,
    y,
    noise_std: float,
    jitter: float = 0.0,
    block: int = 1024,
    dtype=torch.float32,
):
    """Exact GP NLL (+components) at scale via the Gram-free blocked
    Cholesky, on F's device.

    agent_riemannian.py:442-460 semantics: 0.5 logdet + 0.5 y^T C^{-1} y +
    0.5 N log(2 pi) with C = K + sigma^2 I. The forward substitution runs a
    block at a time on the factor, so peak memory stays the factor and one
    panel. Returns (nll, {"log_det_term", "quadratic_term",
    "constant_term"}), 0-d tensors of ``dtype``."""
    n = F.shape[0]
    L, logdet, n_pad = _gram_free_blocked_cholesky_factor(spec, F, noise_std, jitter,
                                                          block, dtype)
    y_pad = _pad_rows(torch.as_tensor(y, device=F.device).to(dtype)[:, None], block)[0]
    w = torch.zeros_like(y_pad)
    for s in range(0, n_pad, block):
        e = s + block
        # rhs = y_k - L[kB:(k+1)B, :kB] @ w[:kB]  (columns past the block are zero)
        rhs = y_pad[s:e] - L[s:e, :s] @ w[:s]
        w[s:e] = torch.linalg.solve_triangular(L[s:e, s:e], rhs, upper=False)
    quad = 0.5 * torch.sum(w * w)
    const = torch.tensor(0.5 * n * math.log(2.0 * math.pi), dtype=dtype, device=F.device)
    ld = 0.5 * logdet
    return ld + quad + const, {"log_det_term": ld, "quadratic_term": quad,
                               "constant_term": const}
