"""GP linear algebra with the reference's numerical-fallback semantics.

Port of the direct subset of ``dqgp_tpu/ops/linalg.py``. The reference's
solve chain is Cholesky -> LU -> pinv (agent_riemannian.py:414-428). Here a
failed factorization is detected from ``torch.linalg.cholesky_ex``'s
``info``, and the eigh-pinv rescue runs only for the batch members that
failed. Every function takes leading batch dimensions (agents, CV folds).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing


class SolveResult(NamedTuple):
    """Result of a PSD solve; ``L`` is the identity where ``chol_ok`` is False."""

    C_inv: torch.Tensor      # (..., N, N); zeros if the inverse was not asked for
    C_inv_y: torch.Tensor    # (..., N)
    logdet: torch.Tensor     # (...)
    chol_ok: torch.Tensor    # (...) bool
    L: torch.Tensor          # (..., N, N)


def _tri_solve(L: torch.Tensor, B: torch.Tensor, upper: bool) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=upper)


def _pinv_rescue(C: torch.Tensor, y: torch.Tensor):
    """C^{-1}, C^{-1} y and log|det C| from a float32 eigendecomposition, as
    the JAX package's rescue branch computes them (linalg.py:84-96)."""
    n = C.shape[-1]
    w32, V32 = torch.linalg.eigh(C.to(torch.float32))
    w, V = w32.to(C.dtype), V32.to(C.dtype)
    cutoff = torch.amax(torch.abs(w), dim=-1, keepdim=True) * n * torch.finfo(torch.float32).eps
    w_inv = torch.where(torch.abs(w) > cutoff, 1.0 / w, torch.zeros_like(w))
    C_inv = (V * w_inv[..., None, :]) @ V.transpose(-1, -2)
    C_inv_y = (C_inv @ y[..., None])[..., 0]
    logdet = torch.sum(torch.log(torch.abs(w) + 1e-8), dim=-1)
    return C_inv, C_inv_y, logdet


def solve_psd_with_fallback(C: torch.Tensor, y: torch.Tensor, fallback: bool = True,
                            need_inverse: bool = True) -> SolveResult:
    """C^{-1}, C^{-1} y and logdet(C) via Cholesky, eigh-pinv on failure.

    ``fallback=False`` flags a failed factorization with NaN outputs and
    ``chol_ok=False`` instead (the callers' "flag" semantics); that path
    neither synchronises with the host nor uploads anything, so a CUDA graph
    can capture it. The rescue reads ``failed.any()`` on the host and runs
    only outside a graph. ``need_inverse=False`` skips the explicit inverse
    on the Cholesky path."""
    n = C.shape[-1]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    L, info = torch.linalg.cholesky_ex(C)
    chol_ok = info == 0
    L_safe = torch.where(chol_ok[..., None, None], L, eye)

    w = _tri_solve(L_safe, y[..., None], upper=False)
    C_inv_y = _tri_solve(L_safe.transpose(-1, -2), w, upper=True)[..., 0]
    if need_inverse:
        Vi = _tri_solve(L_safe, eye.expand_as(C), upper=False)
        C_inv = _tri_solve(L_safe.transpose(-1, -2), Vi, upper=True)
    else:
        C_inv = torch.zeros_like(C)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L_safe, dim1=-2, dim2=-1)), dim=-1)

    failed = ~chol_ok
    if fallback:
        with tracing.span("sync.rescue_check"):
            rescue = bool(failed.any())
        if rescue:
            # rescue only the batch members whose factorization failed
            Ci, Ciy, ld = _pinv_rescue(C[failed], y[failed])
            C_inv, C_inv_y, logdet = C_inv.clone(), C_inv_y.clone(), logdet.clone()
            C_inv[failed], C_inv_y[failed], logdet[failed] = Ci, Ciy, ld
    else:
        nan = float("nan")
        C_inv = torch.where(failed[..., None, None], C_inv.new_full((), nan), C_inv)
        C_inv_y = torch.where(failed[..., None], C_inv_y.new_full((), nan), C_inv_y)
        logdet = torch.where(failed, logdet.new_full((), nan), logdet)
    return SolveResult(C_inv, C_inv_y, logdet, chol_ok, L_safe)


def get_psd_solver(solver: str):
    """'direct' -> solve_psd_with_fallback; 'direct-flag' -> the same with
    failures flagged as NaN whatever the caller's ``fallback`` (CV folds,
    which the driver re-scores through 'direct')."""
    if solver == "direct":
        return solve_psd_with_fallback
    if solver == "direct-flag":
        def direct_flag(C, y, fallback: bool = True, need_inverse: bool = True):
            del fallback  # the solver string wins
            return solve_psd_with_fallback(C, y, fallback=False,
                                           need_inverse=need_inverse)
        return direct_flag
    raise NotImplementedError(
        f"solver {solver!r} is not ported (the port has 'direct' and "
        f"'direct-flag'; the mixed solvers exist for emulated float64)")


def condition_number(C: torch.Tensor) -> torch.Tensor:
    """2-norm condition number from a float64 ``eigvalsh`` (|eigenvalues| are
    the singular values of the symmetric Grams this is applied to). A
    non-finite C (a flagged agent's NaN state) reads NaN, as XLA's eigvalsh
    returns it; torch's would raise."""
    C64 = C.to(torch.float64)
    finite = torch.isfinite(C64).all(dim=-1).all(dim=-1)
    eye = torch.eye(C.shape[-1], dtype=torch.float64, device=C.device)
    w = torch.abs(torch.linalg.eigvalsh(torch.where(finite[..., None, None], C64, eye)))
    cond = torch.amax(w, dim=-1) / torch.amin(w, dim=-1)
    return torch.where(finite, cond, cond.new_full((), float("nan"))).to(C.dtype)


def masked_identity_pad(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero padded rows/cols of a Gram and put 1 on padded diagonal entries,
    so the padded block is an identity that decouples from the real one."""
    m2 = mask[..., :, None] * mask[..., None, :]
    return K * m2 + torch.diag_embed(1.0 - mask)
