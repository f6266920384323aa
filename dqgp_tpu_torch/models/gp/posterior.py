"""GP posterior prediction and per-agent NLL + gradient.

Port of ``dqgp_tpu/models/gp/posterior.py`` on the direct float64 solver.
Numerics mirror the reference:

* predict path (main.py:1364-1488): C = K + sigma^2 I + 1e-6 I, Cholesky
  solve, mean = K_*^T alpha, var = diag(K_**) - sum(v^2) clamped >= 1e-10,
  explicit-inverse fallback.
* agent NLL path (agent_riemannian.py:409-471): C = K + sigma^2 I (no
  jitter), dL/dtheta_p = 0.5 * sum((C^{-1} - alpha alpha^T) * dK_p^T),
  NLL = 0.5 logdet + 0.5 y^T C^{-1} y + 0.5 N log(2 pi).

Ragged agent shards and CV folds are padded and masked
(``masked_identity_pad``); every function takes leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ... import config
from ...ops.linalg import (
    condition_number,
    get_psd_solver,
    masked_identity_pad,
    solve_psd_with_fallback,
)
from ..kernels.quantum_kernel import (
    QuantumKernelSpec,
    gram_from_features,
    kernel_features,
)
from .metrics import outer_diag


class NLLResult(NamedTuple):
    nll: torch.Tensor
    grad: torch.Tensor
    log_det_term: torch.Tensor
    quadratic_term: torch.Tensor
    constant_term: torch.Tensor
    condition_number: torch.Tensor
    chol_ok: torch.Tensor


def masked_nll_core(
    K: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    noise_std: float,
    compute_cond: bool = True,
    fallback: bool = True,
) -> Tuple[NLLResult, torch.Tensor]:
    """NLL (components, cond) plus the gradient bracket C^{-1} - alpha alpha^T.

    K (..., N, N), y and mask (..., N). The result's ``grad`` is an empty
    placeholder."""
    dtype = K.dtype
    mask = mask.to(dtype)
    y = (y * mask).to(dtype)
    Km = masked_identity_pad(K, mask)
    C = Km + (noise_std**2) * torch.diag_embed(mask)  # sigma^2 only on real rows

    res = solve_psd_with_fallback(C, y, fallback=fallback)
    alpha = res.C_inv_y
    bracket = res.C_inv - alpha[..., :, None] * alpha[..., None, :]

    n_real = torch.sum(mask, dim=-1)
    log_det_term = 0.5 * res.logdet  # padded block contributes log(1) = 0
    quadratic_term = 0.5 * torch.sum(y * alpha, dim=-1)
    constant_term = 0.5 * n_real * math.log(2.0 * math.pi)
    nll = log_det_term + quadratic_term + constant_term

    if compute_cond:
        # The reference conditions the noise-free K (agent_riemannian.py:411).
        # Padded rows take the mean real diagonal, which lies inside the real
        # spectrum and leaves max/min untouched.
        diag = torch.diagonal(K, dim1=-2, dim2=-1)
        diag_mean = torch.sum(diag * mask, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
        m2 = mask[..., :, None] * mask[..., None, :]
        K_cond = K * m2 + torch.diag_embed((1.0 - mask) * diag_mean[..., None])
        cond = condition_number(K_cond)
    else:
        cond = torch.full(nll.shape, float("nan"), dtype=dtype, device=K.device)
    out = NLLResult(nll, K.new_zeros((0,)), log_det_term, quadratic_term,
                    constant_term, cond, res.chol_ok)
    return out, bracket


def masked_nll_and_grad(
    K: torch.Tensor,
    dK: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    noise_std: float,
    compute_cond: bool = True,
    fallback: bool = True,
) -> NLLResult:
    """NLL, its three components, and d(NLL)/dtheta for (padded) agents.

    K (..., N, N); dK (..., P, N, N); y, mask (..., N) with 1 = real row.
    Reference: agent_riemannian.py:409-471."""
    dtype = K.dtype
    res, bracket = masked_nll_core(K, y, mask, noise_std, compute_cond=compute_cond,
                                   fallback=fallback)
    m = mask.to(dtype)
    m2 = m[..., :, None] * m[..., None, :]
    dKm = dK.to(dtype) * m2[..., None, :, :]
    grad = 0.5 * torch.einsum("...ij,...pji->...p", bracket, dKm)
    return res._replace(grad=grad)


def gp_posterior_from_grams(
    K_tt: torch.Tensor,
    K_st: torch.Tensor,
    K_ss_diag: torch.Tensor,
    y_train: torch.Tensor,
    noise_std: float,
    jitter: float = 1e-6,
    train_mask: Optional[torch.Tensor] = None,
    solver: str = "direct",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Posterior mean/var from precomputed Grams. Returns (mean, var, chol_ok).

    K_tt (..., N, N), K_st (..., M, N), K_ss_diag (..., M), y_train (..., N).
    Reference semantics main.py:1433-1466."""
    dtype = K_tt.dtype
    if train_mask is None:
        train_mask = torch.ones(K_tt.shape[:-1], dtype=dtype, device=K_tt.device)
    m = train_mask.to(dtype)
    Km = masked_identity_pad(K_tt, m)
    C = Km + (noise_std**2 + jitter) * torch.diag_embed(m)
    y = y_train * m
    K_st = K_st * m[..., None, :]

    res = get_psd_solver(solver)(C, y, need_inverse=False)
    mean = (K_st @ res.C_inv_y[..., None])[..., 0]
    # var = diag(K_**) - sum(v^2), v = L^{-1} K_st^T on the Cholesky path; on
    # the rescue path the explicit inverse (main.py:1476-1482).
    v = torch.linalg.solve_triangular(res.L, K_st.transpose(-1, -2), upper=False)
    var = K_ss_diag - torch.sum(v * v, dim=-2)
    if not solver.endswith("-flag") and not bool(res.chol_ok.all()):
        # flag solvers carry no rescue: a failed fold's mean is already NaN
        inv_var = K_ss_diag - torch.sum((K_st @ res.C_inv) * K_st, dim=-1)
        var = torch.where(res.chol_ok[..., None], var, inv_var)
    var = torch.clamp(var, min=1e-10)
    return mean, var, res.chol_ok


def predict_quantum_gp(
    spec: QuantumKernelSpec,
    X_train: torch.Tensor,
    Y_train: torch.Tensor,
    X_test: torch.Tensor,
    theta: torch.Tensor,
    noise_std: float = 0.1,
    jitter: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-to-end posterior predict (mean, var) — main.py:1364-1488 twin.

    Runs on the device of its tensors. Features are float32 (the kernel
    path), upcast to float64 before the Grams; the test-test Gram is never
    materialized (only its diagonal enters the variance)."""
    dtype = config.GP_DTYPE
    F_tr = kernel_features(spec, X_train, theta)
    F_te = kernel_features(spec, X_test, theta)
    if spec.kernel_type == "fidelity":
        F_tr, F_te = F_tr.to(torch.complex128), F_te.to(torch.complex128)
    else:
        F_tr, F_te = F_tr.to(dtype), F_te.to(dtype)
    K_tt = gram_from_features(spec, F_tr).to(dtype)
    K_st = gram_from_features(spec, F_te, F_tr).to(dtype)
    if spec.kernel_type == "fidelity":
        K_ss_diag = torch.ones(X_test.shape[0], dtype=dtype, device=X_test.device)
    else:
        K_ss_diag = outer_diag(spec.outer_kernel, F_te, spec.outer_params).to(dtype)
    mean, var, _ = gp_posterior_from_grams(
        K_tt, K_st, K_ss_diag, Y_train.to(dtype), noise_std, jitter,
        solver="direct",
    )
    return mean, var
