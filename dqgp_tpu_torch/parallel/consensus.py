"""Multi-agent ADMM consensus step on one device.

Port of the single-device path of ``dqgp_tpu/parallel/consensus.py``. The
agents are a written-out batch dimension: their padded, masked shards live on
the device as (A, Nmax, ...) tensors, and one step runs

1. z = round4(circular_mean(theta + psi/rho))   [consensus, from OLD state]
2. for every agent at once: the Gram at wrap(z), the masked float64 NLL and
   its gradient by the reference's h=pi/8 central difference, the proximal
   theta update and the dual psi update, with the reference's 4-decimal
   rounding (main.py:2507-2555; agent_riemannian.py:438, 485-486).

Two ways to form the gradient (``grad_method``), as in the JAX package:

* ``"central"`` materializes the 2P+1 shifted Grams of every agent, whose
  angle rows all go through ONE circuit-kernel launch: O(A P N^2) memory.
* ``"streamed"`` forms the Gram at wrap(z) first (one launch), then for each
  parameter p the +h and -h shifted features of all agents (one launch of
  2 A N rows) and from them g_p: the shifted Gram pair, differenced in
  float32, upcast and contracted with the solve bracket at once, O(A N^2)
  live memory whatever P is. On the card, for float32 features of the
  projected Matern kernel and a float64 GP side, one hand-written kernel a
  parameter (``ops.cuda_pair``) does that without storing the pair.

Both give the same gradient up to the order of the final sums. The third,
``"autodiff"``, is the exact gradient of the NLL at wrap(z) by
``torch.autograd``: the Gram's features go through the same kernels
forward and through the hand-written adjoint kernel (``circuit_vjp``)
backward, the rest (Gram, Cholesky solve) through PyTorch's own backward.
The JAX package differentiates its XLA engine, since its Pallas kernels
have no VJP.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from .. import manifold as M
from ..models.gp.posterior import NLLResult, masked_nll_and_grad, masked_nll_core
from ..models.kernels.quantum_kernel import (
    QuantumKernelSpec,
    features_from_angles,
    gram_and_shift_grads,
    gram_from_features,
)
from ..ops import cuda_pair
from ..ops.statevector import angle_matrix

GRAD_METHODS = ("central", "streamed", "autodiff")


class AgentBatch(NamedTuple):
    """Static-shape agent shards: X (A, Nmax, D) f32, Y and mask (A, Nmax) f64."""

    X: torch.Tensor
    Y: torch.Tensor
    mask: torch.Tensor


class AgentStepOut(NamedTuple):
    theta: torch.Tensor            # (A, P)
    psi: torch.Tensor              # (A, P)
    z: torch.Tensor                # (P,)
    nll: torch.Tensor              # (A,)
    log_det_term: torch.Tensor     # (A,)
    quadratic_term: torch.Tensor   # (A,)
    constant_term: torch.Tensor    # (A,)
    condition_number: torch.Tensor # (A,)


def make_agent_batch(agent_data_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
                     device, pad_to: Optional[int] = None) -> AgentBatch:
    """Pack ragged per-agent (X_i, Y_i) into padded, masked tensors on ``device``."""
    n_max = pad_to or max(x.shape[0] for x, _ in agent_data_splits)
    d = agent_data_splits[0][0].shape[1]
    A = len(agent_data_splits)
    X = np.zeros((A, n_max, d), np.float32)
    Y = np.zeros((A, n_max), np.float64)
    mask = np.zeros((A, n_max), np.float64)
    for i, (Xi, Yi) in enumerate(agent_data_splits):
        ni = Xi.shape[0]
        if ni > n_max:
            raise ValueError(f"agent {i} has {ni} > pad_to={n_max} samples")
        X[i, :ni] = Xi
        Y[i, :ni] = Yi
        mask[i, :ni] = 1.0
    return AgentBatch(*(torch.as_tensor(a, device=device) for a in (X, Y, mask)))


def agent_features(spec: QuantumKernelSpec, X: torch.Tensor,
                   thetas: torch.Tensor) -> torch.Tensor:
    """Features (A, S, N, F) of every agent's shard X (A, N, D) at each of S
    parameter vectors thetas (S, P), with all A*S*N angle rows in ONE
    feature call (float32 angles)."""
    angles = angle_matrix(spec.circuit, X[:, None], thetas, torch.float32)  # (A, S, N, G)
    flat = features_from_angles(spec, angles.reshape(-1, angles.shape[-1]))
    return flat.reshape(*angles.shape[:-1], flat.shape[-1])


def agent_grams(spec: QuantumKernelSpec, X: torch.Tensor,
                thetas: torch.Tensor) -> torch.Tensor:
    """Grams (A, S, N, N) of ``agent_features``; float32 like the features."""
    return gram_from_features(spec, agent_features(spec, X, thetas))


def streamed_nll_and_grad(spec: QuantumKernelSpec, batch: AgentBatch,
                          z32: torch.Tensor, h: float, noise_std: float, *,
                          dtype=torch.float64, compute_cond: bool = True,
                          fallback: bool = True):
    """The masked NLL and its central-difference gradient, one parameter at
    a time (dqgp_tpu/parallel/consensus.py:161-190).

    z32 (P,) is the wrapped consensus vector in float32. The shifted vectors
    are formed and wrapped in float32, as ``shift_parameter_batch`` forms
    them, and each dK_p = (K_+ - K_-) / 2h is differenced in float32 before
    the upcast, so the gradient is the central path's up to the order of
    its sums.

    Where ``cuda_pair.takes_kernel`` holds (float32 features on the card, a
    float64 GP side, the projected Matern kernel at a closed-form nu, no
    regularization), g_p comes from the shifted features through one
    ``cuda_pair.shift_pair_contract`` call, written into column p of the
    gradient on the card; everywhere else from the Gram pair in PyTorch."""
    F0 = agent_features(spec, batch.X, z32[None])
    K = gram_from_features(spec, F0)[:, 0]
    mask = batch.mask.to(dtype)
    res, bracket = masked_nll_core(K.to(dtype), batch.Y.to(dtype), mask, noise_std,
                                   compute_cond=compute_cond, fallback=fallback)
    del K
    P = z32.shape[0]
    eye = torch.eye(P, dtype=z32.dtype, device=z32.device)
    shifts = (torch.remainder(torch.stack([z32 + h * eye[p], z32 - h * eye[p]]), M.PERIOD)
              for p in range(P))
    if cuda_pair.takes_kernel(spec, F0.device, F0.dtype, F0.shape[-1], dtype):
        length_scale, nu = cuda_pair.matern_params(spec)
        bracket = bracket.contiguous()
        grad = torch.empty((batch.X.shape[0], P), dtype=dtype, device=z32.device)
        for p, pair in enumerate(shifts):
            cuda_pair.shift_pair_contract(agent_features(spec, batch.X, pair), bracket, mask, h,
                                          length_scale, nu, out=grad[:, p])
        return res._replace(grad=grad)
    m2 = mask[:, :, None] * mask[:, None, :]
    bracket_t = bracket.transpose(-1, -2)  # g_p = 1/2 sum_ij bracket_ij dK_p,ji
    grads = [cuda_pair.contract_pair(agent_grams(spec, batch.X, pair), bracket_t, m2, h)
             for pair in shifts]                                       # pairs (A, 2, N, N)
    return res._replace(grad=torch.stack(grads, dim=-1))


def autodiff_nll_and_grad(spec: QuantumKernelSpec, batch: AgentBatch,
                          z_manifold: torch.Tensor, noise_std: float, *,
                          dtype=torch.float64, compute_cond: bool = True,
                          fallback: bool = True):
    """The masked NLL of every agent at the wrapped consensus vector and its
    exact gradient by ``torch.autograd`` (dqgp_tpu/parallel/consensus.py:
    145-160): the loss is over t in the GP dtype, the Gram is built from
    t.to(float32) and upcast, and the NLL comes from ``masked_nll_and_grad``
    with an empty dK. The features run the kernels of the other gradients
    forward and the adjoint kernel backward."""
    A, P = batch.X.shape[0], z_manifold.shape[0]
    with torch.enable_grad():
        t = z_manifold.to(dtype).expand(A, P).clone().requires_grad_(True)
        angles = angle_matrix(spec.circuit, batch.X, t.to(torch.float32),
                              torch.float32)                            # (A, N, G)
        flat = features_from_angles(spec, angles.reshape(-1, angles.shape[-1]))
        K = gram_from_features(spec, flat.reshape(*angles.shape[:-1], flat.shape[-1]))
        Kt = K.to(dtype)
        res = masked_nll_and_grad(Kt, Kt.new_zeros((A, 0) + Kt.shape[1:]),
                                  batch.Y.to(dtype), batch.mask.to(dtype), noise_std,
                                  compute_cond=compute_cond, fallback=fallback)
        (grad,) = torch.autograd.grad(res.nll.sum(), t)
    return NLLResult(*(v.detach() for v in res._replace(grad=grad)))


def agent_updates(
    spec: QuantumKernelSpec,
    z: torch.Tensor,
    psi: torch.Tensor,
    batch: AgentBatch,
    *,
    rho: float,
    L: float,
    noise_std: float,
    shift_value: float = float(np.pi / 8),
    parity_round: bool = True,
    compute_cond: bool = True,
    gp_dtype: str = "float64",
    psd_fallback: bool = True,
    grad_method: str = "central",
):
    """Every agent's local round at the consensus vector z (P,): its Gram
    at wrap(z), the masked NLL and gradient, the proximal theta and dual psi
    updates (agent_riemannian.py:314-491; the JAX package's ``_agent_local``
    over the agent batch). Returns (theta, psi, NLLResult)."""
    if grad_method not in GRAD_METHODS:
        raise NotImplementedError(f"grad_method {grad_method!r}: the port has {GRAD_METHODS}")
    dtype = config.torch_dtype(gp_dtype)
    # The shift batch is built and wrapped in float32, as the reference's
    # kernel path sees it; the f32 Grams are upcast only afterwards.
    z_manifold = M.wrap(z)
    z32 = z_manifold.to(torch.float32)
    if grad_method == "autodiff":
        res = autodiff_nll_and_grad(spec, batch, z_manifold, noise_std, dtype=dtype,
                                    compute_cond=compute_cond, fallback=psd_fallback)
    elif grad_method == "streamed":
        res = streamed_nll_and_grad(spec, batch, z32, shift_value, noise_std,
                                    dtype=dtype, compute_cond=compute_cond,
                                    fallback=psd_fallback)
    else:
        K, dK = gram_and_shift_grads(spec, batch.X, z32, shift_value)
        res = masked_nll_and_grad(K.to(dtype), dK, batch.Y.to(dtype),
                                  batch.mask.to(dtype), noise_std,
                                  compute_cond=compute_cond, fallback=psd_fallback)
    grad = M.round4(res.grad) if parity_round else res.grad
    theta_new = M.admm_update_theta(z_manifold, grad, psi, rho, L)
    psi_new = M.admm_update_psi(psi, theta_new, z_manifold, rho)
    if parity_round:
        theta_new = M.round4(theta_new)
        psi_new = M.round4(psi_new)
    return theta_new, psi_new, res


def admm_iteration(
    spec: QuantumKernelSpec,
    theta: torch.Tensor,
    psi: torch.Tensor,
    batch: AgentBatch,
    *,
    rho: float,
    parity_round: bool = True,
    **kwargs,
) -> AgentStepOut:
    """One bulk-synchronous ADMM round over all agents (theta, psi: (A, P)):
    the consensus z from the old state, then ``agent_updates`` (its keyword
    arguments: L, noise_std, grad_method "central", "streamed" or
    "autodiff", gp_dtype, ...; see the module docstring)."""
    xi = theta + psi / rho
    phase = 2.0 * math.pi * xi / M.PERIOD
    z = M.circular_mean_from_sums(torch.sum(torch.cos(phase), dim=0),
                                  torch.sum(torch.sin(phase), dim=0))
    if parity_round:
        z = M.round4(z)
    theta_new, psi_new, res = agent_updates(spec, z, psi, batch, rho=rho,
                                            parity_round=parity_round, **kwargs)
    return AgentStepOut(theta_new, psi_new, z, res.nll, res.log_det_term,
                        res.quadratic_term, res.constant_term,
                        res.condition_number)


def make_admm_step(spec: QuantumKernelSpec, **kwargs):
    """The per-iteration step ``step(theta, psi, batch) -> AgentStepOut`` with
    the ADMM settings bound (rho, L, noise_std, ...: see ``admm_iteration``)."""
    def step(theta, psi, batch):
        return admm_iteration(spec, theta, psi, batch, **kwargs)
    return step
