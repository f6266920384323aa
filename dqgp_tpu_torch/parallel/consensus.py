"""Multi-agent ADMM consensus step on one device.

Port of the single-device path of ``dqgp_tpu/parallel/consensus.py``. The
agents are a written-out batch dimension: their padded, masked shards live on
the device as (A, Nmax, ...) tensors, and one step runs

1. z = round4(circular_mean(theta + psi/rho))   [consensus, from OLD state]
2. for every agent at once: the 2P+1 shifted Grams at wrap(z) — all agents'
   shifted angle rows go through ONE Pauli-feature kernel launch — the
   masked float64 NLL and its gradient by the reference's h=pi/8 central
   difference (the JAX package's "streamed" and "autodiff" gradients are
   not ported), the proximal theta update and the dual psi update, with the
   reference's 4-decimal rounding (main.py:2507-2555;
   agent_riemannian.py:438, 485-486).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from .. import manifold as M
from ..models.gp.posterior import masked_nll_and_grad
from ..models.kernels.quantum_kernel import QuantumKernelSpec, gram_and_shift_grads


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


def admm_iteration(
    spec: QuantumKernelSpec,
    theta: torch.Tensor,
    psi: torch.Tensor,
    batch: AgentBatch,
    *,
    rho: float,
    L: float,
    noise_std: float,
    shift_value: float = float(np.pi / 8),
    parity_round: bool = True,
    compute_cond: bool = True,
    psd_fallback: bool = True,
) -> AgentStepOut:
    """One bulk-synchronous ADMM round over all agents (theta, psi: (A, P))."""
    dtype = config.GP_DTYPE

    xi = theta + psi / rho
    phase = 2.0 * math.pi * xi / M.PERIOD
    z = M.circular_mean_from_sums(torch.sum(torch.cos(phase), dim=0),
                                  torch.sum(torch.sin(phase), dim=0))
    if parity_round:
        z = M.round4(z)

    # The shift batch is built and wrapped in float32, as the reference's
    # kernel path sees it; the f32 Grams are upcast only afterwards.
    z_manifold = M.wrap(z)
    K, dK = gram_and_shift_grads(spec, batch.X, z_manifold.to(torch.float32),
                                 shift_value)
    res = masked_nll_and_grad(K.to(dtype), dK, batch.Y.to(dtype),
                              batch.mask.to(dtype), noise_std,
                              compute_cond=compute_cond, fallback=psd_fallback)
    grad = M.round4(res.grad) if parity_round else res.grad
    theta_new = M.admm_update_theta(z_manifold, grad, psi, rho, L)
    psi_new = M.admm_update_psi(psi, theta_new, z_manifold, rho)
    if parity_round:
        theta_new = M.round4(theta_new)
        psi_new = M.round4(psi_new)
    return AgentStepOut(theta_new, psi_new, z, res.nll, res.log_det_term,
                        res.quadratic_term, res.constant_term,
                        res.condition_number)


def make_admm_step(spec: QuantumKernelSpec, **kwargs):
    """The per-iteration step ``step(theta, psi, batch) -> AgentStepOut`` with
    the ADMM settings bound (rho, L, noise_std, ...: see ``admm_iteration``)."""
    def step(theta, psi, batch):
        return admm_iteration(spec, theta, psi, batch, **kwargs)
    return step
