"""Torus manifold ops and the Riemannian ADMM algebra, on tensors.

Port of the functional part of ``dqgp_tpu/manifold.py`` that the training
loop runs (reference: riemannian_optimizer.py:26-399). The reference's
quirks stay: ``log_map`` is the unsigned ``wrap(y - x)`` in [0, period), and
the agent update is the closed-form proximal step. The ``np_*`` twins are
host-side numpy for the driver's bookkeeping.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PERIOD = float(np.pi)


def wrap(x: torch.Tensor, period: float = PERIOD) -> torch.Tensor:
    """Wrap angles to [0, period]; subnormal inputs and results become 0.

    The JAX package's ``jnp.mod`` runs with denormals flushed: a subnormal
    negative x reads as zero, comes back unchanged and is then flushed to 0.
    ``torch.remainder`` does not flush denormals, and would return ``period``
    there, so subnormal inputs are flushed first. For every normal input both
    flushes are no-ops."""
    tiny = torch.finfo(x.dtype).tiny
    x = torch.where(torch.abs(x) < tiny, torch.zeros_like(x), x)
    m = torch.remainder(x, period)
    return torch.where(torch.abs(m) < tiny, torch.zeros_like(m), m)


def exp_map(x: torch.Tensor, v: torch.Tensor, period: float = PERIOD) -> torch.Tensor:
    """Exponential map = addition + wrap."""
    return wrap(x + v, period)


def log_map(x: torch.Tensor, y: torch.Tensor, period: float = PERIOD) -> torch.Tensor:
    """The reference's unsigned log map ``wrap(y - x)`` in [0, period)."""
    return wrap(y - x, period)


def circular_mean(angles: torch.Tensor, period: float = PERIOD) -> torch.Tensor:
    """Circular mean per dimension over axis 0."""
    phase = 2.0 * math.pi * angles / period
    return circular_mean_from_sums(torch.sum(torch.cos(phase), dim=0),
                                   torch.sum(torch.sin(phase), dim=0), period)


def circular_mean_from_sums(cos_sum: torch.Tensor, sin_sum: torch.Tensor,
                            period: float = PERIOD) -> torch.Tensor:
    """Finish a circular mean from pre-reduced (cos, sin) sums."""
    mean_angle = torch.atan2(sin_sum, cos_sum) * period / (2.0 * math.pi)
    return torch.remainder(mean_angle, period)


def round4(x: torch.Tensor) -> torch.Tensor:
    """4-decimal quantization of the reference's ADMM loop: x * 1e4 rounded
    half to even, then scaled back by 1e-4.

    ``jnp.round(x, 4)`` divides by 1e4, but XLA compiles that division by a
    constant into a multiply by its reciprocal, so the JAX package's values
    are ``rint(x * 1e4) * 1e-4``; ``torch.round(x, decimals=4)`` divides and
    differs from them in the last ulp for about a third of inputs."""
    return torch.round(x * 1e4) * 1e-4


def np_circular_mean(angles: np.ndarray, period: float = PERIOD) -> np.ndarray:
    phase = 2.0 * np.pi * np.asarray(angles) / period
    return np.mod(
        np.arctan2(np.sum(np.sin(phase), axis=0), np.sum(np.cos(phase), axis=0))
        * period / (2.0 * np.pi),
        period,
    )


def np_distance(x: np.ndarray, y: np.ndarray, period: float = PERIOD) -> float:
    diff = np.asarray(x) - np.asarray(y)
    wrapped = np.mod(diff + period / 2.0, period) - period / 2.0
    return float(np.linalg.norm(wrapped))


def admm_update_z(theta: torch.Tensor, psi: torch.Tensor, rho: float,
                  period: float = PERIOD) -> torch.Tensor:
    """Consensus update: circular mean of ``theta + psi/rho`` over agents."""
    return circular_mean(theta + psi / rho, period)


def admm_update_theta(z: torch.Tensor, grad: torch.Tensor, psi: torch.Tensor,
                      rho: float, L: float, period: float = PERIOD) -> torch.Tensor:
    """Proximal-linearized agent update ``wrap(z - (grad + psi)/(rho + L))``."""
    return exp_map(z, -(grad + psi) / (rho + L), period)


def admm_update_psi(psi: torch.Tensor, theta: torch.Tensor, z: torch.Tensor,
                    rho: float, period: float = PERIOD) -> torch.Tensor:
    """Dual update ``psi + rho * log_map(z, theta)`` (unsigned log map)."""
    return psi + rho * log_map(z, theta, period)
