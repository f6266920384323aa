"""Torus manifold, Riemannian optimizers and the Riemannian ADMM algebra,
on tensors.

Port of ``dqgp_tpu/manifold.py`` (reference: riemannian_optimizer.py:26-428):
plain functions on tensors, and thin classes with the reference's public
surface (``TorusManifold``, ``RiemannianOptimizer``, ``RiemannianADMM``,
``create_riemannian_framework``). The reference's quirks stay: ``log_map``
is the unsigned ``wrap(y - x)`` in [0, period) unless ``signed=True``, and
the agent update is the closed-form proximal step (the training loop never
calls the optimizer). The ``np_*`` twins are host-side numpy for the
driver's bookkeeping.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

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


def distance(x: torch.Tensor, y: torch.Tensor, period: float = PERIOD) -> torch.Tensor:
    """Riemannian distance on the torus: the l2 norm of the per-component
    shortest arcs (riemannian_optimizer.py:89-105)."""
    return torch.linalg.norm(signed_arc(y, x, period))


def signed_arc(x: torch.Tensor, y: torch.Tensor, period: float = PERIOD) -> torch.Tensor:
    """Per-component signed shortest arc from x to y, in [-period/2, period/2)."""
    return torch.remainder(y - x + period / 2.0, period) - period / 2.0


def exp_map(x: torch.Tensor, v: torch.Tensor, period: float = PERIOD) -> torch.Tensor:
    """Exponential map = addition + wrap."""
    return wrap(x + v, period)


def log_map(x: torch.Tensor, y: torch.Tensor, period: float = PERIOD,
            signed: bool = False) -> torch.Tensor:
    """The reference's unsigned log map ``wrap(y - x)`` in [0, period), or
    with ``signed=True`` the signed shortest arc."""
    if signed:
        return signed_arc(x, y, period)
    return wrap(y - x, period)


retraction = exp_map  # riemannian_optimizer.py:123-129


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
                    rho: float, period: float = PERIOD,
                    signed_log: bool = False) -> torch.Tensor:
    """Dual update ``psi + rho * log_map(z, theta)`` (the unsigned log map
    unless ``signed_log``)."""
    return psi + rho * log_map(z, theta, period, signed=signed_log)


def admm_primal_residual(theta: torch.Tensor, z: torch.Tensor,
                         period: float = PERIOD) -> torch.Tensor:
    """Norm of the agents' distances to z (riemannian_optimizer.py:370-386)."""
    return torch.linalg.norm(torch.linalg.norm(signed_arc(z, theta, period), dim=-1))


def admm_dual_residual(z_new: torch.Tensor, z_old: torch.Tensor,
                       period: float = PERIOD) -> torch.Tensor:
    """Distance between consecutive z (riemannian_optimizer.py:388-399)."""
    return distance(z_new, z_old, period)


# ---------------------------------------------------------------------------
# Riemannian optimizers as (state, grad) -> (state, x) transforms
# (riemannian_optimizer.py:149-282)
# ---------------------------------------------------------------------------


class OptState(NamedTuple):
    velocity: torch.Tensor
    prev_grad: torch.Tensor
    iteration: torch.Tensor  # int32 scalar


def opt_init(num_parameters: int, dtype=torch.float64, device=None) -> OptState:
    zeros = torch.zeros((num_parameters,), dtype=dtype, device=device)
    return OptState(velocity=zeros, prev_grad=zeros,
                    iteration=torch.zeros((), dtype=torch.int32, device=device))


def _clip_by_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    norm = torch.linalg.norm(g)
    return g * torch.where(norm > max_norm, max_norm / torch.clamp(norm, min=1e-30),
                           torch.ones_like(norm))


def _cap_step(direction: torch.Tensor, max_step: float) -> torch.Tensor:
    norm = torch.linalg.norm(direction)
    return direction * torch.where(norm > max_step, max_step / torch.clamp(norm, min=1e-30),
                                   torch.ones_like(norm))


def opt_step(state: OptState, x: torch.Tensor, grad: torch.Tensor, *, method: str,
             lr: float = 0.015, beta: float = 0.9, gradient_clip_norm: float = 1.0,
             max_step_size: float = 0.08,
             period: float = PERIOD) -> Tuple[OptState, torch.Tensor]:
    """One Riemannian optimizer step (riemannian_optimizer.py:180-282):
    "gradient_descent", "momentum" or "conjugate_gradient" (Polak-Ribière,
    a plain gradient step first; vector transport is the identity)."""
    g = _clip_by_norm(grad, gradient_clip_norm)
    if method == "gradient_descent":
        direction = _cap_step(-lr * g, max_step_size)
        return state._replace(iteration=state.iteration + 1), exp_map(x, direction, period)
    if method == "momentum":
        velocity = _cap_step(beta * state.velocity - lr * g, max_step_size)
        return (OptState(velocity, state.prev_grad, state.iteration + 1),
                exp_map(x, velocity, period))
    if method == "conjugate_gradient":
        is_first = state.iteration == 0
        beta_pr = torch.dot(g, g - state.prev_grad) / (
            torch.dot(state.prev_grad, state.prev_grad) + 1e-10)
        velocity = -g + torch.clamp(beta_pr, min=0.0) * state.velocity
        direction = torch.where(is_first, _cap_step(-lr * g, max_step_size),
                                _cap_step(lr * velocity, max_step_size))
        velocity = torch.where(is_first, state.velocity, velocity)
        return OptState(velocity, g, state.iteration + 1), exp_map(x, direction, period)
    raise ValueError(f"Unknown method: {method}")


# ---------------------------------------------------------------------------
# Classes with the reference's public surface
# ---------------------------------------------------------------------------


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


class TorusManifold:
    """Torus (S^1)^P with period pi (riemannian_optimizer.py:53-146)."""

    def __init__(self, dimension: int, period: float = PERIOD):
        self.dim = dimension
        self.period = period
        self.name = f"Torus S^1 x ... x S^1 ({dimension}D, period={period:.3f})"

    def wrap_to_manifold(self, x):
        return wrap(_f64(x), self.period)

    def random_point(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A uniform point of [0, period)^dim from ``generator`` (the JAX
        package draws from a PRNG key; the two give different numbers)."""
        return torch.rand((self.dim,), generator=generator, dtype=torch.float64) * self.period

    def distance(self, x, y):
        return distance(_f64(x), _f64(y), self.period)

    def exp_map(self, x, v):
        return exp_map(_f64(x), _f64(v), self.period)

    def log_map(self, x, y, signed: bool = False):
        return log_map(_f64(x), _f64(y), self.period, signed=signed)

    def retraction(self, x, v):
        return self.exp_map(x, v)

    def vector_transport(self, x, v, d):
        return v  # identity on the torus (riemannian_optimizer.py:131-137)

    def riemannian_gradient(self, x, euclidean_grad):
        return euclidean_grad  # induced metric (riemannian_optimizer.py:139-146)


class RiemannianOptimizer:
    """Stateful wrapper over ``opt_step`` (riemannian_optimizer.py:149-282)."""

    def __init__(self, manifold: TorusManifold, learning_rate: float = 0.015,
                 method: str = "gradient_descent", beta: float = 0.9,
                 gradient_clip_norm: float = 1.0, max_step_size: float = 0.08):
        self.manifold = manifold
        self.lr = learning_rate
        self.method = method
        self.beta = beta
        self.gradient_clip_norm = gradient_clip_norm
        self.max_step_size = max_step_size
        self.state = opt_init(manifold.dim)

    def step(self, x, grad):
        x = _f64(x)
        if self.state.velocity.device != x.device:
            # the state lives where the points do, as the JAX package's
            # arrays live on its default device
            self.state = OptState(*(t.to(x.device) for t in self.state))
        self.state, x_new = opt_step(
            self.state, x, _f64(grad), method=self.method, lr=self.lr,
            beta=self.beta, gradient_clip_norm=self.gradient_clip_norm,
            max_step_size=self.max_step_size, period=self.manifold.period)
        return x_new


class RiemannianADMM:
    """Stateless ADMM update rules (riemannian_optimizer.py:285-399)."""

    def __init__(self, manifold: TorusManifold, rho: float = 1.0, signed_log: bool = False):
        self.manifold = manifold
        self.rho = rho
        self.signed_log = signed_log
        self.iteration = 0

    def update_z(self, theta, psi):
        return admm_update_z(_f64(theta), _f64(psi), self.rho, self.manifold.period)

    def update_theta(self, z, grad, psi, L, optimizer=None):
        # ``optimizer`` is accepted and ignored, as riemannian_optimizer.py:324-348 does
        return admm_update_theta(_f64(z), _f64(grad), _f64(psi), self.rho, L,
                                 self.manifold.period)

    def update_psi(self, psi, theta, z):
        return admm_update_psi(_f64(psi), _f64(theta), _f64(z), self.rho,
                               self.manifold.period, signed_log=self.signed_log)

    def compute_primal_residual(self, theta, z):
        return admm_primal_residual(_f64(theta), _f64(z), self.manifold.period)

    def compute_dual_residual(self, z_new, z_old):
        return admm_dual_residual(_f64(z_new), _f64(z_old), self.manifold.period)


def create_riemannian_framework(num_parameters: int, learning_rate: float = 0.01,
                                rho: float = 1.0, method: str = "gradient_descent",
                                gradient_clip_norm: float = 1.0, max_step_size: float = 0.1
                                ) -> Tuple[TorusManifold, RiemannianOptimizer, RiemannianADMM]:
    """The reference's factory (riemannian_optimizer.py:402-428)."""
    manifold = TorusManifold(num_parameters)
    optimizer = RiemannianOptimizer(manifold, learning_rate, method,
                                    gradient_clip_norm=gradient_clip_norm,
                                    max_step_size=max_step_size)
    return manifold, optimizer, RiemannianADMM(manifold, rho)
