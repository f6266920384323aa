"""RiemannianAgent — the reference's single-agent surface over the port's
agent step.

Port of ``dqgp_tpu/agent.py`` (reference: agent_riemannian.py:126-491):
``RiemannianAgent(agent_id, X_sub, Y_sub, ..., device=...).train_and_update(z,
psi_i)`` returns ``(theta_i, psi_i, nll_loss, condition_number,
nll_components)``. The distributed path (``driver.train``) runs the same
``parallel.consensus.agent_updates`` over all agents at once.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .manifold import TorusManifold, create_riemannian_framework
from .models.kernels.quantum_kernel import QuantumKernel, create_quantum_kernel
from .parallel.consensus import AgentBatch, agent_updates

# One step per (spec, hyperparameters), shared by agents built alike, as the
# JAX package shares one compiled program (agent.py:25-52); FIFO-bounded so
# that a hyperparameter sweep does not keep one entry per grid point.
_step_cache: Dict[tuple, object] = {}
_STEP_CACHE_SIZE = 32


def _get_agent_step(spec, rho, L, noise_std, shift_value, parity_round, grad_method):
    key = (spec, float(rho), float(L), float(noise_std), float(shift_value),
           bool(parity_round), grad_method)
    if key not in _step_cache:
        if len(_step_cache) >= _STEP_CACHE_SIZE:
            _step_cache.pop(next(iter(_step_cache)))
        _step_cache[key] = functools.partial(
            agent_updates, spec, rho=float(rho), L=float(L), noise_std=float(noise_std),
            shift_value=float(shift_value), parity_round=bool(parity_round),
            compute_cond=True, grad_method=grad_method)
    return _step_cache[key]


class RiemannianAgent:
    def __init__(
        self,
        agent_id,
        X_sub,
        Y_sub,
        num_qubits: int,
        noise_std: float,
        rho: float,
        L: float,
        q_kernel: Optional[QuantumKernel] = None,
        use_parameter_shift: bool = True,
        num_workers=None,                      # accepted for parity; on-device
        shift_value: float = float(np.pi / 8),
        num_layers: int = 2,
        combined_computation: bool = True,     # parity; always combined here
        encoding_type: str = "yz_cx",
        kernel_type: str = "fidelity",
        measurement: str = "XYZ",
        outer_kernel: str = "gaussian",
        outer_kernel_params: Optional[Dict] = None,
        regularization: Optional[str] = None,
        riemannian_lr: float = 0.01,
        riemannian_method: str = "gradient_descent",
        riemannian_beta: float = 0.9,
        grad_method: Optional[str] = None,
        parity_round: bool = True,
        *,
        device,
    ):
        self.agent_id = agent_id
        self.device = torch.device(device)
        self.X_sub = np.asarray(X_sub)
        if self.X_sub.ndim == 1:
            self.X_sub = self.X_sub.reshape(-1, 1)
        self.Y_sub = np.asarray(Y_sub)
        self.noise_std = noise_std
        self.rho = rho
        self.L = L
        self.shift_value = shift_value
        # An explicit grad_method wins; otherwise the reference's executor
        # choice: parameter shift -> central difference, PennyLane -> autodiff
        # (main.py:109-114).
        if grad_method is None:
            grad_method = "central" if use_parameter_shift else "autodiff"
        self.grad_method = grad_method
        self.parity_round = parity_round

        if q_kernel is not None:
            self.spec = q_kernel.spec
        else:
            self.spec = create_quantum_kernel(
                num_qubits, self.X_sub.shape[1], num_layers, use_parameter_shift,
                encoding_type, kernel_type, measurement, outer_kernel,
                outer_kernel_params, regularization, device=self.device,
            ).spec

        # the Riemannian framework, exposed like the reference's
        # _setup_riemannian_framework (agent_riemannian.py:198-207)
        self.manifold: Optional[TorusManifold] = None
        self.riemannian_optimizer = None
        self.riemannian_admm = None
        self._riemannian_lr = riemannian_lr
        self._riemannian_method = riemannian_method

        n = self.X_sub.shape[0]
        self._batch = AgentBatch(
            torch.as_tensor(self.X_sub[None], dtype=torch.float32, device=self.device),
            torch.as_tensor(self.Y_sub[None], dtype=torch.float64, device=self.device),
            torch.ones((1, n), dtype=torch.float64, device=self.device))
        self._step = _get_agent_step(self.spec, rho, L, noise_std, shift_value,
                                     parity_round, self.grad_method)

    def _setup_riemannian_framework(self, num_parameters: int):
        if self.manifold is None:
            self.manifold, self.riemannian_optimizer, self.riemannian_admm = (
                create_riemannian_framework(num_parameters=num_parameters,
                                            learning_rate=self._riemannian_lr,
                                            rho=self.rho, method=self._riemannian_method))

    def train_and_update(self, z, psi_i) -> Tuple[np.ndarray, np.ndarray, float, float, Dict]:
        """One local ADMM round (agent_riemannian.py:314-491)."""
        z = torch.as_tensor(np.asarray(z, np.float64), device=self.device)
        self._setup_riemannian_framework(z.shape[0])
        psi = torch.as_tensor(np.asarray(psi_i, np.float64), device=self.device)[None]
        theta_i, psi_new, res = self._step(z, psi, self._batch)
        nll, ld, quad, const, cond = (float(v[0]) for v in (
            res.nll, res.log_det_term, res.quadratic_term, res.constant_term,
            res.condition_number))
        components = {"log_det_term": ld, "quadratic_term": quad,
                      "constant_term": const, "total": nll}
        return (theta_i[0].cpu().numpy(), psi_new[0].cpu().numpy(), nll, cond, components)
