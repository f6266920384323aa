"""Carry circuits, kernel specs and ADMM state across from the JAX package.

The JAX package's ``Circuit``, ``Gate`` and ``QuantumKernelSpec`` are frozen
dataclasses of plain Python fields, so they are read duck-typed here without
importing jax. Checkpoints need no conversion: the port's
``driver.load_checkpoint`` reads the npz layout the JAX package's
``save_checkpoint`` writes, so ``train(resume_from=...)`` resumes a JAX run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.kernels.quantum_kernel import QuantumKernelSpec
from .ops.circuit import Circuit, Gate

_GATE_FIELDS = tuple(f.name for f in dataclasses.fields(Gate))


def circuit_from_fields(num_qubits: int, num_features: int, num_parameters: int,
                        gates, name: str = "circuit",
                        requires_clipping: bool = False) -> Circuit:
    """A port ``Circuit`` from plain fields; ``gates`` holds objects with
    ``Gate``'s attributes (or mappings of them)."""
    def field(g, k):
        return g[k] if isinstance(g, dict) else getattr(g, k)

    port_gates = tuple(Gate(**{k: field(g, k) for k in _GATE_FIELDS}) for g in gates)
    return Circuit(num_qubits, num_features, num_parameters, port_gates,
                   name=name, requires_clipping=requires_clipping)


def circuit_from_jax(c) -> Circuit:
    """The port's twin of a JAX-package ``Circuit`` (read duck-typed)."""
    return circuit_from_fields(c.num_qubits, c.num_features, c.num_parameters,
                               c.gates, c.name, c.requires_clipping)


def spec_from_jax(spec) -> QuantumKernelSpec:
    """The port's twin of a JAX-package ``QuantumKernelSpec``."""
    return QuantumKernelSpec(
        circuit=circuit_from_jax(spec.circuit),
        kernel_type=spec.kernel_type,
        measurement=spec.measurement,
        outer_kernel=spec.outer_kernel,
        outer_kernel_params=tuple(spec.outer_kernel_params),
        regularization=spec.regularization,
    )


def state_from_numpy(theta, psi, z, device):
    """ADMM state (theta (A, P), psi (A, P), z (P,)) as float64 tensors."""
    return tuple(torch.as_tensor(np.asarray(a, np.float64), device=device)
                 for a in (theta, psi, z))
