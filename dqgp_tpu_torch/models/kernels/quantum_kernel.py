"""Quantum kernels: fidelity and projected, batched.

Port of ``dqgp_tpu/models/kernels/quantum_kernel.py``. Both kernels factor
through per-sample statevectors: the fidelity Gram is |Psi_A Psi_B^H|^2 and
the projected kernel is an outer kernel on single-qubit Pauli expectations.
Gradients are the reference's central difference with h = pi/8 over
parameters wrapped to the torus before evaluation
(agent_riemannian.py:38-41, 247-275).

Device policy, mirroring the JAX package's dispatch: projected features
with per-qubit Pauli measurements run the Pauli-feature kernel (K1), or the
fused-program Pauli-feature kernel (K3) where
``config.fusion_enabled(n, "features")`` (at >= 10 qubits by default);
fidelity states and full Pauli strings run the states kernel (K2), or the
fused-program states kernel (K4) where ``config.fusion_enabled(n, "states")``;
float64 angles run K1's and K2's float64 instantiations (the fused kernels
are float32 only, as in the JAX package). Full Pauli-string expectations are
plain torch on the states, as they are XLA in the JAX package. On the CPU
every wrapper runs its kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ... import config
from ...manifold import PERIOD
from ...ops.circuit import Circuit
from ...ops.cuda_circuit import (
    CircuitFunction,
    pauli_features_from_angles,
    pauli_features_from_angles_fused,
    states_from_angles,
    states_from_angles_fused,
)
from ...ops.statevector import angle_matrix, pauli_string_expectation
from ..circuits import build_circuit
from .outer import outer_gram

Measurement = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class QuantumKernelSpec:
    """Static (hashable) kernel description."""

    circuit: Circuit
    kernel_type: str = "fidelity"          # 'fidelity' | 'projected'
    measurement: Measurement = "XYZ"       # chars of single-qubit Paulis, or
                                           # a tuple of full Pauli strings
    outer_kernel: str = "gaussian"
    outer_kernel_params: Tuple[Tuple[str, float], ...] = ()
    regularization: Optional[str] = None   # 'thresholding' | 'tikhonov' | None

    def __post_init__(self):
        if self.kernel_type not in ("fidelity", "projected"):
            raise ValueError(
                f"Unknown kernel type: {self.kernel_type}. Supported: 'fidelity', 'projected'"
            )
        if isinstance(self.measurement, list):
            object.__setattr__(self, "measurement", tuple(self.measurement))
        # Only projected specs consult the measurement: a string (or tuple of
        # single chars) selects per-qubit blocks from 'XYZ'; a tuple of longer
        # strings lists full n-qubit Pauli strings over 'IXYZ'.
        if self.kernel_type != "projected":
            return
        m = self.measurement
        if isinstance(m, str):
            if not m or any(c not in "XYZ" for c in m.upper()):
                raise ValueError(
                    f"Bad measurement string {m!r}; use chars from 'XYZ'")
        else:
            if not m:
                raise ValueError("measurement tuple is empty")
            if all(len(p) == 1 for p in m):
                if any(p.upper() not in "XYZ" for p in m):
                    raise ValueError(
                        f"Bad per-qubit measurement {m!r}; single-char "
                        f"entries must come from 'XYZ'")
            else:
                n = self.circuit.num_qubits
                for p in m:
                    if len(p) != n or any(c not in "IXYZ" for c in p.upper()):
                        raise ValueError(
                            f"Bad Pauli string {p!r} in measurement {m!r}: "
                            f"full strings must be exactly num_qubits={n} "
                            f"chars from 'IXYZ' (single chars = per-qubit "
                            f"blocks, which cannot be mixed with full "
                            f"strings)")

    @property
    def num_parameters(self) -> int:
        return self.circuit.num_parameters

    @property
    def outer_params(self) -> Dict[str, float]:
        return dict(self.outer_kernel_params)


def _measurement_selector(spec: QuantumKernelSpec) -> Tuple[str, ...]:
    m = spec.measurement
    if isinstance(m, str):
        return tuple(m.upper())
    return tuple(p.upper() for p in m)


def _run(kernel, circuit: Circuit, angles: torch.Tensor, output: str) -> torch.Tensor:
    """``kernel(circuit, angles)``; where the angles need a gradient, through
    ``CircuitFunction``, whose backward is the hand-written adjoint kernel
    (its plain version on the CPU)."""
    if angles.requires_grad and torch.is_grad_enabled():
        return CircuitFunction.apply(angles, circuit, kernel, output)
    return kernel(circuit, angles)


def features_from_angles(spec: QuantumKernelSpec, angles: torch.Tensor) -> torch.Tensor:
    """Features from a precomputed (B, G) angle matrix.

    (B, 2^n) complex states for fidelity, (B, D) real for projected.
    Precision follows ``angles.dtype``: float64 angles run the complex128
    path. Mirrors ``dqgp_tpu/models/kernels/quantum_kernel.py``'s dispatch,
    with the hand-written kernels in place of the Pallas ones. Angles that
    need a gradient (the "autodiff" gradient) take the same kernels forward
    and the adjoint kernel ``circuit_vjp`` backward."""
    n = spec.circuit.num_qubits
    f64 = angles.dtype == torch.float64
    m = _measurement_selector(spec) if spec.kernel_type == "projected" else None

    if m is not None and all(len(s) == 1 for s in m):
        if not f64 and config.fusion_enabled(n, "features"):
            kernel = pauli_features_from_angles_fused
        else:
            kernel = pauli_features_from_angles
        full = _run(kernel, spec.circuit, angles, "features")
        blocks = {"X": full[:, :n], "Y": full[:, n:2 * n], "Z": full[:, 2 * n:]}
        return torch.cat([blocks[c] for c in m], dim=-1)

    # The fused kernel is float32-only, as in the JAX package, where float64
    # always takes the unfused engine.
    if not f64 and config.fusion_enabled(n, "states"):
        kernel = states_from_angles_fused
    else:
        kernel = states_from_angles
    states = _run(kernel, spec.circuit, angles, "states")
    if spec.kernel_type == "fidelity":
        return states
    cols = [pauli_string_expectation(states, p) for p in m]
    return torch.stack(cols, dim=-1).to(torch.float64 if f64 else torch.float32)


def kernel_features(spec: QuantumKernelSpec, X: torch.Tensor, theta: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Per-sample features of X (N, D) at parameters theta (P,)."""
    return features_from_angles(spec, angle_matrix(spec.circuit, X, theta, dtype))


def grams_at_rows(spec: QuantumKernelSpec, X: torch.Tensor,
                  thetas: torch.Tensor) -> torch.Tensor:
    """Symmetric float64 Grams (T, N, N) of X (N, D) at each of T parameter
    rows (T, P), through the complex128 pipeline: the T*N float64 angle rows
    go through ONE feature call (K1's or K2's float64 instantiation on the
    card), then the Grams are formed in float64. The driver's host condition
    numbers run on it (``dqgp_tpu/driver.py:248-268`` forms the same Grams
    one parameter row at a time under vmap)."""
    angles = angle_matrix(spec.circuit, X.to(torch.float64)[None], thetas, torch.float64)
    flat = features_from_angles(spec, angles.reshape(-1, angles.shape[-1]))
    return gram_from_features(spec, flat.reshape(*angles.shape[:-1], flat.shape[-1]))


def regularize_gram(K: torch.Tensor, method: Optional[str]) -> torch.Tensor:
    """Square-Gram regularization (squlearn semantics, main.py:2011-2013):
    thresholding clips the spectrum at 0, tikhonov shifts by the most
    negative eigenvalue if any."""
    if method is None:
        return K
    if method == "thresholding":
        w, v = torch.linalg.eigh(K)
        w = torch.clamp(w, min=0.0)
        return (v * w[..., None, :]) @ v.transpose(-1, -2)
    if method == "tikhonov":
        w = torch.linalg.eigvalsh(K)
        lam_min = torch.min(w)
        shift = torch.where(lam_min < 0.0, -lam_min, torch.zeros_like(lam_min))
        return K + shift * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    raise ValueError(f"Unknown regularization {method!r}")


def gram_from_features(spec: QuantumKernelSpec, FA: torch.Tensor,
                       FB: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram from precomputed features (leading batch dims allowed); FB=None
    is the symmetric Gram, which squlearn regularizes."""
    symmetric = FB is None
    FB = FA if FB is None else FB
    if spec.kernel_type == "fidelity":
        ar, ai = FA.real, FA.imag
        br, bi = FB.real, FB.imag
        re = ar @ br.transpose(-1, -2) + ai @ bi.transpose(-1, -2)
        im = ar @ bi.transpose(-1, -2) - ai @ br.transpose(-1, -2)
        K = re * re + im * im
    else:
        K = outer_gram(spec.outer_kernel, FA, FB, spec.outer_params)
    if symmetric:
        K = regularize_gram(K, spec.regularization)
    return K


def gram(spec: QuantumKernelSpec, XA: torch.Tensor, theta: torch.Tensor,
         XB: Optional[torch.Tensor] = None, dtype=torch.float32) -> torch.Tensor:
    """K(XA, XB; theta). XB=None computes the symmetric training Gram."""
    FA = kernel_features(spec, XA, theta, dtype)
    FB = None if XB is None else kernel_features(spec, XB, theta, dtype)
    return gram_from_features(spec, FA, FB)


def shift_parameter_batch(theta: torch.Tensor, h: float,
                          period: float = PERIOD) -> torch.Tensor:
    """(2P+1, P): [theta; theta + h e_p ...; theta - h e_p ...], each row
    wrapped to [0, period) in theta's dtype (the reference's worker wraps
    before evaluating, agent_riemannian.py:38-41)."""
    P = theta.shape[-1]
    eye = torch.eye(P, dtype=theta.dtype, device=theta.device)
    stacked = torch.cat([theta[None, :], theta[None, :] + h * eye,
                         theta[None, :] - h * eye], dim=0)
    return torch.remainder(stacked, period)


def gram_and_shift_grads(spec: QuantumKernelSpec, X: torch.Tensor,
                         theta: torch.Tensor, h: float = float(np.pi / 8),
                         period: float = PERIOD,
                         dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, dK/dtheta) with the reference's central difference.

    X is (..., N, D): leading dims (agents) share theta. All 2P+1 shifted
    parameter vectors of every leading index go through ONE feature call.
    Returns K (..., N, N) and dK (..., P, N, N), in the features' dtype."""
    thetas = shift_parameter_batch(theta, h, period)                 # (S, P)
    A = angle_matrix(spec.circuit, X[..., None, :, :], thetas, dtype)  # (..., S, N, G)
    lead = A.shape[:-2]
    flat = features_from_angles(spec, A.reshape(-1, A.shape[-1]))
    feats = flat.reshape(*lead, X.shape[-2], flat.shape[-1])
    grams = gram_from_features(spec, feats)                           # (..., S, N, N)
    P = theta.shape[-1]
    K = grams[..., 0, :, :]
    dK = (grams[..., 1:1 + P, :, :] - grams[..., 1 + P:, :, :]) / (2.0 * h)
    return K, dK


class QuantumKernel:
    """API-parity facade over the functional kernel ops (the squlearn
    surface the reference touches: main.py:198-205, 245, 1413-1430)."""

    def __init__(self, spec: QuantumKernelSpec, device, dtype: str = "auto"):
        """``dtype="auto"`` is float64 on every device: the JAX facade's
        reference-grade default wherever complex128 is native (CPU and GPU,
        ``dqgp_tpu/config.py::resolve_gram_dtype``)."""
        self.spec = spec
        self.device = torch.device(device)
        if dtype == "auto":
            dtype = "float64"
        self.dtype = {"float32": torch.float32, "float64": torch.float64}[dtype]
        self._parameters: Optional[torch.Tensor] = None

    @property
    def num_parameters(self) -> int:
        return self.spec.num_parameters

    @property
    def encoding_circuit(self) -> Circuit:
        return self.spec.circuit

    def assign_parameters(self, params) -> None:
        self._parameters = torch.as_tensor(params, dtype=self.dtype,
                                           device=self.device)

    def _x(self, X) -> torch.Tensor:
        return torch.as_tensor(X, device=self._parameters.device)

    def evaluate(self, XA, XB=None) -> np.ndarray:
        if self._parameters is None:
            raise ValueError("parameters not assigned")
        symmetric = XB is None or XB is XA
        if (not symmetric and self.spec.regularization is not None
                and np.shape(XB) == np.shape(XA)):
            # squlearn regularizes square Grams only: a value-equal XB still
            # takes the symmetric path
            symmetric = np.array_equal(np.asarray(XB), np.asarray(XA))
        XB_t = None if symmetric else self._x(XB)
        K = gram(self.spec, self._x(XA), self._parameters, XB_t, dtype=self.dtype)
        return K.detach().cpu().numpy().astype(np.float64)

    def evaluate_derivatives(self, XA, XB=None, values=("K", "dKdp"),
                             h=float(np.pi / 8)):
        if self._parameters is None:
            raise ValueError("parameters not assigned")
        if XB is not None and XB is not XA and not (
                np.shape(XB) == np.shape(XA)
                and np.array_equal(np.asarray(XB), np.asarray(XA))):
            raise NotImplementedError(
                "evaluate_derivatives supports only the symmetric case "
                "(XB is None or XB == XA)")
        K, dK = gram_and_shift_grads(self.spec, self._x(XA), self._parameters,
                                     h, dtype=self.dtype)
        out = {}
        if "K" in values:
            out["K"] = K.detach().cpu().numpy().astype(np.float64)
        if "dKdp" in values:
            out["dKdp"] = dK.detach().cpu().numpy().astype(np.float64)
        return out


def create_quantum_kernel(
    num_qubits: int,
    num_features: int = 1,
    num_layers: int = 2,
    use_parameter_shift: bool = True,
    encoding_type: str = "yz_cx",
    kernel_type: str = "fidelity",
    measurement: Measurement = "XYZ",
    outer_kernel: str = "gaussian",
    outer_kernel_params: Optional[Dict[str, float]] = None,
    regularization: Optional[str] = None,
    apply_outer_params: bool = False,
    dtype: str = "auto",
    *,
    device,
) -> QuantumKernel:
    """Flag-compatible twin of the reference's factory (main.py:43-145).

    ``use_parameter_shift`` is accepted and ignored; ``apply_outer_params``
    False reproduces the reference quirk that CLI outer-kernel parameters
    never reach the kernel (main.py:127-133)."""
    del use_parameter_shift
    circuit = build_circuit(encoding_type, num_qubits, num_features, num_layers)
    params = tuple(sorted((outer_kernel_params or {}).items())) if apply_outer_params else ()
    spec = QuantumKernelSpec(
        circuit=circuit,
        kernel_type=kernel_type,
        measurement=measurement,
        outer_kernel=outer_kernel,
        outer_kernel_params=params,
        regularization=regularization,
    )
    return QuantumKernel(spec, device, dtype=dtype)
