"""Batched statevector engine in plain PyTorch.

Port of ``dqgp_tpu/ops/statevector.py``. It prepares all sample states in one
batched pass over a (B, 2^n) complex tensor, one tensor op (or a few) per
gate. This is the plain twin of the hand-written Pauli-feature and states
kernels (``ops/cuda_circuit.py``): the wrappers run it for CPU tensors, and
the card checks hold the kernels to it. It runs in complex64 or complex128; the trig
precision tracks the state's precision.

Qubit 0 is the least-significant bit of the state index.
"""

from __future__ import annotations

import functools

import torch

from .circuit import (
    CRX, CRY, CRZ, CX, CZ, ENC_ARCCOS, H, RX, RY, RZ, RZZ,
    Circuit, Gate,
)

_SQRT1_2 = 0.7071067811865476


@functools.lru_cache(maxsize=64)
def _static_tensors(circuit: Circuit, device: torch.device) -> dict:
    """The circuit's coefficient arrays on ``device``, uploaded once: a CUDA
    graph cannot capture the upload, and a replayed step must not repeat it."""
    arr = {k: torch.as_tensor(v, device=device)
           for k, v in circuit.static_arrays().items()}
    arr["pidx"], arr["fidx"] = arr["pidx"].long(), arr["fidx"].long()
    return arr


def angle_matrix(circuit: Circuit, X: torch.Tensor, theta: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Rotation-angle matrix for every sample and gate.

    angle[..., n, g] = const_g + pc_g * theta[..., pidx_g]
                       + (fc_g + pf_g * theta[..., pidx_g]) * enc_g(X[..., n, fidx_g])

    X is (..., N, D) and theta (..., P); their leading dimensions broadcast,
    so one call builds the angles of every agent and every shifted parameter
    vector. The coefficient arrays are float32 (``Circuit.static_arrays``);
    with ``dtype=float64`` they promote exactly as in the JAX package.
    """
    arr = _static_tensors(circuit, X.device)
    Xf = X.to(dtype)
    th = theta.to(dtype)
    # Pad so parameter-free circuits (and pidx=-1 gates clamped to 0) index safely.
    th_pad = torch.cat([th, th.new_zeros(th.shape[:-1] + (1,))], dim=-1)
    th_g = (th_pad[..., arr["pidx"]] * arr["has_p"])[..., None, :]   # (..., 1, G)
    xg = Xf[..., arr["fidx"]]                                          # (..., N, G)
    encoded = torch.where(
        arr["enc"] == ENC_ARCCOS,
        torch.arccos(torch.clamp(xg, -1.0, 1.0)),
        xg,
    ) * arr["has_f"]
    return (arr["const"] + arr["pc"] * th_g
            + (arr["fc"] + arr["pf"] * th_g) * encoded)


def _real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def _split(state: torch.Tensor, q: int, n: int):
    """(B, 2^n) -> s0, s1 of shape (B, 2^(n-1-q), 2^q): qubit q isolated."""
    s = state.reshape(state.shape[0], 1 << (n - 1 - q), 2, 1 << q)
    return s[:, :, 0, :], s[:, :, 1, :]


def _merge(n0: torch.Tensor, n1: torch.Tensor, n: int) -> torch.Tensor:
    return torch.stack([n0, n1], dim=2).reshape(n0.shape[0], 1 << n)


def _bits(n: int, q: int, device) -> torch.Tensor:
    return (torch.arange(1 << n, device=device) >> q) & 1


def apply_gate(state: torch.Tensor, gate: Gate, angle: torch.Tensor,
               n: int) -> torch.Tensor:
    """Apply one gate to a batch of states. ``angle`` has shape (B,)."""
    q, kind = gate.qubit, gate.kind
    dev = state.device
    rdt = _real_dtype(state.dtype)

    if kind == CX:
        idx = torch.arange(1 << n, device=dev)
        perm = torch.where(_bits(n, gate.control, dev) == 1, idx ^ (1 << q), idx)
        return state[:, perm]

    if kind == CZ:
        both = _bits(n, gate.control, dev) & _bits(n, q, dev)
        return state * (1.0 - 2.0 * both).to(state.dtype)

    if kind == RZZ:
        # exp(-i a/2 Z_c Z_t): e^{-ia/2} where the bits agree, e^{+ia/2} otherwise.
        agree = _bits(n, gate.control, dev) == _bits(n, q, dev)
        sgn = torch.where(agree, 1.0, -1.0).to(rdt)
        half = (0.5 * angle).to(rdt)[:, None]
        phase = torch.complex(torch.cos(half).expand(-1, 1 << n),
                              -sgn * torch.sin(half))
        return state * phase.to(state.dtype)

    if kind == H:
        s0, s1 = _split(state, q, n)
        return _merge((s0 + s1) * _SQRT1_2, (s0 - s1) * _SQRT1_2, n)

    half = (0.5 * angle).to(rdt)[:, None, None]
    c = torch.cos(half)
    s = torch.sin(half)
    s0, s1 = _split(state, q, n)
    if kind in (RX, CRX):
        # [[c, -is], [-is, c]]
        isn = torch.complex(torch.zeros_like(s), s)
        new = _merge(c * s0 - isn * s1, -isn * s0 + c * s1, n)
    elif kind in (RY, CRY):
        new = _merge(c * s0 - s * s1, s * s0 + c * s1, n)
    elif kind in (RZ, CRZ):
        new = _merge(torch.complex(c, -s) * s0, torch.complex(c, s) * s1, n)
    else:
        raise ValueError(f"unsupported gate kind {kind}")
    if kind in (CRX, CRY, CRZ):
        return torch.where(_bits(n, gate.control, dev) == 1, new, state)
    return new


def state_from_angles(circuit: Circuit, angles: torch.Tensor,
                      dtype=torch.complex64) -> torch.Tensor:
    """Run the gate sequence on |0...0> for (B, G) per-sample angles.

    Returns (B, 2^n) complex states."""
    b = angles.shape[0]
    state = torch.zeros((b, circuit.dim), dtype=dtype, device=angles.device)
    state[:, 0] = 1.0
    for gi, gate in enumerate(circuit.gates):
        state = apply_gate(state, gate, angles[:, gi], circuit.num_qubits)
    return state


def batched_states(circuit: Circuit, X: torch.Tensor, theta: torch.Tensor,
                   dtype=torch.complex64) -> torch.Tensor:
    """States Psi(x_i; theta) for a whole batch: (N, 2^n)."""
    return state_from_angles(
        circuit, angle_matrix(circuit, X, theta, _real_dtype(dtype)), dtype)


def pauli_features(state: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """Single-qubit Pauli expectations: (B, 3n) ordered [X_0..X_{n-1}, Y.., Z..]."""
    xs, ys, zs = [], [], []
    for q in range(num_qubits):
        s0, s1 = _split(state, q, num_qubits)
        cross = torch.sum(torch.conj(s0) * s1, dim=(1, 2))
        xs.append(2.0 * cross.real)
        ys.append(2.0 * cross.imag)
        zs.append(torch.sum(torch.abs(s0) ** 2 - torch.abs(s1) ** 2, dim=(1, 2)))
    return torch.stack(xs + ys + zs, dim=-1).to(_real_dtype(state.dtype))


def pauli_string_expectation(state: torch.Tensor, pauli: str) -> torch.Tensor:
    """<psi| P |psi> for a full n-qubit Pauli string like "XXIZ".

    Character k of ``pauli`` acts on qubit k (qubit 0 = least-significant bit).
    """
    n = len(pauli)
    if state.shape[-1] != (1 << n):
        raise ValueError("pauli string length does not match state size")
    phi = state
    for q, ch in enumerate(pauli.upper()):
        if ch == "I":
            continue
        s0, s1 = _split(phi, q, n)
        if ch == "X":
            phi = _merge(s1, s0, n)
        elif ch == "Y":
            phi = _merge(-1j * s1, 1j * s0, n)
        elif ch == "Z":
            phi = _merge(s0, -s1, n)
        else:
            raise ValueError(f"bad Pauli character {ch!r}")
    return torch.sum(torch.conj(state) * phi, dim=-1).real
