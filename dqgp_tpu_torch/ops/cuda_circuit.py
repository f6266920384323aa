"""Wrapper of the hand-written Pauli-feature kernel (K1).

``pauli_features_from_angles`` is the port of
``dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fn``: f32 angles
(B, G) -> Pauli features (B, 3n) as [X | Y | Z] blocks. On a CUDA tensor it
launches ``csrc/pauli_features.cu`` (built with nvcc at first use) and counts
the launch in ``pauli_features_from_angles.launches``. On a CPU tensor it runs
the plain PyTorch engine (``state_from_angles`` + ``pauli_features``) and
counts nothing. There is no fallback: on the card it launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .circuit import Circuit
from .statevector import pauli_features, state_from_angles

SOURCE = "pauli_features.cu"
MAX_QUBITS = 10
_SMEM_BUDGET = 200 * 1024  # bytes a block may take (the card allows 227 KB)


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dqgp_pauli_features.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                        ctypes.c_longlong, vp]
    lib.dqgp_pauli_features.restype = i32
    lib.dqgp_cuda_error_string.argtypes = [i32]
    lib.dqgp_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _gate_table(circuit: Circuit, device: torch.device) -> torch.Tensor:
    """(G, 3) int32 [kind, qubit, control] on ``device``, built once."""
    rows = [(g.kind, g.qubit, g.control) for g in circuit.gates] or [(0, 0, -1)]
    return torch.tensor(rows, dtype=torch.int32, device=device).contiguous()


def launch_config(num_qubits: int, num_gates: int) -> tuple[int, int, int]:
    """(threads per block, padded angle-row stride, dynamic smem bytes).

    A block holds its threads' states ([amplitude][thread] re and im planes)
    and their angle rows, padded to an odd stride so the per-thread reads hit
    distinct banks. Threads per block halve from 128 until that fits."""
    dim = 1 << num_qubits
    gstride = num_gates | 1
    tpb = 128
    while tpb > 1 and tpb * (8 * dim + 4 * gstride) > _SMEM_BUDGET:
        tpb //= 2
    return tpb, gstride, tpb * (8 * dim + 4 * gstride)


def pauli_features_reference(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device."""
    return pauli_features(state_from_angles(circuit, angles, torch.complex64),
                          circuit.num_qubits)


def pauli_features_from_angles(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """angles (B, G) float32 -> Pauli features (B, 3n) float32."""
    if not _is_cuda(angles):
        return pauli_features_reference(circuit, angles)
    n = circuit.num_qubits
    if angles.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA Pauli-feature kernel is float32-only, got {angles.dtype}; "
            f"the float64 statevector path is not ported to the card")
    if angles.dim() != 2 or angles.shape[1] != circuit.num_gates:
        raise ValueError(f"angles must be (B, {circuit.num_gates}), got "
                         f"{tuple(angles.shape)}")
    if not angles.is_contiguous():
        raise ValueError("angles must be contiguous")
    if not 1 <= n <= MAX_QUBITS:
        raise ValueError(f"the CUDA Pauli-feature kernel supports 1 to "
                         f"{MAX_QUBITS} qubits, got {n}")
    B, G = angles.shape
    out = torch.empty((B, 3 * n), dtype=torch.float32, device=angles.device)
    if B == 0:
        return out
    tpb, gstride, smem = launch_config(n, G)
    gates = _gate_table(circuit, angles.device)
    lib = _library()
    with torch.cuda.device(angles.device):
        stream = torch.cuda.current_stream(angles.device).cuda_stream
        err = lib.dqgp_pauli_features(angles.data_ptr(), gates.data_ptr(),
                                      out.data_ptr(), B, G, n, tpb, gstride,
                                      smem, stream)
    if err != 0:
        raise RuntimeError("Pauli-feature kernel launch failed: "
                           + lib.dqgp_cuda_error_string(err).decode())
    pauli_features_from_angles.launches += 1
    return out


pauli_features_from_angles.launches = 0
