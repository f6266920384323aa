"""Wrappers of the hand-written circuit kernels (K1, K2, K3, K4).

* ``pauli_features_from_angles`` (K1, ``csrc/pauli_features.cu``) — port of
  ``dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fn``: angles
  (B, G) -> Pauli features (B, 3n) as [X | Y | Z] blocks, float32 or float64.
* ``states_from_angles`` (K2, ``csrc/states.cu``) — port of
  ``make_pallas_states_fn``: angles (B, G) -> states (B, 2^n), complex64
  from float32 angles, complex128 from float64 ones.
* ``pauli_features_from_angles_fused`` (K3, ``csrc/pauli_features_fused.cu``)
  — port of ``make_pallas_pauli_features_fused_fn``: the same Pauli features
  through the gate-fused program of ``ops/fusion.py``, float32 only like the
  Pallas kernel.
* ``states_from_angles_fused`` (K4, ``csrc/states_fused.cu``) — port of
  ``make_pallas_states_fused_fn``: the states through the fused program,
  float32 only. K3 and K4 share the op loop (``csrc/fused_program.cuh``).

On a CUDA tensor each wrapper launches its kernel (built with nvcc at first
use) and adds one to its launch count: ``.launches`` for the float32
instantiation and ``.launches_f64`` for the float64 one. On a CPU tensor it
runs the kernel's plain PyTorch version (the ``*_reference`` functions) and
counts nothing. There is no fallback: on the card a wrapper launches or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .circuit import Circuit
from .fusion import (
    PermOp, SU2Op, diag_patterns_concat, fuse_circuit, packed_inputs,
    state_from_angles_fused,
)
from .statevector import pauli_features, state_from_angles

SOURCE = "pauli_features.cu"        # K1
STATES_SOURCE = "states.cu"         # K2
FUSED_SOURCE = "states_fused.cu"    # K4
FEATURES_FUSED_SOURCE = "pauli_features_fused.cu"  # K3
SOURCES = (SOURCE, STATES_SOURCE, FEATURES_FUSED_SOURCE, FUSED_SOURCE)
MAX_QUBITS = 10
_SMEM_BUDGET = 200 * 1024  # bytes a block may take (the card allows 227 KB)

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K1_ARGS = [_vp, _vp, _vp] + [_i32] * 5 + [_i64, _vp]
_K2_ARGS = [_vp, _vp, _vp] + [_i32] * 6 + [_i64, _vp]
_SIGNATURES = {
    SOURCE: {"dqgp_pauli_features": _K1_ARGS, "dqgp_pauli_features_f64": _K1_ARGS},
    STATES_SOURCE: {"dqgp_states": _K2_ARGS, "dqgp_states_f64": _K2_ARGS},
    FUSED_SOURCE: {"dqgp_states_fused": [_vp] * 4 + [_i32] * 8 + [_i64, _vp]},
    FEATURES_FUSED_SOURCE: {"dqgp_pauli_features_fused": [_vp] * 4 + [_i32] * 5 + [_i64, _vp]},
}


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _library(source: str = SOURCE) -> ctypes.CDLL:
    lib = _build.load(source)
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _i32
    lib.dqgp_cuda_error_string.argtypes = [_i32]
    lib.dqgp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(source: str, fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of ``source``'s library on the current stream of
    ``device``; raise if the launch was refused."""
    lib = _library(source)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.dqgp_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=64)
def _gate_table(circuit: Circuit, device: torch.device) -> torch.Tensor:
    """(G, 3) int32 [kind, qubit, control] on ``device``, built once."""
    rows = [(g.kind, g.qubit, g.control) for g in circuit.gates] or [(0, 0, -1)]
    return torch.tensor(rows, dtype=torch.int32, device=device).contiguous()


def _threads_per_block(smem_bytes) -> int:
    """128 threads, halved until ``smem_bytes(threads)`` fits the budget."""
    tpb = 128
    while tpb > 1 and smem_bytes(tpb) > _SMEM_BUDGET:
        tpb //= 2
    return tpb


def launch_config(num_qubits: int, num_gates: int,
                  real_bytes: int = 4) -> tuple[int, int, int]:
    """K1's (threads per block, padded angle-row stride, dynamic smem bytes).

    A block holds its threads' states ([amplitude][thread] re and im planes)
    and their angle rows, padded to an odd stride so the per-thread reads hit
    distinct banks. Threads per block halve from 128 until that fits."""
    dim = 1 << num_qubits
    gstride = num_gates | 1

    def smem(tpb):
        return tpb * real_bytes * (2 * dim + gstride)

    tpb = _threads_per_block(smem)
    return tpb, gstride, smem(tpb)


def states_launch_config(num_qubits: int, row_len: int, real_bytes: int = 4,
                         fixed_bytes: int = 0) -> tuple[int, int, int, int]:
    """K2's and K4's (threads per block, padded row stride, padded state
    stride, dynamic smem bytes).

    As K1's, but the [amplitude][thread] planes' stride is padded to an odd
    word count (threads + 1), so the cooperative store's reads down a column
    hit distinct banks; ``fixed_bytes`` is per-block data (K4's pattern
    matrix C)."""
    dim = 1 << num_qubits
    rstride = row_len | 1

    def smem(tpb):
        return real_bytes * (2 * dim * (tpb | 1) + tpb * rstride) + fixed_bytes

    tpb = _threads_per_block(smem)
    if smem(tpb) > _SMEM_BUDGET:
        raise ValueError(f"a {num_qubits}-qubit state with {row_len}-wide rows "
                         f"and {fixed_bytes} B of tables exceeds the "
                         f"{_SMEM_BUDGET} B shared-memory budget of one block")
    return tpb, rstride, tpb | 1, smem(tpb)


def fused_features_launch_config(num_qubits: int) -> tuple[int, int]:
    """K3's (threads per block, dynamic smem bytes).

    A block holds only its threads' states (re and im planes, 8 * 2^n bytes
    a sample); the packed rows and the pattern matrix stay in device memory.
    As many threads as fit the budget, at most 128: 25 at 10 qubits."""
    per_sample = 8 << num_qubits
    tpb = max(1, min(128, _SMEM_BUDGET // per_sample))
    return tpb, tpb * per_sample


def _check_angles(circuit: Circuit, angles: torch.Tensor, kernel: str,
                  dtypes=(torch.float32, torch.float64)) -> None:
    if angles.dtype not in dtypes:
        raise NotImplementedError(
            f"the CUDA {kernel} kernel takes "
            f"{' or '.join(str(d) for d in dtypes)} angles, got {angles.dtype}")
    if angles.dim() != 2 or angles.shape[1] != circuit.num_gates:
        raise ValueError(f"angles must be (B, {circuit.num_gates}), got "
                         f"{tuple(angles.shape)}")
    if not angles.is_contiguous():
        raise ValueError("angles must be contiguous")
    if not 1 <= circuit.num_qubits <= MAX_QUBITS:
        raise ValueError(f"the CUDA {kernel} kernel supports 1 to {MAX_QUBITS} "
                         f"qubits, got {circuit.num_qubits}")


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# ---------------------------------------------------------------------------
# K1: Pauli features
# ---------------------------------------------------------------------------


def pauli_features_reference(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """K1's plain PyTorch version, on any device, in the angles' precision."""
    return pauli_features(state_from_angles(circuit, angles, _complex_of(angles.dtype)),
                          circuit.num_qubits)


def pauli_features_from_angles(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """angles (B, G) float32 or float64 -> Pauli features (B, 3n), same dtype."""
    if not _is_cuda(angles):
        return pauli_features_reference(circuit, angles)
    _check_angles(circuit, angles, "Pauli-feature")
    n = circuit.num_qubits
    B, G = angles.shape
    out = torch.empty((B, 3 * n), dtype=angles.dtype, device=angles.device)
    if B == 0:
        return out
    f64 = angles.dtype == torch.float64
    tpb, gstride, smem = launch_config(n, G, angles.element_size())
    _launch(SOURCE, "dqgp_pauli_features_f64" if f64 else "dqgp_pauli_features",
            angles.device, angles.data_ptr(),
            _gate_table(circuit, angles.device).data_ptr(), out.data_ptr(),
            B, G, n, tpb, gstride, smem)
    if f64:
        pauli_features_from_angles.launches_f64 += 1
    else:
        pauli_features_from_angles.launches += 1
    return out


# ---------------------------------------------------------------------------
# K2: states
# ---------------------------------------------------------------------------


def states_reference(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """K2's plain PyTorch version: complex64 states from float32 angles,
    complex128 from float64, on any device."""
    return state_from_angles(circuit, angles, _complex_of(angles.dtype))


def states_from_angles(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """angles (B, G) float32 or float64 -> states (B, 2^n) complex64 or
    complex128."""
    if not _is_cuda(angles):
        return states_reference(circuit, angles)
    _check_angles(circuit, angles, "states")
    n = circuit.num_qubits
    B, G = angles.shape
    out = torch.empty((B, circuit.dim), dtype=_complex_of(angles.dtype),
                      device=angles.device)
    if B == 0:
        return out
    f64 = angles.dtype == torch.float64
    tpb, gstride, sstride, smem = states_launch_config(n, G, angles.element_size())
    _launch(STATES_SOURCE, "dqgp_states_f64" if f64 else "dqgp_states",
            angles.device, angles.data_ptr(),
            _gate_table(circuit, angles.device).data_ptr(), out.data_ptr(),
            B, G, n, tpb, gstride, sstride, smem)
    if f64:
        states_from_angles.launches_f64 += 1
    else:
        states_from_angles.launches += 1
    return out


# ---------------------------------------------------------------------------
# K4: states through the fused program
# ---------------------------------------------------------------------------

_OP_SU2, _OP_PERM, _OP_DIAG = 0, 1, 2


@functools.lru_cache(maxsize=64)
def _fused_tables(circuit: Circuit, device: torch.device):
    """(op table (n_ops, 6) int32, pattern matrix C (2^n, KT) float32) on
    ``device``, built once. Op rows: [type, qubit, control, row, K, flags]
    (csrc/states_fused.cu); a DIAG row's control field holds its first
    column of C."""
    program = fuse_circuit(circuit)
    rows = []
    for op in program.ops:
        if isinstance(op, SU2Op):
            rows.append((_OP_SU2, op.qubit, op.control, 8 * op.slot, 0,
                         int(op.real) | (int(op.diag) << 1)))
        elif isinstance(op, PermOp):
            rows.append((_OP_PERM, op.qubit, op.control, 0, 0, 0))
        else:  # DiagOp
            rows.append((_OP_DIAG, 0, op.row_start - 8 * program.n_su2,
                         op.row_start, op.K, 0))
    table = torch.tensor(rows or [(_OP_PERM, 0, 0, 0, 0, 0)], dtype=torch.int32,
                         device=device).contiguous()
    cmat = torch.as_tensor(diag_patterns_concat(program), device=device).contiguous()
    return table, cmat


def states_fused_reference(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """K4's plain PyTorch version: the fused program in complex64."""
    return state_from_angles_fused(circuit, angles, torch.complex64)


def states_from_angles_fused(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """angles (B, G) float32 -> states (B, 2^n) complex64 via the fused
    program. The packed coefficient rows are built outside the kernel
    (``fusion.packed_inputs``), as the JAX package builds them outside its
    Pallas kernel."""
    if not _is_cuda(angles):
        return states_fused_reference(circuit, angles)
    _check_angles(circuit, angles, "fused states", dtypes=(torch.float32,))
    return states_from_packed(circuit, packed_inputs(fuse_circuit(circuit), angles))


def states_from_packed(circuit: Circuit, packed: torch.Tensor) -> torch.Tensor:
    """K4's launch on packed rows (B, R) float32 on the card -> states
    (B, 2^n) complex64; counted in ``states_from_angles_fused.launches``."""
    program = fuse_circuit(circuit)
    if not _is_cuda(packed) or packed.dtype != torch.float32:
        raise ValueError("packed rows must be a float32 CUDA tensor")
    if packed.dim() != 2 or packed.shape[1] != program.n_rows or not packed.is_contiguous():
        raise ValueError(f"packed rows must be contiguous (B, {program.n_rows}), got "
                         f"{tuple(packed.shape)}")
    n = circuit.num_qubits
    B = packed.shape[0]
    out = torch.empty((B, circuit.dim), dtype=torch.complex64, device=packed.device)
    if B == 0:
        return out
    table, cmat = _fused_tables(circuit, packed.device)
    R, KT = program.n_rows, cmat.shape[1]
    tpb, rstride, sstride, smem = states_launch_config(
        n, R, 4, fixed_bytes=4 * cmat.numel())
    _launch(FUSED_SOURCE, "dqgp_states_fused", packed.device, packed.data_ptr(),
            cmat.data_ptr(), table.data_ptr(), out.data_ptr(), B, R, n,
            len(program.ops), KT, tpb, rstride, sstride, smem)
    states_from_angles_fused.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: Pauli features through the fused program
# ---------------------------------------------------------------------------


def pauli_features_fused_reference(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch version: the fused program in complex64, then the
    per-qubit X, Y, Z reduction."""
    return pauli_features(state_from_angles_fused(circuit, angles, torch.complex64),
                          circuit.num_qubits)


def pauli_features_from_angles_fused(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """angles (B, G) float32 -> Pauli features (B, 3n) float32 via the fused
    program. The packed coefficient rows are built outside the kernel
    (``fusion.packed_inputs``), as the JAX package builds them outside its
    Pallas kernel."""
    if not _is_cuda(angles):
        return pauli_features_fused_reference(circuit, angles)
    _check_angles(circuit, angles, "fused Pauli-feature", dtypes=(torch.float32,))
    return pauli_features_from_packed(circuit, packed_inputs(fuse_circuit(circuit), angles))


def pauli_features_from_packed(circuit: Circuit, packed: torch.Tensor) -> torch.Tensor:
    """K3's launch on packed rows (B, R) float32 on the card -> features
    (B, 3n) float32; counted in ``pauli_features_from_angles_fused.launches``.
    The rows are transposed to (R, B) here, so the kernel's loads coalesce
    (the Pallas wrapper transposes them to ``Pt`` likewise)."""
    program = fuse_circuit(circuit)
    if not _is_cuda(packed) or packed.dtype != torch.float32:
        raise ValueError("packed rows must be a float32 CUDA tensor")
    if packed.dim() != 2 or packed.shape[1] != program.n_rows:
        raise ValueError(f"packed rows must be (B, {program.n_rows}), got "
                         f"{tuple(packed.shape)}")
    n = circuit.num_qubits
    if not 1 <= n <= MAX_QUBITS:
        raise ValueError(f"the CUDA fused Pauli-feature kernel supports 1 to "
                         f"{MAX_QUBITS} qubits, got {n}")
    B = packed.shape[0]
    out = torch.empty((B, 3 * n), dtype=torch.float32, device=packed.device)
    if B == 0:
        return out
    packed_t = packed.t().contiguous()
    table, cmat = _fused_tables(circuit, packed.device)
    tpb, smem = fused_features_launch_config(n)
    _launch(FEATURES_FUSED_SOURCE, "dqgp_pauli_features_fused", packed.device,
            packed_t.data_ptr(), cmat.data_ptr(), table.data_ptr(), out.data_ptr(),
            B, n, len(program.ops), cmat.shape[1], tpb, smem)
    pauli_features_from_angles_fused.launches += 1
    return out


pauli_features_from_angles.launches = 0
pauli_features_from_angles.launches_f64 = 0
states_from_angles.launches = 0
states_from_angles.launches_f64 = 0
states_from_angles_fused.launches = 0
pauli_features_from_angles_fused.launches = 0

_COUNTERS = {
    "K1": (pauli_features_from_angles, "launches"),
    "K1_f64": (pauli_features_from_angles, "launches_f64"),
    "K2": (states_from_angles, "launches"),
    "K2_f64": (states_from_angles, "launches_f64"),
    "K3": (pauli_features_from_angles_fused, "launches"),
    "K4": (states_from_angles_fused, "launches"),
}


def launch_counts() -> dict:
    """Every wrapper's launch count, by kernel and precision."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
