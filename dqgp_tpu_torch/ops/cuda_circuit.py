"""Wrappers of the hand-written circuit kernels (K1, K2, K3, K4).

* ``pauli_features_from_angles`` (K1, ``csrc/pauli_features.cu``) — port of
  ``dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fn``: angles
  (B, G) -> Pauli features (B, 3n) as [X | Y | Z] blocks, float32 or float64.
* ``states_from_angles`` (K2, ``csrc/states.cu``) — port of
  ``make_pallas_states_fn``: angles (B, G) -> states (B, 2^n), complex64
  from float32 angles, complex128 from float64 ones.
* ``pauli_features_from_angles_fused`` (K3, ``csrc/pauli_features_fused.cu``
  with ``csrc/warp_state.cuh``) — port of
  ``make_pallas_pauli_features_fused_fn``: the same Pauli features through
  the gate-fused program of ``ops/fusion.py``, float32 only like the Pallas
  kernel; a sample's state in registers across a warp's lanes, the fused
  coefficients built inside the kernel from the angles.
* ``states_from_angles_fused`` (K4, ``csrc/states_fused.cu`` with
  ``csrc/fused_program.cuh``) — port of ``make_pallas_states_fused_fn``: the
  states through the fused program, float32 only.

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
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .circuit import Circuit
from .fusion import (
    DiagOp, PermOp, SU2Op, diag_patterns_concat, fuse_circuit, packed_inputs,
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
_K3_THREADS = 256               # K3's launch bound (two blocks an SM)
_K3_SMEM_BUDGET = 112 * 1024    # so that two K3 blocks fit an SM's 228 KB

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K1_ARGS = [_vp, _vp, _vp] + [_i32] * 5 + [_i64, _vp]
_K2_ARGS = [_vp, _vp, _vp] + [_i32] * 6 + [_i64, _vp]
_SIGNATURES = {
    SOURCE: {"dqgp_pauli_features": _K1_ARGS, "dqgp_pauli_features_f64": _K1_ARGS},
    STATES_SOURCE: {"dqgp_states": _K2_ARGS, "dqgp_states_f64": _K2_ARGS},
    FUSED_SOURCE: {"dqgp_states_fused": [_vp] * 4 + [_i32] * 8 + [_i64, _vp]},
    FEATURES_FUSED_SOURCE: {
        "dqgp_pauli_features_fused": [_vp] * 6 + [_i32] * 9 + [_i64, _vp],
        "dqgp_pauli_features_fused_blocks_per_sm": [_i32, _i32, _i64]},
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


@functools.lru_cache(maxsize=64)
def k3_tables(circuit: Circuit):
    """K3's tables for ``circuit``'s fused program, as numpy. K3 stages each
    sample's row as its G angles, then its DiagOps' member angles, then
    (where a sample spans several lanes) its SU2 ops' 8 coefficients each:

    * the op table (n_ops, 6) int32, rows [type, qubit, control, first,
      count, aux]: an SU2 op's gates are gate-table rows [first, first +
      count) in application order, and aux is its flags (bit 0 real, bit 1
      diagonal) | the row offset of its coefficients (G + n_members + 8 *
      slot) << 2; a DiagOp's member angles lie at row offsets [first, first
      + K) and aux is its first column of C; a PERM row is a CX;
    * the gate table (n_gates, 2) int32, rows [gate kind, gate index into
      the angle row], the SU2 ops' gates;
    * the member table (n_members,) int32, each DiagOp member's gate index,
      -1 for a CZ (its angle is pi);
    * C (``diag_patterns_concat``, (2^n, KT) float32) permuted to (KT, A,
      L): entry [j, r, l] is C[l * A + r, j], for the amplitude in register
      r of lane l of a sample's lane group (A = min(2^n, 32) registers, L =
      2^n / A lanes), so the lanes of a group read consecutive words.

    The op and gate tables have at least one row, so that the kernel
    always gets a valid pointer; it reads no member where there is none."""
    program = fuse_circuit(circuit)
    G = circuit.num_gates
    members = [gi for op in program.ops if isinstance(op, DiagOp)
               for _, _, _, gi in op.members]
    coef_at = G + len(members)
    ops, gates, member_at = [], [], G
    for op in program.ops:
        if isinstance(op, SU2Op):
            ops.append((_OP_SU2, op.qubit, op.control, len(gates), len(op.gate_idxs),
                        int(op.real) | (int(op.diag) << 1)
                        | ((coef_at + 8 * op.slot) << 2)))
            gates += [(circuit.gates[gi].kind, gi) for gi in op.gate_idxs]
        elif isinstance(op, PermOp):
            ops.append((_OP_PERM, op.qubit, op.control, 0, 0, 0))
        else:  # DiagOp
            ops.append((_OP_DIAG, 0, -1, member_at, op.K, op.row_start - 8 * program.n_su2))
            member_at += op.K
    cmat = diag_patterns_concat(program)
    lanes = max(1, cmat.shape[0] // 32)
    cperm = cmat.reshape(lanes, cmat.shape[0] // lanes, cmat.shape[1]).transpose(2, 1, 0)
    return (np.array(ops or [(_OP_PERM, 0, 0, 0, 0, 0)], np.int32),
            np.array(gates or [(0, 0)], np.int32), np.array(members, np.int32),
            np.ascontiguousarray(cperm))


@functools.lru_cache(maxsize=64)
def _k3_device_tables(circuit: Circuit, device: torch.device):
    """``k3_tables(circuit)`` on ``device``, built once."""
    return tuple(torch.as_tensor(t, device=device).contiguous() for t in k3_tables(circuit))


def pauli_features_from_angles_fused(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """angles (B, G) float32 -> Pauli features (B, 3n) float32 via the fused
    program. The kernel builds each SU2 op's 2x2 from the angles itself,
    as the JAX package's Pallas wrapper builds its packed rows from them."""
    if not _is_cuda(angles):
        return pauli_features_fused_reference(circuit, angles)
    _check_angles(circuit, angles, "fused Pauli-feature", dtypes=(torch.float32,))
    n = circuit.num_qubits
    B, G = angles.shape
    out = torch.empty((B, 3 * n), dtype=torch.float32, device=angles.device)
    if B == 0:
        return out
    program = fuse_circuit(circuit)
    ops, gates, members, cperm = _k3_device_tables(circuit, angles.device)
    geo = fused_features_geometry(circuit)
    _launch(FEATURES_FUSED_SOURCE, "dqgp_pauli_features_fused", angles.device,
            angles.data_ptr(), cperm.data_ptr(), ops.data_ptr(), gates.data_ptr(),
            members.data_ptr(), out.data_ptr(), B, n, G, len(program.ops),
            gates.shape[0], members.shape[0], program.n_su2, cperm.shape[0],
            geo.threads, geo.smem_bytes)
    pauli_features_from_angles_fused.launches += 1
    return out


class K3Geometry(NamedTuple):
    threads: int          # threads a block
    lanes: int            # lanes a sample's state spreads over
    samples: int          # samples a block works on at a time
    smem_bytes: int       # dynamic shared memory a block
    c_bytes: int          # of which the permuted pattern matrix C


def fused_features_geometry(circuit: Circuit) -> K3Geometry:
    """K3's launch geometry for ``circuit`` (csrc/pauli_features_fused.cu).

    A sample's state lives in registers over max(1, 2^(n-5)) lanes, so a
    warp works on 32 / lanes samples and no state is in shared memory. A
    block holds the int32 tables (padded to 16 bytes, with the batch loop's
    two words), C ((2^n, KT) float32) and, per warp, one word and its
    samples' staged rows at an odd stride: each sample's G angles, its
    phase runs' member angles and, where it spans several lanes, 8
    coefficients for each SU2 op. 256 threads, halved until two blocks fit
    an SM."""
    ops, gates, members, cperm = k3_tables(circuit)
    n = circuit.num_qubits
    lanes = 1 << max(0, n - 5)
    per_warp = 32 // lanes
    c_bytes = cperm.nbytes
    fixed = 4 * ((ops.size + gates.size + members.size + 2 + 3) & ~3) + c_bytes
    coef_words = 8 * fuse_circuit(circuit).n_su2 if lanes > 1 else 0
    row_words = (circuit.num_gates + members.size + coef_words) | 1
    warp_bytes = 4 * (per_warp * row_words + 1)
    tpb = _K3_THREADS
    while tpb > 32 and fixed + tpb // 32 * warp_bytes > _K3_SMEM_BUDGET:
        tpb //= 2
    smem = fixed + tpb // 32 * warp_bytes
    if smem > _K3_SMEM_BUDGET:
        raise ValueError(f"K3's tables for {n} qubits (C {c_bytes} B) exceed the "
                         f"{_K3_SMEM_BUDGET} B a block may take")
    return K3Geometry(tpb, lanes, tpb // 32 * per_warp, smem, c_bytes)


def fused_features_blocks_per_sm(geo: K3Geometry, num_qubits: int) -> int:
    """Resident K3 blocks an SM holds at this geometry, as the CUDA occupancy
    calculator reckons it from the build's registers and ``geo``'s shared
    memory (card only)."""
    return _library(FEATURES_FUSED_SOURCE).dqgp_pauli_features_fused_blocks_per_sm(
        num_qubits, geo.threads, geo.smem_bytes)


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
