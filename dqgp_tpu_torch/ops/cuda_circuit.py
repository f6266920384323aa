"""Wrappers of the hand-written circuit kernels (K1, K2, K3, K4).

* ``pauli_features_from_angles`` (K1, ``csrc/pauli_features.cu``) — port of
  ``dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fn``: angles
  (B, G) -> Pauli features (B, 3n) as [X | Y | Z] blocks, float32 or
  float64: a sample's state in registers across a warp's lanes
  (``csrc/warp_state.cuh``, templated on the real type: complex64 or
  complex128), a gate at a time, then K3's reduction. At 11 and 12 qubits
  (``csrc/pauli_features_q11_12.cu``, ``pauli_features_f64_q11_12.cu``) a
  sample spans 2 and 4 warps.
* ``states_from_angles`` (K2, ``csrc/states.cu``) — port of
  ``make_pallas_states_fn``: angles (B, G) -> states (B, 2^n), complex64
  from float32 angles, complex128 from float64 ones: the same register
  layout and gate sequence, then a coalesced write-out.
* ``pauli_features_from_angles_fused`` (K3, ``csrc/pauli_features_fused.cu``)
  — port of ``make_pallas_pauli_features_fused_fn``: the same Pauli features
  through the gate-fused program of ``ops/fusion.py``, float32 only like the
  Pallas kernel; a sample's state in registers across a warp's lanes, the
  fused coefficients built inside the kernel from the angles
  (``csrc/warp_program.cuh``, the body it shares with K4); at 11 and 12
  qubits (``csrc/pauli_features_fused_q11_12.cu``) a sample across 2 and 4
  warps, the phase runs' pattern columns derived from their members.
* ``states_from_angles_fused`` (K4, ``csrc/states_fused.cu``) — port of
  ``make_pallas_states_fused_fn``: the states through the fused program,
  float32 only; ``warp_program.cuh``'s body, then the write-out.
* ``circuit_vjp`` (``csrc/circuit_vjp.cu``) — the backward of K1 and K2:
  the angles' gradient (B, G) from the cotangent of the features or of the
  states, float32, by adjoint differentiation (a sample's two states in
  registers across a warp's lanes, ``csrc/warp_state.cuh``, the forward
  batch loop K1 and K2 share, then the gates walked backwards). The JAX
  package has no counterpart kernel: its Pallas kernels have no VJP.
  ``CircuitFunction`` makes the forward wrappers differentiable with it.

Each kernel takes 1 to ``MAX_QUBITS[kernel]`` qubits: K1 (both precisions)
and K3 up to 12, K2, K4 and the adjoint up to ``ONE_WARP_QUBITS`` = 10, where
a sample's state still fits one warp (11 and 12 qubits for them are still to
be ported); outside its range a wrapper raises on the card, naming the
kernel and its range. K1 and K3 take qubit q as bit q of the state's index
in registers, lanes and warps; the states kernels (K2, K4) put the low
qubits on the lanes so that a sample's lanes write consecutive amplitudes
(``states_bit``); the adjoint
takes each forward kernel's map. The kernels see only those physical bits:
the tables built here carry the map. The float64 instantiations of K1 and K2
share every map, table and geometry rule with the float32 ones; only their
registers a thread (``f64_min_blocks``) and staging words differ.

On a CUDA tensor each wrapper launches its kernel (built with nvcc at first
use) inside the span ``cuda_circuit.launch:<key>`` (``tracing``; ``<key>``
the kernel's key in ``launch_counts()``) and adds one to its launch count:
``.launches`` for the float32 instantiation and ``.launches_f64`` for the
float64 one (``circuit_vjp``: ``.launches_features`` and
``.launches_states``); a launch of an 11- or 12-qubit instantiation (one of
``WIDE_SOURCES``) is counted in ``wide_launch_counts()`` as well. On a CPU
tensor it runs the kernel's plain PyTorch version (the ``*_reference``
functions) and counts nothing. There is no fallback: on the card a wrapper
launches or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from . import _build, cuda_eig, cuda_pair
from .circuit import Circuit
from .fusion import (
    DiagOp, PermOp, SU2Op, diag_patterns_concat, fuse_circuit, state_from_angles_fused,
)
from .statevector import pauli_features, state_from_angles

SOURCE = "pauli_features.cu"        # K1
STATES_SOURCE = "states.cu"         # K2
FUSED_SOURCE = "states_fused.cu"    # K4
FEATURES_FUSED_SOURCE = "pauli_features_fused.cu"  # K3
VJP_SOURCE = "circuit_vjp.cu"       # the backward of K1 and K2
# the instantiations at 11 and 12 qubits, translation units of their own
WIDE_SOURCES = {"K1": "pauli_features_q11_12.cu", "K1_f64": "pauli_features_f64_q11_12.cu",
                "K3": "pauli_features_fused_q11_12.cu"}
SOURCES = (SOURCE, STATES_SOURCE, FEATURES_FUSED_SOURCE, FUSED_SOURCE, VJP_SOURCE,
           *WIDE_SOURCES.values())
ONE_WARP_QUBITS = 10  # the most qubits whose state one warp holds
MAX_QUBITS = {"K1": 12, "K2": ONE_WARP_QUBITS, "K3": 12, "K4": ONE_WARP_QUBITS,
              "vjp": ONE_WARP_QUBITS}
KERNEL_NAMES = {"K1": "Pauli-feature kernel (K1)", "K2": "states kernel (K2)",
                "K3": "fused Pauli-feature kernel (K3)", "K4": "fused states kernel (K4)",
                "vjp": "adjoint kernel (the backward of K1 and K2)"}
_WARP_THREADS = 256             # the warp kernels' launch bound
_WARP_SMEM_PER_SM = 224 * 1024  # what an SM's resident blocks share of its 228 KB

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATES_ARGS = [_vp, _vp, _vp] + [_i32] * 4 + [_i64, _vp]  # K1 and K2
_FUSED_ARGS = [_vp] * 6 + [_i32] * 9 + [_i64, _vp]
_OCCUPANCY_ARGS = [_i32, _i32, _i64]
_SIGNATURES = {
    SOURCE: {"dqgp_pauli_features": _GATES_ARGS,
             "dqgp_pauli_features_f64": _GATES_ARGS,
             "dqgp_pauli_features_blocks_per_sm": _OCCUPANCY_ARGS,
             "dqgp_pauli_features_f64_blocks_per_sm": _OCCUPANCY_ARGS},
    STATES_SOURCE: {"dqgp_states": _GATES_ARGS,
                    "dqgp_states_f64": _GATES_ARGS,
                    "dqgp_states_blocks_per_sm": _OCCUPANCY_ARGS,
                    "dqgp_states_f64_blocks_per_sm": _OCCUPANCY_ARGS},
    FUSED_SOURCE: {"dqgp_states_fused": _FUSED_ARGS,
                   "dqgp_states_fused_blocks_per_sm": _OCCUPANCY_ARGS},
    FEATURES_FUSED_SOURCE: {"dqgp_pauli_features_fused": _FUSED_ARGS,
                            "dqgp_pauli_features_fused_blocks_per_sm": _OCCUPANCY_ARGS},
    VJP_SOURCE: {"dqgp_circuit_vjp": [_vp] * 4 + [_i32] * 5 + [_i64, _vp],
                 "dqgp_circuit_vjp_blocks_per_sm": _OCCUPANCY_ARGS},
}
_SIGNATURES.update({src: _SIGNATURES[FEATURES_FUSED_SOURCE if k == "K3" else SOURCE]
                    for k, src in WIDE_SOURCES.items()})
# each warp kernel's (source, launch function, occupancy function)
_WARP_KERNELS = {
    "K1": (SOURCE, "dqgp_pauli_features", "dqgp_pauli_features_blocks_per_sm"),
    "K1_f64": (SOURCE, "dqgp_pauli_features_f64", "dqgp_pauli_features_f64_blocks_per_sm"),
    "K2": (STATES_SOURCE, "dqgp_states", "dqgp_states_blocks_per_sm"),
    "K2_f64": (STATES_SOURCE, "dqgp_states_f64", "dqgp_states_f64_blocks_per_sm"),
    "K3": (FEATURES_FUSED_SOURCE, "dqgp_pauli_features_fused",
           "dqgp_pauli_features_fused_blocks_per_sm"),
    "K4": (FUSED_SOURCE, "dqgp_states_fused", "dqgp_states_fused_blocks_per_sm"),
    "vjp": (VJP_SOURCE, "dqgp_circuit_vjp", "dqgp_circuit_vjp_blocks_per_sm"),
}


def kernel_source(kernel: str, num_qubits: int) -> str:
    """The source that holds warp kernel ``kernel``'s instantiation for
    ``num_qubits``."""
    if num_qubits > ONE_WARP_QUBITS and kernel in WIDE_SOURCES:
        return WIDE_SOURCES[kernel]
    return _WARP_KERNELS[kernel][0]


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _library(source: str = SOURCE) -> ctypes.CDLL:
    # a process's first use of a source: its build, or the reuse of a build
    with tracing.span(f"cuda_circuit.load:{source}"):
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
        # the stream's handle itself: building a torch.cuda.Stream around it
        # costs more host time than a small launch takes on the device
        err = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.dqgp_cuda_error_string(err).decode())


def _launch_counted(key: str, source: str, fn: str, device: torch.device, *args) -> None:
    """``_launch`` inside the span ``cuda_circuit.launch:<key>``, then one
    more launch of ``key`` (a ``launch_counts()`` key) and, where ``source``
    is the key's wide source, one more wide launch."""
    with tracing.span(f"cuda_circuit.launch:{key}"):
        _launch(source, fn, device, *args)
    counter, attr = _COUNTERS[key]
    setattr(counter, attr, getattr(counter, attr) + 1)
    if source == WIDE_SOURCES.get(key):
        _wide_launches[key] += 1


def states_bit(num_qubits: int, qubit: int) -> int:
    """The bit of the state's index on which the states kernels (K2 float32,
    K4) hold ``qubit``; bits 0-4 pick a lane's register, bits 5.. the lane.

    Qubits 0..n-6 go to the lane bits and n-5..n-1 to the register bits, so
    that amplitude k is register k >> (n-5) of lane k & (L-1) and the L lanes
    of a sample hold consecutive amplitudes. Up to 5 qubits a lane holds the
    whole sample and the map is the identity; -1 (no control) stays -1."""
    if num_qubits <= 5 or qubit < 0:
        return qubit
    return qubit + 5 if qubit < num_qubits - 5 else qubit - (num_qubits - 5)


def gate_table(circuit: Circuit, states_layout: bool = False) -> np.ndarray:
    """(G, 3) int32 [kind, qubit, control], at least one row; with
    ``states_layout`` the qubits are the states kernels' physical bits."""
    n = circuit.num_qubits
    bit = (lambda q: states_bit(n, q)) if states_layout else (lambda q: q)
    rows = [(g.kind, bit(g.qubit), bit(g.control)) for g in circuit.gates]
    return np.array(rows or [(0, 0, -1)], np.int32)


@functools.lru_cache(maxsize=64)
def _gate_table(circuit: Circuit, device: torch.device,
                states_layout: bool = False) -> torch.Tensor:
    """``gate_table`` on ``device``, built once."""
    return torch.as_tensor(gate_table(circuit, states_layout), device=device).contiguous()


def _check_angles(circuit: Circuit, angles: torch.Tensor, kernel: str,
                  dtypes=(torch.float32, torch.float64)) -> None:
    """``kernel`` is a key of ``MAX_QUBITS``."""
    name = KERNEL_NAMES[kernel]
    if angles.dtype not in dtypes:
        raise NotImplementedError(
            f"the CUDA {name} takes "
            f"{' or '.join(str(d) for d in dtypes)} angles, got {angles.dtype}")
    if angles.dim() != 2 or angles.shape[1] != circuit.num_gates:
        raise ValueError(f"angles must be (B, {circuit.num_gates}), got "
                         f"{tuple(angles.shape)}")
    if not angles.is_contiguous():
        raise ValueError("angles must be contiguous")
    if not 1 <= circuit.num_qubits <= MAX_QUBITS[kernel]:
        raise ValueError(f"the CUDA {name} supports 1 to {MAX_QUBITS[kernel]} qubits, "
                         f"got {circuit.num_qubits}")


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
    _check_angles(circuit, angles, "K1")
    n = circuit.num_qubits
    B, G = angles.shape
    out = torch.empty((B, 3 * n), dtype=angles.dtype, device=angles.device)
    if B == 0:
        return out
    key = "K1_f64" if angles.dtype == torch.float64 else "K1"
    geo = features_geometry(circuit, angles.element_size())
    _launch_counted(key, kernel_source(key, n), _WARP_KERNELS[key][1],
                    angles.device, angles.data_ptr(),
                    _gate_table(circuit, angles.device).data_ptr(),  # qubit q on bit q
                    out.data_ptr(), B, G, n, geo.threads, geo.smem_bytes)
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
    _check_angles(circuit, angles, "K2")
    n = circuit.num_qubits
    B, G = angles.shape
    out = torch.empty((B, circuit.dim), dtype=_complex_of(angles.dtype),
                      device=angles.device)
    if B == 0:
        return out
    key = "K2_f64" if angles.dtype == torch.float64 else "K2"
    geo = states_geometry(circuit, angles.element_size())
    _launch_counted(key, STATES_SOURCE, _WARP_KERNELS[key][1], angles.device,
                    angles.data_ptr(), _gate_table(circuit, angles.device, True).data_ptr(),
                    out.data_ptr(), B, G, n, geo.threads, geo.smem_bytes)
    return out


# ---------------------------------------------------------------------------
# The fused program's tables and geometry (K3, K4)
# ---------------------------------------------------------------------------

_OP_SU2, _OP_PERM, _OP_DIAG = 0, 1, 2


@functools.lru_cache(maxsize=128)
def fused_tables(circuit: Circuit, states_layout: bool = False):
    """The tables K3 and K4 run ``circuit``'s fused program from, as numpy;
    with ``states_layout`` under the states kernels' bit map (K4), else with
    qubit q on bit q (K3). The kernels stage each sample's row as its G
    angles, then its DiagOps' member angles, then (where a sample spans
    several lanes) its SU2 ops' 8 coefficients each:

    * the op table (n_ops, 6) int32, rows [type, qubit, control, first,
      count, aux], qubit and control as physical bits: an SU2 op's gates are
      gate-table rows [first, first + count) in application order, and aux is
      its flags (bit 0 real, bit 1 diagonal) | the row offset of its
      coefficients (G + n_members + 8 * slot) << 2; a DiagOp's member angles
      lie at row offsets [first, first + K) and aux is its first column of
      C; a PERM row is a CX;
    * the gate table (n_gates, 2) int32, rows [gate kind, gate index into
      the angle row], the SU2 ops' gates;
    * the member table (n_members,) int32, each DiagOp member's gate index,
      -1 for a CZ (its angle is pi);
    * C (``diag_patterns_concat``, (2^n, KT) float32) permuted to (KT, A,
      L): entry [j, r, l] is the column-j pattern of the amplitude in
      register r of lane l of a sample's lane group (A = min(2^n, 32)
      registers, L = 2^n / A lanes), which is amplitude l * A + r under
      K3's map and r * L + l under the states kernels', so the lanes of a
      group read consecutive words.

    From 11 qubits up C (176 KB and more) is not staged: it is (0, 32, L),
    and the member table is followed by each member's code, kind | bit of
    its qubit << 4 | bit of its control (0 for an RZ) << 8, from which each
    lane of K3 folds a phase run's polynomial over its register bits
    (``csrc/warp_state.cuh``'s apply_diag_poly).

    The op and gate tables have at least one row, so that the kernel
    always gets a valid pointer; it reads no member where there is none."""
    program = fuse_circuit(circuit)
    n, G = circuit.num_qubits, circuit.num_gates
    bit = (lambda q: states_bit(n, q)) if states_layout else (lambda q: q)
    members = [gi for op in program.ops if isinstance(op, DiagOp)
               for _, _, _, gi in op.members]
    coef_at = G + len(members)
    ops, gates, member_at = [], [], G
    for op in program.ops:
        if isinstance(op, SU2Op):
            ops.append((_OP_SU2, bit(op.qubit), bit(op.control), len(gates),
                        len(op.gate_idxs), int(op.real) | (int(op.diag) << 1)
                        | ((coef_at + 8 * op.slot) << 2)))
            gates += [(circuit.gates[gi].kind, gi) for gi in op.gate_idxs]
        elif isinstance(op, PermOp):
            ops.append((_OP_PERM, bit(op.qubit), bit(op.control), 0, 0, 0))
        else:  # DiagOp
            ops.append((_OP_DIAG, 0, -1, member_at, op.K, op.row_start - 8 * program.n_su2))
            member_at += op.K
    dim = circuit.dim
    lanes = max(1, dim // 32)
    if n > ONE_WARP_QUBITS:
        members += member_codes(circuit, states_layout)
        return (np.array(ops or [(_OP_PERM, 0, 0, 0, 0, 0)], np.int32),
                np.array(gates or [(0, 0)], np.int32), np.array(members, np.int32),
                np.zeros((0, 32, lanes), np.float32))
    cmat = diag_patterns_concat(program)
    KT = cmat.shape[1]
    if states_layout:  # amplitude r * L + l
        cperm = cmat.reshape(dim // lanes, lanes, KT).transpose(2, 0, 1)
    else:              # amplitude l * A + r
        cperm = cmat.reshape(lanes, dim // lanes, KT).transpose(2, 1, 0)
    return (np.array(ops or [(_OP_PERM, 0, 0, 0, 0, 0)], np.int32),
            np.array(gates or [(0, 0)], np.int32), np.array(members, np.int32),
            np.ascontiguousarray(cperm))


def member_codes(circuit: Circuit, states_layout: bool = False) -> list:
    """Each phase-run member's code, kind | bit of its qubit << 4 | bit of its
    control (0 for an RZ) << 8, in the member table's order: from 11 qubits up
    K3 builds the phase runs from them (``csrc/warp_state.cuh``'s
    lane_polynomial), by ``fusion.diag_pattern``'s conventions."""
    n = circuit.num_qubits
    bit = (lambda q: states_bit(n, q)) if states_layout else (lambda q: q)
    return [kind | bit(q) << 4 | max(bit(c), 0) << 8 for op in fuse_circuit(circuit).ops
            if isinstance(op, DiagOp) for kind, q, c, _ in op.members]


@functools.lru_cache(maxsize=128)
def _fused_device_tables(circuit: Circuit, device: torch.device, states_layout: bool):
    """``fused_tables`` on ``device``, built once."""
    return tuple(torch.as_tensor(t, device=device).contiguous()
                 for t in fused_tables(circuit, states_layout))


class WarpGeometry(NamedTuple):
    """Launch geometry of a warp kernel (K1 and K2, K3, K4, the adjoint)."""

    threads: int          # threads a block
    lanes: int            # lanes a sample's state spreads over
    samples: int          # samples a block works on at a time
    smem_bytes: int       # dynamic shared memory a block
    c_bytes: int          # of which the permuted pattern matrix C (K3, K4)
    warps: int = 1        # warps a sample's state spreads over (11, 12 qubits: 2, 4)


def exchange_words(num_qubits: int) -> int:
    """Words a warp's exchange slot takes where a sample spans several warps
    (csrc/warp_state.cuh's Exchange): its state, 32 registers x 32 lanes, re
    and im, then its 3n partial sums of the reduction, padded to 16 bytes;
    none up to ``ONE_WARP_QUBITS``."""
    if num_qubits <= ONE_WARP_QUBITS:
        return 0
    return (2 * 32 * 32 + 3 * num_qubits + 3) & ~3


def _warp_geometry(num_qubits: int, table_words: int, c_bytes: int,
                   row_words: int, what: str, blocks_per_sm: int = 2,
                   threads: int = _WARP_THREADS,
                   scratch_warp_words: int = 0, real_bytes: int = 4) -> WarpGeometry:
    """A sample's state lives in registers over max(1, 2^(n-5)) lanes, so a
    warp works on 32 / lanes samples up to 10 qubits and a group of
    2^(n-10) warps on one sample above; no state is in shared memory but
    for the exchange slots of a sample across warps. A block holds the
    slots of as many warps as the launch bound allows (``exchange_words``
    each), its int32 tables with the batch loop's two words (padded to 16
    bytes), C and, per warp, one word, its samples' staged rows at an odd
    stride (each warp of a group its own copy) and ``scratch_warp_words`` of
    the kernel's own (after every warp's rows); slots, rows, the word and
    scratch are words of ``real_bytes``, and in float64 a warp's rows and
    word are padded to 16 bytes. ``threads`` a block, halved until
    ``blocks_per_sm`` blocks (the kernel's launch bound) fit an SM, and
    never below a group."""
    lanes = 1 << max(0, num_qubits - 5)
    warps = max(1, lanes // 32)
    per_group = max(1, 32 // lanes)  # samples a group of `warps` warps
    slots = real_bytes * _WARP_THREADS // 32 * exchange_words(num_qubits)
    fixed = slots + 4 * ((table_words + 2 + 3) & ~3) + c_bytes
    rows = per_group * (row_words | 1)
    rows = rows + 1 if real_bytes == 4 else (rows + 2) & ~1
    warp_bytes = real_bytes * (rows + scratch_warp_words)
    budget = _WARP_SMEM_PER_SM // blocks_per_sm
    tpb = threads
    while tpb > 32 * warps and fixed + tpb // 32 * warp_bytes > budget:
        tpb //= 2
    smem = fixed + tpb // 32 * warp_bytes
    if smem > budget:
        raise ValueError(f"{what} for {num_qubits} qubits ({fixed} B of tables, "
                         f"{warp_bytes} B a warp) exceed the {budget} B "
                         f"a block may take")
    return WarpGeometry(tpb, lanes, tpb // 32 // warps * per_group, smem, c_bytes, warps)


@functools.lru_cache(maxsize=128)
def fused_geometry(circuit: Circuit) -> WarpGeometry:
    """K3's and K4's launch geometry for ``circuit`` (csrc/warp_program.cuh):
    the tables are the op, gate and member tables (with the members' codes
    from 11 qubits up), and a sample's staged row is its G angles, its phase
    runs' member angles and, where it spans several lanes, 8 coefficients
    for each SU2 op. The same for both bit maps."""
    ops, gates, members, cperm = fused_tables(circuit)
    n = circuit.num_qubits
    n_members = members.size // (2 if n > ONE_WARP_QUBITS else 1)  # then codes
    coef_words = 8 * fuse_circuit(circuit).n_su2 if n > 5 else 0
    return _warp_geometry(n, ops.size + gates.size + members.size, cperm.nbytes,
                          circuit.num_gates + n_members + coef_words,
                          "the fused program's tables")


def f64_min_blocks(num_qubits: int) -> int:
    """Resident blocks an SM that the float64 instantiations of K1 and K2
    for ``num_qubits`` ask of the compiler (csrc/warp_state.cuh's
    F64MinBlocks): two where a lane's complex128 state is at most 64
    registers (n <= 4), one above, where it is 128."""
    return 2 if num_qubits <= 4 else 1


def state_stage_words(num_qubits: int) -> int:
    """Words of float64 a warp of K2's float64 kernel stages its states in
    for the write-out (csrc/warp_state.cuh's store_state_f64): its samples'
    rows of 2^n complex128, each padded by the lanes a sample where those
    are fewer than 8; none at 10 qubits, where a sample's lanes write their
    registers out directly."""
    lanes = 1 << max(0, num_qubits - 5)
    if lanes == 32:
        return 0
    return 2 * (32 // lanes) * ((1 << num_qubits) + (lanes if lanes < 8 else 0))


@functools.lru_cache(maxsize=128)
def states_geometry(circuit: Circuit, real_bytes: int = 4) -> WarpGeometry:
    """K2's launch geometry for ``circuit`` (csrc/states.cu): the table is
    the (G, 3) gate table and a sample's staged row its G angles, of
    ``real_bytes`` (4: float32, 8: float64, which stages its states for the
    write-out too and asks for ``f64_min_blocks`` blocks an SM)."""
    n, G = circuit.num_qubits, circuit.num_gates
    if real_bytes == 4:
        return _warp_geometry(n, 3 * G, 0, G, "K2's gate table and rows")
    return _warp_geometry(n, 3 * G, 0, G, "K2's float64 gate table, rows and staging",
                          f64_min_blocks(n), scratch_warp_words=state_stage_words(n),
                          real_bytes=8)


def features_min_blocks(num_qubits: int, real_bytes: int = 4) -> int:
    """Resident blocks an SM that K1's instantiation for ``num_qubits``
    asks of the compiler (csrc/warp_state.cuh's GateFeaturesMinBlocks):
    four where a lane's whole state is at most 32 registers, two above; in
    float64 ``f64_min_blocks``."""
    if real_bytes == 8:
        return f64_min_blocks(num_qubits)
    return 4 if num_qubits <= 4 else 2


@functools.lru_cache(maxsize=128)
def features_geometry(circuit: Circuit, real_bytes: int = 4) -> WarpGeometry:
    """K1's launch geometry for ``circuit`` (csrc/pauli_features.cu) in
    float32 (``real_bytes`` 4) or float64 (8): K2's table and rows, sized so
    that the blocks an SM the instantiation asks for fit its shared memory.
    Up to 5 qubits, where a lane holds a sample and a batch is few warps
    (the north-star step's 84,240 rows are 2,633), the blocks are 128
    threads: they spread evenly over the SMs where 256-thread blocks leave
    some SMs with half as much again."""
    n, G = circuit.num_qubits, circuit.num_gates
    return _warp_geometry(n, 3 * G, 0, G, "K1's gate table and rows",
                          features_min_blocks(n, real_bytes),
                          _WARP_THREADS // 2 if n <= 5 else _WARP_THREADS,
                          real_bytes=real_bytes)


def blocks_per_sm(kernel: str, geo: WarpGeometry, num_qubits: int) -> int:
    """Resident blocks an SM holds of warp kernel ``kernel`` ("K1",
    "K1_f64", "K2", "K2_f64", "K3", "K4" or "vjp") at this geometry, as the CUDA occupancy calculator reckons it from
    the build's registers and ``geo``'s shared memory (card only)."""
    fn = _WARP_KERNELS[kernel][2]
    return getattr(_library(kernel_source(kernel, num_qubits)), fn)(
        num_qubits, geo.threads, geo.smem_bytes)


def _launch_fused(kernel: str, circuit: Circuit, angles: torch.Tensor,
                  out: torch.Tensor, states_layout: bool) -> None:
    """One launch of K3 or K4 on (B, G) float32 CUDA angles, counted."""
    n = circuit.num_qubits
    program = fuse_circuit(circuit)
    ops, gates, members, cperm = _fused_device_tables(circuit, angles.device, states_layout)
    geo = fused_geometry(circuit)
    n_members = members.shape[0] // (2 if n > ONE_WARP_QUBITS else 1)  # then codes
    _launch_counted(kernel, kernel_source(kernel, n), _WARP_KERNELS[kernel][1],
                    angles.device, angles.data_ptr(), cperm.data_ptr(), ops.data_ptr(),
                    gates.data_ptr(), members.data_ptr(), out.data_ptr(), angles.shape[0], n,
                    circuit.num_gates, len(program.ops), gates.shape[0], n_members,
                    program.n_su2, cperm.shape[0], geo.threads, geo.smem_bytes)


# ---------------------------------------------------------------------------
# K4: states through the fused program
# ---------------------------------------------------------------------------


def states_fused_reference(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """K4's plain PyTorch version: the fused program in complex64."""
    return state_from_angles_fused(circuit, angles, torch.complex64)


def states_from_angles_fused(circuit: Circuit, angles: torch.Tensor) -> torch.Tensor:
    """angles (B, G) float32 -> states (B, 2^n) complex64 via the fused
    program. The kernel builds each SU2 op's 2x2 from the angles itself, as
    the JAX package's Pallas wrapper builds its packed rows from them."""
    if not _is_cuda(angles):
        return states_fused_reference(circuit, angles)
    _check_angles(circuit, angles, "K4", dtypes=(torch.float32,))
    out = torch.empty((angles.shape[0], circuit.dim), dtype=torch.complex64,
                      device=angles.device)
    if angles.shape[0] == 0:
        return out
    _launch_fused("K4", circuit, angles, out, states_layout=True)
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
    program. The kernel builds each SU2 op's 2x2 from the angles itself,
    as the JAX package's Pallas wrapper builds its packed rows from them."""
    if not _is_cuda(angles):
        return pauli_features_fused_reference(circuit, angles)
    _check_angles(circuit, angles, "K3", dtypes=(torch.float32,))
    out = torch.empty((angles.shape[0], 3 * circuit.num_qubits), dtype=torch.float32,
                      device=angles.device)
    if angles.shape[0] == 0:
        return out
    _launch_fused("K3", circuit, angles, out, states_layout=False)
    return out


# ---------------------------------------------------------------------------
# The backward of K1 and K2
# ---------------------------------------------------------------------------

VJP_OUTPUTS = ("features", "states")


def vjp_min_blocks(num_qubits: int) -> int:
    """Resident blocks an SM that the adjoint's instantiation for
    ``num_qubits`` asks of the compiler (csrc/circuit_vjp.cu's
    VjpMinBlocks): two where a lane's two states are at most 64 registers,
    one above."""
    return 2 if num_qubits <= 4 else 1


@functools.lru_cache(maxsize=128)
def vjp_geometry(circuit: Circuit, blocks_per_sm: int = 0, threads: int = 0) -> WarpGeometry:
    """The adjoint's launch geometry for ``circuit`` (csrc/circuit_vjp.cu):
    K1's table and staged rows (the rows take the gradient in place of the
    angles) and, where a sample spans lanes (n > 5), every lane's partial
    gradients (32 x (G | 1) words a warp), sized for the blocks an SM the
    instantiation asks for; up to 5 qubits, where a lane holds a sample,
    128-thread blocks, as K1's. ``blocks_per_sm`` and ``threads`` (0: these
    defaults) size a variant's launch."""
    n, G = circuit.num_qubits, circuit.num_gates
    return _warp_geometry(n, 3 * G, 0, G, "the adjoint's gate table, rows and partials",
                          blocks_per_sm or vjp_min_blocks(n),
                          threads or (_WARP_THREADS // 2 if n <= 5 else _WARP_THREADS),
                          32 * (G | 1) if n > 5 else 0)


def circuit_vjp_reference(circuit: Circuit, angles: torch.Tensor, cotangent: torch.Tensor,
                          output: str) -> torch.Tensor:
    """The adjoint kernel's plain PyTorch version: ``torch.autograd`` through
    K1's (``output="features"``) or K2's (``"states"``) plain version."""
    fn = pauli_features_reference if output == "features" else states_reference
    with torch.enable_grad():
        a = angles.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(fn(circuit, a), a, cotangent)
    return grad


def circuit_vjp(circuit: Circuit, angles: torch.Tensor, cotangent: torch.Tensor,
                output: str) -> torch.Tensor:
    """d<cotangent, f(angles)>/d angles (B, G), f the Pauli features (K1,
    cotangent (B, 3n) real) or the states (K2, cotangent (B, 2^n) complex,
    torch's convention for the gradient of a real loss), float32."""
    if output not in VJP_OUTPUTS:
        raise ValueError(f"output must be one of {VJP_OUTPUTS}, got {output!r}")
    if not _is_cuda(angles):
        return circuit_vjp_reference(circuit, angles, cotangent, output)
    _check_angles(circuit, angles, "vjp", dtypes=(torch.float32,))
    n = circuit.num_qubits
    B, G = angles.shape
    want = (B, 3 * n) if output == "features" else (B, circuit.dim)
    dtype = torch.float32 if output == "features" else torch.complex64
    if tuple(cotangent.shape) != want or cotangent.dtype != dtype:
        raise ValueError(f"the {output} cotangent must be {want} {dtype}, got "
                         f"{tuple(cotangent.shape)} {cotangent.dtype}")
    grad = torch.empty_like(angles)
    if B == 0:
        return grad
    cot = cotangent.contiguous()
    states = output == "states"
    if states:
        cot = torch.view_as_real(cot)
    geo = vjp_geometry(circuit)
    _launch_counted("K2_vjp" if states else "K1_vjp", VJP_SOURCE, "dqgp_circuit_vjp",
                    angles.device, angles.data_ptr(),
                    _gate_table(circuit, angles.device, states).data_ptr(), cot.data_ptr(),
                    grad.data_ptr(), B, G, n, int(states), geo.threads, geo.smem_bytes)
    return grad


class CircuitFunction(torch.autograd.Function):
    """``forward(circuit, angles)`` (a K1-K4 wrapper) made differentiable:
    its backward is ``circuit_vjp`` of its ``output`` ("features" for K1 and
    K3, "states" for K2 and K4: the fused programs compute the same
    functions)."""

    @staticmethod
    def forward(ctx, angles, circuit, forward, output):
        ctx.circuit, ctx.output = circuit, output
        ctx.save_for_backward(angles)
        return forward(circuit, angles)

    @staticmethod
    def backward(ctx, cotangent):
        (angles,) = ctx.saved_tensors
        return circuit_vjp(ctx.circuit, angles, cotangent, ctx.output), None, None, None


pauli_features_from_angles.launches = 0
pauli_features_from_angles.launches_f64 = 0
states_from_angles.launches = 0
states_from_angles.launches_f64 = 0
states_from_angles_fused.launches = 0
pauli_features_from_angles_fused.launches = 0
circuit_vjp.launches_features = 0
circuit_vjp.launches_states = 0

_COUNTERS = {
    "K1": (pauli_features_from_angles, "launches"),
    "K1_f64": (pauli_features_from_angles, "launches_f64"),
    "K2": (states_from_angles, "launches"),
    "K2_f64": (states_from_angles, "launches_f64"),
    "K3": (pauli_features_from_angles_fused, "launches"),
    "K4": (states_from_angles_fused, "launches"),
    "K1_vjp": (circuit_vjp, "launches_features"),
    "K2_vjp": (circuit_vjp, "launches_states"),
    # the batched eigenvalue kernel (cuda_eig): launches, the Grams it took,
    # and the Grams the card sent to eigvalsh instead (above its limit)
    "eig": (cuda_eig.gram_extremes, "launches"),
    "eig_grams": (cuda_eig.gram_extremes, "grams"),
    "eig_eigvalsh_grams": (cuda_eig.gram_extremes, "eigvalsh_grams"),
    # the streamed gradient's contraction kernel (cuda_pair): a call a
    # parameter, counted once although a call is two launches (the tiles,
    # then the agents' sums)
    "pair_contract": (cuda_pair.shift_pair_contract, "launches"),
}


# the launches of the 11- and 12-qubit instantiations, by the keys of WIDE_SOURCES
_wide_launches = dict.fromkeys(WIDE_SOURCES, 0)


def launch_counts() -> dict:
    """Every wrapper's launch count, by kernel and precision, the batched
    eigenvalue kernel's Gram counts, and the streamed gradient's
    contraction calls (``pair_contract`` counts calls, not launches: a
    call is two)."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _COUNTERS.items()}


def wide_launch_counts() -> dict:
    """Of ``launch_counts()``, the launches that took an 11- or 12-qubit
    instantiation (``WIDE_SOURCES``), by the same keys."""
    return dict(_wide_launches)


def reset_launch_counts() -> None:
    """Zero ``launch_counts()`` and ``wide_launch_counts()``."""
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
    for k in _wide_launches:
        _wide_launches[k] = 0
