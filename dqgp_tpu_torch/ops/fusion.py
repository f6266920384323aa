"""Gate fusion for the circuit engine: port of ``dqgp_tpu/ops/fusion.py``.

Two algebraic fusions cut the number of passes over the state:

1. **SU(2) fusion** — maximal runs of uncontrolled single-qubit gates on one
   qubit are pre-multiplied into one 2x2 unitary per sample, computed outside
   the kernel on (B,)-sized tensors and handed to it as 8 packed float rows
   per fused op. Controlled rotations ride the same path as single-gate SU(2)
   ops with a control.
2. **Diagonal-run fusion** — RZ, CRZ, CZ and RZZ commute; a maximal run of
   them collapses into one phase op ``state[i] *= exp(i * phi[i])`` with
   ``phi = C @ a_rows``, C a static (2^n, K) pattern matrix.

Both are pure reorderings and compositions of unitaries, so the fused program
equals the original gate sequence. The program itself (``fuse_circuit`` and
its op records) is plain numpy and Python, copied from the JAX package so
both build the same op list; ``su2_products``, ``packed_inputs`` and
``state_from_angles_fused`` are the torch versions. ``state_from_angles_fused``
is the plain version of the fused-program states kernel K4
(``ops/cuda_circuit.states_from_angles_fused``); ``packed_inputs`` builds the
kernel's input outside it, as the JAX package does outside its Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from .circuit import CRX, CRY, CRZ, CX, CZ, H, RX, RY, RZ, RZZ, Circuit
from .statevector import _merge, _real_dtype, _split

# Single-qubit (uncontrolled) gate kinds eligible for SU(2) runs.
_SU2_KINDS = (RX, RY, RZ, H)
# Gate kinds whose 2x2 matrix is real (products of these stay real).
_REAL_KINDS = (RY, H)

_SQRT1_2 = 0.7071067811865476


@dataclasses.dataclass(frozen=True)
class SU2Op:
    """A fused 2x2 unitary on one qubit (optionally controlled).

    ``gate_idxs`` are indices into ``circuit.gates`` in application order;
    ``slot`` is this op's index into the packed 8-row coefficient block.
    ``real``/``diag`` are static structure flags used to skip dead terms.
    """

    qubit: int
    gate_idxs: Tuple[int, ...]
    slot: int
    control: int = -1
    real: bool = False
    diag: bool = False


@dataclasses.dataclass(frozen=True)
class PermOp:
    """A CX gate: static basis-state permutation."""

    qubit: int
    control: int


@dataclasses.dataclass(frozen=True)
class DiagOp:
    """A fused run of diagonal gates.

    ``members`` holds (kind, qubit, control, gate_idx) per member; CZ members
    carry gate_idx == -1 (their 'angle' is the constant pi). ``row_start`` is
    the first packed row of this op's K angle rows.
    """

    members: Tuple[Tuple[int, int, int, int], ...]
    row_start: int

    @property
    def K(self) -> int:
        return len(self.members)


@dataclasses.dataclass(frozen=True)
class FusedProgram:
    """The fused op sequence plus the packed-input row layout."""

    circuit: Circuit
    ops: Tuple
    n_su2: int
    n_rows: int  # total packed rows: 8 * n_su2 + sum of DiagOp K

    @property
    def num_state_sweeps(self) -> int:
        """Ops that touch the full state once (diag ops count 2 for the
        cos/sin and complex-multiply sweeps)."""
        return sum(2 if isinstance(op, DiagOp) else 1 for op in self.ops)


def _qubits_of(op) -> frozenset:
    if isinstance(op, SU2Op):
        s = {op.qubit}
        if op.control >= 0:
            s.add(op.control)
        return frozenset(s)
    if isinstance(op, PermOp):
        return frozenset((op.qubit, op.control))
    raise TypeError(op)


class _DiagSeed:
    """Pass-1 marker for CZ / RZZ (fused into DiagOps in pass 2)."""

    def __init__(self, kind, qubit, control, gate_idx):
        self.kind, self.qubit, self.control, self.gate_idx = (
            kind, qubit, control, gate_idx)


@functools.lru_cache(maxsize=256)
def fuse_circuit(circuit: Circuit) -> FusedProgram:
    """Run both fusion passes over a circuit's gate list."""
    # ---- pass 1: per-qubit SU(2) runs -------------------------------------
    pending: dict = {}  # qubit -> list of gate indices
    seq1: List = []

    def flush(q):
        idxs = pending.pop(q, None)
        if idxs:
            kinds = [circuit.gates[i].kind for i in idxs]
            seq1.append(SU2Op(
                qubit=q, gate_idxs=tuple(idxs), slot=-1,
                real=all(k in _REAL_KINDS for k in kinds),
                diag=all(k == RZ for k in kinds),
            ))

    for gi, g in enumerate(circuit.gates):
        if g.kind in _SU2_KINDS and g.control < 0:
            pending.setdefault(g.qubit, []).append(gi)
            continue
        flush(g.qubit)
        if g.control >= 0:
            flush(g.control)
        if g.kind == CX:
            seq1.append(PermOp(qubit=g.qubit, control=g.control))
        elif g.kind in (CZ, RZZ):
            seq1.append(_DiagSeed(g.kind, g.qubit, g.control,
                                  -1 if g.kind == CZ else gi))
        elif g.kind in (CRX, CRY, CRZ):
            seq1.append(SU2Op(
                qubit=g.qubit, gate_idxs=(gi,), slot=-1,
                control=g.control, real=(g.kind == CRY),
                diag=(g.kind == CRZ),
            ))
        else:  # pragma: no cover - kinds are exhaustive
            raise ValueError(f"unhandled gate kind {g.kind}")
    for q in sorted(pending):
        flush(q)

    # ---- pass 2: commuting diagonal runs ----------------------------------
    # A diagonal op joins the pending run; a non-diagonal op may be emitted
    # BEFORE the pending run iff it is disjoint from every run member (gates
    # on disjoint qubits commute).
    seq2: List = []
    pend_members: List[Tuple[int, int, int, int]] = []
    pend_sources: List = []
    pend_qubits: set = set()

    def flush_diag():
        nonlocal pend_members, pend_sources, pend_qubits
        if pend_members:
            if len(pend_sources) == 1 and isinstance(pend_sources[0], SU2Op):
                # A lone RZ run / CRZ costs one cheap sweep as a diagonal
                # SU(2); a K=1 DiagOp would cost ~2 sweeps.
                seq2.append(pend_sources[0])
            else:
                seq2.append(DiagOp(members=tuple(pend_members), row_start=-1))
        pend_members, pend_sources, pend_qubits = [], [], set()

    def diag_members(op):
        if isinstance(op, _DiagSeed):
            return [(op.kind, op.qubit, op.control, op.gate_idx)]
        # SU2Op that is purely diagonal: RZ run or a single CRZ
        return [(circuit.gates[gi].kind, circuit.gates[gi].qubit,
                 circuit.gates[gi].control, gi) for gi in op.gate_idxs]

    for op in seq1:
        is_diag = isinstance(op, _DiagSeed) or (
            isinstance(op, SU2Op) and op.diag)
        if is_diag:
            pend_sources.append(op)
            for m in diag_members(op):
                pend_members.append(m)
                pend_qubits.add(m[1])
                if m[2] >= 0:
                    pend_qubits.add(m[2])
        else:
            if pend_members and (_qubits_of(op) & pend_qubits):
                flush_diag()
            seq2.append(op)
    flush_diag()

    # ---- assign slots / packed rows (diag rows follow the 8*n_su2 block) --
    n_su2 = sum(isinstance(op, SU2Op) for op in seq2)
    ops: List = []
    slot = 0
    row = 8 * n_su2
    for op in seq2:
        if isinstance(op, SU2Op):
            ops.append(dataclasses.replace(op, slot=slot))
            slot += 1
        elif isinstance(op, DiagOp):
            ops.append(dataclasses.replace(op, row_start=row))
            row += op.K
        else:
            ops.append(op)
    return FusedProgram(circuit=circuit, ops=tuple(ops), n_su2=n_su2, n_rows=row)


def diag_pattern(op: DiagOp, num_qubits: int) -> np.ndarray:
    """Static (2^n, K) phase-pattern matrix C: phi = C @ member_angles.

    Column conventions (state[i] *= exp(i * phi[i])):
      RZ(q):     bit_q - 1/2
      CRZ(c,t):  bit_c * (bit_t - 1/2)
      CZ(c,t):   bit_c * bit_t            (angle row is the constant pi)
      RZZ(c,t):  (bit_c XOR bit_t) - 1/2
    """
    idx = np.arange(1 << num_qubits)
    C = np.zeros((1 << num_qubits, op.K), np.float64)
    for k, (kind, q, c, _) in enumerate(op.members):
        bq = (idx >> q) & 1
        bc = (idx >> c) & 1 if c >= 0 else None
        if kind == RZ:
            C[:, k] = bq - 0.5
        elif kind == CRZ:
            C[:, k] = bc * (bq - 0.5)
        elif kind == CZ:
            C[:, k] = bc * bq
        elif kind == RZZ:
            C[:, k] = (bq ^ bc) - 0.5
        else:  # pragma: no cover
            raise ValueError(f"non-diagonal kind {kind} in DiagOp")
    return C


def diag_patterns_concat(program: FusedProgram) -> np.ndarray:
    """All DiagOps' pattern matrices side by side: (2^n, K_total) float32.

    Column block for an op starts at ``op.row_start - 8 * n_su2``. Returns a
    (2^n, 1) zero matrix when the program has no DiagOp, so a kernel can
    take a fixed input."""
    dim = program.circuit.dim
    blocks = [diag_pattern(op, program.circuit.num_qubits)
              for op in program.ops if isinstance(op, DiagOp)]
    if not blocks:
        return np.zeros((dim, 1), np.float32)
    return np.concatenate(blocks, axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# torch parts: the kernel's packed input and the plain fused engine
# ---------------------------------------------------------------------------


def _gate_matrix_entries(kind, c, s):
    """2x2 entries (complex) of a gate from cos/sin of half its angle."""
    zero = torch.zeros_like(c)
    if kind in (RX, CRX):
        ims = torch.complex(zero, -s)
        return torch.complex(c, zero), ims, ims, torch.complex(c, zero)
    if kind in (RY, CRY):
        return (torch.complex(c, zero), torch.complex(-s, zero),
                torch.complex(s, zero), torch.complex(c, zero))
    if kind in (RZ, CRZ):
        z = torch.complex(zero, zero)
        return torch.complex(c, -s), z, z, torch.complex(c, s)
    if kind == H:
        r = torch.complex(torch.full_like(c, _SQRT1_2), zero)
        return r, r, r, -r
    raise ValueError(f"kind {kind} has no SU(2) matrix")


def su2_products(program: FusedProgram, angles: torch.Tensor):
    """Per-sample fused 2x2 unitaries for every SU2Op.

    angles: (B, G) real. Returns (u00, u01, u10, u11), each (B, n_su2)
    complex (complex128 iff angles are float64)."""
    circ = program.circuit
    B = angles.shape[0]
    cdtype = torch.complex128 if angles.dtype == torch.float64 else torch.complex64
    one = torch.ones((B,), dtype=cdtype, device=angles.device)
    zero = torch.zeros((B,), dtype=cdtype, device=angles.device)
    cols = ([], [], [], [])
    for op in program.ops:
        if not isinstance(op, SU2Op):
            continue
        u00, u01, u10, u11 = one, zero, zero, one
        for gi in op.gate_idxs:
            half = 0.5 * angles[:, gi]
            g00, g01, g10, g11 = _gate_matrix_entries(
                circ.gates[gi].kind, torch.cos(half), torch.sin(half))
            u00, u01, u10, u11 = (
                g00 * u00 + g01 * u10,
                g00 * u01 + g01 * u11,
                g10 * u00 + g11 * u10,
                g10 * u01 + g11 * u11,
            )
        for col, u in zip(cols, (u00, u01, u10, u11)):
            col.append(u)
    if not cols[0]:
        e = torch.zeros((B, 0), dtype=cdtype, device=angles.device)
        return e, e, e, e
    return tuple(torch.stack(col, dim=1) for col in cols)


def _diag_rows(op: DiagOp, angles: torch.Tensor, dtype) -> torch.Tensor:
    """(B, K) member angles of a DiagOp; CZ members are the constant pi."""
    B = angles.shape[0]
    rows = [torch.full((B,), np.pi, dtype=dtype, device=angles.device) if gi < 0
            else angles[:, gi].to(dtype) for _, _, _, gi in op.members]
    return torch.stack(rows, dim=1)


def packed_inputs(program: FusedProgram, angles: torch.Tensor) -> torch.Tensor:
    """The (B, n_rows) float32 matrix the fused kernel consumes.

    Row layout: SU2 slot s owns rows [8s, 8s+8) in the order
    (u00re, u00im, u01re, u01im, u10re, u10im, u11re, u11im); DiagOp angle
    rows follow, contiguous per op (CZ members contribute a constant-pi row).
    """
    B = angles.shape[0]
    u00, u01, u10, u11 = su2_products(program, angles)
    blocks = []
    if program.n_su2:
        su2 = torch.stack([
            u00.real, u00.imag, u01.real, u01.imag,
            u10.real, u10.imag, u11.real, u11.imag,
        ], dim=2)  # (B, n_su2, 8)
        blocks.append(su2.reshape(B, 8 * program.n_su2))
    for op in program.ops:
        if isinstance(op, DiagOp):
            blocks.append(_diag_rows(op, angles, angles.dtype))
    if not blocks:
        return torch.zeros((B, 0), dtype=torch.float32, device=angles.device)
    return torch.cat(blocks, dim=1).to(torch.float32)


def state_from_angles_fused(circuit: Circuit, angles: torch.Tensor,
                            dtype=None) -> torch.Tensor:
    """Run the FUSED program on |0..0> with plain torch ops: (B, 2^n).

    ``dtype`` defaults to complex128 for float64 angles, else complex64."""
    program = fuse_circuit(circuit)
    n = circuit.num_qubits
    dev = angles.device
    if dtype is None:
        dtype = torch.complex128 if angles.dtype == torch.float64 else torch.complex64
    rdtype = _real_dtype(dtype)
    B = angles.shape[0]
    state = torch.zeros((B, circuit.dim), dtype=dtype, device=dev)
    state[:, 0] = 1.0
    us = [u.to(dtype) for u in su2_products(program, angles.to(rdtype))]
    idx = torch.arange(1 << n, device=dev)

    for op in program.ops:
        if isinstance(op, SU2Op):
            a, b, c, d = (u[:, op.slot, None, None] for u in us)
            s0, s1 = _split(state, op.qubit, n)
            new = _merge(a * s0 + b * s1, c * s0 + d * s1, n)
            if op.control >= 0:
                new = torch.where(((idx >> op.control) & 1).bool(), new, state)
            state = new
        elif isinstance(op, PermOp):
            perm = torch.where(((idx >> op.control) & 1).bool(),
                               idx ^ (1 << op.qubit), idx)
            state = state[:, perm]
        else:  # DiagOp
            C = torch.as_tensor(diag_pattern(op, n), dtype=rdtype, device=dev)
            phi = _diag_rows(op, angles, rdtype) @ C.T       # (B, dim)
            state = state * torch.complex(torch.cos(phi), torch.sin(phi))
    return state
