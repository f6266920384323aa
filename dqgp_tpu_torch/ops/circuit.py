"""Circuit IR: parameterized encoding circuits as static gate lists.

A numpy-only copy of ``dqgp_tpu/ops/circuit.py`` (the JAX package cannot be
imported without importing jax). A circuit is plain data — a tuple of
``Gate`` records — that the statevector engine and the CUDA Pauli-feature
kernel both consume to prepare ALL sample states in one batched pass. The
coefficient arrays of ``static_arrays`` stay float32 exactly as in the JAX
package: its float64 pipeline consumes these f32-rounded constants too.

Angle model
-----------
Every rotation gate's angle is an affine-bilinear function of the trainable
parameter vector ``theta`` (the torus variables the ADMM consensus optimizes)
and one encoded input feature:

    angle = const + pc * theta[pidx] + (fc + pf * theta[pidx]) * enc(x[fidx])

with ``enc`` one of {identity, arccos}. This covers every circuit family the
reference exposes (additive feature maps like YZ-CX, multiplicative Chebyshev
towers ``theta * arccos(x)``, plain trainable rotations, plain feature
rotations) with one uniform, vectorizable representation: the (N, G) angle
matrix is computed in one shot, then the gate sequence is applied to the whole
batch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Gate kinds (static ints so the IR can also be consumed by the C++ oracle).
RX, RY, RZ, H, CX, CZ, CRX, CRY, CRZ, RZZ = range(10)

KIND_NAMES = {
    RX: "rx", RY: "ry", RZ: "rz", H: "h", CX: "cx",
    CZ: "cz", CRX: "crx", CRY: "cry", CRZ: "crz", RZZ: "rzz",
}
PARAMETERIZED = {RX, RY, RZ, CRX, CRY, CRZ, RZZ}

# Feature encodings.
ENC_NONE, ENC_ID, ENC_ARCCOS = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Gate:
    """One gate. ``qubit`` is the target; ``control`` is -1 for 1q gates.

    Qubit 0 is the least-significant bit of the state index (a state index i
    has qubit q in basis state ``(i >> q) & 1``).
    """

    kind: int
    qubit: int
    control: int = -1
    const: float = 0.0
    pidx: int = -1          # trainable parameter index (or -1)
    pc: float = 0.0         # coefficient on theta[pidx]
    fidx: int = -1          # feature index (or -1)
    fc: float = 0.0         # coefficient on enc(x[fidx])
    pf: float = 0.0         # coefficient on theta[pidx] * enc(x[fidx])
    enc: int = ENC_NONE

    def __post_init__(self):
        if self.kind in (CX, CZ, CRX, CRY, CRZ, RZZ) and self.control < 0:
            raise ValueError(f"{KIND_NAMES[self.kind]} requires a control qubit")
        if self.control == self.qubit and self.control >= 0:
            raise ValueError("control == target")


@dataclasses.dataclass(frozen=True)
class Circuit:
    """A static, hashable encoding circuit (usable as a cache key)."""

    num_qubits: int
    num_features: int
    num_parameters: int
    gates: Tuple[Gate, ...]
    name: str = "circuit"
    requires_clipping: bool = False  # True iff any gate uses arccos(x)

    def __post_init__(self):
        for g in self.gates:
            if g.qubit >= self.num_qubits or g.control >= self.num_qubits:
                raise ValueError(f"gate {g} out of range for {self.num_qubits} qubits")
            if g.pidx >= self.num_parameters:
                raise ValueError(f"gate {g} references parameter {g.pidx} >= {self.num_parameters}")
            if g.fidx >= self.num_features:
                raise ValueError(f"gate {g} references feature {g.fidx} >= {self.num_features}")

    def __hash__(self) -> int:
        """The fields' hash, computed once: a circuit keys the caches of
        every kernel wrapper (tables, geometry), and hashing its gate list
        anew on each launch costs more host time than a small launch takes
        on the device."""
        try:
            return self._hash
        except AttributeError:
            h = hash((self.num_qubits, self.num_features, self.num_parameters,
                      self.gates, self.name, self.requires_clipping))
            object.__setattr__(self, "_hash", h)
            return h

    def __getstate__(self):
        """Without the cached hash: string hashes differ between processes."""
        state = dict(self.__dict__)
        state.pop("_hash", None)
        return state

    @property
    def dim(self) -> int:
        return 1 << self.num_qubits

    @property
    def num_gates(self) -> int:
        return len(self.gates)

    def static_arrays(self):
        """Pack the angle-model coefficients into numpy arrays."""
        G = len(self.gates)
        arr = {
            "kind": np.array([g.kind for g in self.gates], np.int32),
            "qubit": np.array([g.qubit for g in self.gates], np.int32),
            "control": np.array([g.control for g in self.gates], np.int32),
            "const": np.array([g.const for g in self.gates], np.float32),
            "pidx": np.array([max(g.pidx, 0) for g in self.gates], np.int32),
            "has_p": np.array([g.pidx >= 0 for g in self.gates], np.float32),
            "pc": np.array([g.pc for g in self.gates], np.float32),
            "fidx": np.array([max(g.fidx, 0) for g in self.gates], np.int32),
            "has_f": np.array([g.fidx >= 0 for g in self.gates], np.float32),
            "fc": np.array([g.fc for g in self.gates], np.float32),
            "pf": np.array([g.pf for g in self.gates], np.float32),
            "enc": np.array([g.enc for g in self.gates], np.int32),
        }
        assert all(v.shape == (G,) for v in arr.values())
        return arr
