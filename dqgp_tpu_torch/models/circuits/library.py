"""Encoding-circuit library: the 8 families the reference exposes.

A numpy-only copy of ``dqgp_tpu/models/circuits/library.py``; the tests hold
every family's gate list and coefficient arrays equal to the JAX package's.

The reference instantiates squlearn 0.9.1 circuit classes
(main.py:68-106, agent_riemannian.py:51-85): chebyshev (ChebyshevPQC), yz_cx
(YZ_CX_EncodingCircuit), hubregtsen (HubregtsenEncodingCircuit), kyriienko
(KyriienkoEncodingCircuit), multi_control (MultiControlEncodingCircuit),
layered (LayeredEncodingCircuit with gates=['RX','RY','RZ']), random
(RandomEncodingCircuit), highdim (HighDimEncodingCircuit). All are
``(num_qubits, num_features, num_layers)``-parameterized layered
rotation+entangler circuits whose trainable parameters are rotation angles
(treated as period-pi torus coordinates by the optimizer,
riemannian_optimizer.py:61-71).

squlearn itself is unavailable in this offline environment, so the exact gate
sequences below are re-derived from the circuits' published descriptions
(Haug/Self/Kim arXiv:2108.01039 for YZ-CX; Hubregtsen et al. arXiv:2105.02276;
Kyriienko et al. arXiv:2011.10395 Chebyshev towers; squlearn documentation for
ChebyshevPQC / MultiControl / Layered / Random / HighDim). Structural
invariants preserved from observed reference behavior:

* chebyshev is the only family that requires input clipping to [-0.99, 0.99]
  (it feeds arccos(x); main.py:224-236), and its trainable parameters multiply
  the arccos feature (Chebyshev tower scaling).
* hubregtsen with (3 qubits, 1 layer) has exactly 6 trainable parameters —
  pinned by the reference's own example ``--kernel-params 0.576 2.450 1.875
  1.401 0.314 1.443`` (main.py:2020-2021) for BASELINE config #1.
* every family's parameter count is a deterministic function of
  (num_qubits, num_features, num_layers); ground-truth parameters are drawn
  U(0, pi) (main.py:211).

Exact gate-for-gate squlearn parity is flagged as a fixture-verification task
(SURVEY.md §7 "hard parts"); the IR makes swapping definitions trivial.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from ...ops.circuit import (
    CRX, CRY, CRZ, CX, CZ, ENC_ARCCOS, ENC_ID, H, RX, RY, RZ,
    Circuit, Gate,
)

ENCODING_TYPES = (
    "chebyshev", "yz_cx", "hubregtsen", "kyriienko",
    "multi_control", "layered", "random", "highdim",
)


def _ring(n: int) -> List[tuple]:
    """Nearest-neighbour entangling pairs, closed ring for n > 2."""
    if n < 2:
        return []
    if n == 2:
        return [(0, 1)]
    return [(i, (i + 1) % n) for i in range(n)]


def _chain(n: int) -> List[tuple]:
    return [(i, i + 1) for i in range(n - 1)]


@functools.lru_cache(maxsize=256)
def build_circuit(
    encoding_type: str,
    num_qubits: int,
    num_features: int = 1,
    num_layers: int = 2,
    seed: int = 0,
) -> Circuit:
    """Build one of the 8 encoding circuits as a static ``Circuit`` IR.

    Mirrors ``create_quantum_kernel``'s circuit dispatch (main.py:67-106).
    The same arguments give the same (immutable) object: the kernel wrappers
    key their cached tables by the circuit, and telling two equal circuits
    apart gate by gate costs more host time than a small launch takes on the
    device.
    """
    if encoding_type not in ENCODING_TYPES:
        raise ValueError(
            f"Unknown encoding type: {encoding_type}. Supported: {ENCODING_TYPES}"
        )
    builder = _BUILDERS[encoding_type]
    return builder(num_qubits, num_features, num_layers, seed)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _chebyshev(n: int, d: int, layers: int, seed: int) -> Circuit:
    """ChebyshevPQC: initial Ry(p) block; per layer a Chebyshev-tower encoding
    block Rx(p * arccos(x)), a CRZ(p) nearest-neighbour ring, and an Ry(p)
    rotation block. Trainable params scale the arccos features (the Chebyshev
    degree), so inputs must live in [-0.99, 0.99] (main.py:224-236)."""
    gates: List[Gate] = []
    p = 0
    for q in range(n):
        gates.append(Gate(RY, q, pidx=p, pc=1.0)); p += 1
    f = 0
    for _ in range(layers):
        for q in range(n):
            gates.append(Gate(RX, q, pidx=p, fidx=f % d, pf=1.0, enc=ENC_ARCCOS))
            p += 1; f += 1
        for (c, t) in _ring(n):
            gates.append(Gate(CRZ, t, control=c, pidx=p, pc=1.0)); p += 1
        for q in range(n):
            gates.append(Gate(RY, q, pidx=p, pc=1.0)); p += 1
    return Circuit(n, d, p, tuple(gates), name="chebyshev", requires_clipping=True)


def _yz_cx(n: int, d: int, layers: int, seed: int, c: float = 1.0) -> Circuit:
    """YZ-CX (arXiv:2108.01039): per layer Ry(p + c*x) Rz(p + c*x) on every
    qubit followed by a CX chain. P = 2 * n * layers."""
    gates: List[Gate] = []
    p = 0
    f = 0
    for _ in range(layers):
        for q in range(n):
            gates.append(Gate(RY, q, pidx=p, pc=1.0, fidx=f % d, fc=c, enc=ENC_ID))
            p += 1
            gates.append(Gate(RZ, q, pidx=p, pc=1.0, fidx=f % d, fc=c, enc=ENC_ID))
            p += 1; f += 1
        for (cq, t) in _chain(n):
            gates.append(Gate(CX, t, control=cq))
    return Circuit(n, d, p, tuple(gates), name="yz_cx")


def _hubregtsen(n: int, d: int, layers: int, seed: int) -> Circuit:
    """Hubregtsen QEK ansatz (arXiv:2105.02276): per layer H + Rz(x) feature
    encoding, trainable Ry(p) rotations, and a CRZ(p) ring.
    P = layers * (n + #ring) = 2*n*layers for n > 2; = 6 for (3 qubits,
    1 layer) — matches the reference's 6-value --kernel-params example."""
    gates: List[Gate] = []
    p = 0
    f = 0
    for _ in range(layers):
        for q in range(n):
            gates.append(Gate(H, q))
            gates.append(Gate(RZ, q, fidx=f % d, fc=1.0, enc=ENC_ID))
            f += 1
        for q in range(n):
            gates.append(Gate(RY, q, pidx=p, pc=1.0)); p += 1
        for (cq, t) in _ring(n):
            gates.append(Gate(CRZ, t, control=cq, pidx=p, pc=1.0)); p += 1
    return Circuit(n, d, p, tuple(gates), name="hubregtsen")


def _kyriienko(n: int, d: int, layers: int, seed: int) -> Circuit:
    """Kyriienko (arXiv:2011.10395): Chebyshev-tower feature map
    Ry(2*(q+1)*arccos(x)) followed by an HEA variational block
    (Ry(p) Rz(p) + CX chain) per layer. arccos is clipped internally, so no
    data clipping is required (the reference also treats kyriienko as
    clipping-free, main.py:80-83). P = 2 * n * layers."""
    gates: List[Gate] = []
    p = 0
    f = 0
    for _ in range(layers):
        for q in range(n):
            gates.append(Gate(RY, q, fidx=f % d, fc=2.0 * (q + 1), enc=ENC_ARCCOS))
            f += 1
        for q in range(n):
            gates.append(Gate(RY, q, pidx=p, pc=1.0)); p += 1
            gates.append(Gate(RZ, q, pidx=p, pc=1.0)); p += 1
        for (cq, t) in _chain(n):
            gates.append(Gate(CX, t, control=cq))
    return Circuit(n, d, p, tuple(gates), name="kyriienko")


def _multi_control(n: int, d: int, layers: int, seed: int) -> Circuit:
    """MultiControl: per layer H + Rz(x) encoding, then a trainable CRX(p)
    ring and Ry(p) rotations (complex entanglement patterns, main.py:84-87).
    P = layers * (#ring + n)."""
    gates: List[Gate] = []
    p = 0
    f = 0
    for _ in range(layers):
        for q in range(n):
            gates.append(Gate(H, q))
            gates.append(Gate(RZ, q, fidx=f % d, fc=1.0, enc=ENC_ID))
            f += 1
        for (cq, t) in _ring(n):
            gates.append(Gate(CRX, t, control=cq, pidx=p, pc=1.0)); p += 1
        for q in range(n):
            gates.append(Gate(RY, q, pidx=p, pc=1.0)); p += 1
    return Circuit(n, d, p, tuple(gates), name="multi_control")


def _layered(n: int, d: int, layers: int, seed: int) -> Circuit:
    """Layered with gates=['RX','RY','RZ'] (main.py:88-96): per layer one
    block per gate kind on every qubit — the RX block encodes (p + x), the RY
    and RZ blocks are purely trainable — then a CX chain.
    P = 3 * n * layers."""
    gates: List[Gate] = []
    p = 0
    f = 0
    for _ in range(layers):
        for kind in (RX, RY, RZ):
            for q in range(n):
                if kind == RX:
                    gates.append(
                        Gate(kind, q, pidx=p, pc=1.0, fidx=f % d, fc=1.0, enc=ENC_ID)
                    )
                    f += 1
                else:
                    gates.append(Gate(kind, q, pidx=p, pc=1.0))
                p += 1
        for (cq, t) in _chain(n):
            gates.append(Gate(CX, t, control=cq))
    return Circuit(n, d, p, tuple(gates), name="layered")


def _random(n: int, d: int, layers: int, seed: int) -> Circuit:
    """Random circuit, deterministic in (n, d, layers, seed) — mirrors
    squlearn's seeded RandomEncodingCircuit (default seed 0). Draws
    2*n*layers gate slots. Even slots are trainable feature-encoded
    rotations (guaranteeing every feature and at least n*layers parameters
    reach the state); odd slots draw a random extra gate, and the rotation /
    CRZ outcomes there allocate parameters too — so P is seed-dependent with
    n*layers <= P <= 2*n*layers, matching RandomEncodingCircuit's behavior of
    a draw-dependent parameter count."""
    rng = np.random.RandomState(seed)
    gates: List[Gate] = []
    p = 0
    f = 0
    rot_kinds = [RX, RY, RZ]
    # Even slots: trainable feature-encoded rotations on a random qubit — this
    # guarantees every feature and n*layers fresh parameters reach the state.
    # Odd slots: a random extra gate (rotation / H / entangler).
    for slot in range(2 * n * layers):
        q = int(rng.randint(0, n))
        if slot % 2 == 0:
            kind = rot_kinds[int(rng.randint(0, 3))]
            gates.append(Gate(kind, q, pidx=p, pc=1.0, fidx=f % d, fc=1.0, enc=ENC_ID))
            p += 1; f += 1
            continue
        roll = rng.rand()
        if roll < 0.4 or n == 1:
            kind = rot_kinds[int(rng.randint(0, 3))]
            gates.append(Gate(kind, q, pidx=p, pc=1.0)); p += 1
        elif roll < 0.6:
            gates.append(Gate(H, q))
        else:
            t = int(rng.randint(0, n - 1))
            t = t if t < q else t + 1
            two = [CX, CZ, CRZ][int(rng.randint(0, 3))]
            if two == CRZ:
                gates.append(Gate(CRZ, t, control=q, pidx=p, pc=1.0)); p += 1
            else:
                gates.append(Gate(two, t, control=q))
    return Circuit(n, d, p, tuple(gates), name="random")


def _highdim(n: int, d: int, layers: int, seed: int) -> Circuit:
    """HighDim: cycles many features across qubits and layers with alternating
    Ry/Rz rotations (p + x) plus a CX ring — built for d up to 6 and beyond
    (main.py:101-104). P = n * layers."""
    gates: List[Gate] = []
    p = 0
    f = 0
    for layer in range(layers):
        for q in range(n):
            kind = RY if (layer + q) % 2 == 0 else RZ
            gates.append(Gate(kind, q, pidx=p, pc=1.0, fidx=f % d, fc=1.0, enc=ENC_ID))
            p += 1; f += 1
        for (cq, t) in _ring(n):
            gates.append(Gate(CX, t, control=cq))
    return Circuit(n, d, p, tuple(gates), name="highdim")


_BUILDERS = {
    "chebyshev": _chebyshev,
    "yz_cx": _yz_cx,
    "hubregtsen": _hubregtsen,
    "kyriienko": _kyriienko,
    "multi_control": _multi_control,
    "layered": _layered,
    "random": _random,
    "highdim": _highdim,
}
