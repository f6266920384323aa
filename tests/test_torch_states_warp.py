"""The register-across-a-warp kernels (K1 float32, K2 float32, K4) as far as
the CPU reaches them: their launch geometry, the tables that carry the
qubit-to-bit map, the input guards, and a plain numpy model of the
lane/register split that applies every gate kind and every fused op through
the same case split as the device bodies of csrc/warp_state.cuh (a register
bit inside the lane, a lane bit with the partner at lane ^ m, a control as a
register mask or a lane predicate, CZ/RZZ across the two domains), writes
the state out as store_state does (K2, K4) and reduces it to the Pauli
features as reduce_features does (K1).

The model runs in complex128 and is held to the plain statevector engine at
1e-12 (the split is exact; the kernels' own float32 bars, 5e-6, 2e-6 and
3e-6, are held on the card by chip_smoke.py phases 3 and 6 and
tests/test_torch_cuda.py). tests/test_torch_pauli_features_warp.py holds
K1's model to the JAX package's XLA engine and its Pallas kernel as well.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu_torch.convert import circuit_from_jax
from dqgp_tpu_torch.ops import circuit as tc
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import fusion as tf
from dqgp_tpu_torch.ops import statevector as tsv

MODEL_ATOL = 1e-12
MODEL_QUBITS = (3, 5, 6, 7, 10)
K1_MODEL_QUBITS = (1, 3, 4, 5, 6, 8, 10)


def _circuit(enc, n, layers=2):
    return circuit_from_jax(build_circuit(enc, n, 2, layers))


def _every_kind_circuit(n, seed):
    """Every gate kind three times over, on seeded qubits: at n > 5 targets
    and controls fall on both sides of the register/lane split."""
    rng = np.random.RandomState(seed)
    gates = []
    for kind in list(range(10)) * 3:
        q = int(rng.randint(n))
        c = int((q + 1 + rng.randint(n - 1)) % n) if kind >= tc.CX else -1
        gates.append(tc.Gate(kind=kind, qubit=q, control=c))
    order = rng.permutation(len(gates))
    return tc.Circuit(num_qubits=n, num_features=1, num_parameters=1,
                      gates=tuple(gates[i] for i in order), name="every_kind")


def _random_angles(c, rows, seed):
    return np.random.RandomState(seed).uniform(-np.pi, 3 * np.pi, (rows, c.num_gates))


# ---------------------------------------------------------------------------
# The plain model: a state as [sample][lane][register]
# ---------------------------------------------------------------------------


class LaneRegisterState:
    """A batch of states held as the warp kernels hold one: physical bits
    0..4 of an amplitude's index pick the register, bits 5.. the lane."""

    def __init__(self, n, rows):
        self.n = n
        self.A = min(1 << n, 32)
        self.L = (1 << n) // self.A
        self.reg_bits = min(n, 5)
        self.s = np.zeros((rows, self.L, self.A), np.complex128)
        self.s[:, 0, 0] = 1.0
        self.lig = np.arange(self.L)
        self.reg = np.arange(self.A)

    def _control(self, ctl):
        """(rows of the [lane][register] grid the op acts on)."""
        if ctl < 0:
            return np.ones((self.L, self.A), bool)
        if ctl < 5:
            return np.broadcast_to((self.reg & (1 << ctl)) != 0, (self.L, self.A))
        return np.broadcast_to((((self.lig >> (ctl - 5)) & 1) != 0)[:, None], (self.L, self.A))

    def su2(self, u, q, ctl=-1):
        """u: (rows, 2, 2) complex; s0' = u00 s0 + u01 s1, s1' = u10 s0 + u11 s1."""
        ok = self._control(ctl)
        if q < self.reg_bits:  # both amplitudes of a pair in one lane
            new = self.s.copy()
            for p in range(self.A // 2):
                k0 = ((p >> q) << (q + 1)) | (p & ((1 << q) - 1))
                k1 = k0 | (1 << q)
                s0, s1 = self.s[:, :, k0], self.s[:, :, k1]
                on = ok[:, k0][None]  # the control never is the target bit
                new[:, :, k0] = np.where(on, u[:, 0, 0, None] * s0 + u[:, 0, 1, None] * s1, s0)
                new[:, :, k1] = np.where(on, u[:, 1, 0, None] * s0 + u[:, 1, 1, None] * s1, s1)
            self.s = new
        else:  # the partner amplitude lies in lane lig ^ m, same register
            m = 1 << (q - 5)
            partner = self.s[:, self.lig ^ m, :]
            hi = ((self.lig & m) != 0)[None, :, None]
            mine_c = np.where(hi, u[:, 1, 1, None, None], u[:, 0, 0, None, None])
            other_c = np.where(hi, u[:, 1, 0, None, None], u[:, 0, 1, None, None])
            self.s = np.where(ok[None], mine_c * self.s + other_c * partner, self.s)

    def perm(self, q, ctl):
        flip = np.array([[0, 1], [1, 0]], np.complex128)
        self.su2(np.broadcast_to(flip, (self.s.shape[0], 2, 2)), q, ctl)

    def _bit(self, q):
        if q < 5:
            return np.broadcast_to((self.reg & (1 << q)) != 0, (self.L, self.A))
        return np.broadcast_to((((self.lig >> (q - 5)) & 1) != 0)[:, None], (self.L, self.A))

    def diag2(self, q, ctl, cz, half):
        """CZ, or RZZ of half angle ``half`` (rows,), on bits q and ctl."""
        one_q, one_c = self._bit(q), self._bit(ctl)
        if cz:
            self.s = np.where((one_q & one_c)[None], -self.s, self.s)
        else:
            sign = np.where(one_q == one_c, -1.0, 1.0)[None]  # exp(-i a/2) where they agree
            self.s = self.s * np.exp(1j * sign * half[:, None, None])

    def diag_run(self, cperm, col, member_angles):
        """phi[l][r] = sum_j C[col + j][r][l] a_j; s *= exp(i phi)."""
        K_ = member_angles.shape[1]
        phi = np.einsum("jrl,bj->blr", cperm[col:col + K_].astype(np.float64), member_angles)
        self.s = self.s * np.exp(1j * phi)

    def stored(self):
        """The (rows, 2^n) output as store_state writes it under the states
        kernels' map: the lanes of a pair trade a register, the even lane
        then writes amplitudes l, l+1 of register r and the odd lane those
        of register r+1."""
        out = np.full((self.s.shape[0], 1 << self.n), np.nan, np.complex128)
        if self.L == 1:
            return self.s[:, 0, :].copy()
        for r in range(0, self.A, 2):
            for l in range(self.L):
                odd = l & 1
                # what the partner gives away
                given = self.s[:, l ^ 1, r + 1] if odd else self.s[:, l ^ 1, r]
                pair = (given, self.s[:, l, r + 1]) if odd else (self.s[:, l, r], given)
                k = (r + odd) * self.L + (l & ~1)
                out[:, k], out[:, k + 1] = pair
        return out

    def logical(self):
        """The (rows, 2^n) state under K3's map: amplitude l * A + r."""
        return self.s.reshape(self.s.shape[0], -1).copy()

    def _group_sum(self, v):
        """(rows, L) per-lane partial sums -> every lane's total, by the
        xor butterfly of group_sum."""
        m = 1
        while m < self.L:
            v = v + v[:, self.lig ^ m]
            m <<= 1
        return v

    def features(self):
        """The (rows, 3n) [X | Y | Z] output as reduce_features writes it
        under the feature kernels' map (qubit q on bit q): a register qubit
        pairs amplitudes inside the lane, a lane qubit with the partner lane
        (only the lane whose bit is clear adds the pair to X and Y), the
        lanes' sums meet in a butterfly, and lane f mod L writes feature f.
        Every feature must be written exactly once."""
        n, rows = self.n, self.s.shape[0]
        out = np.full((rows, 3 * n), np.nan)
        written = np.zeros(3 * n, int)
        for q in range(n):
            x, y, z = (np.zeros((rows, self.L)) for _ in range(3))
            if q < self.reg_bits:
                for p in range(self.A // 2):
                    k0 = ((p >> q) << (q + 1)) | (p & ((1 << q) - 1))
                    s0, s1 = self.s[:, :, k0], self.s[:, :, k0 | (1 << q)]
                    x += s0.real * s1.real + s0.imag * s1.imag
                    y += s0.real * s1.imag - s0.imag * s1.real
                    z += np.abs(s0) ** 2 - np.abs(s1) ** 2
            else:
                m = 1 << (q - 5)
                mine, partner = self.s, self.s[:, self.lig ^ m, :]
                hi = ((self.lig & m) != 0)[None, :]
                w = np.where(hi, 0.0, 1.0)  # this lane holds s0 where its bit is clear
                x = w * (mine.real * partner.real + mine.imag * partner.imag).sum(-1)
                y = w * (mine.real * partner.imag - mine.imag * partner.real).sum(-1)
                prob = (np.abs(mine) ** 2).sum(-1)
                z = np.where(hi, -prob, prob)
            totals = ((q, 2.0 * self._group_sum(x)), (n + q, 2.0 * self._group_sum(y)),
                      (2 * n + q, self._group_sum(z)))
            for f, total in totals:
                for lig in range(self.L):
                    if f % self.L == lig:
                        out[:, f] = total[:, lig]
                        written[f] += 1
        assert written.tolist() == [1] * (3 * n)
        return out


def _gate_2x2(kind, half):
    c, s = np.cos(half), np.sin(half)
    z, o = np.zeros_like(c), np.ones_like(c)
    if kind in (tc.RX, tc.CRX):
        u = [[c, -1j * s], [-1j * s, c]]
    elif kind in (tc.RY, tc.CRY):
        u = [[c, -s], [s, c]]
    elif kind in (tc.RZ, tc.CRZ):
        u = [[c - 1j * s, z], [z, c + 1j * s]]
    else:  # H
        u = [[o * np.sqrt(0.5), o * np.sqrt(0.5)], [o * np.sqrt(0.5), -o * np.sqrt(0.5)]]
    return np.stack([np.stack([e + 0j for e in row], -1) for row in u], -2)


def _model_gate_sequence(circuit, angles, states_layout):
    """run_gate_batch in the model: the gate table under either bit map, a
    gate at a time through apply_gate's case split."""
    st = LaneRegisterState(circuit.num_qubits, angles.shape[0])
    for j, (kind, q, ctl) in enumerate(K.gate_table(circuit, states_layout).tolist()):
        half = 0.5 * angles[:, j]
        if kind == tc.CX:
            st.perm(q, ctl)
        elif kind in (tc.CZ, tc.RZZ):
            st.diag2(q, ctl, kind == tc.CZ, half)
        else:
            st.su2(_gate_2x2(kind, half), q, ctl)
    return st


def model_states(circuit, angles):
    """K2's float32 kernel in the model: the remapped gate table, a gate at a
    time, then the write-out."""
    return _model_gate_sequence(circuit, angles, True).stored()


def model_features(circuit, angles):
    """K1's float32 kernel in the model: the gate table with qubit q on bit
    q, a gate at a time, then the reduction."""
    return _model_gate_sequence(circuit, angles, False).features()


def model_fused(circuit, angles, states_layout):
    """K4's (or, without ``states_layout``, K3's) op loop in the model, run
    from the tables the kernel consumes."""
    ops, gates, members, cperm = K.fused_tables(circuit, states_layout)
    st = LaneRegisterState(circuit.num_qubits, angles.shape[0])
    G = circuit.num_gates
    for typ, q, ctl, first, count, aux in ops.tolist():
        if typ == 0:
            u = None
            for kind, gi in gates[first:first + count].tolist():
                g = _gate_2x2(kind, 0.5 * angles[:, gi])
                u = g if u is None else g @ u
            st.su2(u, q, ctl)
        elif typ == 1:
            st.perm(q, ctl)
        else:
            idx = members[first - G:first - G + count]
            a = np.where(idx[None] >= 0, angles[:, np.maximum(idx, 0)], np.pi)
            st.diag_run(cperm, aux, a)
    return st.stored() if states_layout else st.logical()


def _reference(circuit, angles):
    return tsv.state_from_angles(circuit, torch.tensor(angles), torch.complex128).numpy()


@pytest.mark.parametrize("n", MODEL_QUBITS)
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_lane_register_model_runs_the_gate_sequence(enc, n):
    """K2's remapped gate table through the lane/register case split, then
    the float4 write-out, gives the plain engine's states."""
    c = _circuit(enc, n)
    a = _random_angles(c, 3, seed=n)
    np.testing.assert_allclose(model_states(c, a), _reference(c, a), rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("n", MODEL_QUBITS)
@pytest.mark.parametrize("seed", [0, 1])
def test_lane_register_model_every_gate_kind(n, seed):
    """All ten gate kinds with targets and controls on seeded qubits: unfused
    (K2's table) and fused (K4's tables) against the plain engine."""
    c = _every_kind_circuit(n, seed)
    assert {g.kind for g in c.gates} == set(range(10))
    a = _random_angles(c, 2, seed=10 + n)
    want = _reference(c, a)
    np.testing.assert_allclose(model_states(c, a), want, rtol=0, atol=MODEL_ATOL)
    np.testing.assert_allclose(model_fused(c, a, True), want, rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("states_layout", [True, False])
@pytest.mark.parametrize("n", MODEL_QUBITS)
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_lane_register_model_runs_the_fused_program(enc, n, states_layout):
    """The fused tables under either bit map (K4's with the write-out, K3's
    read back as amplitude l * A + r) give the plain engine's states."""
    c = _circuit(enc, n)
    a = _random_angles(c, 3, seed=20 + n)
    np.testing.assert_allclose(model_fused(c, a, states_layout), _reference(c, a),
                               rtol=0, atol=MODEL_ATOL)


def _features_reference(circuit, angles):
    return K.pauli_features_reference(circuit, torch.tensor(angles)).numpy()


@pytest.mark.parametrize("n", K1_MODEL_QUBITS)
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_lane_register_model_runs_k1(enc, n):
    """The unfused gate sequence under the identity bit map, then the model
    of reduce_features, gives the plain engine's Pauli features."""
    c = _circuit(enc, n)
    a = _random_angles(c, 3, seed=30 + n)
    np.testing.assert_allclose(model_features(c, a), _features_reference(c, a),
                               rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("n", MODEL_QUBITS)
@pytest.mark.parametrize("seed", [0, 1])
def test_lane_register_model_k1_every_gate_kind(n, seed):
    """All ten gate kinds through K1's model, targets and controls (CRX, CRY,
    CRZ, CZ, RZZ, CX) on seeded qubits: at n > 5 on register bits and on
    lane bits."""
    c = _every_kind_circuit(n, seed)
    if n > 5:
        assert {g.control >= 5 for g in c.gates if g.control >= 0} == {True, False}
    a = _random_angles(c, 2, seed=40 + n)
    np.testing.assert_allclose(model_features(c, a), _features_reference(c, a),
                               rtol=0, atol=MODEL_ATOL)


# ---------------------------------------------------------------------------
# Tables and geometry
# ---------------------------------------------------------------------------


def _logical_qubit(n, bit):
    """The inverse of K.states_bit."""
    if n <= 5 or bit < 0:
        return bit
    return bit - 5 if bit >= 5 else bit + (n - 5)


@pytest.mark.parametrize("n", range(1, K.ONE_WARP_QUBITS + 1))
def test_states_bit_map(n):
    """Qubits 0..n-6 on the lane bits (5..), n-5..n-1 on the register bits
    (0..4), a bijection; the identity up to 5 qubits; no control stays -1."""
    bits = [K.states_bit(n, q) for q in range(n)]
    assert sorted(bits) == list(range(n)) if n <= 5 else sorted(bits) == list(
        range(5)) + list(range(5, n))
    assert [_logical_qubit(n, b) for b in bits] == list(range(n))
    assert K.states_bit(n, -1) == -1
    if n <= 5:
        assert bits == list(range(n))
    else:
        assert bits[:n - 5] == list(range(5, n)) and bits[n - 5:] == list(range(5))
        # amplitude k: register k >> (n-5), lane k & (L-1)
        L = 1 << (n - 5)
        for k in (0, 1, L, 3 * L + 1, (1 << n) - 1):
            phys = sum(((k >> q) & 1) << K.states_bit(n, q) for q in range(n))
            assert (phys & 31, phys >> 5) == (k >> (n - 5), k & (L - 1))


@pytest.mark.parametrize("n", [1, 3, 5, 6, 10])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_states_tables_give_back_the_logical_program(enc, n):
    """Under the inverse map the states kernels' tables are the logical
    ones: K2's gate table is the circuit's, K4's op table K3's; the gate and
    member tables do not depend on the map; C's permutation gives back
    diag_patterns_concat."""
    c = _circuit(enc, n)
    phys, logical = K.gate_table(c, states_layout=True), K.gate_table(c)
    assert logical.tolist() == [[g.kind, g.qubit, g.control] for g in c.gates]
    assert phys.dtype == np.int32 and phys.shape == (c.num_gates, 3)
    back = [[k, _logical_qubit(n, q), _logical_qubit(n, ctl)] for k, q, ctl in phys.tolist()]
    assert back == logical.tolist()

    ops_s, gates_s, members_s, cperm_s = K.fused_tables(c, True)
    ops, gates, members, cperm = K.fused_tables(c, False)
    np.testing.assert_array_equal(gates_s, gates)
    np.testing.assert_array_equal(members_s, members)
    program = tf.fuse_circuit(c)
    assert len(ops_s) == len(program.ops)
    for row_s, row, op in zip(ops_s.tolist(), ops.tolist(), program.ops):
        assert row_s[0] == row[0] and row_s[3:] == row[3:]
        if isinstance(op, tf.DiagOp):
            assert row_s[1:3] == row[1:3] == [0, -1]
        else:
            assert [_logical_qubit(n, b) for b in row_s[1:3]] == row[1:3] == [op.qubit, op.control]
    cmat = tf.diag_patterns_concat(program)
    A = min(1 << n, 32)
    L = (1 << n) // A
    assert cperm_s.shape == cperm.shape == (cmat.shape[1], A, L)
    # states map: [j, r, l] is amplitude r * L + l; K3's: amplitude l * A + r
    np.testing.assert_array_equal(cperm_s.transpose(1, 2, 0).reshape(cmat.shape), cmat)
    np.testing.assert_array_equal(cperm.transpose(2, 1, 0).reshape(cmat.shape), cmat)


@pytest.mark.parametrize("n", range(1, K.ONE_WARP_QUBITS + 1))
def test_states_warp_geometry(n):
    """K2's float32 geometry: the state in registers over max(1, 2^(n-5))
    lanes, so shared memory holds only the gate table, the batch loop's two
    words and each warp's staged angle rows at an odd stride with its group
    word; two blocks fit an SM."""
    c = _circuit("chebyshev", n)
    G = c.num_gates
    geo = K.states_geometry(c)
    lanes = max(1, 2 ** (n - 5))
    assert geo.lanes == lanes and geo.samples == geo.threads // lanes and geo.c_bytes == 0
    table = 4 * ((3 * G + 2 + 3) // 4 * 4)
    per_warp = 4 * ((32 // lanes) * (G | 1) + 1)
    assert geo.smem_bytes == table + geo.threads // 32 * per_warp
    assert geo.threads in (32, 64, 128, 256) and 2 * geo.smem_bytes <= 228 * 1024
    kyr6 = K.states_geometry(_circuit("kyriienko", 6, 1))  # config #5's circuit
    assert (kyr6.threads, kyr6.lanes, kyr6.samples) == (256, 2, 128)


@pytest.mark.parametrize("n", range(1, K.ONE_WARP_QUBITS + 1))
def test_features_warp_geometry(n):
    """K1's float32 geometry: K2's layout of shared memory (the (G, 3) gate
    table with qubit q on bit q, each warp's staged angle rows), sized so
    that the blocks an SM its instantiation asks for (four up to 4 qubits,
    two above) fit the SM."""
    for G_layers in (1, 3):
        c = _circuit("chebyshev", n, G_layers)
        G = c.num_gates
        geo = K.features_geometry(c)
        lanes = max(1, 2 ** (n - 5))
        blocks = K.features_min_blocks(n)
        assert blocks == (4 if n <= 4 else 2)
        assert geo.lanes == lanes and geo.samples == geo.threads // lanes and geo.c_bytes == 0
        assert geo.samples // (geo.threads // 32) == 32 // lanes  # samples a warp
        table = 4 * ((3 * G + 2 + 3) // 4 * 4)
        per_warp = 4 * ((32 // lanes) * (G | 1) + 1)
        assert geo.smem_bytes == table + geo.threads // 32 * per_warp
        assert geo.threads == (128 if n <= 5 else 256)
        # each resident block also takes 1 KB of the SM's 228 KB for the system
        assert blocks * (geo.smem_bytes + 1024) <= 228 * 1024
    north = K.features_geometry(_circuit("chebyshev", 4, 3))  # the north star's circuit
    assert (north.threads, north.lanes, north.samples) == (128, 1, 128)
    assert north.smem_bytes == 4 * 124 + 4 * 4 * (32 * 41 + 1)
    wide = K.features_geometry(_circuit("chebyshev", 3, 40))  # long rows: fewer warps a block
    assert wide.threads < 128 and 4 * (wide.smem_bytes + 1024) <= 228 * 1024
    # the gate table K1 gets is the circuit's own: qubit q on bit q
    c10 = _circuit("chebyshev", 10)
    assert K.gate_table(c10).tolist() == [[g.kind, g.qubit, g.control] for g in c10.gates]


@pytest.mark.parametrize("n", range(1, K.ONE_WARP_QUBITS + 1))
def test_fused_states_geometry(n):
    """K4 runs K3's body, so its geometry is K3's whatever the bit map: the
    tables, C and each warp's staged rows (angles, phase-run members and,
    where a sample spans lanes, its SU2 coefficients)."""
    c = _circuit("kyriienko", n, 1)
    ops, gates, members, cperm = K.fused_tables(c, True)
    geo = K.fused_geometry(c)
    lanes = max(1, 2 ** (n - 5))
    assert geo.lanes == lanes and geo.samples == geo.threads // lanes
    assert geo.c_bytes == cperm.nbytes == 4 * (1 << n) * cperm.shape[0]
    coef = 8 * tf.fuse_circuit(c).n_su2 if lanes > 1 else 0
    row = (c.num_gates + members.size + coef) | 1
    table = 4 * ((ops.size + gates.size + members.size + 2 + 3) // 4 * 4)
    assert geo.smem_bytes == table + geo.c_bytes + geo.threads // 32 * 4 * ((32 // lanes) * row + 1)
    assert geo.threads in (32, 64, 128, 256) and 2 * geo.smem_bytes <= 228 * 1024
    if n == 6:  # config #5's circuit: 11 fused ops, 6 SU2 ops, no phase run
        assert (len(ops), members.size, geo.threads, geo.samples) == (11, 0, 256, 128)


# ---------------------------------------------------------------------------
# Guards and the card's path, with the launch itself patched out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wrapper,dtypes", [
    ("pauli_features_from_angles", "float32 or torch.float64"),
    ("states_from_angles", "float32 or torch.float64"),
    ("states_from_angles_fused", "float32")])
def test_states_launch_guards(wrapper, dtypes):
    """K1, K2 and K4 take contiguous (B, G) angles of their dtypes and
    qubit counts (K1 1-12, K2 and K4 1-10): anything else raises before any
    launch (as it would on the card)."""
    c = _circuit("chebyshev", 3, 1)
    fn = getattr(K, wrapper)
    most = K.MAX_QUBITS["K1" if wrapper == "pauli_features_from_angles" else "K2"]
    with mock.patch.object(K, "_is_cuda", lambda t: True):
        with pytest.raises(NotImplementedError, match=dtypes + " angles"):
            fn(c, torch.zeros((4, c.num_gates), dtype=torch.float16))
        with pytest.raises(ValueError, match=f"angles must be \\(B, {c.num_gates}\\)"):
            fn(c, torch.zeros((4, c.num_gates + 1)))
        with pytest.raises(ValueError, match="contiguous"):
            fn(c, torch.zeros((c.num_gates, 4)).t())
        with pytest.raises(ValueError, match=f"1 to {most} qubits"):
            big = _circuit("chebyshev", most + 1, 1)
            fn(big, torch.zeros((1, big.num_gates)))
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


@pytest.mark.parametrize("n", [3, 6, 10])
def test_card_path_of_k4_takes_the_angles(n):
    """On the card's path K4 is one launch on the angles: no torch op builds
    coefficients (fusion.packed_inputs raises if anything calls it) and the
    launch gets the states-layout tables and the geometry's block."""
    c = _circuit("kyriienko", n, 1)
    a = torch.zeros((5, c.num_gates))
    calls = []
    with mock.patch.object(K, "_is_cuda", lambda t: True), \
            mock.patch.object(K, "_launch", lambda *args: calls.append(args)), \
            mock.patch.object(tf, "packed_inputs", side_effect=AssertionError("packed")), \
            mock.patch.object(tf, "su2_products", side_effect=AssertionError("products")):
        try:
            out = K.states_from_angles_fused(c, a)
            assert K.launch_counts()["K4"] == 1
        finally:
            K.reset_launch_counts()
    assert out.shape == (5, 1 << n) and out.dtype == torch.complex64
    assert not hasattr(K, "packed_inputs") and not hasattr(K, "states_from_packed")
    (source, fn, _, angles_ptr, cperm_ptr, ops_ptr, *rest), = calls
    assert (source, fn, angles_ptr) == (K.FUSED_SOURCE, "dqgp_states_fused", a.data_ptr())
    ops, gates, members, cperm = K._fused_device_tables(c, a.device, True)
    assert (cperm_ptr, ops_ptr) == (cperm.data_ptr(), ops.data_ptr())
    geo, program = K.fused_geometry(c), tf.fuse_circuit(c)
    assert rest[3:] == [5, n, c.num_gates, len(program.ops), gates.shape[0], members.shape[0],
                        program.n_su2, cperm.shape[0], geo.threads, geo.smem_bytes]


@pytest.mark.parametrize("n", [3, 6, 10])
def test_card_path_of_k2_by_dtype(n):
    """float32 angles take the warp kernel, float64 angles its float64
    instantiation, both with the remapped gate table and each with the
    geometry of its real type."""
    c = _circuit("kyriienko", n, 1)
    calls = []
    with mock.patch.object(K, "_is_cuda", lambda t: True), \
            mock.patch.object(K, "_launch", lambda *args: calls.append(args)):
        try:
            a32, a64 = torch.zeros((5, c.num_gates)), torch.zeros((5, c.num_gates),
                                                                  dtype=torch.float64)
            assert K.states_from_angles(c, a32).dtype == torch.complex64
            assert K.states_from_angles(c, a64).dtype == torch.complex128
            assert (K.launch_counts()["K2"], K.launch_counts()["K2_f64"]) == (1, 1)
        finally:
            K.reset_launch_counts()
    f32, f64 = calls
    geo = K.states_geometry(c)
    assert f32[1] == "dqgp_states" and f32[4] == K._gate_table(c, a32.device, True).data_ptr()
    assert list(f32[6:]) == [5, c.num_gates, n, geo.threads, geo.smem_bytes]
    geo64 = K.states_geometry(c, 8)
    assert f64[1] == "dqgp_states_f64" and f64[4] == f32[4]
    assert list(f64[6:]) == [5, c.num_gates, n, geo64.threads, geo64.smem_bytes]


@pytest.mark.parametrize("n", [3, 4, 6, 10])
def test_card_path_of_k1_by_dtype(n):
    """float32 angles take the warp kernel, float64 angles its float64
    instantiation, both with the gate table that has qubit q on bit q and
    each with the geometry of its real type; each ticks its own counter."""
    c = _circuit("chebyshev", n, 2)
    calls = []
    with mock.patch.object(K, "_is_cuda", lambda t: True), \
            mock.patch.object(K, "_launch", lambda *args: calls.append(args)):
        try:
            a32, a64 = torch.zeros((5, c.num_gates)), torch.zeros((5, c.num_gates),
                                                                  dtype=torch.float64)
            out32 = K.pauli_features_from_angles(c, a32)
            out64 = K.pauli_features_from_angles(c, a64)
            assert K.launch_counts() == {**dict.fromkeys(K.launch_counts(), 0),
                                         "K1": 1, "K1_f64": 1}
            assert K.pauli_features_from_angles(c, a32[:0]).shape == (0, 3 * n)
            assert K.launch_counts()["K1"] == 1  # an empty batch launches nothing
        finally:
            K.reset_launch_counts()
    assert (out32.shape, out32.dtype) == ((5, 3 * n), torch.float32)
    assert (out64.shape, out64.dtype) == ((5, 3 * n), torch.float64)
    f32, f64 = calls
    geo = K.features_geometry(c)
    table = K._gate_table(c, a32.device)
    assert table.tolist() == [[g.kind, g.qubit, g.control] for g in c.gates]
    assert f32[:2] == (K.SOURCE, "dqgp_pauli_features")
    assert f32[3:6] == (a32.data_ptr(), table.data_ptr(), out32.data_ptr())
    assert list(f32[6:]) == [5, c.num_gates, n, geo.threads, geo.smem_bytes]
    geo64 = K.features_geometry(c, 8)
    assert f64[:2] == (K.SOURCE, "dqgp_pauli_features_f64") and f64[4] == table.data_ptr()
    assert list(f64[6:]) == [5, c.num_gates, n, geo64.threads, geo64.smem_bytes]
    assert K._WARP_KERNELS["K1"] == (K.SOURCE, "dqgp_pauli_features",
                                     "dqgp_pauli_features_blocks_per_sm")
    assert K._WARP_KERNELS["K1_f64"] == (K.SOURCE, "dqgp_pauli_features_f64",
                                         "dqgp_pauli_features_f64_blocks_per_sm")


def test_circuit_keys_the_caches_cheaply():
    """A launch looks its cached tables up by the circuit: the library gives
    one object for the same arguments (no gate-by-gate comparison on a
    lookup), and a circuit hashes its gate list once, equal circuits alike,
    a pickled copy anew."""
    import pickle

    from dqgp_tpu_torch.models.circuits import build_circuit as torch_build

    c = torch_build("kyriienko", 6, 2, 1)
    assert torch_build("kyriienko", 6, 2, 1) is c
    assert torch_build("kyriienko", 6, 2, 2) is not c
    twin = _circuit("kyriienko", 6, 1)  # equal, built apart
    assert twin is not c and twin == c and hash(twin) == hash(c) == c._hash
    copy = pickle.loads(pickle.dumps(c))
    assert "_hash" not in copy.__dict__ and copy == c and hash(copy) == hash(c)
    assert K.states_geometry(twin) is K.states_geometry(c)


@pytest.mark.parametrize("n", [6, 10])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_states_dispatch_is_unchanged(mode, n, monkeypatch):
    """The fidelity features go through K2 unless the fusion switch is "on"
    (the states path has no qubit threshold of its own), and float64 angles
    take K2 whatever the switch: the fused kernel is float32 only."""
    from dqgp_tpu_torch import config
    from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ

    monkeypatch.setattr(config, "use_fusion", mode)
    c = _circuit("kyriienko", n, 1)
    spec = TQ.QuantumKernelSpec(circuit=c, kernel_type="fidelity")
    a = torch.tensor(_random_angles(c, 2, seed=n), dtype=torch.float32)
    with mock.patch.object(TQ, "states_from_angles", wraps=K.states_from_angles) as k2, \
            mock.patch.object(TQ, "states_from_angles_fused",
                              wraps=K.states_from_angles_fused) as k4:
        got = TQ.features_from_angles(spec, a)
        assert (k2.call_count, k4.call_count) == ((0, 1) if mode == "on" else (1, 0))
        TQ.features_from_angles(spec, a.double())
        assert (k2.call_count, k4.call_count) == ((1, 1) if mode == "on" else (2, 0))
    assert got.shape == (2, 1 << n) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), K.states_reference(c, a).numpy(), rtol=0, atol=3e-6)
