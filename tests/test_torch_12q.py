"""11 and 12 qubits on the CPU: the plain engines against the JAX package's
XLA engines, and what the CPU reaches of K1 (float32 and float64) and K3
with a sample's state across 2 and 4 warps (csrc/pauli_features_q11_12.cu,
pauli_features_f64_q11_12.cu, pauli_features_fused_q11_12.cu).

* The port's plain fused engine (K3's plain version) and plain float64
  engine (K1 float64's) against JAX's fused program and its complex128
  engine at 11 and 12 qubits: 5e-6 in float32, 1e-12 in float64.
* A numpy model of the kernels' layout from 11 qubits up: amplitude k in
  register k & 31 of lane (k >> 5) & 31 of warp k >> 10 of its sample's
  group, round-tripping at 1-12 qubits; gates on a register, lane and warp
  bit through the kernels' case split (a warp bit through the exchange
  slots); the phase runs from the member codes; the reduction's per-warp
  partial sums. Held to the plain engine at 1e-12 (the split is exact).
* The derived phase-run columns equal ``diag_patterns_concat``'s at 1-12
  qubits; the geometry within the shared-memory budget; K2, K4 and the
  adjoint raise at 11-12 qubits with no plain fallback; the wrappers take
  the wide sources.
* ``train()`` at 12 qubits on the fixture's CPU cut
  (tests/fixtures/torch_port_12q.json, scripts/record_torch_port_12q.py)
  at phase 11a's bars.

The card's own checks are chip_smoke.py's phase 19.
"""

import json
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.ops import fusion as jfusion
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu_torch.convert import circuit_from_jax
from dqgp_tpu_torch.ops import circuit as tc
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import fusion as tf

MODEL_ATOL = 1e-12
WIDE = (11, 12)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _angles(c, rows, seed):
    return np.random.RandomState(seed).uniform(-np.pi, 3 * np.pi, (rows, c.num_gates))


def _every_kind_circuit(n, seed):
    """Every gate kind four times over, on seeded qubits (targets and
    controls on register, lane and, from 11 qubits, warp bits)."""
    rng = np.random.RandomState(seed)
    gates = []
    for kind in list(range(10)) * 4:
        q = int(rng.randint(n))
        c = int((q + 1 + rng.randint(n - 1)) % n) if kind >= tc.CX else -1
        gates.append(tc.Gate(kind=kind, qubit=q, control=c))
    order = rng.permutation(len(gates))
    return tc.Circuit(num_qubits=n, num_features=1, num_parameters=1,
                      gates=tuple(gates[i] for i in order), name="every_kind")


# ---------------------------------------------------------------------------
# The plain engines against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc,n", [("chebyshev", 12), ("random", 11), ("hubregtsen", 12)])
def test_plain_engines_match_jax(enc, n):
    """K3's plain version (the plain fused engine, float32) against JAX's
    fused program, and K1 float64's (the plain complex128 engine) against
    JAX's complex128 engine, on the same seeded angles."""
    jc = build_circuit(enc, n, 2, 2)
    c = circuit_from_jax(jc)
    a = _angles(c, 16, seed=n)
    want32 = np.asarray(jax.jit(lambda x: jsv.pauli_features(
        jfusion.state_from_angles_fused(jc, x), n))(jnp.asarray(a, jnp.float32)))
    got32 = K.pauli_features_fused_reference(c, torch.tensor(a, dtype=torch.float32))
    assert np.abs(got32.numpy() - want32).max() <= cs.K1_TOL
    want64 = np.asarray(jax.jit(lambda x: jsv.pauli_features(
        jsv.state_from_angles(jc, x, jnp.complex128), n))(jnp.asarray(a)))
    got64 = K.pauli_features_reference(c, torch.tensor(a))
    assert got64.dtype == torch.float64
    assert np.abs(got64.numpy() - want64).max() <= cs.F64_TOL


# ---------------------------------------------------------------------------
# A numpy model of the layout across warps
# ---------------------------------------------------------------------------


def location(n, k):
    """Where K1 and K3 hold amplitude k of an n-qubit sample (qubit q on bit
    q): (warp in the sample's group, lane, register)."""
    if n <= 5:
        return 0, 0, k
    return k >> 10, (k >> 5) & 31, k & 31


@pytest.mark.parametrize("n", range(1, 13))
def test_amplitude_map_round_trips(n):
    """Every amplitude has one place, within the geometry's lanes and warps,
    and comes back from it; the lane's index in the group (lig) carries bits
    5..n-1 of the amplitude."""
    geo = K.features_geometry(circuit_from_jax(build_circuit("chebyshev", n, 2, 1)))
    A = min(1 << n, 32)
    seen = set()
    for k in range(1 << n):
        w, lane, r = location(n, k)
        assert w < geo.warps and r < A and (n <= 5 or lane < min(geo.lanes, 32))
        lig = w * 32 + lane
        assert (k if n <= 5 else lig * 32 + r) == k and (n <= 5 or lig == k >> 5)
        seen.add((w, lane, r))
    assert len(seen) == 1 << n
    assert (geo.warps, geo.lanes) == (1 << max(0, n - 10), 1 << max(0, n - 5))


class WarpGroupState:
    """A batch of n-qubit states (n = 11, 12) as K1 and K3 hold one:
    s[b, warp, lane, register], amplitude (warp * 32 + lane) * 32 + register."""

    def __init__(self, n, rows):
        self.n, self.W = n, 1 << (n - 10)
        self.s = np.zeros((rows, self.W, 32, 32), np.complex128)
        self.s[:, 0, 0, 0] = 1.0
        self.lig = np.arange(self.W)[:, None] * 32 + np.arange(32)[None, :]  # (W, 32)
        self.reg = np.arange(32)

    def bit(self, b):
        """(W, 32, 32) amplitude bit b, from the register or from lig."""
        if b < 5:
            return np.broadcast_to((self.reg >> b) & 1, (self.W, 32, 32)).astype(bool)
        return np.broadcast_to(((self.lig >> (b - 5)) & 1)[..., None], (self.W, 32, 32)).astype(bool)

    def partner(self, q):
        """Each amplitude's partner across bit q, fetched as the kernels do:
        another register, the lane lig ^ m by shuffle, or the partner warp's
        exchange slot (every warp publishes its state first)."""
        if q < 5:
            return self.s[..., self.reg ^ (1 << q)]
        if q < 10:
            return self.s[:, :, np.arange(32) ^ (1 << (q - 5)), :]
        slots = self.s.copy()  # publish_state
        return slots[:, np.arange(self.W) ^ (1 << (q - 10))]

    def su2(self, u, q, ctl=-1):
        """Each amplitude's own row of the 2x2 with its partner."""
        hi = self.bit(q)[None]
        mine = np.where(hi, u[:, 1, 1, None, None, None], u[:, 0, 0, None, None, None])
        other = np.where(hi, u[:, 1, 0, None, None, None], u[:, 0, 1, None, None, None])
        on = self.bit(ctl)[None] if ctl >= 0 else True
        self.s = np.where(on, mine * self.s + other * self.partner(q), self.s)

    def diag(self, phi):
        self.s = self.s * np.exp(1j * phi)

    def diag_codes(self, codes, member_angles):
        """apply_diag_codes: each member's column from its code and the
        amplitude's bits, the phases summed in the members' order."""
        phi = 0.0
        for j, code in enumerate(codes):
            kind, bq, bc = code & 15, self.bit((code >> 4) & 15), self.bit(code >> 8)
            col = {tc.RZ: bq - 0.5, tc.CRZ: bc * (bq - 0.5), tc.CZ: (bq & bc) * 1.0,
                   tc.RZZ: (bq ^ bc) - 0.5}[kind]
            phi = phi + col[None] * member_angles[:, j, None, None, None]
        self.diag(phi)

    def features(self):
        """reduce_features_swept from 11 qubits up: each warp's shares of the
        3n sums (register qubits from pairs in the lane, lane qubits with the
        partner lane, warp qubits with the partner warp's published state;
        the lane whose or warp whose bit is clear adds X and Y), summed over
        the warp's lanes; the group's first warp adds the W shares."""
        n, rows = self.n, self.s.shape[0]
        part = np.zeros((rows, self.W, 3 * n))
        prob = np.abs(self.s) ** 2
        for q in range(n):
            lo = ~self.bit(q)
            p = self.partner(q)
            cross = np.where(lo[None], np.conj(self.s) * p, 0.0)
            part[:, :, q] = cross.real.sum((2, 3))
            part[:, :, n + q] = cross.imag.sum((2, 3))
            part[:, :, 2 * n + q] = np.where(lo[None], prob, -prob).sum((2, 3))
        total = part.sum(1)
        total[:, :2 * n] *= 2.0
        return total


def _gate_2x2(kind, half):
    c, s = np.cos(half), np.sin(half)
    z, o = np.zeros_like(c), np.ones_like(c)
    if kind in (tc.RX, tc.CRX):
        u = [[c, -1j * s], [-1j * s, c]]
    elif kind in (tc.RY, tc.CRY):
        u = [[c, -s], [s, c]]
    elif kind in (tc.RZ, tc.CRZ):
        u = [[c - 1j * s, z], [z, c + 1j * s]]
    elif kind == tc.H:
        u = [[o * np.sqrt(0.5), o * np.sqrt(0.5)], [o * np.sqrt(0.5), -o * np.sqrt(0.5)]]
    else:  # CX
        u = [[z, o], [o, z]]
    return np.stack([np.stack([e + 0j for e in row], -1) for row in u], -2)


def model_k1(circuit, angles):
    """K1 in the model: the gate table a gate at a time (CZ and RZZ as
    diag2's sign and phase from two bits), then the reduction."""
    st = WarpGroupState(circuit.num_qubits, angles.shape[0])
    for j, (kind, q, ctl) in enumerate(K.gate_table(circuit).tolist()):
        half = 0.5 * angles[:, j, None, None, None]
        if kind == tc.CZ:
            st.diag(np.where((st.bit(q) & st.bit(ctl))[None], np.pi, 0.0))
        elif kind == tc.RZZ:
            st.diag(np.where((st.bit(q) == st.bit(ctl))[None], -half, half))
        else:
            st.su2(_gate_2x2(kind, 0.5 * angles[:, j]), q, ctl)
    return st.features()


def model_k3(circuit, angles):
    """K3 in the model: the fused program from fused_tables (the SU2 ops'
    2x2s from their gates, each new gate on the left; PERM rows; the phase
    runs from the member codes that follow the member table), then the
    reduction."""
    ops, gates, members, cperm = K.fused_tables(circuit)
    n_members = members.size // 2
    assert cperm.shape[0] == 0 and members[n_members:].tolist() == K.member_codes(circuit)
    st = WarpGroupState(circuit.num_qubits, angles.shape[0])
    for op_type, q, ctl, first, count, aux in ops.tolist():
        if op_type == 0:
            u = np.broadcast_to(np.eye(2, dtype=np.complex128), (angles.shape[0], 2, 2))
            for kind, gi in gates[first:first + count].tolist():
                u = _gate_2x2(kind, 0.5 * angles[:, gi]) @ u
            st.su2(u, q, ctl)
        elif op_type == 1:
            st.su2(_gate_2x2(tc.CX, 0.0 * angles[:, 0]), q, ctl)
        else:
            idx = members[aux:aux + count]
            a = np.where(idx >= 0, angles[:, np.maximum(idx, 0)], np.pi)
            st.diag_codes(members[n_members + aux:n_members + aux + count].tolist(), a)
    return st.features()


@pytest.mark.parametrize("n", WIDE)
@pytest.mark.parametrize("which", ["every_kind", "chebyshev"])
def test_warp_model_matches_the_plain_engine(n, which):
    """K1's and K3's algorithms across warps, in the model, against the
    plain complex128 engine."""
    c = (_every_kind_circuit(n, seed=n) if which == "every_kind"
         else circuit_from_jax(build_circuit("chebyshev", n, 2, 2)))
    a = _angles(c, 3, seed=7)
    want = K.pauli_features_reference(c, torch.tensor(a)).numpy()
    assert np.abs(model_k1(c, a) - want).max() <= MODEL_ATOL
    assert np.abs(model_k3(c, a) - want).max() <= MODEL_ATOL


def pattern_entry(code, k):
    """csrc/warp_state.cuh's pattern_entry at amplitude k, its bits taken
    from the register (k & 31) and lig (k >> 5) as the kernel takes them."""
    r, lig = k & 31, k >> 5

    def bit(b):
        return (r >> b) & 1 if b < 5 else (lig >> (b - 5)) & 1

    kind, bq, bc = code & 15, bit((code >> 4) & 15), bit(code >> 8)
    if kind == tc.RZ:
        return np.float32(bq) - np.float32(0.5)
    if kind == tc.CRZ:
        return np.float32(bq) - np.float32(0.5) if bc else np.float32(0.0)
    if kind == tc.CZ:
        return np.float32(bq & bc)
    return np.float32(bq ^ bc) - np.float32(0.5)


@pytest.mark.parametrize("n", range(2, 13))
def test_member_codes_rebuild_the_pattern_columns(n):
    """Every member's derived column equals diag_patterns_concat's, exactly,
    for circuits whose phase runs hold RZ, CRZ, CZ and RZZ members (at 1
    qubit no circuit has a phase run)."""
    circuits = [_every_kind_circuit(n, seed=s) for s in (1, 2)]
    circuits += [circuit_from_jax(build_circuit(e, n, 2, 2)) for e in ("chebyshev", "random")]
    kinds = set()
    for c in circuits:
        codes = K.member_codes(c)
        cmat = tf.diag_patterns_concat(tf.fuse_circuit(c))
        if not codes:
            assert not cmat.any()
            continue
        k = np.arange(1 << n)
        got = np.stack([np.array([pattern_entry(code, i) for i in k]) for code in codes], 1)
        np.testing.assert_array_equal(got, cmat)
        kinds |= {code & 15 for code in codes}
    assert kinds == {tc.RZ, tc.CRZ, tc.CZ, tc.RZZ}


# ---------------------------------------------------------------------------
# Geometry, guards and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDE)
def test_wide_geometry_fits(n):
    """K1 (float32 and float64) and K3 from 11 qubits up: 2^(n-10) warps a
    sample, the launch bound's warps' exchange slots first, then the tables
    and each warp's own copy of its group's row, within the blocks an SM the
    instantiation asks for."""
    c = circuit_from_jax(build_circuit("chebyshev", n, 2, 2))
    W, G = 1 << (n - 10), c.num_gates
    slot = (2 * 32 * 32 + 3 * n + 3) & ~3
    assert K.exchange_words(n) == slot and K.exchange_words(10) == 0
    for real, blocks in ((4, 2), (8, 1)):
        geo = K.features_geometry(c, real)
        assert (geo.warps, geo.lanes, geo.threads) == (W, 32 * W, 256)
        assert geo.samples == geo.threads // 32 // W > 0 and geo.c_bytes == 0
        rows = G | 1
        rows = rows + 1 if real == 4 else (rows + 2) & ~1
        want = real * 8 * slot + 4 * ((3 * G + 2 + 3) & ~3) + geo.threads // 32 * real * rows
        assert geo.smem_bytes == want <= 224 * 1024 // blocks
        assert K.features_min_blocks(n, real) == blocks
    ops, gates, members, cperm = K.fused_tables(c)
    program = tf.fuse_circuit(c)
    n_members = sum(op.K for op in program.ops if isinstance(op, tf.DiagOp))
    assert members.size == 2 * n_members and cperm.nbytes == 0
    geo = K.fused_geometry(c)
    row = (G + n_members + 8 * program.n_su2) | 1
    table = 4 * ((ops.size + gates.size + members.size + 2 + 3) & ~3)
    assert geo.smem_bytes == 4 * 8 * slot + table + geo.threads // 32 * 4 * (row + 1) <= 112 * 1024
    assert (geo.warps, geo.samples, geo.c_bytes) == (W, geo.threads // 32 // W, 0)


@pytest.mark.parametrize("n", WIDE)
@pytest.mark.parametrize("wrapper", ["states_from_angles", "states_from_angles_fused",
                                     "circuit_vjp"])
def test_kernels_not_ported_at_11_12_raise(wrapper, n):
    """K2, K4 and the adjoint stop at 10 qubits: on the card they raise,
    naming the kernel and its range, and never reach a plain version."""
    c = circuit_from_jax(build_circuit("chebyshev", n, 2, 1))
    a = torch.zeros((2, c.num_gates))
    args = (c, a, torch.zeros((2, 3 * n)), "features") if wrapper == "circuit_vjp" else (c, a)
    plain = ("states_reference", "states_fused_reference", "circuit_vjp_reference")
    with mock.patch.object(K, "_is_cuda", lambda t: True), mock.patch.multiple(
            K, **{p: mock.DEFAULT for p in plain}) as refs:
        name = {"states_from_angles": "states kernel (K2)",
                "states_from_angles_fused": "fused states kernel (K4)",
                "circuit_vjp": "adjoint kernel (the backward of K1 and K2)"}[wrapper]
        with pytest.raises(ValueError, match=re.escape(f"the CUDA {name} supports 1 to 10 "
                                                       f"qubits, got {n}")):
            getattr(K, wrapper)(*args)
        if wrapper == "states_from_angles":
            with pytest.raises(ValueError, match="1 to 10 qubits"):
                K.states_from_angles(c, a.double())
        assert not any(m.called for m in refs.values())
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


@pytest.mark.parametrize("n", WIDE)
def test_wide_launches_take_their_sources(n):
    """At 11 and 12 qubits the wrappers launch the instantiations of the
    wide sources with the wide geometry: K3 with the members' count (not
    the member table's, which holds their codes too) and no C."""
    c = circuit_from_jax(build_circuit("chebyshev", n, 2, 2))
    a32 = torch.zeros((5, c.num_gates))
    launched = []
    with mock.patch.object(K, "_is_cuda", lambda t: True), \
            mock.patch.object(K, "_launch", lambda *args: launched.append(args)), \
            mock.patch.object(K, "_fused_device_tables",
                              lambda circuit, device, states: tuple(
                                  torch.as_tensor(t) for t in K.fused_tables(circuit, states))):
        K.pauli_features_from_angles(c, a32)
        K.pauli_features_from_angles(c, a32.double())
        K.pauli_features_from_angles_fused(c, a32)
    assert K.launch_counts()["K1"] == K.launch_counts()["K1_f64"] == 1
    assert K.launch_counts()["K3"] == 1
    K.reset_launch_counts()
    (src1, fn1, *_, t1, s1), (src2, fn2, *_, t2, s2), (src3, fn3, *rest) = launched
    assert (src1, fn1) == ("pauli_features_q11_12.cu", "dqgp_pauli_features")
    assert (src2, fn2) == ("pauli_features_f64_q11_12.cu", "dqgp_pauli_features_f64")
    assert (src3, fn3) == ("pauli_features_fused_q11_12.cu", "dqgp_pauli_features_fused")
    geo = K.features_geometry(c)
    assert (t1, s1) == (geo.threads, geo.smem_bytes)
    assert (t2, s2) == (K.features_geometry(c, 8).threads, K.features_geometry(c, 8).smem_bytes)
    program = tf.fuse_circuit(c)
    n_members = sum(op.K for op in program.ops if isinstance(op, tf.DiagOp))
    B, n_, G, n_ops, n_gates, members, n_su2, KT, tpb, smem = rest[-10:]
    assert (B, n_, G, n_ops, n_gates, members, n_su2, KT) == (
        5, n, c.num_gates, len(program.ops), K.fused_tables(c)[1].shape[0], n_members,
        program.n_su2, 0)
    assert (tpb, smem) == (K.fused_geometry(c).threads, K.fused_geometry(c).smem_bytes)


# ---------------------------------------------------------------------------
# train() at 12 qubits against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q12_fixture():
    with open(cs.Q12_FIXTURE) as f:
        return json.load(f)


def test_train_at_12_qubits_holds_the_fixture(q12_fixture):
    """The fixture's CPU cut (53 samples, 2 agents of 23-24 rows, 1
    iteration) through the port's train() and CG predictor on the CPU, held
    as phase 11a holds the 10-qubit fixture: agent NLLs at JAX's z within
    ``config7_nll_bars``, z, CV-NLPD and the CG test NLPD within their
    bars."""
    from dqgp_tpu_torch.driver import train
    from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
    from dqgp_tpu_torch.parallel import blocked as BL

    ref = q12_fixture["cpu_train"]
    assert (ref["problem"]["num_qubits"], ref["problem"]["n_samples"],
            ref["iterations"]) == (cs.C12_QUBITS, cs.C12_CPU_SAMPLES, cs.C12_CPU_ITERS)
    spec = cs.config7_spec(cs.C12_QUBITS)
    X_tr, Y_tr, X_te, Y_te, splits = cs.config7_problem(cs.C12_CPU_SAMPLES, cs.C12_CPU_AGENTS)
    assert [len(x) for x, _ in splits] == ref["problem"]["shard_sizes"]
    cfg = cs.config7_train_config(cs.C12_CPU_ITERS, verbose=False)
    res = train(spec, splits, X_tr, Y_tr, cfg, device="cpu")
    mean, var = BL.make_cg_predictor(spec, X_tr, Y_tr, torch.as_tensor(res.z), cfg.noise_std,
                                     device="cpu")(X_te)
    metrics = evaluate_predictions(Y_te, mean, var)
    nll_at_ref = cs.config7_agent_nll_at(spec, splits, ref["z_trajectory"], "cpu",
                                         cfg.noise_std)
    z_dev, nll_dev, cv_ratio, t_ratio = cs.check_config7_fixture(
        res, metrics, ref, cs.C12_CPU_ITERS, nll_at_ref)
    assert z_dev <= 1e-12  # iteration 1's z is the initial state's on both sides
    assert nll_dev <= cs.config7_nll_bars(ref)[0] and cv_ratio <= 1 and t_ratio <= 1
