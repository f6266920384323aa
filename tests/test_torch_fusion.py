"""The fusion module and the fused-program states kernel (K4): the port's
fused program against the JAX package's, its packed rows, the plain
fused engine (K4's plain version, which the wrapper runs on the CPU) against
the Pallas kernel in interpret mode, and the fusion switch.

Bars (tests/test_fusion.py): fused float32 states 3e-6 against the Pallas
fused kernel and the unfused engine; the fused complex128 engine 1e-12
against the unfused one (the fusion algebra is exact). Packed rows are
float32 trig and 2x2 complex products from two engines: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu import config as jconfig
from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu.ops import fusion as jf
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu.ops.pallas_circuit import make_pallas_states_fused_fn
from dqgp_tpu_torch import config as tconfig
from dqgp_tpu_torch.convert import circuit_from_jax
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import fusion as tf

F32_ATOL, F64_ATOL, PACKED_ATOL = 3e-6, 1e-12, 1e-6
_xla_states = jax.jit(jsv.state_from_angles, static_argnums=(0, 2))


def _angles(c, rows, seed, dtype):
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.uniform(-0.95, 0.95, (rows, c.num_features)), dtype)
    theta = jnp.asarray(rng.uniform(0, np.pi, c.num_parameters), dtype)
    return np.asarray(jsv.angle_matrix(c, X, theta, dtype))


def _op_record(op):
    return (type(op).__name__,) + dataclasses.astuple(op)


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_fused_program_matches_jax(enc, n, layers):
    c = build_circuit(enc, n, 2, layers)
    want = jf.fuse_circuit(c)
    got = tf.fuse_circuit(circuit_from_jax(c))
    assert [_op_record(op) for op in got.ops] == [_op_record(op) for op in want.ops]
    assert (got.n_su2, got.n_rows, got.num_state_sweeps) == (
        want.n_su2, want.n_rows, want.num_state_sweeps)
    np.testing.assert_array_equal(tf.diag_patterns_concat(got),
                                  jf.diag_patterns_concat(want))
    for g_op, w_op in zip(got.ops, want.ops):
        if isinstance(w_op, jf.DiagOp):
            np.testing.assert_array_equal(tf.diag_pattern(g_op, n), jf.diag_pattern(w_op, n))


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_packed_inputs_and_su2_products_match_jax(enc):
    c = build_circuit(enc, 4, 2, 2)
    tc = circuit_from_jax(c)
    a32 = _angles(c, 6, seed=1, dtype=jnp.float32)
    want = np.asarray(jf.packed_inputs(jf.fuse_circuit(c), jnp.asarray(a32)))
    got = tf.packed_inputs(tf.fuse_circuit(tc), torch.tensor(a32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PACKED_ATOL)
    a64 = _angles(c, 6, seed=2, dtype=jnp.float64)
    for g, w in zip(tf.su2_products(tf.fuse_circuit(tc), torch.tensor(a64)),
                    jf.su2_products(jf.fuse_circuit(c), jnp.asarray(a64))):
        assert g.dtype == torch.complex128
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=F64_ATOL)


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_fused_states_match_pallas_fused(enc, n):
    """K4's wrapper on the CPU (the plain fused engine) against the Pallas
    fused kernel in interpret mode and the unfused engine."""
    c = build_circuit(enc, n, 2, 2)
    tc = circuit_from_jax(c)
    a = _angles(c, 7, seed=n, dtype=jnp.float32)
    got = K.states_from_angles_fused(tc, torch.tensor(a))
    assert got.dtype == torch.complex64 and got.shape == (7, 1 << n)
    pallas = np.asarray(make_pallas_states_fused_fn(c, interpret=True)(jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=F32_ATOL)
    unfused = K.states_from_angles(tc, torch.tensor(a))
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=0, atol=F32_ATOL)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_fused_engine_f64_is_exact(enc):
    c = build_circuit(enc, 4, 2, 3)
    a = _angles(c, 5, seed=3, dtype=jnp.float64)
    got = tf.state_from_angles_fused(circuit_from_jax(c), torch.tensor(a))
    assert got.dtype == torch.complex128
    want = np.asarray(_xla_states(c, jnp.asarray(a), jnp.complex128))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_ATOL)
    jax_fused = np.asarray(jf.state_from_angles_fused(c, jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), jax_fused, rtol=0, atol=F64_ATOL)


def test_fused_batch_padding():
    c = build_circuit("hubregtsen", 2, 1, 1)
    a = _angles(c, 130, seed=2, dtype=jnp.float32)
    got = K.states_from_angles_fused(circuit_from_jax(c), torch.tensor(a))
    want = np.asarray(make_pallas_states_fused_fn(c, interpret=True)(jnp.asarray(a)))
    assert got.shape == want.shape == (130, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)


def test_fused_tables_describe_the_program():
    """The op, gate and member tables and the pattern matrix K4 reads
    (csrc/warp_program.cuh), under the states kernels' bit map."""
    tc = circuit_from_jax(build_circuit("chebyshev", 4, 2, 3))
    program = tf.fuse_circuit(tc)
    ops, gates, members, cperm = K.fused_tables(tc, states_layout=True)
    assert ops.shape == (len(program.ops), 6) and ops.dtype == np.int32
    cmat = tf.diag_patterns_concat(program)
    # up to 5 qubits a lane holds the whole sample: [column][register][1]
    np.testing.assert_array_equal(cperm[:, :, 0].T, cmat)
    coef_at, member_at, n_gates = tc.num_gates + members.size, tc.num_gates, 0
    for row, op in zip(ops.tolist(), program.ops):
        if isinstance(op, tf.SU2Op):
            assert row == [0, op.qubit, op.control, n_gates, len(op.gate_idxs),
                           int(op.real) | (int(op.diag) << 1) | ((coef_at + 8 * op.slot) << 2)]
            assert gates[n_gates:n_gates + len(op.gate_idxs)].tolist() == [
                [tc.gates[gi].kind, gi] for gi in op.gate_idxs]
            n_gates += len(op.gate_idxs)
        elif isinstance(op, tf.PermOp):
            assert row == [1, op.qubit, op.control, 0, 0, 0]
        else:
            assert row == [2, 0, -1, member_at, op.K, op.row_start - 8 * program.n_su2]
            assert members[member_at - tc.num_gates:][:op.K].tolist() == [
                gi for _, _, _, gi in op.members]
            member_at += op.K
    assert n_gates == len(gates) and member_at - tc.num_gates == members.size
    assert [op.K for op in program.ops if isinstance(op, tf.DiagOp)] == [4, 4, 4]
    assert cmat.shape == (16, 12) and cperm.shape == (12, 16, 1)
    kyr = tf.fuse_circuit(circuit_from_jax(build_circuit("kyriienko", 6, 1, 1)))
    assert (len(kyr.ops), kyr.n_su2, kyr.n_rows) == (11, 6, 48)
    assert not any(isinstance(op, tf.DiagOp) for op in kyr.ops)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_fusion_enabled_matches_jax(mode, monkeypatch):
    monkeypatch.setattr(jconfig, "use_fusion", mode)
    monkeypatch.setattr(tconfig, "use_fusion", mode)
    for n in [None] + list(range(1, 14)):
        for path in ("features", "states"):
            assert tconfig.fusion_enabled(n, path) == jconfig.fusion_enabled(n, path)
    assert tconfig.FUSION_MIN_QUBITS_FEATURES == jconfig.FUSION_MIN_QUBITS_FEATURES


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_fused_launch_config_fits_at_10_qubits(enc):
    """K4's block (the tables, the pattern matrix C and each warp's staged
    rows; the state is in registers) fits twice in one SM's shared memory for
    every family at the kernels' 10-qubit limit, a warp a sample."""
    tc = circuit_from_jax(build_circuit(enc, 10, 2, 2))
    program = tf.fuse_circuit(tc)
    cmat = tf.diag_patterns_concat(program)
    geo = K.fused_geometry(tc)
    assert geo.c_bytes == 4 * cmat.size and geo.lanes == 32
    assert geo.threads >= 32 and geo.samples == geo.threads // 32
    row = tc.num_gates + (program.n_rows - 8 * program.n_su2) + 8 * program.n_su2
    assert geo.smem_bytes >= geo.c_bytes + geo.samples * 4 * row
    assert 2 * geo.smem_bytes <= 228 * 1024
