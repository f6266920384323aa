"""The fused Pauli-feature kernel module (K3): its wrapper on the CPU (K3's
plain version: the plain fused engine, then the per-qubit X, Y, Z reduction)
against the Pallas fused kernel in interpret mode and against K1's plain
version, batch padding, the dispatch at 10 qubits with the fusion switch on
"auto", the launch geometry, the tables from which the kernel builds its
coefficients (walked in plain torch against the packed rows) and the input
guards.

Bar (tests/test_fusion.py:63): fused float32 features within 8e-6 of the
Pallas fused kernel and of the unfused engine. The CUDA kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py phase 10).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.models.kernels.quantum_kernel import features_from_angles as jax_features
from dqgp_tpu.ops import fusion as jf
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu.ops.pallas_circuit import make_pallas_pauli_features_fused_fn
from dqgp_tpu_torch import config
from dqgp_tpu_torch.convert import circuit_from_jax, spec_from_jax
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import fusion as tf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 8e-6


def _angles(c, rows, seed):
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.uniform(-0.95, 0.95, (rows, c.num_features)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, c.num_parameters), jnp.float32)
    return np.asarray(jsv.angle_matrix(c, X, theta))


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_fused_features_match_pallas_fused(enc, n):
    """K3's wrapper on the CPU against the Pallas fused kernel in interpret
    mode and against K1's plain (unfused) version."""
    c = build_circuit(enc, n, 2, 2)
    tc = circuit_from_jax(c)
    a = _angles(c, 7, seed=n)
    got = K.pauli_features_from_angles_fused(tc, torch.tensor(a))
    assert got.dtype == torch.float32 and got.shape == (7, 3 * n)
    pallas = np.asarray(make_pallas_pauli_features_fused_fn(c, interpret=True)(jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)
    unfused = K.pauli_features_reference(tc, torch.tensor(a))
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=0, atol=ATOL)
    # the CPU path is the plain version: no kernel launch is counted
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


def test_fused_features_batch_padding():
    c = build_circuit("hubregtsen", 2, 1, 1)
    a = _angles(c, 130, seed=2)
    got = K.pauli_features_from_angles_fused(circuit_from_jax(c), torch.tensor(a))
    want = np.asarray(make_pallas_pauli_features_fused_fn(c, interpret=True)(jnp.asarray(a)))
    assert got.shape == want.shape == (130, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_reference_is_the_plain_fused_engine():
    tc = circuit_from_jax(build_circuit("chebyshev", 4, 2, 2))
    a = torch.tensor(_angles(build_circuit("chebyshev", 4, 2, 2), 5, seed=3))
    want = K.pauli_features(tf.state_from_angles_fused(tc, a, torch.complex64), 4)
    np.testing.assert_array_equal(K.pauli_features_fused_reference(tc, a).numpy(),
                                  want.numpy())


def test_dispatch_at_10_qubits_takes_k3(monkeypatch):
    """Config #7's circuit (chebyshev 10 qubits, 2 layers: G=70, 32 fused
    ops, R=260, C (1024, 20)): with the switch on "auto", projected features
    go through K3's wrapper and agree with the JAX package's features."""
    monkeypatch.setattr(config, "use_fusion", "auto")
    c = build_circuit("chebyshev", 10, 2, 2)
    jspec = JaxSpec(circuit=c, kernel_type="projected", outer_kernel="matern")
    spec = spec_from_jax(jspec)
    program = tf.fuse_circuit(spec.circuit)
    assert (c.num_gates, len(program.ops), program.n_su2, program.n_rows) == (70, 32, 30, 260)
    assert tf.diag_patterns_concat(program).shape == (1024, 20)
    a = _angles(c, 5, seed=4)
    with mock.patch.object(TQ, "pauli_features_from_angles_fused",
                           wraps=K.pauli_features_from_angles_fused) as k3, \
            mock.patch.object(TQ, "pauli_features_from_angles",
                              wraps=K.pauli_features_from_angles) as k1:
        got = TQ.features_from_angles(spec, torch.tensor(a))
        TQ.features_from_angles(spec, torch.tensor(a, dtype=torch.float64))
    # float32 takes K3, float64 K1's float64 instantiation (fusion is f32 only)
    assert (k3.call_count, k1.call_count) == (1, 1)
    assert k1.call_args.args[1].dtype == torch.float64
    want = np.asarray(jax_features(jspec, jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    monkeypatch.setattr(config, "use_fusion", "off")
    with mock.patch.object(TQ, "pauli_features_from_angles_fused") as k3:
        TQ.features_from_angles(spec, torch.tensor(a))
    assert k3.call_count == 0


@pytest.mark.parametrize("n", range(1, K.ONE_WARP_QUBITS + 1))
def test_fused_features_launch_config(n):
    """K3's geometry: a sample's state in registers over max(1, 2^(n-5))
    lanes, so a block works on threads / lanes samples and holds no state in
    shared memory, only its tables, C and each warp's staged rows (angles,
    phase-run members and, where a sample spans lanes, its SU2
    coefficients), within the budget that lets two blocks share an SM."""
    c = circuit_from_jax(build_circuit("chebyshev", n, 2, 2))
    ops, gates, members, cperm = K.fused_tables(c)
    geo = K.fused_geometry(c)
    lanes = max(1, 2 ** (n - 5))
    assert geo.lanes == lanes and geo.samples == geo.threads // lanes
    assert geo.c_bytes == 4 * (1 << n) * cperm.shape[0] == cperm.nbytes
    coef = 8 * tf.fuse_circuit(c).n_su2 if lanes > 1 else 0
    row = (c.num_gates + members.size + coef) | 1  # angles, members, coefficients
    per_warp = 4 * ((32 // lanes) * row + 1)  # rows, and the warp's group index
    table = 4 * ((ops.size + gates.size + members.size + 2 + 3) // 4 * 4)
    assert geo.smem_bytes == table + geo.c_bytes + geo.threads // 32 * per_warp
    assert geo.threads in (32, 64, 128, 256) and 2 * geo.smem_bytes <= 228 * 1024
    if n == 10:  # config #7's circuit: C (1024, 20) is 80 KB, a warp a sample
        assert (geo.threads, geo.c_bytes, geo.samples) == (256, 81920, 8)


def _walk_fused_tables(tc, a: torch.Tensor) -> torch.Tensor:
    """The packed rows K3 forms inside itself, by a plain torch walk of the
    tables it consumes: each SU2 op's 2x2 from its gate list, from the
    identity with each new gate on the left, into its slot (from its row
    offset); then each DiagOp's member angles (pi for a CZ)."""
    ops, gates, members, _ = K.fused_tables(tc)
    B = a.shape[0]
    one = torch.ones((B,), dtype=torch.complex64)
    zero = torch.zeros((B,), dtype=torch.complex64)
    coef_at = tc.num_gates + members.size
    su2, diag = {}, []
    for typ, _, _, first, count, aux in ops.tolist():
        if typ == 0:
            u00, u01, u10, u11 = one, zero, zero, one
            for kind, gi in gates[first:first + count].tolist():
                half = 0.5 * a[:, gi]
                g00, g01, g10, g11 = tf._gate_matrix_entries(kind, torch.cos(half),
                                                             torch.sin(half))
                u00, u01, u10, u11 = (g00 * u00 + g01 * u10, g00 * u01 + g01 * u11,
                                      g10 * u00 + g11 * u10, g10 * u01 + g11 * u11)
            su2[((aux >> 2) - coef_at) // 8] = torch.stack([u00.real, u00.imag, u01.real, u01.imag,
                                         u10.real, u10.imag, u11.real, u11.imag], dim=1)
        elif typ == 2:
            at = first - tc.num_gates  # the member angles' row offsets
            diag += [a[:, gi] if gi >= 0 else torch.full((B,), np.pi, dtype=a.dtype)
                     for gi in members[at:at + count].tolist()]
    assert sorted(su2) == list(range(len(su2)))
    return torch.cat([su2[k] for k in range(len(su2))]
                     + ([torch.stack(diag, dim=1)] if diag else []), dim=1)


@pytest.mark.parametrize("n", [1, 3, 5, 6, 10])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_k3_tables_rebuild_the_packed_rows(enc, n):
    """K3 builds its coefficients from its tables: walked in plain torch,
    they give fusion.packed_inputs bit for bit and the JAX package's packed
    rows within 1e-6 (tests/test_torch_fusion.py's bar); C is held permuted
    [column][register][lane] and the op table follows the program."""
    c = build_circuit(enc, n, 2, 2)
    tc = circuit_from_jax(c)
    program = tf.fuse_circuit(tc)
    a = _angles(c, 9, seed=10 + n)
    got = _walk_fused_tables(tc, torch.tensor(a))
    want = tf.packed_inputs(program, torch.tensor(a))
    assert got.dtype == want.dtype == torch.float32 and got.shape == (9, program.n_rows)
    assert torch.equal(got, want)
    jwant = np.asarray(jf.packed_inputs(jf.fuse_circuit(c), jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=0, atol=1e-6)
    ops, gates, members, cperm = K.fused_tables(tc)
    assert len(ops) == len(program.ops)
    lanes = max(1, 2 ** (n - 5))
    cmat = tf.diag_patterns_concat(program)
    np.testing.assert_array_equal(
        cperm.transpose(2, 1, 0).reshape(cmat.shape), cmat)
    if (enc, n) == ("chebyshev", 10):  # config #7's program
        assert (program.n_su2, program.n_rows, cperm.shape) == (30, 260, (20, 32, 32))
        assert len(gates) + len(members) == c.num_gates == 70
    assert cperm.shape[2] == lanes


def test_k3_launch_guards():
    """K3 takes contiguous float32 (B, G) angles: other dtypes, shapes and
    layouts raise before any launch (as they would on the card)."""
    c = circuit_from_jax(build_circuit("chebyshev", 3, 2, 1))
    with mock.patch.object(K, "_is_cuda", lambda t: True):
        with pytest.raises(NotImplementedError, match="float32 angles"):
            K.pauli_features_from_angles_fused(c, torch.zeros((4, c.num_gates),
                                                              dtype=torch.float64))
        with pytest.raises(ValueError, match=f"angles must be \\(B, {c.num_gates}\\)"):
            K.pauli_features_from_angles_fused(c, torch.zeros((4, c.num_gates + 1)))
        with pytest.raises(ValueError, match="contiguous"):
            K.pauli_features_from_angles_fused(c, torch.zeros((c.num_gates, 4)).t())
    assert K.pauli_features_from_angles_fused.launches == 0
