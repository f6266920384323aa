"""The fused Pauli-feature kernel module (K3): its wrapper on the CPU (K3's
plain version: the plain fused engine, then the per-qubit X, Y, Z reduction)
against the Pallas fused kernel in interpret mode and against K1's plain
version, batch padding, the dispatch at 10 qubits with the fusion switch on
"auto", the launch configuration and the input guards.

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
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu.ops.pallas_circuit import make_pallas_pauli_features_fused_fn
from dqgp_tpu_torch import config
from dqgp_tpu_torch.convert import circuit_from_jax, spec_from_jax
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import fusion as tf

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


@pytest.mark.parametrize("n", range(1, K.MAX_QUBITS + 1))
def test_fused_features_launch_config(n):
    """K3's block holds only states, 8 * 2^n bytes a sample, within the
    200 KB budget: 25 threads at 10 qubits (a K4 block takes 8)."""
    tpb, smem = K.fused_features_launch_config(n)
    assert 1 <= tpb <= 128 and smem == tpb * 8 * (1 << n) <= 200 * 1024
    if n == 10:
        assert tpb == 25
        assert K.states_launch_config(10, 260, 4, fixed_bytes=4 * 1024 * 20)[0] == 8


def test_packed_launch_guards():
    c = circuit_from_jax(build_circuit("chebyshev", 3, 2, 1))
    R = tf.fuse_circuit(c).n_rows
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        K.pauli_features_from_packed(c, torch.zeros((4, R)))
    with pytest.raises(NotImplementedError, match="float32 angles"):
        with mock.patch.object(K, "_is_cuda", lambda t: True):
            K.pauli_features_from_angles_fused(c, torch.zeros((4, c.num_gates),
                                                              dtype=torch.float64))
    assert K.pauli_features_from_angles_fused.launches == 0
