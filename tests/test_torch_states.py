"""The states kernel module (K2) and the float64 Pauli-feature path: the
port's wrappers on the CPU against the Pallas states kernel in interpret
mode and the JAX XLA engine, the full Pauli-string features, and the
facade's precision default.

complex64 states are held at 2e-6 (tests/test_pallas_circuit.py's bar),
complex128 states and float64 features at 1e-12 (tests/test_native.py's).
The CUDA kernels themselves cannot run here; tests/test_torch_cuda.py and
chip_smoke.py hold them to the plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.models.kernels import quantum_kernel as JQ
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu.ops.pallas_circuit import make_pallas_states_fn
from dqgp_tpu_torch.convert import circuit_from_jax, spec_from_jax
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import statevector as tsv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

C64_ATOL, F64_ATOL = 2e-6, 1e-12
# one XLA program per circuit instead of one dispatch per gate
_xla_states = jax.jit(jsv.state_from_angles, static_argnums=(0, 2))


def _inputs(c, rows, seed, dtype):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-0.95, 0.95, (rows, c.num_features))
    theta = rng.uniform(0, np.pi, c.num_parameters)
    return X, theta, np.asarray(jsv.angle_matrix(c, jnp.asarray(X, dtype),
                                                 jnp.asarray(theta, dtype), dtype))


@pytest.mark.parametrize("n", [2, 4, 6])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_states_f32_match_pallas_and_xla(enc, n):
    c = build_circuit(enc, n, 2, 1)
    _, _, a = _inputs(c, 5, seed=n, dtype=jnp.float32)
    got = K.states_from_angles(circuit_from_jax(c), torch.tensor(a))
    assert got.shape == (5, 1 << n) and got.dtype == torch.complex64
    pallas = np.asarray(make_pallas_states_fn(c, interpret=True)(jnp.asarray(a)))
    xla = np.asarray(_xla_states(c, jnp.asarray(a), jnp.complex64))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=C64_ATOL)
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=C64_ATOL)


@pytest.mark.parametrize("n", [2, 4, 6])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_states_f64_match_xla_c128(enc, n):
    c = build_circuit(enc, n, 2, 1)
    _, _, a = _inputs(c, 7, seed=10 + n, dtype=jnp.float64)
    got = K.states_from_angles(circuit_from_jax(c), torch.tensor(a))
    assert got.dtype == torch.complex128
    want = np.asarray(_xla_states(c, jnp.asarray(a), jnp.complex128))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_ATOL)
    # K1's float64 path on the same angles
    feats = K.pauli_features_from_angles(circuit_from_jax(c), torch.tensor(a))
    assert feats.dtype == torch.float64
    np.testing.assert_allclose(feats.numpy(), np.asarray(jsv.pauli_features(want, n)),
                               rtol=0, atol=F64_ATOL)


@pytest.mark.parametrize("rows", [1, 130, 257])
def test_states_batch_padding(rows):
    """Batches off the Pallas kernel's 128-lane tile: 1, one past it, two past."""
    c = build_circuit("hubregtsen", 3, 2, 1)
    _, _, a = _inputs(c, rows, seed=rows, dtype=jnp.float32)
    got = K.states_from_angles(circuit_from_jax(c), torch.tensor(a))
    want = np.asarray(make_pallas_states_fn(c, interpret=True)(jnp.asarray(a)))
    assert got.shape == want.shape == (rows, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=C64_ATOL)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_batched_states_matches_jax(cdtype):
    c = build_circuit("kyriienko", 4, 1, 2)
    X, theta, _ = _inputs(c, 6, seed=3, dtype=jnp.float64)
    jdt = jnp.complex64 if cdtype == torch.complex64 else jnp.complex128
    want = np.asarray(jsv.batched_states(c, jnp.asarray(X), jnp.asarray(theta), jdt))
    got = tsv.batched_states(circuit_from_jax(c), torch.tensor(X), torch.tensor(theta),
                             cdtype)
    assert got.dtype == cdtype
    atol = C64_ATOL if cdtype == torch.complex64 else F64_ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("kernel_type,measurement", [
    ("fidelity", "XYZ"), ("projected", ("XZI", "YYX", "IIZ"))])
def test_features_match_jax_dispatch(kernel_type, measurement, dtype):
    """Fidelity states and full Pauli-string features through the port's
    dispatch (K2's path) against the JAX package's on the same angles."""
    c = build_circuit("yz_cx", 3, 2, 2)
    jspec = JaxSpec(circuit=c, kernel_type=kernel_type, measurement=measurement)
    _, _, a = _inputs(c, 9, seed=4, dtype=dtype)
    want = np.asarray(JQ.features_from_angles(jspec, jnp.asarray(a)))
    got = TQ.features_from_angles(spec_from_jax(jspec), torch.tensor(a)).numpy()
    assert got.dtype == want.dtype
    atol = F64_ATOL if dtype == jnp.float64 else C64_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_facade_auto_is_float64(device):
    """dtype="auto" is float64 on every device, as the JAX facade resolves
    it wherever complex128 is native (CPU and GPU)."""
    c = build_circuit("kyriienko", 2, 1, 1)
    qk = TQ.QuantumKernel(spec_from_jax(JaxSpec(circuit=c)), device)
    assert qk.dtype == torch.float64
    assert TQ.QuantumKernel(spec_from_jax(JaxSpec(circuit=c)), device,
                            dtype="float32").dtype == torch.float32


def test_facade_fidelity_gram_matches_jax():
    c = build_circuit("kyriienko", 3, 1, 1)
    qk = TQ.create_quantum_kernel(3, 1, 1, encoding_type="kyriienko",
                                  kernel_type="fidelity", device="cpu")
    X, theta, _ = _inputs(c, 8, seed=5, dtype=jnp.float64)
    qk.assign_parameters(theta)
    want = np.asarray(JQ.gram(JaxSpec(circuit=c, kernel_type="fidelity"),
                              jnp.asarray(X), jnp.asarray(theta), dtype=jnp.float64))
    np.testing.assert_allclose(qk.evaluate(X), want, rtol=0, atol=F64_ATOL)
