"""The Pauli-feature kernel module (K1): its wrapper on the CPU against the
Pallas kernel in interpret mode and the JAX XLA engine, its launch counter,
and the guards that keep unsupported requests off the card.

The CUDA kernel itself cannot run here; tests/test_torch_cuda.py and
chip_smoke.py hold it to the plain version on the card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu.ops.pallas_circuit import make_pallas_pauli_features_fn
from dqgp_tpu_torch.convert import circuit_from_jax, spec_from_jax
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.ops import _build
from dqgp_tpu_torch.ops import cuda_circuit as K1
from dqgp_tpu_torch.ops.circuit import Circuit, Gate, RY

ATOL = 5e-6  # float32 features, as tests/test_pallas_circuit.py holds them


def _angles(c, n_rows, seed):
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.uniform(-0.95, 0.95, (n_rows, c.num_features)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, c.num_parameters), jnp.float32)
    return jsv.angle_matrix(c, X, theta)


@pytest.mark.parametrize("enc,n,layers,rows", [
    ("chebyshev", 4, 1, 5), ("hubregtsen", 3, 1, 130), ("yz_cx", 3, 2, 6)])
def test_wrapper_matches_pallas_interpret(enc, n, layers, rows):
    c = build_circuit(enc, n, 2, layers)
    a = _angles(c, rows, seed=n + layers)
    want = np.asarray(make_pallas_pauli_features_fn(c, interpret=True)(a))
    before = K1.pauli_features_from_angles.launches
    got = K1.pauli_features_from_angles(circuit_from_jax(c), torch.tensor(np.asarray(a)))
    assert got.shape == (rows, 3 * n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the CPU path is the plain version: no kernel launch is counted
    assert K1.pauli_features_from_angles.launches == before == 0


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_wrapper_matches_xla_engine(enc):
    c = build_circuit(enc, 4, 2, 2)
    a = _angles(c, 9, seed=1)
    want = np.asarray(jsv.pauli_features(jsv.state_from_angles(c, a), 4))
    got = K1.pauli_features_from_angles(circuit_from_jax(c), torch.tensor(np.asarray(a)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_features_dispatch_blocks_and_order():
    c = build_circuit("kyriienko", 3, 2, 1)
    spec = JaxSpec(circuit=c, kernel_type="projected", measurement="ZX")
    a = _angles(c, 4, seed=2)
    full = K1.pauli_features_from_angles(circuit_from_jax(c), torch.tensor(np.asarray(a)))
    got = TQ.features_from_angles(spec_from_jax(spec), torch.tensor(np.asarray(a)))
    np.testing.assert_array_equal(got.numpy(), torch.cat([full[:, 6:], full[:, :3]], 1).numpy())


@pytest.fixture
def fake_cuda(monkeypatch):
    """Make the dispatch and the wrapper take their CUDA branch for CPU
    tensors, so their guards are checked without a card. Building or
    loading the kernel would fail here, so any guard that lets a request
    through shows up as a build error instead of the expected exception."""
    monkeypatch.setattr(K1, "_is_cuda", lambda t: True)

    def no_build(*a, **k):
        raise AssertionError("a guard let the request reach the kernel build")

    monkeypatch.setattr(_build, "load", no_build)


def test_cuda_float64_request_raises(fake_cuda):
    """float64 requests go to K1's and K2's float64 instantiations: on the
    card they reach the kernel build (which the fixture refuses) instead of
    raising NotImplementedError. A dtype no kernel takes raises."""
    c = build_circuit("chebyshev", 2, 2, 1)
    a64 = torch.zeros((3, c.num_gates), dtype=torch.float64)
    for kernel_type in ("projected", "fidelity"):
        spec = spec_from_jax(JaxSpec(circuit=c, kernel_type=kernel_type))
        with pytest.raises(AssertionError, match="reach the kernel build"):
            TQ.features_from_angles(spec, a64)
    with pytest.raises(NotImplementedError, match="float16"):
        K1.pauli_features_from_angles(circuit_from_jax(c), a64.half())
    with pytest.raises(NotImplementedError, match="float32 angles"):
        K1.states_from_angles_fused(circuit_from_jax(c), a64)
    assert K1.launch_counts() == dict.fromkeys(K1.launch_counts(), 0)


def test_cuda_fidelity_and_pauli_strings_raise(fake_cuda, monkeypatch):
    """Fidelity states and full Pauli strings go to K2 (K4 with fusion on),
    per-qubit projected features to K1 (K3 with fusion on): each reaches its
    kernel's build."""
    from dqgp_tpu_torch import config

    c = build_circuit("yz_cx", 2, 2, 1)
    a = torch.zeros((3, c.num_gates), dtype=torch.float32)
    for mode, source in (("off", K1.STATES_SOURCE), ("on", K1.FUSED_SOURCE)):
        monkeypatch.setattr(config, "use_fusion", mode)
        for spec in (JaxSpec(circuit=c, kernel_type="fidelity"),
                     JaxSpec(circuit=c, kernel_type="projected",
                             measurement=("XZ", "YY"))):
            with pytest.raises(AssertionError, match="reach the kernel build") as e:
                TQ.features_from_angles(spec_from_jax(spec), a)
            assert e.traceback[-1].locals["a"] == (source,)
    for mode, source in (("off", K1.SOURCE), ("on", K1.FEATURES_FUSED_SOURCE)):
        monkeypatch.setattr(config, "use_fusion", mode)
        with pytest.raises(AssertionError, match="reach the kernel build") as e:
            TQ.features_from_angles(
                spec_from_jax(JaxSpec(circuit=c, kernel_type="projected")), a)
        assert e.traceback[-1].locals["a"] == (source,)


def test_cuda_wrapper_validates_inputs(fake_cuda):
    c = circuit_from_jax(build_circuit("hubregtsen", 2, 2, 1))
    with pytest.raises(ValueError, match="angles must be"):
        K1.pauli_features_from_angles(c, torch.zeros((3, c.num_gates + 1)))
    with pytest.raises(ValueError, match="contiguous"):
        K1.pauli_features_from_angles(c, torch.zeros((c.num_gates, 3)).T)
    big = Circuit(13, 1, 1, (Gate(RY, 12, pidx=0, pc=1.0),))
    with pytest.raises(ValueError, match="1 to 12 qubits"):
        K1.pauli_features_from_angles(big, torch.zeros((2, 1)))
    assert K1.pauli_features_from_angles.launches == 0


@pytest.mark.parametrize("n", range(1, K1.ONE_WARP_QUBITS + 1))
def test_launch_config_fits_shared_memory(n):
    """The float64 kernel's block (its float32 twin keeps no state in shared
    memory: tests/test_torch_states_warp.py::test_features_warp_geometry)."""
    for G in (1, 40, 400):
        tpb, gstride, smem = K1.launch_config(n, G)
        assert tpb >= 1 and gstride % 2 == 1 and gstride >= G
        assert smem == tpb * (16 * (1 << n) + 8 * gstride) <= 227 * 1024
    assert K1.launch_config(4, 40)[0] == 128
    assert K1.launch_config(10, 70)[0] == 8


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    script = tmp_path / "fake_nvcc"
    script.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\nexit 2\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        _build.build(K1.SOURCE)
    assert not list((tmp_path / "build").glob("*.so"))
