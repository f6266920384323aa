"""The port's data generators and held-out split against the JAX package's
and sklearn's, on the same seeds.

X, theta* and the classical generators are numpy on both sides: exact. Y of
the quantum-GP dataset comes from a float64 Gram built by two engines (the
port's states path against JAX's complex128 XLA engine) and a host Cholesky:
1e-8.
"""

import numpy as np
import pytest
from sklearn.model_selection import train_test_split

from dqgp_tpu.data import synthetic as jsyn
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.data import (
    generate_data_numpy,
    generate_quantum_gp_data,
    train_test_split_np,
)

Y_ATOL = 1e-8


@pytest.mark.parametrize("enc,n,d,kernel_type,N,kw", [
    ("kyriienko", 3, 1, "fidelity", 60, {}),
    ("kyriienko", 6, 1, "fidelity", 120, {"noise_std": 0.05}),
    ("chebyshev", 3, 2, "projected", 50, {"data_range": (-1.5, 1.5)}),
    ("hubregtsen", 2, 2, "projected", 40, {"kernel_params": np.linspace(0.1, 2.0, 4)}),
    ("yz_cx", 2, 1, "fidelity", 30, {"param_seed": 7}),
])
def test_quantum_gp_data_matches_jax(enc, n, d, kernel_type, N, kw):
    c = build_circuit(enc, n, d, 1)
    jspec = JaxSpec(circuit=c, kernel_type=kernel_type,
                    outer_kernel="matern" if kernel_type == "projected" else "gaussian")
    if "kernel_params" in kw:
        kw = dict(kw, kernel_params=kw["kernel_params"][:c.num_parameters])
    Xj, Yj, thj = jsyn.generate_quantum_gp_data(N, d, jspec, data_seed=3, **kw)
    Xt, Yt, tht = generate_quantum_gp_data(N, d, spec_from_jax(jspec), data_seed=3,
                                           device="cpu", **kw)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(tht, thj)
    np.testing.assert_allclose(Yt, Yj, rtol=0, atol=Y_ATOL)
    if c.requires_clipping:
        assert np.abs(Xt).max() <= 0.99


def test_quantum_gp_data_validates():
    spec = spec_from_jax(JaxSpec(circuit=build_circuit("kyriienko", 2, 1, 1)))
    with pytest.raises(ValueError, match="num_features"):
        generate_quantum_gp_data(10, 2, spec, data_seed=0, device="cpu")
    with pytest.raises(ValueError, match="Expected"):
        generate_quantum_gp_data(10, 1, spec, kernel_params=[0.1], data_seed=0,
                                 device="cpu")
    with pytest.raises(ValueError, match="gram_dtype"):
        generate_quantum_gp_data(10, 1, spec, data_seed=0, gram_dtype="bf16",
                                 device="cpu")
    X32, _, th32 = generate_quantum_gp_data(10, 1, spec, data_seed=0,
                                            gram_dtype="float32", device="cpu")
    X64, _, th64 = generate_quantum_gp_data(10, 1, spec, data_seed=0, device="cpu")
    np.testing.assert_array_equal(X32, X64)
    np.testing.assert_array_equal(th32, th64)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_generate_data_numpy_matches_jax(d):
    Xj, Yj = jsyn.generate_data_numpy(40, d, 0.1, data_seed=5)
    Xt, Yt = generate_data_numpy(40, d, 0.1, data_seed=5)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(Yt, Yj)


@pytest.mark.parametrize("n,test_size,seed", [
    (1000, 0.1, 42), (67, 0.1, 42), (10, 0.25, 0), (333, 0.3, 7), (2, 0.5, 1)])
def test_train_test_split_np_matches_sklearn(n, test_size, seed):
    rng = np.random.RandomState(n)
    X = rng.randn(n, 2)
    Y = rng.randn(n)
    want = train_test_split(X, Y, np.arange(n), test_size=test_size,
                            random_state=seed, shuffle=True)
    got = train_test_split_np(X, Y, test_size, seed)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_test_split_np_validates():
    X, Y = np.zeros((4, 1)), np.zeros(4)
    for bad in (0.0, 1.0, -0.1, 1.5):
        with pytest.raises(ValueError):
            train_test_split_np(X, Y, bad, 0)
    with pytest.raises(ValueError, match="no training"):
        train_test_split_np(X, Y, 0.99, 0)
    assert len(train_test_split_np(X, Y, 0.5, 0)[0]) == 2
