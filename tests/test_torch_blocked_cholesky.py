"""The Gram-free blocked Cholesky and ``nll_large`` (parallel/blocked.py)
against the JAX package's and numpy's on the CPU, on the same seeded numpy
inputs (tests/test_blocked.py:70-92 and :262-296's problems), and the port's
``examples/scale_out_50k.py`` against the same calls in JAX.

Bars, each stated at its test:

* float64 from the same float64 features: the factor against
  ``np.linalg.cholesky`` rtol 1e-8 / atol 1e-10, logdet and the NLL rtol
  1e-10 (tests/test_blocked.py:85-90); the factor against JAX's atol 1e-12;
* with ``regularization`` (the clip's LOBPCG inside), from the same float64
  features: rtol 3e-5 against JAX's ``nll_large`` and against the dense
  NLL of the regularized Gram (tests/test_blocked.py:286-296);
* float32 (the example's type): the port's float32 NLL within twice JAX's
  own float32-vs-float64 spread of the float64 NLL;
* the example: each side computes its own float32 features (torch's plain
  fused engine vs XLA's), then a float32 CG to cg_tol 1e-5: mean within
  rtol 1e-3 / atol 1e-4 and variance rtol 1e-2 / atol 1e-5 of JAX's (the
  CG bars of PERF.md §2); the float32 NLL within config #7's NLL bar,
  max(1e-4 relative, twice JAX's own float32-vs-float64 spread), of the
  float64 NLL on the port's own features and of JAX's float32 NLL.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.models.kernels.quantum_kernel import kernel_features
from dqgp_tpu.parallel import blocked as JB
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.examples import scale_out_50k
from dqgp_tpu_torch.models.gp.posterior import masked_nll_core
from dqgp_tpu_torch.models.kernels.quantum_kernel import gram_from_features
from dqgp_tpu_torch.models.kernels.quantum_kernel import kernel_features as kernel_features_t
from dqgp_tpu_torch.parallel import blocked as TB


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(kernel_type="projected", outer="gaussian", N=75, seed=5, regularization=None,
             encoding="hubregtsen"):
    """tests/test_blocked.py:15-25's problem: float32 features from JAX, Y."""
    jspec = JaxSpec(circuit=build_circuit(encoding, 3, 2, 1), kernel_type=kernel_type,
                    outer_kernel=outer, regularization=regularization)
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (N, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, jspec.num_parameters), jnp.float32)
    F = np.asarray(kernel_features(jspec, X, theta))
    Y = np.sin(3 * np.asarray(X)[:, 0]) + 0.1 * rng.randn(N)
    return jspec, spec_from_jax(jspec), F, Y


def _dense_nll(K: np.ndarray, y: np.ndarray, sigma2: float) -> float:
    C = K + sigma2 * np.eye(len(y))
    L = np.linalg.cholesky(C)
    w = np.linalg.solve(L, y)
    return np.sum(np.log(np.diag(L))) + 0.5 * w @ w + 0.5 * len(y) * np.log(2 * np.pi)


@pytest.mark.parametrize("kernel_type,outer,encoding", [
    ("projected", "gaussian", "hubregtsen"),
    ("fidelity", "gaussian", "yz_cx"),      # complex features
])
def test_factor_and_nll_match_jax_and_numpy(kernel_type, outer, encoding):
    """N = 75 at block 16 pads to 80: the padded rows are an identity block
    and add nothing to logdet."""
    jspec, spec, F, Y = _problem(kernel_type, outer, encoding=encoding)
    F64 = F.astype(np.complex128 if kernel_type == "fidelity" else np.float64)
    L, logdet = TB.gram_free_blocked_cholesky(spec, torch.tensor(F64), 0.1, jitter=0.0,
                                              block=16, dtype=torch.float64)
    jL, jlogdet = JB.gram_free_blocked_cholesky(jspec, jnp.asarray(F64), 0.1, jitter=0.0,
                                                block=16, dtype=jnp.float64)
    assert L.shape == (80, 80) and L.dtype == torch.float64
    K = gram_from_features(spec, torch.tensor(F64)).numpy()
    C = K + 0.01 * np.eye(75)
    np.testing.assert_allclose(L.numpy()[:75, :75], np.linalg.cholesky(C), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(L.numpy()[75:, 75:], np.eye(5))
    np.testing.assert_array_equal(L.numpy()[75:, :75], 0.0)
    assert float(logdet) == pytest.approx(np.linalg.slogdet(C)[1], rel=1e-10)
    assert float(logdet) == pytest.approx(float(jlogdet), rel=1e-10)

    nll, comps = TB.nll_large(spec, torch.tensor(F64), Y, 0.1, block=16, dtype=torch.float64)
    jnll, jcomps = JB.nll_large(jspec, jnp.asarray(F64), jnp.asarray(Y), 0.1, block=16,
                                dtype=jnp.float64)
    assert float(nll) == pytest.approx(_dense_nll(K, Y, 0.01), rel=1e-10)
    assert float(nll) == pytest.approx(float(jnll), rel=1e-10)
    for k, v in comps.items():
        assert v.dtype == torch.float64
        assert float(v) == pytest.approx(float(jcomps[k]), rel=1e-9)
    # the default jitter (1e-6) sits on the diagonal
    L_j, _ = TB.gram_free_blocked_cholesky(spec, torch.tensor(F64), 0.1, block=16,
                                           dtype=torch.float64)
    np.testing.assert_allclose(L_j.numpy()[:75, :75],
                               np.linalg.cholesky(C + 1e-6 * np.eye(75)), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("method", ["thresholding", "tikhonov"])
def test_nll_large_honors_regularization_like_jax(method):
    """tests/test_blocked.py:262-296's problem (96 rows at block 32, the
    clip built on the unpadded rows) from the same float64 features on both
    sides: with float32 features each side's float32 Gram rounds
    differently (torch's vs XLA's matmul), which alone moves the NLL by
    ~3e-5 relative here, the whole of the bar. rtol 3e-5 against JAX's
    ``nll_large`` and against the dense NLL of the eigh-regularized Gram."""
    jspec, spec, F, Y = _problem(outer="matern", N=96, seed=3, regularization=method)
    F64 = F.astype(np.float64)
    nll, comps = TB.nll_large(spec, torch.tensor(F64), Y, 0.1, block=32, dtype=torch.float64)
    jnll, jcomps = JB.nll_large(jspec, jnp.asarray(F64), jnp.asarray(Y), 0.1, block=32,
                                dtype=jnp.float64)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=3e-5)
    np.testing.assert_allclose(float(comps["log_det_term"]), float(jcomps["log_det_term"]),
                               rtol=3e-5, atol=1e-4)
    K_reg = gram_from_features(spec, torch.tensor(F64))
    res, _ = masked_nll_core(K_reg, torch.tensor(Y), torch.ones(96, dtype=torch.float64), 0.1,
                             compute_cond=False)
    np.testing.assert_allclose(float(nll), float(res.nll), rtol=3e-5)


def test_regularization_term_reaches_the_panels(monkeypatch):
    """On an indefinite operator the clip changes the factor: a projected
    Gram from features whose float32 Gram has a negative eigenvalue is not
    available at this size, so the clip's weights are set by hand on a
    LowRankRegularizer and the panels checked against the dense K_reg."""
    jspec, spec, F, Y = _problem(outer="matern", N=96, seed=3, regularization="thresholding")
    F64 = torch.tensor(F, dtype=torch.float64)
    rng = np.random.RandomState(0)
    V, _ = np.linalg.qr(rng.randn(96, 2))
    reg = TB.LowRankRegularizer(V=torch.tensor(V), w=torch.tensor([0.3, 0.0], dtype=torch.float64),
                                shift=torch.tensor(0.0, dtype=torch.float64),
                                lambda_min=torch.tensor(-0.3, dtype=torch.float64),
                                saturated=torch.tensor(False))
    monkeypatch.setattr(TB, "make_lowrank_regularizer", lambda *a, **k: reg)
    L, _ = TB.gram_free_blocked_cholesky(spec, F64, 0.1, jitter=0.0, block=32,
                                         dtype=torch.float64)
    K = gram_from_features(replace(spec, regularization=None), F64).numpy()
    K_reg = K + 0.3 * np.outer(V[:, 0], V[:, 0]) + 0.01 * np.eye(96)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K_reg), rtol=1e-8, atol=1e-10)


def test_float32_nll_within_twice_jax_spread():
    """The example's float32 type: the port's float32 NLL against the float64
    one, within twice JAX's own float32-vs-float64 spread."""
    jspec, spec, F, Y = _problem(outer="matern", N=75)
    nll32, comps = TB.nll_large(spec, torch.tensor(F), Y.astype(np.float32), 0.1, block=16)
    assert comps["quadratic_term"].dtype == torch.float32
    jnll32, _ = JB.nll_large(jspec, jnp.asarray(F), jnp.asarray(Y, jnp.float32), 0.1, block=16)
    jnll64, _ = JB.nll_large(jspec, jnp.asarray(F), jnp.asarray(Y), 0.1, block=16,
                             dtype=jnp.float64)
    spread = abs(float(jnll32) - float(jnll64))
    assert 0 < abs(float(nll32) - float(jnll64)) <= 2 * spread


def test_failed_panel_makes_logdet_nan():
    """A panel that is not positive definite leaves NaN, as a failed float
    Cholesky does in the JAX package, instead of raising."""
    _, spec, F, _ = _problem(N=40)
    L, logdet = TB.gram_free_blocked_cholesky(spec, torch.tensor(F, dtype=torch.float64),
                                              noise_std=0.0, jitter=-5.0, block=16,
                                              dtype=torch.float64)
    assert np.isnan(float(logdet)) and bool(torch.isnan(L[:16, :16]).all())


def test_scale_out_example_matches_jax():
    """``run(N=300, device="cpu")`` against the JAX package's calls of
    examples/scale_out_50k.py on the same seeded data."""
    got = scale_out_50k.run(300, "cpu", verbose=False)
    N, M = 300, scale_out_50k.M
    jspec = JaxSpec(circuit=build_circuit("chebyshev", num_qubits=10, num_features=2,
                                          num_layers=2),
                    kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.uniform(-0.99, 0.99, (N + M, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, jspec.num_parameters), jnp.float32)
    F = kernel_features(jspec, X, theta)
    F_tr, F_te = F[:N].astype(jnp.float32), F[N:].astype(jnp.float32)
    Y = jnp.asarray(np.sin(3 * np.asarray(X)[:N, 0]) + 0.1 * rng.randn(N), jnp.float32)
    mean, var, res = JB.gp_posterior_large(jspec, F_tr, Y, F_te, noise_std=0.1, block=4096,
                                           cg_tol=1e-5, cg_maxiter=600, precond_rank=256)
    nll, _ = JB.nll_large(jspec, F_tr, Y, noise_std=0.1, block=1024)
    assert got["mean"].dtype == torch.float32 and got["mean"].shape == (M,)
    assert got["cg_converged"] and float(res.residual_norm) <= 1e-5
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(mean), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["var"].numpy(), np.asarray(var), rtol=1e-2, atol=1e-5)
    assert got["n_chol"] == N
    # the float32 NLL against the float64 one on the port's own features,
    # and against JAX's float32 one, within config #7's NLL bar (PERF.md
    # §2): max(1e-4 relative, twice JAX's own float32-vs-float64 spread).
    # A 10-qubit Matérn Gram in float32 moves this NLL by 5e-4 to 8e-4 on
    # either engine; JAX's own spread here is 1e-4, partly cancelled by its
    # float32 Cholesky.
    nll64, _ = JB.nll_large(jspec, F_tr.astype(jnp.float64), Y.astype(jnp.float64),
                            noise_std=0.1, block=1024, dtype=jnp.float64)
    bar = max(1e-4 * abs(float(nll64)), 2 * abs(float(nll) - float(nll64)))
    spec = spec_from_jax(jspec)
    F_own = kernel_features_t(spec, torch.tensor(np.asarray(X)), torch.tensor(np.asarray(theta)))
    own64, _ = TB.nll_large(spec, F_own[:N].double(), torch.tensor(np.asarray(Y)).double(),
                            noise_std=0.1, block=1024, dtype=torch.float64)
    assert abs(got["nll"] - float(own64)) <= bar
    assert abs(got["nll"] - float(nll)) <= bar
