"""Torus ops and ADMM updates of the port vs the JAX package (float64)."""

import jax.numpy as jnp
import numpy as np
import torch

from dqgp_tpu import manifold as JM
from dqgp_tpu_torch import manifold as TM


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_wrap_matches_jax_including_subnormals():
    tiny = np.finfo(np.float64).tiny
    x = np.array([0.0, -0.0, 1.0, -1.0, np.pi, -np.pi, 3 * np.pi + 0.1, -7.5,
                  1e-300, -1e-300, tiny, -tiny, 5e-324, -5e-324, -1e-310,
                  1e-310, 2.5e-320, -2.5e-320])
    want = np.asarray(JM.wrap(jnp.asarray(x)))
    got = TM.wrap(_t(x)).numpy()
    # exact: the port flushes subnormals the way XLA's mod sees them
    np.testing.assert_array_equal(got, want)
    assert np.all(got >= 0.0)


def test_wrap_sweep_exact():
    x = np.random.RandomState(0).uniform(-20, 20, 5000)
    np.testing.assert_array_equal(TM.wrap(_t(x)).numpy(),
                                  np.asarray(JM.wrap(jnp.asarray(x))))


def test_round4_half_to_even_exact():
    rng = np.random.RandomState(1)
    halves = (np.arange(-20000, 20000) + 0.5) / 1e4      # .5 boundaries
    x = np.concatenate([halves, halves + 1e-12, halves - 1e-12,
                        rng.uniform(-10, 10, 5000)])
    np.testing.assert_array_equal(TM.round4(_t(x)).numpy(),
                                  np.asarray(JM.round4(jnp.asarray(x))))


def test_circular_mean_and_admm_updates():
    rng = np.random.RandomState(2)
    theta = np.round(rng.rand(4, 9) * 3, 4)
    psi = np.round(rng.rand(4, 9), 4)
    z = np.round(rng.rand(9) * 3, 4)
    grad = np.round(rng.randn(4, 9) * 50, 4)
    rho = L = 100.0
    # The reductions run over 4 agents in both packages; transcendental
    # kernels of XLA and PyTorch may differ in the last ulp, so 1e-14.
    np.testing.assert_allclose(
        TM.circular_mean(_t(theta)).numpy(),
        np.asarray(JM.circular_mean(jnp.asarray(theta))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        TM.admm_update_z(_t(theta), _t(psi), rho).numpy(),
        np.asarray(JM.admm_update_z(jnp.asarray(theta), jnp.asarray(psi), rho)),
        rtol=0, atol=1e-14)
    # elementwise updates: exact
    np.testing.assert_array_equal(
        TM.admm_update_theta(_t(z), _t(grad), _t(psi), rho, L).numpy(),
        np.asarray(JM.admm_update_theta(jnp.asarray(z), jnp.asarray(grad),
                                        jnp.asarray(psi), rho, L)))
    np.testing.assert_array_equal(
        TM.admm_update_psi(_t(psi), _t(theta), _t(z), rho).numpy(),
        np.asarray(JM.admm_update_psi(jnp.asarray(psi), jnp.asarray(theta),
                                      jnp.asarray(z), rho)))
    np.testing.assert_array_equal(
        TM.log_map(_t(z), _t(theta)).numpy(),
        np.asarray(JM.log_map(jnp.asarray(z), jnp.asarray(theta))))
    np.testing.assert_array_equal(TM.np_circular_mean(theta),
                                  JM.np_circular_mean(theta))
    assert TM.np_distance(theta[0], z) == JM.np_distance(theta[0], z)
