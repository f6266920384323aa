"""Torus ops and ADMM updates of the port vs the JAX package (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
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


# --- the rest of the manifold module (dqgp_tpu/manifold.py:58-73, 195-410) ---


def _j(a):
    return jnp.asarray(np.asarray(a, np.float64))


def _same4(got, want):
    """Equal after the reference's 4-decimal rounding, and within float64
    rounding before it (torch.remainder and XLA's mod round alike)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.round(got, 4), np.round(want, 4))


def _pairs(seed=4):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-4, 7, (6, 9))
    y = rng.uniform(-4, 7, (6, 9))
    y[0] = x[0] + np.pi / 2          # exactly half a period apart
    y[1] = x[1]
    return x, y


def test_distance_signed_arc_and_signed_log_map():
    x, y = _pairs()
    _same4(TM.signed_arc(_t(x), _t(y)).numpy(), JM.signed_arc(_j(x), _j(y)))
    _same4(TM.log_map(_t(x), _t(y), signed=True).numpy(), JM.log_map(_j(x), _j(y), signed=True))
    for a, b in zip(x, y):
        _same4(float(TM.distance(_t(a), _t(b))), float(JM.distance(_j(a), _j(b))))
        assert float(TM.distance(_t(a), _t(b))) == pytest.approx(TM.np_distance(a, b), abs=1e-12)
    assert TM.retraction is TM.exp_map


def test_admm_residuals_and_signed_psi_update():
    x, y = _pairs(5)
    z = y[0]
    _same4(float(TM.admm_primal_residual(_t(x), _t(z))),
           float(JM.admm_primal_residual(_j(x), _j(z))))
    _same4(float(TM.admm_dual_residual(_t(x[1]), _t(z))),
           float(JM.admm_dual_residual(_j(x[1]), _j(z))))
    psi = np.round(np.random.RandomState(6).rand(6, 9), 4)
    _same4(TM.admm_update_psi(_t(psi), _t(x), _t(z), 100.0, signed_log=True).numpy(),
           JM.admm_update_psi(_j(psi), _j(x), _j(z), 100.0, signed_log=True))


@pytest.mark.parametrize("method", ["gradient_descent", "momentum", "conjugate_gradient"])
def test_opt_step_sequences_match_jax(method):
    """Five steps of each optimizer from the same start and gradients,
    large and small (both sides of the clip and of the step cap)."""
    rng = np.random.RandomState(7)
    x_t = x_j = rng.uniform(0, np.pi, 9)
    st_t, st_j = TM.opt_init(9), JM.opt_init(9)
    for k in range(5):
        g = rng.randn(9) * (10.0 if k % 2 else 0.05)
        st_t, x_t = TM.opt_step(st_t, _t(x_t), _t(g), method=method)
        st_j, x_j = JM.opt_step(st_j, _j(x_j), _j(g), method=method)
        _same4(x_t.numpy(), x_j)
        _same4(st_t.velocity.numpy(), st_j.velocity)
        _same4(st_t.prev_grad.numpy(), st_j.prev_grad)
        assert int(st_t.iteration) == int(st_j.iteration) == k + 1
        x_t, x_j = x_t.numpy(), np.asarray(x_j)
    with pytest.raises(ValueError, match="Unknown method"):
        TM.opt_step(st_t, _t(x_t), _t(g), method="adam")


@pytest.mark.parametrize("method", ["gradient_descent", "momentum", "conjugate_gradient"])
def test_optimizer_state_lives_on_the_points_device(method):
    """RiemannianOptimizer steps as the JAX package's does, and its state
    lives on the device of the points it is stepped with. The port kept it
    on the CPU whatever the point's device (a fault of the port: momentum
    and conjugate gradient raised on points on the card). The meta device
    stands in for the card here; tests/test_torch_cuda.py steps on the
    card."""
    opt = TM.RiemannianOptimizer(TM.TorusManifold(9), method=method)
    jopt = JM.RiemannianOptimizer(JM.TorusManifold(9), method=method)
    rng = np.random.RandomState(12)
    x_t = x_j = rng.uniform(0, np.pi, 9)
    for k in range(4):
        g = rng.randn(9) * (10.0 if k % 2 else 0.05)
        x_t, x_j = opt.step(_t(x_t), _t(g)), jopt.step(_j(x_j), _j(g))
        _same4(x_t.numpy(), x_j)
        _same4(opt.state.velocity.numpy(), jopt.state.velocity)
        assert all(t.device == x_t.device for t in opt.state)
        assert int(opt.state.iteration) == int(jopt.state.iteration) == k + 1
        x_t, x_j = x_t.numpy(), np.asarray(x_j)
    meta = TM.RiemannianOptimizer(TM.TorusManifold(9), method=method)
    x = torch.zeros(9, dtype=torch.float64, device="meta")
    for _ in range(2):
        x = meta.step(x, torch.ones(9, dtype=torch.float64, device="meta"))
        assert x.device.type == "meta"
        assert all(t.device.type == "meta" for t in meta.state)


def test_clip_and_cap():
    for scale in (1e-3, 0.5, 3.0, 1e3):
        g = np.random.RandomState(8).randn(9) * scale
        _same4(TM._clip_by_norm(_t(g), 1.0).numpy(), JM._clip_by_norm(_j(g), 1.0))
        _same4(TM._cap_step(_t(g), 0.08).numpy(), JM._cap_step(_j(g), 0.08))
    _same4(TM._clip_by_norm(_t(np.zeros(3)), 1.0).numpy(), np.zeros(3))


def test_classes_and_factory_match_jax():
    manifold, opt, admm = TM.create_riemannian_framework(9, learning_rate=0.02, rho=3.0,
                                                         method="momentum")
    jm, jo, ja = JM.create_riemannian_framework(9, learning_rate=0.02, rho=3.0,
                                                method="momentum")
    assert manifold.name == jm.name and manifold.dim == 9 and manifold.period == jm.period
    assert (opt.lr, opt.method, opt.max_step_size) == (jo.lr, jo.method, jo.max_step_size)
    x, y = _pairs(9)
    _same4(manifold.wrap_to_manifold(x).numpy(), jm.wrap_to_manifold(x))
    _same4(float(manifold.distance(x[2], y[2])), float(jm.distance(x[2], y[2])))
    _same4(manifold.exp_map(x, y).numpy(), jm.exp_map(x, y))
    _same4(manifold.retraction(x, y).numpy(), jm.retraction(x, y))
    _same4(manifold.log_map(x, y).numpy(), jm.log_map(x, y))
    _same4(manifold.log_map(x, y, signed=True).numpy(), jm.log_map(x, y, signed=True))
    assert manifold.vector_transport(x, y, None) is y
    assert manifold.riemannian_gradient(x, y) is y
    for k in range(3):
        g = np.random.RandomState(10 + k).randn(9)
        _same4(opt.step(x[0], g).numpy(), jo.step(x[0], g))
    z, psi = y[3], np.round(np.random.RandomState(11).rand(6, 9), 4)
    _same4(admm.update_z(x, psi).numpy(), ja.update_z(x, psi))
    _same4(admm.update_theta(z, y, psi, 100.0, optimizer=opt).numpy(),
           ja.update_theta(z, y, psi, 100.0))
    _same4(admm.update_psi(psi, x, z).numpy(), ja.update_psi(psi, x, z))
    _same4(float(admm.compute_primal_residual(x, z)), float(ja.compute_primal_residual(x, z)))
    _same4(float(admm.compute_dual_residual(x[0], z)), float(ja.compute_dual_residual(x[0], z)))
    assert admm.iteration == ja.iteration == 0


def test_random_point_takes_a_generator():
    """JAX draws from a PRNG key, the port from a torch.Generator: the
    numbers differ, the shape, range and reproducibility hold."""
    m = TM.TorusManifold(7)
    a = m.random_point(torch.Generator().manual_seed(3))
    b = m.random_point(torch.Generator().manual_seed(3))
    assert a.shape == (7,) and a.dtype == torch.float64
    assert bool(torch.all((a >= 0) & (a < m.period)))
    assert torch.equal(a, b)
    assert not torch.equal(a, m.random_point(torch.Generator().manual_seed(4)))
