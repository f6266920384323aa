"""The port's RiemannianAgent against the JAX package's on the CPU: one
``train_and_update`` round from the same shard, z and psi, for the
parameter-shift (central) and the PennyLane-style (autodiff) gradient, and
the bounded step cache keyed as ``dqgp_tpu/agent.py:33-53`` keys it.

Bars as tests/test_torch_consensus.py's: float32 features differ in the last
ulp between the two engines, so theta may flip one 4-dp digit (psi rho
times that), NLL components at rtol 1e-4, condition numbers of the
float32-built Gram at rtol 1e-2.
"""

import numpy as np
import pytest

from dqgp_tpu import agent as JA
from dqgp_tpu_torch import agent as TA


def _shard(seed=0, n=12):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-0.9, 0.9, (n, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(n)
    return X, Y, rng


@pytest.mark.parametrize("kernel_type,use_shift", [("projected", True), ("projected", False),
                                                   ("fidelity", True)])
def test_train_and_update_matches_jax(kernel_type, use_shift):
    X, Y, rng = _shard()
    kw = dict(num_qubits=2, noise_std=0.1, rho=100.0, L=100.0, num_layers=1,
              encoding_type="chebyshev", kernel_type=kernel_type, outer_kernel="gaussian",
              use_parameter_shift=use_shift)
    ja = JA.RiemannianAgent(0, X, Y, **kw)
    ta = TA.RiemannianAgent(0, X, Y, device="cpu", **kw)
    assert ta.grad_method == ja.grad_method == ("central" if use_shift else "autodiff")
    P = ja.spec.num_parameters
    z = rng.uniform(0.1, np.pi - 0.1, P).round(4)
    psi = rng.rand(P).round(4)
    want = ja.train_and_update(z, psi)
    got = ta.train_and_update(z, psi)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 + 1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-2)
    assert isinstance(got[2], float) and isinstance(got[3], float)
    for k in ("log_det_term", "quadratic_term", "constant_term", "total"):
        np.testing.assert_allclose(got[4][k], want[4][k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-6)
    if want[3] < 1e7:
        np.testing.assert_allclose(got[3], want[3], rtol=1e-2)
    else:
        # past ~1e7 a float32-built Gram only floors cond: the reference's
        # bucket is what holds (Good < 1e12 <= Moderate < 1e15 <= Poor)
        assert (got[3] < 1e12) == (want[3] < 1e12) and (got[3] < 1e15) == (want[3] < 1e15)
    # the framework the reference sets up on the first round
    assert ta.manifold.dim == P and ta.riemannian_admm.rho == 100.0
    assert ta.riemannian_optimizer.method == "gradient_descent"


def test_a_second_round_continues_from_the_first():
    """Round 2 from round 1's (JAX) outputs. Both agents get the same inputs:
    a 4-dp flip of theta next to z moves the unsigned log map by a whole
    period, hence psi by rho*pi (the reference's quirk), so feeding each
    agent its own round-1 psi would compare two different problems."""
    X, Y, rng = _shard(seed=3)
    kw = dict(num_qubits=2, noise_std=0.1, rho=100.0, L=100.0, num_layers=1,
              encoding_type="chebyshev", kernel_type="projected")
    ja = JA.RiemannianAgent(1, X, Y, **kw)
    ta = TA.RiemannianAgent(1, X, Y, device="cpu", **kw)
    z = rng.uniform(0.1, np.pi - 0.1, ja.spec.num_parameters).round(4)
    jt, jp, *_ = ja.train_and_update(z, np.zeros_like(z))
    ta.train_and_update(z, np.zeros_like(z))
    z2 = np.round((z + jt) / 2, 4)
    want = ja.train_and_update(z2, jp)
    got = ta.train_and_update(z2, jp)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 + 1e-12)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)


def test_step_cache_is_shared_keyed_and_bounded(monkeypatch):
    monkeypatch.setattr(TA, "_step_cache", {})
    X, Y, _ = _shard()
    kw = dict(num_qubits=2, noise_std=0.1, rho=100.0, L=100.0, num_layers=1,
              encoding_type="chebyshev", kernel_type="projected")
    a = TA.RiemannianAgent(0, X, Y, device="cpu", **kw)
    b = TA.RiemannianAgent(1, X[:6], Y[:6], device="cpu", **kw)
    assert a._step is b._step and len(TA._step_cache) == 1
    c = TA.RiemannianAgent(2, X, Y, device="cpu", **dict(kw, rho=50.0))
    assert c._step is not a._step and len(TA._step_cache) == 2
    for i in range(40):
        TA._get_agent_step(a.spec, 1.0 + i, 100.0, 0.1, np.pi / 8, True, "central")
    assert len(TA._step_cache) == TA._STEP_CACHE_SIZE
    assert (a.spec, 100.0, 100.0, 0.1, float(np.pi / 8), True, "central") not in TA._step_cache


def test_device_is_required():
    X, Y, _ = _shard()
    with pytest.raises(TypeError):
        TA.RiemannianAgent(0, X, Y, num_qubits=2, noise_std=0.1, rho=100.0, L=100.0)
