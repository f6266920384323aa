"""The port's "autodiff" gradient against the JAX package's on the CPU.

The JAX package differentiates the NLL at wrap(z) through its XLA
statevector engine and the Cholesky solve with ``jax.value_and_grad``
(consensus.py:145-160); the port does the same through its plain engine
with ``torch.autograd``. Both build the Gram from float32 features, whose
last ulps differ between the two engines; the NLL solve amplifies that, so
the gradients are held at 1e-4 of their largest component (measured 5e-6 to
1e-4 over seeds and kernels on these sizes) and the NLLs at rtol 5e-5
(measured up to 3.4e-5). Against the exact gradient (JAX's jacfwd of a
float64 Gram, as tests/test_autodiff_grad.py forms it) autodiff must beat
the h=pi/8 central difference.

JAX runs on one device here (``n_mesh_devices=1``): on a multi-device
agents mesh its autodiff gradient is the SUM of the mesh's agents'
gradients (the cotangent of the replicated z is reduced across the mesh),
a fault of the reference on meshes that the port does not reproduce.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu import driver as JD
from dqgp_tpu.data import split_data_numpy
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.gp.posterior import masked_nll_and_grad as jax_nll
from dqgp_tpu.models.kernels import QuantumKernelSpec, gram as jax_gram
from dqgp_tpu.parallel.consensus import make_admm_step as jax_step, make_agent_batch as jax_batch
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch import manifold as TM
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.parallel import consensus as TC

GRAD_RTOL = 1e-4


def _problem(kernel_type="projected", seed=1):
    if kernel_type == "projected":
        spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 3, 2, 1),
                                 kernel_type="projected", outer_kernel="matern")
    else:
        spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 2, 2, 1),
                                 kernel_type="fidelity")
    rng = np.random.RandomState(seed)
    splits = []
    for n in (14, 11, 12):
        X = rng.uniform(-0.9, 0.9, (n, 2))
        splits.append((X, np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(n)))
    z = rng.uniform(0.2, np.pi - 0.2, spec.num_parameters).round(4)
    return spec, splits, z


def _jax_value_and_grad(spec, splits, z):
    """JAX's autodiff loss of consensus.py:148-159, per agent (padded and
    masked as its batch is)."""
    b = jax_batch(splits)

    def loss(t, X, Y, m):
        Kt = jax_gram(spec, X, t.astype(jnp.float32)).astype(jnp.float64)
        return jax_nll(Kt, jnp.zeros((0,) + Kt.shape), Y, m, 0.1, compute_cond=False).nll

    vg = jax.jit(jax.vmap(jax.value_and_grad(loss), in_axes=(None, 0, 0, 0)))
    nll, g = vg(jnp.asarray(np.mod(z, np.pi)), b.X, b.Y, b.mask)
    return np.asarray(nll), np.asarray(g)


@pytest.mark.parametrize("kernel_type", ["projected", "fidelity"])
def test_autodiff_gradient_matches_jax_value_and_grad(kernel_type):
    spec, splits, z = _problem(kernel_type)
    want_nll, want_g = _jax_value_and_grad(spec, splits, z)
    res = TC.autodiff_nll_and_grad(spec_from_jax(spec), TC.make_agent_batch(splits, "cpu"),
                                   TM.wrap(torch.as_tensor(z)), 0.1, compute_cond=False)
    got_g = res.grad.numpy()
    scale = np.abs(want_g).max()
    assert np.abs(got_g - want_g).max() <= GRAD_RTOL * scale, (np.abs(got_g - want_g).max(), scale)
    np.testing.assert_allclose(res.nll.numpy(), want_nll, rtol=5e-5)
    assert not res.grad.requires_grad and res.grad.dtype == torch.float64


def test_autodiff_beats_central_difference():
    """As tests/test_autodiff_grad.py, on its problem: the exact gradient
    from JAX's jacfwd of the Gram; the port's autodiff lands closer to it
    than the port's central difference."""
    spec = QuantumKernelSpec(circuit=build_circuit("hubregtsen", 2, 2, 1),
                             kernel_type="projected", outer_kernel="gaussian")
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.9, 0.9, (10, 2)).astype(np.float32).astype(np.float64)
    Y = np.sin(X[:, 0]) + 0.05 * rng.randn(10)
    z = rng.uniform(0.2, np.pi - 0.7, spec.num_parameters)
    tspec = spec_from_jax(spec)
    batch = TC.make_agent_batch([(X, Y)], "cpu")

    def K_of(t):
        return jax_gram(spec, jnp.asarray(X, jnp.float32), t.astype(jnp.float32)).astype(jnp.float64)

    K = np.asarray(jax.jit(K_of)(jnp.asarray(z)))
    dK = np.asarray(jax.jit(jax.jacfwd(K_of))(jnp.asarray(z)))
    Ci = np.linalg.inv(K + 0.01 * np.eye(len(X)))
    alpha = Ci @ Y
    exact = 0.5 * np.einsum("ij,jip->p", Ci - np.outer(alpha, alpha), dK)

    def grad(method):
        _, _, res = TC.agent_updates(tspec, torch.as_tensor(z), torch.zeros(1, tspec.num_parameters),
                                     batch, rho=100.0, L=100.0, noise_std=0.1,
                                     parity_round=False, compute_cond=False, grad_method=method)
        return res.grad[0].numpy()

    err_auto = np.linalg.norm(grad("autodiff") - exact)
    err_central = np.linalg.norm(grad("central") - exact)
    assert err_auto < err_central, (err_auto, err_central)
    assert err_auto <= 1e-3 * np.abs(exact).max(), (err_auto, np.abs(exact).max())


def test_autodiff_step_matches_jax_step():
    """One ADMM step with the autodiff gradient (4-dp rounding on): theta
    at most one 4-dp flip from JAX's, psi at most rho times that (the bars
    of tests/test_torch_consensus.py)."""
    spec, splits, _ = _problem()
    rng = np.random.RandomState(5)
    theta = np.round(rng.rand(3, spec.num_parameters), 4)
    psi = np.round(rng.rand(3, spec.num_parameters), 4)
    kw = dict(rho=100.0, L=100.0, noise_std=0.1, grad_method="autodiff")
    want = jax_step(spec, None, **kw)(jnp.asarray(theta), jnp.asarray(psi), jax_batch(splits))
    got = TC.make_admm_step(spec_from_jax(spec), **kw)(
        torch.as_tensor(theta), torch.as_tensor(psi), TC.make_agent_batch(splits, "cpu"))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), rtol=0, atol=1e-4 + 1e-12)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi), rtol=0, atol=2e-2)
    # the NLL (~4) is the sum of terms of magnitude ~30-50 that cancel:
    # hold each term at 1e-4 (tests/test_torch_consensus.py) and the sum
    # absolutely (measured 2.7e-4)
    np.testing.assert_allclose(got.nll.numpy(), np.asarray(want.nll), rtol=0, atol=1e-3)
    for f in ("log_det_term", "quadratic_term", "constant_term"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-4, err_msg=f)
    np.testing.assert_allclose(got.condition_number.numpy(), np.asarray(want.condition_number),
                               rtol=1e-2)


def test_train_with_autodiff_matches_jax():
    """Three iterations of the driver with grad_method="autodiff": z within
    5e-3 and CV-NLPD within 0.05 of JAX's run (bench.py:59-60)."""
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 3, 2, 1),
                             kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (60, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(60)
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, 2, "regional")
    kw = dict(cv_folds=3, verbose=False, max_iter=3, grad_method="autodiff")
    j = JD.train(spec, splits, X, Y, JD.TrainConfig(n_mesh_devices=1, **kw))
    t = TD.train(spec_from_jax(spec), splits, X, Y, TD.TrainConfig(**kw), device="cpu")
    zj = np.array([h["consensus_params"] for h in j.cv_history])
    zt = np.array([h["consensus_params"] for h in t.cv_history])
    cvj = np.array([h["consensus_cv_score"] for h in j.cv_history])
    cvt = np.array([h["consensus_cv_score"] for h in t.cv_history])
    assert (t.iterations, t.converged_by) == (j.iterations, j.converged_by)
    assert np.abs(zt - zj).max() <= 5e-3 and np.abs(cvt - cvj).max() <= 0.05


def test_autodiff_is_a_choice_not_a_fallback():
    """Unknown gradient methods still raise; "autodiff" is one of three."""
    assert TC.GRAD_METHODS == ("central", "streamed", "autodiff")
    spec, splits, z = _problem()
    with pytest.raises(NotImplementedError, match="grad_method"):
        TC.agent_updates(spec_from_jax(spec), torch.as_tensor(z),
                         torch.zeros(3, spec.num_parameters), TC.make_agent_batch(splits, "cpu"),
                         rho=100.0, L=100.0, noise_std=0.1, grad_method="adjoint")

