"""The streamed central-difference gradient (parallel/consensus.py) against
the JAX package's ``make_admm_step(..., grad_method="streamed")`` and against
the port's own central step, over 3 ADMM iterations from the same theta, psi
and ragged agent shards; and the driver's ``grad_method`` and
``cv_max_samples`` against the JAX driver's.

The GP side is float64 on both packages; the features are float32 (the
streamed path forms its shifted parameters in float32, in both packages).
Port streamed against port central: the same features and the same float64
bracket, so z, theta and psi agree at 4 dp exactly and the gradients to the
order of their sums. Port against JAX: two float32 engines, so the bars are
tests/test_consensus.py's (tests/test_torch_consensus.py): z and theta
within one 4-dp step, psi within 2e-2 (rho = 100 times a theta step); the
agent NLLs within rtol 1e-4, the bar chip_smoke.py holds the card to (the
Matérn Grams of chebyshev features amplify the engines' last-ulp feature
differences to ~6e-5 relative in the NLL, against ~3e-6 for
tests/test_torch_consensus.py's Gaussian ones).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu import driver as JD
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.parallel import make_admm_step as jax_step, make_agent_batch as jax_batch
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.models.gp.posterior import masked_nll_and_grad
from dqgp_tpu_torch.models.kernels.quantum_kernel import gram_and_shift_grads
from dqgp_tpu_torch.parallel import make_admm_step as torch_step
from dqgp_tpu_torch.parallel import make_agent_batch as torch_batch
from dqgp_tpu_torch.parallel.consensus import agent_grams, streamed_nll_and_grad
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(rho=100.0, L=100.0, noise_std=0.1)
ITERS = 3


def _setup(enc="chebyshev", n=3, n_agents=4, n_per=8, seed=0):
    jspec = JaxSpec(circuit=build_circuit(enc, n, 2, 1), kernel_type="projected",
                    outer_kernel="matern")
    rng = np.random.RandomState(seed)
    splits = []
    for i in range(n_agents):
        ni = n_per - (i % 2)  # ragged shards on purpose
        X = rng.uniform(-0.9, 0.9, (ni, 2))
        splits.append((X, np.sin(X[:, 0]) + 0.1 * rng.randn(ni)))
    P = jspec.num_parameters
    theta = np.round(rng.rand(n_agents, P), 4)
    psi = np.round(rng.rand(n_agents, P), 4)
    return jspec, splits, theta, psi


@pytest.mark.parametrize("enc,n", [("chebyshev", 3), ("hubregtsen", 2)])
def test_streamed_steps_match_jax_and_central(enc, n):
    jspec, splits, theta, psi = _setup(enc, n)
    spec = spec_from_jax(jspec)
    jstep = jax_step(jspec, None, grad_method="streamed", **KW)
    sstep = torch_step(spec, grad_method="streamed", **KW)
    cstep = torch_step(spec, grad_method="central", **KW)
    jb, tb = jax_batch(splits), torch_batch(splits, "cpu")
    j = (jnp.asarray(theta), jnp.asarray(psi))
    s = c = (torch.tensor(theta), torch.tensor(psi))
    for _ in range(ITERS):
        jo, so, co = jstep(*j, jb), sstep(*s, tb), cstep(*c, tb)
        for f in ("z", "theta", "psi"):
            np.testing.assert_array_equal(getattr(so, f).numpy(), getattr(co, f).numpy(),
                                          err_msg=f)
        np.testing.assert_allclose(so.nll.numpy(), co.nll.numpy(), rtol=1e-12)
        np.testing.assert_allclose(so.z.numpy(), np.asarray(jo.z), rtol=0, atol=1e-4 + 1e-12)
        np.testing.assert_allclose(so.theta.numpy(), np.asarray(jo.theta), rtol=0,
                                   atol=1e-4 + 1e-12)
        np.testing.assert_allclose(so.psi.numpy(), np.asarray(jo.psi), rtol=0, atol=2e-2)
        np.testing.assert_allclose(so.nll.numpy(), np.asarray(jo.nll), rtol=1e-4)
        j, s, c = (jo.theta, jo.psi), (so.theta, so.psi), (co.theta, co.psi)


def test_streamed_gradient_equals_central_gradient():
    """The unrounded gradients: the streamed per-parameter contraction
    against the materialized dK of ``gram_and_shift_grads`` +
    ``masked_nll_and_grad`` (chip_smoke.py holds the card to 1e-6 of the
    largest component)."""
    jspec, splits, _, _ = _setup()
    spec = spec_from_jax(jspec)
    batch = torch_batch(splits, "cpu")
    # a wrapped consensus vector, as admm_iteration hands it over
    z32 = torch.tensor(np.random.RandomState(5).uniform(0, np.pi, spec.num_parameters),
                       dtype=torch.float32)
    h = float(np.pi / 8)
    got = streamed_nll_and_grad(spec, batch, z32, h, 0.1)
    K, dK = gram_and_shift_grads(spec, batch.X, z32, h)
    want = masked_nll_and_grad(K.double(), dK, batch.Y, batch.mask, 0.1)
    assert got.grad.shape == want.grad.shape == (4, spec.num_parameters)
    scale = float(want.grad.abs().max())
    assert float((got.grad - want.grad).abs().max()) <= 1e-9 * scale
    np.testing.assert_allclose(got.nll.numpy(), want.nll.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.condition_number.numpy(),
                               want.condition_number.numpy(), rtol=1e-9)


def test_agent_grams_shape_and_central_grams():
    jspec, splits, _, _ = _setup()
    spec = spec_from_jax(jspec)
    batch = torch_batch(splits, "cpu")
    thetas = torch.rand((3, spec.num_parameters))
    G = agent_grams(spec, batch.X, thetas)
    assert G.shape == (4, 3, 8, 8) and G.dtype == torch.float32
    K, _ = gram_and_shift_grads(spec, batch.X, thetas[0], float(np.pi / 8))
    torch.testing.assert_close(G[:, 0], K, rtol=1e-6, atol=1e-6)


def test_unported_grad_method_raises():
    # "autodiff" is ported (tests/test_torch_autodiff.py); a name that
    # neither package has still raises
    jspec, splits, theta, psi = _setup()
    step = torch_step(spec_from_jax(jspec), grad_method="adjoint", **KW)
    with pytest.raises(NotImplementedError, match="grad_method 'adjoint'"):
        step(torch.tensor(theta), torch.tensor(psi), torch_batch(splits, "cpu"))


def test_driver_streamed_cv_subsample_matches_jax():
    """TrainConfig.grad_method and cv_max_samples: 2 iterations of both
    drivers on 60 rows over 3 agents, CV on a seeded 24-row subsample."""
    jspec, _, _, _ = _setup()
    rng = np.random.RandomState(7)
    X = rng.uniform(-0.9, 0.9, (60, 2))
    Y = np.sin(3 * X[:, 0]) + 0.1 * rng.randn(60)
    splits = [(X[i::3], Y[i::3]) for i in range(3)]
    kw = dict(max_iter=2, grad_method="streamed", cv_max_samples=24, compute_cond=False)
    with contextlib.redirect_stdout(io.StringIO()):
        jres = JD.train(jspec, splits, X, Y, JD.TrainConfig(**kw))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tres = TD.train(spec_from_jax(jspec), splits, X, Y, TD.TrainConfig(**kw), device="cpu")
    assert "CV model selection on a 24-sample subset of 60 training rows" in log.getvalue()
    z = np.array([h["consensus_params"] for h in tres.cv_history])
    jz = np.array([h["consensus_params"] for h in jres.cv_history])
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-4 + 1e-12)
    cv = [h["consensus_cv_score"] for h in tres.cv_history]
    jcv = [h["consensus_cv_score"] for h in jres.cv_history]
    np.testing.assert_allclose(cv, jcv, rtol=0, atol=0.05)
    # the first iteration starts from the same z; later ones may not (one
    # 4-dp flip moves the NLL by more than the engines do)
    np.testing.assert_allclose(tres.nll_history[0]["agent_losses"],
                               jres.nll_history[0]["agent_losses"], rtol=1e-4)
