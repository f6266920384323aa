"""One ADMM iteration of the port vs the JAX single-device step, from the
same theta, psi and ragged agent shards."""

import jax.numpy as jnp
import numpy as np
import torch

from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec
from dqgp_tpu.parallel import make_admm_step as jax_step, make_agent_batch as jax_batch
from dqgp_tpu_torch.convert import spec_from_jax, state_from_numpy
from dqgp_tpu_torch.parallel import make_admm_step as torch_step
from dqgp_tpu_torch.parallel import make_agent_batch as torch_batch


def _setup(n_agents=4, n_per=6, seed=0):
    # as tests/test_consensus.py:21-37
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 2, 1),
        kernel_type="projected", outer_kernel="gaussian",
    )
    rng = np.random.RandomState(seed)
    splits = []
    for i in range(n_agents):
        ni = n_per - (i % 2)  # ragged shards on purpose
        X = rng.uniform(-0.9, 0.9, (ni, 2))
        Y = np.sin(X[:, 0]) + 0.1 * rng.randn(ni)
        splits.append((X, Y))
    P_ = spec.num_parameters
    theta = np.round(rng.rand(n_agents, P_), 4)
    psi = np.round(rng.rand(n_agents, P_), 4)
    return spec, splits, theta, psi


def test_one_iteration_matches_jax():
    spec, splits, theta, psi = _setup()
    kw = dict(rho=100.0, L=100.0, noise_std=0.1)
    want = jax_step(spec, None, **kw)(jnp.asarray(theta), jnp.asarray(psi), jax_batch(splits))
    th_t, ps_t, _ = state_from_numpy(theta, psi, np.zeros(spec.num_parameters), "cpu")
    got = torch_step(spec_from_jax(spec), **kw)(th_t, ps_t, torch_batch(splits, "cpu"))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=0, atol=1e-12)
    # float32 features: at most one 4-dp flip of theta, hence of psi (x rho)
    # — the bars of tests/test_consensus.py:62-63
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), rtol=0, atol=1e-4 + 1e-12)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi), rtol=0, atol=2e-2)
    # The two float32 engines round differently (a quarter of the feature
    # entries and half of the Gram entries differ in the last ulp), and the
    # solve amplifies that to ~3e-6 relative in the NLL; hence 1e-5.
    # The components partly cancel in the sum, so each moves more (1e-5
    # observed on the quadratic term); hence 1e-4 for them.
    np.testing.assert_allclose(got.nll.numpy(), np.asarray(want.nll), rtol=1e-5)
    for f in ("log_det_term", "quadratic_term", "constant_term"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-4, err_msg=f)
    # condition numbers of an f32-built Gram: f32 representation noise
    np.testing.assert_allclose(got.condition_number.numpy(),
                               np.asarray(want.condition_number), rtol=1e-2)


def test_agent_batch_padding_and_device():
    _, splits, _, _ = _setup()
    b = torch_batch(splits, "cpu")
    j = jax_batch(splits)
    for f in ("X", "Y", "mask"):
        assert getattr(b, f).dtype == {"X": torch.float32}.get(f, torch.float64)
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(j, f)))
    assert b.X.device.type == "cpu"


def test_padded_rows_do_not_leak():
    # the same agent padded to 6 or to 9 rows gives the same step
    spec, splits, theta, psi = _setup(n_agents=2)
    kw = dict(rho=100.0, L=100.0, noise_std=0.1, compute_cond=False)
    step = torch_step(spec_from_jax(spec), **kw)
    th, ps, _ = state_from_numpy(theta, psi, np.zeros(spec.num_parameters), "cpu")
    a = step(th, ps, torch_batch(splits, "cpu"))
    b = step(th, ps, torch_batch(splits, "cpu", pad_to=9))
    # f32 Gram products of another shape accumulate in another order; the
    # solve amplifies that (tests/test_consensus.py:64-66 allows 1e-3)
    np.testing.assert_allclose(b.nll.numpy(), a.nll.numpy(), rtol=1e-5)
    np.testing.assert_allclose(b.theta.numpy(), a.theta.numpy(), rtol=0, atol=1e-4 + 1e-12)
