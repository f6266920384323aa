"""The port's "autodiff" gradient at config #7's width (chebyshev 10 qubits
/ 2 layers, projected Matérn) against the JAX package's on the CPU.

On a few agents of a few dozen rows the port's autodiff step (the plain
fused engine forward, as K3 runs at 10 qubits, and torch.autograd backward)
is held to ``jax.value_and_grad`` of the JAX step's loss (its XLA engine,
``n_mesh_devices=1`` semantics) at the bars of tests/test_torch_autodiff.py:
NLL rtol 5e-5, gradient 1e-4 of the largest component (measured 6e-6 to
3e-5 here).

Then the port replays the first iteration of
tests/fixtures/torch_port_config7_autodiff.json (the fixture problem: 999
rows over 8 agents, written by scripts/record_torch_port_config7_autodiff.py)
through its plain engine: iteration 1's z exactly, the agent NLLs within the
config #7 bars (max(1e-4, 2 x the JAX package's own spread)) and iteration
1's gradient within ``chip_smoke.config7_autodiff_grad_bar`` — the bars
chip_smoke.py's phase 15c holds the card to.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch import manifold as TM
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.parallel import consensus as TC
from test_torch_autodiff import GRAD_RTOL, _jax_value_and_grad


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread here: these tests hand the work back and forth
    between JAX and torch many times a step, so that torch's thread pool
    does not compete with XLA's for the cores of a host that the other test
    workers load too (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(seed):
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", cs.C7_QUBITS, 2, cs.C7_LAYERS),
                             kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(seed)
    splits = []
    for n in (30, 26, 28):
        X = rng.uniform(-0.9, 0.9, (n, 2))
        splits.append((X, np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(n)))
    z = rng.uniform(0.2, np.pi - 0.2, spec.num_parameters).round(4)
    return spec, splits, z


@pytest.mark.parametrize("seed", [0, 1])
def test_config7_autodiff_gradient_matches_jax_value_and_grad(seed):
    spec, splits, z = _problem(seed)
    want_nll, want_g = _jax_value_and_grad(spec, splits, z)
    res = TC.autodiff_nll_and_grad(spec_from_jax(spec), TC.make_agent_batch(splits, "cpu"),
                                   TM.wrap(torch.as_tensor(z)), 0.1, compute_cond=False)
    scale = np.abs(want_g).max()
    assert np.abs(res.grad.numpy() - want_g).max() <= GRAD_RTOL * scale
    np.testing.assert_allclose(res.nll.numpy(), want_nll, rtol=5e-5)


def _fixture():
    with open(cs.CONFIG7_AUTODIFF_FIXTURE) as f:
        return json.load(f)


def test_config7_autodiff_fixture_problem_is_the_streamed_ones():
    """The fixture's problem and settings are config #7's fixture problem
    (tests/fixtures/torch_port_config7.json) with the autodiff gradient."""
    ref, streamed = _fixture(), json.load(open(cs.CONFIG7_FIXTURE))
    for key in ("x_sha256", "y_sha256", "shard_sizes", "num_qubits", "num_layers", "agents"):
        assert ref["problem"][key] == streamed["problem"][key]
    cfg = ref["train_config"]
    assert (cfg["grad_method"], cfg["n_mesh_devices"]) == ("autodiff", 1)
    same = ("rho", "L", "noise_std", "seed", "cv_max_samples", "compute_cond", "max_iter")
    assert all(cfg[k] == streamed["train_config"][k] for k in same)
    assert ref["iterations"] == cs.C7_FIX_ITERS
    assert np.array_equal(ref["iteration1_z"], ref["z_trajectory"][0])
    # the JAX package's own spread sets the gradient bar
    assert cs.config7_autodiff_grad_bar(ref) >= cs.AUTODIFF_GRAD_TOL


def test_config7_autodiff_fixture_first_iteration_on_the_plain_engine():
    ref = _fixture()
    spec = cs.config7_spec()
    X_tr, Y_tr, _, _, splits = cs.config7_problem(cs.C7_FIX_SAMPLES, cs.C7_FIX_AGENTS)
    assert [len(x) for x, _ in splits] == ref["problem"]["shard_sizes"]
    cfg = cs.config7_train_config(1, grad_method="autodiff", verbose=False)
    res = TD.train(spec, splits, X_tr, Y_tr, cfg, device="cpu")
    np.testing.assert_array_equal(res.cv_history[0]["consensus_params"], ref["iteration1_z"])
    nll = np.array(res.nll_history[0]["agent_losses"])
    rel = np.abs(nll - ref["agent_nll"][0]) / np.abs(ref["agent_nll"][0])
    assert rel.max() <= cs.config7_nll_bars(ref)[0], rel
    g = TC.autodiff_nll_and_grad(spec, TC.make_agent_batch(splits, "cpu"),
                                 TM.wrap(torch.as_tensor(ref["iteration1_z"])), cfg.noise_std,
                                 compute_cond=False).grad.numpy()
    g_ref = np.array(ref["iteration1_grad"])
    assert np.abs(g - g_ref).max() <= cs.config7_autodiff_grad_bar(ref) * np.abs(g_ref).max()
    assert np.isfinite(res.cv_history[0]["consensus_cv_score"])
