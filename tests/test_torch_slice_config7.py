"""The config #7 slice as a whole — the classical dataset, held-out split,
regional partition, ADMM training with streamed gradients and CV on a
seeded subsample, then the CG posterior — against the JAX package on the
CPU, at config #7's width (chebyshev 10 qubits / 2 layers, P = 70, a
projected Matérn kernel) and a small depth: 107 samples, 96 train rows over
4 agents, 2 iterations with CV on 48 of them, a CG predict of the 11 held-out
rows. At 10 qubits the fusion switch's "auto" sends every feature through
K3's wrapper, which on the CPU runs the plain fused engine.

Then a replay of the fixture problem (tests/fixtures/torch_port_config7.json,
written by scripts/record_torch_port_config7.py): its first iteration and
the CG posterior at the fixture's final z, held to the bars chip_smoke.py
holds the card to in phase 11a.

Bars (chip_smoke.check_config7_fixture): z within 5e-3 (bench.py:59), every
agent NLL, scored at the reference's own z of each iteration, within
max(1e-4, 2 x the iteration's largest relative spread of the JAX package's
own re-scores at that z: float64 features, and in the fixture also its eager
float32 engine and its float32 fused program), and every CV-NLPD and the
test NLPD within max(0.05, 2 |JAX f32 - JAX f64|) of JAX's float32 values.
These Matérn Grams of 10-qubit features are ill-conditioned: a last-ulp
change of the float32 features moves an agent NLL by up to ~5e-4 relative,
and NLPD by more than bench.py:60's 0.05; the JAX package's own spreads on
the same z measure how far.
"""

import contextlib
import functools
import io
import json
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split

import chip_smoke as cs
from dqgp_tpu import driver as JD
from dqgp_tpu.data import split_data_numpy as jax_split
from dqgp_tpu.data.synthetic import generate_data_numpy as jax_generate
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.gp import cv as jcv
from dqgp_tpu.models.gp.metrics import evaluate_predictions as jax_eval
from dqgp_tpu.models.kernels import QuantumKernelSpec
from dqgp_tpu.models.kernels import quantum_kernel as jqk
from dqgp_tpu.parallel import blocked as JB
from dqgp_tpu_torch import config
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.data import generate_data_numpy
from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.parallel.blocked import make_cg_predictor

N, AGENTS, ITERS, CV_MAX = 107, 4, 2, 48
TRAIN = dict(max_iter=ITERS, grad_method="streamed", cv_max_samples=CV_MAX,
             compute_cond=False, verbose=False, seed=cs.C7_SEED)


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def _f64_features(module):
    return mock.patch.object(module, "kernel_features",
                             functools.partial(jqk.kernel_features, dtype=jnp.float64))


def _jax_cv(spec, X, Y, z, seed):
    folds = jcv.kfold_pad_indices_np(len(X), 5, seed)
    with _f64_features(jcv):
        scores = jcv.cv_fold_scores_impl(spec, jnp.asarray(X), jnp.asarray(Y),
                                         jnp.asarray(z), *folds)
    return jcv.aggregate_cv_scores(*scores, 5)["mean_nlpd"]


def _jax_nll_f64(spec, splits, z):
    """Agent NLLs at z from float64 features (the step's Gram at wrap(z))."""
    from dqgp_tpu import manifold as JM
    from dqgp_tpu.models.gp.posterior import masked_nll_core
    from dqgp_tpu.parallel import make_agent_batch

    b = make_agent_batch(splits)
    zw = JM.wrap(jnp.asarray(z))
    return [float(masked_nll_core(jqk.gram(spec, b.X[a], zw, dtype=jnp.float64),
                                  b.Y[a], b.mask[a], 0.1, compute_cond=False)[0].nll)
            for a in range(b.X.shape[0])]


def _jax_cg_nlpd(spec, X, Y, X_te, Y_te, z, f64):
    with _f64_features(jqk) if f64 else contextlib.nullcontext():
        mean, var = JB.make_cg_predictor(spec, X, Y, jnp.asarray(z, jnp.float64), 0.1)(X_te)
    return jax_eval(Y_te, np.asarray(mean), np.asarray(var))["nlpd"]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's run of the slice, in the fixture format that
    chip_smoke.check_config7_fixture reads."""
    jspec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 10, 2, 2),
                              kernel_type="projected", outer_kernel="matern")
    X, Y = jax_generate(N, 2, 0.1, cs.C7_SEED)
    X_tr, X_te, Y_tr, Y_te = train_test_split(X, Y, test_size=0.1,
                                              random_state=cs.C7_SEED, shuffle=True)
    splits = _quiet(jax_split, X_tr, Y_tr, AGENTS, "regional", 1.0, cs.C7_SEED)
    res = JD.train(jspec, splits, X_tr, Y_tr, JD.TrainConfig(**TRAIN))
    z_traj = [np.asarray(h["consensus_params"]) for h in res.cv_history]
    sel = np.random.RandomState(cs.C7_SEED).choice(len(X_tr), CV_MAX, replace=False)
    args = (jspec, X_tr, Y_tr, X_te, Y_te, res.z)
    return dict(
        jspec=jspec, data=(X, Y), iterations=res.iterations,
        z_trajectory=[z.tolist() for z in z_traj],
        agent_nll=[h["agent_losses"] for h in res.nll_history],
        agent_nll_f64_features=[_jax_nll_f64(jspec, splits, z) for z in z_traj],
        cv_nlpd=[h["consensus_cv_score"] for h in res.cv_history],
        cv_nlpd_f64_features=[_jax_cv(jspec, X_tr[sel], Y_tr[sel], z, cs.C7_SEED + it)
                              for it, z in enumerate(z_traj, start=1)],
        test_metrics={"nlpd": _jax_cg_nlpd(*args, f64=False)},
        test_nlpd_f64_features=_jax_cg_nlpd(*args, f64=True),
    )


def test_config7_slice_matches_jax(reference, monkeypatch):
    monkeypatch.setattr(config, "use_fusion", "auto")
    spec = spec_from_jax(reference["jspec"])
    X, Y = generate_data_numpy(N, 2, 0.1, cs.C7_SEED)
    np.testing.assert_array_equal(X, reference["data"][0])
    np.testing.assert_array_equal(Y, reference["data"][1])
    X_tr, Y_tr, X_te, Y_te, splits = cs.config7_problem(N, AGENTS)
    assert len(X_tr) == 96 and len(X_te) == 11
    with mock.patch.object(TQ, "pauli_features_from_angles_fused",
                           wraps=TQ.pauli_features_from_angles_fused) as k3, \
            mock.patch.object(TQ, "pauli_features_from_angles") as k1:
        res = TD.train(spec, splits, X_tr, Y_tr, TD.TrainConfig(**TRAIN), device="cpu")
        mean, var = make_cg_predictor(spec, X_tr, Y_tr, res.z, 0.1, device="cpu")(X_te)
    # every feature of the path goes through K3's wrapper: per step the Gram
    # at wrap(z) and one +-h call per parameter, per CV pass one, per
    # predictor the training rows and the eval rows
    P = spec.num_parameters
    assert k3.call_count == ITERS * (1 + P) + ITERS + 2 and k1.call_count == 0
    metrics = evaluate_predictions(Y_te, mean, var)
    nll_at_ref = cs.config7_agent_nll_at(spec, splits, reference["z_trajectory"], "cpu", 0.1)
    # at iteration 1 both runs stand at the same z: the run's own NLLs are
    # the re-scored ones
    np.testing.assert_allclose(res.nll_history[0]["agent_losses"], nll_at_ref[0], rtol=1e-12)
    z_dev, nll_dev, cv_ratio, t_ratio = cs.check_config7_fixture(res, metrics, reference, ITERS,
                                                                 nll_at_ref)
    print(f"z dev {z_dev:.2e}, NLL rel dev {nll_dev:.2e}, CV dev/bar {cv_ratio:.3f}, "
          f"test NLPD dev/bar {t_ratio:.3f}")


@pytest.fixture(scope="module")
def fixture_problem():
    with open(cs.CONFIG7_FIXTURE) as f:
        ref = json.load(f)
    return ref, cs.config7_problem(cs.C7_FIX_SAMPLES, cs.C7_FIX_AGENTS)


def test_fixture_problem_digest(fixture_problem):
    ref, (X_tr, Y_tr, X_te, Y_te, splits) = fixture_problem
    p = ref["problem"]
    X, Y = generate_data_numpy(cs.C7_FIX_SAMPLES, 2, 0.1, cs.C7_SEED)
    assert cs.array_digest(X) == p["x_sha256"] and cs.array_digest(Y) == p["y_sha256"]
    assert [len(x) for x, _ in splits] == p["shard_sizes"]
    assert (len(X_tr), len(X_te)) == (999, 112)
    sel = np.random.RandomState(cs.C7_SEED).choice(len(X_tr), cs.C7_CV_MAX, replace=False)
    assert cs.array_digest(sel.astype(np.float64)) == p["cv_subsample_sha256"]
    assert ref["train_config"]["grad_method"] == "streamed"
    assert ref["train_config"]["cv_max_samples"] == cs.C7_CV_MAX


def test_fixture_replay_first_iteration_and_cg(fixture_problem):
    """The port on the CPU passes phase 11a's bars on the fixture problem:
    the first iteration, and the CG posterior at the fixture's final z."""
    ref, (X_tr, Y_tr, X_te, Y_te, splits) = fixture_problem
    spec = cs.config7_spec()
    res = TD.train(spec, splits, X_tr, Y_tr, cs.config7_train_config(1, verbose=False),
                   device="cpu")
    cs.check_fidelity_run(res, ref, 1, "config #7 fixture", cs.config7_nll_bars(ref))
    predict = make_cg_predictor(spec, X_tr, Y_tr, np.array(ref["z_final"]), 0.1,
                                device="cpu")
    mean, var = predict(X_te)
    metrics = evaluate_predictions(Y_te, mean, var)
    assert abs(metrics["nlpd"] - ref["test_metrics"]["nlpd"]) <= cs.config7_test_nlpd_bar(ref)
    # float64 on the CPU, as the JAX reference's CG ran
    np.testing.assert_allclose(mean.numpy(), ref["cg"]["mean"], rtol=1e-3, atol=1e-5)
    assert predict.alpha_result.residual_norm <= 30 * 1e-6


def test_fixture_agent_nll_at_jax_z(fixture_problem):
    """Phase 11a's agent-NLL check: the port's NLLs at each of JAX's z of
    the fixture trajectory, within that iteration's bar."""
    ref, (X_tr, Y_tr, X_te, Y_te, splits) = fixture_problem
    nll = cs.config7_agent_nll_at(cs.config7_spec(), splits, ref["z_trajectory"], "cpu", 0.1)
    rel = np.abs(nll - ref["agent_nll"]) / np.abs(ref["agent_nll"])
    assert nll.shape == (3, cs.C7_FIX_AGENTS)
    assert np.all(rel <= cs.config7_nll_bars(ref)[:, None]), rel.max(axis=1)
