"""The fidelity-kernel slice as a whole — dataset, held-out split, regional
partition, ADMM training with per-iteration CV, predict, evaluate — against
the JAX package on the CPU, at a small size: a kyriienko fidelity kernel on
a synthetic quantum-GP dataset of 67 rows (60 train as 2 agents x 30, 7
held out), 3 iterations with 3-fold CV. Once with the gate-fusion switch on,
where the port runs the fused-program engine (K4's plain version) in place
of the unfused one.

Bars, as chip_smoke.py holds the card (chip_smoke.check_fidelity_run): z
within 5e-3 (bench.py:59), every agent NLL within rtol 1e-4, and every
CV-NLPD and the test NLPD within max(0.05, 2 |JAX f32 - JAX f64|) of JAX's
float32 values. The fidelity Gram here has few numerically nonzero
eigenvalues and the predictive variance is formed by cancellation, so NLPD
moves between two float32 engines by more than bench.py:60's 0.05; JAX's
own float32-vs-float64-feature spread on the same z measures how far.
"""

import contextlib
import functools
import io
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split

import chip_smoke as cs
from dqgp_tpu import driver as JD
from dqgp_tpu.data import split_data_numpy as jax_split
from dqgp_tpu.data.synthetic import generate_quantum_gp_data as jax_generate
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.gp import cv as jcv
from dqgp_tpu.models.gp import posterior as jpost
from dqgp_tpu.models.gp.metrics import evaluate_predictions as jax_eval
from dqgp_tpu.models.kernels import QuantumKernelSpec
from dqgp_tpu.models.kernels.quantum_kernel import kernel_features as jax_features
from dqgp_tpu_torch import config
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.data import (
    generate_quantum_gp_data,
    split_data_numpy,
    train_test_split_np,
)
from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions as torch_eval
from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp as torch_predict
from dqgp_tpu_torch.ops import cuda_circuit as K

N, TEST_SPLIT, AGENTS, SEED, ITERS, FOLDS = 67, 0.1, 2, 42, 3, 3


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def _f64_features(module):
    return mock.patch.object(module, "kernel_features",
                             functools.partial(jax_features, dtype=jnp.float64))


def _jax_cv(spec, X, Y, z, seed, f64):
    folds = jcv.kfold_pad_indices_np(len(X), FOLDS, seed)
    with _f64_features(jcv) if f64 else contextlib.nullcontext():
        scores = jcv.cv_fold_scores_impl(spec, jnp.asarray(X), jnp.asarray(Y),
                                         jnp.asarray(z), *folds)
    return jcv.aggregate_cv_scores(*scores, FOLDS)["mean_nlpd"]


def _jax_test_nlpd(spec, X, Y, X_te, Y_te, z, f64):
    predict = jpost.predict_quantum_gp.__wrapped__  # the plain function
    with _f64_features(jpost) if f64 else contextlib.nullcontext():
        mean, var = predict(spec, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(X_te),
                            jnp.asarray(z), noise_std=0.1)
    return jax_eval(Y_te, np.asarray(mean), np.asarray(var))["nlpd"]


@pytest.fixture(scope="module", params=[3, 4], ids=["3q", "4q"])
def reference(request):
    """The JAX package's run of the slice, in the fixture format that
    chip_smoke.check_fidelity_run reads."""
    jspec = QuantumKernelSpec(circuit=build_circuit("kyriienko", request.param, 1, 1),
                              kernel_type="fidelity")
    X, Y, theta = jax_generate(N, 1, jspec, data_seed=SEED, param_seed=SEED)
    X_tr, X_te, Y_tr, Y_te = train_test_split(X, Y, test_size=TEST_SPLIT,
                                              random_state=SEED, shuffle=True)
    splits = _quiet(jax_split, X_tr, Y_tr, AGENTS, "regional", 1.0, SEED)
    res = JD.train(jspec, splits, X_tr, Y_tr,
                   JD.TrainConfig(max_iter=ITERS, cv_folds=FOLDS, verbose=False),
                   ground_truth_params=theta)
    z_traj = [np.asarray(h["consensus_params"]) for h in res.cv_history]
    args = (jspec, X_tr, Y_tr, X_te, Y_te, res.z)
    return dict(
        jspec=jspec, data=(X, Y, theta), iterations=res.iterations,
        z_trajectory=[z.tolist() for z in z_traj],
        agent_nll=[h["agent_losses"] for h in res.nll_history],
        cv_nlpd=[h["consensus_cv_score"] for h in res.cv_history],
        cv_nlpd_f64_features=[_jax_cv(jspec, X_tr, Y_tr, z, SEED + it, True)
                              for it, z in enumerate(z_traj, start=1)],
        test_nlpd=_jax_test_nlpd(*args, f64=False),
        test_nlpd_f64=_jax_test_nlpd(*args, f64=True),
    )


@pytest.mark.parametrize("fusion", ["auto", "on"])
def test_fidelity_slice_matches_jax(reference, fusion, monkeypatch):
    monkeypatch.setattr(config, "use_fusion", fusion)
    spec = spec_from_jax(reference["jspec"])
    X, Y, theta = generate_quantum_gp_data(N, 1, spec, data_seed=SEED, param_seed=SEED,
                                           device="cpu")
    Xj, Yj, thj = reference["data"]
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(theta, thj)
    np.testing.assert_allclose(Y, Yj, rtol=0, atol=1e-8)
    X_tr, X_te, Y_tr, Y_te, _, _ = train_test_split_np(X, Y, TEST_SPLIT, SEED)
    splits = _quiet(split_data_numpy, X_tr, Y_tr, AGENTS, "regional", 1.0, SEED)
    assert [len(x) for x, _ in splits] == [30, 30] and len(X_te) == 7

    with mock.patch.object(K, "state_from_angles_fused",
                           wraps=K.state_from_angles_fused) as fused:
        res = TD.train(spec, splits, X_tr, Y_tr,
                       TD.TrainConfig(max_iter=ITERS, cv_folds=FOLDS, verbose=False),
                       ground_truth_params=theta, device="cpu")
        mean, var = torch_predict(spec, torch.tensor(X_tr), torch.tensor(Y_tr),
                                  torch.tensor(X_te), torch.tensor(res.z), noise_std=0.1)
    # the fused engine runs in every step, CV pass and predict, or in none
    assert fused.call_count == (2 * ITERS + 2 if fusion == "on" else 0)

    z_dev, nll_dev, cv_ratio = cs.check_fidelity_run(res, reference, ITERS, fusion)
    nlpd = torch_eval(Y_te, mean, var)["nlpd"]
    bar = max(cs.NLPD_TOL, 2 * abs(reference["test_nlpd"] - reference["test_nlpd_f64"]))
    print(f"z dev {z_dev:.2e}, NLL rel dev {nll_dev:.2e}, CV dev/bar {cv_ratio:.3f}, "
          f"test NLPD {nlpd:.4f} vs {reference['test_nlpd']:.4f} (bar {bar:.3f})")
    assert abs(nlpd - reference["test_nlpd"]) <= bar
