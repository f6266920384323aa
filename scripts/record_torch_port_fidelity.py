#!/usr/bin/env python
"""Record the JAX reference for the PyTorch port's fidelity-kernel run.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_fidelity.py

BASELINE config #5 at the reference's recommended 1-D size, as the CLI runs
it (cli.py:342-378): ``generate_quantum_gp_data(1000, 1, spec,
data_seed=42, param_seed=42)`` for a 6-qubit, 1-layer kyriienko fidelity
kernel, sklearn's ``train_test_split`` (test split 0.1, seed 42), a regional
partition over 4 agents, ``dqgp_tpu.driver.train`` for
``chip_smoke.FID_ITERS`` ADMM iterations with per-iteration 5-fold CV, then
``predict_quantum_gp`` + ``evaluate_predictions`` on the 100 held-out rows.

It writes ``tests/fixtures/torch_port_fidelity.json``: the dataset (a digest
of X, Y itself and theta*), the z trajectory, every iteration's per-agent
NLL, and CV-NLPD and test NLPD from float32 features (the production path).
Beside them it records the same CV-NLPD and test NLPD at the same z values
from float64 features, so the fixture carries JAX's own float32-vs-float64
spread: on this problem the fidelity Gram has few numerically nonzero
eigenvalues and the latent variance 1 - k^T K^-1 k is formed by
cancellation, so NLPD moves by whole units between two float32 engines.
chip_smoke.py imports no JAX, so on the GPU this file is its reference.
"""

import functools
import json
import os
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from sklearn.model_selection import train_test_split  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dqgp_tpu import driver  # noqa: E402
from dqgp_tpu.data import split_data_numpy  # noqa: E402
from dqgp_tpu.data.synthetic import generate_quantum_gp_data  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.gp import cv as jcv  # noqa: E402
from dqgp_tpu.models.gp import posterior as jpost  # noqa: E402
from dqgp_tpu.models.gp.metrics import evaluate_predictions  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec  # noqa: E402
from dqgp_tpu.models.kernels.quantum_kernel import kernel_features  # noqa: E402


def float64_features(module):
    """Patch ``module``'s kernel_features to build float64 features."""
    return mock.patch.object(module, "kernel_features",
                             functools.partial(kernel_features, dtype=jnp.float64))


def cv_nlpd(spec, X, Y, z, seed, folds):
    tr_i, tr_m, va_i, va_m = jcv.kfold_pad_indices_np(len(X), folds, seed)
    scores = jcv.cv_fold_scores_impl(spec, jnp.asarray(X), jnp.asarray(Y),
                                     jnp.asarray(z), tr_i, tr_m, va_i, va_m)
    return jcv.aggregate_cv_scores(*scores, folds)["mean_nlpd"]


def test_nlpd(spec, X, Y, X_test, Y_test, z, noise_std, jit=True):
    # the jitted function keeps its first trace: a patched kernel_features
    # reaches only the plain function underneath
    predict = jpost.predict_quantum_gp if jit else jpost.predict_quantum_gp.__wrapped__
    mean, var = predict(spec, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(X_test),
                        jnp.asarray(z), noise_std=noise_std)
    return evaluate_predictions(Y_test, np.asarray(mean), np.asarray(var))


def record() -> dict:
    spec = QuantumKernelSpec(
        circuit=build_circuit("kyriienko", cs.FID_QUBITS, 1, cs.FID_LAYERS),
        kernel_type="fidelity")
    X, Y, theta_star = generate_quantum_gp_data(
        cs.FID_SAMPLES, 1, spec, data_seed=cs.FID_SEED, param_seed=cs.FID_SEED)
    X_tr, X_te, Y_tr, Y_te, tr_idx, te_idx = train_test_split(
        X, Y, np.arange(len(X)), test_size=cs.FID_TEST_SPLIT,
        random_state=cs.FID_SEED, shuffle=True)
    splits = split_data_numpy(X_tr, Y_tr, cs.FID_AGENTS, "regional", 1.0, cs.FID_SEED)
    cfg = driver.TrainConfig(max_iter=cs.FID_ITERS, verbose=False, seed=cs.FID_SEED)
    res = driver.train(spec, splits, X_tr, Y_tr, cfg, ground_truth_params=theta_star)
    z_traj = [np.asarray(h["consensus_params"]) for h in res.cv_history]
    metrics = test_nlpd(spec, X_tr, Y_tr, X_te, Y_te, res.z, cfg.noise_std)

    cv_f32, cv_f64 = [], []
    for it, z in enumerate(z_traj, start=1):
        cv_f32.append(cv_nlpd(spec, X_tr, Y_tr, z, cfg.seed + it, cfg.cv_folds))
        with float64_features(jcv):
            cv_f64.append(cv_nlpd(spec, X_tr, Y_tr, z, cfg.seed + it, cfg.cv_folds))
    with float64_features(jpost):
        metrics_f64 = test_nlpd(spec, X_tr, Y_tr, X_te, Y_te, res.z, cfg.noise_std,
                                jit=False)
    cv_driver = [h["consensus_cv_score"] for h in res.cv_history]
    assert np.allclose(cv_f32, cv_driver, rtol=0, atol=1e-9), (cv_f32, cv_driver)

    return {
        "about": "JAX reference for the PyTorch port's fidelity-kernel run "
                 "(scripts/record_torch_port_fidelity.py)",
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "problem": {
            "source": "BASELINE.md:39 config #5 at cli.py:338's recommended 1-D "
                      "size; cli.py:342-378 data flow",
            "n_samples": cs.FID_SAMPLES, "test_split": cs.FID_TEST_SPLIT,
            "agents": cs.FID_AGENTS, "seed": cs.FID_SEED,
            "encoding": "kyriienko", "num_qubits": cs.FID_QUBITS,
            "num_layers": cs.FID_LAYERS, "kernel": "fidelity",
            "x_sha256": cs.array_digest(X),
            "Y": Y.tolist(),
            "theta_star": theta_star.tolist(),
            "train_idx_sha256": cs.array_digest(tr_idx.astype(np.float64)),
            "shard_sizes": [int(x.shape[0]) for x, _ in splits],
        },
        "train_config": {k: v for k, v in vars(cfg).items()
                         if isinstance(v, (int, float, str, bool, type(None)))},
        "iterations": res.iterations,
        "converged_by": res.converged_by,
        "z_trajectory": [z.tolist() for z in z_traj],
        "agent_nll": [list(map(float, h["agent_losses"])) for h in res.nll_history],
        "cv_solver": [h["solver"] for h in res.cv_history],
        "cv_nlpd": cv_f32,
        "cv_nlpd_f64_features": cv_f64,
        "z_final": np.asarray(res.z).tolist(),
        "test_metrics": {k: metrics[k] for k in ("nlpd", "rmse", "r2",
                                                  "within_1sigma", "within_2sigma")},
        "test_nlpd_f64_features": metrics_f64["nlpd"],
    }


if __name__ == "__main__":
    out = os.path.join(REPO, "tests", "fixtures", "torch_port_fidelity.json")
    data = record()
    with open(out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    spread = np.abs(np.subtract(data["cv_nlpd"], data["cv_nlpd_f64_features"]))
    print(f"wrote {out}: {data['iterations']} iterations, CV-NLPD "
          f"{data['cv_nlpd']}, f32-vs-f64 spread {spread.tolist()}, test NLPD "
          f"{data['test_metrics']['nlpd']:.4f} (f64 features "
          f"{data['test_nlpd_f64_features']:.4f})")
