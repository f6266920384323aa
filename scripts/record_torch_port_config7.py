#!/usr/bin/env python
"""Record the JAX reference for the PyTorch port's config #7 fixture problem.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_config7.py

BASELINE config #7 (the scale-out case, BASELINE.md:41) at full width and cut
depth: the classical 2-D dataset ``generate_data_numpy(1111, 2, 0.1, 42)``,
sklearn's ``train_test_split`` (test split 0.1, seed 42: 999 train and 112
test rows), a regional partition over 8 agents, chebyshev 10 qubits / 2
layers under a projected Matérn kernel, rho = L = 100, noise 0.1, and
``dqgp_tpu.driver.train`` for ``chip_smoke.C7_FIX_ITERS`` ADMM iterations
with streamed gradients, CV on a 512-row subsample and ``compute_cond=False``;
then ``parallel.blocked.make_cg_predictor`` on all 999 training rows at the
selected z, with its defaults, on the 112 test rows.

The JAX package runs on the CPU: float32 features on its XLA engine, the GP
side in float64. It writes ``tests/fixtures/torch_port_config7.json``: a
digest of the problem, the z trajectory, theta and psi, every iteration's
agent NLLs, the CV history, the CG posterior's mean, variance, iteration
counts and test metrics. Beside them it records the agent NLLs, the CV-NLPD
at the same z values and the CG test NLPD from float64 features, so the
fixture carries JAX's own float32-vs-float64 spread, as the fidelity fixture
does; the agent NLLs at the same z values re-scored from float32 features
outside the jitted step, on the gate-by-gate engine and on the gate-fused
program (the program K3 runs), so it carries the spread between the JAX
package's own float32 implementations; and the
CG test NLPD with the CG itself in float32, the type make_cg_predictor
takes on an accelerator (blocked.py:1208-1213; the port solves in float64
on every device). The predictive variances here are ~1e-4, formed by cancellation from
k(x, x) = 1, so the CG's type moves the test NLPD by ~0.5.
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
from dqgp_tpu.data.synthetic import generate_data_numpy  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.gp import cv as jcv  # noqa: E402
from dqgp_tpu.models.gp.metrics import evaluate_predictions  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec  # noqa: E402
from dqgp_tpu.models.kernels import quantum_kernel as jqk  # noqa: E402
from dqgp_tpu.parallel.blocked import make_cg_predictor  # noqa: E402


def float64_features(module):
    """Patch ``module``'s kernel_features to build float64 features."""
    return mock.patch.object(module, "kernel_features",
                             functools.partial(jqk.kernel_features, dtype=jnp.float64))


def cv_nlpd(spec, X, Y, z, seed, folds):
    tr_i, tr_m, va_i, va_m = jcv.kfold_pad_indices_np(len(X), folds, seed)
    scores = jcv.cv_fold_scores_impl(spec, jnp.asarray(X), jnp.asarray(Y),
                                     jnp.asarray(z), tr_i, tr_m, va_i, va_m)
    return jcv.aggregate_cv_scores(*scores, folds)["mean_nlpd"]


def accelerator_dtype():
    """make_cg_predictor's dtype rule reads the backend: off the CPU it
    solves in float32. A non-TPU accelerator's name keeps the features on
    the XLA engine."""
    return mock.patch.object(jax, "default_backend", lambda: "gpu")


def cg_predict(spec, X_tr, Y_tr, X_te, Y_te, z, noise_std):
    predict = make_cg_predictor(spec, X_tr, Y_tr, jnp.asarray(z, jnp.float64), noise_std)
    mean, var = predict(X_te)
    res = predict.alpha_result
    return (np.asarray(mean), np.asarray(var),
            evaluate_predictions(Y_te, np.asarray(mean), np.asarray(var)),
            int(res.iterations), float(res.residual_norm))


def fused_program_features():
    """Patch the XLA engine to run the gate-fused op program (ops/fusion.py):
    the program the fused Pauli-feature kernel (K3) runs on a TPU, and the
    port's K3 on the card."""
    from dqgp_tpu.ops.fusion import state_from_angles_fused

    return mock.patch.object(jqk, "state_from_angles", state_from_angles_fused)


def agent_nll_at(spec, splits, z_traj, dtype=jnp.float32):
    """Every iteration's agent NLLs at its z, scored eagerly: the step's Gram
    at wrap(z) from ``dtype`` features, then the float64 NLL."""
    from dqgp_tpu import manifold as JM
    from dqgp_tpu.models.gp.posterior import masked_nll_core
    from dqgp_tpu.parallel import make_agent_batch

    b = make_agent_batch(splits)
    out = []
    for z in z_traj:
        zw = JM.wrap(jnp.asarray(z))
        row = []
        for a in range(b.X.shape[0]):
            K = jqk.gram(spec, b.X[a], zw, dtype=dtype)
            row.append(float(masked_nll_core(K.astype(jnp.float64), b.Y[a], b.mask[a], 0.1,
                                             compute_cond=False)[0].nll))
        out.append(row)
    return out


def record(qubits: int = cs.C7_QUBITS, n_samples: int = cs.C7_FIX_SAMPLES,
           agents: int = cs.C7_FIX_AGENTS, iters: int = cs.C7_FIX_ITERS) -> dict:
    """The fixture problem; other widths and cuts of config #7 with the
    arguments (scripts/record_torch_port_12q.py: 12 qubits)."""
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", qubits, 2, cs.C7_LAYERS),
                             kernel_type="projected", outer_kernel="matern")
    X, Y = generate_data_numpy(n_samples, 2, 0.1, cs.C7_SEED)
    X_tr, X_te, Y_tr, Y_te, tr_idx, te_idx = train_test_split(
        X, Y, np.arange(len(X)), test_size=cs.C7_TEST_SPLIT,
        random_state=cs.C7_SEED, shuffle=True)
    splits = split_data_numpy(X_tr, Y_tr, agents, "regional", 1.0, cs.C7_SEED)
    cfg = driver.TrainConfig(max_iter=iters, seed=cs.C7_SEED,
                             grad_method="streamed", cv_max_samples=cs.C7_CV_MAX,
                             compute_cond=False, verbose=False)
    res = driver.train(spec, splits, X_tr, Y_tr, cfg)
    z_traj = [np.asarray(h["consensus_params"]) for h in res.cv_history]

    # the CV subsample, drawn as dqgp_tpu/driver.py:521-529 draws it (all
    # rows where they are no more than cv_max_samples)
    sel = (np.random.RandomState(cfg.seed).choice(len(X_tr), cfg.cv_max_samples,
                                                  replace=False)
           if len(X_tr) > cfg.cv_max_samples else np.arange(len(X_tr)))
    X_cv, Y_cv = X_tr[sel], Y_tr[sel]
    cv_f32, cv_f64 = [], []
    for it, z in enumerate(z_traj, start=1):
        cv_f32.append(cv_nlpd(spec, X_cv, Y_cv, z, cfg.seed + it, cfg.cv_folds))
        with float64_features(jcv):
            cv_f64.append(cv_nlpd(spec, X_cv, Y_cv, z, cfg.seed + it, cfg.cv_folds))
    # the driver scores CV inside its jitted step program, whose fusion
    # rounds the float32 features differently from the re-score here
    cv_driver = [h["consensus_cv_score"] for h in res.cv_history]
    assert np.allclose(cv_f32, cv_driver, rtol=0, atol=1e-5), (cv_f32, cv_driver)

    with fused_program_features():
        fused_nll = agent_nll_at(spec, splits, z_traj)

    mean, var, metrics, cg_iters, cg_resid = cg_predict(
        spec, X_tr, Y_tr, X_te, Y_te, res.z, cfg.noise_std)
    with float64_features(jqk):
        _, _, metrics_f64, _, _ = cg_predict(spec, X_tr, Y_tr, X_te, Y_te, res.z,
                                             cfg.noise_std)
    with accelerator_dtype():
        mean32, _, metrics_cg32, cg32_iters, _ = cg_predict(
            spec, X_tr, Y_tr, X_te, Y_te, res.z, cfg.noise_std)
    assert mean32.dtype == np.float32

    return {
        "about": "JAX reference for the PyTorch port's config #7 fixture problem "
                 "(scripts/record_torch_port_config7.py)",
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "problem": {
            "source": f"BASELINE.md:41 config #7 at full width, {n_samples} samples over "
                      f"{agents} agents; cli.py:342-378 classical data flow",
            "n_samples": n_samples, "test_split": cs.C7_TEST_SPLIT,
            "agents": agents, "seed": cs.C7_SEED,
            "encoding": "chebyshev", "num_qubits": qubits,
            "num_layers": cs.C7_LAYERS, "kernel": "projected", "outer_kernel": "matern",
            "x_sha256": cs.array_digest(X),
            "y_sha256": cs.array_digest(Y),
            "train_idx_sha256": cs.array_digest(tr_idx.astype(np.float64)),
            "cv_subsample_sha256": cs.array_digest(sel.astype(np.float64)),
            "shard_sizes": [int(x.shape[0]) for x, _ in splits],
        },
        "train_config": {k: v for k, v in vars(cfg).items()
                         if isinstance(v, (int, float, str, bool, type(None)))},
        "iterations": res.iterations,
        "converged_by": res.converged_by,
        "z_trajectory": [z.tolist() for z in z_traj],
        "theta": np.asarray(res.theta).tolist(),
        "psi": np.asarray(res.psi).tolist(),
        "agent_nll": [list(map(float, h["agent_losses"])) for h in res.nll_history],
        "nll_sum": [float(h["total_nll"]) for h in res.nll_history],
        "agent_nll_f64_features": agent_nll_at(spec, splits, z_traj, jnp.float64),
        "agent_nll_eager_f32": agent_nll_at(spec, splits, z_traj),
        "agent_nll_fused_f32": fused_nll,
        "cv_solver": [h["solver"] for h in res.cv_history],
        "cv_nlpd": cv_driver,
        "cv_nlpd_f64_features": cv_f64,
        "z_final": np.asarray(res.z).tolist(),
        "cg": {"alpha_iterations": cg_iters, "alpha_residual": cg_resid,
               "mean": mean.tolist(), "var": var.tolist()},
        "test_metrics": {k: metrics[k] for k in ("nlpd", "rmse", "r2",
                                                  "within_1sigma", "within_2sigma")},
        "test_nlpd_f64_features": metrics_f64["nlpd"],
        "test_nlpd_f32_cg": metrics_cg32["nlpd"],
        "cg_f32_alpha_iterations": cg32_iters,
    }


if __name__ == "__main__":
    out = os.path.join(REPO, "tests", "fixtures", "torch_port_config7.json")
    data = record()
    with open(out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    spread = np.abs(np.subtract(data["cv_nlpd"], data["cv_nlpd_f64_features"]))
    print(f"wrote {out}: {data['iterations']} iterations, nll_sum {data['nll_sum']}, "
          f"CV-NLPD {data['cv_nlpd']}, f32-vs-f64 spread {spread.tolist()}, CG "
          f"{data['cg']['alpha_iterations']} iterations, test NLPD "
          f"{data['test_metrics']['nlpd']:.4f} (f64 features "
          f"{data['test_nlpd_f64_features']:.4f}, f32 CG {data['test_nlpd_f32_cg']:.4f})")
