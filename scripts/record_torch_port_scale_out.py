#!/usr/bin/env python
"""Record the JAX package's CLI on the flags of ``chip_smoke.py`` phase 18b.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_scale_out.py [--part cpu_runs|runs]

Runs ``dqgp_tpu.cli.main`` on the CPU with 64-bit on (float64 GP, and the CG
posterior in float64) on each run of ``chip_smoke.SCALE_OUT_RUNS`` (config
#7's CLI flags with ``--regularization thresholding`` / ``tikhonov`` on the
CG route, cut to 1,999 train rows, 8 agents and 2 iterations; ~11 minutes)
and of ``chip_smoke.SCALE_OUT_CPU_RUNS`` (the same flags at the north star's
circuit and 270 train rows, the CPU tests' size; ~1 minute). ``--part``
records one of the two into the existing fixture.

For each run the fixture holds the summary (as ``--metrics-json`` writes
it), the z and CV-NLPD trajectories, the dataset after the split (digests
of X_train and X_test, Y_train and Y_test themselves), what the low-rank
eigenvalue clip found in the CG predictor (``make_lowrank_regularizer``'s
lambda_min, shift, nonzero weights and ``saturated``, captured), and at the
run's selected z the test and train-subsample NLPD of the CG route from
float64 features and of the dense posterior: JAX's own spread of those
NLPDs, which set the bar of the port's (config #7's test NLPD is
ill-conditioned: its variances are small differences that the CG's
tolerance and the features' last ulps move). It writes
``tests/fixtures/torch_port_scale_out.json``; ``chip_smoke.py`` phase 18b
and ``tests/test_torch_cli.py`` hold the port's CLI to it.
"""

import argparse
import json
import os
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dqgp_tpu import config as jconfig  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.gp import posterior as jpost  # noqa: E402
from dqgp_tpu.models.gp.metrics import evaluate_predictions  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec  # noqa: E402
from dqgp_tpu.models.kernels import quantum_kernel as jqk  # noqa: E402
from dqgp_tpu.parallel import blocked as jblocked  # noqa: E402
from scripts.record_torch_port_cli import run_cli  # noqa: E402
from scripts.record_torch_port_config7 import float64_features  # noqa: E402


def clip_record(reg) -> dict:
    return {"lambda_min": float(reg.lambda_min), "shift": float(reg.shift),
            "nonzero_w": int(np.count_nonzero(np.asarray(reg.w))),
            "saturated": bool(reg.saturated), "rank": int(reg.V.shape[1]),
            "n": int(reg.V.shape[0]), "dtype": str(reg.V.dtype)}


def nlpd_spread(flags, summary, split) -> dict:
    """At the run's selected z, as the CLI predicts (the CG route on the
    test rows and the seeded train subsample, with the fitted noise where
    the run fits it): the NLPDs from float32 features (the run's own), from
    float64 features, and of the dense posterior (square Gram through
    regularize_gram where the run regularizes)."""
    def flag(name):
        return flags[flags.index(name) + 1]

    spec = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", int(flag("--num-qubits")), 2,
                              int(flag("--num-layers"))),
        kernel_type="projected", outer_kernel="matern",
        regularization=flag("--regularization") if "--regularization" in flags else None)
    cfg = summary["config"]
    noise = (summary["noise_fit"]["fitted_noise_std"] if summary.get("noise_fit")
             else cfg["noise_std"])
    z = jnp.asarray(summary["best_cv_z"], jnp.float64)
    X_tr, Y_tr = split["X_train"], split["Y_train"]
    sub_n = min(len(X_tr), max(int(flag("--predict-cg-threshold")), 1024))
    sel = np.random.RandomState(cfg["seed"]).choice(len(X_tr), sub_n, replace=False)
    parts = {"test": (split["X_test"], split["Y_test"]), "train": (X_tr[sel], Y_tr[sel])}
    out = {}
    for label in ("f32", "f64_features"):
        with float64_features(jqk) if label == "f64_features" else mock.patch.dict({}):
            predict = jblocked.make_cg_predictor(spec, X_tr, Y_tr, z, noise)
            for part, (X, Y) in parts.items():
                mean, var = predict(X)
                out[f"{part}_nlpd_{label}"] = evaluate_predictions(
                    Y, np.asarray(mean), np.asarray(var))["nlpd"]
    for part, (X, Y) in parts.items():
        mean, var = jpost.predict_quantum_gp(spec, jnp.asarray(X_tr), jnp.asarray(Y_tr),
                                             jnp.asarray(X), z, noise_std=noise)
        out[f"{part}_nlpd_dense"] = evaluate_predictions(Y, np.asarray(mean),
                                                         np.asarray(var))["nlpd"]
        assert abs(out[f"{part}_nlpd_f32"] - summary[f"{part}_metrics"]["nlpd"]) <= 1e-9, out
    return out


def record_run(flags) -> dict:
    clips = []
    real = jblocked.make_lowrank_regularizer

    def capture(*args, **kwargs):
        reg = real(*args, **kwargs)
        clips.append(clip_record(reg))
        return reg

    with mock.patch.object(jblocked, "make_lowrank_regularizer", capture):
        summary, split, seconds = run_cli(flags)
    spread = nlpd_spread(flags, summary, split)
    print(f"{flags[-1]}: {seconds:.1f} s, test NLPD {summary['test_metrics']['nlpd']:.6f}, "
          f"clip {clips}, at its z {spread}")
    return {
        "nlpd_at_z": spread,
        "flags": flags,
        "seconds_cpu": seconds,
        "summary": summary,
        "z_trajectory": [h["consensus_params"] for h in summary["cv_history"]],
        "cv_nlpd": [h["consensus_cv_score"] for h in summary["cv_history"]],
        "clip": clips,
        "dataset": {
            "x_train_sha256": cs.array_digest(split["X_train"]),
            "x_test_sha256": cs.array_digest(split["X_test"]),
            "Y_train": split["Y_train"].tolist(),
            "Y_test": split["Y_test"].tolist(),
        },
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=["cpu_runs", "runs"], default=None,
                    help="record only these runs into the existing fixture")
    args = ap.parse_args()
    assert jconfig.resolve_dtype_mode("auto") == "float64", "record on the CPU"
    assert jax.config.jax_enable_x64
    fixture = {"about": "JAX package's CLI on chip_smoke.SCALE_OUT_RUNS' and "
                        "SCALE_OUT_CPU_RUNS' flags (scripts/record_torch_port_scale_out.py)",
               "jax_version": jax.__version__, "backend": jax.default_backend()}
    if args.part:
        with open(cs.SCALE_OUT_FIXTURE) as f:
            fixture = {**json.load(f), **fixture}
    parts = {"cpu_runs": cs.SCALE_OUT_CPU_RUNS, "runs": cs.SCALE_OUT_RUNS}
    for part, runs in parts.items():
        if args.part in (None, part):
            fixture[part] = {name: record_run(flags) for name, flags in runs.items()}
    with open(cs.SCALE_OUT_FIXTURE, "w") as f:
        json.dump(fixture, f, indent=1)
    print(f"wrote {cs.SCALE_OUT_FIXTURE}")


if __name__ == "__main__":
    main()
