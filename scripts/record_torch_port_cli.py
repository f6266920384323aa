#!/usr/bin/env python
"""Record the JAX package's CLI on the flags of ``chip_smoke.py`` phase 17.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_cli.py

Runs ``dqgp_tpu.cli.main`` on the CPU (float64 GP: "auto" resolves to
float64 there) on each run of ``chip_smoke.CLI_RUNS``, with
``--cond-mode host`` added: the port's CLI on the card resolves its default
"auto" to "host", the exact float64 condition numbers after training, where
the JAX package on the CPU would resolve it to "device" (float32-built
Grams, floored at ~1e7-1e8). Condition numbers are reporting only, so the
trajectory is the same either way.

* Run A, the README's SRTM command (BASELINE config #2) with the noise fit,
  on the stand-in tiles of ``scripts/make_synthetic_tiles.py`` (written into
  ``srtm_data/`` where missing; their sha256 digests are recorded);
* Run B, BASELINE config #5 in the quantum-dataset mode. Beside it the CV
  NLPD at each iteration's z and the test NLPD are recomputed from float64
  features (``scripts/record_torch_port_fidelity.py``'s helpers), so the
  fixture carries JAX's own float32-vs-float64 spread, the bar of config
  #5's ill-conditioned NLPDs.

For each run the fixture holds the summary (as ``--metrics-json`` writes
it), the z and CV-NLPD trajectories, and the dataset after the split, as
the CLI split it (sklearn's ``train_test_split``, captured): digests of
X_train and X_test, Y_train and Y_test themselves. It writes
``tests/fixtures/torch_port_cli.json``; ``chip_smoke.py`` phase 17 and
``tests/test_torch_cli.py`` hold the port's CLI to it.
"""

import contextlib
import io
import json
import os
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import sklearn.model_selection  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dqgp_tpu import cli  # noqa: E402
from dqgp_tpu import config as jconfig  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.gp import cv as jcv  # noqa: E402
from dqgp_tpu.models.gp import posterior as jpost  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec  # noqa: E402
from scripts.make_synthetic_tiles import TILES, ensure_tiles  # noqa: E402
from scripts.record_torch_port_fidelity import (  # noqa: E402
    cv_nlpd, float64_features, test_nlpd)


def run_cli(flags):
    """dqgp_tpu.cli.main(flags), its output discarded -> (the summary as
    --metrics-json writes it, the split it made, seconds)."""
    split = {}
    real_split = sklearn.model_selection.train_test_split

    def capture(*a, **k):
        out = real_split(*a, **k)
        split["X_train"], split["X_test"], split["Y_train"], split["Y_test"] = out[:4]
        return out

    t0 = time.time()
    with mock.patch.object(sklearn.model_selection, "train_test_split", capture), \
            contextlib.redirect_stdout(io.StringIO()):
        summary = cli.main(flags)
    seconds = time.time() - t0
    return json.loads(json.dumps(cli._json_sanitize(summary), default=float)), split, seconds


def record_run(name: str) -> dict:
    flags = cs.CLI_RUNS[name] + ["--cond-mode", "host"]
    summary, split, seconds = run_cli(flags)
    print(f"run {name}: {seconds:.1f} s, test NLPD {summary['test_metrics']['nlpd']:.6f}")
    run = {
        "flags": flags,
        "seconds_cpu": seconds,
        "summary": summary,
        "z_trajectory": [h["consensus_params"] for h in summary["cv_history"]],
        "cv_nlpd": [h["consensus_cv_score"] for h in summary["cv_history"]],
        "dataset": {
            "x_train_sha256": cs.array_digest(split["X_train"]),
            "x_test_sha256": cs.array_digest(split["X_test"]),
            "Y_train": split["Y_train"].tolist(),
            "Y_test": split["Y_test"].tolist(),
        },
    }
    if name == "A":
        run["tiles_sha256"] = {t: cs.file_digest(os.path.join(cs.SRTM_DIR, f"{t}.hgt"))
                               for t in TILES}
    else:
        run.update(fidelity_spread(summary, split))
    return run


def fidelity_spread(summary: dict, split: dict) -> dict:
    """Run B's CV and test NLPD from float32 (the CLI's) and float64
    features at the run's own z values."""
    spec = QuantumKernelSpec(
        circuit=build_circuit("kyriienko", cs.FID_QUBITS, 1, cs.FID_LAYERS),
        kernel_type="fidelity")
    cfg = summary["config"]
    X, Y = split["X_train"], split["Y_train"]
    cv32, cv64 = [], []
    for h in summary["cv_history"]:
        z, seed = h["consensus_params"], cfg["seed"] + h["iteration"]
        cv32.append(cv_nlpd(spec, X, Y, z, seed, cfg["cv_folds"]))
        with float64_features(jcv):
            cv64.append(cv_nlpd(spec, X, Y, z, seed, cfg["cv_folds"]))
    assert np.allclose(cv32, [h["consensus_cv_score"] for h in summary["cv_history"]],
                       rtol=0, atol=1e-9), cv32
    z = summary["best_cv_z"]
    args = (spec, X, Y, split["X_test"], split["Y_test"], z, cfg["noise_std"])
    t32 = test_nlpd(*args)["nlpd"]
    assert abs(t32 - summary["test_metrics"]["nlpd"]) <= 1e-9, t32
    with float64_features(jpost):
        t64 = test_nlpd(*args, jit=False)["nlpd"]
    return {"cv_nlpd_f64_features": cv64, "test_nlpd_f64_features": t64}


def main() -> None:
    assert jconfig.resolve_dtype_mode("auto") == "float64", "record on the CPU"
    ensure_tiles(cs.SRTM_DIR)
    fixture = {
        "about": "JAX package's CLI on chip_smoke.CLI_RUNS' flags "
                 "(scripts/record_torch_port_cli.py)",
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "runs": {name: record_run(name) for name in cs.CLI_RUNS},
    }
    with open(cs.CLI_FIXTURE, "w") as f:
        json.dump(fixture, f, indent=1)
    print(f"wrote {cs.CLI_FIXTURE}")


if __name__ == "__main__":
    main()
