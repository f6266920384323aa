#!/usr/bin/env python
"""Record the JAX float64 reference that the PyTorch port is held to.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_reference.py
    JAX_PLATFORMS=cpu python scripts/record_torch_port_reference.py \
        --iters 25 --out tests/fixtures/torch_port_northstar_25.json

Runs ``dqgp_tpu.driver.train`` on the CPU on the north-star problem that
``chip_smoke.py`` builds (bench.py:52-77 plus 200 held-out rows), for
``--iters`` ADMM iterations (default ``chip_smoke.ITERS``) with per-iteration
5-fold CV, then ``predict_quantum_gp`` + ``evaluate_predictions`` on the
held-out rows, and writes ``--out`` (default
``tests/fixtures/torch_port_northstar.json``; the 25-iteration run of the
bench gate, bench.py:59-60, is ``chip_smoke.FIXTURE_25``). The GP side is
direct float64 (the "auto" resolution on CPU/GPU); features are the JAX XLA
engine's float32. chip_smoke.py imports no JAX, so on the GPU these files are
its reference.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dqgp_tpu import driver  # noqa: E402
from dqgp_tpu.data import split_data_numpy  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.gp.metrics import evaluate_predictions  # noqa: E402
from dqgp_tpu.models.gp.posterior import predict_quantum_gp  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec  # noqa: E402


def record(iters: int) -> dict:
    X, Y, X_test, Y_test = cs.make_problem()
    spec = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES,
                              cs.NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")
    splits = split_data_numpy(X, Y, cs.N_AGENTS, "regional")
    cfg = driver.TrainConfig(max_iter=iters, verbose=False)
    res = driver.train(spec, splits, X, Y, cfg)
    mean, var = predict_quantum_gp(spec, jnp.asarray(X), jnp.asarray(Y),
                                   jnp.asarray(X_test), jnp.asarray(res.z),
                                   noise_std=cfg.noise_std)
    metrics = evaluate_predictions(Y_test, np.asarray(mean), np.asarray(var))
    return {
        "about": "JAX float64 reference for the PyTorch port's north-star run "
                 "(scripts/record_torch_port_reference.py)",
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "problem": {
            "source": "bench.py:52-77 + 200 held-out rows (chip_smoke.make_problem)",
            "n_train": cs.N_SAMPLES, "n_test": cs.N_TEST, "agents": cs.N_AGENTS,
            "shard_sizes": [int(x.shape[0]) for x, _ in splits],
            "encoding": "chebyshev", "num_qubits": cs.NUM_QUBITS,
            "num_layers": cs.NUM_LAYERS, "kernel": "projected/matern nu=1.5",
            "sha256": cs.problem_digest(X, Y, X_test, Y_test),
        },
        "train_config": {k: v for k, v in vars(cfg).items()
                         if isinstance(v, (int, float, str, bool, type(None)))},
        "iterations": res.iterations,
        "converged_by": res.converged_by,
        "z_trajectory": [h["consensus_params"].tolist() for h in res.cv_history],
        "cv_nlpd": [h["consensus_cv_score"] for h in res.cv_history],
        "cv_solver": [h["solver"] for h in res.cv_history],
        "total_nll": [h["total_nll"] for h in res.nll_history],
        "z_final": np.asarray(res.z).tolist(),
        "test_metrics": {k: metrics[k] for k in ("nlpd", "rmse", "r2", "within_1sigma",
                                                  "within_2sigma")},
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=cs.ITERS, help="ADMM iterations")
    ap.add_argument("--out", default=cs.FIXTURE, help="the fixture file to write")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    data = record(args.iters)
    with open(out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {out}: {data['iterations']} iterations, test NLPD "
          f"{data['test_metrics']['nlpd']:.4f}")
