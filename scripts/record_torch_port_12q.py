#!/usr/bin/env python
"""Record the JAX package on config #7 at 12 qubits, for ``chip_smoke.py``
phase 19c and the CPU tests (tests/test_torch_12q.py).

    JAX_PLATFORMS=cpu python scripts/record_torch_port_12q.py [--part NAME]

The JAX package runs on the CPU, 64-bit on (the GP side in float64, float32
features on its XLA engine, which fuses the circuit at 10 qubits and more as
the port's K3 does). It writes ``tests/fixtures/torch_port_12q.json`` with
four parts (``--part`` records one of them into the existing file):

* ``fixture``: config #7's fixture problem (``record_torch_port_config7.record``:
  the classical 2-D data, 999 training rows over 8 regional agents,
  streamed gradients, CV on the 512-row subsample, the CG posterior of the
  112 test rows) at chebyshev 12 qubits / 2 layers (P = 84) for
  ``chip_smoke.C12_FIX_ITERS`` iterations, with JAX's own spreads over
  float64 features and its other float32 engines (~10 minutes);
* ``cpu_train``: the same at ``chip_smoke.C12_CPU_SAMPLES`` samples over 2
  agents for 1 iteration, the CPU tests' ``train()`` at 12 qubits;
* ``run_e``: the JAX CLI on ``chip_smoke.RUN_E_FLAGS`` (config #7's CLI flags
  at 12 qubits, 1,999 training rows over 8 agents, 2 iterations, the
  condition numbers, the noise fit, the CG route) with ``--cond-mode host``,
  as the card resolves the CLI's "auto"; at the run's selected z, its test
  and train-subsample NLPD of the CG route with the fitted noise from
  float64 features and of the dense posterior (~15 minutes);
* ``run_e_cpu``: the same on ``chip_smoke.RUN_E_CPU_FLAGS``, the CPU tests'
  size.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dqgp_tpu import config as jconfig  # noqa: E402
from scripts.record_torch_port_cli import run_cli  # noqa: E402
from scripts.record_torch_port_config7 import record as record_problem  # noqa: E402
from scripts.record_torch_port_scale_out import nlpd_spread  # noqa: E402

HOST_COND = ["--cond-mode", "host"]


def record_cli_run(flags) -> dict:
    flags = flags + HOST_COND
    summary, split, seconds = run_cli(flags)
    spread = nlpd_spread(flags, summary, split)
    print(f"run E ({len(split['X_train'])} train rows): {seconds:.1f} s, test NLPD "
          f"{summary['test_metrics']['nlpd']:.6f}, sigma "
          f"{summary['noise_fit']['fitted_noise_std']:.6f}, at its z {spread}", flush=True)
    return {
        "nlpd_at_z": spread,
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


def record_training(n_samples: int, agents: int, iters: int) -> dict:
    t0 = time.time()
    out = record_problem(cs.C12_QUBITS, n_samples, agents, iters)
    out["seconds_cpu"] = time.time() - t0
    print(f"{n_samples} samples over {agents} agents, {iters} iterations: "
          f"{out['seconds_cpu']:.1f} s, nll_sum {out['nll_sum']}, CV-NLPD {out['cv_nlpd']}",
          flush=True)
    return out


PARTS = {
    "fixture": lambda: record_training(cs.C12_FIX_SAMPLES, cs.C12_FIX_AGENTS, cs.C12_FIX_ITERS),
    "cpu_train": lambda: record_training(cs.C12_CPU_SAMPLES, cs.C12_CPU_AGENTS,
                                         cs.C12_CPU_ITERS),
    "run_e": lambda: record_cli_run(cs.RUN_E_FLAGS),
    "run_e_cpu": lambda: record_cli_run(cs.RUN_E_CPU_FLAGS),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=list(PARTS), default=None,
                    help="record only this part into the existing fixture")
    args = ap.parse_args()
    assert jconfig.resolve_dtype_mode("auto") == "float64", "record on the CPU"
    assert jax.config.jax_enable_x64
    fixture = {"about": "JAX package on config #7 at 12 qubits "
                        "(scripts/record_torch_port_12q.py)",
               "jax_version": jax.__version__, "backend": jax.default_backend()}
    if args.part:
        with open(cs.Q12_FIXTURE) as f:
            fixture = {**json.load(f), **fixture}
    for part, record in PARTS.items():
        if args.part in (None, part):
            fixture[part] = record()
            with open(cs.Q12_FIXTURE, "w") as f:  # each part as soon as it is done
                json.dump(fixture, f, indent=1)
                f.write("\n")
    print(f"wrote {cs.Q12_FIXTURE}")


if __name__ == "__main__":
    main()
