#!/usr/bin/env python
"""Record the JAX package's host condition numbers on config #7's fixture problem.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_config7_cond.py

Config #7 (chebyshev 10 qubits / 2 layers, projected Matérn) at the fixture
problem of ``scripts/record_torch_port_config7.py``: 1,111 samples, 999
training rows over 8 regional agents. At the fixture's z rows (its
``z_trajectory``, one row an iteration) it runs
``dqgp_tpu.driver.host_condition_numbers``: each agent's float64 Gram from
complex128 states at wrap(z), then an exact eigvalsh, as the CLI's default
(``compute_cond=True``, ``cond_mode="auto"``) reports them after training on
an accelerator. It adds them to ``tests/fixtures/torch_port_config7.json`` as
``host_cond`` ({"z_rows", "cond", "seconds"}) and leaves every other key as
it is; run it again after ``record_torch_port_config7.py``, which writes the
file anew. ``tests/test_torch_f64_warp.py`` holds the port's
``host_condition_numbers`` to these values on the CPU.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from sklearn.model_selection import train_test_split  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dqgp_tpu import driver  # noqa: E402
from dqgp_tpu.data import split_data_numpy  # noqa: E402
from dqgp_tpu.data.synthetic import generate_data_numpy  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec  # noqa: E402


def record(ref: dict) -> dict:
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", cs.C7_QUBITS, 2, cs.C7_LAYERS),
                             kernel_type="projected", outer_kernel="matern")
    X, Y = generate_data_numpy(cs.C7_FIX_SAMPLES, 2, 0.1, cs.C7_SEED)
    assert cs.array_digest(X) == ref["problem"]["x_sha256"]
    X_tr, _, Y_tr, _ = train_test_split(X, Y, test_size=cs.C7_TEST_SPLIT,
                                        random_state=cs.C7_SEED, shuffle=True)
    splits = split_data_numpy(X_tr, Y_tr, cs.C7_FIX_AGENTS, "regional", 1.0, cs.C7_SEED)
    assert [len(x) for x, _ in splits] == ref["problem"]["shard_sizes"]
    rows = np.array(ref["z_trajectory"])
    t0 = time.time()
    cond = driver.host_condition_numbers(spec, splits, rows)
    return {"z_rows": rows.tolist(), "cond": cond.tolist(), "seconds": time.time() - t0}


if __name__ == "__main__":
    with open(cs.CONFIG7_FIXTURE) as f:
        data = json.load(f)
    data["host_cond"] = record(data)
    with open(cs.CONFIG7_FIXTURE, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote host_cond into {cs.CONFIG7_FIXTURE} (jax {jax.__version__}): "
          f"{np.array(data['host_cond']['cond'])} in {data['host_cond']['seconds']:.1f} s")
