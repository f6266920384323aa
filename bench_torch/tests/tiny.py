"""Small cells for the CPU tests: the benchmark's folder copied to a
temporary directory, with a configuration, workloads and a
``BENCHMARK.json`` small enough to run on the CPU in seconds."""

from __future__ import annotations

import io
import json
import math
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def gates_of(circuit) -> list:
    """The program's circuit as a configuration's gate list."""
    from dqgp_tpu_torch.ops.circuit import ENC_ARCCOS, ENC_ID, KIND_NAMES

    out = []
    for g in circuit.gates:
        d = {"kind": KIND_NAMES[g.kind], "q": g.qubit}
        if g.control >= 0:
            d["c"] = g.control
        if g.pidx >= 0:
            d["p"] = g.pidx
        for k in ("const", "pc", "fc", "pf"):
            if getattr(g, k):
                d[k] = getattr(g, k)
        if g.fidx >= 0:
            d["f"] = g.fidx
        if g.enc == ENC_ARCCOS:
            d["enc"] = "arccos"
        elif g.enc == ENC_ID:
            d["enc"] = "identity"
        out.append(d)
    return out


def tiny_config(qubits=2, layers=1, rows=(9, 10, 11, 12), compute_cond=False):
    from dqgp_tpu_torch.models.circuits import build_circuit

    c = build_circuit("chebyshev", qubits, 2, layers)
    big = json.load(open(os.path.join(BENCH, "configs", "northstar.json")))
    cfg = dict(big)
    cfg.update(name="tiny", reduced=[])
    cfg["circuit"] = {"family": "chebyshev", "qubits": qubits, "layers": layers, "features": 2,
                      "parameters": c.num_parameters, "gates": gates_of(c)}
    cfg["partition"] = {"method": "regional", "agent_rows": list(rows)}
    cfg["train"] = dict(big["train"], max_iter=3, compute_cond=compute_cond)
    cfg["posterior"] = {"train_rows": 60, "test_rows": 8, "domain": [-0.99, 0.99],
                        "target": "sine", "noise_std": 0.1, "block": 256, "cg_tol": 1e-5,
                        "cg_maxiter": 200, "precond_rank": 8, "jitter": 1e-6,
                        "dtype": "float32"}
    return cfg


def make_tree(tmp, cfg=None, limits_train=None, limits_post=None):
    """A copy of the benchmark folder under ``tmp`` with the tiny cells;
    returns (bench_dir, benchmark_json)."""
    bench_dir = os.path.join(str(tmp), "bench_torch")
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = cfg or tiny_config()
    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    lt = limits_train or {"loss": 1e-3, "cv": 1e-3, "step": 1e-3, "cond": 1e-3}
    lp = limits_post or {"mean": 1e-2, "var": 1e-2}
    cells = {
        "tiny.train": {"config": "tiny", "traffic": "train", "entry": "train", "iters": 3,
                       "chain_iters": 1, "ref_steps": 2, "limits": lt},
        "tiny.posterior": {"config": "tiny", "traffic": "posterior", "entry": "posterior",
                           "pool": 2, "limits": lp},
    }
    for name, wl in cells.items():
        with open(os.path.join(bench_dir, "workloads", f"{name}.json"), "w") as f:
            json.dump(wl, f)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "tiny", "source": "test", "file": "x", "reduced": [],
                             "why": "test"})
    for name, wl in cells.items():
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": wl["traffic"],
                                   "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            if m["name"] in ("iter_ms",) or m["name"].endswith(".train"):
                m["workloads"].append("tiny.train")
            if m["name"] in ("posterior_s",) or m["name"].endswith(".posterior"):
                m["workloads"].append("tiny.posterior")
    path = os.path.join(str(tmp), "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return bench_dir, path


def run_cell(bench_dir, bench_json, cell, seed=7, seconds=0.0, trace=0):
    """One CPU run of a cell through the harness; (exit code, last line)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], bench_dir=bench_dir, benchmark_json=bench_json,
                  require_cuda=False, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


INF = math.inf
