"""CPU tests of the port's benchmark harness (``bench_torch/``).

    python -m pytest bench_torch/tests -q

They cover the generator (the same shapes for every seed), the copied
counts against ``chip_smoke.py``'s arithmetic, the plain reference against
the port's plain engines, the last line's format, the discovery of added
workload and metric files, the faults and the control (each must read not
correct), and that the harness refuses to run without a card."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import tiny  # noqa: E402
from bench_torch import counts, faults, reference as R, traffic  # noqa: E402
from bench_torch.entries import train as train_entry  # noqa: E402

BENCH = tiny.BENCH
ROOT = tiny.ROOT
CONFIGS = ("northstar", "config7")
SEEDS = (0, 1, 12345, 2**31 + 17, 2**40 + 3)


def config(name):
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


# --- the generator ------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_training_data_same_shapes_every_seed(name):
    cfg = config(name)
    counts_ = cfg["partition"]["agent_rows"]
    lo, hi = cfg["data"]["domain"]
    firsts = set()
    for seed in SEEDS:
        splits, X, Y = traffic.training_data(cfg, seed)
        assert [len(x) for x, _ in splits] == counts_
        assert X.shape == (sum(counts_), cfg["data"]["dim"]) and Y.shape == (len(X),)
        assert X.min() >= lo and X.max() <= hi
        assert np.isfinite(Y).all()
        firsts.add(float(X[0, 0]))
    assert len(firsts) == len(SEEDS)  # the values move with the seed


def test_training_data_is_the_programs_regional_split():
    from dqgp_tpu_torch.data import split_data_numpy

    cfg = config("northstar")
    splits, X, Y = traffic.training_data(cfg, 3)
    theirs = split_data_numpy(X, Y, len(splits), "regional")
    for (a, ya), (b, yb) in zip(splits, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ya, yb)


def test_posterior_data_same_shapes_every_seed():
    cfg = config("config7")
    p = cfg["posterior"]
    for seed in SEEDS:
        X, Y, theta = traffic.posterior_data(cfg, seed, 0)
        assert X.shape == (p["train_rows"] + p["test_rows"], 2) and X.dtype == np.float32
        assert Y.shape == (p["train_rows"],) and theta.shape == (cfg["circuit"]["parameters"],)
        assert np.abs(X).max() <= 0.99 and theta.min() >= 0 and theta.max() < math.pi


def test_small_seeds_fit_the_programs_seeding():
    for seed in SEEDS:
        s = traffic.small_seed(seed, 4, 7)
        assert 0 <= s and s + 10_000 < 2**32


# --- the counts -----------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_counts_are_chip_smokes_arithmetic(name):
    import chip_smoke as cs
    from dqgp_tpu_torch.models.circuits import build_circuit

    cfg = config(name)
    c = cfg["circuit"]
    circuit = build_circuit(c["family"], c["qubits"], c["features"], c["layers"])
    assert tiny.gates_of(circuit) == c["gates"]
    n = c["qubits"]
    gate, fused = cs.gate_ops(circuit), cs.fused_program_ops(circuit)
    assert counts.gate_ops(c) == gate == cfg["counts"]["gate_sequence_ops_per_sample"]
    assert fused == cfg["counts"]["fused_program_ops_per_sample"]
    assert counts.feature_ops(n) == cs.feature_ops(n) == cfg["counts"]["reduction_ops_per_sample"]
    # the features read the same work whichever kernel computes them
    assert cfg["counts"]["feature_ops_per_sample"] == min(gate, fused) + cs.feature_ops(n)
    rows = 1000
    k1_ms, _ = cs.k1_bound(circuit, rows)
    if gate <= fused:
        assert counts.feature_least_s(cfg, rows) * 1e3 == pytest.approx(k1_ms, rel=1e-12)


def test_train_counts_are_below_the_peaks_at_the_measured_times():
    """The counted work of an iteration at the card's peaks takes less than
    the fastest iteration PERF.md records, so no share can pass 100 %."""
    assert counts.train_iteration_least_s(config("northstar")) < 8.1e-3
    assert counts.train_iteration_least_s(config("config7")) < 0.643


def test_posterior_counts_are_below_the_peaks_at_the_measured_times():
    """At the most matvecs the CG can run (both solves at cg_maxiter), the
    posterior's counted work at the FP32 peak takes less than the fastest
    posterior PERF.md records."""
    cfg = config("config7")
    most = cfg["posterior"]["cg_maxiter"]
    assert counts.posterior_least_s(cfg, 2 * most, most) < 7.17
    assert counts.gram_tile(cfg) == (20480, 30, 4096)


def test_the_traces_gram_tiles_count_the_cgs_matvecs(monkeypatch):
    """The Gram tiles that the traced posterior's products hold, over the
    tiles a matvec, are every matvec that the two CG solves made."""
    from bench_torch import trace as trace_mod
    from bench_torch.entries import posterior as post_entry
    import dqgp_tpu_torch.parallel.blocked as blocked

    made, cg = [], blocked.cg_solve

    def counted(*a, **k):
        res = cg(*a, **k)
        made.append(res.iterations)
        return res

    monkeypatch.setattr(blocked, "cg_solve", counted)
    cfg = tiny.tiny_config(qubits=4, layers=2)
    e = post_entry.Entry(cfg, {"pool": 1}, 5, "cpu")
    with trace_mod.profiler("cpu") as prof:
        out = e.unit(0)
    tr = trace_mod.read(prof, 1.0)
    rows, inner, width = counts.gram_tile(cfg)
    tiles = tr.products(rows, inner, width)
    assert len(made) == 2 and made[0] == out["cg_iterations"]
    assert tiles == sum(made) * (rows // width) > 0


def _run(cfg, trace, **kw):
    import types

    base = dict(cfg=cfg, trace=trace, counts=counts, units=[], traced_work=1,
                untraced_work=0, untraced_s=0.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _metric(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, "metrics",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_mfu_posterior_counts_from_the_configuration():
    """A redundant product in the trace moves nothing; the matvecs come
    from the tiles alone, and a trace with none reads nothing."""
    from bench_torch.trace import Trace

    cfg = config("config7")
    rows, inner, width = counts.gram_tile(cfg)
    tile = ("aten::mm", 0.0, 1.0, [[rows, inner], [inner, width]])
    extra = ("aten::mm", 0.0, 1.0, [[20000, 512], [512, 512]])
    read = _metric("mfu.posterior")
    tr = Trace(window_s=7.0, kernels=[("k", 0.0, 1.0)], ops=[tile] * (5 * 300) + [extra] * 9)
    units = [{"cg_iterations": 150}]
    got = read(_run(cfg, tr, units=units))
    want = 100.0 * counts.posterior_least_s(cfg, 300, 150) / 7.0
    assert got == pytest.approx(want) and 0 < got < 100
    assert read(_run(cfg, Trace(window_s=7.0, kernels=[("k", 0.0, 1.0)], ops=[extra]),
                     units=units)) is None


def test_mfu_train_reads_the_untraced_iterations():
    from bench_torch.trace import Trace

    cfg = config("config7")
    read = _metric("mfu.train")
    tr = Trace(window_s=9.0, kernels=[("k", 0.0, 1.0)])
    got = read(_run(cfg, tr, traced_work=10, untraced_work=40, untraced_s=26.0))
    assert got == pytest.approx(100.0 * counts.train_iteration_least_s(cfg) / 0.65)
    assert read(_run(cfg, tr, traced_work=10)) is None


# --- the reference against the program's plain engines -------------------------

def _spec_and_circ(qubits=4, layers=2):
    cfg = tiny.tiny_config(qubits=qubits, layers=layers)
    return cfg, train_entry.program_spec(cfg), R.Circuit(cfg["circuit"], "cpu")


def test_reference_features_match_the_plain_engine():
    from dqgp_tpu_torch.models.kernels.quantum_kernel import kernel_features

    cfg, spec, circ = _spec_and_circ()
    X = torch.rand(50, 2, dtype=torch.float64) * 1.98 - 0.99
    theta = torch.rand(cfg["circuit"]["parameters"], dtype=torch.float64) * math.pi
    for real, tol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
        got = kernel_features(spec, X, theta, real)
        want = circ.features(X, theta, real)
        torch.testing.assert_close(want.double(), got.double(), atol=tol, rtol=0)


@pytest.mark.parametrize("family", ("chebyshev", "yz_cx", "hubregtsen", "kyriienko",
                                    "multi_control", "layered", "random", "highdim"))
def test_reference_runs_every_family_of_the_program(family):
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
    from dqgp_tpu_torch.models.kernels.quantum_kernel import kernel_features

    c = build_circuit(family, 3, 2, 2)
    circ = R.Circuit({"qubits": 3, "gates": tiny.gates_of(c)}, "cpu")
    spec = QuantumKernelSpec(circuit=c, kernel_type="projected", outer_kernel="matern")
    X = torch.rand(20, 2, dtype=torch.float64) * 1.98 - 0.99
    theta = torch.rand(c.num_parameters, dtype=torch.float64) * math.pi
    torch.testing.assert_close(circ.features(X, theta, torch.float64),
                               kernel_features(spec, X, theta, torch.float64),
                               atol=1e-12, rtol=0)


def test_reference_nll_and_gradient_match_the_program():
    from dqgp_tpu_torch.parallel.consensus import agent_updates, make_agent_batch

    cfg, spec, circ = _spec_and_circ()
    splits, _, _ = traffic.training_data(cfg, 4)
    ag = R.Agents(splits, "cpu")
    z = torch.rand(cfg["circuit"]["parameters"], dtype=torch.float64) * math.pi
    psi = torch.rand(len(splits), cfg["circuit"]["parameters"], dtype=torch.float64)
    nll, grad = R.agent_nll(circ, cfg["kernel"], ag, z, 0.1, with_grad=True)
    batch = make_agent_batch(splits, "cpu")
    th, ps, res = agent_updates(spec, z, psi, batch, rho=100.0, L=100.0, noise_std=0.1,
                                compute_cond=False, parity_round=False)
    torch.testing.assert_close(nll, res.nll, rtol=1e-4, atol=0)
    torch.testing.assert_close(grad, res.grad, rtol=0, atol=1e-3 * float(grad.abs().max()))


def test_reference_cv_and_conditions_match_the_program():
    from dqgp_tpu_torch.driver import host_condition_numbers
    from dqgp_tpu_torch.models.gp.cv import k_fold_cross_validation_consensus

    cfg, spec, circ = _spec_and_circ()
    splits, X, Y = traffic.training_data(cfg, 6)
    z = np.round(np.random.RandomState(0).uniform(0, math.pi, cfg["circuit"]["parameters"]), 4)
    want = k_fold_cross_validation_consensus(spec, torch.as_tensor(X), torch.as_tensor(Y), z,
                                             0.1, k_folds=5, random_seed=9)["mean_nlpd"]
    got = R.cv_score(circ, cfg["kernel"], X, Y, z, 0.1, 5, 9)
    assert got == pytest.approx(want, rel=1e-6)
    theirs = host_condition_numbers(spec, splits, z[None], device="cpu")
    mine = R.condition_numbers(circ, cfg["kernel"], R.Agents(splits, "cpu"), z[None], "cpu")
    np.testing.assert_allclose(mine, theirs, rtol=1e-6)


def test_reference_posterior_matches_the_programs_dense_posterior():
    from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp
    from bench_torch.entries.posterior import exact_posterior

    cfg, spec, _ = _spec_and_circ()
    X, Y, theta = traffic.posterior_data(cfg, 2, 0)
    n = cfg["posterior"]["train_rows"]
    m, v = predict_quantum_gp(spec, torch.as_tensor(X[:n]), torch.as_tensor(Y[:n]).double(),
                              torch.as_tensor(X[n:]), torch.as_tensor(theta))
    rm, rv = exact_posterior(cfg, cfg["posterior"], X, Y, theta, "cpu")
    np.testing.assert_allclose(rm, m.numpy(), atol=1e-5)
    np.testing.assert_allclose(rv, v.numpy(), atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-9 + 2**-14])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0 - 2**-9])
    assert torch.equal(faults.tf32(x), want)


# --- the harness on the CPU ------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"),
                          cfg=tiny.tiny_config(qubits=4, layers=2, rows=(20, 22, 24, 26)))


@pytest.mark.parametrize("cell", ("tiny.train", "tiny.posterior"))
@pytest.mark.parametrize("trace", (0, 1))
def test_last_line_format(tree, cell, trace):
    rc, line = tiny.run_cell(*tree, cell, seed=2**31 + 99, trace=trace)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    d = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    e2e = {"tiny.train": {"setup_s", "iter_ms"}, "tiny.posterior": {"setup_s", "posterior_s"}}
    if trace:
        assert "busy_s" in d and "window_s" in d
        assert not (set(line["metrics"]) & e2e[cell])
    else:
        assert set(line["metrics"]) == e2e[cell]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])


def test_added_workload_and_metric_files_are_found(tmp_path):
    bench_dir, bench_json = tiny.make_tree(tmp_path)
    wl = json.load(open(os.path.join(bench_dir, "workloads", "tiny.train.json")))
    wl.update(iters=4, ref_steps=1)
    with open(os.path.join(bench_dir, "workloads", "tiny.train4.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(bench_dir, "metrics", "units_done.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.units))\n")
    bench = json.load(open(bench_json))
    bench["workloads"].append({"name": "tiny.train4", "config": "tiny", "traffic": "train",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "units_done", "unit": "count", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny.train4"]})
    bench["end_to_end"][1]["workloads"].append("tiny.train4")
    with open(bench_json, "w") as f:
        json.dump(bench, f)
    rc, line = tiny.run_cell(bench_dir, bench_json, "tiny.train4")
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["units_done"]["value"] == line["attempted"]
    assert "iter_ms" in line["metrics"]


@pytest.mark.parametrize("kind", faults.FAULTS)
def test_training_faults_are_not_correct(tree, kind):
    with faults.train_fault(kind):
        rc, line = tiny.run_cell(*tree, "tiny.train", seed=31)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("kind", faults.FAULTS)
def test_posterior_faults_are_not_correct(tree, kind):
    with faults.posterior_fault(kind):
        rc, line = tiny.run_cell(*tree, "tiny.posterior", seed=32)
    assert rc == 0 and line["correct"] is False


def test_training_control_is_not_correct():
    """The control, the program's float32 GP path, reads above the limits
    of the north star's cells at the north star's own size."""
    from bench_torch import calibrate

    cfg = config("northstar")
    cfg["train"] = dict(cfg["train"], compute_cond=False)
    for cell in ("northstar.train", "northstar.chained"):
        wl = json.load(open(os.path.join(BENCH, "workloads", f"{cell}.json")))
        nums = calibrate.train_reading(cfg, wl, 3, torch.device("cpu"),
                                       {"gp_dtype": "float32", "cv_dtype": "float32"})
        assert any(v > wl["limits"][k] for k, v in nums.items()), nums


def test_posterior_control_is_not_correct():
    """The control, the reference in TF32, reads above the posterior cell's
    limits (at a size the CPU holds)."""
    from bench_torch import calibrate
    from bench_torch.entries.posterior import exact_posterior, worst_gap

    cfg = config("config7")
    p = dict(cfg["posterior"], train_rows=1500, test_rows=64)
    cfg["posterior"] = p
    wl = json.load(open(os.path.join(BENCH, "workloads", "config7.posterior_cg.json")))
    X, Y, theta = traffic.posterior_data(cfg, 5, 0)
    m, v = calibrate.control_posterior(cfg, p, X, Y, theta, torch.device("cpu"))
    rm, rv = exact_posterior(cfg, p, X, Y, theta, "cpu")
    gaps = {"mean": worst_gap(m, rm), "var": worst_gap(v, rv)}
    assert any(g > wl["limits"][k] for k, g in gaps.items()), gaps


def test_no_card_no_result():
    """Without a card the harness exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                           "northstar.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
