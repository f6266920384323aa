"""CPU tests of config #7 at 12 qubits as a benchmark deployment
(``bench_torch/configs/config7q12.json``, the cell ``config7q12.train``):
the configuration against the port's circuit and the counts' arithmetic,
the generator's agents, the port's ``driver.train`` at 12 qubits against the
plain reference through the cell's own comparison, the wrappers' launch
spans and wide-launch counter, and the two per-layer metrics that read them
(``features_roofline.train``, ``feature_launches.train``)."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "bench_torch", "tests")]

import chip_smoke as cs  # noqa: E402
import tiny  # noqa: E402
from bench_torch import counts, faults, reference as R, traffic  # noqa: E402
from bench_torch.entries import train as train_entry  # noqa: E402
from bench_torch.trace import Trace  # noqa: E402
from dqgp_tpu_torch import tracing  # noqa: E402
from dqgp_tpu_torch.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu_torch.ops import cuda_circuit as K  # noqa: E402
from dqgp_tpu_torch.tracing import Span  # noqa: E402

CELL = "config7q12.train"
# what config7q12.json may hold apart from config7.json: its own names and
# cut, the circuit and its counts; it runs no posterior
OWN_KEYS = {"name", "source", "deployment", "reduced", "source_values", "why_reduced",
            "assumed", "circuit", "counts"}


def config(name="config7q12"):
    with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metric(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tiny.BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture(autouse=True)
def _threads():
    """One torch thread: under the suite's six workers more threads a
    worker oversubscribe the cores (the comparison below took 790 s at 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the configuration ----------------------------------------------------------

def test_config7q12_is_config7_at_12_qubits():
    cfg, c7 = config(), config("config7")
    assert {k: v for k, v in cfg.items() if k not in OWN_KEYS} == {
        k: v for k, v in c7.items() if k not in OWN_KEYS | {"posterior"}}
    assert "posterior" not in cfg and cfg["reduced"] == ["train"]
    c = cfg["circuit"]
    assert (c["family"], c["qubits"], c["layers"], c["features"]) == ("chebyshev", 12, 2, 2)
    circuit = build_circuit("chebyshev", 12, 2, 2)
    assert c["gates"] == tiny.gates_of(circuit)
    assert c["parameters"] == circuit.num_parameters == circuit.num_gates == 84
    entry = {e["name"]: e for e in benchmark()["configs"]}["config7q12"]
    assert entry["file"] == "bench_torch/configs/config7q12.json"
    assert entry["reduced"] == cfg["reduced"]


def test_config7q12_counts_are_chip_smokes_arithmetic():
    cfg = config()
    c, own = cfg["circuit"], cfg["counts"]
    circuit = build_circuit("chebyshev", 12, 2, 2)
    gate, fused = cs.gate_ops(circuit), cs.fused_program_ops(circuit)
    assert counts.gate_ops(c) == gate == own["gate_sequence_ops_per_sample"]
    assert fused == own["fused_program_ops_per_sample"]
    assert counts.feature_ops(12) == cs.feature_ops(12) == own["reduction_ops_per_sample"]
    # the smaller of the two programs: the gate sequence at 12 qubits, and the
    # fused program's count reads no C (K3 derives its columns from 11 qubits)
    assert gate < fused
    assert own["feature_ops_per_sample"] == gate + cs.feature_ops(12)
    assert own["feature_bytes_per_sample"] == 4 * (circuit.num_gates + 3 * 12)
    rows = 108_032  # a +- pair of the step's padded shards
    k1_ms, bound = cs.k1_bound(circuit, rows)
    assert bound == "operations"
    assert counts.feature_least_s(cfg, rows) * 1e3 == pytest.approx(k1_ms, rel=1e-12)
    assert k1_ms == pytest.approx(3.4876, abs=1e-4)


def test_config7q12_iteration_counts_are_below_the_measured_step():
    """The counted work of an iteration at the card's peaks takes less than
    the fastest 12-qubit step measured on the card (PR 12: 2.68 s), so
    mfu.train stays below 100 %."""
    rows = counts.train_rows_per_iteration(config())
    assert rows == {"step": 64 * 844 * (2 * 84 + 1), "cv": 512}
    assert counts.train_iteration_least_s(config()) < 0.5


@pytest.mark.parametrize("seed", (0, 12345, 2**40 + 3))
def test_config7q12_generator_gives_every_agent_its_rows(seed):
    cfg = config()
    splits, X, Y = traffic.training_data(cfg, seed)
    assert [len(x) for x, _ in splits] == cfg["partition"]["agent_rows"]
    assert X.shape == (49_999, 2) and Y.shape == (49_999,)
    assert np.abs(X).max() <= 2.0 and np.isfinite(Y).all()


# --- the port at 12 qubits against the reference --------------------------------

# The cut: two agents of 8 rows inside the encoding's domain [-1, 1]^2 (a
# row outside it is clipped, and an agent wholly outside has one row's
# features), 2 iterations from a seeded start, the reference following the
# first. Tolerances, from the port's plain engines on the CPU against the
# reference (both float32 circuits, float64 solves):
# * loss 1e-5: the float32 fused program and the reference's gate-by-gate
#   statevector part in the last ulps, which the Matern Gram amplifies: seen
#   2e-7 to 7e-7 at 8 to 24 rows an agent; features 0.1 % off read 2.3e-4 to
#   2.8e-4;
# * cv 1e-5: seen 6e-8 to 1.8e-7; the altered features read 6.0e-4 to
#   6.1e-4;
# * step 1e-2: the z rows are rounded to 4 decimals and were equal (0.0);
#   a flip of the last decimal of one component moves the norm by ~1e-4 of
#   it, far below the limit.
Q12_ROWS = 8
Q12_LIMITS = {"loss": 1e-5, "cv": 1e-5, "step": 1e-2}
ADMM_SEED = 1234
_chains = {}


@pytest.fixture(scope="module")
def q12_problem():
    rng = traffic.rng_for(5, 0)
    X = rng.uniform(-1.0, 1.0, (2 * Q12_ROWS, 2))
    Y = traffic.goldstein_price_log(X) + 0.1 * rng.standard_normal(len(X))
    splits = [(X[:Q12_ROWS], Y[:Q12_ROWS]), (X[Q12_ROWS:], Y[Q12_ROWS:])]
    return splits, X, Y


@pytest.mark.parametrize("fault", (None, "altered"))
def test_the_port_at_12_qubits_follows_the_reference(monkeypatch, q12_problem, fault):
    splits, X, Y = q12_problem
    cfg = config()
    wl = dict(json.load(open(os.path.join(tiny.BENCH, "workloads", f"{CELL}.json"))),
              ref_steps=1)
    # the generator's grid needs a square number of agents: the cut's two
    # agents are handed to the cell's own entry in its place
    monkeypatch.setattr(train_entry.traffic, "training_data", lambda c, s: (splits, X, Y))
    # the reference's chain depends on the ADMM seed alone: follow it once
    real = R.follow

    def follow(circ, kernel, ag, admm, seed, steps, *args, **kw):
        if (seed, steps) not in _chains:
            _chains[seed, steps] = real(circ, kernel, ag, admm, seed, steps, *args, **kw)
        return _chains[seed, steps]

    monkeypatch.setattr(R, "follow", follow)
    e = train_entry.Entry(cfg, wl, 5, "cpu")
    assert e.spec.circuit.num_qubits == 12 and e.spec.num_parameters == 84
    if fault:
        with faults.train_fault(fault):
            res = e.run(ADMM_SEED, iters=2)
    else:
        res = e.run(ADMM_SEED, iters=2)
    assert res["finite"] and res["iterations"] == 2
    got = train_entry.compare(cfg, wl, splits, X, Y, res, torch.device("cpu"), Q12_LIMITS)
    assert set(got) == {"loss", "cv", "step"}
    within = all(c["value"] <= c["limit"] for c in got.values())
    assert within == (fault is None), got


# --- the launch spans and the wide-launch counter --------------------------------

def _launch_every_wrapper():
    """Each hand-kernel wrapper once on the card's path, with the launch
    replaced: K1 float32 at 4 and 11 qubits, K1 float64 at 12, K3 at 10 and
    12, K2 (both precisions), K4 and the adjoint's two outputs at 6."""
    def circuit(n):
        return build_circuit("chebyshev", n, 2, 2)

    def zeros(c, dtype=torch.float32):
        return torch.zeros((3, c.num_gates), dtype=dtype)

    c4, c6, c10, c11, c12 = (circuit(n) for n in (4, 6, 10, 11, 12))
    K.pauli_features_from_angles(c4, zeros(c4))
    K.pauli_features_from_angles(c11, zeros(c11))
    K.pauli_features_from_angles(c12, zeros(c12, torch.float64))
    K.pauli_features_from_angles_fused(c10, zeros(c10))
    K.pauli_features_from_angles_fused(c12, zeros(c12))
    K.states_from_angles(c6, zeros(c6))
    K.states_from_angles(c6, zeros(c6, torch.float64))
    K.states_from_angles_fused(c6, zeros(c6))
    K.circuit_vjp(c6, zeros(c6), torch.zeros((3, 18)), "features")
    K.circuit_vjp(c6, zeros(c6), torch.zeros((3, 64), dtype=torch.complex64), "states")
    return ["K1", "K1", "K1_f64", "K3", "K3", "K2", "K2_f64", "K4", "K1_vjp", "K2_vjp"]


@pytest.fixture
def card_path():
    """The wrappers' card path with each launch recorded, not made."""
    launched = []
    K.reset_launch_counts()
    with mock.patch.object(K, "_is_cuda", lambda t: True), \
            mock.patch.object(K, "_launch", lambda *args: launched.append(args)):
        try:
            yield launched
        finally:
            K.reset_launch_counts()


def test_wide_launches_are_counted_apart(card_path):
    keys = _launch_every_wrapper()
    assert len(card_path) == len(keys)
    assert K.wide_launch_counts() == {"K1": 1, "K1_f64": 1, "K3": 1}
    got = K.launch_counts()
    # the wide counts stay out of launch_counts(): its sum is every launch
    assert sum(got.values()) == len(keys)
    assert {k: got[k] for k in set(keys)} == {k: keys.count(k) for k in set(keys)}
    K.reset_launch_counts()
    assert K.wide_launch_counts() == dict.fromkeys(K.WIDE_SOURCES, 0)
    assert not any(K.launch_counts().values())


def test_each_launch_is_one_span(card_path):
    before = len(tracing.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        keys = _launch_every_wrapper()
    spans = tracing.spans()[before:]
    assert [s.name for s in spans] == [f"cuda_circuit.launch:{k}" for k in keys]
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    # with no profiler the launches record nothing
    n = len(tracing.spans())
    _launch_every_wrapper()
    assert len(tracing.spans()) == n


# --- the per-layer metrics --------------------------------------------------------

def _run(trace, traced_work=1):
    return types.SimpleNamespace(cfg=config(), trace=trace, counts=counts,
                                 traced_work=traced_work)


K3_12 = "void (anonymous namespace)::warp_features_kernel<12>(float const*, float const*)"
K1_12 = "void (anonymous namespace)::warp_pauli_features_kernel<12>(float const*, int const*)"
K1_F64 = "void (anonymous namespace)::warp_pauli_features_f64_kernel<12>(double const*)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8"


def test_features_roofline_reads_whichever_kernel_ran():
    read = metric("features_roofline.train")
    rows = counts.train_rows_per_iteration(config())
    least = counts.feature_least_s(config(), 2 * (rows["step"] + rows["cv"]))
    kernels = [(GEMM, 0.0, 5.0), (K1_F64, 5.0, 6.0)]
    k3 = Trace(window_s=9.0, kernels=kernels + [(K3_12, 0.0, 20.0), (K3_12, 20.0, 30.0)])
    k1 = Trace(window_s=9.0, kernels=kernels + [(K1_12, 0.0, 10.0), (K1_12, 10.0, 30.0)])
    want = 100.0 * least / 30.0
    assert read(_run(k3, 2)) == pytest.approx(want)
    assert read(_run(k1, 2)) == pytest.approx(want)
    # where K3 alone ran it reads what k3_roofline.train reads
    assert read(_run(k3, 2)) == metric("k3_roofline.train")(_run(k3, 2))
    assert read(_run(Trace(window_s=9.0, kernels=kernels), 2)) is None
    assert read(_run(None)) is None


MS = 1_000_000  # ns


def _training_spans(launches=True):
    """A run of 2 iterations: K3 three times in the step and once in the CV
    of the first, twice in the step of the second, K1 once in the second's
    CV; a float64 K1 launch in the first's step and in the backfill, which
    are not counted."""
    spans = []

    def add(name, start, parent=-1):
        spans.append(Span(name, start * MS, (start + 1) * MS, parent, 3))
        return len(spans) - 1

    def launch(key, at, parent):
        if launches:
            add(f"cuda_circuit.launch:{key}", at, parent)

    add("driver.start", 0)
    for it, (step, cv) in enumerate(((["K3", "K3", "K3", "K1_f64"], "K3"), (["K3", "K3"], "K1"))):
        i = add("driver.iteration", 10 + 20 * it)
        d = add("driver.dispatch", 10 + 20 * it, i)
        s = add("consensus.step", 10 + 20 * it, d)
        for k, key in enumerate(step):
            launch(key, 11 + 20 * it + k, s)
        c = add("cv.scores", 18 + 20 * it, d)
        launch(cv, 18 + 20 * it, c)
        add("sync.fetch", 20 + 20 * it, i)
        add("driver.record", 22 + 20 * it, i)
    b = add("driver.backfill", 60)
    launch("K1_f64", 61, add("driver.backfill_chunk", 60, b))
    launch("K3", 70, -1)
    return spans


def test_feature_launches_counts_k1_and_k3_inside_the_iterations(monkeypatch):
    read = metric("feature_launches.train")
    box = []
    monkeypatch.setattr(tracing, "spans", lambda: list(box))
    assert read(None) is None
    box[:] = _training_spans(launches=False)
    assert read(None) is None
    box[:] = _training_spans()
    assert read(None) == pytest.approx((3 + 1 + 2 + 1) / 2)


def test_the_benchmark_declares_the_cell_and_its_metrics():
    bench = benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("config7q12", "train", 1)
    with open(os.path.join(tiny.BENCH, "workloads", f"{CELL}.json")) as f:
        wl = json.load(f)
    assert (wl["config"], wl["traffic"], wl["entry"]) == ("config7q12", "train", "train")
    assert set(wl["limits"]) == {"loss", "cv", "step"}
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("iter_ms", "features_ms.train", "elementwise_ms.train", "solve_ms.train",
                 "idle_share.train", "mfu.train", "dispatch_ms.train", "record_ms.train",
                 "sync_ms.train", "syncs.train", "run_start_ms.train"):
        assert metrics[name]["workloads"][-1] == CELL
    assert CELL not in metrics["k3_roofline.train"]["workloads"]
    for name, unit, source in (("features_roofline.train", "%", "device_trace"),
                               ("feature_launches.train", "count", "program_counter")):
        m = metrics[name]
        assert (m["unit"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
            unit, source, "features kernels", "iter_ms", [CELL])
        assert os.path.exists(os.path.join(tiny.BENCH, "metrics", f"{name}.py"))
