"""The port's spans (``dqgp_tpu_torch.tracing``) on the CPU.

* With no profiler a run records nothing, and every span still exposes its
  seconds.
* Under ``torch.profiler`` a tiny ``driver.train`` (one and two iterations a
  chunk, the host backfill on) gives one ``driver.start``, one
  ``driver.iteration``, ``driver.dispatch`` and ``sync.fetch`` a chunk, one
  ``driver.record`` an iteration, the backfill's chunks, and their nesting,
  all under one unit id; ``cond_backfill_time`` and ``total_time`` are the
  spans' seconds.
* A tiny ``gp_posterior_large``: the alpha solve's ``blocked.cg_iteration``
  spans are its iterations, and the ``blocked.gram_matvec`` spans every
  matvec of both solves.
* A span's clock is Kineto's: an operator inside a span lies inside it on
  the profile's timeline; ``clear`` forgets the recorded spans.
* No span reaches the benchmark's reading of the device trace, and the
  package has no ``record_function`` range.
* The CLI's ``--profile-dir`` traces, one a stage, carry the spans: the
  training loop's, and the CG posterior's in the prediction stages'.
* A kernel library's first load is a ``cuda_circuit.load:<source>`` span.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dqgp_tpu_torch import cli, tracing
from dqgp_tpu_torch.data import split_data_numpy
from dqgp_tpu_torch.driver import TrainConfig, train
from dqgp_tpu_torch.models.circuits import build_circuit
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch.models.kernels.quantum_kernel import kernel_features
from dqgp_tpu_torch.ops import cuda_circuit
from dqgp_tpu_torch.parallel import blocked
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 3


@pytest.fixture(scope="module")
def problem():
    """chebyshev 2 qubits / 1 layer, Matérn, 2 regional agents of 20 rows."""
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 2, 2, 1),
                             kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (40, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(40)
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, 2, "regional")
    return spec, splits, X, Y


def _train(problem, **kw):
    spec, splits, X, Y = problem
    cfg = TrainConfig(max_iter=ITERS, cv_folds=3, verbose=False, **kw)
    return train(spec, splits, X, Y, cfg, device="cpu")


def _traced(fn):
    """fn() under the profiler; (its result, the spans it recorded by
    index, the profile)."""
    before = len(tracing.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, dict(list(enumerate(tracing.spans()))[before:]), prof


def _named(spans, name):
    return [i for i, s in spans.items() if s.name == name]


def _ancestors(spans, i):
    names, p = [], spans[i].parent
    while p >= 0:
        names.append(spans[p].name)
        p = spans[p].parent
    return names


def _seconds(s):
    return (s.end_ns - s.start_ns) * 1e-9


def test_no_profiler_records_no_span(problem):
    before = len(tracing.spans())
    res = _train(problem, chain_iters=2, cond_mode="host")
    assert len(tracing.spans()) == before
    assert res.total_time > 0 and res.cond_backfill_time > 0
    assert all(h["iter_time"] > 0 for h in res.nll_history)
    with tracing.span("test.untraced") as s:
        assert s.elapsed >= 0
    closed = s.elapsed
    assert closed >= 0 and s.elapsed == closed  # fixed once the span closes
    assert len(tracing.spans()) == before


@pytest.mark.parametrize("chain", (1, 2))
def test_training_spans(problem, chain):
    res, spans, _ = _traced(lambda: _train(problem, chain_iters=chain, cond_mode="host"))
    chunks = -(-ITERS // chain)
    assert res.iterations == ITERS
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans.values())
    # one unit, a new one
    units = {s.unit for s in spans.values()}
    assert len(units) == 1 and units.pop() > max(
        (s.unit for s in tracing.spans()[:min(spans)]), default=0)
    for i, s in spans.items():  # a child lies inside its parent
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)

    (start,) = _named(spans, "driver.start")
    assert spans[start].parent == -1
    its = _named(spans, "driver.iteration")
    assert len(its) == chunks and all(spans[i].parent == -1 for i in its)
    assert spans[start].end_ns <= spans[its[0]].start_ns
    for name, count in (("driver.dispatch", chunks), ("sync.fetch", chunks),
                        ("driver.record", ITERS)):
        got = _named(spans, name)
        assert len(got) == count, name
        assert all(spans[spans[i].parent].name == "driver.iteration" for i in got), name
    for name in ("consensus.step", "cv.scores"):  # a CPU chunk runs eagerly
        got = _named(spans, name)
        assert len(got) == chunks * chain, name
        assert all(spans[spans[i].parent].name == "driver.dispatch" for i in got), name
    rescues = _named(spans, "sync.rescue_check")
    # the eager step rescues; a chained chunk's step flags instead
    assert len(rescues) >= (ITERS if chain == 1 else 0)
    assert all("consensus.step" in _ancestors(spans, i) for i in rescues)
    assert not _named(spans, "driver.capture")  # no CUDA graph on the CPU

    (backfill,) = _named(spans, "driver.backfill")
    chunk_spans = _named(spans, "driver.backfill_chunk")
    assert len(chunk_spans) == 1  # one 16-row chunk, both agents in it
    assert all(spans[i].parent == backfill for i in chunk_spans)
    # one read after the last chunk, so that the card's work of a chunk
    # overlaps the host's building of the next
    (read,) = _named(spans, "sync.backfill")
    assert spans[read].parent == backfill
    assert spans[read].start_ns >= max(spans[i].end_ns for i in chunk_spans)

    total = sum(_seconds(spans[i]) for i in its)
    assert res.total_time == pytest.approx(total, abs=1e-3)
    for h in res.nll_history:
        assert 0 < h["iter_time"] <= max(_seconds(spans[i]) for i in its) / chain + 1e-3


def test_cond_backfill_time_is_the_backfill_span(problem):
    res, spans, _ = _traced(lambda: _train(problem, cond_mode="host"))
    (backfill,) = _named(spans, "driver.backfill")
    # one span, two clocks: perf_counter for the seconds, Unix-epoch ns for
    # the record, read a few calls apart
    gap = _seconds(spans[backfill]) - res.cond_backfill_time
    assert 0 <= gap < 1e-3


def _posterior(precond_rank=4):
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 2, 2, 1),
                             kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(1)
    X = torch.as_tensor(rng.uniform(-0.99, 0.99, (70, 2)))
    theta = torch.as_tensor(rng.uniform(0, np.pi, spec.num_parameters))
    F = kernel_features(spec, X, theta, torch.float64)
    Y = torch.sin(3 * X[:60, 0]) + 0.1 * torch.as_tensor(rng.randn(60))
    return blocked.gp_posterior_large(spec, F[:60], Y, F[60:], noise_std=0.1, block=256,
                                      cg_tol=1e-8, cg_maxiter=100,
                                      precond_rank=precond_rank, test_chunk=4)


@pytest.mark.parametrize("precond_rank", (0, 4))
def test_posterior_spans(monkeypatch, precond_rank):
    made, cg = [], blocked.cg_solve

    def counted(*a, **k):
        out = cg(*a, **k)
        made.append(out.iterations)
        return out

    monkeypatch.setattr(blocked, "cg_solve", counted)
    (_, _, res), spans, _ = _traced(lambda: _posterior(precond_rank))
    assert made[0] == res.iterations > 0 and len(made) == 1 + 3  # 10 test rows, 4 a chunk
    assert len(_named(spans, "blocked.setup")) == 1
    (alpha,) = _named(spans, "blocked.alpha_solve")
    var = _named(spans, "blocked.var_solve")
    its = _named(spans, "blocked.cg_iteration")
    assert len(var) == 3 and len(its) == sum(made)
    assert sum(spans[i].parent == alpha for i in its) == res.iterations
    assert sorted(sum(spans[i].parent == v for i in its) for v in var) == sorted(made[1:])
    matvecs = _named(spans, "blocked.gram_matvec")
    assert len(matvecs) == sum(made)
    assert all(spans[spans[i].parent].name == "blocked.cg_iteration" for i in matvecs)
    reads = _named(spans, "sync.cg_residual")
    # one read before each solve, one to end each iteration
    assert len(reads) == sum(made) + len(made)
    assert sum(spans[spans[i].parent].name == "blocked.cg_iteration" for i in reads) == sum(made)


def test_span_clock_is_kinetos():
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("test.matmul"):
            x @ x
    s = tracing.spans()[-1]
    assert s.name == "test.matmul"
    t0 = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns <= t0 + e.time_range.start * 1e3 <= t0 + e.time_range.end * 1e3 \
            <= s.end_ns
    tracing.clear()
    assert tracing.spans() == []


def test_spans_reach_no_reader_of_the_device_trace(problem):
    from bench_torch import trace as trace_mod

    with trace_mod.profiler("cpu") as prof:
        _train(problem, chain_iters=2, cond_mode="host")
        _posterior()
    tr = trace_mod.read(prof, 1.0)
    names = {s.name for s in tracing.spans()}
    assert {"driver.iteration", "blocked.cg_iteration", "sync.fetch"} <= names
    seen = {k[0] for k in tr.kernels} | {o[0] for o in tr.ops}
    assert not names & seen


def test_no_record_function_range_in_the_package():
    """A record_function range would land on the device's timeline as a CUDA
    event under a traced run."""
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "dqgp_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    if "record_function" in f.read():
                        hits.append(name)
    assert hits == []


@pytest.fixture(scope="module")
def cli_traces(tmp_path_factory):
    """The ``--profile-dir`` traces of a tiny CLI run whose predictions take
    the CG posterior: {stage: trace events}."""
    trace_dir = str(tmp_path_factory.mktemp("trace"))
    cli.run(["--input-dim", "2", "--n-dataset", "60", "--encoding", "hubregtsen",
             "--kernel-type", "projected", "--num-qubits", "2", "--num-layers", "1",
             "--outer-kernel", "matern", "--data-seed", "1", "--n-agents", "2",
             "--max-iter", "2", "--cv-folds", "3", "--no-plot", "--quiet", "--device", "cpu",
             "--predict-cg-threshold", "20", "--profile-dir", trace_dir])
    out = {}
    for name in os.listdir(trace_dir):
        with open(os.path.join(trace_dir, name)) as f:
            out[name[:-len("_trace.json")]] = json.load(f)["traceEvents"]
    return out


def _span_events(events):
    return [e for e in events if e.get("cat") == "span"]


def test_cli_profile_dir_carries_the_spans(cli_traces):
    assert {"load", "split", "train", "predict_test", "predict_train"} <= set(cli_traces)
    events = cli_traces["train"]
    spans = _span_events(events)
    its = [e for e in spans if e["name"] == "driver.iteration"]
    assert len(its) == 2 and {"cli.train", "driver.start", "driver.record"} <= {
        e["name"] for e in spans}
    assert len({(e["pid"], e["tid"]) for e in spans}) == 1
    # on the trace's timeline: the profile's operators lie inside the spans
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    first = its[0]
    inside = [e for e in ops if first["ts"] <= e["ts"] and
              e["ts"] + e["dur"] <= first["ts"] + first["dur"]]
    assert inside
    (train_span,) = [e for e in spans if e["name"] == "cli.train"]
    assert all(train_span["ts"] <= e["ts"] for e in its)


def test_cli_profile_dir_traces_the_cg_posterior(cli_traces):
    """The predictions' traces carry the CG posterior's spans, each trace
    its own stage's alone."""
    assert not any(e["name"].startswith("blocked.") for e in _span_events(cli_traces["train"]))
    names = [e["name"] for e in _span_events(cli_traces["predict_test"])]
    # the predictor's set-up (preconditioner, alpha solve) runs in the first
    # prediction stage
    for name in ("cli.predict_test", "blocked.setup", "blocked.alpha_solve",
                 "blocked.var_solve", "blocked.cg_iteration", "sync.cg_residual"):
        assert name in names, name
    assert names.count("blocked.gram_matvec") == names.count("blocked.cg_iteration") > 0
    assert not any(n.startswith("driver.") for n in names)
    names = [e["name"] for e in _span_events(cli_traces["predict_train"])]
    assert "cli.predict_train" in names and "blocked.var_solve" in names
    assert "blocked.alpha_solve" not in names and "cli.predict_test" not in names


def test_a_librarys_first_load_is_a_span(monkeypatch):
    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    loads = []
    monkeypatch.setattr(cuda_circuit._build, "load", lambda src: loads.append(src) or Lib())
    cuda_circuit._library.cache_clear()
    try:
        _, spans, _ = _traced(lambda: [cuda_circuit._library(cuda_circuit.SOURCE)
                                       for _ in range(2)])
    finally:
        cuda_circuit._library.cache_clear()
    assert loads == [cuda_circuit.SOURCE]
    assert [s.name for s in spans.values()
            if s.name.startswith("cuda_circuit.load")] == ["cuda_circuit.load:pauli_features.cu"]
