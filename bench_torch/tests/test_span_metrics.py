"""CPU tests of the per-layer metrics that read the program's spans
(``bench_torch/spans.py``, ``metrics/*``), on hand-made span lists.

    python -m pytest bench_torch/tests -q

Each metric reads the newest unit's spans only, reads nothing without the
spans it needs (or without the program's ``tracing`` module, as at a
commit before it), and counts the host reads inside an iteration, not the
backfill's."""

from __future__ import annotations

import builtins
import importlib.util
import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import tiny  # noqa: E402
from dqgp_tpu_torch import tracing  # noqa: E402
from dqgp_tpu_torch.tracing import Span  # noqa: E402

MS = 1_000_000  # ns


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tiny.BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _List:
    """Spans laid out by hand: ``add`` takes a start and a length in ms."""

    def __init__(self, unit):
        self.spans, self.unit = [], unit

    def add(self, name, start, length, parent=-1):
        self.spans.append(Span(name, start * MS, (start + length) * MS, parent, self.unit))
        return len(self.spans) - 1


def _training(unit=7, chained=False):
    """A run of 2 iterations: chunk 1 with 2 host reads (the rescue check in
    the step, the fetch), chunk 2 with 1 (and, chained, the capture inside
    its dispatch), then the backfill with its read."""
    s = _List(unit)
    s.add("driver.start", 0, 5)
    it = s.add("driver.iteration", 5, 20)
    d = s.add("driver.dispatch", 5, 10, it)
    step = s.add("consensus.step", 5, 6, d)
    s.add("sync.rescue_check", 8, 1, step)
    s.add("cv.scores", 11, 3, d)
    s.add("sync.fetch", 15, 4, it)
    s.add("driver.record", 20, 2, it)
    it = s.add("driver.iteration", 25, 30)
    d = s.add("driver.dispatch", 25, 20, it)
    if chained:
        s.add("driver.capture", 25, 12, d)
    s.add("sync.fetch", 45, 5, it)
    s.add("driver.record", 50, 4, it)
    b = s.add("driver.backfill", 55, 40)
    c = s.add("driver.backfill_chunk", 55, 40, b)
    s.add("sync.backfill", 90, 5, c)
    return s.spans


def _posterior(unit=9):
    """An alpha solve of 2 iterations and a variance solve of 3."""
    s = _List(unit)
    s.add("blocked.setup", 0, 10)
    a = s.add("blocked.alpha_solve", 10, 40)
    s.add("sync.cg_residual", 10, 1, a)
    for k in range(2):
        i = s.add("blocked.cg_iteration", 11 + 10 * k, 10, a)
        s.add("blocked.gram_matvec", 11 + 10 * k, 5, i)
        s.add("sync.cg_residual", 18 + 10 * k, 3, i)
    v = s.add("blocked.var_solve", 50, 60)
    s.add("sync.cg_residual", 50, 1, v)
    for k in range(3):
        i = s.add("blocked.cg_iteration", 51 + 20 * k, 20, v)
        s.add("blocked.gram_matvec", 51 + 20 * k, 12, i)
        s.add("sync.cg_residual", 66 + 20 * k, 5, i)
    return s.spans


def _join(first, second):
    """Two units' spans as one process records them (parents are indices)."""
    n = len(first)
    return first + [s._replace(parent=s.parent + n if s.parent >= 0 else -1) for s in second]


@pytest.fixture
def recorded(monkeypatch):
    """Replace the program's recorded spans with a list of the test's."""
    box = []
    monkeypatch.setattr(tracing, "spans", lambda: list(box))
    return box


RUN = types.SimpleNamespace()


def test_training_metrics(recorded):
    recorded.extend(_training())
    # dispatch: (10 - 1) + 20, over 2 iterations
    assert _metric("dispatch_ms.train")(RUN) == pytest.approx(14.5)
    assert _metric("record_ms.train")(RUN) == pytest.approx(3.0)
    # rescue check 1 + fetches 4 and 5; the backfill's read is not counted
    assert _metric("sync_ms.train")(RUN) == pytest.approx(5.0)
    assert _metric("syncs.train")(RUN) == pytest.approx(1.5)
    assert _metric("run_start_ms.train")(RUN) == pytest.approx(5.0)


def test_chained_capture_leaves_dispatch_for_the_start(recorded):
    recorded.extend(_training(chained=True))
    assert _metric("dispatch_ms.train")(RUN) == pytest.approx((9 + 20 - 12) / 2)
    assert _metric("run_start_ms.train")(RUN) == pytest.approx(5.0 + 12)


def test_posterior_metrics(recorded):
    recorded.extend(_posterior())
    # (2 x (10 - 3) + 3 x (20 - 5)) / 5
    assert _metric("cg_host_ms.posterior")(RUN) == pytest.approx(59 / 5)
    assert _metric("var_cg_iters.posterior")(RUN) == 3


def test_the_newest_unit_is_read(recorded):
    """An older unit's spans (another run in the process) move nothing."""
    recorded.extend(_join(_posterior(unit=3), _training(unit=4)))
    assert _metric("record_ms.train")(RUN) == pytest.approx(3.0)
    assert _metric("cg_host_ms.posterior")(RUN) is None
    recorded[:] = _join(_training(unit=4), _posterior(unit=5))
    assert _metric("dispatch_ms.train")(RUN) is None
    assert _metric("var_cg_iters.posterior")(RUN) == 3


NEW = ("dispatch_ms.train", "record_ms.train", "sync_ms.train", "syncs.train",
       "run_start_ms.train", "cg_host_ms.posterior", "var_cg_iters.posterior")


@pytest.mark.parametrize("name", NEW)
def test_no_spans_read_nothing(recorded, name):
    assert _metric(name)(RUN) is None
    recorded.append(Span("cli.train", 0, MS, -1, 1))
    assert _metric(name)(RUN) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_tracing_reads_nothing(monkeypatch, name):
    real = builtins.__import__

    def no_tracing(mod, globals=None, locals=None, fromlist=(), level=0):
        if mod == "dqgp_tpu_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("cannot import name 'tracing'")
        return real(mod, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert _metric(name)(RUN) is None


def test_the_benchmark_declares_each_metric():
    import json

    bench = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert os.path.exists(os.path.join(tiny.BENCH, "metrics", f"{name}.py"))
        assert m["source"] in ("program_span", "program_counter")
        train = name.endswith(".train")
        assert m["moves"] == ("iter_ms" if train else "posterior_s")
        assert m["layer"] == ("driver" if train else "CG posterior")
