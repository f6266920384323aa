"""Spans: named host intervals at the port's layer boundaries.

    with tracing.span("driver.iteration") as s:
        ...
        s.elapsed     # seconds so far (perf_counter)
    s.elapsed         # the span's seconds once it has closed

Every span exposes its seconds, whatever else runs. While a
``torch.profiler`` session records, each span also appends
``Span(name, start_ns, end_ns, parent, unit)`` to this module's list
(``spans()``): the times from ``time.time_ns()``, the Unix-epoch clock that
Kineto stamps its events with, so ``start_ns`` less a profile's
``trace_start_ns`` puts the span on the profile's timeline; ``parent`` is
the list index of the enclosing recorded span (-1 for none); ``unit`` the
id of the ``driver.train`` or ``gp_posterior_large`` call that it belongs
to (``new_unit``). With no profiler the list is left alone: a span costs
the profiler check and two clock reads.

Spans are not the profiler's own user ranges: Kineto mirrors such a range
on the device's timeline as a CUDA event, which a reader of the device
trace would take for device work, and a range costs ~10 us a call even
with no profiler.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: int
    unit: int


# the records as mutable lists, Span's fields in order: building a
# NamedTuple costs ~10 us under the profiler, a list ~0.2 us
_spans: List[list] = []
_open: List[int] = []  # indices of the recorded spans open now, innermost last
_unit = 0
_recording = torch._C._autograd._profiler_enabled


def spans() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return [Span(*s) for s in _spans]


def clear() -> None:
    """Forget every recorded span."""
    _spans.clear()
    _open.clear()


def new_unit() -> None:
    """Start a unit: the spans recorded from here on carry its id."""
    global _unit
    _unit += 1


class span:
    """A context manager timing its body; see the module docstring."""

    __slots__ = ("name", "_t0", "_t1", "_index")

    def __init__(self, name: str):
        self.name = name
        self._t1: Optional[float] = None

    def __enter__(self) -> "span":
        self._index = -1
        if _recording():
            self._index = len(_spans)
            _spans.append([self.name, time.time_ns(), None, _open[-1] if _open else -1, _unit])
            _open.append(self._index)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._t1 = time.perf_counter()
        if self._index >= 0 and _open and _open[-1] == self._index:
            _open.pop()
            _spans[self._index][2] = time.time_ns()

    @property
    def elapsed(self) -> float:
        """Seconds since the span opened (its whole length once closed)."""
        return (time.perf_counter() if self._t1 is None else self._t1) - self._t0
