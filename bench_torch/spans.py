"""The traced unit's program spans (``dqgp_tpu_torch.tracing``), for the
per-layer metrics that read them. The program records spans only while
the profiler runs, so under ``--trace 1`` the newest unit id is the traced
unit's: a training run or a posterior. A program without the module, or
without the spans a metric needs, reads nothing."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


def is_sync(name: str) -> bool:
    """A host read of a device value."""
    return name.startswith("sync.")


class Unit:
    """The spans of one unit id, with their parent links."""

    def __init__(self, spans: list, unit: int):
        self.spans = {i: s for i, s in enumerate(spans) if s.unit == unit and s.end_ns is not None}
        self.children: Dict[int, List[int]] = {}
        for i, s in self.spans.items():
            self.children.setdefault(s.parent, []).append(i)

    def named(self, name: str) -> List[int]:
        return [i for i, s in self.spans.items() if s.name == name]

    def ms(self, i: int) -> float:
        s = self.spans[i]
        return (s.end_ns - s.start_ns) * 1e-6

    def outer(self, i: int, match: Callable[[str], bool]) -> List[int]:
        """The spans under ``i`` that match, those inside a match left out."""
        out, stack = [], list(self.children.get(i, ()))
        while stack:
            j = stack.pop()
            if match(self.spans[j].name):
                out.append(j)
            else:
                stack.extend(self.children.get(j, ()))
        return out


def traced_unit() -> Optional[Unit]:
    try:
        from dqgp_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    if not spans:
        return None
    return Unit(spans, max(s.unit for s in spans))


def training_unit():
    """(the traced training run's spans, its iterations), or None."""
    u = traced_unit()
    iters = len(u.named("driver.record")) if u is not None else 0
    return (u, iters) if iters else None


def iteration_syncs(u: Unit) -> List[int]:
    """The host's reads inside the run's iterations (not its backfill's)."""
    return [j for i in u.named("driver.iteration") for j in u.outer(i, is_sync)]
