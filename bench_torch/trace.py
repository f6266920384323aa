"""The traced run's reading of ``torch.profiler``: the device's kernels,
the host's operators with their shapes, and the sums the per-layer
metrics read.

The kernel groups are copied from ``scripts/profile_torch_port.py`` (first
match wins). Busy time is the union of the kernels' intervals, so kernels
that overlap count once.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

GROUPS = (
    ("adjoint", r"warp_vjp_kernel"),
    ("hand", r"warp_pauli_features_kernel|warp_pauli_features_f64_kernel|pauli_features_kernel_f64"
             r"|warp_states_kernel|warp_states_f64_kernel|states_kernel_f64|warp_features_kernel"
             r"|warp_states_fused_kernel"),
    ("eigh", r"syev|sytrd|stedc|ormtr|steqr|sterf|latrd"),
    ("trsm", r"trsm|trsv|trtri"),
    ("cholesky", r"potrf|potrs"),
    ("gemm", r"gemm|gemv|xmma|cutlass|Kernel2|dot_kernel"),
    ("elementwise", r".*"),
)
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def group_of(name: str) -> str:
    for g, pattern in GROUPS:
        if re.search(pattern, name):
            return g
    return "elementwise"


@dataclass
class Trace:
    """What the traced window held: kernels (name, start s, end s) on the
    device, host operators (name, start s, end s, input shapes), and the
    window's length on the host's clock."""

    window_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    ops: List[Tuple[str, float, float, list]] = field(default_factory=list)

    def busy_s(self) -> float:
        total, end = 0.0, None
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def group_s(self) -> Dict[str, float]:
        out = {g: 0.0 for g, _ in GROUPS}
        for name, s, e in self.kernels:
            out[group_of(name)] += e - s
        return out

    def kernel_s(self, pattern: re.Pattern) -> Tuple[float, int]:
        hits = [(e - s) for n, s, e in self.kernels if pattern.search(n)]
        return sum(hits), len(hits)

    def products(self, m: int, k: int, n: int) -> int:
        """The matrix products of shape (m, k) x (k, n) that the host
        dispatched (a batched product once a batch member)."""
        count = 0
        for name, _, _, shapes in self.ops:
            if name not in GEMM_OPS or not shapes:
                continue
            mats = [s for s in shapes if len(s) >= 2]
            if name in ("aten::addmm", "aten::baddbmm"):
                mats = mats[1:]
            if len(mats) < 2:
                continue
            a, b = mats[0], mats[1]
            if (a[-2], a[-1], b[-1]) == (m, k, n):
                batch = 1
                for d in a[:-2]:
                    batch *= d
                count += batch
        return count

    def top_kernels(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest stretches with no kernel on the device, each named by
        the innermost host operator running at its middle."""
        ks = sorted(self.kernels, key=lambda x: x[1])
        gaps, end = [], None
        for _, s, e in ks:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        ops = sorted(self.ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        out = []
        for s, e in gaps[:k]:
            mid, name = 0.5 * (s + e), "host, no operator"
            # the covering operator that started last is the innermost
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0:
                if ops[i][2] >= mid:
                    name = ops[i][0]
                    break
                i -= 1
            out.append([name, e - s])
        return out


def profiler(device_type: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=True)


def read(prof, window_s: float) -> Trace:
    """The events of a finished profile as a :class:`Trace`."""
    import torch

    tr = Trace(window_s=window_s)
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tr.kernels.append((e.name, s, t))
        else:
            tr.ops.append((e.name, s, t, list(e.input_shapes or [])))
    return tr


def breakdown(tr: Optional[Trace]) -> Optional[dict]:
    if tr is None or not tr.kernels:
        return None
    return {"device_ops": tr.top_kernels(), "idle_gaps": tr.idle_gaps()}
