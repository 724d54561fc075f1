"""What the traced run reads from ``torch.profiler``: the device's busy time
(the union of its kernel and copy intervals), its busy time inside the
program's ranges, device time by kernel name, and the breakdown (the device
operations with the most time, and idle time by the program range the host
was in).  Times are seconds; the profiler's clock is microseconds.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

Span = Tuple[float, float]


def union_us(spans: Iterable[Span]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur else 0.0)


def merged(spans: Iterable[Span]) -> List[Span]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The events of one profiled span of the window, read from the
    profiler's raw events (``kineto_results``; building its event tree for a
    batch's ~260,000 launches takes minutes)."""

    def __init__(self, prof, ranges: Sequence[str], wall_s: float):
        from torch.autograd import DeviceType

        self.wall_s = wall_s
        self.device: List[Tuple[str, float, float]] = []
        self.ranges: Dict[str, List[Span]] = {name: [] for name in ranges}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.device.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3))
            elif e.is_user_annotation() and e.name() in self.ranges:
                self.ranges[e.name()].append((e.start_ns() / 1e3, e.end_ns() / 1e3))
        self.busy = merged((s, e) for _, s, e in self.device)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def busy_in_s(self, name: str) -> float:
        """Device busy time inside the host ranges called ``name``."""
        total = 0.0
        for ws, we in self.ranges.get(name, []):
            total += union_us((max(s, ws), min(e, we)) for s, e in self.busy
                              if e > ws and s < we)
        return total / 1e6

    def kernel_s(self, fragments: Sequence[str]) -> float:
        """Summed device time of the kernels whose names hold a fragment."""
        return sum(e - s for n, s, e in self.device if any(f in n for f in fragments)) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, List[List[object]]]:
        ops: Dict[str, float] = {}
        for n, s, e in self.device:
            ops[n[:120]] = ops.get(n[:120], 0.0) + (e - s) / 1e6
        gaps: Dict[str, float] = {}
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            where = self._range_at(a)
            gaps[where] = gaps.get(where, 0.0) + (b - a) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}

    def _range_at(self, t: float) -> str:
        best, width = "outside the program's ranges", None
        for name, spans in self.ranges.items():
            for s, e in spans:
                if s <= t < e and (width is None or e - s < width):
                    best, width = name, e - s
        return best


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over the block, host and device; yields a list
    that holds the profiler once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    box: list = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield box
        torch.cuda.synchronize()
        t = time.perf_counter()
    box.append(prof)
    print(f"profiler stopped in {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
