"""The reduction of a ``torch.profiler`` trace to device numbers.

A traced run profiles a fixed number of batches inside its window and
exports the profiler's trace (Chrome trace JSON).  :func:`reduce` reads it:
the device's operations (kernels, copies, fills) with their names and
times, their union (the seconds in which an operation ran on the card),
the largest operations by total time, and the longest idle gaps, each
named by the innermost host range (``record_function``) open at its middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

#: Trace categories of work on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Trace category of a ``record_function`` range on the host.
HOST_RANGE_CAT = "user_annotation"


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start_us: float
    dur_us: float


class TraceSummary(NamedTuple):
    ops: List[DeviceOp]
    busy_s: float
    top_ops: List[Tuple[str, float]]  # name, seconds (largest first)
    idle_gaps: List[Tuple[str, float]]  # host range, seconds (longest first)

    def seconds(self, pick) -> float:
        """Device seconds in the kernels whose name ``pick`` accepts."""
        return sum(o.dur_us for o in self.ops if o.cat == "kernel" and pick(o.name)) * 1e-6

    def count(self, pick) -> int:
        return sum(1 for o in self.ops if o.cat == "kernel" and pick(o.name))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(trace: Dict, top: int = 10) -> TraceSummary:
    """The device numbers of a Chrome trace dict."""
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) else trace
    ops, ranges = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(DeviceOp(ev.get("name", "?"), cat, float(ev["ts"]), float(ev.get("dur", 0.0))))
        elif cat == HOST_RANGE_CAT:
            ranges.append((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)),
                           ev.get("name", "?")))
    busy = _union([(o.start_us, o.start_us + o.dur_us) for o in ops])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name: Dict[str, float] = defaultdict(float)
    for o in ops:
        by_name[o.name] += o.dur_us * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        around = [r for r in ranges if r[0] <= mid <= r[1]]
        name = min(around, key=lambda r: r[1] - r[0])[2] if around else "outside any range"
        gaps.append((name, (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(ops, busy_s, top_ops, gaps[:top])
