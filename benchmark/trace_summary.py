"""Reads a torch.profiler (Kineto) chrome trace: the device's busy time,
kernel time by name, which host span launched each kernel, and the idle
gaps labelled by what the host was doing.

Events read (complete events, "ph": "X", times in microseconds):
- device work: categories "kernel", "gpu_memcpy", "gpu_memset";
- launches: "cuda_runtime" and "cuda_driver" events, tied to the device
  work they started by args.correlation;
- host spans: "user_annotation", the harness's own record_function ranges
  (the profiled part records no other host events).

`window` is the host span that bounds the measured part: busy time, idle
gaps and spans are clipped to it.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
NAME_CHARS = 160  # of a kernel's name in the breakdown (templates run long)


@dataclass
class DeviceOp:
    name: str
    cat: str
    start: float  # us
    dur: float  # us
    span: Optional[str]  # the innermost host span open at its launch


@dataclass
class Summary:
    window: Tuple[float, float]  # us
    ops: List[DeviceOp]
    spans: List[Tuple[str, float, float]]  # (name, start, end) us, in the window
    busy_us: float
    gaps: List[Tuple[float, float]] = field(default_factory=list)  # idle intervals, us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def kernels(self, pattern: str = "", span: Optional[str] = None) -> List[DeviceOp]:
        """Kernels whose name matches the regex `pattern`, launched inside
        host spans named `span` when given."""
        rx = re.compile(pattern)
        return [op for op in self.ops if op.cat == "kernel" and rx.search(op.name)
                and (span is None or op.span == span)]

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def top_ops(self, n: int = 10) -> List[List]:
        """The n device operations (by name) that took the most time, s."""
        by: Dict[str, float] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + op.dur
        return [[k[:NAME_CHARS], v / 1e6]
                for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, n: int = 10) -> List[List]:
        """Idle time summed by the host span open at each gap's middle
        ("none" outside every span), the n largest, s."""
        by: Dict[str, float] = {}
        for a, b in self.gaps:
            label = innermost(self.spans, (a + b) / 2) or "none"
            by[label] = by.get(label, 0.0) + (b - a)
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def innermost(spans: List[Tuple[str, float, float]], ts: float) -> Optional[str]:
    """The name of the shortest span that holds ts."""
    best = None
    for name, a, b in spans:
        if a <= ts <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else None


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """(busy us, idle gaps) of the intervals clipped to [lo, hi]."""
    busy, gaps, cur = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def summarize(trace: dict, window: str) -> Summary:
    """The Summary of a parsed chrome trace, inside the (first) host span
    named `window`. Raises when that span is missing."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans_all = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events if e.get("cat") == SPAN_CAT]
    bounds = [s for s in spans_all if s[0] == window]
    if not bounds:
        raise ValueError(f"the trace has no host span {window!r}")
    lo, hi = bounds[0][1], bounds[0][2]
    spans = sorted((s for s in spans_all if s[1] >= lo and s[2] <= hi and s[0] != window),
                   key=lambda s: s[1])
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    starts = [s[1] for s in spans]
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if ts + dur < lo or ts > hi:
            continue
        at = launch_ts.get(e.get("args", {}).get("correlation"))
        span = None
        if at is not None:
            # Only spans that started before the launch can hold it.
            span = innermost(spans[:bisect.bisect_right(starts, at)], at)
        ops.append(DeviceOp(e["name"], e["cat"], ts, dur, span))
    busy, gaps = _union([(op.start, op.start + op.dur) for op in ops], lo, hi)
    return Summary((lo, hi), ops, spans, busy, gaps)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
