"""Reduction of a torch.profiler trace of the traced window to what the
per-layer metrics read.

- Ranges (`record_function` spans of the program and of the harness):
  each one's count, host ms (its CPU span) and device ms (the kernels and
  copies it launched), summed over the window.
- Device work by kernel name: a kernel launched through ctypes is not
  linked to the range it was launched in, so it is read by name.
- Busy time: the union of the intervals of every kernel, copy and set
  on the device, clipped to the window. Overlapping work counts once.
- The breakdown: the device operations that took most time, and the
  idle gaps of the device summed by the innermost range the host was in.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"  # the harness's range around the traced window


def _device_type_is(e, kind: str) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper() == kind


def _device_ms(e) -> float:
    t = getattr(e, "device_time_total", None)
    if t is None:
        t = getattr(e, "cuda_time_total", 0.0)
    return t / 1e3


def _self_device_ms(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    if t is None:
        t = getattr(e, "self_cuda_time_total", 0.0)
    return t / 1e3


def union_us(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals of a list of (start, end)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class TraceSummary:
    """The numbers of one traced window, from a finished profiler."""

    def __init__(self, prof):
        events = list(prof.events())
        cpu = [e for e in events if _device_type_is(e, "CPU")]
        names = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
        windows = [e for e in cpu if e.name == WINDOW]
        if not windows:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        w = windows[0]
        self.w0, self.w1 = w.time_range.start, w.time_range.end
        self.window_s = (self.w1 - self.w0) / 1e6
        self.annotations = [(e.time_range.start, e.time_range.end, e.name)
                            for e in cpu if e.name in names or e.name.startswith("bench.")]
        device = [e for e in events if _device_type_is(e, "CUDA")
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in names]
        self.device_ops = [(e.name, e.time_range.start, e.time_range.end) for e in device]
        clipped = [(max(s, self.w0), min(t, self.w1)) for _, s, t in self.device_ops
                   if t > self.w0 and s < self.w1]
        self.busy = union_us(clipped)
        self.busy_s = sum(t - s for s, t in self.busy) / 1e6
        self.ranges: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"device_ms": 0.0, "count": 0})
        for e in prof.key_averages():
            if _device_type_is(e, "CPU") and e.key in names:
                self.ranges[e.key] = {"device_ms": _device_ms(e),
                                      "host_ms": e.cpu_time_total / 1e3,
                                      "count": e.count}
            elif _device_type_is(e, "CUDA") and _self_device_ms(e) > 0:
                k = self.kernels[e.key]
                k["device_ms"] += _self_device_ms(e)
                k["count"] += e.count

    def range(self, name: str) -> Optional[Dict[str, float]]:
        r = self.ranges.get(name)
        return r if r and r["count"] else None

    def kernel(self, part: str) -> Optional[Dict[str, float]]:
        """Device ms and launches of the kernels whose name holds `part`."""
        hits = [v for k, v in self.kernels.items() if part in k]
        if not hits or not sum(v["count"] for v in hits):
            return None
        return {"device_ms": sum(v["device_ms"] for v in hits),
                "count": sum(v["count"] for v in hits)}

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops: Dict[str, float] = defaultdict(float)
        for name, s, t in self.device_ops:
            ops[name[:120]] += (t - s) / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        edges = [self.w0] + [x for iv in self.busy for x in iv] + [self.w1]
        for s, t in zip(edges[0::2], edges[1::2]):
            if t <= s:
                continue
            mid = (s + t) / 2
            inside = [(e - b, n) for b, e, n in self.annotations if b <= mid <= e]
            gaps[min(inside)[1] if inside else "outside the window"] += (t - s) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in order(ops)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}
