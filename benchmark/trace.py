"""The device trace of a traced run and the arithmetic read from it (the
union of device intervals, copied from the program's utils/profiler.py
``_union_us``; kernel time by name; the breakdown of device time and idle
gaps).

The traced window is the span of the host annotations named ``SPAN`` that
the drivers put around each profiled rep or dispatch.  Times are in
microseconds, as the chrome trace gives them.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def profiler(device: torch.device):
    """torch.profiler over the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def export_events(prof) -> List[dict]:
    """The profile's chrome-trace events (written to a file in TMPDIR, read
    back, deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def union_us(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _iv(e: dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


@dataclass
class Trace:
    events: List[dict]
    lo: float  # the traced window, µs
    hi: float

    @classmethod
    def of(cls, events: List[dict]) -> Optional["Trace"]:
        spans = [_iv(e) for e in events if e.get("name") == SPAN and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        if not spans:
            return None
        return cls([e for e in events if e.get("ph") == "X"], min(s for s, _ in spans),
                   max(e for _, e in spans))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def device(self, cats=DEVICE_CATS) -> List[dict]:
        return [e for e in self.events if e.get("cat") in cats]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        """Seconds of the window in which a device operation of ``cats`` ran."""
        return union_us([_iv(e) for e in self.device(cats)], self.lo, self.hi) / 1e6

    def idle_share(self) -> float:
        """1 - (union of kernel intervals) / window."""
        return 1.0 - self.busy_s(("kernel",)) / self.window_s

    def kernel_s(self, name_part: str) -> float:
        """Seconds of kernels whose name holds ``name_part``, inside the window."""
        total = 0.0
        for e in self.device(("kernel",)):
            if name_part in e.get("name", ""):
                s, t = _iv(e)
                total += max(0.0, min(t, self.hi) - max(s, self.lo))
        return total / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation running where each began."""
        by_op: Dict[str, float] = {}
        busy = []
        for e in self.device():
            s, t = _iv(e)
            s, t = max(s, self.lo), min(t, self.hi)
            if t > s:
                by_op[e["name"]] = by_op.get(e["name"], 0.0) + (t - s) / 1e6
                busy.append((s, t))
        gaps, cur = [], self.lo
        for s, t in sorted(busy):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, t)
        if self.hi > cur:
            gaps.append((cur, self.hi))
        host = sorted((_iv(e) + (e.get("name", "?"),) for e in self.events
                       if e.get("cat") in HOST_CATS), key=lambda x: x[0])
        by_host: Dict[str, float] = {}
        active: list = []  # host operations begun by the gap, latest start last
        nxt = 0
        for g0, g1 in gaps:  # ascending: an operation ended before one gap ends before all later
            while nxt < len(host) and host[nxt][0] <= g0:
                active.append(host[nxt])
                nxt += 1
            while active and active[-1][1] <= g0:
                active.pop()
            name = active[-1][2] if active else "(no host op)"
            by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
