"""Tracing and profiling (counterpart of rnnt_inference_tpu/utils/profiler.py).

``device_trace`` wraps a run in a torch.profiler trace (CPU and, for a CUDA
device, CUDA activities) and exports it as a chrome trace; ``BatchTimeline``
is a host-side event log in the same format.  The timed reps of the Offline
harness run inside a ``TIMED_REP`` annotation, so ``device_idle_share`` can
read how much of each timed rep the card spent with no kernel running.

Unlike the JAX package's trace, which turns into a no-op when the backend
cannot profile, ``device_trace`` raises: a CUDA run whose trace holds no
device activity is an error, not an empty file.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import torch

# the name of the annotation around each timed rep (runtime/harness.py)
TIMED_REP = "rnnt.timed_rep"
TRACE_FILE = "trace.json"
# chrome-trace categories of device work
KERNEL_CATS = ("kernel",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device="cuda") -> Iterator[Optional[str]]:
    """Trace the body with torch.profiler and write ``log_dir/trace.json``
    (chrome format); yields that path (None and no trace when log_dir is
    None).  CPU activity always, CUDA activity for a CUDA device.  Raises
    when CUDA activity cannot be traced, and when a CUDA run's trace holds
    no device activity."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot trace CUDA activity in this build")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    if cuda and not any(e.get("cat") in DEVICE_CATS for e in load_trace(path)):
        raise RuntimeError(f"the trace {path} holds no device activity")


def load_trace(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union_us(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
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


def device_idle_share(events: List[dict], span: str = TIMED_REP,
                      cats: Tuple[str, ...] = KERNEL_CATS) -> List[dict]:
    """For each host span named ``span`` (a complete event): its window in
    µs, the union of the device intervals of categories ``cats`` inside it,
    and idle share = 1 - busy / window."""
    windows = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
               if e.get("name") == span and e.get("ph") == "X"
               and e.get("cat") != "gpu_user_annotation"]
    busy = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
            if e.get("cat") in cats and e.get("ph") == "X"]
    out = []
    for lo, hi in windows:
        used = _union_us(busy, lo, hi)
        out.append(dict(window_us=hi - lo, busy_us=used,
                        idle_share=1.0 - used / (hi - lo) if hi > lo else 0.0))
    return out


@dataclass
class BatchTimeline:
    """Host-side per-batch event log -> chrome-trace JSON."""

    events: List[dict] = field(default_factory=list)
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        start = time.time()
        yield
        end = time.time()
        self.events.append(dict(name=name, ph="X", ts=(start - self._t0) * 1e6,
                                dur=(end - start) * 1e6, pid=0, tid=0, args=meta))

    def mark(self, name: str, **meta):
        self.events.append(dict(name=name, ph="i", ts=(time.time() - self._t0) * 1e6,
                                pid=0, tid=0, s="g", args=meta))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)
