"""Tracing and profiling (counterpart of rnnt_inference_tpu/utils/profiler.py).

``device_trace`` wraps a run in a torch.profiler trace (CPU and, for a CUDA
device, CUDA activities) and exports it as a chrome trace.  The timed reps
of the Offline harness run inside a ``TIMED_REP`` annotation, so
``device_idle_share`` can read how much of each timed rep the card spent
with no kernel running.

``span(name)`` times a stretch of the program's host work, always: each
name keeps its count, its total and a ring of its last ``RING`` (start,
end) pairs on ``time.perf_counter_ns`` in the process-wide ``REGISTRY``.
While a torch profiler runs, a span also opens ``record_function(name)``,
so it lands in the chrome trace as a ``user_annotation`` on the kernels'
clock.  Spans are named ``rnnt.<layer>.<what>``.  ``REGISTRY.server`` holds
the per-query stamps of the last ``run_server_native`` call
(``QueryRecord``).  The registry is not locked: spans run on the serving
thread.

``record_call(kernel, launch, **shape)`` keeps a kernel call's shapes in
``REGISTRY.calls[kernel]`` (a ring of ``RING``), only while a torch profiler
runs: the record a roofline of the traced calls reads, kept by the wrapper
that launched the kernel, with the launch's number on its counter (so a
reader can tell that the calls of one profile were all recorded).  The
streaming FastConformer's kernels record themselves so
(ops/attention_cuda.py, ops/depthwise_cuda.py).

Unlike the JAX package's trace, which turns into a no-op when the backend
cannot profile, ``device_trace`` raises: a CUDA run whose trace holds no
device activity is an error, not an empty file.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from collections import deque
from time import perf_counter_ns
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled

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


# the last (start, end) pairs each span name keeps
RING = 65536
# a query's stamps in run_server_native, in the order they are taken
QUERY_STAMPS = ("polled", "inserted", "finish_enqueued", "mask_read", "completed")
# the stages of a query: each from one stamp to the next
QUERY_STAGES = ("admit", "in_slot", "readback_wait", "respond")


class SpanStats:
    """One span name's record: how many spans ended, their total ns, and the
    (start, end) ns of the last ``RING`` of them."""

    __slots__ = ("count", "total_ns", "ring")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.ring = deque(maxlen=RING)

    def add(self, start_ns: int, end_ns: int) -> None:
        self.count += 1
        self.total_ns += end_ns - start_ns
        self.ring.append((start_ns, end_ns))

    def intervals(self, lo_ns: float = 0, hi_ns: float = math.inf) -> List[Tuple[int, int]]:
        """The ring's (start, end) pairs that start in [lo_ns, hi_ns)."""
        return [(s, e) for s, e in self.ring if lo_ns <= s < hi_ns]


class QueryRecord:
    """The stamps (perf_counter_ns) of each query of one
    ``run_server_native`` call, ``stamps[name][query_id]``: polled, when
    ``lg.poll`` returned it; inserted, when ``insert_samples`` returned;
    finish_enqueued, the end of the enqueue of the dispatch whose finish
    mask first holds its slot; mask_read, when that mask reached the host;
    completed, at ``lg.complete``.  Warm-up samples (id < 0) are not
    recorded."""

    def __init__(self):
        self.start_ns = perf_counter_ns()
        self.stamps: Dict[str, Dict[int, int]] = {name: {} for name in QUERY_STAMPS}

    def stages(self, from_s: float = 0.0, to_s: float = math.inf) -> Dict[str, np.ndarray]:
        """ns of each stage (``QUERY_STAGES``: admit = inserted - polled,
        in_slot = finish_enqueued - inserted, readback_wait = mask_read -
        finish_enqueued, respond = completed - mask_read) of the queries
        that hold every stamp and completed between from_s and to_s
        seconds after the call's start; with "query", their ids."""
        lo, hi = self.start_ns + from_s * 1e9, self.start_ns + to_s * 1e9
        stamps = [self.stamps[name] for name in QUERY_STAMPS]
        ids = sorted(q for q, t in stamps[-1].items()
                     if lo <= t < hi and all(q in d for d in stamps))
        t = np.array([[d[q] for d in stamps] for q in ids], np.int64).reshape(-1, len(stamps))
        out = {name: t[:, k + 1] - t[:, k] for k, name in enumerate(QUERY_STAGES)}
        out["query"] = np.array(ids, np.int64)
        return out


class SpanRegistry:
    """Every span name's ``SpanStats``, the last Server call's
    ``QueryRecord`` (None before the first) and the kernel calls recorded
    while a profiler ran (``record_call``)."""

    def __init__(self):
        self.spans: Dict[str, SpanStats] = {}
        self.server: Optional[QueryRecord] = None
        self.calls: Dict[str, deque] = {}

    def stats(self, name: str) -> SpanStats:
        st = self.spans.get(name)
        if st is None:
            st = self.spans[name] = SpanStats()
        return st

    def new_server_record(self) -> QueryRecord:
        self.server = QueryRecord()
        return self.server


REGISTRY = SpanRegistry()


def record_call(kernel: str, launch: int, **shape) -> None:
    """Keep one call of ``kernel`` (its ``launch`` number on the wrapper's
    counter and its shapes, tensors kept as they are) while a torch profiler
    runs; nothing otherwise."""
    if _profiler_enabled():
        ring = REGISTRY.calls.get(kernel)
        if ring is None:
            ring = REGISTRY.calls[kernel] = deque(maxlen=RING)
        ring.append(dict(shape, launch=launch))


class span:
    """``with span(name) as s:`` records the body's interval in
    ``REGISTRY`` (``s.start_ns`` and ``s.end_ns`` once it ends) and, only
    while a torch profiler runs, opens ``record_function(name)`` around it.
    With no profiler, a span costs a flag read, two clock reads and a ring
    append."""

    __slots__ = ("name", "start_ns", "end_ns", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self._annotation = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = perf_counter_ns()
        REGISTRY.stats(self.name).add(self.start_ns, self.end_ns)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
