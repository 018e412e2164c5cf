"""The Server driver (traffic kind "server"): the program's
``runtime/scheduler.py run_server_native`` over ``runtime/server.py
ServerRunner``, open loop, fed by the benchmark's own load generator
(benchmark/loadgen.py) in place of the program's.

Set-up: weights, the store made on the device, the runner with
``ServerRunner.warmup`` and then ``warm_s`` seconds of the mix at its rate
(every wav bucket's shapes and the allocator's pools), untimed; last, a
full garbage collection and ``gc.freeze()``, as a latency-bound Python
service does after start-up, so that no collection in the window walks
set-up's objects.  The window
issues Poisson arrivals at the mix's rate for ``seconds``; it ends when every
query issued has been answered (or a minute later).  Each query's latency
runs from its scheduled arrival to its completion on the loadgen's clock,
and the percentiles cover every query issued; a query never answered counts
as failed, with the latency it had reached when the run gave up.

A traced run times the runner's ``step_async`` and ``insert_samples`` on the
host over the first ``trace_from_s`` seconds of the window, then profiles
``trace_dispatches`` dispatches.  The profiler's own host work slows the
host-bound loop, so the traced span's idle share reads high, and the
queries alive while the profiler ran are left out of ``Run.latency_ms``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import loadgen
from benchmark import trace as tr_mod
from benchmark import traffic
from benchmark.common import Cell, Run, cell_program, log, sync


class _Timed:
    """The runner's step_async and insert_samples, wrapped on the instance:
    host seconds of each call over the window's first ``trace_from``
    seconds; then a profile over the next ``skip + count`` dispatches, the
    last ``count`` of them inside the traced span (the profiler's start
    slows the first few)."""

    def __init__(self, runner, device, trace_from: float, count: int, skip: int = 5):
        self.runner, self.device = runner, device
        self.trace_from, self.count, self.skip = trace_from, count, skip
        self.host: Dict[str, List[float]] = {"dispatch": [], "insert": []}
        self.prof = None
        self.events = None
        self.profiled = 0  # dispatches enqueued under the profiler
        self.span: List[float] = []  # perf_counter at the profiler's start and stop
        self.t0 = time.perf_counter()
        self._step, self._insert = runner.step_async, runner.insert_samples
        runner.step_async, runner.insert_samples = self.step_async, self.insert_samples

    def _timing(self) -> bool:
        return time.perf_counter() - self.t0 < self.trace_from

    def step_async(self):
        if self._timing():
            t = time.perf_counter()
            mask = self._step()
            self.host["dispatch"].append(time.perf_counter() - t)
            return mask
        if self.events is not None:
            return self._step()
        if self.prof is None:
            self.span = [time.perf_counter()]
            self.prof = tr_mod.profiler(torch.device(self.device))
            self.prof.start()
        self.profiled += 1
        if self.profiled <= self.skip:
            return self._step()
        with torch.profiler.record_function(tr_mod.SPAN):
            mask = self._step()
        if self.profiled == self.skip + self.count:
            self.stop()
        return mask

    def insert_samples(self, wavs, ids):
        timing = self._timing()
        t = time.perf_counter()
        self._insert(wavs, ids)
        if timing:
            self.host["insert"].append(time.perf_counter() - t)

    def stop(self):
        if self.prof is not None:
            sync(self.device)  # the traced dispatches' kernels end inside the profile
            self.prof.stop()
            self.events = tr_mod.export_events(self.prof)
            self.prof = None
            self.span.append(time.perf_counter())

    def restore(self):
        self.stop()
        self.runner.step_async, self.runner.insert_samples = self._step, self._insert


class Serving:
    """The runner of a cell with its store, set up and warmed: ``serve``
    issues a schedule through it."""

    def __init__(self, cell: Cell, device, seed: int):
        from rnnt_inference_tpu_torch.data.dataset import SampleStore
        from rnnt_inference_tpu_torch.runtime.server import ServerRunner

        tr = cell.traffic
        self.cell, self.device, self.tr = cell, device, tr
        s_order, self.s_arr, s_warm, self.s_check = traffic.substreams(seed, 4)
        self.weights, served, self.params, self.cfg = cell_program(
            cell, device, tr["max_symbols_per_step"])
        _, self.wavs = traffic.store(tr["duration"], tr["utterances"], s_order, device)
        self.store = SampleStore(kind="waveform", samples=self.wavs,
                                 transcripts=[""] * len(self.wavs))
        self.runner = ServerRunner(served, self.params, self.cfg, slots=tr["slots"],
                                   split_len=tr["split_len"], insert_batch=tr["insert_batch"],
                                   steps_per_dispatch=tr["steps_per_dispatch"], device=device)
        self.runner.warmup()
        self.serve(*self.schedule(tr["qps"], tr["warm_s"], s_warm), tr["warm_s"])
        sync(device)
        gc.collect()
        gc.freeze()

    def schedule(self, qps: float, seconds: float, seed: int):
        """(arrival times, store utterance of each query) in ``seed``'s order."""
        return traffic.arrivals(qps, seconds, len(self.wavs), self.tr["arrivals_seed"], seed)

    def serve(self, schedule: np.ndarray, order: np.ndarray, seconds: float):
        """(the loadgen, {query: tokens}) of serving the schedule; the
        dispatches it took are left in ``self.dispatches``."""
        from rnnt_inference_tpu_torch.runtime.scheduler import run_server_native

        tr = self.tr
        with loadgen.serving_from(schedule, order) as made:
            report, results = run_server_native(
                self.runner, self.store, target_qps=tr["qps"], qos_len=tr["qos_len"],
                max_wall_s=seconds + tr["grace_s"], pipeline_depth=tr["pipeline_depth"],
                response_size=tr["response_size"], min_duration_s=seconds)
        # a dispatch runs steps_per_dispatch chunks, one kernel-B launch each
        self.dispatches = report["launches"].get("decode_step", 0) // tr["steps_per_dispatch"]
        return made[0], results


def latencies(lg) -> Tuple[np.ndarray, np.ndarray, float]:
    """(latency ms of every scheduled query, answered mask, the last
    answer's time): a query never answered has the latency it had reached
    when the loadgen closed."""
    sched, _, done = lg.stamps()
    answered = done >= 0
    end = max(lg.closed_at, float(done.max()) if answered.any() else 0.0)
    return (np.where(answered, done, end) - sched) * 1e3, answered, float(done.max())


def run(cell: Cell, device, seed: int, seconds: float, traced: bool, t_begin: float) -> Run:
    """One run of the cell; ``t_begin`` is the process's start on
    time.perf_counter, from which set-up is counted."""
    sv = Serving(cell, device, seed)
    out = Run(cell=cell, weights=sv.weights)
    schedule, order = sv.schedule(cell.traffic["qps"], seconds, sv.s_arr)
    out.e2e["setup_s"] = time.perf_counter() - t_begin
    timed = (_Timed(sv.runner, device, cell.traffic["trace_from_s"],
                    cell.traffic["trace_dispatches"]) if traced else None)
    try:
        lg, results = sv.serve(schedule, order, seconds)
    finally:
        if timed is not None:
            timed.restore()
    if torch.device(device).type == "cuda":
        out.memory_peak = int(torch.cuda.max_memory_allocated(device))

    lat_ms, answered, last = latencies(lg)
    sched, issued, _ = lg.stamps()
    out.attempted, out.failed = len(schedule), int((~answered).sum())
    out.e2e["latency_p50_ms"] = float(np.percentile(lat_ms, 50))
    out.e2e["latency_p99_ms"] = float(np.percentile(lat_ms, 99))
    out.latency_ms = lat_ms.tolist()
    if timed is not None and timed.span:
        # the profiled span on the loadgen's clock, to the window's end if
        # the profiler never stopped
        a = timed.span[0] - lg.t0_perf
        b = timed.span[1] - lg.t0_perf if len(timed.span) > 1 else np.inf
        outside = (sched + lat_ms / 1e3 < a) | (sched > b)
        out.latency_ms = lat_ms[outside].tolist()
        log(f"profiled span {a:.3f}-{b:.3f} s of the window: {int(outside.sum())} of "
            f"{len(lat_ms)} queries lived outside it")
    late = issued[issued >= 0] - sched[issued >= 0]
    log(f"window: {len(schedule)} queries scheduled over {seconds} s, {int(answered.sum())} "
        f"answered, the last at {last:.3f} s; issue lateness p50 "
        f"{np.percentile(late, 50) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms; latency p50 "
        f"{out.e2e['latency_p50_ms']:.2f} ms, p99 {out.e2e['latency_p99_ms']:.2f} ms, max "
        f"{lat_ms.max():.2f} ms; p50 by quarter of the window "
        f"{[round(float(np.percentile(q, 50)), 2) for q in np.array_split(lat_ms, 4)]} ms; "
        f"{sv.dispatches} dispatches, {last * 1e3 / max(sv.dispatches, 1):.3f} ms apart")
    if timed is not None:
        out.host_s = timed.host
        out.trace = tr_mod.Trace.of(timed.events) if timed.events else None

    got = sorted(q for q in results if q >= 0)
    syms = np.array([len(results[q]) for q in got])
    lens_q = np.array([len(sv.wavs[order[q]]) for q in got])
    work = cell.model.work(cell.config, sv.params, sv.cfg, lens_q, [results[q] for q in got], 1)
    log(f"symbols per post-stack frame in the window: "
        f"{work['symbols'] / work['post_frames']:.4f}")
    pick = traffic.check_sample(len(got), cell.traffic["check_queries"], sv.s_check,
                                [int(np.argmax(lens_q)), int(np.argmax(syms))])
    out.check_wavs = [sv.wavs[order[got[i]]] for i in pick]
    out.check_tokens = [results[got[i]] for i in pick]
    return out
