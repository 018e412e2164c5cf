"""Server-scenario load generation and latency accounting (counterpart of
rnnt_inference_tpu/runtime/scheduler.py).

Poisson arrivals at a target QPS, a FIFO issue queue, per-sample completion
latency and the p50/p90/p99 summary.  QoS deferral: samples longer than
qos_len waveform samples are parked and served only after the main stream
drains, and their latencies are kept apart from the live percentiles.
response_size: finished slots are responded in groups of at least
response_size, except while the tail drains or the slot pool is starved.
Queries loop over the sample set (query q -> sample order[q % n]).
``run_server`` keeps its own Poisson schedule on the Python clock;
``run_server_native`` takes arrivals and latencies from the native
mini-loadgen (runtime/native.py).  Both dispatch steps with
``ServerRunner.step_async`` and read the finish masks back later: the host
admits new queries while the card runs the steps already enqueued.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.runtime.server import ServerRunner
from rnnt_inference_tpu_torch.utils.profiler import REGISTRY, span


@dataclass
class ServerMetrics:
    latencies_ms: Dict[int, float] = field(default_factory=dict)
    # QoS-deferred queries, kept out of the live percentiles
    deferred_latencies_ms: Dict[int, float] = field(default_factory=dict)
    issued: int = 0
    completed: int = 0
    wall_seconds: float = 0.0

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(list(self.latencies_ms.values()), p))

    def summary(self) -> dict:
        # None, not NaN, when every completion was deferred: NaN is not
        # JSON, and validate_report calls a missing percentile INVALID
        have_live = bool(self.latencies_ms)
        d = dict(
            scenario="Server",
            completed=self.completed,
            completed_live=len(self.latencies_ms),
            wall_seconds=round(self.wall_seconds, 3),
            qps=round(self.completed / self.wall_seconds, 2) if self.wall_seconds else 0,
            latency_ms_p50=round(self.percentile(50), 1) if have_live else None,
            latency_ms_p90=round(self.percentile(90), 1) if have_live else None,
            latency_ms_p99=round(self.percentile(99), 1) if have_live else None,
        )
        if self.deferred_latencies_ms:
            vals = list(self.deferred_latencies_ms.values())
            d["deferred_completed"] = len(vals)
            d["deferred_ms_mean"] = round(float(np.mean(vals)), 1)
            d["deferred_ms_max"] = round(float(np.max(vals)), 1)
        slow = sorted(((q, lat) for q, lat in self.latencies_ms.items() if lat > 1000.0),
                      key=lambda kv: -kv[1])
        if slow:
            d["slow_sample_count"] = len(slow)
            d["slow_samples"] = [{"query": int(q), "latency_ms": round(lat, 1)}
                                 for q, lat in slow[:16]]
        return d


def poisson_schedule(n: int, target_qps: float, seed: int = 0) -> np.ndarray:
    """Arrival offsets (seconds) of n samples at target_qps (exponential
    gaps, as loadgen's Server mode)."""
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / target_qps, size=n))


def run_server(
    runner: ServerRunner,
    store: SampleStore,
    target_qps: float,
    sample_order: Optional[np.ndarray] = None,
    seed: int = 0,
    qos_len: int = 233500,
    max_wall_s: float = 600.0,
    realtime: bool = True,
    response_size: int = 1,
    min_query_count: int = 0,
    min_duration_s: float = 0.0,
    inflight_window: int = 1,
) -> Tuple[ServerMetrics, Dict[int, np.ndarray]]:
    """Drive the slot pipeline against a Poisson arrival trace.

    realtime=True keeps the wall-clock arrival times (Server latency);
    realtime=False issues as fast as the pipeline accepts (latencies then
    measure residency from the actual issue).  Each loop dispatches one
    step without reading it back, and the finish masks in flight are read
    once there are ``inflight_window`` of them or no slot is active.
    Returns (metrics, {query_id: tokens}); query q is sample
    sample_order[q % len(store)] (default: the store's order)."""
    n = len(store)
    n_queries = max(n, min_query_count)
    order = sample_order if sample_order is not None else np.arange(n)
    # twice the duration's arrivals: a sum of qps * dur exponential gaps
    # has mean dur, so about half the seeds would run out before it
    arrivals = poisson_schedule(
        max(n_queries, int(target_qps * min_duration_s * 2) + 16), target_qps, seed)

    metrics = ServerMetrics()
    results: Dict[int, np.ndarray] = {}
    issue_times: Dict[int, float] = {}
    deferred: List[int] = []
    deferred_set = set()

    t_start = time.time()
    next_i = 0
    finished_backlog: List[int] = []
    inflight = []  # finish masks of dispatches not read back yet

    # issue until the count and the duration rules are both met
    nq = n_queries
    while nq < len(arrivals) and arrivals[nq - 1] < min_duration_s:
        nq += 1

    def respond(pairs):
        now = time.time()
        for query_id, tokens in pairs:
            results[query_id] = tokens
            pool = (metrics.deferred_latencies_ms if query_id in deferred_set
                    else metrics.latencies_ms)
            pool[query_id] = (now - issue_times[query_id]) * 1e3
            metrics.completed += 1

    def sample_of(q: int) -> int:
        return int(order[q % n])

    def drain_inflight(force: bool) -> None:
        # responses wait for >= response_size finished slots unless forced
        # (tail drain, slot starvation)
        while inflight:
            finished_backlog.extend(int(s) for s in np.nonzero(inflight.pop(0).cpu().numpy())[0])
        tail = next_i >= nq and not deferred
        starved = not runner.free_slots
        if finished_backlog and (force or tail or starved
                                 or len(finished_backlog) >= response_size):
            respond(runner.extract(finished_backlog))
            finished_backlog.clear()

    while metrics.completed < nq and (time.time() - t_start) < max_wall_s:
        now = time.time() - t_start
        # 1. admit due arrivals into free slots (QoS: defer over-long samples)
        batch: List[int] = []
        while (next_i < nq and (not realtime or arrivals[next_i] <= now)
               and len(batch) < runner.insert_batch and len(batch) < len(runner.free_slots)):
            q = next_i
            next_i += 1
            issue_times[q] = t_start + arrivals[q] if realtime else time.time()
            if store.samples[sample_of(q)].shape[0] > qos_len:
                deferred.append(q)
                deferred_set.add(q)
                continue
            batch.append(q)
        # the deferred samples once the main stream is exhausted
        if next_i >= nq and not batch and deferred:
            while deferred and len(batch) < min(runner.insert_batch, len(runner.free_slots)):
                q = deferred.pop(0)
                if not realtime:
                    issue_times[q] = time.time()
                batch.append(q)
        if batch:
            runner.insert_samples([store.samples[sample_of(q)] for q in batch], batch)
            metrics.issued += len(batch)

        # 2. streaming steps, dispatched without a read back: the insert
        # and the step queue on the card behind the steps still running
        if runner.n_active:
            inflight.append(runner.step_async())
        elif next_i < nq and realtime and not inflight:
            wait = arrivals[next_i] - (time.time() - t_start)  # idle until the next arrival
            if wait > 0:
                time.sleep(min(wait, 0.01))

        # 3. read the finish masks back, and respond in response_size groups
        if len(inflight) >= inflight_window or not runner.n_active:
            drain_inflight(force=not runner.n_active and next_i >= nq)

    metrics.wall_seconds = time.time() - t_start
    return metrics, results


def run_server_native(
    runner: ServerRunner,
    store: SampleStore,
    target_qps: float,
    seed: int = 0,
    qos_len: int = 233500,
    max_wall_s: float = 600.0,
    pipeline_depth: int = 16,
    response_size: int = 1,
    min_query_count: int = 0,
    min_duration_s: float = 0.0,
) -> Tuple[dict, Dict[int, np.ndarray]]:
    """Server run driven by the native mini-loadgen: a C++ thread issues
    Poisson arrivals on a steady clock and completions are stamped there, so
    latencies are free of Python jitter and charged from the scheduled
    arrival (loadgen's rule).  The issuer keeps the min_query_count and
    min_duration rules.  Steps are dispatched ahead of their read back
    (``ServerRunner.step_async``): past ``pipeline_depth`` finish masks in
    flight the oldest are read down to depth // 2; short of free slots, or
    at the tail, all of them; otherwise none.

    The loop's host phases are spans (utils/profiler.py): rnnt.server.poll,
    .insert, .dispatch, .read_mask and .extract; each query's stamps are
    left in ``REGISTRY.server`` (a ``QueryRecord`` made anew per call).

    Returns (the native latency report, with the kernel launches of the
    run under "launches"; {query_id: tokens})."""
    from rnnt_inference_tpu_torch.runtime.native import NativeLoadGen
    from rnnt_inference_tpu_torch.runtime.offline import launch_counts, launches_since

    results: Dict[int, np.ndarray] = {}
    deferred: List[int] = []
    inflight = []  # (finish mask, end of its dispatch's enqueue) not read back yet
    finished_backlog: List[int] = []
    before = launch_counts()
    lg = NativeLoadGen(len(store), target_qps, mode="Server", seed=seed,
                       min_query_count=min_query_count, min_duration_s=min_duration_s)
    t_start = time.time()
    stamps = REGISTRY.new_server_record().stamps  # each query's, by id
    polled, inserted, enqueued = stamps["polled"], stamps["inserted"], stamps["finish_enqueued"]
    mask_read, completed = stamps["mask_read"], stamps["completed"]

    def drain_one(force: bool) -> None:
        mask, enqueued_ns = inflight.pop(0)
        with span("rnnt.server.read_mask") as read:
            host = mask.cpu()
        finished = [int(s) for s in np.nonzero(host.numpy())[0]]
        for slot in finished:
            query_id = runner.slot_sample[slot]
            if query_id >= 0:  # not a warm-up sample
                enqueued[query_id] = enqueued_ns
                mask_read[query_id] = read.end_ns
        finished_backlog.extend(finished)
        # respond in response_size groups, unless forced, the tail drains
        # or the slot pool is starved
        tail = lg.done_issuing and lg.pending == 0 and not deferred
        starved = not runner.free_slots
        if finished_backlog and (force or tail or starved
                                 or len(finished_backlog) >= response_size):
            with span("rnnt.server.extract"):
                answers = runner.extract(finished_backlog)
            for query_id, tokens in answers:
                results[query_id] = tokens
                if query_id >= 0:  # not a warm-up sample
                    completed[query_id] = time.perf_counter_ns()
                    lg.complete(query_id)
            finished_backlog.clear()

    try:
        while not lg.drained and time.time() - t_start < max_wall_s:
            # 1. admit arrivals into free slots (QoS: park over-long samples)
            room = min(runner.insert_batch, len(runner.free_slots))
            batch: List[int] = []
            if room:
                with span("rnnt.server.poll") as poll:
                    arrived = lg.poll(max_n=room, timeout_us=500)
                for q in arrived:
                    polled[q] = poll.end_ns
                    if store.samples[lg.sample_of(q)].shape[0] > qos_len:
                        lg.mark_deferred(q)  # kept out of the live percentiles
                        deferred.append(q)
                    else:
                        batch.append(q)
            # the deferred queries once the issue stream is exhausted; not
            # only on an idle pipeline: finished slots are freed by extract,
            # which may wait for response_size finishers, so waiting for
            # n_active == 0 here could wait forever
            if lg.pending == 0 and lg.done_issuing and not batch and deferred:
                while deferred and len(batch) < room:
                    batch.append(deferred.pop(0))
            if batch:
                with span("rnnt.server.insert") as insert:
                    runner.insert_samples([store.samples[lg.sample_of(q)] for q in batch], batch)
                for q in batch:
                    inserted[q] = insert.end_ns

            # 2. dispatch steps ahead and read the finish masks back lazily
            if runner.n_active:
                with span("rnnt.server.dispatch") as dispatch:
                    mask = runner.step_async()
                inflight.append((mask, dispatch.end_ns))
            if inflight:
                if len(inflight) > pipeline_depth:
                    target = max(pipeline_depth // 2, 1)
                elif not runner.free_slots or (not runner.n_active and lg.pending == 0):
                    target = 0  # short of slots, or the tail: read them all
                else:
                    target = len(inflight)
                force = not runner.n_active and lg.pending == 0 and lg.done_issuing
                while len(inflight) > target:
                    drain_one(force)
        report = lg.report()
    finally:
        lg.close()
    report["launches"] = launches_since(before)
    return report, results
