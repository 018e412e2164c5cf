"""Sustained Server-scenario measurement (counterpart of
scripts/server_probe.py).

    python -m rnnt_inference_tpu_torch.tools.server_probe [qps1,qps2,...] [duration_s] \\
        [--native_loadgen] [--pipeline_depth 16] [--mlperf_conf configs/mlperf.conf] \\
        [--user_conf configs/user.conf] [--model w.npz | --quant_in q.npz] [--device cpu]

Env: PROBE_SLOTS (128), PROBE_SPLIT (24), PROBE_N (512 synthetic
utterances), PROBE_DTYPE (bf16|f32|quant; seeded weights, ignored with
--model or --quant_in), PROBE_WINDOW (8: the Python-clock levels'
``inflight_window``, as the JAX probe).  --pipeline_depth is the native
levels' ``run_server_native`` depth (16, the product's).  Defaults: the
ladder 10,20,40,80 QPS, 60 s per level.  Everything runs on the card
unless --device cpu is given.

Two quantities, reported apart:

  1. STEP CADENCE: wall time per ``ServerRunner.step`` (one dispatch of
     steps_per_dispatch streaming steps over all slots) over K = 50 steps,
     with every slot kept occupied for the whole window (a slot that
     finishes is refilled before the next step; the refills are outside
     the timed calls).  ``step`` reads its finish mask back at once, so
     the cadence includes that read.  Beside the wall: the CUDA-event span
     of the same steps on the card's stream (first enqueue to the finish
     mask's read) and, from a torch.profiler trace of a second window of K
     steps, the union of the kernels' time inside each step, whose
     complement is the host's share of the wall (given only when the trace
     holds every launch of A and B it made).  Then the same for a window of
     K dispatches made with ``step_async`` under run_server_native's drain
     policy at the pipeline depth, the finished slots extracted and
     refilled inside the window (a saturated Server's loop): wall and
     CUDA-event span per dispatch, the kernels' busy time and the device's
     idle share over the window, and the time spent in ``extract``.
  2. LATENCY LADDER: Poisson arrivals at each QPS level for ``duration``
     seconds (min_query_count = qps x duration, response_size 9, at most
     4 x duration of wall), on the Python clock (runtime/scheduler.py
     ``run_server``, ``inflight_window`` PROBE_WINDOW) or, with
     --native_loadgen, on the native mini-loadgen's (``run_server_native``
     at --pipeline_depth, the product's clock).  Every level gets the
     MLPerf verdict of runtime/config.py ``validate_report`` against
     ``TestSettings.from_conf(--mlperf_conf, --user_conf, "rnnt",
     "Server")``.  The rules each level was held to are printed with it:
     the defaults are configs/mlperf.conf's (min_duration 600 s,
     min_query_count 270336), which no probe level of a few seconds meets,
     so a shorter probe passes a --user_conf that cuts them.

stdout is one JSON line: device_step_cadence_ms, split_len, slots, the
ladder (each level's report, verdict, target_qps and pipeline_depth or
inflight_window), highest_valid_qps (None when no level is VALID) and
rules (per level: the min_duration, min_query_count and latency bound it
was held to).  The cadences' other numbers and each level's report go to
stderr as they come.

``probe`` does the work on a ServerRunner the caller has built, so a
script that already holds a model can run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.runtime.config import TestSettings, validate_report
from rnnt_inference_tpu_torch.runtime.offline import launch_counts, launches_since
from rnnt_inference_tpu_torch.runtime.scheduler import run_server, run_server_native
from rnnt_inference_tpu_torch.runtime.server import ServerRunner
from rnnt_inference_tpu_torch.utils import profiler

CADENCE_STEPS = 50
# the CUDA functions of the wrappers that launch A and B on a Server step
KERNEL_NAMES = {"quant_lstm_layer": "quant_lstm", "decode_step": "decode_loop"}
RESPONSE_SIZE = 9
STEP_SPAN = "rnnt.server_step"
WINDOW_SPAN = "rnnt.server_window"
PIPELINE_DEPTH = 16  # run_server_native's default, the product's


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def _fill(runner: ServerRunner, store: SampleStore, nxt: int) -> int:
    """Insert samples (cycling through the store from index ``nxt``) until
    every slot is occupied; returns the next index."""
    while runner.free_slots:
        k = min(runner.insert_batch, len(runner.free_slots))
        idx = [(nxt + i) % len(store) for i in range(k)]
        runner.insert_samples([store.samples[i] for i in idx], idx)
        nxt += k
    return nxt


def _steps(runner: ServerRunner, store: SampleStore, k: int, nxt: int):
    """k timed steps, every slot occupied at each: (wall seconds per step,
    CUDA-event ms per step (empty on the CPU), the next store index).  The
    refills are synchronized before the step that follows them, so a
    step's span on the card holds only its own work."""
    cuda = runner.device.type == "cuda"
    walls, pairs = [], []
    for _ in range(k):
        nxt = _fill(runner, store, nxt)
        if cuda:
            torch.cuda.synchronize(runner.device)
        with torch.profiler.record_function(STEP_SPAN):
            if cuda:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            finished = runner.step()
            walls.append(time.perf_counter() - t0)
            if cuda:
                b.record()
                pairs.append((a, b))
        if len(finished):
            runner.extract(finished)
    if cuda:
        torch.cuda.synchronize(runner.device)
    return walls, [a.elapsed_time(b) for a, b in pairs], nxt


def step_cadence(runner: ServerRunner, store: SampleStore, steps: int = CADENCE_STEPS) -> dict:
    """Part 1: the wall time per ``runner.step`` over ``steps`` steps with
    every slot occupied (refilled between steps), the CUDA-event span of
    each step, and the kernels' busy time per step from a torch.profiler
    trace of a second window of ``steps`` steps (on the card; None on the
    CPU, and None when the trace holds fewer kernel-A or kernel-B launches
    than the window made: ``trace_kernels`` has both counts).  The runner
    is drained afterwards."""
    cuda = runner.device.type == "cuda"
    _, _, nxt = _steps(runner, store, 2, 0)  # warm
    before = launch_counts()
    walls, event_ms, nxt = _steps(runner, store, steps, nxt)
    launches = launches_since(before)
    busy_ms, traced = None, None
    if cuda:
        spans, traced = _traced(runner, lambda: _steps(runner, store, steps, nxt), STEP_SPAN,
                                steps)
        if traced["traced"] == traced["launched"]:
            busy_ms = float(np.mean([s["busy_us"] for s in spans])) / 1e3
    _drain(runner)
    wall_ms = float(np.mean(walls)) * 1e3
    out = dict(steps=steps, slots=runner.slots, split_len=runner.split_len,
               steps_per_dispatch=runner.steps_per_dispatch,
               wall_ms_per_step=wall_ms, wall_ms_p50=float(np.median(walls)) * 1e3,
               wall_ms_max=float(np.max(walls)) * 1e3, launches=launches,
               event_ms_per_step=float(np.mean(event_ms)) if cuda else None,
               kernel_busy_ms_per_step=busy_ms,
               host_share=None if busy_ms is None else 1.0 - busy_ms / wall_ms,
               trace_kernels=traced,
               slot_audio_seconds_per_step=runner.slots * runner.steps_per_dispatch
               * runner.split_len * runner.cfg.hop_length * runner.cfg.frame_splicing
               / runner.cfg.sample_rate)
    return out


def _drain(runner: ServerRunner) -> None:
    while runner.n_active:
        finished = runner.step()
        if len(finished):
            runner.extract(finished)


def _traced(runner: ServerRunner, window: Callable, span: str, n_spans: int):
    """Run ``window()`` under a torch.profiler trace of the card: (the
    trace's ``span`` windows with the kernels' busy time and idle share,
    dict(traced=kernel A and B launches in the trace, launched=the
    wrappers' counts)).  The busy time counts only where the two agree."""
    with tempfile.TemporaryDirectory() as d:
        before = launch_counts()
        with profiler.device_trace(d, runner.device) as path:
            window()
        profiled = launches_since(before)
        trace = profiler.load_trace(path)
    spans = profiler.device_idle_share(trace, span=span)
    if len(spans) != n_spans:
        raise RuntimeError(f"the trace holds {len(spans)} {span} spans, not {n_spans}")
    counts = {k: sum(1 for e in trace if e.get("cat") == "kernel" and f"::{name}<" in
                     e.get("name", "")) for k, name in KERNEL_NAMES.items()}
    return spans, dict(traced=counts, launched={k: profiled[k] for k in KERNEL_NAMES})


def _async_window(runner: ServerRunner, store: SampleStore, k: int, nxt: int, depth: int):
    """k dispatches with ``step_async``, every slot occupied at the start:
    past ``depth`` masks in flight the oldest are read down to depth // 2
    (run_server_native's rule), their finished slots extracted and every
    free slot refilled, all inside the timed window, which ends once the
    card has run the last dispatch.  The masks still in flight are read
    and extracted after it.  Returns (wall seconds, CUDA-event ms or None,
    seconds inside ``extract``, its calls, the next store index)."""
    cuda = runner.device.type == "cuda"
    nxt = _fill(runner, store, nxt)
    if cuda:
        torch.cuda.synchronize(runner.device)
    inflight, extract_s, extracts = [], 0.0, 0

    def read(target: int):
        nonlocal extract_s, extracts
        while len(inflight) > target:
            finished = np.nonzero(inflight.pop(0).cpu().numpy())[0]
            if len(finished):
                t0 = time.perf_counter()
                runner.extract(finished)
                extract_s += time.perf_counter() - t0
                extracts += 1

    with torch.profiler.record_function(WINDOW_SPAN):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        for _ in range(k):
            inflight.append(runner.step_async())
            if len(inflight) > depth:
                read(max(depth // 2, 1))
                nxt = _fill(runner, store, nxt)
        if cuda:
            b.record()
            b.synchronize()
        wall = time.perf_counter() - t0
    read(0)
    return wall, a.elapsed_time(b) if cuda else None, extract_s, extracts, nxt


def async_cadence(runner: ServerRunner, store: SampleStore, steps: int = CADENCE_STEPS,
                  depth: int = PIPELINE_DEPTH) -> dict:
    """Part 1 with ``step_async``: ``steps`` dispatches through
    ``_async_window`` at ``depth``: wall and CUDA-event ms per dispatch,
    the time inside ``extract`` (which reads the newest state, so it waits
    for every dispatch enqueued), and from a trace of a second window the
    kernels' busy ms per dispatch and the device's idle share over the
    window (None unless the trace holds every A and B launch it made).
    ``launches`` holds the first window's, so B's launches per streaming
    step read one per chunk."""
    cuda = runner.device.type == "cuda"
    _, _, _, _, nxt = _async_window(runner, store, 2, 0, depth)  # warm
    before = launch_counts()
    wall, event_ms, extract_s, extracts, nxt = _async_window(runner, store, steps, nxt, depth)
    launches = launches_since(before)
    busy_ms = idle = traced = None
    if cuda:
        spans, traced = _traced(runner, lambda: _async_window(runner, store, steps, nxt, depth),
                                WINDOW_SPAN, 1)
        if traced["traced"] == traced["launched"]:
            busy_ms, idle = spans[0]["busy_us"] / 1e3 / steps, spans[0]["idle_share"]
    _drain(runner)
    chunks = steps * runner.steps_per_dispatch
    return dict(dispatches=steps, pipeline_depth=depth,
                wall_ms_per_dispatch=wall * 1e3 / steps,
                event_ms_per_dispatch=None if event_ms is None else event_ms / steps,
                kernel_busy_ms_per_dispatch=busy_ms, device_idle_share=idle,
                extract_calls=extracts, extract_ms_total=extract_s * 1e3,
                extract_share_of_wall=extract_s / wall, launches=launches,
                decode_launches_per_chunk=launches["decode_step"] / chunks,
                trace_kernels=traced)


def rules_of(settings: TestSettings) -> dict:
    return dict(min_duration_ms=settings.min_duration_ms,
                min_query_count=settings.min_query_count,
                target_latency_ms=settings.target_latency_ms,
                target_latency_percentile=settings.target_latency_percentile)


def probe_level(runner: ServerRunner, store: SampleStore, qps: float, duration_s: float,
                settings: TestSettings, native: bool = False, seed: int = 0,
                pipeline_depth: int = PIPELINE_DEPTH, inflight_window: int = 8):
    """One ladder level: Poisson arrivals at ``qps`` for ``duration_s``
    (min_query_count = qps x duration, query q on sample q % m of the
    store's first m = min(len(store), qps x duration) samples, response_size 9, at most
    4 x duration of wall) on the native clock at ``pipeline_depth`` or on
    the Python clock at ``inflight_window``, then its verdict against
    ``settings``.  Returns (the level's report with issued, completed, the
    latency percentiles, its verdict, target_qps, clock, depth or window
    and launches; {query: tokens})."""
    count = max(1, int(qps * duration_s))
    kw = dict(target_qps=qps, seed=seed, response_size=RESPONSE_SIZE, min_query_count=count,
              min_duration_s=duration_s, max_wall_s=4 * duration_s)
    before = launch_counts()
    if native:
        report, results = run_server_native(runner, store, pipeline_depth=pipeline_depth, **kw)
        report = {k: v for k, v in report.items() if k != "launches"}
        pipeline = dict(pipeline_depth=pipeline_depth)
    else:
        # run_server issues at least one query per sample of its store: the
        # store's first qps x duration samples, as the native issuer serves
        if count < len(store):
            store = store.select(np.arange(count))
        metrics, results = run_server(runner, store, realtime=True,
                                      inflight_window=inflight_window, **kw)
        report = dict(metrics.summary(), issued=metrics.issued)
        pipeline = dict(inflight_window=inflight_window)
    level = validate_report(settings, report)
    level.update(target_qps=qps, clock="native" if native else "python",
                 launches=launches_since(before), **pipeline)
    return level, results


def probe(
    runner: ServerRunner,
    store: SampleStore,
    ladder: Sequence[float],
    duration_s: float,
    settings_for: Callable[[float], TestSettings],
    native: bool = False,
    cadence_steps: int = CADENCE_STEPS,
    stop_after_invalid: bool = False,
    min_levels: int = 0,
    pipeline_depth: int = PIPELINE_DEPTH,
    inflight_window: int = 8,
) -> dict:
    """The step cadence (synchronous, then with ``step_async`` at
    ``pipeline_depth``), then the ladder: each level through
    ``probe_level``, held to ``settings_for(qps)``.  With
    ``stop_after_invalid`` the ladder stops after its first INVALID level
    once ``min_levels`` levels have run.  Returns the probe's JSON object:
    device_step_cadence_ms, split_len, slots, ladder (each level with its
    pipeline_depth or inflight_window), highest_valid_qps, rules; and the
    cadence's details under "cadence", the ``step_async`` window's under
    its "step_async" (not printed)."""
    cadence = step_cadence(runner, store, cadence_steps)
    log("step cadence: " + json.dumps(cadence))
    cadence["step_async"] = async_cadence(runner, store, cadence_steps, pipeline_depth)
    log("step_async cadence: " + json.dumps(cadence["step_async"]))
    levels: List[dict] = []
    rules: List[dict] = []
    for qps in ladder:
        settings = settings_for(qps)
        level, _ = probe_level(runner, store, qps, duration_s, settings, native,
                               pipeline_depth=pipeline_depth, inflight_window=inflight_window)
        levels.append(level)
        rules.append(dict(target_qps=qps, **rules_of(settings)))
        log(json.dumps(level))
        if (stop_after_invalid and level["result_validity"] != "VALID"
                and len(levels) >= min_levels):
            break
    valid = [lv["target_qps"] for lv in levels if lv["result_validity"] == "VALID"]
    return dict(device_step_cadence_ms=cadence["wall_ms_per_step"], split_len=runner.split_len,
                slots=runner.slots, ladder=levels,
                highest_valid_qps=max(valid) if valid else None, rules=rules,
                cadence=cadence)


def probe_weights(params: RNNTParams, dtype: str, device, seed: int = 0,
                  model: Optional[str] = None, quant_in: Optional[str] = None):
    """The probe's model: ``quant_in`` (an int8 npz), ``model`` (a weights
    npz or a zenodo rnnt.pt, cast as ``dtype``), or seeded weights in
    ``dtype`` (bf16, f32, or quant: f32 weights calibrated on 64 seeded
    feature frames of 8 lanes and quantized, as the JAX probe does)."""
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights
    from rnnt_inference_tpu_torch.models.weights import init_weights, load_torch_checkpoint

    if quant_in:
        return checkpoint.load_quant_weights(quant_in, params, device)
    if model:
        w = (checkpoint.load_weights(model, params, device) if model.endswith(".npz")
             else load_torch_checkpoint(model, params, device))
    else:
        w = init_weights(params, torch.Generator().manual_seed(seed), device=device)
    if dtype == "quant":
        xc = torch.randn((64, 8, params.trans_input_size),
                         generator=torch.Generator().manual_seed(seed + 1)).to(device)
        lens = torch.full((8,), 64, dtype=torch.int32, device=device)
        return quantize_weights(w, calibrate(w, [(xc, lens)], params), params)
    if dtype not in ("bf16", "f32"):
        raise SystemExit(f"PROBE_DTYPE={dtype!r}: bf16, f32 or quant")
    return w.to(dtype=torch.bfloat16) if dtype == "bf16" else w


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("server_probe")
    p.add_argument("ladder", nargs="?", default="10,20,40,80", help="QPS levels, comma-separated")
    p.add_argument("duration", nargs="?", type=float, default=60.0, help="seconds per level")
    p.add_argument("--native_loadgen", action="store_true",
                   help="time the ladder on the native mini-loadgen's clock")
    p.add_argument("--pipeline_depth", type=int, default=PIPELINE_DEPTH,
                   help="finish masks in flight on the native clock (run_server_native)")
    p.add_argument("--mlperf_conf", type=str, default="configs/mlperf.conf")
    p.add_argument("--user_conf", type=str, default="configs/user.conf")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--quant_in", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    ladder = [float(q) for q in args.ladder.split(",")]
    slots = int(os.environ.get("PROBE_SLOTS", "128"))
    split = int(os.environ.get("PROBE_SPLIT", "24"))
    n = int(os.environ.get("PROBE_N", "512"))
    dtype = os.environ.get("PROBE_DTYPE", "bf16")
    window = int(os.environ.get("PROBE_WINDOW", "8"))

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but no CUDA device is available (use --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = RNNTParams(max_res_len=512)
    cfg = FeaturizerConfig()
    settings = TestSettings.from_conf(args.mlperf_conf, args.user_conf, "rnnt", "Server")
    log(f"device={device} slots={slots} split={split} dtype={dtype} "
        f"pipeline_depth={args.pipeline_depth} inflight_window={window} "
        f"rules={rules_of(settings)}")
    weights = probe_weights(params, dtype, device, args.seed, args.model, args.quant_in)
    store = SampleStore.synthetic(n=n, seed=args.seed)
    runner = ServerRunner(weights, params, cfg, slots=slots, split_len=split, device=device)
    log(f"warmup: {runner.warmup():.1f}s")
    out = probe(runner, store, ladder, args.duration, lambda _qps: settings,
                native=args.native_loadgen, pipeline_depth=args.pipeline_depth,
                inflight_window=window)
    line = {k: v for k, v in out.items() if k != "cadence"}
    print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
