"""Sustained Server-scenario measurement (counterpart of
scripts/server_probe.py).

    python -m rnnt_inference_tpu_torch.tools.server_probe [qps1,qps2,...] [duration_s] \\
        [--native_loadgen] [--mlperf_conf configs/mlperf.conf] \\
        [--user_conf configs/user.conf] [--model w.npz | --quant_in q.npz] [--device cpu]

Env: PROBE_SLOTS (128), PROBE_SPLIT (24), PROBE_N (512 synthetic
utterances), PROBE_DTYPE (bf16|f32|quant; seeded weights, ignored with
--model or --quant_in).  Defaults: the ladder 10,20,40,80 QPS, 60 s per
level.  Everything runs on the card unless --device cpu is given.

Two quantities, reported apart:

  1. STEP CADENCE: wall time per ``ServerRunner.step`` (one dispatch of
     steps_per_dispatch streaming steps over all slots) over K = 50 steps,
     with every slot kept occupied for the whole window (a slot that
     finishes is refilled before the next step; the refills are outside
     the timed calls).  ``step`` reads its finish mask back at once (the
     port has no step_async), so the cadence includes that read.  Beside
     the wall: the CUDA-event span of the same steps on the card's stream
     (first enqueue to the finish mask's read) and, from a torch.profiler
     trace of a second window of K steps, the union of the kernels' time
     inside each step, whose complement is the host's share of the wall
     (given only when the trace holds every launch of A and B it made).
  2. LATENCY LADDER: Poisson arrivals at each QPS level for ``duration``
     seconds (min_query_count = qps x duration, response_size 9, at most
     4 x duration of wall), on the Python clock (runtime/scheduler.py
     ``run_server``) or, with --native_loadgen, on the native
     mini-loadgen's (``run_server_native``, the product's clock).  Every
     level gets the MLPerf verdict of runtime/config.py ``validate_report``
     against ``TestSettings.from_conf(--mlperf_conf, --user_conf, "rnnt",
     "Server")``.  The rules each level was held to are printed with it:
     the defaults are configs/mlperf.conf's (min_duration 600 s,
     min_query_count 270336), which no probe level of a few seconds meets,
     so a shorter probe passes a --user_conf that cuts them.

stdout is one JSON line: device_step_cadence_ms, split_len, slots, the
ladder (each level's report, verdict and target_qps), highest_valid_qps
(None when no level is VALID) and rules (per level: the min_duration,
min_query_count and latency bound it was held to).  The cadence's other
numbers and each level's report go to stderr as they come.

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
        with tempfile.TemporaryDirectory() as d:
            before_trace = launch_counts()
            with profiler.device_trace(d, runner.device) as path:
                _steps(runner, store, steps, nxt)
            profiled = launches_since(before_trace)
            trace = profiler.load_trace(path)
        spans = profiler.device_idle_share(trace, span=STEP_SPAN)
        if len(spans) != steps:
            raise RuntimeError(f"the trace holds {len(spans)} step spans, not {steps}")
        # the busy time counts only if the trace holds every launch of the window
        counts = {k: sum(1 for e in trace if e.get("cat") == "kernel" and f"::{name}<" in
                         e.get("name", "")) for k, name in KERNEL_NAMES.items()}
        traced = dict(traced=counts, launched={k: profiled[k] for k in KERNEL_NAMES})
        if traced["traced"] == traced["launched"]:
            busy_ms = float(np.mean([s["busy_us"] for s in spans])) / 1e3
    while runner.n_active:  # drain
        finished = runner.step()
        if len(finished):
            runner.extract(finished)
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


def rules_of(settings: TestSettings) -> dict:
    return dict(min_duration_ms=settings.min_duration_ms,
                min_query_count=settings.min_query_count,
                target_latency_ms=settings.target_latency_ms,
                target_latency_percentile=settings.target_latency_percentile)


def probe_level(runner: ServerRunner, store: SampleStore, qps: float, duration_s: float,
                settings: TestSettings, native: bool = False, seed: int = 0):
    """One ladder level: Poisson arrivals at ``qps`` for ``duration_s``
    (min_query_count = qps x duration, query q on sample q % m of the
    store's first m = min(len(store), qps x duration) samples, response_size 9, at most
    4 x duration of wall) on the native or the Python clock, then its verdict
    against ``settings``.  Returns (the level's report with issued,
    completed, the latency percentiles, its verdict, target_qps, clock and
    launches; {query: tokens})."""
    count = max(1, int(qps * duration_s))
    kw = dict(target_qps=qps, seed=seed, response_size=RESPONSE_SIZE, min_query_count=count,
              min_duration_s=duration_s, max_wall_s=4 * duration_s)
    before = launch_counts()
    if native:
        report, results = run_server_native(runner, store, **kw)
        report = {k: v for k, v in report.items() if k != "launches"}
    else:
        # run_server issues at least one query per sample of its store: the
        # store's first qps x duration samples, as the native issuer serves
        if count < len(store):
            store = store.select(np.arange(count))
        metrics, results = run_server(runner, store, realtime=True, **kw)
        report = dict(metrics.summary(), issued=metrics.issued)
    level = validate_report(settings, report)
    level.update(target_qps=qps, clock="native" if native else "python",
                 launches=launches_since(before))
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
) -> dict:
    """The step cadence, then the ladder: each level through
    ``probe_level``, held to ``settings_for(qps)``.  With
    ``stop_after_invalid`` the ladder stops after its first INVALID level
    once ``min_levels`` levels have run.  Returns the probe's JSON object:
    device_step_cadence_ms, split_len, slots, ladder, highest_valid_qps,
    rules; and the cadence's details under "cadence" (not printed)."""
    cadence = step_cadence(runner, store, cadence_steps)
    log("step cadence: " + json.dumps(cadence))
    levels: List[dict] = []
    rules: List[dict] = []
    for qps in ladder:
        settings = settings_for(qps)
        level, _ = probe_level(runner, store, qps, duration_s, settings, native)
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

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but no CUDA device is available (use --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = RNNTParams(max_res_len=512)
    cfg = FeaturizerConfig()
    settings = TestSettings.from_conf(args.mlperf_conf, args.user_conf, "rnnt", "Server")
    log(f"device={device} slots={slots} split={split} dtype={dtype} rules={rules_of(settings)}")
    weights = probe_weights(params, dtype, device, args.seed, args.model, args.quant_in)
    store = SampleStore.synthetic(n=n, seed=args.seed)
    runner = ServerRunner(weights, params, cfg, slots=slots, split_len=split, device=device)
    log(f"warmup: {runner.warmup():.1f}s")
    out = probe(runner, store, ladder, args.duration, lambda _qps: settings,
                native=args.native_loadgen)
    line = {k: v for k, v in out.items() if k != "cadence"}
    print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
