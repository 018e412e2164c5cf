"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's five CUDA kernels from rnnt_inference_tpu_torch/csrc
(one nvcc per source, started together), holds each against its plain
PyTorch twin on the card at full model width (kernel A bit for bit at N =
16, 64, 128 lanes and T = 48, at the bench's 1,024 lanes and T = 16 and
8, and at one lane over a whole SingleStream utterance, for the three int8
layer shapes, on both its paths (fused, and x . W_ih hoisted into one
GEMM), each timed, one launch counted per layer call; kernel B per step
and over one launch of K iterations, at N = 1, 16, 64, 128 lanes, with
its time per iteration at one and at K iterations per launch, its early
exit, and the symbol loop's time by K; kernel C at N = 16, 128 beside
cuDNN's layer; kernel E, the bf16 projection, at the packed runner's
layer shapes, fproj and eproj, beside its bound and torch.mm's bf16-in,
f32-out product; the Conformer's kernels F and G and kernel B's
wide-vocabulary instantiation at the conformer.offline.speech cell's
shapes, phase conformer_kernels),
then drives each path with the kernel launch counts set to 0 just before
it and read just after:
  - end_to_end: the bucketed Offline int8 pipeline (waveform -> log-mel ->
    int8 encoder (kernel A) -> greedy decode (kernel B)) through
    OfflineRunner, once on the kernels and once on the twins;
  - features_fused: the fused featurizer entry point (kernel D, 3xTF32
    tensor-core products), on 16 utterances of 14-15 s: raw log-mel within
    1e-4 of its twin, normalized features within 5e-4, their drift from
    eager log_mel_features printed, and the int8 model's tokens on D's
    features held to the twin's (edit rate <= max(1e-3, twice the twin's
    rate against log_mel_features or against the twin summing in another
    order), as calibrated and with the bench's blank bias at cap 1, each
    with a token buffer no utterance fills); timed also at the largest wav
    batch the cut bench's packed runner stages;
  - cli_bf16 / cli_f32: the CLI, ``main --run_mode bf16|f32 --benchmark
    --scenario Offline --synthetic N`` (float encoder on kernel C, decode on
    kernel B), then the same store through run_offline on the twins;
  - packed_int8: the CLI's sequence-packed Offline run on the int8 model,
    ``main --run_mode quant --quant_in <tmp> --packed --benchmark
    --synthetic 64 --batch_size 16`` (kernel A per chunk, kernel B in
    packed mode), then the same store through the packed runner on the
    twins and through the bucketed int8 runner on the kernels;
  - server_int8: the Server slot pipeline (run_server over a ServerRunner
    of 32 slots, kernels A and B) on 32 utterances, as fast as it accepts
    them and then at half that rate in real time, its tokens against the
    bucketed int8 runner's;
  - fake_quant: ``main --run_mode fake_quant --calib_in ... --accuracy``
    on a small store (eager fake-quant encoder, kernel B's f32
    instantiation), on the card and with --device cpu (the twins);
  - native: ``main --native_loadgen --benchmark`` on the int8 model in
    Offline (bucketed and --packed, 64 utterances), Server (at the real-time
    rate of server_int8) and SingleStream, timed on the native mini-loadgen
    (g++ build), min_duration cut to 6 s by a user.conf; each against the
    same store's non-native run_offline on the kernels, and SingleStream
    also against its utterances through the one-lane runner on the twins;
  - product_chain: scripts/run.sh stages 3-5 through the CLI: a zenodo-layout
    rnnt.pt -> --calibration -> --save_quant -> --accuracy --packed
    --manifest (WER) -> native Offline performance, against the same chain
    from an npz of the same weights; a broken loadgen source must raise;
  - multi_device: the int8 runners with mesh= over every visible card
    (tokens equal the runs without it), on two shards of one card (packed
    at 1,024 lanes, bucketed at batch 32, Server-dp on 32 slots; launches
    per shard; tokens held to the single-device run), the multihost probe
    with two gloo ranks on the card and a one-rank NCCL group; with two or
    more cards, a mesh over two cards and two NCCL ranks (else a line says
    it did not run);
  - transcribe: wav and FLAC copies of 8 utterances through
    convert_librispeech (bit-equal), compute_features_store on the card,
    and the Transcriber on product_chain's rnnt.pt in bf16 (kernels C and
    B) against the twins;
  - server_probe: tools/server_probe.py on the bench's calibrated blank
    model (int8, cap 1, 0.8 symbols per frame), 128 slots, split 24: the
    step cadence over 50 full-slot steps (synchronous, then 50 step_async
    dispatches at depth 16 with the refills inside the window), then a
    ladder of Poisson rates (25 to 800 QPS, 6 s each under a user.conf
    that cuts min_duration to 6 s and min_query_count to qps x 6) on the
    native clock at pipeline depth 16 with each level's MLPerf verdict,
    stopping after the first INVALID level (at least three levels), and
    the highest VALID level and the lowest again on the Python clock
    (inflight_window 8); completed = issued at every level, and the lowest
    level's tokens equal the bucketed Offline runner's on its samples;
  - server_pipelined: the same model in a runner of its own: 50
    step_async dispatches and 8-slot inserts under
    torch.cuda.set_sync_debug_mode("error"), the native Server at depth 16
    and at depth 1 on the same arrivals at 200 QPS (tokens equal per
    query), the ladder at depth 1 beside depth 16's, and native packed
    Offline at max_inflight_cycles 1 and 4 (equal hypotheses);
  - run_stages: tools/run_stages.py, the port's scripts/run.sh flow, with
    QUICK=true STAGE=-1 SYNTHETIC=64 in a temporary WORK_DIR (kernels
    built, calibration on kernel C, quantization, stage 3b's check_calib,
    Offline and Server accuracy and native performance runs on kernels A
    and B); tools/eval_accuracy.py on its Offline accuracy log prints the
    run's own WER;
  - bare_machine: the same flow from a bare machine, STAGE=-1 QUICK=true
    with PLATFORM unset: stage -1 probes the card in a throwaway process
    (utils/backend.py), stage 0 fetches a seeded full-width rnnt.pt and
    stage 1 two seeded LibriSpeech-layout tarballs (dev-clean 32 FLAC
    utterances of 2-14 s, train-clean-100 16 of 2-8 s; md5-checked) from
    a loopback HTTP server (data/download.py), stage 2 converts them, stage
    3 calibrates on the listed train utterances with --model rnnt.pt
    (kernel C), stage 5 serves dev-clean.npz (kernels A and B); a second
    pass fetches nothing, the stores are bit-equal to the seeded 16-bit
    audio, and tools/eval_accuracy.py gives the run's WER;
  - bench_blank_cap1 / bench_burst_cap30: the port's bench (``python -m
    rnnt_inference_tpu_torch.bench``, a child process) at the JAX headline
    configuration (int8, packed, cap 1, calibrated blank rate 0.8) and at
    cap 30 with the calibrated burst model, BENCH_N and BENCH_MIN_S cut;
  - bench_twins: both bench configurations in this process at the bench
    run's shapes (its store, 1,024 lanes, the calibrated emission bias
    replayed) through the packed runner on the kernels, on the twins and
    on the twins summing in another order, then every kernel-B launch of
    a rep against its twin;
  - profile: the device's idle share over a timed rep from torch.profiler
    traces, of ``main --packed --benchmark --profiler_dir`` and of the
    bench's headline configuration at the bench phase's size.
Kernel B's packed mode is held against its twin over one launch of K
iterations at N = 16, 64, 128 (phase kernel_b_packed).  Token edit rates
kernels vs twins are held to 1e-3 (in bench_twins, to twice the rate at
which two plain versions that sum in another order part).  Launches are counted
per main call and per timed pass.  Each phase prints one JSON line; the
last line is {"ok": true, "device": {...}}.  Any failure
raises (exit code != 0); with no CUDA device it exits with code 2 before
printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor-core rate
PEAK_F32_FLOPS = 67e12  # f32 FMA on the CUDA cores (no tensor cores)


T_START = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since start."""
    if "phase" in obj:
        obj = dict(obj, elapsed_seconds=round(time.time() - T_START, 1))
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def int8_diff(a: torch.Tensor, b: torch.Tensor):
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d != 0).float().mean())


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    if np.array_equal(a, b):
        return 0
    prev = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        cur[1:] = np.minimum(prev[1:] + 1, sub)
        for j in range(1, len(b) + 1):  # insertions run left to right
            cur[j] = min(cur[j], cur[j - 1] + 1)
        prev = cur
    return int(prev[-1])


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit({"phase": "device", **dev})
    return dev


def kernel_ms(fn, name: str, reps: int) -> float:
    """Mean device milliseconds of the kernels whose name holds ``name`` over
    ``reps`` calls of fn, from torch.profiler's kernel records: for a kernel
    shorter than its host launch path, which back-to-back CUDA events would
    time instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if name in e.name
              and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if len(events) != reps:
        raise RuntimeError(f"{len(events)} {name} kernels recorded for {reps} calls")
    us = sum(getattr(e, "device_time", None) or e.cuda_time for e in events)
    return us / 1e3 / reps


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def phase_build() -> None:
    from rnnt_inference_tpu_torch.ops import (
        attention_cuda, cuda_build, decode_cuda, depthwise_cuda, features_cuda, lstm_cuda,
        lstm_scan_cuda, projection_cuda,
    )

    t0 = time.time()
    names = [lstm_cuda.NAME, decode_cuda.NAME, lstm_scan_cuda.NAME, features_cuda.NAME,
             projection_cuda.NAME, attention_cuda.NAME, depthwise_cuda.NAME]
    info = cuda_build.build(names)  # one nvcc per source, in parallel
    for name in names:
        cuda_build.load(name)
    ptxas = {
        n: [l.strip() for l in v["log"].splitlines() if "registers" in l or "spill" in l]
        for n, v in info.items()
    }
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas})


def single_stream_frames(params) -> tuple:
    """(T of the pre-net layers, T of the post-net layers) of the longest
    utterance of phase native's SingleStream run, padded to its waveform
    bucket as that run pads it."""
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    cfg = FeaturizerConfig()
    store = SampleStore.synthetic(n=NATIVE_N, seed=0).select(np.arange(NATIVE_SS))
    t_pre = cfg.out_frames(QuerySampleLibrary(store, cfg).wav_bucket_for(int(store.lengths.max())))
    return t_pre, -(-t_pre // params.stack_time_factor)


def phase_kernel_a(qweights, dev, ss_frames) -> dict:
    """Kernel A against its twin at H=1024 for the three layer shapes (IC =
    240, 1024, 2048), T=48 at N in {16 (the int8 runner's batch), 64, 128},
    T=16 (the packed runner's chunk) at N=1,024 (the bench's lanes), T=8
    (the post-net's chunk after the time reduction) at N=1,024 for the two
    post-net layers, at N=1 over a whole SingleStream utterance
    (``ss_frames``: the pre-net layer at its stacked frames, the post-net
    layers after the time reduction), and on either side of the hoisted
    path's least rows (IC=240: T=3, N=200; T=4, N=256), int8 and f32 y: y,
    h and c bit-equal on both paths (fused and hoisted; the one the shape
    rule picks through the wrapper: one launch counted per call, hoisted
    counted as the rule says).  Per row the time of each path, per call and
    per step, beside the bound; on the rows that hoist, the input GEMM alone
    (its sums against the twin's, bit for bit) beside its bound."""
    from rnnt_inference_tpu_torch.ops import lstm_cuda
    from rnnt_inference_tpu_torch.ops.lstm_int8 import quant_lstm_layer

    layers = (qweights.pre_rnn[0], qweights.post_rnn[1], qweights.post_rnn[0])
    g = torch.Generator().manual_seed(123)
    rows, entries = [], {}
    cases = [(N, T, layer) for N, T in ((16, 48), (64, 48), (128, 48), (1024, 16))
             for layer in layers]
    cases += [(1024, 8, layer) for layer in layers[1:]]
    cases += [(1, ss_frames[0] if layer is layers[0] else ss_frames[1], layer) for layer in layers]
    cases += [(200, 3, layers[0]), (256, 4, layers[0])]
    counted = lstm_cuda.quant_lstm_layer_cuda
    for N, T, layer in cases:
        IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
        x = torch.randint(-128, 128, (T, N, IC), generator=g, dtype=torch.int8).to(dev)
        h = torch.randint(-128, 128, (N, H), generator=g, dtype=torch.int8).to(dev)
        c = (torch.randn((N, H), generator=g) * 0.5).to(dev)
        hoist = lstm_cuda.hoists(T, N, IC)
        for emit_f32 in (False, True):
            before = (counted.launches, counted.hoisted)
            got = counted(layer, x, h, c, emit_f32)
            launches, hoisted = counted.launches - before[0], counted.hoisted - before[1]
            other, _ = lstm_cuda.layer_on_path(layer, x, h, c, emit_f32, not hoist)
            want = quant_lstm_layer(layer, x, h, c, emit_f32)
            torch.cuda.synchronize()
            row = {"IC": IC, "H": H, "N": N, "T": T, "emit_f32": emit_f32,
                   "path": "hoisted" if hoist else "fused", "launches_per_call": launches,
                   "hoisted_per_call": hoisted}
            for path, out in ((row["path"], got), ("fused" if hoist else "hoisted", other)):
                for name, a, b in zip(("y", "h", "c"), out, want):
                    d = (a.double() - b.double()).abs()
                    row[f"{path}_{name}_max_abs_diff"] = float(d.max())
                    row[f"{path}_{name}_share_diff"] = float((d != 0).double().mean())
            if launches != 1 or hoisted != int(hoist) or any(
                    row[f"{p}_{k}_max_abs_diff"] != 0 for p in ("fused", "hoisted")
                    for k in "yhc"):
                raise AssertionError(f"kernel A is not its twin bit for bit: {row}")
            ms = cuda_ms(lambda: counted(layer, x, h, c, emit_f32), 20)
            path_ms = {p: cuda_ms(lambda: lstm_cuda.layer_on_path(layer, x, h, c, emit_f32,
                                                                  p == "hoisted"), 20)
                       for p in ("fused", "hoisted")}
            plain_ms = cuda_ms(lambda: quant_lstm_layer(layer, x, h, c, emit_f32), 2, 1)
            y_es = 4 if emit_f32 else 1
            bytes_moved = ((IC + H) * 4 * H + T * N * IC + N * H * (1 + 4)
                           + T * N * H * y_es + N * H * (1 + 4))
            ops = 2 * T * N * (IC + H) * 4 * H
            bound_ms, bound_by = bound(bytes_moved, ops, PEAK_INT8_OPS)
            row.update(ms=ms, ms_per_step=ms / T, fused_ms=path_ms["fused"],
                       hoisted_ms=path_ms["hoisted"], plain_ms=plain_ms,
                       plain_ms_per_step=plain_ms / T, bound_ms=bound_ms, bound_by=bound_by)
            if hoist and not emit_f32:  # the input GEMM alone: x, W_ih and the s32 sums once
                xw = lstm_cuda.input_products_cuda(layer, x)
                if not torch.equal(xw, lstm_cuda.input_products(x, layer.w_ih)):
                    raise AssertionError(f"kernel A's input GEMM is not its twin: {row}")
                gemm_bound_ms, gemm_bound_by = bound(
                    T * N * IC + IC * 4 * H + T * N * 4 * H * 4, 2 * T * N * IC * 4 * H,
                    PEAK_INT8_OPS)
                row.update(gemm_ms=cuda_ms(lambda: lstm_cuda.input_products_cuda(layer, x), 20),
                           gemm_bound_ms=gemm_bound_ms, gemm_bound_by=gemm_bound_by)
            rows.append(row)
            if not emit_f32:
                entries[(N, IC)] = dict(row, x=x, h=h, layer=layer)
    emit({"phase": "kernel_a", "tolerance": "bit-equal on both paths: y, h, c (and f32 y) "
          "max |d| = 0; the input GEMM's s32 sums equal", "rows": rows})

    # the JSON line's entry: IC=2048 (the first post layer, the widest), N=64, T=48
    wide = max(layer.w_ih.shape[0] for layer in layers)
    e = entries[(64, wide)]
    layer, x, h = e["layer"], e["x"], e["h"]
    IC, H, N, T = e["IC"], e["H"], e["N"], e["T"]
    # yardstick: torch._int_mm of cat(x_t, h)·W_cat for all T steps in one
    # call (the layer's int8 GEMM work without its recurrence)
    K = IC + H
    KP = -(-K // 16) * 16
    w_t = torch.zeros((4 * H, KP), dtype=torch.int8, device=dev)
    w_t[:, :K] = torch.cat([layer.w_ih, layer.w_hh]).t()
    xh = torch.zeros((T * N, KP), dtype=torch.int8, device=dev)
    xh[:, :IC] = x.reshape(T * N, IC)
    xh[:, IC:K] = h.repeat(T, 1)
    library_ms = cuda_ms(lambda: torch._int_mm(xh, w_t.t()), 10)
    by_n = {n: entries[(n, wide)] for n in (1, 16, 64, 128, 1024)}
    return {
        "name": "quant_lstm_layer", "route": "cuda",
        "source": "rnnt_inference_tpu_torch/csrc/quant_lstm.cu",
        "replaces": "rnnt_inference_tpu/ops/lstm_pallas.py:187",
        "shape": f"IC={IC} H={H} N={N} T={T} int8 y, one call = 1 launch counted",
        "max_abs_err": max(r[f"{p}_{k}_max_abs_diff"] for r in rows
                           for p in ("fused", "hoisted") for k in "yhc"),
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": library_ms,
        "by_n": {n: {k: r[k] for k in ("T", "path", "ms", "ms_per_step", "fused_ms",
                                        "hoisted_ms", "plain_ms", "bound_ms", "bound_by")}
                 for n, r in by_n.items()},
        "hoist_rows": [lstm_cuda.HOIST_MIN_ROWS, lstm_cuda.HOIST_MAX_ROWS],
        "gemm": [{k: r[k] for k in ("T", "N", "IC", "gemm_ms", "gemm_bound_ms",
                                    "gemm_bound_by")} for r in rows if "gemm_ms" in r],
    }


def _decode_lanes(rng, N, T2, V, R, long=False):
    """Lane state (8, N): random mid-utterance states, or (long) every lane
    at frame 0 of a T2-frame utterance, so none can finish in < T2
    iterations."""
    if long:
        z = np.zeros(N, np.int64)
        return np.stack([z - 1, z, z, z - 1, z, z + T2, z + T2 - 1, z]).astype(np.int32)
    f_lens = rng.randint(0, T2 + 1, N)
    eos = np.maximum(f_lens - 1, 0)
    return np.stack([
        rng.randint(-1, V - 1, N), np.minimum(rng.randint(0, T2, N), eos),
        rng.choice([0, 1, 2, 29, 30], N), rng.randint(-1, R, N), f_lens == 0,
        f_lens, eos, np.zeros(N),
    ]).astype(np.int32)


def phase_kernel_b(weights, params, dev, phase: str) -> dict:
    """Kernel B against its twin at full width with the weights' type (bf16
    from the int8 model, or f32), N in {1 (SingleStream's one lane), 16, 64,
    128} lanes in random states:
    per step from the same state, and one launch of K iterations from a
    fresh state against K twin steps; then its time per iteration with one
    iteration per launch and with K per launch (lanes that cannot finish
    during the timing), its early exit, and the symbol loop's time by K."""
    from rnnt_inference_tpu_torch.models import decoder
    from rnnt_inference_tpu_torch.ops import decode_cuda as dc

    dw = dc.decode_weights(weights)
    wdt = dw.embed.dtype
    K = decoder.DEFAULT_STEPS_PER_CHECK
    T2, L, P, J, V, R = 40, params.pred_num_layers, params.pred_hidden_size, \
        params.joint_hidden_size, params.num_labels, params.max_res_len
    rng = np.random.RandomState(7)
    # Kernel and twin both sum in f32, in different orders.  So the states
    # they reach are held to: lanes, symbols and tokens equal; with bf16
    # weights hg within 2**-8, one bf16 step below 1 (|h| < 1), and cg
    # within 1e-3 (a layer-0 h that rounds to the other bf16 neighbour
    # moves the layer-1 gates by up to 2**-8 * max|W_ih| ~ 2e-4 for each
    # such element); with f32 weights, where nothing is rounded to bf16, hg
    # and cg within 1e-5.
    hg_tol, cg_tol, tol = (
        (2 ** -8, 1e-3, "hg <= 2**-8 (one bf16 step below 1), cg <= 1e-3")
        if wdt == torch.bfloat16 else (1e-5, 1e-5, "hg and cg <= 1e-5"))

    def compare(a, b, row, what):
        dh = (a[1].float() - b[1].float()).abs()
        got = {"lanes_and_symbols_equal": torch.equal(a[0], b[0]),
               "tokens_equal": torch.equal(a[3], b[3]), "hg_max_abs_diff": float(dh.max()),
               "hg_share_diff": float((dh != 0).float().mean()),
               "cg_max_abs_diff": float((a[2] - b[2]).abs().max())}
        for k, v in got.items():
            key = f"{what}_{k}"
            row[key] = (row.get(key, True) and v) if isinstance(v, bool) else max(row.get(key, 0.0), v)
        if not (got["lanes_and_symbols_equal"] and got["tokens_equal"]
                and got["hg_max_abs_diff"] <= hg_tol and got["cg_max_abs_diff"] <= cg_tol):
            raise AssertionError(f"kernel B off ({what}, N={row['N']}): {got}")

    rows = []
    # the one-lane row draws from a generator of its own: the other rows'
    # states do not depend on it
    for N, r in ((1, np.random.RandomState(1)), (16, rng), (64, rng), (128, rng)):
        fproj = torch.from_numpy(r.randn(T2, N, J).astype(np.float32)).to(dev)
        lanes0 = _decode_lanes(r, N, T2, V, R)
        hg0 = torch.from_numpy(r.randn(L, N, P).astype(np.float32) * 0.5).to(dev, wdt)
        cg0 = torch.from_numpy(r.randn(L, N, P).astype(np.float32) * 0.5).to(dev)
        res0 = torch.full((N, R), -1, dtype=torch.int8, device=dev)
        fresh = lambda: [torch.from_numpy(lanes0).to(dev), hg0.clone(), cg0.clone(), res0.clone()]
        row = {"N": N, "weights": str(wdt), "K": K}
        b = fresh()
        for _ in range(8):  # per step from the twin's state
            a = [t.clone() for t in b]
            dc.decode_step_cuda(fproj, *a, dw, params)
            dc.decode_step_reference(fproj, *b, dw, params)
            compare(a, b, row, "step")
        a, b = fresh(), fresh()  # one launch of K iterations against K twin steps
        dc.decode_step_cuda(fproj, *a, dw, params, K)
        for _ in range(K):
            dc.decode_step_reference(fproj, *b, dw, params)
        compare(a, b, row, "k_launch")
        row["emitted"] = int((b[0][dc.SYMBOL] != params.BLANK).sum())

        # timing on lanes that cannot finish within the timed iterations
        TL = 1024
        fl = torch.from_numpy(r.randn(TL, N, J).astype(np.float32)).to(dev)
        lanes_l = torch.from_numpy(_decode_lanes(r, N, TL, V, R, long=True)).to(dev)
        st = [lanes_l, hg0.clone(), cg0.clone(), res0.clone()]
        ms1 = cuda_ms(lambda: dc.decode_step_cuda(fl, *st, dw, params, 1), 100, 5)
        st = [lanes_l.clone(), hg0.clone(), cg0.clone(), res0.clone()]
        reps = max(1, TL // K - 2)  # (reps + 1) K < TL iterations in all
        msk = cuda_ms(lambda: dc.decode_step_cuda(fl, *st, dw, params, K), reps, 1) / K
        if bool(st[0][dc.FINISH].any()) or (reps + 1) * K >= TL:
            raise AssertionError("kernel B timing: a lane finished, so iterations were skipped")
        st = [lanes_l.clone(), hg0.clone(), cg0.clone(), res0.clone()]
        plain_ms = cuda_ms(lambda: dc.decode_step_reference(fl, *st, dw, params), 20, 2)
        row.update(ms_per_iteration_one_per_launch=ms1, ms_per_iteration_k_per_launch=msk,
                   plain_ms_per_step=plain_ms)
        rows.append(row)
    by_n = {r["N"]: r for r in rows}

    # early exit: every lane at its last frame (f_lens 1) finishes within
    # max_symbols_per_step + 1 iterations; a launch asked for 4096 must end
    # then, so it takes about as long as that many, not 4096
    N = 64
    fproj = torch.from_numpy(rng.randn(T2, N, J).astype(np.float32)).to(dev)
    lanes_e = _decode_lanes(rng, N, 1, V, R, long=True)
    hg0 = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev, wdt)
    cg0 = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev)
    res0 = torch.full((N, R), -1, dtype=torch.int8, device=dev)
    fresh = lambda: [torch.from_numpy(lanes_e).to(dev), hg0.clone(), cg0.clone(), res0.clone()]
    cap = params.max_symbols_per_step + 1
    a, b = fresh(), fresh()
    dc.decode_step_cuda(fproj, *a, dw, params, 4096)
    for _ in range(cap):
        dc.decode_step_reference(fproj, *b, dw, params)
    compare(a, b, {"N": N}, "early_exit")
    if not bool(a[0][dc.FINISH].all()):
        raise AssertionError("kernel B early exit: a lane did not finish")
    ms_4096 = cuda_ms(lambda: dc.decode_step_cuda(fproj, *fresh(), dw, params, 4096), 10, 1)
    ms_cap = cuda_ms(lambda: dc.decode_step_cuda(fproj, *fresh(), dw, params, cap), 10, 1)
    if not ms_4096 < 2 * ms_cap:
        raise AssertionError(f"kernel B did not leave early: {ms_4096} ms vs {ms_cap} ms")
    early = {"N": N, "iterations_needed_at_most": cap, "ms_asked_4096": ms_4096,
             f"ms_asked_{cap}": ms_cap}

    # the symbol loop (greedy_decode_chunk: host loop of launches of K
    # iterations, one finish.all() read per launch) by K, N=64, 40 frames
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode_chunk, init_decode_state

    N = 64
    f = torch.from_numpy(rng.randn(T2, N, 1024).astype(np.float32)).to(dev)
    f_lens = torch.full((N,), T2, dtype=torch.int32, device=dev)
    max_iters = T2 * (params.max_symbols_per_step + 1) + 1
    loop = {}
    for k in (1, 16, 64, 256, max_iters):
        state = init_decode_state(N, params, torch.float32, wdt, dev)
        greedy_decode_chunk(weights, state, f, f_lens, params, steps_per_check=k, dw=dw)
        torch.cuda.synchronize()
        dc.decode_step_cuda.launches = 0
        t0 = time.perf_counter()
        out = greedy_decode_chunk(weights, state, f, f_lens, params, steps_per_check=k, dw=dw)
        torch.cuda.synchronize()
        loop[str(k)] = {"ms": (time.perf_counter() - t0) * 1e3,
                        "launches": dc.decode_step_cuda.launches,
                        "tokens": int((out.res_idx + 1).clamp(max=R).sum())}
    emit({"phase": phase, "tolerance": "per step from the same state, and one launch of K "
          f"iterations against K twin steps: lanes/symbols/tokens equal, {tol}",
          "rows": rows, "early_exit": early,
          "symbol_loop_by_k": {"N": N, "frames": T2, "max_iters": max_iters, "by_k": loop}})

    # the bound of one launch of K iterations, per iteration: the weights
    # and the state (lanes, hg, cg) are read and written once per launch,
    # each iteration reads one fproj row per lane and writes one token; the
    # bound of one iteration per launch beside it (the weights every time)
    wsize = dw.embed.element_size()
    wbytes = sum(t.numel() * t.element_size() for t in (
        dw.embed, dw.w_ih, dw.w_hh, dw.b, dw.w1p, dw.b1, dw.w2, dw.b2))
    N = 64
    state_bytes = N * (8 * 4 + L * P * (wsize + 4))  # lanes, hg, cg
    per_iter_bytes = N * J * 4 + N  # one fproj row in, one token out
    flops = 2 * N * (L * 2 * P * 4 * P + P * J + J * V)
    peak = PEAK_BF16_FLOPS if wdt == torch.bfloat16 else PEAK_F32_FLOPS
    bound_ms, bound_by = bound((wbytes + 2 * state_bytes) / K + per_iter_bytes, flops, peak)
    bound1_ms, bound1_by = bound(wbytes + 2 * state_bytes + per_iter_bytes, flops, peak)
    r = by_n[64]
    return {
        "name": "decode_step", "route": "cuda",
        "source": "rnnt_inference_tpu_torch/csrc/decode_step.cu",
        "replaces": "rnnt_inference_tpu/ops/decode_pallas.py:112",
        "shape": f"N=64 P={P} J={J} L={L} {wdt} weights; ms, plain_ms and bound_ms per "
                 f"iteration, one launch = up to K={K} iterations (weights read once "
                 "per launch)",
        "max_abs_err": max(max(x["step_hg_max_abs_diff"], x["step_cg_max_abs_diff"],
                               x["k_launch_hg_max_abs_diff"], x["k_launch_cg_max_abs_diff"])
                           for x in rows),
        "ms": r["ms_per_iteration_k_per_launch"],
        "ms_one_iteration_per_launch": r["ms_per_iteration_one_per_launch"],
        "ms_by_n": {n: {"k_per_launch": x["ms_per_iteration_k_per_launch"],
                        "one_per_launch": x["ms_per_iteration_one_per_launch"]}
                    for n, x in by_n.items()},
        "plain_ms": r["plain_ms_per_step"], "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_one_iteration_per_launch": bound1_ms,
        "bound_by_one_iteration_per_launch": bound1_by, "library_ms": None,
    }


def phase_kernel_b_packed(weights, params, dev) -> dict:
    """Kernel B's packed mode against its twin at full width (bf16, the int8
    model's prediction net and joint), N in {16, 64, 128} lanes on packed
    timelines (utterance starts on a third of the frames, a budget of 8
    tokens per utterance): 8 single steps from the twin's state, then one
    launch of K iterations from a fresh state against K twin steps, which
    must include lanes that enter an utterance, lanes the budget holds back
    and lanes that finish.  Then its time per iteration at K per launch on
    lanes that cannot finish, beside the bucketed mode's on the same
    state."""
    from rnnt_inference_tpu_torch.models import decoder
    from rnnt_inference_tpu_torch.ops import decode_cuda as dc

    dw = dc.decode_weights(weights)
    K = decoder.DEFAULT_STEPS_PER_CHECK
    T2, L, P, J, V, R = 40, params.pred_num_layers, params.pred_hidden_size, \
        params.joint_hidden_size, params.num_labels, params.max_res_len
    budget = 8
    rng = np.random.RandomState(17)

    def check(a, b, row, what):
        dh = float((a[1].float() - b[1].float()).abs().max())
        dcg = float((a[2] - b[2]).abs().max())
        same = (torch.equal(a[0], b[0]) and torch.equal(a[3], b[3]) and torch.equal(a[4], b[4]))
        row[f"{what}_lanes_res_rb_equal"] = row.get(f"{what}_lanes_res_rb_equal", True) and same
        row[f"{what}_hg_max_abs_diff"] = max(row.get(f"{what}_hg_max_abs_diff", 0.0), dh)
        row[f"{what}_cg_max_abs_diff"] = max(row.get(f"{what}_cg_max_abs_diff", 0.0), dcg)
        if not (same and dh <= 2 ** -8 and dcg <= 1e-3):
            raise AssertionError(f"kernel B packed off ({what}, N={row['N']}): equal {same}, "
                                 f"hg {dh}, cg {dcg}")

    def launch(st, steps, fp, starts):
        dc.decode_step_cuda(fp, *st[:4], dw, params, steps, starts, st[4], budget)

    def twin(st, fp, starts):
        dc.decode_step_reference(fp, *st[:4], dw, params, starts, st[4], budget)

    rows = []
    for N in (16, 64, 128):
        fproj = torch.from_numpy(rng.randn(T2, N, J).astype(np.float32)).to(dev)
        lanes0 = _decode_lanes(rng, N, T2, V, R)
        starts_np = rng.rand(T2, N) < 0.35
        starts_np[0] = True
        starts = torch.from_numpy(starts_np).to(dev)
        rb0 = np.maximum(lanes0[3] - rng.randint(0, 12, N), -1).astype(np.int32)
        hg0 = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev, torch.bfloat16)
        cg0 = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev)
        fresh = lambda: [torch.from_numpy(lanes0.copy()).to(dev), hg0.clone(), cg0.clone(),
                         torch.full((N, R), -1, dtype=torch.int8, device=dev),
                         torch.from_numpy(rb0.copy()).to(dev)]
        row = {"N": N, "K": K, "budget": budget}
        b = fresh()
        for _ in range(8):  # per step from the twin's state
            a = [t.clone() for t in b]
            launch(a, 1, fproj, starts)
            twin(b, fproj, starts)
            check(a, b, row, "step")
        a, b = fresh(), fresh()  # one launch of K iterations against K twin steps
        launch(a, K, fproj, starts)
        entered = held = finished_at = 0
        for i in range(K):
            ri, fin = b[0][dc.RES_IDX].clone(), b[0][dc.FINISH].clone()
            sad, rb = b[0][dc.SYMADD].clone(), b[4].clone()
            twin(b, fproj, starts)
            upd = (b[0][dc.SYMBOL] != params.BLANK) & (sad != params.max_symbols_per_step) & (fin == 0)
            entered += int((b[4] != rb).sum())  # rb moves only where a lane enters
            held += int((upd & (b[0][dc.RES_IDX] == ri)).sum())
            if i < K - 1:
                finished_at += int(((b[0][dc.FINISH] != 0) & (fin == 0)).sum())
        check(a, b, row, "k_launch")
        row.update(entered_in_launch=entered, emissions_held_by_budget=held,
                   lanes_finished_mid_launch=finished_at)
        if not (entered and held and finished_at):
            raise AssertionError(f"kernel B packed check misses a case: {row}")

        # timing on lanes that cannot finish: 1,024 frames, an utterance
        # start every 8 frames, bucketed and packed on the same state
        TL = 1024
        fl = torch.from_numpy(rng.randn(TL, N, J).astype(np.float32)).to(dev)
        starts_l = torch.zeros((TL, N), dtype=torch.bool, device=dev)
        starts_l[::8] = True
        lanes_l = torch.from_numpy(_decode_lanes(rng, N, TL, V, R, long=True)).to(dev)
        reps = max(1, TL // K - 2)
        timed = {}
        for mode in ("bucketed", "packed"):
            st = [lanes_l.clone(), hg0.clone(), cg0.clone(),
                  torch.full((N, R), -1, dtype=torch.int8, device=dev),
                  torch.full((N,), -1, dtype=torch.int32, device=dev)]
            sl = starts_l if mode == "packed" else None
            run = ((lambda: launch(st, K, fl, sl)) if mode == "packed"
                   else (lambda: dc.decode_step_cuda(fl, *st[:4], dw, params, K)))
            timed[mode] = cuda_ms(run, reps, 1) / K
            if bool(st[0][dc.FINISH].any()):
                raise AssertionError("kernel B packed timing: a lane finished")
            if mode == "packed":
                row["markers_in_timing"] = int((st[3] == dc.PACK_BOUNDARY).sum())
        st = [lanes_l.clone(), hg0.clone(), cg0.clone(),
              torch.full((N, R), -1, dtype=torch.int8, device=dev),
              torch.full((N,), -1, dtype=torch.int32, device=dev)]
        row.update(ms_per_iteration_packed=timed["packed"],
                   ms_per_iteration_bucketed=timed["bucketed"],
                   plain_ms_per_step_packed=cuda_ms(lambda: twin(st, fl, starts_l), 20, 2))
        rows.append(row)
    emit({"phase": "kernel_b_packed", "tolerance": "8 steps from the twin's state and one "
          f"launch of K={K} iterations against K twin steps: lanes, res and res_base equal, "
          "hg <= 2**-8, cg <= 1e-3", "rows": rows})
    return {r["N"]: r for r in rows}


def phase_kernel_c(weights, dev) -> dict:
    """Kernel C against its twin at H=1024 (the middle encoder layer's
    shape, IC=1024), N in {16, 128} at T=48 and the packed runner's
    N=1,024 at T=16, bf16 and f32 weights, both on one xw: the layer's own
    projection (kernel E in bf16, which phase projection holds to its
    twin); the cluster size plan chose and the timed calls' launches by
    cluster size; cuDNN's LSTM layer of the same shape and type as the
    yardstick."""
    from rnnt_inference_tpu_torch.models.weights import map_tensors
    from rnnt_inference_tpu_torch.ops import cuda_build
    from rnnt_inference_tpu_torch.ops import lstm as tl
    from rnnt_inference_tpu_torch.ops import lstm_scan_cuda, projection_cuda

    g = torch.Generator().manual_seed(321)
    rows, entries = [], {}
    for dt in (torch.bfloat16, torch.float32):
        layer = map_tensors(weights.post_rnn[1], lambda t: t.to(dt))
        IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
        # y/h: one bf16 step below 1 (an h that rounds to the other bf16
        # neighbour), c: 1e-3; f32: summation order only, 1e-5
        tol_h, tol_c = (2 ** -8, 1e-3) if dt == torch.bfloat16 else (1e-5, 1e-5)
        for N, T in ((16, 48), (128, 48), (1024, 16)):
            x = torch.randn((T, N, IC), generator=g).to(dev)
            h0 = (torch.randn((N, H), generator=g) * 0.5).to(dev)
            c0 = (torch.randn((N, H), generator=g) * 0.5).to(dev)
            xw = projection_cuda.project(x.to(dt), layer.w_ih, layer.b)
            hc, cc = h0.to(dt), c0
            got = lstm_scan_cuda.lstm_recurrence_cuda(layer, xw, hc, cc)
            want = tl.lstm_recurrence(xw, layer.w_hh, hc, cc)
            torch.cuda.synchronize()
            row = {"dtype": str(dt), "IC": IC, "H": H, "N": N, "T": T}
            for name, a, b, tol in zip(("y", "h", "c"), got, want, (tol_h, tol_h, tol_c)):
                d = (a.float() - b.float()).abs()
                row[f"{name}_max_abs_diff"] = float(d.max())
                row[f"{name}_share_diff"] = float((d != 0).float().mean())
                if not row[f"{name}_max_abs_diff"] <= tol:
                    raise AssertionError(f"kernel C {name} off: {row}")
            # the kernel alone (recurrence over T steps) against its twin,
            # and the whole layer (projection + kernel) against cuDNN's
            # LSTM layer
            before = lstm_scan_cuda.lstm_recurrence_cuda.launches
            lstm_scan_cuda.lstm_recurrence_cuda(layer, xw, hc, cc)
            launches_per_call = lstm_scan_cuda.lstm_recurrence_cuda.launches - before
            cluster_size = lstm_scan_cuda.plan(
                H, N, dt, cuda_build.sm_count(dev),
                lambda c: lstm_scan_cuda.max_clusters(dev, c, N, H))[2]
            by_size = dict(lstm_scan_cuda.CLUSTER_LAUNCHES)
            ms = cuda_ms(lambda: lstm_scan_cuda.lstm_recurrence_cuda(layer, xw, hc, cc), 10)
            cluster_launches = {k: v - by_size.get(k, 0)
                                for k, v in lstm_scan_cuda.CLUSTER_LAUNCHES.items()
                                if v != by_size.get(k, 0)}
            plain_ms = cuda_ms(lambda: tl.lstm_recurrence(xw, layer.w_hh, hc, cc), 3, 1)
            layer_ms = cuda_ms(lambda: tl.lstm_layer(layer, x, h0, c0), 10)
            cudnn = torch.nn.LSTM(IC, H).to(dev, dt)
            cudnn.flatten_parameters()
            xl, hl, cl = x.to(dt), h0.to(dt)[None], c0.to(dt)[None]
            with torch.no_grad():
                library_ms = cuda_ms(lambda: cudnn(xl, (hl, cl)), 10)
            es = layer.w_hh.element_size()
            bytes_moved = (T * N * 4 * H * es + H * 4 * H * es + N * H * (es + 4)
                           + T * N * H * es + N * H * (es + 4))
            ops = 2 * T * N * H * 4 * H
            bound_ms, bound_by = bound(
                bytes_moved, ops, PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS)
            row.update(ms=ms, ms_per_step=ms / T, launches_per_call=launches_per_call,
                       cluster_size=cluster_size, cluster_launches=cluster_launches,
                       plain_ms=plain_ms, layer_ms=layer_ms, projection_ms=layer_ms - ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            entries[(dt, N)] = row
    emit({"phase": "kernel_c", "tolerance": "bf16: y/h <= 2**-8, c <= 1e-3; f32: y/h/c <= 1e-5",
          "library": "torch.nn.LSTM (cuDNN) layer, same shape and type, TF32 off; compare "
                     "with layer_ms (projection + kernel C); projection_ms = layer_ms - ms",
          "rows": rows})
    e = entries[(torch.bfloat16, 128)]
    return {
        "name": "lstm_recurrence", "route": "cuda",
        "source": "rnnt_inference_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "rnnt_inference_tpu/ops/lstm_pallas.py:41",
        "shape": f"IC={e['IC']} H={e['H']} N=128 T={e['T']} bf16, one call = "
                 f"{e['launches_per_call']} launch; library_ms is cuDNN's whole layer "
                 "(compare layer_ms)",
        "max_abs_err": max(max(r["y_max_abs_diff"], r["h_max_abs_diff"], r["c_max_abs_diff"])
                           for r in rows),
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": e["library_ms"], "layer_ms": e["layer_ms"],
        "projection_ms": e["projection_ms"],
        "f32": {k: entries[(torch.float32, 128)][k]
                for k in ("ms", "plain_ms", "layer_ms", "projection_ms", "library_ms",
                          "bound_ms", "bound_by")},
        "n16": {str(d): {k: entries[(d, 16)][k] for k in ("ms", "layer_ms", "library_ms")}
                for d in (torch.bfloat16, torch.float32)},
        "n1024_t16": {str(d): {k: entries[(d, 1024)][k]
                               for k in ("ms", "ms_per_step", "bound_ms", "cluster_size",
                                         "cluster_launches", "layer_ms", "library_ms")}
                      for d in (torch.bfloat16, torch.float32)},
    }


def phase_projection(weights, dev) -> dict:
    """Kernel E (ops/projection_cuda.py) against its plain twin on the
    model's bf16 weights at the main path's shapes: the packed runner's
    pre-net layers (M = 16 frames x 1,024 lanes, K = 240 and 1,024), its
    post-net layers (M = 8,192 after stack_time, K = 2,048 and 1,024), ragged
    M, the joint's fproj (N = 512, f32 out), the decode set-up's eproj (M =
    28, K = 320, N = 1,280) and an odd N (W2, N = 29); M = 0 launches
    nothing.  Tolerance: the kernel and the twin sum the same exact
    products in f32 in another order, so the f32 epilogue lies within
    2 K eps sum|a||b| of the twin, and the bf16 one, after its one
    rounding, within that plus one bf16 ulp of the larger of the two.  Each
    shape is timed beside its bound, the twin and the library's
    bf16-in, f32-out product (torch.mm(..., out_dtype=torch.float32))."""
    from rnnt_inference_tpu_torch.ops import projection_cuda as pc

    bf = lambda t: t.to(torch.bfloat16)
    pre, post, jw = weights.pre_rnn, weights.post_rnn, weights.joint
    cases = [  # name, M, w, b
        ("pre_layer0", 16384, pre[0].w_ih, pre[0].b),
        ("pre_layer1", 16384, pre[1].w_ih, pre[1].b),
        ("post_layer0", 8192, post[0].w_ih, post[0].b),
        ("post_layer1", 8192, post[1].w_ih, post[1].b),
        ("ragged_post_layer0", 8192 - 77, post[0].w_ih, post[0].b),
        ("ragged_pre_layer0", 1000, pre[0].w_ih, pre[0].b),
        ("fproj", 8192, jw.w1_trans, None),
        ("eproj", weights.embed.shape[0], weights.pred_rnn[0].w_ih, None),
        ("odd_n", 64, jw.w2, None),
    ]
    g = torch.Generator().manual_seed(18)
    rows, eps = {}, torch.finfo(torch.float32).eps
    for name, M, w, b in cases:
        w, b = bf(w).contiguous(), None if b is None else bf(b)
        K, N = w.shape
        x = bf(torch.randn((M, K), generator=g)).to(dev)
        before = pc.project_cuda.launches
        got = pc.project_cuda(x, w, b)
        launches = pc.project_cuda.launches - before
        want = pc.project_reference(x, w, b)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape or launches != 1:
            raise AssertionError(f"kernel E {name}: {got.dtype} {tuple(got.shape)}, want "
                                 f"{want.dtype} {tuple(want.shape)}; {launches} launches")
        tol = 2 * K * eps * (x.float().abs() @ w.float().abs())
        if b is not None:
            big = torch.maximum(got.float().abs(), want.float().abs())
            tol = tol + torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
        d = (got.float() - want.float()).abs()
        ratio = float((d / tol).max())
        if not ratio <= 1.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"kernel E {name} off: max |d| {float(d.max())}, "
                                 f"{ratio} of its tolerance")
        ms = cuda_ms(lambda: pc.project_cuda(x, w, b), 20)
        plain_ms = cuda_ms(lambda: pc.project_reference(x, w, b), 5, 1)
        try:
            library_ms = cuda_ms(lambda: torch.mm(x, w, out_dtype=torch.float32), 20)
        except (TypeError, RuntimeError) as e:  # a torch without mm's out_dtype
            library_ms = f"not available: {e}"
        out_bytes = 2 if b is not None else 4
        nbytes = (M * K + K * N) * 2 + M * N * out_bytes + (0 if b is None else N * 4)
        bound_ms, bound_by = bound(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)
        rows[name] = {
            "M": M, "K": K, "N": N, "epilogue": "b: f32" if b is None else "a: bf16 + bias",
            "launches_per_call": launches, "max_abs_err": float(d.max()),
            "share_differing": float((d != 0).float().mean()), "max_err_over_tolerance": ratio,
            "ms": ms, "tflops": 2 * M * N * K / ms / 1e9, "bound_ms": bound_ms,
            "bound_by": bound_by, "plain_ms": plain_ms, "library_ms": library_ms}
    w = bf(post[0].w_ih)
    before = pc.project_cuda.launches
    empty = pc.project_cuda(torch.empty((0, w.shape[0]), dtype=torch.bfloat16, device=dev), w)
    if empty.shape != (0, w.shape[1]) or pc.project_cuda.launches != before:
        raise AssertionError("kernel E: M = 0 must return (0, N) without a launch")
    emit({"phase": "projection",
          "tolerance": "f32 out: 2 K eps sum|a||b| (summation order); bf16 out: that plus one "
                       "bf16 ulp (the one rounding after another order)",
          "library": "torch.mm(a, b, out_dtype=torch.float32) (aten::mm.dtype), bf16 in",
          "rows": rows})
    e = rows["post_layer0"]
    return {
        "name": "projection", "route": "cuda",
        "source": "rnnt_inference_tpu_torch/csrc/projection.cu",
        "replaces": "none: rnnt_inference_tpu/ops/lstm.py:64 jnp.dot(..., "
                    "preferred_element_type=jnp.float32), left to XLA",
        "shape": f"M={e['M']} K={e['K']} N={e['N']} bf16, bias, bf16 out (post-net layer 0 of "
                 "a packed chunk); one call = 1 launch",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "max_err_over_tolerance": max(r["max_err_over_tolerance"] for r in rows.values()),
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": e["library_ms"],
        "by_shape": {k: {q: r[q] for q in ("ms", "bound_ms", "plain_ms", "library_ms")}
                     for k, r in rows.items()},
    }


def phase_conformer_kernels(dev, seed: int) -> dict:
    """The Conformer-Transducer's kernels (tests/test_torch_conformer_cuda.py
    holds them to their twins too), each against its plain twin, timed
    beside its bound at the benchmark cell's shapes (conformer.offline.speech:
    8,192 utterances drawn by its law, 1.7 M varlen rows):
      F  relative-position attention (csrc/rel_attention.cu), 8 heads of
         64: the whole rep's one launch timed; held to the twin on its
         first 96 utterances element by element: one bf16 ulp of the
         twin's output (2^-7 |out|, both round it) plus the rounding of
         the probabilities to bf16 (2^-9 of each term of sum_j p |v_j|,
         doubled: 2^-8 of the twin run on |v|) plus 1e-6; the twin timed
         there;
      G  depthwise convolution + bias + Swish (csrc/depthwise.cu), 512
         channels, 31 taps, over the whole rep: one bf16 ulp of the twin;
         beside the library's depthwise Conv1d on the transposed rows (the
         path G replaced);
      B  kernel B's wide-vocabulary instantiation (one layer, P = J = 640,
         V = 1,025, bf16, int16 tokens) at 1,024 lanes: one iteration and
         one launch of K = 64 against the twin
         (tools/decode_divergence.py compare_k_launch: parting only at
         ties, decode_divergence.wide_parting_explained), ms per iteration
         at K = 64 per launch, its bound from the work an iteration needs
         (h W_hh, g W1p and z W2 a lane; x W_ih is the eproj table's row,
         read once a launch with the weights)."""
    from rnnt_inference_tpu_torch.config import ConformerParams
    from rnnt_inference_tpu_torch.models import conformer
    from rnnt_inference_tpu_torch.ops import attention_cuda as ac
    from rnnt_inference_tpu_torch.ops import decode_cuda as dc
    from rnnt_inference_tpu_torch.ops import depthwise_cuda as dg
    from rnnt_inference_tpu_torch.tools.decode_divergence import (compare_k_launch,
                                                                   wide_parting_explained)

    spec = json.load(open("benchmark/traffic/offline_speech_cap10.json"))["duration"]
    rng = np.random.RandomState(spec["sizes_seed"])
    secs = np.clip(rng.gamma(spec["shape"], spec["mean_s"] / spec["shape"], 8192),
                   spec["min_s"], spec["max_s"])
    params = ConformerParams()
    lens = np.array([params.encoded_len(int(s * 16000) // 160 + 1) for s in secs])
    starts, R = conformer.varlen_layout(lens)
    segs = ac.Segments.of(starts, lens, dev)
    gaps = conformer.gap_mask(starts, lens, R, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    H, d, D = 8, 64, 512
    qkv = torch.randn((R, 3 * D), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :]
    u, vb = (0.1 * torch.randn((2, H, d), generator=g, device=dev)).unbind(0)
    pos = torch.randn((2 * segs.t_max - 1, D), generator=g, device=dev).to(torch.bfloat16)
    rows = {}

    # F: one launch over the rep; the twin on a slice of it
    f_ms = cuda_ms(lambda: ac.rel_attention_cuda(q, k, v, u, vb, pos, segs), 5)
    n = 96
    sub = ac.Segments.of(starts[:n], lens[:n], dev)
    sub.t_max = segs.t_max  # the band stays the rep's
    got = ac.rel_attention(q, k, v, u, vb, pos, sub)[: int(starts[n - 1] + lens[n - 1])]
    want = ac.rel_attention(q, k, v, u, vb, pos, sub, impl="reference")[: got.shape[0]]
    absv = ac.rel_attention(q, k, v.abs(), u, vb, pos, sub, impl="reference")[: got.shape[0]]
    diff = (got.float() - want.float()).abs()
    over = diff - (2 ** -7 * want.float().abs() + 2 ** -8 * absv.float() + 1e-6)
    err = float(diff.max())
    if not float(over.max()) <= 0:
        raise AssertionError(f"kernel F off: max |d| {err}, over its bound by "
                             f"{float(over.max())}")
    plain_ms = cuda_ms(lambda: ac.rel_attention_reference(q, k, v, u, vb, pos, sub), 1, 1)
    ops = 6.0 * float((lens.astype(np.float64) ** 2).sum()) * d * H
    nbytes = 2.0 * H * d * (4 * lens.sum() + 2 * segs.t_max - 1)
    bound_ms, bound_by = bound(nbytes, ops, PEAK_BF16_FLOPS)
    rows["F"] = {
        "name": "rel_attention", "route": "cuda", "source": "rnnt_inference_tpu_torch/csrc/"
        "rel_attention.cu", "replaces": "none: the JAX package has no attention",
        "shape": f"{len(lens)} utterances of 1-{segs.t_max} encoder frames ({R} varlen rows), "
                 f"{H} heads of {d}; one call = 1 launch",
        "ms": f_ms, "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / f_ms,
        "plain_ms": plain_ms, "plain_on": f"the first {n} utterances", "max_abs_err": err,
        "max_abs_out": float(want.float().abs().max()),
        "library_ms": "none: no single PyTorch call computes relative-position attention over "
                      "varlen segments without the T x T scores"}

    # G: the whole rep's rows, against the twin and the library's path
    x = torch.randn((R, D), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((31, D), generator=g, device=dev) / 5).to(torch.bfloat16)
    bias = torch.randn(D, generator=g, device=dev)
    got = dg.depthwise_silu(x, gaps, w, bias)
    want = dg.depthwise_silu(x, gaps, w, bias, impl="reference")
    own = ~gaps
    diff = (got.float() - want.float()).abs()[own]
    if float((diff - want.float().abs()[own] * 2 ** -7).max()) > 1e-6:
        raise AssertionError(f"kernel G off: max |d| {float(diff.max())}")
    g_ms = cuda_ms(lambda: dg.depthwise_silu_cuda(x, gaps, w, bias), 5)
    plain_ms = cuda_ms(lambda: dg.depthwise_silu_reference(x, gaps, w, bias), 2, 1)
    lib = lambda: torch.nn.functional.conv1d(x.t()[None], w.t()[:, None, :], bias.to(x.dtype),
                                             padding=15, groups=D)[0].t().contiguous()
    library_ms = cuda_ms(lib, 3, 1)
    bound_ms, bound_by = bound(4.0 * R * D + R, 2.0 * 31 * R * D, PEAK_F32_FLOPS)
    rows["G"] = {
        "name": "depthwise_silu", "route": "cuda", "source": "rnnt_inference_tpu_torch/csrc/"
        "depthwise.cu", "replaces": "none: the JAX package has no convolution module",
        "shape": f"{R} rows x {D} channels, 31 taps, gap rows read as zero; one call = 1 launch",
        "ms": g_ms, "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / g_ms,
        "plain_ms": plain_ms, "max_abs_err": float(diff.max()),
        "library_ms": library_ms, "library": "F.conv1d depthwise on the rows transposed, "
                                             "transposed back (Swish not included)"}

    # B wide: 1,024 lanes at P = J = 640, V = 1,025
    P = J = 640
    V, N, R2, T2 = 1025, 1024, 128, 6
    cg_ = torch.Generator().manual_seed(seed + 5)
    uni = lambda *shape, s: (torch.rand(shape, generator=cg_) * 2 - 1) * s
    bf = lambda t: t.to(dev, torch.bfloat16).contiguous()
    dw = dc.DecodeWeights(embed=bf(torch.randn((V - 1, P), generator=cg_)),
                          w_ih=bf(uni(1, P, 4 * P, s=P ** -0.5)),
                          w_hh=bf(uni(1, P, 4 * P, s=P ** -0.5)),
                          b=uni(1, 4 * P, s=P ** -0.5).to(dev),
                          w1p=bf(uni(P, J, s=(2 * P) ** -0.5)), b1=uni(J, s=0.05).to(dev),
                          w2=bf(uni(J, V, s=J ** -0.5)), b2=uni(V, s=J ** -0.5).to(dev))
    bp = ConformerParams(max_res_len=R2, max_symbols_per_step=10)
    lr = np.random.RandomState(seed)
    f_lens = np.full(N, T2)
    lanes = np.stack([lr.randint(-1, V - 1, N), lr.randint(0, T2, N), np.zeros(N),
                      lr.choice([-1, 5], N), np.zeros(N), f_lens, f_lens - 1,
                      np.zeros(N)]).astype(np.int32)
    state = [torch.from_numpy(lanes).to(dev),
             torch.from_numpy(lr.randn(1, N, P).astype(np.float32) * 0.5).to(dev, torch.bfloat16),
             torch.from_numpy(lr.randn(1, N, P).astype(np.float32) * 0.5).to(dev),
             torch.full((N, R2), -1, dtype=torch.int16, device=dev)]
    fproj = torch.from_numpy(lr.randn(T2, N, J).astype(np.float32)).to(dev)
    rep = compare_k_launch(fproj, state, dw, bp, 64)
    faults = [lane for lane in rep["lanes"] if not wide_parting_explained(lane)]
    if not (rep["deterministic"] and rep["end_drift_within_tolerance"]) or faults:
        raise AssertionError(f"kernel B wide off: {json.dumps(dict(rep, lanes=faults))[:3000]}")

    def k64():
        s = [t.clone() for t in state]
        s[0][dc.F_LENS] = 1 << 20  # no lane finishes: all 64 iterations run
        s[0][dc.EOS] = T2 - 1
        return s

    runs = [k64() for _ in range(6)]
    it = iter(runs)
    b_ms = cuda_ms(lambda: dc.decode_step_cuda(fproj, *next(it), dw, bp, 64), 5, 1) / 64
    s1 = [t.clone() for t in state]
    plain_ms = cuda_ms(lambda: dc.decode_step_reference(fproj, *s1, dw, bp), 5, 1)
    ops = 2.0 * N * (P * 4 * P + P * J + J * V)
    nbytes = (2.0 * (P * 4 * P + P * J + J * V) + 4.0 * V * 4 * P) / 64 + N * J * 4
    bound_ms, bound_by = bound(nbytes, ops, PEAK_BF16_FLOPS)
    rows["B_wide"] = {
        "name": "decode_step (wide)", "route": "cuda", "source": "rnnt_inference_tpu_torch/csrc/"
        "decode_step.cu decode_loop_wide", "replaces": "ops/decode_pallas.py:112 "
        "_decode_step_kernel (its one-layer, 1,025-label case)",
        "shape": f"N={N} lanes, P=J={P}, V={V}, one bf16 layer, int16 tokens; K=64 a launch",
        "ms": b_ms, "bound_ms": bound_ms, "bound_by": bound_by, "plain_ms": plain_ms,
        "lanes_parted_in_64": rep["lanes_parted"],
        "near_ties": sum(lane["near_tie"] for lane in rep["lanes"]),
        "library_ms": "none (no single PyTorch call)"}
    emit({"phase": "conformer_kernels", "rows": rows})
    return rows


def phase_conformer_packed(dev, card: str, seed: int) -> dict:
    """The Conformer's packed Offline path: PackedOfflineRunner on the
    benchmark cell conformer.offline.speech's program (17 blocks, 1,025
    labels, bf16; the cell's weights and emission model) over 48 of its
    utterances (its traffic's law and speech-like audio, in an order drawn
    from ``seed``) on 16 lanes at cap 10, with the launch counts set to 0
    just before the run and read just after: each block launches F and G
    once a rep, E and B launch.  Then the same through the runner on the
    twins (impl="reference", no launch).  Each run's tokens are judged as
    the benchmark judges a run (benchmark/check.py against the plain
    reference): the mean widest logit gap within the cell's limit."""
    from benchmark import check, traffic
    from benchmark.common import Cell, cell_program
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime import offline
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    cell = Cell.load("conformer.offline.speech")
    tr, cap = cell.traffic, cell.traffic["max_symbols_per_step"]
    w, served, params, fz = cell_program(cell, dev, cap)
    _, wavs = traffic.store(tr["duration"], 48, seed, dev)
    store = SampleStore(kind="waveform", samples=wavs, transcripts=[""] * len(wavs))
    qsl = QuerySampleLibrary(store, fz, wav_buckets_s=tr["wav_buckets_s"])
    cfg = cell.config
    out = {}
    for impl in (None, "reference"):
        r = PackedOfflineRunner(served, params, fz, n_lanes=16, chunk_frames=tr["chunk_frames"],
                                batch_size=16, decode_chunk=tr["decode_chunk"], device=dev,
                                impl=impl)
        r.stage(qsl)
        for fn in offline._KERNELS.values():
            fn.launches = 0
        t0 = time.time()
        res = r.run_device()
        seconds = time.time() - t0
        launches = offline.launch_counts()
        gaps = check.gaps(cfg, w, cap, wavs, res.tokens, dev, cell.model)
        row = {"launches": launches, "launches_per_timed_pass": res.launches,
               "seconds": seconds, "mean_logit_gap": check.mean_gap(gaps),
               "symbols": int(sum(len(t) for t in res.tokens)),
               "ms": {k: v * 1e3 for k, v in res.phase_seconds.items()}}
        blocks = cfg["num_blocks"]
        if impl is None and not (launches["attention"] == launches["depthwise"] == blocks
                                 and launches["decode_step"] > 0 and launches["projection"] > 0):
            raise AssertionError(f"the Conformer's packed rep launched {launches}")
        if impl is not None and any(launches.values()):
            raise AssertionError(f"impl='reference' launched a kernel: {launches}")
        limit = cell.entry["limits"]["mean_logit_gap"]
        if row["symbols"] == 0 or not row["mean_logit_gap"] <= limit:
            raise AssertionError(f"Conformer packed run ({impl}) off: {row}")
        out["kernels" if impl is None else "twins"] = row
    emit({"phase": "conformer_packed", "card": card, "utterances": len(wavs), "lanes": 16,
          **out})
    return {"main": out["kernels"]["launches"],
            "timed_pass": out["kernels"]["launches_per_timed_pass"]}


def phase_kernel_d(qweights, params, dev, bench_store) -> dict:
    """The fused featurizer path (log_mel_features_fused, kernel D) on 16
    utterances of up to 15 s, with the launch count set to 0 just before it
    and read just after; then kernel D against its twin on the same input.
    Prints the drift of D's normalized features from eager
    log_mel_features (TF32 off) and holds D's tokens on the int8 model
    (encoder, then greedy decode) against the twin's: edit rate <= max(1e-3,
    twice the rate at which the twin's tokens part from those of
    log_mel_features or of the twin summing in another order, whichever is
    larger; the rule bench_twins applies to ties), in two decodes: the
    model as calibrated, and with the bench's blank bias at cap 1.  Each
    decode's token buffer holds max_symbols_per_step tokens for every
    encoder step, so no utterance fills it and the tokens depend on every
    frame.  The rates against the f64 evaluation are printed.  Times D's
    entry point against log_mel_features also at the largest wav batch the
    cut bench's packed runner stages (bench_store, batch 1,024, the bench's
    buckets)."""
    import dataclasses

    from rnnt_inference_tpu_torch.bench import KNOB_DEFAULTS, bias_joint_toward_blank
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode
    from rnnt_inference_tpu_torch.ops import features as tf
    from rnnt_inference_tpu_torch.ops import features_cuda
    from rnnt_inference_tpu_torch.runtime.qsl import (
        QuerySampleLibrary, batch_plan, to_int16_pcm,
    )

    cfg = FeaturizerConfig()
    store = SampleStore.synthetic(n=16, seed=11, min_seconds=14.0, max_seconds=15.0)
    S = 15 * cfg.sample_rate
    wav = np.zeros((16, S), np.float32)
    for i, s in enumerate(store.samples):
        wav[i, : len(s)] = s
    wav, lens = torch.from_numpy(wav).to(dev), torch.from_numpy(store.lengths).to(dev)

    features_cuda.log_mel_cuda.launches = 0
    got, got_lens = tf.log_mel_features_fused(wav, lens, cfg)
    torch.cuda.synchronize()
    launches = features_cuda.log_mel_cuda.launches
    if launches == 0:
        raise AssertionError("log_mel_features_fused never launched kernel D")
    want, want_lens = tf.log_mel_features_fused(wav, lens, cfg, impl="reference")
    feat_diff = float((got - want).abs().max())
    if not (torch.equal(got_lens, want_lens) and feat_diff <= 5e-4):
        raise AssertionError(f"fused features off: {feat_diff}")
    plain, plain_lens = tf.log_mel_features(wav, lens, cfg)
    if not torch.equal(got_lens, plain_lens):
        raise AssertionError("fused and eager feature lengths differ")

    def quantiles(a, b):
        d = (a - b).abs().flatten().double()
        return {"p50": float(d.quantile(0.5)), "p99": float(d.quantile(0.99)),
                "max": float(d.max())}

    drift = {"kernel_vs_log_mel_features": quantiles(got, plain),
             "twin_vs_log_mel_features": quantiles(want, plain)}

    # the padded, preemphasized waveform the entry point hands the kernel
    x = tf.pad_both(tf.preemphasis(wav, lens.long(), cfg.preemph), cfg.n_fft // 2,
                    cfg.pad_mode)[:, tf._frontend_constants(cfg)[3][0]:].contiguous()
    T = S // cfg.hop_length + 1
    frame_lens = lens.long() // cfg.hop_length + 1

    # The token gate's baselines: log_mel_features runs the twin's GEMMs
    # (its features equal the twin's), so also a plain f32 version that
    # sums each frame's DFT in two halves of the frame (another order); and
    # the f64 evaluation, the exact value the f32 versions round.
    def raw_mel(dtype, halves):
        cos_m, sin_m, fbt = (c.to(dtype) for c in tf.device_constants(cfg, str(x.device))[:3])
        fr = tf.frames_at(x.to(dtype), T, cfg.hop_length, cos_m.shape[0])
        h = cos_m.shape[0] // halves
        re = sum(fr[..., i:i + h] @ cos_m[i:i + h] for i in range(0, cos_m.shape[0], h))
        im = sum(fr[..., i:i + h] @ sin_m[i:i + h] for i in range(0, cos_m.shape[0], h))
        return torch.log((re * re + im * im + cfg.dither ** 2) @ fbt + 1e-20).float()

    features = {"kernel_d": (got, got_lens), "twin": (want, want_lens),
                "log_mel_features": (plain, plain_lens),
                "twin_other_order": tf._finish(raw_mel(torch.float32, 2), frame_lens, cfg),
                "f64": tf._finish(raw_mel(torch.float64, 1), frame_lens, cfg)}

    # two decodes, each with a token buffer no utterance can fill: the int8
    # model as calibrated (it emits its cap of max_symbols_per_step tokens
    # at nearly every step) and with the bench's blank bias at cap 1 (about
    # 0.8 symbols per step, emission decided by the frame, many near-ties)
    steps = -(-int(got_lens.max()) // params.stack_time_factor)  # the longest encoder output
    cap1 = dataclasses.replace(params, max_res_len=steps + 1, max_symbols_per_step=1)
    decodes = {
        "calibrated": (qweights, dataclasses.replace(
            params, max_res_len=params.max_symbols_per_step * steps + 1)),
        "blank_cap1": (bias_joint_toward_blank(qweights, cap1, cfg)[0], cap1),
    }

    def tokens(w, p, feats, flens):
        res, rlens = greedy_decode(w, feats, flens, p)
        if int(rlens.max()) >= p.max_res_len:
            raise AssertionError(f"an utterance filled the {p.max_res_len}-token buffer")
        return [res[i, : rlens[i]].cpu().numpy() for i in range(res.shape[0])]

    pairs = (("kernel_d", "twin"), ("twin", "log_mel_features"), ("twin", "twin_other_order"),
             ("kernel_d", "f64"), ("twin", "f64"))
    token_gates = {}
    for name, (w, p) in decodes.items():
        toks = {k: tokens(w, p, *f) for k, f in features.items()}
        rates = {f"{a}_vs_{b}": _edit_rate(toks[a], toks[b]) for a, b in pairs}
        baseline = max(rates["twin_vs_log_mel_features"][0], rates["twin_vs_twin_other_order"][0])
        gate = max(1e-3, 2 * baseline)
        rate_d, n_tok, _ = rates["kernel_d_vs_twin"]
        token_gates[name] = {
            "tokens": n_tok, "token_buffer": p.max_res_len,
            "longest_utterance_tokens": max(map(len, toks["twin"])),
            "edit_rates": {k: {"rate": r, "utterances_differing": d} for k, (r, _, d) in
                           rates.items()}, "gate": gate}
        if n_tok == 0 or rate_d > gate:
            raise AssertionError(f"{name}: kernel D's token edit rate {rate_d} against the twin "
                                 f"over {n_tok} tokens, gate {gate}: {token_gates[name]}")
    rate_d = max(g["edit_rates"]["kernel_d_vs_twin"]["rate"] for g in token_gates.values())

    # the kernel alone, on that waveform
    a, b = tf.fused_mel(x, T, cfg), tf.fused_mel(x, T, cfg, impl="reference")
    torch.cuda.synchronize()
    mel_diff = float((a - b).abs().max())
    if not mel_diff <= 1e-4:
        worst = np.unravel_index(int((a - b).abs().argmax()), a.shape)
        raise AssertionError(f"kernel D off: {mel_diff} at (utterance, frame, mel) {worst}")
    ms = cuda_ms(lambda: tf.fused_mel(x, T, cfg), 20)
    plain_ms = cuda_ms(lambda: tf.fused_mel(x, T, cfg, impl="reference"), 10)
    entry_ms = cuda_ms(lambda: tf.log_mel_features_fused(wav, lens, cfg), 10)
    plain_entry_ms = cuda_ms(lambda: tf.log_mel_features(wav, lens, cfg), 10)
    N, K, M, flen = x.shape[0], 257, cfg.n_mels, 2 * cfg.hop_length
    bytes_moved = x.numel() * 4 + N * T * M * 4 + (2 * flen * K + K * M) * 4
    products = N * T * (2 * 2 * flen * K + 2 * K * M)
    ops = products + N * T * (3 * K + 2 * M)
    # the floor of D's own arithmetic: three tf32 products per f32 product
    # on the tensor cores; beside it, f32 on the CUDA cores (a design without them)
    bound_ms, bound_by = bound(bytes_moved, 3 * products, PEAK_TF32_FLOPS)
    bound_f32, bound_f32_by = bound(bytes_moved, ops, PEAK_F32_FLOPS)

    # the largest wav batch the cut bench's packed runner stages
    qsl = QuerySampleLibrary(bench_store, cfg, wav_buckets_s=tuple(
        float(v) for v in KNOB_DEFAULTS["BENCH_SECONDS"].split(",")))
    Sb, rows, g = max(batch_plan(qsl, int(KNOB_DEFAULTS["BENCH_BATCH"]), None, 32),
                      key=lambda e: e[0] * e[2])
    wb = np.zeros((g, Sb), np.int16)
    lb = np.zeros((g,), np.int32)
    for r, i in enumerate(rows):
        smp = bench_store.samples[i][:Sb]
        wb[r, : len(smp)] = to_int16_pcm(smp)
        lb[r] = len(smp)
    wb = torch.from_numpy(wb).to(dev).float() * (1.0 / 32768.0)  # as the packed runner scales
    lb = torch.from_numpy(lb).to(dev)
    gb, gbl = tf.log_mel_features_fused(wb, lb, cfg)
    pb, pbl = tf.log_mel_features(wb, lb, cfg)
    batch_diff = float((gb - pb).abs().max())
    if not (torch.equal(gbl, pbl) and batch_diff <= 5e-4):
        raise AssertionError(f"fused features off at the bench's batch: {batch_diff}")
    packed_batch = {
        "utterances": g, "samples": Sb, "frames": Sb // cfg.hop_length + 1,
        "features_max_abs_diff_vs_log_mel_features": batch_diff,
        "entry_ms": cuda_ms(lambda: tf.log_mel_features_fused(wb, lb, cfg), 5),
        "log_mel_features_ms": cuda_ms(lambda: tf.log_mel_features(wb, lb, cfg), 5),
    }
    del wb, gb, pb
    emit({"phase": "kernel_d", "utterances": N, "frames": T, "launches": launches,
          "tolerance": "normalized features <= 5e-4 (tests/test_features.py's bound), "
                       "raw log-mel <= 1e-4; tokens, per decode: edit rate against the "
                       "twin <= max(1e-3, 2 x the larger of twin against log_mel_features "
                       "and twin against the twin summing in another order)",
          "features_max_abs_diff": feat_diff, "log_mel_max_abs_diff": mel_diff,
          "normalized_feature_drift": drift, "token_gates": token_gates,
          "ms": ms, "plain_ms": plain_ms, "entry_ms": entry_ms,
          "log_mel_features_ms": plain_entry_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_ms_f32_cuda_cores": bound_f32, "bound_by_f32_cuda_cores": bound_f32_by,
          "packed_runner_batch": packed_batch})
    return {
        "name": "log_mel", "route": "cuda",
        "source": "rnnt_inference_tpu_torch/csrc/mel.cu",
        "replaces": "rnnt_inference_tpu/ops/features_pallas.py:47",
        "shape": f"N={N} T={T} frames of 320 samples, 257 bins, {M} mels; one call = 1 launch; "
                 "3xTF32 tensor-core products; bound_ms at the TF32 tensor-core rate "
                 "(3 products each), bound_ms_f32_cuda_cores at the f32 CUDA-core rate",
        "launches": launches, "max_abs_err": mel_diff, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_ms_f32_cuda_cores": bound_f32,
        "bound_by_f32_cuda_cores": bound_f32_by, "library_ms": None,
        "library_note": "no single PyTorch call computes frames -> windowed DFT -> "
                        "power -> mel -> log (torch.stft + matmul + log is several calls)",
        "entry_ms": entry_ms, "log_mel_features_ms": plain_entry_ms,
        "packed_runner_batch": packed_batch, "token_edit_rate_vs_twin": rate_d,
    }


def phase_cli(mode: str, n: int, dev, card: str) -> dict:
    """The CLI's float run mode end to end: main --run_mode <mode>
    --benchmark --scenario Offline --synthetic n (device-resident bucketed
    Offline; kernel C for the encoder, kernel B for decode), with the launch
    counts set to 0 just before it and read just after; then the same
    weights and store through run_offline with an impl="reference" runner,
    which must launch no kernel, and the token edit rate between the two.
    The launches of main's timed pass are the runner's own count
    (RunReport.launches)."""
    import tempfile

    from rnnt_inference_tpu_torch import main as cli
    from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
    from rnnt_inference_tpu_torch.ops import (
        decode_cuda, lstm_cuda, lstm_scan_cuda, projection_cuda,
    )
    from rnnt_inference_tpu_torch.runtime.harness import run_offline
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner

    counters = {"lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda,
                "decode_step": decode_cuda.decode_step_cuda,
                "quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "projection": projection_cuda.project_cuda}
    with tempfile.TemporaryDirectory() as out:
        argv = ["--run_mode", mode, "--benchmark", "--scenario", "Offline",
                "--synthetic", str(n), "--output_dir", out]
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):  # main prints its summary
            rk = cli.main(argv)
        seconds = time.time() - t0
        launches = {k: c.launches for k, c in counters.items()}
        per_pass = rk.launches
        if launches["lstm_recurrence"] == 0 or launches["decode_step"] == 0:
            raise AssertionError(f"the {mode} CLI run never launched kernel C or B: {launches}")
        if per_pass["lstm_recurrence"] == 0 or per_pass["decode_step"] == 0:
            raise AssertionError(f"main's timed pass launched no kernel C or B: {per_pass}")
        if mode == "bf16" and not per_pass["projection"]:
            raise AssertionError(f"main's bf16 timed pass launched no kernel E: {per_pass}")

        args = cli.parse_args(argv)
        params, cfg = RNNTParams(), FeaturizerConfig()
        weights, _ = cli.load_model_weights(args, params, dev)
        store = cli.load_store(args, None)
        ref = OfflineRunner(weights, params, cfg, args.batch_size, device=dev, impl="reference")
        rr = run_offline(weights, store, params, cfg, batch_size=args.batch_size,
                         runner=ref, device_resident=True, warmup=False, device=dev)
        if any(rr.launches.values()):
            raise AssertionError(f"impl='reference' launched a kernel: {rr.launches}")

    seq = lambda h: np.frombuffer(h.encode(), np.uint8)  # one character per token
    n_tok = sum(len(h) for h in rr.hypotheses)
    edits = [edit_distance(seq(a), seq(b)) for a, b in zip(rk.hypotheses, rr.hypotheses)]
    edit_rate = sum(edits) / max(n_tok, 1)
    if n_tok == 0 or edit_rate > 1e-3:
        raise AssertionError(f"{mode} kernels vs reference token edit rate {edit_rate} "
                             f"({n_tok} tokens)")
    ms = lambda r: {k: v * 1e3 for k, v in r.phase_seconds.items()}
    emit({
        "phase": f"cli_{mode}", "card": card, "argv": argv[:-2], "utterances": len(store),
        "audio_seconds": store.audio_seconds, "batch_size": args.batch_size,
        "batches": rk.extra["batches"], "main_seconds": seconds, "tokens": n_tok,
        "utterances_differing": [i for i, e in enumerate(edits) if e],
        "token_edit_rate": edit_rate, "launches": launches,
        "launches_per_timed_pass": per_pass,
        "kernels": {"summary": rk.summary(), "ms": ms(rk)},
        "reference": {"wall_seconds": rr.wall_seconds,
                      "audio_seconds_per_second": rr.audio_seconds_per_second, "ms": ms(rr)},
    })
    return {"main": launches, "timed_pass": per_pass}


def phase_end_to_end(qweights, params, dev, seed: int, card: str) -> dict:
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    store = SampleStore.synthetic(n=32, seed=seed + 2, min_seconds=1.0, max_seconds=15.0)
    qsl = QuerySampleLibrary(store)
    kern = OfflineRunner(qweights, params, batch_size=16, device=dev)
    ref = OfflineRunner(qweights, params, batch_size=16, device=dev, impl="reference")
    warm = kern.warmup(qsl)

    lstm_cuda.quant_lstm_layer_cuda.launches = 0
    decode_cuda.decode_step_cuda.launches = 0
    rk = kern.run(qsl)
    launches = {
        "quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda.launches,
        "decode_step": decode_cuda.decode_step_cuda.launches,
    }
    rr = ref.run(qsl)
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if any(rk.launches[k] != v for k, v in launches.items()):
        raise AssertionError(f"the runner counted {rk.launches}, the wrappers {launches}")
    if any(rr.launches.values()):
        raise AssertionError(f"impl='reference' launched a kernel: {rr.launches}")
    # one kernel-A launch per layer call: every batch runs the whole encoder once
    layer_calls = rk.batches * (params.pre_num_layers + params.post_num_layers)
    if rk.launches["quant_lstm_layer"] != layer_calls:
        raise AssertionError(f"kernel A launched {rk.launches['quant_lstm_layer']} times for "
                             f"{layer_calls} layer calls")

    n_tok = sum(len(t) for t in rr.tokens)
    edits = [edit_distance(a, b) for a, b in zip(rk.tokens, rr.tokens)]
    differ = [i for i, e in enumerate(edits) if e]
    edit_rate = sum(edits) / max(n_tok, 1)
    for t in rk.tokens:
        if len(t) > params.max_res_len or (len(t) and (t.min() < 0 or t.max() >= params.BLANK)):
            raise AssertionError("tokens outside the alphabet or the buffer")
    if n_tok == 0 or edit_rate > 1e-3:
        raise AssertionError(f"kernel vs reference token edit rate {edit_rate} ({n_tok} tokens)")
    out = {
        "phase": "end_to_end", "card": card, "utterances": len(store), "batch_size": 16,
        "batches": rk.batches, "audio_seconds": store.audio_seconds,
        "warmup_seconds": warm, "tokens": n_tok, "utterances_differing": differ,
        "token_edit_rate": edit_rate, "launches": launches,
        "launches_per_timed_pass": rk.launches, "encoder_layer_calls_per_timed_pass": layer_calls,
        "kernels": {
            "wall_seconds": rk.wall_seconds,
            "audio_seconds_per_second": store.audio_seconds / rk.wall_seconds,
            "ms": {k: v * 1e3 for k, v in rk.phase_seconds.items()},
        },
        "reference": {
            "wall_seconds": rr.wall_seconds,
            "audio_seconds_per_second": store.audio_seconds / rr.wall_seconds,
            "ms": {k: v * 1e3 for k, v in rr.phase_seconds.items()},
        },
    }
    emit(out)
    return {"main": launches, "timed_pass": rk.launches, "layer_calls": layer_calls}


def _edit_rate(got, want):
    """(token edit rate of got against want, tokens of want, indices that differ)."""
    n_tok = sum(len(t) for t in want)
    edits = [edit_distance(np.asarray(a), np.asarray(b)) for a, b in zip(got, want, strict=True)]
    return sum(edits) / max(n_tok, 1), n_tok, [i for i, e in enumerate(edits) if e]


def phase_packed_int8(qweights, params, dev, card: str) -> dict:
    """The CLI's sequence-packed int8 Offline run: main --run_mode quant
    --quant_in <the int8 weights, saved> --packed --benchmark --scenario
    Offline --synthetic 64 --batch_size 16 (64 utterances of 1-15 s on 16
    lanes; at cap 30 the budget of max_res_len tokens binds), with the
    launch counts set to 0 just before it and read just after; kernel A
    must launch five times per chunk of the timed rep.  Then the same store
    through the packed runner on the twins (no launch) and through the
    bucketed int8 runner on the kernels (device-resident, int16 staging as
    the packed runner's): token edit rates <= 1e-3 against both."""
    import tempfile

    from rnnt_inference_tpu_torch import main as cli
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda
    from rnnt_inference_tpu_torch.runtime.harness import run_offline
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner

    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda}
    with tempfile.TemporaryDirectory() as out:
        quant = os.path.join(out, "rnnt_quant.npz")
        checkpoint.save_quant_weights(quant, qweights)
        argv = ["--run_mode", "quant", "--quant_in", quant, "--packed", "--benchmark",
                "--scenario", "Offline", "--synthetic", "64", "--batch_size", "16",
                "--output_dir", out]
        for c in counters.values():
            c.launches = 0
        lstm_cuda.quant_lstm_layer_cuda.hoisted = 0
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):  # main prints its summary
            rk = cli.main(argv)
        seconds = time.time() - t0
        launches = {k: c.launches for k, c in counters.items()}
        hoisted = lstm_cuda.quant_lstm_layer_cuda.hoisted
        per_rep = rk.launches
        chunks = rk.extra["pack_chunks"]
        layers = params.pre_num_layers + params.post_num_layers
        if launches["quant_lstm_layer"] == 0 or launches["decode_step"] == 0:
            raise AssertionError(f"the packed CLI run never launched kernel A or B: {launches}")
        if per_rep["quant_lstm_layer"] != layers * chunks or per_rep["decode_step"] == 0:
            raise AssertionError(f"the timed packed rep launched {per_rep} for {chunks} chunks")
        args = cli.parse_args(argv)
        weights, _ = cli.load_model_weights(args, params, dev)
        store = cli.load_store(args, None)
    cfg = FeaturizerConfig()
    t0 = time.time()
    ref = PackedOfflineRunner(weights, params, cfg, n_lanes=16, chunk_frames=16, batch_size=16,
                              device=dev, impl="reference")
    rr = run_offline(weights, store, params, cfg, batch_size=16, packed=True, runner=ref,
                     warmup=False, device=dev)
    ref_seconds = time.time() - t0
    if any(rr.launches.values()):
        raise AssertionError(f"impl='reference' launched a kernel: {rr.launches}")
    rb = run_offline(weights, store, params, cfg, batch_size=16, device_resident=True,
                     runner=OfflineRunner(weights, params, cfg, 16, device=dev), device=dev)
    seq = lambda hyps: [np.frombuffer(h.encode(), np.uint8) for h in hyps]  # a char per token
    rate_ref, n_tok, differ_ref = _edit_rate(seq(rk.hypotheses), seq(rr.hypotheses))
    rate_b, n_tok_b, differ_b = _edit_rate(seq(rk.hypotheses), seq(rb.hypotheses))
    if n_tok == 0 or rate_ref > 1e-3 or rate_b > 1e-3:
        raise AssertionError(f"packed int8 token edit rates {rate_ref} (twins), {rate_b} "
                             f"(bucketed) over {n_tok} tokens")
    ms = lambda r: {k: v * 1e3 for k, v in r.phase_seconds.items()}
    emit({
        "phase": "packed_int8", "card": card, "argv": argv[:3] + ["<tmp>"] + argv[4:-2],
        "utterances": len(store), "audio_seconds": store.audio_seconds, "lanes": 16,
        "main_seconds": seconds, "tokens": n_tok,
        "token_edit_rate_vs_twins": rate_ref, "utterances_differing_vs_twins": differ_ref,
        "token_edit_rate_vs_bucketed": rate_b, "utterances_differing_vs_bucketed": differ_b,
        "packing_efficiency": rk.extra["packing_efficiency"], "pack_chunks": chunks,
        "chunk_frames": rk.extra["chunk_frames"], "launches": launches,
        "launches_per_timed_rep": per_rep, "kernel_a_launches_per_chunk": layers,
        "kernel_a_hoisted_share": hoisted / launches["quant_lstm_layer"],
        "kernels": {"summary": rk.summary(), "ms": ms(rk)},
        "reference": {"wall_seconds": rr.wall_seconds, "run_seconds": ref_seconds,
                      "audio_seconds_per_second": rr.audio_seconds_per_second, "ms": ms(rr)},
        "bucketed_int8": {"wall_seconds": rb.wall_seconds,
                          "audio_seconds_per_second": rb.audio_seconds_per_second,
                          "ms": ms(rb), "launches_per_timed_pass": rb.launches},
    })
    return {"main": launches, "timed_pass": per_rep}


def phase_server_int8(qweights, params, dev, seed: int, card: str) -> dict:
    """The Server slot pipeline on the int8 model: run_server over a
    ServerRunner of 32 slots (split_len 24, insert_batch 8, 4 steps per
    dispatch) on 32 utterances of 1-15 s, first issuing as fast as it
    accepts them (launch counts set to 0 just before, read just after),
    then the same run through a ServerRunner on the twins (impl=
    "reference": kernels A and B at the shapes this path gives them, 32
    slots and T = 24 / 12, against their plain versions on the same
    inputs; it launches no kernel), then in real time at half the issue
    rate the first run reached.  Tokens within edit rate 1e-3 of the
    twins' and of the bucketed int8 runner's on the same store, in both
    kernel runs."""
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
    from rnnt_inference_tpu_torch.runtime.scheduler import run_server
    from rnnt_inference_tpu_torch.runtime.server import ServerRunner

    store = SampleStore.synthetic(n=32, seed=seed + 3, min_seconds=1.0, max_seconds=15.0)
    runner = ServerRunner(qweights, params, slots=32, device=dev)
    warm = runner.warmup()
    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda}
    for c in counters.values():
        c.launches = 0
    metrics, results = run_server(runner, store, target_qps=1e6, realtime=False)
    launches = {k: c.launches for k, c in counters.items()}
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"the Server run never launched kernel A or B: {launches}")
    if metrics.completed != len(store) or runner.n_active:
        raise AssertionError(f"Server completed {metrics.completed} of {len(store)}")
    ref = ServerRunner(qweights, params, slots=32, device=dev, impl="reference")
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.time()
    ref_metrics, ref_results = run_server(ref, store, target_qps=1e6, realtime=False)
    ref_seconds = time.time() - t0
    if {k: c.launches for k, c in counters.items()} != before:
        raise AssertionError("the Server run on the twins launched a kernel")
    if ref_metrics.completed != len(store):
        raise AssertionError(f"the twins' Server completed {ref_metrics.completed}")
    twins = [ref_results[q] for q in range(len(store))]
    bucketed = OfflineRunner(qweights, params, batch_size=16, device=dev)
    qsl = QuerySampleLibrary(store)
    bucketed.warmup(qsl)
    rb = bucketed.run(qsl)
    tokens = [results[q] for q in range(len(store))]
    rate_ref, n_tok, differ_ref = _edit_rate(tokens, twins)
    rate, _, differ = _edit_rate(tokens, rb.tokens)
    if n_tok == 0 or rate_ref > 1e-3 or rate > 1e-3:
        raise AssertionError(f"Server token edit rates {rate_ref} (twins), {rate} (bucketed "
                             f"int8) over {n_tok} tokens")
    issue_qps = metrics.issued / metrics.wall_seconds
    rt_metrics, rt_results = run_server(runner, store, target_qps=issue_qps / 2, realtime=True)
    if rt_metrics.completed != len(store):
        raise AssertionError(f"real-time Server completed {rt_metrics.completed} of {len(store)}")
    rt_tokens = [rt_results[q] for q in range(len(store))]
    rt_rate_ref, _, _ = _edit_rate(rt_tokens, twins)
    rt_rate, _, _ = _edit_rate(rt_tokens, rb.tokens)
    if rt_rate_ref > 1e-3 or rt_rate > 1e-3:
        raise AssertionError(f"real-time Server token edit rates {rt_rate_ref} (twins), "
                             f"{rt_rate} (bucketed int8)")
    rt = rt_metrics.summary()
    emit({
        "phase": "server_int8", "card": card, "utterances": len(store),
        "audio_seconds": store.audio_seconds, "slots": runner.slots,
        "split_len": runner.split_len, "insert_batch": runner.insert_batch,
        "steps_per_dispatch": runner.steps_per_dispatch, "warmup_seconds": warm,
        "tokens": n_tok, "token_edit_rate_vs_twins": rate_ref,
        "utterances_differing_vs_twins": differ_ref, "token_edit_rate_vs_bucketed": rate,
        "utterances_differing_vs_bucketed": differ, "launches": launches,
        "twins": {"run_seconds": ref_seconds, "wall_seconds": ref_metrics.wall_seconds},
        "as_fast_as_accepted": dict(metrics.summary(), issue_qps=issue_qps,
                                    audio_seconds_per_second=store.audio_seconds
                                    / metrics.wall_seconds),
        "realtime": dict(rt, target_qps=issue_qps / 2,
                         deferred=rt.get("deferred_completed", 0),
                         token_edit_rate_vs_twins=rt_rate_ref,
                         token_edit_rate_vs_bucketed=rt_rate),
    })
    return {"main": launches, "timed_pass": launches, "realtime_qps": issue_qps / 2}


# min_duration of the native runs, cut from the MLPerf conf's 600 s
NATIVE_MIN_DURATION_MS = 6000
# the native runs' store (the CLI's --synthetic NATIVE_N) and SingleStream's
# sample set, its first NATIVE_SS utterances
NATIVE_N, NATIVE_SS = 64, 8


def _write_conf(path: str, scenario: str, psc: int, **keys) -> str:
    """A user.conf: performance_sample_count_override and the scenario's keys."""
    lines = [f"rnnt.*.performance_sample_count_override = {psc}"]
    lines += [f"rnnt.{scenario}.{k} = {v}" for k, v in keys.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _cli_run(argv, counters):
    """(main's return value, the wrapper launch counts of the call, its
    seconds): the counts set to 0 just before main and read just after."""
    from rnnt_inference_tpu_torch import main as cli

    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):  # main prints its summary
        ret = cli.main(argv)
    return ret, {k: c.launches for k, c in counters.items()}, time.time() - t0


def _check_native(name, completed, issued, n_queries, per_run, per_timed):
    if not completed == issued >= n_queries:
        raise AssertionError(f"{name}: completed {completed}, issued {issued}, "
                             f"{n_queries} queries asked for")
    for k in ("quant_lstm_layer", "decode_step"):
        if not per_run[k] or not per_timed[k]:
            raise AssertionError(f"{name} never launched {k}: main {per_run}, "
                                 f"the runner's count {per_timed}")


def phase_native(qweights, params, dev, card: str, server_qps: float) -> dict:
    """The CLI's --native_loadgen --benchmark runs on the int8 model (saved
    and loaded with --quant_in), full width, the timing on the native
    mini-loadgen's clock (runtime/native.py, built with g++), each with a
    user.conf that cuts min_duration to NATIVE_MIN_DURATION_MS:
      - Offline bucketed (--synthetic 64 --batch_size 16; target_qps the
        same store's non-native rate, min_query_count 2 x 64) and --packed
        (16 lanes);
      - Server (the same 64 utterances on 32 slots; Poisson at the real-time
        rate of phase server_int8; min_query_count 128);
      - SingleStream (its first 8 utterances; min_query_count 16).
    The launch counts are set to 0 just before each main call and read just
    after.  Each run: completed == issued >= the queries asked for, kernels
    A and B launched in the call and by the runner's own count, and its
    tokens within edit rate 1e-3 of the same store's non-native run on the
    kernels (run_offline, bucketed or packed as the run; Server and
    SingleStream against the bucketed one, query q as sample q % n).
    SingleStream's tokens are also held to edit rate 1e-3 against the same
    utterances through the one-lane runner on the twins (impl="reference",
    int16 staging as SingleStream's), which must launch nothing: kernels A
    and B at SingleStream's shapes against their plain versions."""
    import tempfile

    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda
    from rnnt_inference_tpu_torch.runtime.harness import run_offline
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
    from rnnt_inference_tpu_torch.utils.labels import seq_to_sen

    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda}
    cfg, n, lanes = FeaturizerConfig(), NATIVE_N, 16
    store = SampleStore.synthetic(n=n, seed=0)  # the CLI's --synthetic 64 (--seed 0)
    seq = lambda hyps: [np.frombuffer(h.encode(), np.uint8) for h in hyps]  # a char per token
    refs = {packed: run_offline(qweights, store, params, cfg, batch_size=lanes,
                                device_resident=not packed, packed=packed, device=dev,
                                min_duration_s=2.0)
            for packed in (False, True)}
    paths, out = {}, {"phase": "native", "card": card, "utterances": n,
                      "audio_seconds": store.audio_seconds,
                      "min_duration_ms": NATIVE_MIN_DURATION_MS}
    with tempfile.TemporaryDirectory() as d:
        quant = os.path.join(d, "rnnt_quant.npz")
        checkpoint.save_quant_weights(quant, qweights)
        base = ["--run_mode", "quant", "--quant_in", quant, "--benchmark", "--native_loadgen",
                "--synthetic", str(n), "--batch_size", str(lanes)]
        for packed in (False, True):
            ref = refs[packed]
            key = "native_packed" if packed else "native_offline"
            conf = _write_conf(os.path.join(d, f"{key}.conf"), "Offline", n,
                               min_query_count=2 * n, min_duration=NATIVE_MIN_DURATION_MS,
                               target_qps=ref.samples_per_second)
            argv = base + ["--scenario", "Offline", "--packed" if packed else "--no_packed",
                           "--user_conf", conf, "--output_dir", os.path.join(d, key)]
            rk, launches, seconds = _cli_run(argv, counters)
            if rk.extra.get("timing") != "native":
                raise AssertionError(f"{key}: timing {rk.extra.get('timing')!r}")
            _check_native(key, rk.extra["completed"], rk.extra["issued"], rk.extra["queries"],
                          launches, rk.launches)
            rate, n_tok, differ = _edit_rate(seq(rk.hypotheses), seq(ref.hypotheses))
            if n_tok == 0 or rate > 1e-3:
                raise AssertionError(f"{key}: token edit rate {rate} against run_offline")
            out[key] = {
                "argv": argv[:3] + ["<tmp>"] + argv[4:-4], "main_seconds": seconds,
                "summary": rk.summary(), "token_edit_rate": rate, "tokens": n_tok,
                "utterances_differing": differ, "launches": launches,
                "launches_native_loop": rk.launches,
                "audio_seconds_per_second": rk.audio_seconds_per_second,
                "run_offline_audio_seconds_per_second": ref.audio_seconds_per_second,
                "run_offline_rep_wall_seconds": ref.extra["rep_wall_seconds"],
                "native_over_run_offline": rk.audio_seconds_per_second
                / ref.audio_seconds_per_second,
            }
            paths[key] = {"main": launches, "timed_pass": rk.launches}

        ref_hyps = refs[False].hypotheses
        conf = _write_conf(os.path.join(d, "server.conf"), "Server", n, target_qps=server_qps,
                           min_query_count=2 * n, min_duration=NATIVE_MIN_DURATION_MS)
        argv = base + ["--scenario", "Server", "--server_slots", "32", "--user_conf", conf,
                       "--output_dir", os.path.join(d, "server")]
        (rep, results), launches, seconds = _cli_run(argv, counters)
        _check_native("native_server", rep["completed"], rep["issued"], 2 * n, launches,
                      rep["launches"])
        qs = sorted(results)
        if len(qs) != rep["completed"]:
            raise AssertionError(f"native_server: {len(qs)} results, {rep['completed']} completed")
        rate, n_tok, _ = _edit_rate(seq([seq_to_sen(results[q]) for q in qs]),
                                    seq([ref_hyps[q % n] for q in qs]))
        if n_tok == 0 or rate > 1e-3:
            raise AssertionError(f"native_server: token edit rate {rate} against run_offline")
        out["native_server"] = {
            "argv": argv[:3] + ["<tmp>"] + argv[4:-4], "target_qps": server_qps,
            "main_seconds": seconds, "summary": {k: v for k, v in rep.items() if k != "launches"},
            "token_edit_rate": rate, "tokens": n_tok, "launches": launches,
            "launches_native_loop": rep["launches"]}
        paths["native_server"] = {"main": launches, "timed_pass": rep["launches"]}

        n_ss = NATIVE_SS
        conf = _write_conf(os.path.join(d, "single_stream.conf"), "SingleStream", n_ss,
                           min_query_count=2 * n_ss, min_duration=NATIVE_MIN_DURATION_MS,
                           target_latency_percentile=90)
        argv = base + ["--scenario", "SingleStream", "--user_conf", conf,
                       "--output_dir", os.path.join(d, "single_stream")]
        rs, launches, seconds = _cli_run(argv, counters)
        _check_native("native_single_stream", rs.extra["completed"], rs.extra["issued"],
                      2 * n_ss, launches, rs.launches)
        rate, n_tok, _ = _edit_rate(seq(rs.hypotheses), seq(ref_hyps[:n_ss]))
        if n_tok == 0 or rate > 1e-3:
            raise AssertionError(f"native_single_stream: token edit rate {rate}")
        ss_store = store.select(np.arange(n_ss))
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        twin = run_offline(qweights, ss_store, params, cfg, batch_size=1, warmup=False,
                           device_resident=True, device=dev,
                           runner=OfflineRunner(qweights, params, cfg, 1, device=dev,
                                                impl="reference"))
        twin_seconds = time.time() - t0
        if any(c.launches for c in counters.values()) or any(twin.launches.values()):
            raise AssertionError(f"native_single_stream: impl='reference' launched a kernel: "
                                 f"{twin.launches}")
        twin_rate, twin_tok, twin_differ = _edit_rate(seq(rs.hypotheses), seq(twin.hypotheses))
        if twin_tok == 0 or twin_rate > 1e-3:
            raise AssertionError(f"native_single_stream: token edit rate {twin_rate} against "
                                 "the one-lane runner on the twins")
        out["native_single_stream"] = {
            "argv": argv[:3] + ["<tmp>"] + argv[4:-4], "main_seconds": seconds,
            "utterances": n_ss, "audio_seconds": ss_store.audio_seconds,
            "summary": rs.summary(), "token_edit_rate": rate, "tokens": n_tok,
            "token_edit_rate_vs_twins_one_lane": twin_rate, "tokens_twins": twin_tok,
            "utterances_differing_vs_twins": twin_differ, "twins_seconds": twin_seconds,
            "launches": launches, "launches_native_loop": rs.launches}
        paths["native_single_stream"] = {"main": launches, "timed_pass": rs.launches}
    emit(out)
    return paths


def phase_product_chain(params, dev, card: str, seed: int) -> dict:
    """scripts/run.sh stages 3-5 through the port's CLI on the card: a
    zenodo-layout rnnt.pt of seeded f32 weights (torch.save), ``--model
    rnnt.pt --calibration``, then ``--save_quant``, then ``--accuracy
    --packed --manifest m.json`` (the manifest's transcripts for the WER),
    then the native Offline performance run on the quantized model.  The
    same chain from the same weights saved as an npz must give the same
    calibration, int8 model and accuracy log, byte for byte; the native
    run's tokens sit within edit rate 1e-3 of the accuracy log's; and a
    loadgen source that does not compile raises."""
    import tempfile
    from pathlib import Path

    from rnnt_inference_tpu_torch import main as cli
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.models.weights import (
        init_weights, read_npz, torch_state_dict_from_weights,
    )
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda, lstm_scan_cuda
    from rnnt_inference_tpu_torch.runtime import native
    from rnnt_inference_tpu_torch.utils.labels import seq_to_sen

    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda,
                "lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda}
    rng = np.random.RandomState(seed + 13)
    words = "the a of speech model reads seven quiet rivers under bright stones".split()
    out = {"phase": "product_chain", "card": card}
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)
        weights = init_weights(params, torch.Generator().manual_seed(seed + 11), device="cpu")
        torch.save({"state_dict": torch_state_dict_from_weights(weights), "epoch": 0},
                   p("rnnt.pt"))
        checkpoint.save_weights(p("weights.npz"), weights)
        SampleStore.synthetic(n=8, seed=seed + 12, min_seconds=2.0, max_seconds=8.0,
                              mean_seconds=5.0).save(p("calib.npz"))
        store = SampleStore.synthetic(n=16, seed=seed + 14, max_seconds=14.0)
        store.save(p("store.npz"))
        with open(p("m.json"), "w") as f:
            json.dump([{"audio_filepath": name, "duration": len(s) / 16000.0,
                        "transcript": " ".join(rng.choice(words, size=rng.randint(3, 9)))}
                       for name, s in zip(store.names, store.samples)], f)
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        logs, wer = {}, {}
        with contextlib.redirect_stdout(sys.stderr):  # main prints its summaries
            for src, model in (("pt", p("rnnt.pt")), ("npz", p("weights.npz"))):
                cli.main(["--model", model, "--run_mode", "f32", "--calibration", "--calib_file",
                          p("calib.npz"), "--calib_out", p(f"calib_{src}.npz"),
                          "--batch_size", "8"])
                cli.main(["--model", model, "--run_mode", "f32", "--save_quant", "--calib_in",
                          p(f"calib_{src}.npz"), "--quant_out", p(f"quant_{src}.npz")])
                cli.main(["--quant_in", p(f"quant_{src}.npz"), "--accuracy", "--packed",
                          "--manifest", p("m.json"), "--sample_file", p("store.npz"),
                          "--batch_size", "16", "--output_dir", p(f"acc_{src}")])
                with open(p(f"acc_{src}/accuracy_log.json")) as f:
                    logs[src] = f.read()
                with open(p(f"acc_{src}/summary.json")) as f:
                    wer[src] = json.load(f)["wer_percent"]
            chain_seconds = time.time() - t0
            conf = _write_conf(p("offline.conf"), "Offline", len(store),
                               min_query_count=2 * len(store), min_duration=0)
            perf = cli.main(["--quant_in", p("quant_pt.npz"), "--benchmark", "--native_loadgen",
                             "--sample_file", p("store.npz"), "--batch_size", "16",
                             "--user_conf", conf, "--output_dir", p("perf")])
        launches = {k: c.launches for k, c in counters.items()}
        for kind in ("calib", "quant"):
            a, b = read_npz(p(f"{kind}_pt.npz"))[1], read_npz(p(f"{kind}_npz.npz"))[1]
            if len(a) != len(b) or any(x.tobytes() != y.tobytes() for x, y in zip(a, b)):
                raise AssertionError(f"product_chain: the .pt and .npz chains' {kind} differ")
        if logs["pt"] != logs["npz"]:
            raise AssertionError("product_chain: the .pt chain's accuracy log differs from "
                                 "the .npz chain's")
        acc = {e["qsl_idx"]: np.frombuffer(bytes.fromhex(e["data"]), "<i4")
               for e in json.loads(logs["pt"])}
        if sorted(acc) != list(range(len(store))) or wer["pt"] is None:
            raise AssertionError(f"product_chain: accuracy log of {len(acc)} utterances, "
                                 f"WER {wer['pt']}")
        _check_native("product_chain", perf.extra["completed"], perf.extra["issued"],
                      2 * len(store), launches, perf.launches)
        seq = lambda h: np.frombuffer(h.encode(), np.uint8)  # a char per token
        rate, n_tok, _ = _edit_rate([seq(h) for h in perf.hypotheses],
                                    [seq(seq_to_sen(acc[i])) for i in range(len(store))])
        if n_tok == 0 or rate > 1e-3:
            raise AssertionError(f"product_chain: native vs accuracy-log edit rate {rate}")
        if perf.extra["timing"] != "native" or not launches["lstm_recurrence"]:
            raise AssertionError(f"product_chain: timing {perf.extra['timing']}, launches "
                                 f"{launches} (calibration runs kernel C)")

        broken = Path(p("rnnt_loadgen.cpp"))
        broken.write_text(native.SRC.read_text().replace("int lg_poll(", "int lg_poll(((", 1))
        try:
            native.build_lib(broken, Path(p("broken_build")))
        except RuntimeError as e:
            broken_error = str(e).splitlines()[0]
        else:
            raise AssertionError("product_chain: a broken loadgen source built")
    out.update({
        "utterances": len(store), "audio_seconds": store.audio_seconds,
        "chain_seconds": chain_seconds, "wer_percent": wer["pt"],
        "accuracy_log_equal_npz_chain": True, "native_vs_accuracy_edit_rate": rate,
        "native_offline": perf.summary(), "launches": launches,
        "launches_native_loop": perf.launches, "broken_loadgen_build": broken_error,
    })
    emit(out)
    return {"main": launches, "timed_pass": perf.launches}


MD_PACKED_LANES = 1024  # the bench's lanes, 512 per shard on the two-shard mesh
MD_PROBE_N = 32  # utterances the multihost probe stripes over its two ranks


def _hold_sharded(name: str, got, want, rerun=None, compare=None) -> dict:
    """Sharded tokens against the single-device run's: equal, or (kernel
    B sums its products in an order that depends on the lanes of a pass)
    parting only at near-ties, edit rate <= 1e-3, with every kernel-B
    launch of ``rerun()`` (the sharded run again) parting from its twin
    only at a tie (``compare``: tools/decode_divergence.compare_run_launches
    by default)."""
    from rnnt_inference_tpu_torch.tools import decode_divergence

    compare = compare or decode_divergence.compare_run_launches

    rate, n_tok, differ = _edit_rate(got, want)
    out = {"tokens": n_tok, "token_edit_rate_vs_single_device": rate,
           "utterances_differing": differ, "verdict": "equal"}
    if n_tok == 0:
        raise AssertionError(f"{name}: no tokens")
    if rate or any(len(a) != len(b) for a, b in zip(got, want)):
        out["verdict"] = "near-ties"
        if rate > 1e-3 or rerun is None:
            raise AssertionError(f"{name}: sharded vs single-device edit rate {rate}")
        _, partings = compare(rerun)
        out["kernel_b_launches_against_twin"] = partings
        if partings["faults"]:
            raise AssertionError(f"{name}: kernel B parts from its twin outside a tie: "
                                 f"{partings}")
    return out


def phase_multi_device(qweights, params, dev, card: str, seed: int) -> dict:
    """Data parallelism on the card (parallel/mesh.py, the runners' mesh=,
    the slot-sharded Server, tools/multihost_probe.py), the int8 model at
    full width.  (a) A mesh over every visible card: the bucketed runner
    (batch 32) and the packed runner (16 lanes) on 64 utterances, tokens
    equal to the runs without mesh=.  (b) A two-shard mesh [cuda:0,
    cuda:0]: the packed runner at 1,024 lanes (512 per shard) on 2,048
    utterances of 1-4 s, the bucketed runner at batch 32 (16 per shard) on
    the 64, and Server-dp on 32 slots (server_multi_step_dp against
    server_multi_step on the same inserted state): launches per shard;
    tokens held to the single-device run (_hold_sharded), the Server's
    tokens and res_idx equal.  (c) The multihost probe with 2 ranks on
    cuda:0 over gloo (indices a disjoint cover, the merged report the sum
    of the ranks', each rank's tokens equal a single-process run on its
    indices) and a 1-rank NCCL group that runs all_hosts_report.  (d)
    With two or more cards, the two-shard mesh over cuda:0 and cuda:1 and
    the probe over 2 NCCL ranks; with one card a line says it did not
    run.  Launch counts are set to 0 just before each run and read just
    after.  Returns {path: {"main": launches}}."""
    import tempfile

    import torch.distributed as tdist

    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda
    from rnnt_inference_tpu_torch.ops.features import log_mel_features
    from rnnt_inference_tpu_torch.parallel import distributed
    from rnnt_inference_tpu_torch.parallel.mesh import make_mesh, weight_shardings
    from rnnt_inference_tpu_torch.runtime.harness import hex_to_tokens, run_offline
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
    from rnnt_inference_tpu_torch.runtime.server import (
        init_server_state, server_insert, server_multi_step, server_multi_step_dp,
    )
    from rnnt_inference_tpu_torch.tools import multihost_probe

    t_phase = time.time()
    cfg = FeaturizerConfig()
    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda}
    paths, out = {}, {"phase": "multi_device", "card": card, "cards": torch.cuda.device_count()}

    def counted(path, fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        r = fn()
        paths[path] = {"main": {k: c.launches for k, c in counters.items()}}
        if not all(paths[path]["main"].values()):
            raise AssertionError(f"multi_device {path}: launched {paths[path]['main']}")
        return r, time.time() - t0

    store = SampleStore.synthetic(n=64, seed=seed + 20, min_seconds=1.0, max_seconds=15.0)
    qsl = QuerySampleLibrary(store, cfg)
    single = OfflineRunner(qweights, params, cfg, batch_size=32, device=dev)
    single.warmup(qsl)
    ref_bucketed = single.run(qsl)
    packed_single = PackedOfflineRunner(qweights, params, cfg, n_lanes=16, batch_size=16,
                                        device=dev)
    packed_single.stage(qsl)
    ref_packed = packed_single.run_device()

    def same(name, got, want):
        if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"multi_device {name}: tokens differ from the run without mesh=")

    # (a) every visible card
    mesh_all = make_mesh()
    r, sec = counted("multi_device_all_cards_bucketed", lambda: OfflineRunner(
        qweights, params, cfg, batch_size=32, mesh=mesh_all).run(qsl))
    same("all-cards bucketed", r.tokens, ref_bucketed.tokens)
    rp = PackedOfflineRunner(qweights, params, cfg, n_lanes=16, batch_size=16, mesh=mesh_all)
    rp.stage(qsl)
    rpr, sec_p = counted("multi_device_all_cards_packed", rp.run_device)
    same("all-cards packed", rpr.tokens, ref_packed.tokens)
    out["all_cards"] = {"mesh": repr(mesh_all), "bucketed_seconds": sec,
                        "packed_seconds": sec_p, "tokens_equal": True,
                        "shard_launches": {"bucketed": r.shard_launches,
                                           "packed": rpr.shard_launches}}

    # (b) two shards on one card
    two = [torch.device("cuda", 0)] * 2
    mesh2 = make_mesh(devices=two)
    big = SampleStore.synthetic(n=2 * MD_PACKED_LANES, seed=seed + 21, min_seconds=1.0,
                                max_seconds=4.0, mean_seconds=2.0)
    bqsl = QuerySampleLibrary(big, cfg)
    pk = dict(n_lanes=MD_PACKED_LANES, chunk_frames=16, batch_size=MD_PACKED_LANES,
              decode_chunk=128)
    p1 = PackedOfflineRunner(qweights, params, cfg, device=dev, **pk)
    p1.stage(bqsl)
    p1.run_device()  # one-off costs, untimed
    t0 = time.time()
    w1 = p1.run_device()
    pm = PackedOfflineRunner(qweights, params, cfg, mesh=mesh2, **pk)
    pm.stage(bqsl)
    pm.run_device()
    wm, sec_pm = counted("multi_device_two_shard_packed", pm.run_device)
    out["two_shards_packed"] = dict(
        _hold_sharded("two-shard packed", wm.tokens, w1.tokens, pm.run_device),
        utterances=len(big), audio_seconds=big.audio_seconds, lanes=MD_PACKED_LANES,
        single_wall_seconds=w1.wall_seconds, sharded_wall_seconds=wm.wall_seconds,
        launches=paths["multi_device_two_shard_packed"]["main"],
        shard_launches=wm.shard_launches, run_seconds=time.time() - t0)
    bm = OfflineRunner(qweights, params, cfg, batch_size=32, mesh=mesh2)
    rb, sec_b = counted("multi_device_two_shard_bucketed", lambda: bm.run(qsl))
    out["two_shards_bucketed"] = dict(
        _hold_sharded("two-shard bucketed", rb.tokens, ref_bucketed.tokens,
                      lambda: bm.run(qsl)),
        utterances=len(store), batch_size=32, run_seconds=sec_b,
        launches=paths["multi_device_two_shard_bucketed"]["main"],
        shard_launches=rb.shard_launches)

    slots, split = 32, 24
    max_frames = -(-cfg.out_frames(int(15.0 * cfg.sample_rate)) // split) * split
    wav, lens, _ = qsl.assemble_waveforms(np.arange(slots))
    with torch.inference_mode():
        feats, flens = log_mel_features(torch.from_numpy(wav).to(dev),
                                        torch.from_numpy(lens).to(dev), cfg)
        feats, flens = feats[:max_frames], torch.clamp(flens, max=max_frames)

        def inserted():
            st = init_server_state(slots, max_frames, params, cfg,
                                   qweights.pre_rnn[0].w_ih.dtype,
                                   qweights.pred_rnn[0].w_ih.dtype, dev)
            return server_insert(st, feats, flens, torch.arange(slots), params)

        k = max_frames // split
        s1, f1 = server_multi_step(qweights, inserted(), split, k, params)
        shard_w = weight_shardings(mesh2, qweights)
        per_shard = [{}, {}]
        (sm, fm), sec_s = counted("multi_device_server_dp", lambda: server_multi_step_dp(
            mesh2, shard_w, inserted(), split, k, params, shard_launches=per_shard))
    if not bool(f1.all()) or not torch.equal(fm, f1):
        raise AssertionError("multi_device server-dp: slots left unfinished or finish masks differ")
    res_equal = torch.equal(sm.decode.res, s1.decode.res)
    idx_equal = torch.equal(sm.decode.res_idx, s1.decode.res_idx)
    n1 = (s1.decode.res_idx + 1).clamp(max=params.max_res_len).cpu().numpy()
    nm = (sm.decode.res_idx + 1).clamp(max=params.max_res_len).cpu().numpy()
    toks = lambda st, n: [st.decode.res[i, : n[i]].cpu().numpy() for i in range(slots)]
    rate, n_tok, differ = _edit_rate(toks(sm, nm), toks(s1, n1))
    out["server_dp"] = dict(slots=slots, split_len=split, steps=k, run_seconds=sec_s,
                            tokens=n_tok, res_equal=res_equal, res_idx_equal=idx_equal,
                            token_edit_rate_vs_single_device=rate, slots_differing=differ,
                            launches=paths["multi_device_server_dp"]["main"],
                            shard_launches=per_shard)
    if not (res_equal and idx_equal) or n_tok == 0:
        emit(out)
        raise AssertionError(f"multi_device server-dp: res/res_idx differ from the single slot "
                             f"set (edit rate {rate}, slots {differ})")

    # (c) the multihost probe: 2 ranks on one card over gloo; a 1-rank NCCL group
    with tempfile.TemporaryDirectory() as d:
        quant = os.path.join(d, "rnnt_quant.npz")
        checkpoint.save_quant_weights(quant, qweights)
        t0 = time.time()
        rep = multihost_probe.run_cluster(2, MD_PROBE_N, batch=16, hidden=1024, device="cuda",
                                          backend="gloo", quant_in=quant,
                                          out_dir=os.path.join(d, "probe"), min_s=0.0,
                                          timeout=600)
        probe_seconds = time.time() - t0
        ranks = rep["ranks"]
        idx = [r["indices"] for r in ranks]
        if sorted(idx[0] + idx[1]) != list(range(MD_PROBE_N)) or set(idx[0]) & set(idx[1]):
            raise AssertionError(f"multihost probe: rank indices {idx} do not cover the store")
        if (rep["samples"] != sum(r["samples"] for r in ranks) or rep["hosts"] != 2
                or abs(rep["audio_seconds_per_second"]
                       - sum(r["audio_seconds_per_second"] for r in ranks)) > 1e-9 * max(
                           rep["audio_seconds_per_second"], 1.0)):
            raise AssertionError(f"multihost probe: merged {rep} is not the ranks' sum")
        pstore = multihost_probe.probe_store(MD_PROBE_N)
        for r, mine in enumerate(idx):
            with open(os.path.join(d, "probe", f"rank{r}", "accuracy_log.json")) as f:
                got = [hex_to_tokens(e["data"]) for e in json.load(f)]
            one = os.path.join(d, f"one{r}")
            run_offline(qweights, pstore.select(mine), params, cfg, batch_size=16,
                        warmup=False, device=dev, output_dir=one)
            with open(os.path.join(one, "accuracy_log.json")) as f:
                want = [hex_to_tokens(e["data"]) for e in json.load(f)]
            if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"multihost probe: rank {r}'s tokens differ from a "
                                     f"single-process run on its indices")
            if not (ranks[r]["launches"]["quant_lstm_layer"]
                    and ranks[r]["launches"]["decode_step"]):
                raise AssertionError(f"multihost probe: rank {r} launched {ranks[r]['launches']}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        local = {"audio_seconds_per_second": 123.25, "samples": 7}
        merged = distributed.all_hosts_report(local)
        backend = tdist.get_backend()
    finally:
        tdist.destroy_process_group()
    if merged != dict(local, hosts=1) or backend != "nccl":
        raise AssertionError(f"1-rank NCCL all_hosts_report gave {merged} on {backend}")
    out["multihost_probe"] = dict(
        ranks=2, backend="gloo", device="cuda:0", utterances=MD_PROBE_N, seconds=probe_seconds,
        merged={k: rep[k] for k in ("audio_seconds_per_second", "samples", "hosts",
                                    "per_host_wall_seconds", "load_balance_efficiency")},
        rank_launches=[r["launches"] for r in ranks], rank_tokens_equal_single_process=True,
        nccl_one_rank_report=merged)

    # (d) two or more cards
    if torch.cuda.device_count() >= 2:
        meshk = make_mesh(devices=[torch.device("cuda", i) for i in range(2)])
        bk = OfflineRunner(qweights, params, cfg, batch_size=32, mesh=meshk)
        rk, sec_k = counted("multi_device_two_cards_bucketed", lambda: bk.run(qsl))
        repk = multihost_probe.run_cluster(2, MD_PROBE_N, batch=16, hidden=1024,
                                           device="cuda", backend="nccl", min_s=0.0,
                                           quant_in=None, timeout=600)
        if repk["samples"] != MD_PROBE_N or repk["hosts"] != 2:
            raise AssertionError(f"multihost probe over NCCL: {repk}")
        out["two_cards"] = dict(_hold_sharded("two-card bucketed", rk.tokens,
                                              ref_bucketed.tokens, lambda: bk.run(qsl)),
                                run_seconds=sec_k, shard_launches=rk.shard_launches,
                                probe_nccl={k: repk[k] for k in ("samples", "hosts",
                                                                 "load_balance_efficiency")})
    else:
        out["two_cards"] = {"run": False, "why": f"{torch.cuda.device_count()} visible card: "
                            "the mesh over cuda:0..k-1 and 2 NCCL ranks need two or more"}
        print("multi_device (d): not run: one visible card; a mesh over two cards and two "
              "NCCL ranks need two or more", flush=True)
    out["seconds"] = time.time() - t_phase
    emit(out)
    return paths


def phase_transcribe(params, dev, card: str, seed: int) -> dict:
    """The conversion chain and the Transcriber on the card: 8 synthetic
    utterances of 1-4 s written as 16-bit .wav and, through the port's
    encode_flac, as .flac, each with a manifest; convert_librispeech on
    both (samples bit-equal); compute_features_store on the card (frame
    counts equal to the CPU's, finite, max abs difference to the CPU's
    under 1e-3); Transcriber.from_checkpoint of product_chain's seeded
    rnnt.pt at full width in bf16 (kernels C and B; launch counts set to 0
    just before, read just after) and on the twins (impl="reference", no
    launch): transcripts within edit rate 1e-3.  Wall time per step."""
    import tempfile
    import wave

    from rnnt_inference_tpu_torch.data.dataset import (
        SampleStore, compute_features_store, convert_librispeech,
    )
    from rnnt_inference_tpu_torch.data.flac import encode_flac
    from rnnt_inference_tpu_torch.models.weights import init_weights, torch_state_dict_from_weights
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda, lstm_scan_cuda
    from rnnt_inference_tpu_torch.transcribe import Transcriber

    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda,
                "lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda}
    t_phase = time.time()
    seconds = {}
    src = SampleStore.synthetic(n=8, seed=seed + 30, min_seconds=1.0, max_seconds=4.0,
                                mean_seconds=2.5)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        entries = []
        for name, x in zip(src.names, src.samples):
            pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int32)
            stem = name[: -len(".wav")]
            with wave.open(os.path.join(d, stem + ".wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.astype("<i2").tobytes())
            with open(os.path.join(d, stem + ".flac"), "wb") as f:
                f.write(encode_flac(pcm, 16000))
            entries.append({"audio_filepath": stem + ".flac", "duration": len(x) / 16000.0,
                            "transcript": "utterance " + stem})
        for ext in ("flac", "wav"):
            with open(os.path.join(d, f"m_{ext}.json"), "w") as f:
                json.dump([dict(e, audio_filepath=e["audio_filepath"].replace(".flac", "." + ext))
                           for e in entries], f)
        seconds["write"] = time.time() - t0
        t0 = time.time()
        s_flac = convert_librispeech(d, os.path.join(d, "m_flac.json"), "")
        s_wav = convert_librispeech(d, os.path.join(d, "m_wav.json"), os.path.join(d, "s.npz"))
        seconds["convert"] = time.time() - t0
        if len(s_wav) != 8 or not all(np.array_equal(a, b) for a, b in
                                      zip(s_flac.samples, s_wav.samples)):
            raise AssertionError("transcribe: FLAC and wav stores differ")
        t0 = time.time()
        feats = compute_features_store(s_wav, device=dev)
        torch.cuda.synchronize()
        seconds["features_card"] = time.time() - t0
        feats_cpu = compute_features_store(s_wav, device="cpu")
        diff = max(float(np.abs(a - b).max()) for a, b in zip(feats.samples, feats_cpu.samples))
        if (any(a.shape != b.shape for a, b in zip(feats.samples, feats_cpu.samples))
                or not all(np.isfinite(a).all() for a in feats.samples) or diff >= 1e-3):
            raise AssertionError(f"transcribe: card features differ from the CPU's by {diff}")
        weights = init_weights(params, torch.Generator().manual_seed(seed + 11), device="cpu")
        pt = os.path.join(d, "rnnt.pt")
        torch.save({"state_dict": torch_state_dict_from_weights(weights), "epoch": 0}, pt)
        t0 = time.time()
        tk = Transcriber.from_checkpoint(pt, params, device=dev)
        seconds["load"] = time.time() - t0
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        texts = tk.transcribe_batch(s_wav.samples)
        seconds["transcribe_kernels"] = time.time() - t0
        launches = {k: c.launches for k, c in counters.items()}
        if launches["quant_lstm_layer"] or not launches["decode_step"] or not launches[
                "lstm_recurrence"]:
            raise AssertionError(f"transcribe: bf16 Transcriber launched {launches}")
        twins = Transcriber.from_checkpoint(pt, params, device=dev, impl="reference")
        t0 = time.time()
        ref = twins.transcribe_batch(s_wav.samples)
        seconds["transcribe_twins"] = time.time() - t0
        if any(c.launches != launches[k] for k, c in counters.items()):
            raise AssertionError("transcribe: the twins launched a kernel")
    seq = lambda hyps: [np.frombuffer(h.encode(), np.uint8) for h in hyps]  # a char per token
    rate, n_tok, differ = _edit_rate(seq(texts), seq(ref))
    if n_tok == 0 or rate > 1e-3:
        raise AssertionError(f"transcribe: kernels vs twins edit rate {rate} over {n_tok}")
    emit({"phase": "transcribe", "card": card, "utterances": len(s_wav),
          "audio_seconds": s_wav.audio_seconds, "weights": "rnnt.pt, bf16",
          "flac_equals_wav": True, "features_max_abs_diff_card_vs_cpu": diff,
          "tokens": n_tok, "token_edit_rate_vs_twins": rate, "utterances_differing": differ,
          "launches": launches, "seconds": dict(seconds, phase=time.time() - t_phase)})
    return {"transcribe": {"main": launches}}


# the bench phase's cuts from the JAX headline defaults (BENCH_N 8192,
# BENCH_MIN_S 20): both runs together within about 240 s
BENCH_CUTS = {"BENCH_N": "2048", "BENCH_MIN_S": "10"}
BENCH_RUNS = {
    "blank_cap1": {},  # the headline: int8, packed, cap 1, blank rate 0.8
    "burst_cap30": {"BENCH_EMISSION": "burst", "BENCH_SYM_CAP": "30"},
}


def phase_bench(card: str) -> dict:
    """The port's bench, ``python -m rnnt_inference_tpu_torch.bench`` in a
    child process, at the JAX headline configuration (int8, packed, cap 1,
    blank rate 0.8) and at cap 30 with the burst emission model, each with
    BENCH_CUTS.  Each run must print one JSON line with a value > 0, log a
    calibrated rate within 2x of its target (the JAX bench's band) and the
    decode-iteration line, and launch kernels A and B in its timed rep.
    Returns {run: (weights' replay values, payload)}."""
    import re

    torch.cuda.empty_cache()  # the card is the child's while it runs
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, extra in BENCH_RUNS.items():
        env = dict(os.environ, **BENCH_CUTS, **extra)
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "rnnt_inference_tpu_torch.bench"], cwd=root,
                           env=env, capture_output=True, text=True, timeout=600)
        seconds = time.time() - t0
        sys.stderr.write(r.stderr[-6000:])
        lines = r.stdout.splitlines()
        if r.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"bench {name}: rc {r.returncode}, stdout {r.stdout[-2000:]!r}")
        payload = json.loads(lines[0])
        proto = payload["protocol"]
        m = re.search(r"(blank|burst)-bias: using amp=(\S+) delta=(\S+)(?: kappa=(\S+))? "
                      r"\(([0-9.]+) sym", r.stderr)
        if payload["value"] <= 0 or "error" in payload or m is None:
            raise AssertionError(f"bench {name}: {payload}, calibration logged: {bool(m)}")
        rate, target = float(m.group(5)), proto["calibration"]["target"]
        if not 0.5 * target <= rate <= 2.0 * target:
            raise AssertionError(f"bench {name}: calibrated rate {rate} outside 2x of {target}")
        if ("decode iterations (model of the bucketed batch_plan):" not in r.stderr
                or "decode iterations (timed rep):" not in r.stderr):
            raise AssertionError(f"bench {name}: no decode-iteration lines in the log")
        if not proto["launches"]["quant_lstm_layer"] or not proto["launches"]["decode_step"]:
            raise AssertionError(f"bench {name}: the timed rep launched {proto['launches']}")
        replay = ":".join(m.group(i) for i in (2, 3, 4) if m.group(i) is not None)
        emit({"phase": f"bench_{name}", "card": card, "cuts": BENCH_CUTS, "env": extra,
              "seconds": seconds, "value": payload["value"], "reps": proto["reps"],
              "calibrated_rate": rate, "target_rate": target, "replay": replay,
              "phase_ms": proto["phase_ms"],
              "launched_decode_iterations": proto["launched_decode_iterations"],
              "payload": payload})
        out[name] = (replay, payload)
    return out


BENCH_LANES = 1024  # the bench's BENCH_BATCH default, not cut


def _bench_model(name: str, replay: str, params, dev):
    """The model of bench run ``name`` as bench.run builds it (seeded int8
    weights from a synthetic calibration, max_res_len 512, the run's cap),
    with the emission bias that the bench phase calibrated on the card
    replayed.  Returns (weights, params, buckets)."""
    import dataclasses

    from rnnt_inference_tpu_torch import bench
    from rnnt_inference_tpu_torch.config import FeaturizerConfig

    cap = int(BENCH_RUNS[name].get("BENCH_SYM_CAP", bench.KNOB_DEFAULTS["BENCH_SYM_CAP"]))
    bparams = dataclasses.replace(params, max_res_len=512, max_symbols_per_step=cap)
    cfg = FeaturizerConfig()
    w = bench.build_weights("quant", bparams, cfg, dev)
    if BENCH_RUNS[name].get("BENCH_EMISSION", "blank") == "burst":
        w, _ = bench.bias_joint_burst(w, bparams, cfg, fixed=replay)
    else:
        w, _ = bench.bias_joint_toward_blank(w, bparams, cfg, fixed_delta=replay)
    buckets = tuple(float(x) for x in bench.KNOB_DEFAULTS["BENCH_SECONDS"].split(","))
    return w, bparams, buckets


def phase_bench_twins(params, dev, card: str, benches: dict, store) -> dict:
    """Kernels A and B at the shapes of the bench's runs, against their
    plain versions: each bench configuration (its calibrated bias replayed,
    the bench phase's store of BENCH_N utterances, 1,024 lanes, 16-frame
    chunks, 128-frame decode pieces) through PackedOfflineRunner on the
    kernels (launch counts set to 0 just before, read just after; A five
    times per chunk), on the twins (impl="reference", no launch) and on the
    twins with kernel B's products summed in another order (two plain
    versions of one function).  The bench's emission models put decisions
    at logit ties, where plain versions that differ only in summation
    order part: the kernel's token edit rate against the twins may be at
    most twice that of the two plain versions (and 1e-3 where they
    agree).  Then every
    kernel-B launch of a timed rep against K twin iterations from the
    state it starts from (tools/decode_divergence.compare_run_launches):
    every lane that parts does so at a near-tie or a product tie, the other
    lanes end within kernel B's per-step tolerances, and each launch
    repeats bit for bit.  Returns {run: launches}."""
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda
    from rnnt_inference_tpu_torch.runtime.harness import run_offline
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.tools import decode_divergence

    cfg = FeaturizerConfig()
    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda}
    seq = lambda hyps: [np.frombuffer(h.encode(), np.uint8) for h in hyps]  # a char per token
    out = {}
    for name, (replay, _payload) in benches.items():
        w, bparams, buckets = _bench_model(name, replay, params, dev)
        runs, seconds, launches, runners = {}, {}, {}, {}
        for tag, impl in (("kernels", None), ("twins", "reference"),
                          ("twins_other_order", "reference")):
            runners[tag] = PackedOfflineRunner(w, bparams, cfg, n_lanes=BENCH_LANES,
                                               chunk_frames=16, decode_chunk=128,
                                               batch_size=BENCH_LANES, device=dev, impl=impl)
            order = (decode_divergence.summed_in_halves() if tag == "twins_other_order"
                     else contextlib.nullcontext())
            for c in counters.values():
                c.launches = 0
            lstm_cuda.quant_lstm_layer_cuda.hoisted = 0
            t0 = time.time()
            with order:
                runs[tag] = run_offline(w, store, bparams, cfg, batch_size=BENCH_LANES,
                                        runner=runners[tag], wav_buckets_s=buckets, packed=True,
                                        warmup=impl is None, device=dev)
            seconds[tag] = time.time() - t0
            launches[tag] = {k: c.launches for k, c in counters.items()}
            if impl is None:
                hoisted = lstm_cuda.quant_lstm_layer_cuda.hoisted
        rk = runs["kernels"]
        layers = bparams.pre_num_layers + bparams.post_num_layers
        if (rk.launches["quant_lstm_layer"] != layers * rk.extra["pack_chunks"]
                or not rk.launches["decode_step"]):
            raise AssertionError(f"bench_twins {name}: the timed rep launched {rk.launches}")
        if any(launches["twins"].values()) or any(launches["twins_other_order"].values()):
            raise AssertionError(f"bench_twins {name}: the twins launched {launches}")
        hyps = {tag: seq(r.hypotheses) for tag, r in runs.items()}
        rate, n_tok, differ = _edit_rate(hyps["kernels"], hyps["twins"])
        floor, _, differ_floor = _edit_rate(hyps["twins_other_order"], hyps["twins"])
        rate_other, _, _ = _edit_rate(hyps["kernels"], hyps["twins_other_order"])
        if n_tok == 0 or rate > max(1e-3, 2 * floor):
            raise AssertionError(f"bench_twins {name}: token edit rate {rate} against the twins "
                                 f"over {n_tok} tokens; two plain versions part by {floor}")
        # every kernel-B launch of a timed rep against its twin
        _, partings = decode_divergence.compare_run_launches(runners["kernels"].run_device)
        if partings["faults"] or partings["launches"] != rk.launches["decode_step"]:
            raise AssertionError(f"bench_twins {name}: kernel B parts from its twin outside a "
                                 f"tie: {partings}")
        emit({"phase": f"bench_twins_{name}", "card": card, "replay": replay,
              "utterances": len(store), "audio_seconds": store.audio_seconds,
              "lanes": BENCH_LANES, "max_symbols_per_step": bparams.max_symbols_per_step,
              "tokens": n_tok, "token_edit_rate_vs_twins": rate,
              "utterances_differing_vs_twins": len(differ),
              "token_edit_rate_twins_other_order_vs_twins": floor,
              "utterances_differing_twins_other_order_vs_twins": len(differ_floor),
              "token_edit_rate_vs_twins_other_order": rate_other,
              "kernel_b_launches_against_twin": partings,
              "pack_chunks": rk.extra["pack_chunks"],
              "launches": launches["kernels"], "launches_per_timed_rep": rk.launches,
              "kernel_a_hoisted_share": hoisted / launches["kernels"]["quant_lstm_layer"],
              "audio_seconds_per_second": rk.audio_seconds_per_second,
              "ms": {k: v * 1e3 for k, v in rk.phase_seconds.items()},
              "run_seconds": seconds})
        out[name] = launches["kernels"]
    return out


def phase_fake_quant(dev, card: str) -> dict:
    """The fake_quant run mode through the CLI: f32 weights (seed 5) and
    their calibration saved, then ``main --run_mode fake_quant --calib_in
    ... --accuracy`` on 8 synthetic utterances of 1-4 s, on the card
    (kernel B's f32 instantiation; the encoder is eager PyTorch, no
    kernel) and with --device cpu (the twins): token edit rate <= 1e-3."""
    import tempfile

    from rnnt_inference_tpu_torch import main as cli
    from rnnt_inference_tpu_torch.config import RNNTParams
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.models.weights import init_weights
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda, lstm_scan_cuda

    counters = {"decode_step": decode_cuda.decode_step_cuda,
                "quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda}
    logs, seconds = {}, {}
    with tempfile.TemporaryDirectory() as d:
        paths = {k: os.path.join(d, f"{k}.npz") for k in ("store", "weights", "calib")}
        store = SampleStore.synthetic(n=8, seed=9, min_seconds=1.0, max_seconds=4.0,
                                      mean_seconds=2.5)
        store.save(paths["store"])
        checkpoint.save_weights(paths["weights"], init_weights(
            RNNTParams(), torch.Generator().manual_seed(5), device="cpu"))
        common = ["--model", paths["weights"], "--batch_size", "8"]
        with contextlib.redirect_stdout(sys.stderr):
            cli.main(common + ["--run_mode", "f32", "--calibration", "--calib_file",
                               paths["store"], "--calib_out", paths["calib"]])
            for where in ("cuda", "cpu"):
                out = os.path.join(d, where)
                for c in counters.values():
                    c.launches = 0
                t0 = time.time()
                cli.main(common + ["--run_mode", "fake_quant", "--calib_in", paths["calib"],
                                   "--accuracy", "--sample_file", paths["store"],
                                   "--output_dir", out, "--device", where])
                seconds[where] = time.time() - t0
                launches = {k: c.launches for k, c in counters.items()}
                with open(os.path.join(out, "accuracy_log.json")) as f:
                    logs[where] = {e["qsl_idx"]: np.frombuffer(bytes.fromhex(e["data"]), "<i4")
                                   for e in json.load(f)}
                if where == "cuda":
                    card_launches = launches
                    if (not launches["decode_step"] or launches["quant_lstm_layer"]
                            or launches["lstm_recurrence"]):
                        raise AssertionError(f"fake_quant on the card launched {launches}")
                elif any(launches.values()):
                    raise AssertionError(f"fake_quant with --device cpu launched {launches}")
    n = len(store)
    rate, n_tok, differ = _edit_rate([logs["cuda"][i] for i in range(n)],
                                     [logs["cpu"][i] for i in range(n)])
    if n_tok == 0 or rate > 1e-3:
        raise AssertionError(f"fake_quant card vs twins token edit rate {rate} ({n_tok} tokens)")
    emit({"phase": "fake_quant", "card": card, "utterances": n,
          "audio_seconds": store.audio_seconds, "tokens": n_tok, "token_edit_rate": rate,
          "utterances_differing": differ, "launches": card_launches,
          "seconds": seconds})
    return card_launches


def _profile_row(trace: str, audio_seconds_per_second: float) -> dict:
    """The idle share of the timed reps in a trace (the last rep's, and
    each rep's): 1 - (union of kernel intervals) / (the rep's window), and
    with copies and fills counted as busy; the kernels that took the most
    device time."""
    from rnnt_inference_tpu_torch.utils import profiler

    events = profiler.load_trace(trace)
    spans = profiler.device_idle_share(events)
    if not spans or not any(s["busy_us"] for s in spans):
        raise AssertionError(f"{trace}: no timed rep with device kernels ({len(spans)} spans)")
    busy_all = profiler.device_idle_share(events, cats=profiler.DEVICE_CATS)
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"idle_share": spans[-1]["idle_share"],
            "idle_share_by_rep": [sp["idle_share"] for sp in spans],
            "idle_share_with_copies": busy_all[-1]["idle_share"],
            "window_ms": spans[-1]["window_us"] / 1e3, "kernel_busy_ms": spans[-1]["busy_us"] / 1e3,
            "timed_reps": len(spans), "trace_events": len(events),
            "trace_mb": os.path.getsize(trace) / 2**20,
            "profiled_audio_seconds_per_second": audio_seconds_per_second,
            "top_kernels_us_whole_trace": {k: round(v, 1) for k, v in top}}


def phase_profile(qweights, params, dev, card: str, blank_replay: str, store) -> dict:
    """The device's idle share over a timed rep, from torch.profiler traces
    (utils/profiler.py): ``main --run_mode quant --quant_in <int8 weights>
    --packed --benchmark --synthetic 64 --batch_size 16 --profiler_dir``
    (the packed_int8 cell, random weights at cap 30); then the bench's
    headline configuration (int8 bench weights with the blank bias the
    bench phase calibrated, cap 1, max_res_len 512, packed on 1,024 lanes,
    the bench phase's store) through run_offline inside device_trace, for
    at least 1 s of timed reps, every rep's tokens equal (a rep leaves no
    state that changes the next)."""
    import tempfile

    from rnnt_inference_tpu_torch import main as cli
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.runtime.harness import run_offline
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.utils import profiler

    rows = {}
    with tempfile.TemporaryDirectory() as d:
        quant = os.path.join(d, "rnnt_quant.npz")
        checkpoint.save_quant_weights(quant, qweights)
        trace_dir = os.path.join(d, "cli")
        argv = ["--run_mode", "quant", "--quant_in", quant, "--packed", "--benchmark",
                "--synthetic", "64", "--batch_size", "16", "--output_dir", d,
                "--profiler_dir", trace_dir]
        with contextlib.redirect_stdout(sys.stderr):
            rep = cli.main(argv)
        rows["packed_int8_cli"] = dict(
            _profile_row(os.path.join(trace_dir, profiler.TRACE_FILE),
                         rep.audio_seconds_per_second),
            argv=argv[:3] + ["<tmp>"] + argv[4:-4] + ["--profiler_dir", "<tmp>"],
            phase_ms={k: v * 1e3 for k, v in rep.phase_seconds.items()})

        w, bparams, buckets = _bench_model("blank_cap1", blank_replay, params, dev)
        cfg = FeaturizerConfig()
        runner = PackedOfflineRunner(w, bparams, cfg, n_lanes=BENCH_LANES,
                                     batch_size=BENCH_LANES, device=dev)
        tokens, run_device = [], runner.run_device

        def recorded():  # every rep's tokens, the untimed one included
            r = run_device()
            tokens.append(r.tokens)
            return r

        runner.run_device = recorded
        with profiler.device_trace(os.path.join(d, "bench"), dev) as path:
            rb = run_offline(w, store, bparams, cfg, batch_size=BENCH_LANES, runner=runner,
                             wav_buckets_s=buckets, packed=True, device=dev, min_duration_s=1.0)
        same = all(np.array_equal(a, b) for t in tokens[1:] for a, b in zip(t, tokens[0]))
        if len(tokens) < 3 or not same:
            raise AssertionError(f"{len(tokens)} packed reps, tokens equal across reps: {same}")
        rows[f"bench_blank_cap1_n{len(store)}_lanes{BENCH_LANES}"] = dict(
            _profile_row(path, rb.audio_seconds_per_second), blank_replay=blank_replay,
            reps_with_equal_tokens=len(tokens),
            phase_ms={k: v * 1e3 for k, v in rb.phase_seconds.items()})
    emit({"phase": "profile", "card": card, **rows})
    return rows


# the server_probe phase: the ladder on the native clock, each level for
# PROBE_SECONDS under a user.conf that cuts min_duration to PROBE_SECONDS
# and min_query_count to qps x PROBE_SECONDS; the JAX probe's slots, split
# and store size
PROBE_LEVELS = (25.0, 50.0, 100.0, 200.0, 400.0, 800.0)
PROBE_SECONDS = 6.0
PROBE_SLOTS, PROBE_SPLIT, PROBE_N = 128, 24, 512
PROBE_DEPTH = 16  # run_server_native's default, the product's
KEEP_LEVEL = ("target_qps", "issued", "completed", "latency_ms_p50", "latency_ms_p90",
              "latency_ms_p99", "qps", "wall_seconds", "result_validity", "invalid_reasons",
              "launches", "pipeline_depth", "inflight_window", "extract_calls", "extract_ms",
              "host_ms")


@contextlib.contextmanager
def _host_timed(runner, server_probe):
    """Time the host's parts of each ladder level: every level that
    ``server_probe.probe_level`` returns meanwhile carries host_ms, the
    wall (ms) and calls inside the arrival poll (``NativeLoadGen.poll``,
    which blocks up to 500 us when nothing has arrived), ``insert_samples``
    (featurizing and inserting; enqueued, not waited for),
    ``step_async`` (enqueueing a dispatch), the finish-mask reads
    (``FinishMask.cpu``, waiting for a dispatch) and ``extract`` (which
    reads the newest state, so it waits for every dispatch enqueued); and
    extract_calls and extract_ms on their own."""
    from rnnt_inference_tpu_torch.runtime import native, server

    acc = {}

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                calls, secs = acc.get(name, (0, 0.0))
                acc[name] = (calls + 1, secs + time.perf_counter() - t0)
        return run

    real_level = server_probe.probe_level
    real = dict(poll=native.NativeLoadGen.poll, mask_read=server.FinishMask.cpu)

    def level(*args, **kw):
        acc.clear()
        lv, results = real_level(*args, **kw)
        lv["host_ms"] = {k: dict(calls=c, ms=t * 1e3) for k, (c, t) in sorted(acc.items())}
        lv.update(extract_calls=acc.get("extract", (0, 0.0))[0],
                  extract_ms=acc.get("extract", (0, 0.0))[1] * 1e3)
        return lv, results

    for name in ("extract", "insert_samples", "step_async"):
        setattr(runner, name, timed(name, getattr(runner, name)))
    native.NativeLoadGen.poll = timed("poll", real["poll"])
    server.FinishMask.cpu = timed("mask_read", real["mask_read"])
    server_probe.probe_level = level
    try:
        yield
    finally:
        for name in ("extract", "insert_samples", "step_async"):
            delattr(runner, name)  # the class's methods again
        native.NativeLoadGen.poll, server.FinishMask.cpu = real["poll"], real["mask_read"]
        server_probe.probe_level = real_level


SYNC_DISPATCHES = 50  # step_async dispatches under sync debug mode "error"
TOKENS_QPS = 200.0  # a level below the ladders' highest VALID one at either depth
OFFLINE_N, OFFLINE_CYCLES = 128, 4  # the native packed Offline runs by max_inflight_cycles


def phase_server_pipelined(w, bparams, store, settings_for, counters, card: str,
                           probe_out: dict, dev) -> dict:
    """The Server's pipelined dispatch on server_probe's model (the bench's
    calibrated blank model) in a runner of its own (128 slots, split 24: a
    level cut short by its wall limit leaves slots behind), with the launch
    counts set to 0 just before and read just after:
      1. no sync: SYNC_DISPATCHES ``step_async`` dispatches, an 8-slot
         insert before each while a slot is free, under
         ``torch.cuda.set_sync_debug_mode("error")`` (a host synchronization
         raises); then the masks are read and the finished slots extracted;
      2. tokens: the native Server at depth 16 and at depth 1 on the same
         Poisson arrivals (seed 0) at TOKENS_QPS: equal per query (a parting
         raises, with whether the query's features were equal);
      3. the ladder at depth 1 beside server_probe's at depth 16 (same
         levels, same rules, stopping after the first INVALID level once
         three ran), with each level's time inside ``extract``;
      4. native Offline, packed, at max_inflight_cycles 1, 4, 4, 1 on the
         store's first OFFLINE_N utterances (OFFLINE_CYCLES cycles): equal
         hypotheses, audio-s/s of each.
    Emits one line, phase "server_pipelined"; returns its launch counts."""
    from rnnt_inference_tpu_torch.runtime.harness import run_offline_native
    from rnnt_inference_tpu_torch.runtime.server import ServerRunner
    from rnnt_inference_tpu_torch.tools import server_probe

    t_phase = time.time()
    runner = ServerRunner(w, bparams, slots=PROBE_SLOTS, split_len=PROBE_SPLIT, device=dev)
    runner.warmup()
    for c in counters.values():
        c.launches = 0
    # 1. no host synchronization on the insert and step paths
    torch.cuda.synchronize()
    masks, nxt = [], 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for _ in range(SYNC_DISPATCHES):
            k = min(runner.insert_batch, len(runner.free_slots))
            if k:
                runner.insert_samples([store.samples[i] for i in range(nxt, nxt + k)],
                                      list(range(nxt, nxt + k)))
                nxt += k
            masks.append(runner.step_async())
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t0 = time.perf_counter()
    finished = [np.nonzero(m.cpu().numpy())[0] for m in masks]
    read_s = time.perf_counter() - t0
    done = {}
    for f in finished:
        if len(f):
            done.update(runner.extract(f))
    while runner.n_active:
        done.update(runner.extract(runner.step()))
    if sorted(done) != list(range(nxt)):
        raise AssertionError(f"server_pipelined: {len(done)} of {nxt} inserted samples came back")
    sync_check = dict(dispatches=SYNC_DISPATCHES, inserted=nxt, syncs=0,
                      enqueue_ms_per_dispatch=enqueue_s * 1e3 / SYNC_DISPATCHES,
                      mask_read_ms=read_s * 1e3,
                      finished=int(sum(len(f) for f in finished)))

    # 2. the same arrivals at depth 16 and at depth 1: tokens equal per query
    runs, feats = {}, {}
    insert = runner.insert_samples
    for depth in (PROBE_DEPTH, 1):
        feats[depth] = {}

        def keeping_features(wavs, ids, kept=feats[depth]):
            insert(wavs, ids)  # each query's features as its slot holds them, not read back
            for slot, q in runner.slot_sample.items():
                if q in ids and q >= 0:
                    kept[q] = (runner.state.F[:, slot].clone(), runner.state.F_lens[slot].clone())

        runner.insert_samples = keeping_features
        try:
            level, results = server_probe.probe_level(
                runner, store, TOKENS_QPS, PROBE_SECONDS, settings_for(TOKENS_QPS), native=True,
                pipeline_depth=depth)
        finally:
            runner.insert_samples = insert
        if level["completed"] != level["issued"] or level["result_validity"] != "VALID":
            raise AssertionError(f"server_pipelined depth {depth} at {TOKENS_QPS} QPS: "
                                 f"{ {k: level.get(k) for k in KEEP_LEVEL} }")
        runs[depth] = (level, results)
    got, want = runs[PROBE_DEPTH][1], runs[1][1]
    if sorted(got) != sorted(want):
        raise AssertionError(f"server_pipelined: depth 16 answered {len(got)} queries, "
                             f"depth 1 {len(want)}")
    same_features = lambda a, b: bool(torch.equal(a[1], b[1]) and torch.equal(a[0], b[0]))
    parted = {q: dict(tokens=(len(got[q]), len(want[q])),
                      features_equal=same_features(feats[PROBE_DEPTH][q], feats[1][q]))
              for q in sorted(got) if not np.array_equal(got[q], want[q])}
    if parted:
        raise AssertionError(f"server_pipelined: {len(parted)} of {len(got)} queries part "
                             f"between depth 16 and depth 1: {parted}")
    n_tok = sum(len(t) for t in got.values())

    # 3. the ladder at depth 1, beside server_probe's at depth 16
    ladder1 = []
    with _host_timed(runner, server_probe):
        for qps in PROBE_LEVELS:
            level, _ = server_probe.probe_level(runner, store, qps, PROBE_SECONDS,
                                                settings_for(qps), native=True, pipeline_depth=1)
            ladder1.append(level)
            if level["result_validity"] != "VALID" and len(ladder1) >= 3:
                break
    for lv in ladder1:
        if lv["completed"] != lv["issued"]:
            raise AssertionError(f"server_pipelined depth 1 at {lv['target_qps']}: completed "
                                 f"{lv['completed']} of {lv['issued']}")
    valid1 = [lv["target_qps"] for lv in ladder1 if lv["result_validity"] == "VALID"]

    # 4. native packed Offline by max_inflight_cycles
    ostore = store.select(np.arange(OFFLINE_N))
    offline, hyps = [], {}
    for cycles in (1, 4, 4, 1):
        rep = run_offline_native(w, ostore, bparams, batch_size=OFFLINE_N, packed=True,
                                 min_query_count=OFFLINE_N * OFFLINE_CYCLES,
                                 max_inflight_cycles=cycles, device=runner.device)
        if rep.samples != OFFLINE_N * OFFLINE_CYCLES:
            raise AssertionError(f"server_pipelined offline: {rep.samples} samples")
        hyps.setdefault(cycles, rep.hypotheses)
        if rep.hypotheses != hyps[cycles] or rep.hypotheses != hyps[1]:
            raise AssertionError("server_pipelined offline: the hypotheses part between "
                                 "max_inflight_cycles 1 and 4")
        offline.append(dict(max_inflight_cycles=cycles, wall_seconds=rep.wall_seconds,
                            audio_seconds_per_second=rep.audio_seconds_per_second,
                            launches=rep.launches))
    launches = {k: c.launches for k, c in counters.items()}
    if not all(launches.values()):
        raise AssertionError(f"server_pipelined: launches {launches}")
    cad = probe_out["cadence"]
    emit({"phase": "server_pipelined", "card": card, "sync_check": sync_check,
          "tokens": {"qps": TOKENS_QPS, "queries": len(got), "tokens": n_tok, "parted": 0,
                     "levels": [{k: runs[d][0].get(k) for k in KEEP_LEVEL} for d in runs]},
          "ladder_depth16": [{k: lv.get(k) for k in KEEP_LEVEL} for lv in probe_out["ladder"]],
          "ladder_depth1": [{k: lv.get(k) for k in KEEP_LEVEL} for lv in ladder1],
          "highest_valid_qps": {"depth16": probe_out["highest_valid_qps"],
                                "depth1": max(valid1) if valid1 else None},
          "cadence_sync": {k: cad[k] for k in ("wall_ms_per_step", "event_ms_per_step",
                                               "kernel_busy_ms_per_step", "host_share")},
          "cadence_step_async": cad["step_async"],
          "offline_packed": offline, "launches": launches,
          "seconds": time.time() - t_phase})
    return {"main": launches, "timed_pass": launches}


def _streaming_parting(w, params, qsl, batch_size: int, q: int, feats, server_tokens,
                       offline_tokens, split: int, slots: int, dev) -> dict:
    """Where query q's Server tokens part from the bucketed Offline
    runner's.  Kernel A is bit-equal to its twin, so from equal features
    both runs have the same encoder output f; what differs is the shape
    of two sums: the joint's projection fproj = f @ w1_trans (kernel E), of
    (split / 2) x slots rows in a Server window and T2 x batch_size in the
    Offline batch, and kernel B's, which sum a lane's products in an order
    that can depend on the lane count (64 lanes against 1 or 2 on an H100:
    PERF.md).
    Both projections are rebuilt for q (the Offline batch as the runner
    forms it; the Server's from the features its slot held, a window at a
    time in a window-shaped GEMM), and tools/decode_divergence.py
    compare_fproj_lanes decodes each in its run's lane count side by side:
    they must reproduce both runs' tokens, and part at a near-tie."""
    from rnnt_inference_tpu_torch.models import rnnt as model
    from rnnt_inference_tpu_torch.ops import decode_cuda
    from rnnt_inference_tpu_torch.ops.features import log_mel_features
    from rnnt_inference_tpu_torch.ops.projection_cuda import project
    from rnnt_inference_tpu_torch.tools import decode_divergence

    w1 = w.joint.w1_trans
    order = qsl.sort_desc(np.arange(len(qsl)))
    start = int(np.nonzero(order == q)[0][0]) // batch_size * batch_size
    batch = order[start : start + batch_size]
    row = int(np.nonzero(batch == q)[0][0])
    with torch.inference_mode():
        wav, lens, _ = qsl.assemble_waveforms(batch, pad_n=batch_size)
        x, x_lens = log_mel_features(torch.from_numpy(wav).to(dev), torch.from_numpy(lens).to(dev),
                                     qsl.cfg)
        f, _ = model.transcription(w, x, x_lens, model.init_encoder_state(
            batch_size, params, w.pre_rnn[0].w_ih.dtype, dev), params)
        f_len = -(-int(x_lens[row]) // params.stack_time_factor)
        fproj_off = project(f.to(w1.dtype), w1)[:f_len, row]
        xs = feats[:, None]
        fs, _ = model.transcription(w, xs, torch.tensor([xs.shape[0]], dtype=torch.int32,
                                                        device=dev),
                                    model.init_encoder_state(1, params, w.pre_rnn[0].w_ih.dtype,
                                                             dev), params)
        t2 = split // params.stack_time_factor
        windows = []
        for k in range(0, fs.shape[0], t2):
            win = torch.zeros((t2, slots, fs.shape[2]), dtype=fs.dtype, device=dev)
            win[: min(t2, fs.shape[0] - k), 0] = fs[k : k + t2, 0]
            windows.append(project(win.to(w1.dtype), w1)[:, 0])
        fproj_srv = torch.cat(windows)[:f_len]
        r = decode_divergence.compare_fproj_lanes(fproj_srv, fproj_off, f_len,
                                                  decode_cuda.decode_weights(w), params,
                                                  lane_counts=(slots, batch_size))
    tokens = r.pop("tokens")
    r.update(reproduced=bool(np.array_equal(tokens[0], server_tokens)
                             and np.array_equal(tokens[1], offline_tokens)),
             server_tokens=len(server_tokens), offline_tokens=len(offline_tokens),
             features_equal_offline=bool(torch.equal(feats, x[: feats.shape[0], row])
                                         and feats.shape[0] == int(x_lens[row])),
             fproj_max_abs_diff=float((fproj_srv - fproj_off).abs().max()))
    return r


def phase_server_probe(params, dev, card: str, blank_replay: str, store) -> dict:
    """tools/server_probe.py on the bench's calibrated blank model
    (``_bench_model("blank_cap1", ...)``: int8, cap 1, the blank bias the
    bench phase calibrated, 0.8 symbols per frame), 128 slots, split 24, the
    first 512 utterances of the bench's store: the step cadence, then the
    ladder PROBE_LEVELS on the native clock, each level PROBE_SECONDS under
    a user.conf overlay (min_duration = PROBE_SECONDS, min_query_count =
    qps x PROBE_SECONDS; configs/mlperf.conf below it), stopping after the
    first INVALID level once three levels ran, at pipeline depth 16 (launch
    counts set to 0 just before the ladder, read just after; each level's
    host time in the poll, the inserts, the dispatches, the mask reads and
    ``extract`` beside it).  Then the highest VALID level and
    the lowest level again on the Python clock (inflight_window 8), and
    phase ``server_pipelined``.  Gates: completed = issued
    at every level, kernels A and B launched, and the lowest level's
    Python-clock tokens equal to the bucketed OfflineRunner's on the same
    samples (the streaming invariant: a Server slot decodes its utterance
    in split-frame windows, the Offline runner in one pass)."""
    import tempfile

    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda
    from rnnt_inference_tpu_torch.runtime.config import TestSettings
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
    from rnnt_inference_tpu_torch.runtime.server import ServerRunner
    from rnnt_inference_tpu_torch.tools import server_probe

    t_phase = time.time()
    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda}
    mlperf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "mlperf.conf")
    w, bparams, _ = _bench_model("blank_cap1", blank_replay, params, dev)
    store = store.select(np.arange(PROBE_N))
    runner = ServerRunner(w, bparams, slots=PROBE_SLOTS, split_len=PROBE_SPLIT, device=dev)
    warm = runner.warmup()
    with tempfile.TemporaryDirectory() as d:

        def settings_for(qps):
            conf = _write_conf(os.path.join(d, f"probe_{qps:g}.conf"), "Server", PROBE_N,
                               min_duration=int(PROBE_SECONDS * 1000),
                               min_query_count=int(qps * PROBE_SECONDS))
            return TestSettings.from_conf(mlperf, conf, "rnnt", "Server")

        for c in counters.values():
            c.launches = 0
        with _host_timed(runner, server_probe):
            out = server_probe.probe(runner, store, PROBE_LEVELS, PROBE_SECONDS, settings_for,
                                     native=True, stop_after_invalid=True, min_levels=3,
                                     pipeline_depth=PROBE_DEPTH)
        launches = {k: c.launches for k, c in counters.items()}
        ladder = out["ladder"]
        for lv in ladder:
            if lv["completed"] != lv["issued"] or not all(lv["launches"][k] for k in counters):
                raise AssertionError(f"server_probe level {lv['target_qps']}: completed "
                                     f"{lv['completed']} of {lv['issued']}, launches "
                                     f"{lv['launches']}")
        if len(ladder) < 3 or not all(launches.values()):
            raise AssertionError(f"server_probe: {len(ladder)} levels, launches {launches}")
        lowest, highest = PROBE_LEVELS[0], out["highest_valid_qps"]
        python_clock, feats = {}, {}
        insert = runner.insert_samples

        def insert_keeping_features(wavs, ids):  # each query's features, as its slot holds them
            insert(wavs, ids)
            for slot, q in runner.slot_sample.items():
                if q in ids and q >= 0:
                    feats[q] = runner.state.F[: int(runner.state.F_lens[slot]), slot].clone()

        for qps in sorted({lowest} | ({highest} if highest else set()), reverse=True):
            if qps == lowest:  # the level whose tokens are held to the Offline runner's
                runner.insert_samples = insert_keeping_features
            level, results = server_probe.probe_level(runner, store, qps, PROBE_SECONDS,
                                                      settings_for(qps), native=False)
            if level["completed"] != level["issued"]:
                raise AssertionError(f"server_probe python clock {qps}: completed "
                                     f"{level['completed']} of {level['issued']}")
            python_clock[qps] = (level, results)
        runner.insert_samples = insert
        pipelined = phase_server_pipelined(w, bparams, store, settings_for, counters, card, out,
                                           dev)
    # the streaming invariant: the lowest level's tokens against the
    # bucketed Offline runner on its samples
    level, results = python_clock[lowest]
    m = min(len(store), int(lowest * PROBE_SECONDS))
    qsl = QuerySampleLibrary(store.select(np.arange(m)))
    offline = OfflineRunner(w, bparams, batch_size=64, device=dev)
    offline.warmup(qsl)
    ref = offline.run(qsl).tokens
    n_tok = sum(len(results[q]) for q in results)
    parted = {q: _streaming_parting(w, bparams, qsl, offline.batch_size, q, feats[q],
                                    results[q], ref[q], PROBE_SPLIT, PROBE_SLOTS, dev)
              for q in sorted(results) if not np.array_equal(results[q], ref[q])}
    faults = {q: r for q, r in parted.items() if not (r["near_tie"] and r["reproduced"])}
    if faults or n_tok == 0:
        raise AssertionError(f"server_probe: the Server's tokens part from the bucketed "
                             f"Offline runner's outside a near-tie: {faults} ({len(parted)} "
                             f"of {len(results)} queries parted; {n_tok} tokens)")
    emit({"phase": "server_probe", "card": card, "replay": blank_replay,
          "utterances": len(store), "slots": runner.slots, "split_len": runner.split_len,
          "warmup_seconds": warm, "cadence": out["cadence"],
          "device_step_cadence_ms": out["device_step_cadence_ms"],
          "ladder_native": [{k: lv.get(k) for k in KEEP_LEVEL} for lv in ladder],
          "rules": out["rules"], "highest_valid_qps": highest,
          "python_clock": [{k: lv.get(k) for k in KEEP_LEVEL}
                           for lv, _ in python_clock.values()],
          "streaming_vs_offline": {"queries": len(results), "tokens": n_tok,
                                   "queries_parted": len(parted), "partings": parted},
          "launches": launches, "seconds": time.time() - t_phase})
    return {"server_probe": {"main": launches, "timed_pass": launches},
            "server_pipelined": pipelined}


# stage -1's golden gate runs tests/test_torch_golden.py, which makes the
# bundle's weights with the JAX package: this script runs nothing of it
GOLDEN_NOT_RUN = ("    golden gate NOT RUN by chip_smoke.py: tests/test_torch_golden.py "
                  "imports the JAX package")


def phase_run_stages(card: str) -> dict:
    """tools/run_stages.py, the port's scripts/run.sh flow, with QUICK=true,
    STAGE=-1 and SYNTHETIC=64 in a temporary WORK_DIR, on the card (launch
    counts set to 0 just before, read just after; per stage from the
    records): stage -1 builds the four kernels and the loadgen (its QUICK
    golden gate is not run: the test imports the JAX package), stages 0-2
    skip, stage 3 calibrates (kernel C) and quantizes, then checks the
    calibration against a TRT cache written into WORK_DIR (advisory on a
    synthetic calibration), stage 5 runs the Offline accuracy (packed) and
    performance (native) runs and the Server accuracy and performance
    (native) runs (kernels A and B).  MANIFEST names a manifest written for
    the synthetic store, so the Offline runs score a WER.  Gates: every
    stage returns, the calibration, the int8 npz, the accuracy log and the
    four summaries exist, both performance summaries say timing native,
    tools/eval_accuracy.py on the Offline accuracy log prints the WER of
    that run's summary.json, and kernels A, B and C each launched."""
    import struct
    import tempfile

    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda, lstm_scan_cuda
    from rnnt_inference_tpu_torch.tools import eval_accuracy, run_stages

    t_phase = time.time()
    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda,
                "lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda}
    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.RandomState(17)
    words = "the a of speech model reads seven quiet rivers under bright stones".split()
    with tempfile.TemporaryDirectory() as d:
        work = os.path.join(d, "work")
        os.makedirs(work)
        store = SampleStore.synthetic(n=64, seed=0)  # main's --synthetic 64 (--seed 0)
        manifest = os.path.join(d, "m.json")
        with open(manifest, "w") as f:
            json.dump([{"audio_filepath": name, "duration": len(s) / 16000.0,
                        "transcript": " ".join(rng.choice(words, size=rng.randint(3, 9)))}
                       for name, s in zip(store.names, store.samples)], f)
        # a TRT MinMax cache (name: big-endian hex of amax / 127) for stage 3b
        names = ["input"] + [f"encoder.{net}.lstm{i}_{t}" for net, n in (("pre_rnn", 2),
                                                                         ("post_rnn", 3))
                             for i in range(n) for t in ("hidden", "output")]
        with open(os.path.join(work, "calibration_result_nv.cache"), "w") as f:
            f.write("TRT-8001-MinMaxCalibration\n")
            for k in names:
                amax = 5.84 if k == "input" else 1.0
                f.write(f"{k}: {struct.pack('>f', amax / 127).hex()}\n")
        env = {"QUICK": "true", "STAGE": "-1", "SYNTHETIC": "64", "WORK_DIR": work,
               "MANIFEST": manifest}
        for c in counters.values():
            c.launches = 0
        stages = run_stages.Stages()
        with contextlib.chdir(root), contextlib.redirect_stdout(sys.stderr):
            run_stages.run_all(env, stages, gate=lambda: print(GOLDEN_NOT_RUN))
        records = stages.records
        launches = {k: c.launches for k, c in counters.items()}
        out_dir = os.path.join(work, "out")
        need = [os.path.join(work, f) for f in ("rnnt_calib.npz", "rnnt_quant.npz", "quick.conf")]
        need += [os.path.join(out_dir, "offline_acc", "accuracy_log.json")]
        need += [os.path.join(out_dir, r, "summary.json")
                 for r in ("offline_acc", "offline_perf", "server_acc", "server_perf")]
        missing = [f for f in need if not os.path.isfile(f)]
        if missing:
            raise AssertionError(f"run_stages: missing {missing}")
        summaries = {}
        for r in ("offline_acc", "offline_perf", "server_acc", "server_perf"):
            with open(os.path.join(out_dir, r, "summary.json")) as f:
                summaries[r] = json.load(f)
        for r in ("offline_perf", "server_perf"):
            if summaries[r].get("timing") != "native":
                raise AssertionError(f"run_stages {r}: timing {summaries[r].get('timing')!r}")
        with contextlib.redirect_stdout(sys.stderr):
            wer = eval_accuracy.main(["--log_path",
                                      os.path.join(out_dir, "offline_acc", "accuracy_log.json"),
                                      "--manifest_path", manifest,
                                      "--hypotheses_out", os.path.join(d, "hypotheses.log")])
        run_wer = summaries["offline_acc"].get("wer_percent")
        if run_wer is None or round(wer * 100, 3) != run_wer:
            raise AssertionError(f"run_stages: eval_accuracy WER {wer * 100}% against the "
                                 f"run's {run_wer}%")
    if not all(launches.values()):
        raise AssertionError(f"run_stages: launches {launches}")
    calls = {}  # "stage:run" -> launches and seconds of one main call
    for r in records:
        a = r["argv"]
        run = (a[a.index("--output_dir") + 1].rsplit("/", 1)[-1] if "--output_dir" in a
               else a[2].lstrip("-"))
        calls[f"{r['stage']}:{run}"] = {"launches": r["launches"], "seconds": r["seconds"]}
    emit({"phase": "run_stages", "card": card, "env": {k: v for k, v in env.items()
                                                        if k not in ("WORK_DIR", "MANIFEST")},
          "golden_gate": GOLDEN_NOT_RUN.strip(),
          "main_calls": calls, "launches": launches,
          "wer_percent": run_wer, "eval_accuracy_wer_percent": wer * 100,
          "summaries": {k: {x: v.get(x) for x in ("timing", "result_validity",
                                                  "samples_per_second", "completed",
                                                  "latency_ms_p99", "wer_percent")}
                        for k, v in summaries.items()},
          "seconds": time.time() - t_phase})
    perf = [r["launches"] for r in records
            if "--native_loadgen" in r["argv"] and "--accuracy" not in r["argv"]]
    return {"main": launches,
            "timed_pass": {k: sum(p[k] for p in perf) for k in launches}}


BARE_WORDS = ("HE SAID THE QUIET RIVER RAN UNDER SEVEN BRIGHT STONES WHILE A MODEL READ "
              "OF SPEECH AND NIGHT").split()


def _flac16k(q: np.ndarray) -> bytes:
    from rnnt_inference_tpu_torch.data.flac import encode_flac

    return encode_flac(q, 16000)


def _md5(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def _librispeech_subset(root: str, subset: str, n: int, seconds, rng, pool) -> dict:
    """root/<subset>.tar.gz in LibriSpeech's layout: members
    LibriSpeech/<subset>/<spk>/<chap>/<spk>-<chap>-<utt>.flac (seeded
    speech-like noise, 16-bit, encoded with the port's encode_flac in
    ``pool``) and one <spk>-<chap>.trans.txt per chapter (upper-case, as
    LibriSpeech).  Returns {utterance id: (int16 samples, transcript)}."""
    import tarfile

    from rnnt_inference_tpu_torch.data.dataset import speechlike_noise

    utts, ids = {}, []
    spk0 = 1000 if subset == "dev-clean" else 5000
    for i in range(n):  # four speakers of two chapters each
        spk, chap = spk0 + 37 * (i % 4), 20000 + 11 * (i % 8 // 4)
        uid = f"{spk}-{chap}-{i:04d}"
        x = speechlike_noise(rng, int(rng.uniform(*seconds) * 16000))
        q = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
        utts[uid] = (q, " ".join(rng.choice(BARE_WORDS, size=rng.randint(4, 16))))
        ids.append(uid)
    flacs = dict(zip(ids, pool.map(_flac16k, [utts[u][0] for u in ids])))
    with tarfile.open(os.path.join(root, f"{subset}.tar.gz"), "w:gz") as t:
        def add(name, data):
            info = tarfile.TarInfo(f"LibriSpeech/{subset}/{name}")
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))

        for spk, chap in sorted({tuple(u.split("-")[:2]) for u in ids}):
            mine = [u for u in ids if u.startswith(f"{spk}-{chap}-")]
            add(f"{spk}/{chap}/{spk}-{chap}.trans.txt",
                "".join(f"{u} {utts[u][1]}\n" for u in mine).encode())
            for u in mine:
                add(f"{spk}/{chap}/{u}.flac", flacs[u])
    return utts


class _Tee(io.TextIOBase):
    """Writes to stderr and keeps the text, with the time of each "==> "
    stage marker."""

    def __init__(self):
        self.text, self.marks = io.StringIO(), []

    def write(self, s: str) -> int:
        if s.startswith("==> "):
            self.marks.append((time.time(), s.strip()))
        sys.stderr.write(s)
        return self.text.write(s)

    def flush(self) -> None:
        sys.stderr.flush()


@contextlib.contextmanager
def _loopback_only():
    """No proxy from the environment may take a loopback fetch off the host."""
    keys = ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy", "ALL_PROXY",
            "no_proxy", "NO_PROXY")
    saved = {k: os.environ.pop(k) for k in keys if k in os.environ}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    try:
        yield
    finally:
        for k in ("no_proxy", "NO_PROXY"):
            os.environ.pop(k, None)
        os.environ.update(saved)


def phase_bare_machine(card: str, seed: int) -> dict:
    """tools/run_stages.py from a bare machine: STAGE=-1, QUICK=true,
    PLATFORM unset, in a temporary WORK_DIR, with the checkpoint and the
    corpus fetched over loopback.  A zenodo-layout rnnt.pt of seeded f32
    weights at RNNTParams() (full width) and two LibriSpeech-layout subsets
    (dev-clean: 32 utterances of 2-14 s; train-clean-100: 16 of 2-8 s;
    seeded 16-bit speech-like noise as FLAC with upper-case transcripts)
    are served by a ThreadingHTTPServer on 127.0.0.1; MODEL_URL and
    data/download.py's LIBRISPEECH_SETS (the module attribute, for this
    phase) point at it, with the tarballs' md5s; CALIB_LIST names 12 of the
    16 train utterances; TRT_CACHE names no file (seeded weights cannot
    match a TRT cache, so stage 3b does not run).  Stage -1 probes the card
    in a throwaway process and builds; stage 0 fetches rnnt.pt, stage 1
    both tarballs (md5 checked) and extracts them, stage 2 converts them
    (dev-clean.npz with features, train-calib.npz with the list), stage 3
    calibrates on train-calib.npz with --model rnnt.pt (kernel C) and
    quantizes, stage 5 serves dev-clean.npz in its four runs (kernels A and
    B).  Launch counts are set to 0 just before the run and read just
    after.  Gates: the probe's detail names the card and the device count;
    each file fetched once, byte for byte and md5-checked; a second run
    from STAGE=0, and data/download.py main again, fetch nothing; the
    stores' samples bit-equal to the seeded 16-bit samples / 2**15, the
    calibration store holding the listed utterances; C launched in stage
    3, A and B in each of stage 5's four runs; tools/eval_accuracy.py on
    the Offline accuracy log and the conversion's manifest gives the WER of
    the run's summary (the Server accuracy log, scored the same way, is
    printed beside it)."""
    import collections
    import http.server
    import tempfile
    import threading
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from rnnt_inference_tpu_torch.config import RNNTParams
    from rnnt_inference_tpu_torch.data import download
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.models.weights import init_weights, torch_state_dict_from_weights
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda, lstm_scan_cuda
    from rnnt_inference_tpu_torch.tools import eval_accuracy, run_stages

    t_phase = time.time()
    counters = {"quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
                "decode_step": decode_cuda.decode_step_cuda,
                "lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d, _loopback_only():
        src, work = os.path.join(d, "served"), os.path.join(d, "work")
        os.makedirs(src)
        t0 = time.time()
        weights = init_weights(RNNTParams(), torch.Generator().manual_seed(seed + 21), device="cpu")
        torch.save({"state_dict": torch_state_dict_from_weights(weights), "epoch": 100},
                   os.path.join(src, "rnnt.pt"))
        del weights
        rng = np.random.RandomState(seed + 22)
        with ProcessPoolExecutor(8, mp_context=get_context("spawn")) as pool:
            utts = {"dev-clean": _librispeech_subset(src, "dev-clean", 32, (2.0, 14.0), rng,
                                                     pool),
                    "train-clean-100": _librispeech_subset(src, "train-clean-100", 16,
                                                           (2.0, 8.0), rng, pool)}
        listed = sorted(utts["train-clean-100"])[:12]
        calib_list = os.path.join(d, "calibration_files.txt")
        with open(calib_list, "w") as f:
            f.writelines(f"LibriSpeech/train-clean-100/{u.split('-')[0]}/{u.split('-')[1]}/"
                         f"{u}.flac\n" for u in listed)
        served = {n: _md5(os.path.join(src, n))
                  for n in ("rnnt.pt", "dev-clean.tar.gz", "train-clean-100.tar.gz")}
        sizes = {n: os.path.getsize(os.path.join(src, n)) for n in served}
        setup_seconds = time.time() - t0

        hits, lock = collections.Counter(), threading.Lock()

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **k):
                super().__init__(*a, directory=src, **k)

            def do_GET(self):
                with lock:
                    hits[self.path] += 1
                super().do_GET()

            def log_message(self, *a):
                pass

        server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = lambda n: f"http://127.0.0.1:{server.server_address[1]}/{n}"
        sets = download.LIBRISPEECH_SETS
        download.LIBRISPEECH_SETS = [(s, url(f"{s}.tar.gz"), served[f"{s}.tar.gz"])
                                     for s in utts]
        env = {"STAGE": "-1", "QUICK": "true", "WORK_DIR": work, "MODEL_URL": url("rnnt.pt"),
               "CALIB_LIST": calib_list, "TRT_CACHE": os.path.join(d, "no-trt-cache")}
        tee = _Tee()
        try:
            for c in counters.values():
                c.launches = 0
            stages = run_stages.Stages()
            with contextlib.chdir(root), contextlib.redirect_stdout(tee):
                run_stages.run_all(env, stages, gate=lambda: print(GOLDEN_NOT_RUN))
            t_done = time.time()
            launches = {k: c.launches for k, c in counters.items()}
            fetched = dict(hits)
            again = run_stages.Stages()
            t0 = time.time()
            with contextlib.chdir(root), contextlib.redirect_stdout(sys.stderr):
                run_stages.run_all(dict(env, STAGE="0"), again)
                download.main(["--download_dir", f"{work}/LibriSpeech", "--subsets",
                               "dev-clean", "train-clean-100"])
            second_seconds = time.time() - t0
            refetched = dict(hits)
        finally:
            download.LIBRISPEECH_SETS = sets
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        log = tee.text.getvalue()

        # the probe, the fetches and the second pass
        probe = [ln for ln in log.splitlines() if ln.startswith("  backend probe: ")]
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        if len(probe) != 1 or name not in probe[0] or f"devices={count}" not in probe[0]:
            raise AssertionError(f"bare_machine: probe lines {probe} (card {name!r} x {count})")
        want = {f"/{n}": 1 for n in served}
        if fetched != want or refetched != want:
            raise AssertionError(f"bare_machine: requests {fetched}, after the second pass "
                                 f"{refetched}; want {want}")
        got = {n: _md5(os.path.join(work, n) if n == "rnnt.pt" else
                       os.path.join(work, "LibriSpeech", n)) for n in served}
        if got != served:
            raise AssertionError(f"bare_machine: fetched md5s {got} against served {served}")

        # stage 2's stores against the seeded 16-bit samples
        stores = {"dev-clean": SampleStore.load(os.path.join(work, "dev-clean.npz")),
                  "train-clean-100": SampleStore.load(os.path.join(work, "train-calib.npz"))}
        if (len(stores["dev-clean"]) != 32
                or sorted(stores["train-clean-100"].names) != [f"{u}.flac" for u in listed]):
            raise AssertionError(f"bare_machine: stores of {len(stores['dev-clean'])} and "
                                 f"{stores['train-clean-100'].names}")
        for s, store in stores.items():
            for n, x in zip(store.names, store.samples):
                q = utts[s][n[: -len(".flac")]][0]
                if x.dtype != np.float32 or not np.array_equal(x, q.astype(np.float32) / 32768.0):
                    raise AssertionError(f"bare_machine: {s} {n} differs from its seeded samples")

        # the calibration (kernel C) and the four serving runs (A and B)
        records = stages.records
        cal = [r for r in records if r["stage"] == "3" and "--calibration" in r["argv"]]
        serve = [r for r in records if r["stage"] == "5"]
        if (len(cal) != 1 or not cal[0]["launches"]["lstm_recurrence"]
                or cal[0]["argv"][cal[0]["argv"].index("--model") + 1] != f"{work}/rnnt.pt"
                or f"{work}/train-calib.npz" not in cal[0]["argv"]):
            raise AssertionError(f"bare_machine: calibration {cal}")
        if len(serve) != 4 or any(
                not r["launches"]["quant_lstm_layer"] or not r["launches"]["decode_step"]
                or r["argv"][r["argv"].index("--sample_file") + 1] != f"{work}/dev-clean.npz"
                for r in serve):
            raise AssertionError(f"bare_machine: stage 5 {[r['launches'] for r in serve]}")
        out_dir = os.path.join(work, "out")
        summaries = {}
        for r in ("offline_acc", "offline_perf", "server_acc", "server_perf"):
            with open(os.path.join(out_dir, r, "summary.json")) as f:
                summaries[r] = json.load(f)
        for r in ("offline_perf", "server_perf"):
            if summaries[r].get("timing") != "native":
                raise AssertionError(f"bare_machine {r}: timing {summaries[r].get('timing')!r}")
        with contextlib.redirect_stdout(sys.stderr):
            wer, server_wer = (eval_accuracy.main([
                "--log_path", os.path.join(out_dir, r, "accuracy_log.json"),
                "--manifest_path", os.path.join(work, "dev-clean.manifest.json"),
                "--hypotheses_out", os.path.join(d, f"{r}_hypotheses.log")])
                for r in ("offline_acc", "server_acc"))
        run_wer = summaries["offline_acc"].get("wer_percent")
        if run_wer is None or round(wer * 100, 3) != run_wer:
            raise AssertionError(f"bare_machine: eval_accuracy WER {wer * 100}% against the "
                                 f"run's {run_wer}%")
    # seconds per stage, from each "==> Stage" line to the next "==> " line
    marks = tee.marks + [(t_done, "end")]
    stage_seconds = collections.defaultdict(float)
    for (t, m), (t_next, _) in zip(marks, marks[1:]):
        if m.startswith("==> Stage"):
            stage_seconds[m.split(":")[0].removeprefix("==> ")] += t_next - t
    if not all(launches.values()):
        raise AssertionError(f"bare_machine: launches {launches}")
    emit({"phase": "bare_machine", "card": card, "params": "RNNTParams() defaults",
          "env": {k: v for k, v in env.items() if k in ("STAGE", "QUICK")},
          "trt_cache": "none: seeded weights cannot match the reference's TRT cache, so stage "
                       "3b did not run",
          "golden_gate": GOLDEN_NOT_RUN.strip(), "probe": probe[0].strip(),
          "utterances": {s: len(u) for s, u in utts.items()},
          "audio_seconds": {s: sum(len(q) for q, _ in u.values()) / 16000.0
                            for s, u in utts.items()},
          "calibration_utterances": len(listed), "bytes_fetched": sizes,
          "requests": fetched, "requests_after_second_pass": refetched,
          "setup_seconds": setup_seconds, "stage_seconds": dict(stage_seconds),
          "second_pass_seconds": second_seconds,
          "main_calls": [{"stage": r["stage"], "argv": " ".join(r["argv"][:4]),
                          "launches": r["launches"], "seconds": r["seconds"]} for r in records],
          "launches": launches, "wer_percent": run_wer,
          "eval_accuracy_wer_percent": wer * 100,
          "server_eval_accuracy_wer_percent": server_wer * 100,
          "summaries": {k: {x: v.get(x) for x in ("timing", "result_validity",
                                                  "samples_per_second", "completed",
                                                  "latency_ms_p99", "wer_percent")}
                        for k, v in summaries.items()},
          "seconds": time.time() - t_phase})
    perf = [r["launches"] for r in records
            if "--native_loadgen" in r["argv"] and "--accuracy" not in r["argv"]]
    return {"main": launches, "timed_pass": {k: sum(p[k] for p in perf) for k in launches}}


def phase_fastconformer_kernels(dev, seed: int) -> dict:
    """The streaming FastConformer's kernels (tests/test_torch_fastconformer_cuda.py
    holds them to their twins too), each against its plain twin and timed
    beside its bound at the Server cell's shape (fastconformer.server.poisson:
    128 slots, chunks of 14 encoder frames, a ring of 6 chunks, 8 heads of
    64; 9 taps over 512 channels), every slot busy at chunk 5 or later (its
    keys the ring's 84 rows):
    Times ("ms") are the kernels' device time from torch.profiler; beside
    them "ms_launch_loop", back-to-back calls timed by CUDA events, which the
    host's launch path bounds at these sizes.
      F_stream  relative-position attention under the chunked-limited mask
                (csrc/rel_attention.cu rel_attention_stream): one bf16 ulp
                of the twin's output (2^-7 |out|) plus the rounding of the
                probabilities to bf16 (2^-8 of the twin run on |v|) plus
                1e-6; bound: q, the seen K and V rows, the output and the
                band once, against 6 C keys d operations a head and slot;
      G_causal  causal depthwise convolution + bias + LayerNorm + Swish, the
                cache rewritten in the same launch (csrc/depthwise.cu
                depthwise_causal): one bf16 ulp of the twin plus 1e-3 (the
                LayerNorm's statistics summed in another order), the cache
                equal to the chunk's last 8 rows; bound: rows in, cache rows
                in and out, rows out and the taps, once."""
    from rnnt_inference_tpu_torch.ops import attention_cuda as ac
    from rnnt_inference_tpu_torch.ops import depthwise_cuda as dg

    N, H, d, C, R = 128, 8, 64, 14, 6
    D = H * d
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((N * C, 3 * D), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((N, R, C, 2 * D), generator=g, device=dev).to(torch.bfloat16)
    band = torch.randn(((R + 1) * C - 1, D), generator=g, device=dev).to(torch.bfloat16)
    u, vb = (0.1 * torch.randn((2, H, d), generator=g, device=dev)).unbind(0)
    chunk = torch.randint(5, 14, (N,), generator=g, device=dev, dtype=torch.int32)
    enc = (chunk * C + C).int()
    args = (qkv[:, :D], kv, band, u, vb, chunk, enc, 2)
    got = ac.rel_attention_stream(*args)
    want = ac.rel_attention_stream(*args, impl="reference")
    absv = ac.rel_attention_stream(qkv[:, :D], torch.cat([kv[..., :D], kv[..., D:].abs()], -1),
                                   *args[2:], impl="reference")
    diff = (got.float() - want.float()).abs()
    over = diff - (2 ** -7 * want.float().abs() + 2 ** -8 * absv.float() + 1e-6)
    if not float(over.max()) <= 0:
        raise AssertionError(f"kernel F (streaming) off: max |d| {float(diff.max())}, over its "
                             f"bound by {float(over.max())}")
    f_ms = kernel_ms(lambda: ac.rel_attention_stream_cuda(*args), "rel_attention_stream", 20)
    f_loop_ms = cuda_ms(lambda: ac.rel_attention_stream_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: ac.rel_attention_stream_reference(*args), 3, 1)
    keys = R * C
    ops = 6.0 * N * H * C * keys * d
    nbytes = 2.0 * N * H * d * (2 * C + 2 * keys) + 2.0 * band.numel()
    bound_ms, bound_by = bound(nbytes, ops, PEAK_BF16_FLOPS)
    rows = {"F_stream": {
        "name": "rel_attention_stream", "route": "cuda", "source": "rnnt_inference_tpu_torch/"
        "csrc/rel_attention.cu", "replaces": "none: the JAX package has no attention",
        "shape": f"{N} slots x {C} query rows against {keys} keys (a ring of {R} chunks), {H} "
                 f"heads of {d}, band {band.shape[0]} rows; one call = 1 launch",
        "ms": f_ms, "ms_launch_loop": f_loop_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / f_ms, "plain_ms": plain_ms, "max_abs_err": float(diff.max()),
        "max_abs_out": float(want.float().abs().max()),
        "library_ms": "none: no single PyTorch call attends a ring of chunks in place"}}

    K = 9
    x = torch.randn((N * C, D), generator=g, device=dev).to(torch.bfloat16)
    cache = torch.randn((N, K - 1, D), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, D), generator=g, device=dev) / 3).to(torch.bfloat16)
    b, lg, lb = torch.randn((3, D), generator=g, device=dev).unbind(0)
    c1, c2 = cache.clone(), cache.clone()
    got = dg.depthwise_causal(x, c1, w, b, lg, lb, 1e-5)
    want = dg.depthwise_causal(x, c2, w, b, lg, lb, 1e-5, impl="reference")
    diff = (got.float() - want.float()).abs()
    if float((diff - 2 ** -7 * want.float().abs()).max()) > 1e-3 or not torch.equal(c1, c2):
        raise AssertionError(f"kernel G (causal) off: max |d| {float(diff.max())}, cache equal "
                             f"{torch.equal(c1, c2)}")
    g_ms = kernel_ms(lambda: dg.depthwise_causal_cuda(x, c1, w, b, lg, lb, 1e-5),
                     "depthwise_causal", 20)
    g_loop_ms = cuda_ms(lambda: dg.depthwise_causal_cuda(x, c1, w, b, lg, lb, 1e-5), 20)
    plain_ms = cuda_ms(lambda: dg.depthwise_causal_reference(x, c2, w, b, lg, lb, 1e-5), 3, 1)
    nbytes = 2.0 * D * (2 * N * C + 2 * N * (K - 1) + K) + 4.0 * 3 * D
    bound_ms, bound_by = bound(nbytes, 2.0 * K * N * C * D, PEAK_F32_FLOPS)
    rows["G_causal"] = {
        "name": "depthwise_causal", "route": "cuda", "source": "rnnt_inference_tpu_torch/csrc/"
        "depthwise.cu", "replaces": "none: the JAX package has no convolution module",
        "shape": f"{N} slots x {C} rows x {D} channels, {K} causal taps, {K - 1} cache rows, "
                 f"LayerNorm and Swish; one call = 1 launch",
        "ms": g_ms, "ms_launch_loop": g_loop_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / g_ms, "plain_ms": plain_ms, "max_abs_err": float(diff.max()),
        "library_ms": "none: no single PyTorch call runs a causal depthwise convolution from a "
                      "cache"}
    emit({"phase": "fastconformer_kernels", "rows": rows})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # true f32 matmuls (the featurizer's contract) and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rnnt_inference_tpu_torch.config import RNNTParams
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights
    from rnnt_inference_tpu_torch.models.weights import init_weights
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    t_start = time.time()
    dev = torch.device("cuda")
    device = phase_device()
    phase_build()

    # full MLPerf width, seeded random weights, calibrated on synthetic audio
    params = RNNTParams()
    weights = init_weights(params, torch.Generator().manual_seed(args.seed), device=dev)
    cal = SampleStore.synthetic(n=8, seed=args.seed + 1, min_seconds=2.0, max_seconds=6.0)
    wav = np.zeros((len(cal), max(len(s) for s in cal.samples)), np.float32)
    for i, s in enumerate(cal.samples):
        wav[i, : len(s)] = s
    feats, flens = log_mel_features(torch.from_numpy(wav).to(dev), torch.from_numpy(cal.lengths).to(dev))
    calib = calibrate(weights, [(feats, flens)], params)
    qweights = quantize_weights(weights, calib, params)
    emit({"phase": "model", "params": "RNNTParams() defaults", "seed": args.seed,
          "pre_amax": calib.pre_amax.tolist(), "post_amax": calib.post_amax.tolist()})

    card = device["nvidia_smi"]
    a = phase_kernel_a(qweights, dev, single_stream_frames(params))
    b = phase_kernel_b(qweights, params, dev, "kernel_b")
    b32 = phase_kernel_b(weights, params, dev, "kernel_b_f32")
    bp = phase_kernel_b_packed(qweights, params, dev)
    c = phase_kernel_c(weights, dev)
    proj = phase_projection(weights, dev)
    # the bench's store (bench.run's: seed 0) at the bench phase's BENCH_N
    bench_store = SampleStore.synthetic(n=int(BENCH_CUTS["BENCH_N"]), seed=0)
    d = phase_kernel_d(qweights, params, dev, bench_store)
    # each path driven with the launch counts set to 0 just before it
    paths = {
        "int8": phase_end_to_end(qweights, params, dev, args.seed, card),
        "bf16": phase_cli("bf16", 32, dev, card),
        "f32": phase_cli("f32", 8, dev, card),
        "packed": phase_packed_int8(qweights, params, dev, card),
        "server": phase_server_int8(qweights, params, dev, args.seed, card),
        "fake_quant": {"main": phase_fake_quant(dev, card)},
    }
    paths.update(phase_native(qweights, params, dev, card, paths["server"]["realtime_qps"]))
    paths["product_chain"] = phase_product_chain(params, dev, card, args.seed)
    paths.update(phase_multi_device(qweights, params, dev, card, args.seed))
    paths.update(phase_transcribe(params, dev, card, args.seed))
    benches = phase_bench(card)
    twins = phase_bench_twins(params, dev, card, benches, bench_store)
    phase_profile(qweights, params, dev, card, benches["blank_cap1"][0], bench_store)
    paths.update(phase_server_probe(params, dev, card, benches["blank_cap1"][0], bench_store))
    paths["run_stages"] = phase_run_stages(card)
    paths["bare_machine"] = phase_bare_machine(card, args.seed)
    # launches: A from the int8 Offline path (one pass); B and C from one
    # main call of the CLI's default run mode (bf16), this slice's main
    # path; D from its own entry point; per timed pass beside them
    a["launches"] = paths["int8"]["main"]["quant_lstm_layer"]
    a["encoder_layer_calls_per_timed_pass"] = paths["int8"]["layer_calls"]
    b["launches"] = paths["bf16"]["main"]["decode_step"]
    c["launches"] = paths["bf16"]["main"]["lstm_recurrence"]
    proj["launches"] = paths["bf16"]["main"]["projection"]
    proj["launches_per_timed_pass"] = paths["bf16"]["timed_pass"]["projection"]
    d["launches_per_timed_pass"] = d["launches"]
    native = ("native_offline", "native_packed", "native_server", "native_single_stream",
              "product_chain", "server_probe", "server_pipelined", "run_stages", "bare_machine")
    for e, name, ks in ((a, "quant_lstm_layer", ("int8", "packed", "server") + native),
                        (b, "decode_step", ("int8", "bf16", "f32", "packed", "server") + native),
                        (c, "lstm_recurrence", ("bf16", "f32", "product_chain", "run_stages",
                                                "bare_machine"))):
        e["launches_per_timed_pass"] = paths["bf16" if e is not a else "int8"]["timed_pass"][name]
        e["launches_by_path"] = {k: paths[k]["main"][name] for k in ks}
        e["launches_per_timed_pass_by_path"] = {k: paths[k]["timed_pass"][name] for k in ks}
    d["launches_by_path"] = {"features_fused": d["launches"]}
    # the data-parallel paths (A, B) and the Transcriber (B, C), each counted alone
    for e, name in ((a, "quant_lstm_layer"), (b, "decode_step")):
        e["launches_by_path"].update({k: v["main"][name] for k, v in paths.items()
                                      if k.startswith("multi_device_")})
    b["launches_by_path"]["transcribe"] = paths["transcribe"]["main"]["decode_step"]
    c["launches_by_path"]["transcribe"] = paths["transcribe"]["main"]["lstm_recurrence"]
    b["launches_by_path"]["fake_quant"] = paths["fake_quant"]["main"]["decode_step"]
    # the bench's runs, counted in their own process: the last timed rep;
    # and the same configurations in this process (bench_twins: one run)
    for e, name in ((a, "quant_lstm_layer"), (b, "decode_step")):
        e["launches_per_timed_rep_by_bench_run"] = {
            k: p["protocol"]["launches"][name] for k, (_, p) in benches.items()}
        e["launches_by_path"].update({f"bench_{k}": v[name] for k, v in twins.items()})
    b["f32"] = {k: b32[k] for k in ("ms", "ms_one_iteration_per_launch", "ms_by_n", "plain_ms",
                                    "bound_ms", "bound_by", "bound_ms_one_iteration_per_launch",
                                    "bound_by_one_iteration_per_launch", "max_abs_err")}
    b["max_abs_err"] = max(b["max_abs_err"], b32["max_abs_err"], *(
        max(r["step_hg_max_abs_diff"], r["step_cg_max_abs_diff"], r["k_launch_hg_max_abs_diff"],
            r["k_launch_cg_max_abs_diff"]) for r in bp.values()))
    # packed mode's time per iteration (K per launch) beside the bucketed
    # mode's of the same call and state
    b["packed_mode"] = {n: {k: r[k] for k in ("ms_per_iteration_packed",
                                              "ms_per_iteration_bucketed",
                                              "plain_ms_per_step_packed")}
                        for n, r in bp.items()}
    conf = phase_conformer_kernels(dev, args.seed)
    paths["conformer_packed"] = phase_conformer_packed(dev, card, args.seed)
    for e, name in ((conf["F"], "attention"), (conf["G"], "depthwise"),
                    (conf["B_wide"], "decode_step")):
        e["launches_by_path"] = {"conformer_packed": paths["conformer_packed"]["main"][name]}
    fc = phase_fastconformer_kernels(dev, args.seed)
    emit({"phase": "summary", "card": card, "seconds": time.time() - t_start})
    emit({"kernels": [a, b, c, d, proj, conf["F"], conf["G"], conf["B_wide"], fc["F_stream"],
                      fc["G_causal"]]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
