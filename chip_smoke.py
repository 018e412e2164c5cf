"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's four CUDA kernels from rnnt_inference_tpu_torch/csrc
(one nvcc per source, started together), holds each against its plain
PyTorch twin on the card at full model width (kernel A bit for bit at N =
16, 64, 128 lanes and T = 48, and at the bench's 1,024 lanes and T = 16,
for the three int8 layer shapes, one launch per layer call; kernel B per step and over one launch of K iterations, at N = 16,
64, 128 lanes, with its time per iteration at one and at K iterations per
launch, its early exit, and the symbol loop's time by K; kernel C at N =
16, 128 beside cuDNN's layer),
then drives each path with the kernel launch counts set to 0 just before
it and read just after:
  - end_to_end: the bucketed Offline int8 pipeline (waveform -> log-mel ->
    int8 encoder (kernel A) -> greedy decode (kernel B)) through
    OfflineRunner, once on the kernels and once on the twins;
  - features_fused: the fused featurizer entry point (kernel D);
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
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # f32 FMA on the CUDA cores (no tensor cores)


def emit(obj) -> None:
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


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def phase_build() -> None:
    from rnnt_inference_tpu_torch.ops import (
        cuda_build, decode_cuda, features_cuda, lstm_cuda, lstm_scan_cuda,
    )

    t0 = time.time()
    names = [lstm_cuda.NAME, decode_cuda.NAME, lstm_scan_cuda.NAME, features_cuda.NAME]
    info = cuda_build.build(names)  # one nvcc per source, in parallel
    for name in names:
        cuda_build.load(name)
    ptxas = {
        n: [l.strip() for l in v["log"].splitlines() if "registers" in l or "spill" in l]
        for n, v in info.items()
    }
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas})


def phase_kernel_a(qweights, dev) -> dict:
    """Kernel A against its twin at H=1024 for the three layer shapes (IC =
    240, 1024, 2048), T=48 at N in {16 (the int8 runner's batch), 64, 128}
    and T=16 (the packed runner's chunk) at N=1,024 (the bench's lanes),
    int8 and f32 y: y, h and c bit-equal, one launch per call.  Its time
    per call and per step beside the bound of each row."""
    from rnnt_inference_tpu_torch.ops import lstm_cuda
    from rnnt_inference_tpu_torch.ops.lstm_int8 import quant_lstm_layer

    layers = (qweights.pre_rnn[0], qweights.post_rnn[1], qweights.post_rnn[0])
    g = torch.Generator().manual_seed(123)
    rows, entries = [], {}
    for N, T in ((16, 48), (64, 48), (128, 48), (1024, 16)):
        for layer in layers:
            IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
            x = torch.randint(-128, 128, (T, N, IC), generator=g, dtype=torch.int8).to(dev)
            h = torch.randint(-128, 128, (N, H), generator=g, dtype=torch.int8).to(dev)
            c = (torch.randn((N, H), generator=g) * 0.5).to(dev)
            for emit_f32 in (False, True):
                before = lstm_cuda.quant_lstm_layer_cuda.launches
                got = lstm_cuda.quant_lstm_layer_cuda(layer, x, h, c, emit_f32)
                launches = lstm_cuda.quant_lstm_layer_cuda.launches - before
                want = quant_lstm_layer(layer, x, h, c, emit_f32)
                torch.cuda.synchronize()
                row = {"IC": IC, "H": H, "N": N, "T": T, "emit_f32": emit_f32,
                       "launches_per_call": launches}
                for name, a, b in zip(("y", "h", "c"), got, want):
                    d = (a.double() - b.double()).abs()
                    row[f"{name}_max_abs_diff"] = float(d.max())
                    row[f"{name}_share_diff"] = float((d != 0).double().mean())
                if launches != 1 or any(row[f"{k}_max_abs_diff"] != 0 for k in "yhc"):
                    raise AssertionError(f"kernel A is not its twin bit for bit: {row}")
                ms = cuda_ms(lambda: lstm_cuda.quant_lstm_layer_cuda(layer, x, h, c, emit_f32), 20)
                plain_ms = cuda_ms(lambda: quant_lstm_layer(layer, x, h, c, emit_f32), 2, 1)
                y_es = 4 if emit_f32 else 1
                bytes_moved = ((IC + H) * 4 * H + T * N * IC + N * H * (1 + 4)
                               + T * N * H * y_es + N * H * (1 + 4))
                ops = 2 * T * N * (IC + H) * 4 * H
                bound_ms, bound_by = bound(bytes_moved, ops, PEAK_INT8_OPS)
                row.update(ms=ms, ms_per_step=ms / T, plain_ms=plain_ms,
                           plain_ms_per_step=plain_ms / T, bound_ms=bound_ms, bound_by=bound_by)
                rows.append(row)
                if not emit_f32:
                    entries[(N, IC)] = dict(row, x=x, h=h, layer=layer)
    emit({"phase": "kernel_a", "tolerance": "bit-equal: y, h, c (and f32 y) max |d| = 0",
          "rows": rows})

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
    by_n = {n: entries[(n, wide)] for n in (16, 64, 128, 1024)}
    return {
        "name": "quant_lstm_layer", "route": "cuda",
        "source": "rnnt_inference_tpu_torch/csrc/quant_lstm.cu",
        "replaces": "rnnt_inference_tpu/ops/lstm_pallas.py:187",
        "shape": f"IC={IC} H={H} N={N} T={T} int8 y, one call = 1 launch",
        "max_abs_err": max(max(r["y_max_abs_diff"], r["h_max_abs_diff"], r["c_max_abs_diff"])
                           for r in rows),
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": library_ms,
        "by_n": {n: {k: r[k] for k in ("T", "ms", "ms_per_step", "plain_ms", "bound_ms",
                                        "bound_by")}
                 for n, r in by_n.items()},
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
    from the int8 model, or f32), N in {16, 64, 128} lanes in random states:
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
    for N in (16, 64, 128):
        fproj = torch.from_numpy(rng.randn(T2, N, J).astype(np.float32)).to(dev)
        lanes0 = _decode_lanes(rng, N, T2, V, R)
        hg0 = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev, wdt)
        cg0 = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev)
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
        fl = torch.from_numpy(rng.randn(TL, N, J).astype(np.float32)).to(dev)
        lanes_l = torch.from_numpy(_decode_lanes(rng, N, TL, V, R, long=True)).to(dev)
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
    shape, IC=1024), T=48, N in {16, 128}, bf16 and f32 weights; cuDNN's
    LSTM layer of the same shape and type as the yardstick."""
    from rnnt_inference_tpu_torch.models.weights import map_tensors
    from rnnt_inference_tpu_torch.ops import lstm as tl
    from rnnt_inference_tpu_torch.ops import lstm_scan_cuda

    T = 48
    g = torch.Generator().manual_seed(321)
    rows, entries = [], {}
    for dt in (torch.bfloat16, torch.float32):
        layer = map_tensors(weights.post_rnn[1], lambda t: t.to(dt))
        IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
        # y/h: one bf16 step below 1 (an h that rounds to the other bf16
        # neighbour), c: 1e-3; f32: summation order only, 1e-5
        tol_h, tol_c = (2 ** -8, 1e-3) if dt == torch.bfloat16 else (1e-5, 1e-5)
        for N in (16, 128):
            x = torch.randn((T, N, IC), generator=g).to(dev)
            h0 = (torch.randn((N, H), generator=g) * 0.5).to(dev)
            c0 = (torch.randn((N, H), generator=g) * 0.5).to(dev)
            got = tl.lstm_layer(layer, x, h0, c0)
            want = tl.lstm_layer(layer, x, h0, c0, impl="reference")
            torch.cuda.synchronize()
            row = {"dtype": str(dt), "IC": IC, "H": H, "N": N, "T": T}
            for name, a, b, tol in zip(("y", "h", "c"), got, want, (tol_h, tol_h, tol_c)):
                d = (a.float() - b.float()).abs()
                row[f"{name}_max_abs_diff"] = float(d.max())
                row[f"{name}_share_diff"] = float((d != 0).float().mean())
                if not row[f"{name}_max_abs_diff"] <= tol:
                    raise AssertionError(f"kernel C {name} off: {row}")
            # the kernel alone (recurrence over T steps) against its twin
            # on the same xw, and the whole layer (projection + kernel)
            # against cuDNN's LSTM layer
            xw = (tl.dot_f32(x.to(dt), layer.w_ih) + layer.b.float()).to(dt)
            hc, cc = h0.to(dt), c0
            before = lstm_scan_cuda.lstm_recurrence_cuda.launches
            lstm_scan_cuda.lstm_recurrence_cuda(layer, xw, hc, cc)
            launches_per_call = lstm_scan_cuda.lstm_recurrence_cuda.launches - before
            ms = cuda_ms(lambda: lstm_scan_cuda.lstm_recurrence_cuda(layer, xw, hc, cc), 10)
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
        "shape": f"IC={e['IC']} H={e['H']} N=128 T={T} bf16, one call = "
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
    }


def phase_kernel_d(dev) -> dict:
    """The fused featurizer path (log_mel_features_fused, kernel D) on 16
    utterances of up to 15 s, with the launch count set to 0 just before it
    and read just after; then kernel D against its twin on the same input."""
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.ops import features as tf
    from rnnt_inference_tpu_torch.ops import features_cuda

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

    # the kernel alone, on the padded, preemphasized waveform the entry
    # point hands it
    x = tf.pad_both(tf.preemphasis(wav, lens.long(), cfg.preemph), cfg.n_fft // 2,
                    cfg.pad_mode)[:, tf._frontend_constants(cfg)[3][0]:].contiguous()
    T = S // cfg.hop_length + 1
    a, b = tf.fused_mel(x, T, cfg), tf.fused_mel(x, T, cfg, impl="reference")
    torch.cuda.synchronize()
    mel_diff = float((a - b).abs().max())
    if not mel_diff <= 1e-4:
        raise AssertionError(f"kernel D off: {mel_diff}")
    ms = cuda_ms(lambda: tf.fused_mel(x, T, cfg), 20)
    plain_ms = cuda_ms(lambda: tf.fused_mel(x, T, cfg, impl="reference"), 10)
    entry_ms = cuda_ms(lambda: tf.log_mel_features_fused(wav, lens, cfg), 10)
    plain_entry_ms = cuda_ms(lambda: tf.log_mel_features(wav, lens, cfg), 10)
    N, K, M, flen = x.shape[0], 257, cfg.n_mels, 2 * cfg.hop_length
    bytes_moved = x.numel() * 4 + N * T * M * 4 + (2 * flen * K + K * M) * 4
    ops = N * T * (2 * 2 * flen * K + 3 * K + 2 * K * M + 2 * M)
    bound_ms, bound_by = bound(bytes_moved, ops, PEAK_F32_FLOPS)
    emit({"phase": "kernel_d", "utterances": N, "frames": T, "launches": launches,
          "tolerance": "normalized features <= 5e-4 (tests/test_features.py's bound), "
                       "raw log-mel <= 1e-4",
          "features_max_abs_diff": feat_diff, "log_mel_max_abs_diff": mel_diff, "ms": ms,
          "plain_ms": plain_ms, "entry_ms": entry_ms, "log_mel_features_ms": plain_entry_ms,
          "bound_ms": bound_ms, "bound_by": bound_by})
    return {
        "name": "log_mel", "route": "cuda",
        "source": "rnnt_inference_tpu_torch/csrc/mel.cu",
        "replaces": "rnnt_inference_tpu/ops/features_pallas.py:47",
        "shape": f"N={N} T={T} frames of 320 samples, 257 bins, {M} mels; one call = 1 launch",
        "launches": launches, "max_abs_err": mel_diff, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library_note": "no single PyTorch call computes frames -> windowed DFT -> "
                        "power -> mel -> log (torch.stft + matmul + log is several calls)",
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
    from rnnt_inference_tpu_torch.ops import decode_cuda, lstm_cuda, lstm_scan_cuda
    from rnnt_inference_tpu_torch.runtime.harness import run_offline
    from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner

    counters = {"lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda,
                "decode_step": decode_cuda.decode_step_cuda,
                "quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda}
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
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):  # main prints its summary
            rk = cli.main(argv)
        seconds = time.time() - t0
        launches = {k: c.launches for k, c in counters.items()}
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
    return {"main": launches, "timed_pass": launches}


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
            t0 = time.time()
            with order:
                runs[tag] = run_offline(w, store, bparams, cfg, batch_size=BENCH_LANES,
                                        runner=runners[tag], wav_buckets_s=buckets, packed=True,
                                        warmup=impl is None, device=dev)
            seconds[tag] = time.time() - t0
            launches[tag] = {k: c.launches for k, c in counters.items()}
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
    a = phase_kernel_a(qweights, dev)
    b = phase_kernel_b(qweights, params, dev, "kernel_b")
    b32 = phase_kernel_b(weights, params, dev, "kernel_b_f32")
    bp = phase_kernel_b_packed(qweights, params, dev)
    c = phase_kernel_c(weights, dev)
    d = phase_kernel_d(dev)
    # each path driven with the launch counts set to 0 just before it
    paths = {
        "int8": phase_end_to_end(qweights, params, dev, args.seed, card),
        "bf16": phase_cli("bf16", 32, dev, card),
        "f32": phase_cli("f32", 8, dev, card),
        "packed": phase_packed_int8(qweights, params, dev, card),
        "server": phase_server_int8(qweights, params, dev, args.seed, card),
        "fake_quant": {"main": phase_fake_quant(dev, card)},
    }
    benches = phase_bench(card)
    # the bench's store (bench.run's: seed 0) at the bench phase's BENCH_N
    bench_store = SampleStore.synthetic(n=int(BENCH_CUTS["BENCH_N"]), seed=0)
    twins = phase_bench_twins(params, dev, card, benches, bench_store)
    phase_profile(qweights, params, dev, card, benches["blank_cap1"][0], bench_store)
    # launches: A from the int8 Offline path (one pass); B and C from one
    # main call of the CLI's default run mode (bf16), this slice's main
    # path; D from its own entry point; per timed pass beside them
    a["launches"] = paths["int8"]["main"]["quant_lstm_layer"]
    a["encoder_layer_calls_per_timed_pass"] = paths["int8"]["layer_calls"]
    b["launches"] = paths["bf16"]["main"]["decode_step"]
    c["launches"] = paths["bf16"]["main"]["lstm_recurrence"]
    d["launches_per_timed_pass"] = d["launches"]
    for e, name, ks in ((a, "quant_lstm_layer", ("int8", "packed", "server")),
                        (b, "decode_step", ("int8", "bf16", "f32", "packed", "server")),
                        (c, "lstm_recurrence", ("bf16", "f32"))):
        e["launches_per_timed_pass"] = paths["bf16" if e is not a else "int8"]["timed_pass"][name]
        e["launches_by_path"] = {k: paths[k]["main"][name] for k in ks}
        e["launches_per_timed_pass_by_path"] = {k: paths[k]["timed_pass"][name] for k in ks}
    d["launches_by_path"] = {"features_fused": d["launches"]}
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
    emit({"phase": "summary", "card": card, "seconds": time.time() - t_start})
    emit({"kernels": [a, b, c, d]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
