"""Where the time goes inside the kernels A, B, C and D, on the card.

    python -m rnnt_inference_tpu_torch.tools.kernel_phases

Copies csrc/quant_lstm.cu, csrc/decode_step.cu, csrc/lstm_scan.cu,
csrc/mel.cu and csrc/hopper.cuh into build/kernel_phases/, inserts
%globaltimer stamps (thread 0 of block 0) at the phase boundaries below,
builds them with the port's nvcc flags, runs each at the main path's
shapes (random weights, MLPerf widths) and prints, per shape, the mean
microseconds of one iteration (B) or step (A, C) and of each segment
between two stamps, averaged over the steady iterations.

Kernel D (not persistent: a block per 64 frames of an utterance, as its
``rnnt_log_mel_frames_per_block()`` says) is stamped in every block by
thread 0, which runs warp 0's share (the heaviest: bin tile 0 takes three
tf32 pieces): SM cycles (clock64) of
  stage       the block's samples and filterbank pieces into shared
              memory, and the samples' split into tf32 pieces
  dft_mma     warp 0's DFT products (its passes' k-step loops)
  power       its power epilogues
  dft_wait    the barrier after the DFT: waiting for the other warps
  mel_mma     warp 0's mel products (its mel tile x m-tile units)
  log_store   + 1e-20, log and the stores
converted to microseconds by the blocks' cycles per %globaltimer
nanosecond, averaged over the blocks; with the mel phase (the barrier
after the DFT to the block's end), the kernel's span (first block start
to last block end), the blocks' mean span, and the most blocks one SM
ran, at chip_smoke.py kernel_d's shape (16 utterances x 1,501 frames).

Kernel B segments, one iteration:
  lanes     the lane arrays read after the iteration's first barrier
  l0        phase 1, layer 0's cell updates (no product)
  sync1     its grid barrier
  l1_in     phase 2 until the first chunk of layer 1's input has arrived
  l1_mma    the rest of layer 1's pass (products, k-group sums)
  l1_epi    layer 1's cell updates and the layer-0 h.W_hh it keeps
  sync2
  j_in      phase 3 until the first chunk of the joint's input has arrived
  j_mma     the rest of the joint's pass
  j_epi     z and the layer-1 h.W_hh it keeps
  sync3
  o_in      phase 4 until the first chunk of z has arrived
  o_mma     logits (products, sums, shared memory)
  o_argmax  argmax and the lane algebra
  sync4
Kernel C at N = 16 and 128 (T = 48) and at the packed runner's N =
1,024 (T = 16), f32 and bf16.  The pass engine (f32; bf16 of one pass),
segments of one step: in (the first chunk of h), mma (the rest of the
pass), epi (cell updates), sync; a step of several passes (f32 at N =
128) counts the earlier passes in `in`.  The cluster loop (bf16 at
N = 1,024), with the cluster size plan chose and the launches by size:
per pass of consumer warpgroup 0 (which takes every
other pass; the step's time to the end of its passes split by the SM
cycles its thread 0 in block 0 spent in each segment) turn (waiting for
the other warpgroup to have seen the chunks of the pass before), wait
(for a chunk's full barrier), mma (issuing a chunk's products and waiting
for the previous chunk's), epi (the last products, cell updates, h_t
out); and per step, sync (the grid barrier).
Kernel A segments, one step (N <= 128: one pass each for h and x):
  h_in      after the barrier, until the first chunk of h_{t-1} has arrived
  h_mma     the rest of the h . W_hh pass
  epi       the warps' sums to shared memory, cell updates, h_t and y_t out
  arrive    the barrier's arrival
  x_in      x_{t+1} arriving, between arrival and wait
  x_mma     the rest of the x_{t+1} . W_ih pass (its sums stay in registers)
  wait      the rest of the barrier: waiting for the last block
At the packed runner's N = 1,024 (8 passes) h_in also holds the first 7
passes, and A runs on both its paths: fused, and hoisted (x . W_ih
before the loop), whose passes stream h through their own loop, not the
pass engine: its segments are passes (h_in, h_mma and epi together),
arrive, prefetch (the L2 prefetch of the next step's sums) and wait.

The stamps are inserted by text: an anchor that is missing stops the tool
(a kernel's change must bring this file up to date).  Nothing of this
module runs at import.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

PROBE = """__device__ unsigned long long g_prof[256 * 32];
__device__ int g_it, g_base;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_it < 256) \\
  g_prof[g_it * 32 + (i)] = gtime(); } while (0)
// kernel C's cluster loop: SM cycles by segment, summed over a step
#define STAMP_CLOCKS unsigned long long kp_w = 0, kp_t = 0, kp_m = 0, kp_e = 0, kp_n = 0, \\
  kp_0 = clock64(), kp_a = 0
#define STAMP_TICK kp_a = clock64()
#define STAMP_ADD(x) do { const unsigned long long u_ = clock64(); x += u_ - kp_a; kp_a = u_; } \\
  while (0)
#define STAMP_CLOCKS_OUT do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_it < 256) { \\
  unsigned long long* o_ = g_prof + g_it * 32; o_[8] = kp_w; o_[9] = kp_m; o_[10] = kp_e; \\
  o_[11] = clock64() - kp_0; o_[12] = kp_t; o_[13] = kp_n; } } while (0)
"""
READ = """int rnnt_prof_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}

const char* rnnt_cuda_error_string(int err) {"""

HEADER = [
    ("namespace hopper {", PROBE + "namespace hopper {"),
    ("    __syncthreads();  // chunk c is in, and chunk c - 1's slot is free",
     "    __syncthreads();  // chunk c is in, and chunk c - 1's slot is free\n"
     "    if (c == 0) STAMP(g_base);"),
]
DECODE = [
    ("  };\n\n  cooperative_groups::grid_group grid = cooperative_groups::this_grid();\n"
     "  int it = 0;\n  for (;; ++it) {\n    const int p = it & 1;",
     "  };\n\n  cooperative_groups::grid_group grid = cooperative_groups::this_grid();\n"
     "  int it = 0;\n  for (;; ++it) {\n    if (b == 0 && tid == 0) g_it = it;\n    STAMP(0);\n"
     "    const int p = it & 1;"),
    ("    __syncthreads();\n\n    // phase 1: layer 0.",
     "    __syncthreads();\n    STAMP(1);\n\n    // phase 1: layer 0."),
    ("    grid.sync();\n\n    // phase 2: layer 1",
     "    STAMP(2);\n    grid.sync();\n    STAMP(3);\n\n    // phase 2: layer 1"),
    ("        PassAcc<WT, NC1> acc;\n        pass_products<WT, NC1>(",
     "        PassAcc<WT, NC1> acc;\n        if (b == 0 && tid == 0) g_base = 4;\n"
     "        pass_products<WT, NC1>("),
    ("[&](int r) { return hn_cur + ((size_t)p0 + r) * P; }, acc);\n        if (kg != 0)",
     "[&](int r) { return hn_cur + ((size_t)p0 + r) * P; }, acc);\n        STAMP(5);\n"
     "        if (kg != 0)"),
    ("    grid.sync();\n\n    // phase 3: the joint",
     "    STAMP(6);\n    grid.sync();\n    STAMP(7);\n\n    // phase 3: the joint"),
    ("        PassAcc<WT, NC2> acc;\n        pass_products<WT, NC2>(",
     "        PassAcc<WT, NC2> acc;\n        if (b == 0 && tid == 0) g_base = 8;\n"
     "        pass_products<WT, NC2>("),
    ("[&](int r) { return y + ((size_t)p0 + r) * P; }, acc);\n        if (kg != 0)",
     "[&](int r) { return y + ((size_t)p0 + r) * P; }, acc);\n        STAMP(9);\n"
     "        if (kg != 0)"),
    ("    grid.sync();\n\n    // phase 4: z.W2",
     "    STAMP(10);\n    grid.sync();\n    STAMP(11);\n\n    // phase 4: z.W2"),
    ("      PassAcc<WT, VP> acc;\n      pass_products<WT, VP>(",
     "      PassAcc<WT, VP> acc;\n      if (b == 0 && tid == 0) g_base = 12;\n"
     "      pass_products<WT, VP>("),
    ("      __syncthreads();\n      int unfinished = 0;",
     "      __syncthreads();\n      STAMP(13);\n      int unfinished = 0;"),
    ("    grid.sync();\n    if (it + 1 >= a.steps ||",
     "    STAMP(14);\n    grid.sync();\n    STAMP(15);\n    if (it + 1 >= a.steps ||"),
    ("const char* rnnt_cuda_error_string(int err) {", READ),
]
SCAN = [
    ("  for (int t = 0; t < T; ++t) {\n    const WT* hsrc",
     "  for (int t = 0; t < T; ++t) {\n    if (blockIdx.x == 0 && tid == 0) { g_it = t; g_base = 1; }\n"
     "    STAMP(0);\n    const WT* hsrc"),
    ("[&](int r) { return hsrc + (size_t)(p0 + r) * H; }, acc);\n      if (kg == 0) {",
     "[&](int r) { return hsrc + (size_t)(p0 + r) * H; }, acc);\n      STAMP(2);\n"
     "      if (kg == 0) {"),
    ("    if (t + 1 < T) cooperative_groups::this_grid().sync();  // y_t complete across the grid",
     "    STAMP(3);\n"
     "    if (t + 1 < T) cooperative_groups::this_grid().sync();  // y_t complete across the grid\n"
     "    STAMP(4);"),
    # the bf16 cluster loop: consumer thread 0 of block 0 (warpgroup 0, every
    # other pass) sums SM cycles by segment over its passes of a step into
    # slots 8-12, counts them in 13, and stamps the step's start (0), the end
    # of its passes (1) and the end of its barrier (2)
    ("    mbar_wait(wbar, 0);\n    for (int t = 0; t < T; ++t) {\n",
     "    mbar_wait(wbar, 0);\n    for (int t = 0; t < T; ++t) {\n"
     "      if (blockIdx.x == 0 && tid == 0) g_it = t;\n      STAMP(0);\n      STAMP_CLOCKS;\n"),
    ("        if (P > 0) mbar_wait(&turn[wg], ((P + wg) / CW + 1) & 1);\n",
     "        STAMP_TICK;\n        if (P > 0) mbar_wait(&turn[wg], ((P + wg) / CW + 1) & 1);\n"
     "        STAMP_ADD(kp_t); ++kp_n;\n"),
    ("              mbar_wait(&full[s], (g / S) & 1);\n",
     "              STAMP_TICK;\n              mbar_wait(&full[s], (g / S) & 1);\n"
     "              STAMP_ADD(kp_w);\n"),
    ("              held = s;\n            }\n",
     "              held = s;\n              STAMP_ADD(kp_m);\n            }\n"),
    ("        if (t128 == 0) mbar_arrive(&turn[1 - wg]);\n",
     "        if (t128 == 0) mbar_arrive(&turn[1 - wg]);\n        STAMP_TICK;\n"),
    ("              if (t == T - 1) a.hT[off] = hv;\n            }\n          }\n      }\n",
     "              if (t == T - 1) a.hT[off] = hv;\n            }\n          }\n"
     "        STAMP_ADD(kp_e);\n      }\n      STAMP(1);\n      STAMP_CLOCKS_OUT;\n"),
    ("        cooperative_groups::this_grid().sync();\n      }\n    }\n  }\n  cluster_sync();",
     "        cooperative_groups::this_grid().sync();\n      }\n      STAMP(2);\n    }\n  }\n"
     "  cluster_sync();"),
    ("const char* rnnt_cuda_error_string(int err) {", READ),
]
QUANT = [
    ("  for (int t = 0; t < a.T; ++t) {\n    const int8_t* hsrc",
     "  for (int t = 0; t < a.T; ++t) {\n    if (blockIdx.x == 0 && tid == 0) { g_it = t; g_base = 1; }\n"
     "    STAMP(0);\n    const int8_t* hsrc"),
    ("[&](int r) { return hsrc + (size_t)(p0 + r) * H; }, acc, H, true, false);\n",
     "[&](int r) { return hsrc + (size_t)(p0 + r) * H; }, acc, H, true, false);\n"
     "        STAMP(2);\n"),
    ("    if (t + 1 < a.T) {  // h_t complete across the grid after the wait\n"
     "      const unsigned old = grid_arrive(a.bar);\n"
     "      if constexpr (HOISTED)\n"
     "        prefetch_xw(t + 1);\n"
     "      else\n"
     "        x_products(t + 1, 0, min(RMAX, N), xacc);  // needs no other block's h_t\n"
     "      grid_wait(a.bar, old);",
     "    STAMP(3);\n"
     "    if (t + 1 < a.T) {  // h_t complete across the grid after the wait\n"
     "      const unsigned old = grid_arrive(a.bar);\n"
     "      STAMP(4);\n      if (blockIdx.x == 0 && tid == 0) g_base = 5;\n"
     "      if constexpr (HOISTED)\n"
     "        prefetch_xw(t + 1);\n"
     "      else\n"
     "        x_products(t + 1, 0, min(RMAX, N), xacc);  // needs no other block's h_t\n"
     "      STAMP(6);\n"
     "      grid_wait(a.bar, old);\n      STAMP(7);"),
    ("const char* rnnt_cuda_error_string(int err) {", READ),
]
DPROBE = """__device__ unsigned long long g_dprof[65536 * 16];  // gtime(): the patched hopper.cuh
__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}
#define DPROF_BEGIN unsigned long long dp_c0 = clock64(), dp_t = 0, dp_acc[16] = {0}; \\
  unsigned long long* dp = g_dprof + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) % 65536 * 16; \\
  if (threadIdx.x == 0) { dp[0] = gtime(); dp[2] = smid(); }
#define DMARK(i) do { if (threadIdx.x == 0) dp[i] = clock64() - dp_c0; } while (0)
#define DSTART do { if (threadIdx.x == 0) dp_t = clock64(); } while (0)
#define DADD(i) do { if (threadIdx.x == 0) { const unsigned long long u = clock64(); \\
  dp_acc[i] += u - dp_t; dp_t = u; } } while (0)
#define DPROF_END do { if (threadIdx.x == 0) { dp[11] = clock64() - dp_c0; dp[1] = gtime(); \\
  dp[5] = dp_acc[5]; dp[6] = dp_acc[6]; dp[9] = dp_acc[9]; dp[10] = dp_acc[10]; } } while (0)
"""
DREAD = """int rnnt_dprof_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_dprof, sizeof(g_dprof));
}

const char* rnnt_cuda_error_string(int err) {"""
MEL = [
    ("namespace {\n\nusing hopper::cp_async16;", DPROBE + "namespace {\n\nusing hopper::cp_async16;"),
    ("  const float* xn = a.x + (size_t)n * a.S;\n",
     "  const float* xn = a.x + (size_t)n * a.S;\n  DPROF_BEGIN;\n"),
    ("  moff -= mlen;\n  __syncthreads();\n", "  moff -= mlen;\n  __syncthreads();\n  DMARK(3);\n"),
    ("    for (int s0 = 0; s0 < SK; s0 += AHEAD) {",
     "    DSTART;\n    for (int s0 = 0; s0 < SK; s0 += AHEAD) {"),
    ("    // power of the pass's bins:", "    DADD(5);\n    // power of the pass's bins:"),
    ("  };\n  for (int p = 0; p < npass; ++p) {", "    DADD(6);\n  };\n  for (int p = 0; p < npass; ++p) {"),
    ("  }\n  __syncthreads();  // the power spectrum is complete\n",
     "  }\n  DMARK(7);\n  __syncthreads();  // the power spectrum is complete\n  DMARK(8);\n"),
    ("    for (int s = 0; s < len; ++s) {", "    DSTART;\n    for (int s = 0; s < len; ++s) {"),
    ("#pragma unroll\n    for (int e = 0; e < 4; ++e) {\n      const int row = 16 * m + g",
     "    DADD(9);\n#pragma unroll\n    for (int e = 0; e < 4; ++e) {\n      const int row = 16 * m + g"),
    ("logf(__fadd_rn(acc[e], 1e-20f));\n    }\n  }\n}",
     "logf(__fadd_rn(acc[e], 1e-20f));\n    }\n    DADD(10);\n  }\n  DPROF_END;\n}"),
    ("const char* rnnt_cuda_error_string(int err) {", DREAD),
]
D_SEGMENTS = ("stage", "dft_mma", "power", "dft_wait", "mel_mma", "log_store")
A_SEGMENTS = ("h_in", "h_mma", "epi", "arrive", "x_in", "x_mma", "wait")
B_SEGMENTS = ("lanes", "l0", "sync1", "l1_in", "l1_mma", "l1_epi", "sync2", "j_in", "j_mma",
              "j_epi", "sync3", "o_in", "o_mma", "o_argmax", "sync4")
C_SEGMENTS = ("in", "mma", "epi", "sync")


def _patch(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"kernel_phases: anchor not found once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build(out: Path):
    from rnnt_inference_tpu_torch.ops import cuda_build

    out.mkdir(parents=True, exist_ok=True)
    src = cuda_build.CSRC
    (out / "hopper.cuh").write_text(_patch((src / "hopper.cuh").read_text(), HEADER))
    (out / "decode_step.cu").write_text(_patch((src / "decode_step.cu").read_text(), DECODE))
    (out / "lstm_scan.cu").write_text(_patch((src / "lstm_scan.cu").read_text(), SCAN))
    (out / "quant_lstm.cu").write_text(_patch((src / "quant_lstm.cu").read_text(), QUANT))
    (out / "mel.cu").write_text(_patch((src / "mel.cu").read_text(), MEL))
    procs = {
        n: subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                             str(out / f"lib{n}.so"), str(out / f"{n}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in ("decode_step", "lstm_scan", "quant_lstm", "mel")
    }
    logs = {n: p.communicate()[0] for n, p in procs.items()}  # every nvcc ends
    libs = {}
    for n, p in procs.items():
        if p.returncode:
            raise SystemExit(f"nvcc failed for {n}:\n{logs[n][-4000:]}")
        lib = ctypes.CDLL(str(out / f"lib{n}.so"))
        lib.rnnt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rnnt_cuda_error_string.restype = ctypes.c_char_p
        cuda_build._LIBS[n] = lib  # the wrappers launch the probed build
        libs[n] = lib
    return libs


def _segments(lib, steps: int, stamps: int, first: int, last: int):
    """Mean microseconds per iteration and per segment over iterations
    first .. last - 1 of the last launch."""
    import numpy as np

    buf = np.zeros(256 * 32, np.uint64)
    if lib.rnnt_prof_read(buf.ctypes.data) != 0:
        raise SystemExit("kernel_phases: could not read the stamps")
    a = buf.reshape(256, 32)[:steps, :stamps].astype(np.int64)
    segs = np.diff(a[first:last], axis=1).mean(axis=0) / 1e3
    per = (a[first + 1:last, 0] - a[first:last - 1, 0]).mean() / 1e3
    return float(per), [float(x) for x in segs]


def _cluster_segments(lib, steps: int):
    """Kernel C's bf16 loop over steps 2 .. steps - 2 of the last launch:
    mean microseconds per step and its sync, and per pass of warpgroup 0
    the split of its SM cycles into turn (waiting for the other warpgroup
    to have seen its pass's chunks), wait (for a chunk), mma and epi."""
    import numpy as np

    buf = np.zeros(256 * 32, np.uint64)
    if lib.rnnt_prof_read(buf.ctypes.data) != 0:
        raise SystemExit("kernel_phases: could not read the stamps")
    a = buf.reshape(256, 32)[:steps].astype(np.int64)[2:steps - 1]
    per = float(np.diff(a[:, 0]).mean() / 1e3)
    ns_per_cycle = (a[:, 1] - a[:, 0]) / a[:, 11]
    passes = a[:, 13].sum()
    split = [float((a[:, k] * ns_per_cycle).sum() / 1e3 / passes) for k in (12, 8, 9, 10)]
    return per, (*split, float((a[:, 2] - a[:, 1]).mean() / 1e3))


def _mel_phases(lib, dev) -> None:
    """Kernel D at chip_smoke.py kernel_d's shape: the segments of warp 0
    in every block (see the module's docstring)."""
    import numpy as np
    import torch

    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.ops import features as tf
    from rnnt_inference_tpu_torch.tools.mel_precision import kernel_d_input

    cfg = FeaturizerConfig()
    x, T = kernel_d_input(cfg)
    x = torch.from_numpy(x).to(dev)
    for _ in range(3):
        tf.fused_mel(x, T, cfg)
    torch.cuda.synchronize()
    buf = np.zeros(65536 * 16, np.uint64)
    lib.rnnt_dprof_read.argtypes = [ctypes.c_void_p]
    if lib.rnnt_dprof_read(buf.ctypes.data) != 0:
        raise SystemExit("kernel_phases: could not read kernel D's stamps")
    blocks = x.shape[0] * -(-T // lib.rnnt_log_mel_frames_per_block())
    r = buf.reshape(65536, 16)[:blocks].astype(np.int64)
    span_ns = r[:, 1] - r[:, 0]
    ns_per_cycle = span_ns.sum() / r[:, 11].sum()
    segs = np.stack([r[:, 3], r[:, 5], r[:, 6], r[:, 8] - r[:, 7], r[:, 9], r[:, 10]],
                    axis=1).mean(axis=0) * ns_per_cycle / 1e3
    per_sm = np.bincount(r[:, 2]).max()
    print(f"D N={x.shape[0]} T={T}: kernel {(r[:, 1].max() - r[:, 0].min()) / 1e3:.2f} us, "
          f"{blocks} blocks, at most {per_sm} on one SM, block mean {span_ns.mean() / 1e3:.2f} us "
          f"({1 / ns_per_cycle:.3f} cycles/ns); warp 0: "
          + ", ".join(f"{k} {v:.2f}" for k, v in zip(D_SEGMENTS, segs))
          + f", mel phase {(r[:, 11] - r[:, 8]).mean() * ns_per_cycle / 1e3:.2f} us", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    from rnnt_inference_tpu_torch.config import RNNTParams
    from rnnt_inference_tpu_torch.models.quant import QuantLSTMLayerWeights
    from rnnt_inference_tpu_torch.models.weights import LSTMLayerWeights, init_weights
    from rnnt_inference_tpu_torch.ops import cuda_build
    from rnnt_inference_tpu_torch.ops import decode_cuda as dc
    from rnnt_inference_tpu_torch.ops import lstm_cuda as la
    from rnnt_inference_tpu_torch.ops import lstm_scan_cuda as ls

    root = Path(__file__).resolve().parents[2]
    out = root / "build" / "kernel_phases"
    shutil.rmtree(out, ignore_errors=True)
    libs = _build(out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    sms = cuda_build.sm_count(dev)
    params = RNNTParams()
    rng = np.random.RandomState(0)
    _mel_phases(libs["mel"], dev)
    for dt in (torch.bfloat16, torch.float32):
        dw = dc.decode_weights(init_weights(params, torch.Generator().manual_seed(0), dtype=dt,
                                            device=dev))
        P, J, R = params.pred_hidden_size, params.joint_hidden_size, params.max_res_len
        for N in (16, 32, 64, 128):
            T2 = 1024  # every lane at frame 0 of 1024: none finishes in these 16 iterations
            fproj = torch.from_numpy(rng.randn(T2, N, J).astype(np.float32)).to(dev)
            z = np.zeros(N, np.int64)
            lanes = np.stack([z - 1, z, z, z - 1, z, z + T2, z + T2 - 1, z]).astype(np.int32)
            st = [torch.from_numpy(lanes).to(dev), torch.zeros(2, N, P, dtype=dt, device=dev),
                  torch.zeros(2, N, P, device=dev),
                  torch.full((N, R), -1, dtype=torch.int8, device=dev)]
            for _ in range(2):
                dc.decode_step_cuda(fproj, *st, dw, params, 16)
                torch.cuda.synchronize()
            per, segs = _segments(libs["decode_step"], 16, len(B_SEGMENTS) + 1, 2, 15)
            print(f"B {str(dt)[6:]} N={N}: {per:.2f} us per iteration; "
                  + ", ".join(f"{k} {v:.2f}" for k, v in zip(B_SEGMENTS, segs)), flush=True)
    H = 1024
    g = torch.Generator().manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        layer = LSTMLayerWeights(*(((torch.rand(s, generator=g) * 2 - 1) / 32).to(dev, dt)
                                   for s in ((H, 4 * H), (H, 4 * H), (4 * H,))))
        for N, T in ((16, 48), (128, 48), (1024, 16)):
            xw = (torch.randn(T, N, 4 * H, generator=g) * 0.5).to(dev, dt)
            h0, c0 = torch.zeros(N, H, dtype=dt, device=dev), torch.zeros(N, H, device=dev)
            by_size = dict(ls.CLUSTER_LAUNCHES)
            for _ in range(2):
                ls.lstm_recurrence_cuda(layer, xw, h0, c0)
                torch.cuda.synchronize()
            cs = ls.plan(H, N, dt, sms, lambda c: ls.max_clusters(dev, c, N, H))[2]
            if not cs:  # the pass engine
                per, segs = _segments(libs["lstm_scan"], T, len(C_SEGMENTS) + 1, 2, T - 1)
                print(f"C {str(dt)[6:]} N={N} T={T} (pass engine): {per:.2f} us per step; "
                      + ", ".join(f"{k} {v:.2f}" for k, v in zip(C_SEGMENTS, segs)), flush=True)
                continue
            launched = {k: v - by_size.get(k, 0) for k, v in ls.CLUSTER_LAUNCHES.items()
                        if v != by_size.get(k, 0)}
            per, (turn, wait, mma, epi, sync) = _cluster_segments(libs["lstm_scan"], T)
            print(f"C bf16 N={N} T={T}: {per:.2f} us per step, cluster size {cs} (launches by "
                  f"size {launched}), {-(-N // 128)} passes; a pass of warpgroup 0: turn "
                  f"{turn:.2f}, wait {wait:.2f}, mma {mma:.2f}, epi {epi:.2f}; sync {sync:.2f}",
                  flush=True)
    IC = 2048  # the first post layer, the widest
    i8 = lambda *s: torch.randint(-128, 128, s, generator=g, dtype=torch.int8).to(dev)
    scale = lambda v: torch.tensor(v, device=dev)
    layer = QuantLSTMLayerWeights(i8(IC, 4 * H), i8(H, 4 * H), torch.randn(4 * H, generator=g).to(dev),
                                  scale(16.0), scale(2000.0), scale(16.0))
    for N, T, hoist in ((16, T, False), (64, T, False), (1024, 16, False), (1024, 16, True)):
        x, h0 = i8(T, N, IC), i8(N, H)
        c0 = torch.zeros(N, H, device=dev)
        for _ in range(2):
            la.layer_on_path(layer, x, h0, c0, False, hoist)
            torch.cuda.synchronize()
        per, segs = _segments(libs["quant_lstm"], T, len(A_SEGMENTS) + 1, 2, T - 1)
        names = A_SEGMENTS
        if hoist:  # no pass engine: stamps 1, 2 and 5 are not written
            names = ("passes", "arrive", "prefetch", "wait")
            segs = [sum(segs[:3]), segs[3], segs[4] + segs[5], segs[6]]
        print(f"A int8 IC={IC} N={N} T={T}{' hoisted' if hoist else ''}: {per:.2f} us per "
              "step; " + ", ".join(f"{k} {v:.2f}" for k, v in zip(names, segs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
