// Kernel D: the fused featurizer middle (frames -> windowed DFT -> power ->
// mel -> log), for Hopper (sm_90a).
//
// Replaces rnnt_inference_tpu/ops/features_pallas.py::_mel_kernel (reached
// through _fused_mel and log_mel_features_pallas).  Per utterance n and frame t:
//   frame  = x[n, t*hop : t*hop + 2*hop]           (zeros past S)
//   re, im = frame . cos, frame . sin               (2 hop x K, window folded in)
//   spec   = (re*re + im*im) + dither^2
//   out    = log(spec . fbT + 1e-20)                (K x M)
// K = 257 bins and M = 80 mels at the reference dims.
//
// What bounds it on an H100: about 370 k f32 operations per frame against
// 640 bytes of waveform read and 320 bytes of features written, so it is
// bound by operations.  The f32 contract (ROADMAP "Numeric contracts", the
// drift gate of tests/test_features.py) rules out TF32 and bf16 tensor
// cores, so the ceiling is f32 FMA on the CUDA cores (67 TFLOP/s).
//
// Design (the simple, correct first version): a block owns FT = 32
// consecutive frames of one utterance.  It stages the (FT + 1) * hop samples
// those frames cover in shared memory once; frame f is the window at offset
// f * hop there, so framing needs no gather and no second read of the
// waveform.  Thread k owns DFT bin k for all FT frames (2 FT accumulators in
// registers), reads row s of cos/sin at column k (coalesced across threads;
// the 658 KB of constants stay in L2), and reads the frames as broadcast
// float4 loads from shared memory.  The power spectrum goes to shared
// memory; the block then computes its FT x M mel sums, adds 1e-20, takes the
// log and writes only (N, T, M).  Each dot product is summed in a fixed
// order with fmaf; the file is built with --fmad=false, so the rest rounds
// as written.  3xTF32 tensor-core products and a tiled GEMM shape are for
// later versions.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;        // frames per block
constexpr int THREADS = 288;  // 9 warps: one pass over the bins for K <= 288

__global__ void __launch_bounds__(THREADS)
log_mel(const float* __restrict__ x,     // (N, S)
        const float* __restrict__ cosm,  // (2 hop, K)
        const float* __restrict__ sinm,  // (2 hop, K)
        const float* __restrict__ fbt,   // (K, M)
        float* __restrict__ out,         // (N, T, M)
        int S, int T, int hop, int K, int M, float dither2) {
  extern __shared__ __align__(16) float sm[];
  const int seg_len = (FT + 1) * hop;
  float* seg = sm;             // the block's samples
  float* spec = sm + seg_len;  // (FT, K) power spectrum
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int flen = 2 * hop;
  const float* xn = x + (size_t)n * S;
  const long long base = (long long)t0 * hop;

  for (int i = tid; i < seg_len; i += THREADS) {
    const long long s = base + i;
    seg[i] = s < S ? xn[s] : 0.0f;
  }
  __syncthreads();

  // 1. windowed DFT and power: thread k owns bin k of the block's frames
  for (int k = tid; k < K; k += THREADS) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      re[f] = 0.0f;
      im[f] = 0.0f;
    }
    for (int s = 0; s < flen; s += 4) {
      float c[4], sn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = __ldg(cosm + (size_t)(s + q) * K + k);
        sn[q] = __ldg(sinm + (size_t)(s + q) * K + k);
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(seg + f * hop + s);
        re[f] = __fmaf_rn(v.x, c[0], re[f]);
        im[f] = __fmaf_rn(v.x, sn[0], im[f]);
        re[f] = __fmaf_rn(v.y, c[1], re[f]);
        im[f] = __fmaf_rn(v.y, sn[1], im[f]);
        re[f] = __fmaf_rn(v.z, c[2], re[f]);
        im[f] = __fmaf_rn(v.z, sn[2], im[f]);
        re[f] = __fmaf_rn(v.w, c[3], re[f]);
        im[f] = __fmaf_rn(v.w, sn[3], im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f)
      spec[f * K + k] =
          __fadd_rn(__fadd_rn(__fmul_rn(re[f], re[f]), __fmul_rn(im[f], im[f])), dither2);
  }
  __syncthreads();

  // 2. mel sums, + 1e-20, log; consecutive threads take consecutive mels
  const int nf = min(FT, T - t0);
  for (int o = tid; o < nf * M; o += THREADS) {
    const int f = o / M, m = o - f * M;
    const float* sp = spec + f * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = __fmaf_rn(sp[k], __ldg(fbt + (size_t)k * M + m), acc);
    out[((size_t)n * T + t0 + f) * M + m] = logf(__fadd_rn(acc, 1e-20f));
  }
}

}  // namespace

extern "C" {

// One launch on `stream`: x (N, S) -> out (N, T, M).  Returns 0 or the CUDA
// error of the refused launch.
int rnnt_log_mel(const void* x, const void* cosm, const void* sinm, const void* fbt,
                 void* out, int N, int S, int T, int hop, int K, int M, float dither2,
                 void* stream) {
  if (N <= 0 || N > 65535 || T <= 0 || S < 0 || hop <= 0 || hop % 4 != 0 || K <= 0 ||
      M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)(FT + 1) * hop + (size_t)FT * K);
  cudaError_t err = cudaFuncSetAttribute(log_mel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + FT - 1) / FT, N);
  log_mel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cosm),
      static_cast<const float*>(sinm), static_cast<const float*>(fbt),
      static_cast<float*>(out), S, T, hop, K, M, dither2);
  return static_cast<int>(cudaGetLastError());
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
