// Kernel G: the Conformer convolution module's depthwise convolution, its
// bias (BatchNorm folded in) and Swish in one pass over the varlen rows, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no convolution module.  It
// was added because the library's path is slow on the varlen layout
// (ops/depthwise_cuda.py).  Per row r and channel c of x (R, D) bf16:
//   out[r, c] = silu(sum_k w[k, c] x[r + k - K / 2, c] + b[c])
// where rows that are gaps (no utterance owns them) or lie past either end
// read as zero, so no sum reaches across utterances; the sums, the bias and
// Swish in f32 (sum in tap order), the output rounded once to bf16.
//
// What bounds it on an H100: 2 K operations per element against 4 bytes
// (one bf16 read of x, one bf16 write), far below the card's ridge: it is
// bound by bandwidth.
//
// Design.  A block of 8 warps owns BR = 128 rows by 64 channels: it stages
// the BR + K - 1 rows its taps reach (128 bytes a row; gaps and rows past
// either end as zeros, by cp.async's zero fill) in shared memory once, so
// each input is read from memory about once (the K - 1 halo rows from L2).
// A lane owns two neighbouring channels, their K taps' weights in
// registers, and a warp 16 consecutive rows: each staged row it reads (one
// conflict-free 128-byte row a warp) feeds up to K of its 16 sums, so the
// FMA pipe and not shared memory sets the pace.  Stores are 128 bytes a
// warp and row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::sigmoid_f;

constexpr int BR = 128;         // rows a block
constexpr int BC = 64;          // channels a block
constexpr int THREADS_G = 256;  // 8 warps of RT rows
constexpr int RT = BR / (THREADS_G / 32);

template <int K>
__global__ void __launch_bounds__(THREADS_G)
    depthwise_silu(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ gaps,
                   const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, long long R, int D) {
  constexpr int ROWS = BR + K - 1;
  __shared__ __align__(16) __nv_bfloat162 xs[ROWS][BC / 2];
  const long long r0 = (long long)blockIdx.x * BR;
  const int c0 = blockIdx.y * BC, tid = threadIdx.x;

  for (int c = tid; c < ROWS * (BC / 8); c += THREADS_G) {
    const int row = c / (BC / 8), part = c % (BC / 8);
    const long long src = r0 + row - K / 2;
    bool ok = src >= 0 && src < R;
    ok = ok && gaps[ok ? src : 0] == 0;
    cp_async16(&xs[row][4 * part], x + (ok ? src : 0) * D + c0 + 8 * part, ok);
  }
  cp_async_commit();

  const int cp = tid & 31, rl = RT * (tid >> 5);  // channel pair, first row of the warp
  const int col = c0 + 2 * cp;
  float wa[K], wb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float2 wk = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(w + (long long)k * D + col));
    wa[k] = wk.x;
    wb[k] = wk.y;
  }
  const float ba = bias[col], bb = bias[col + 1];
  float acc[RT][2];
#pragma unroll
  for (int o = 0; o < RT; ++o) acc[o][0] = acc[o][1] = 0.0f;

  cp_async_wait<0>();
  __syncthreads();
  // staged row rl + i is tap i - o of output row rl + o
#pragma unroll
  for (int i = 0; i < RT + K - 1; ++i) {
    const float2 xv = __bfloat1622float2(xs[rl + i][cp]);
#pragma unroll
    for (int o = 0; o < RT; ++o) {
      const int k = i - o;
      if (k >= 0 && k < K) {
        acc[o][0] = __fadd_rn(acc[o][0], __fmul_rn(wa[k], xv.x));
        acc[o][1] = __fadd_rn(acc[o][1], __fmul_rn(wb[k], xv.y));
      }
    }
  }
#pragma unroll
  for (int o = 0; o < RT; ++o) {
    const long long r = r0 + rl + o;
    if (r >= R) break;
    const float ya = __fadd_rn(acc[o][0], ba), yb = __fadd_rn(acc[o][1], bb);
    *reinterpret_cast<__nv_bfloat162*>(out + r * D + col) =
        __floats2bfloat162_rn(__fmul_rn(ya, sigmoid_f(ya)), __fmul_rn(yb, sigmoid_f(yb)));
  }
}

template <int K>
cudaError_t launch(const void* x, const void* gaps, const void* w, const void* b, void* out,
                   long long R, int D, cudaStream_t stream) {
  const dim3 grid((unsigned)((R + BR - 1) / BR), D / BC);
  depthwise_silu<K><<<grid, THREADS_G, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(gaps),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), R, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on `stream`: x (R, D) bf16 on a 16-byte boundary, gaps (R)
// uint8 (nonzero: read as zero), w (K, D) bf16, b (D) f32 -> out (R, D)
// bf16; D a multiple of 64, K = 31 (the Conformer's).  Returns 0, or the
// CUDA error (cudaErrorInvalidValue for arguments it cannot take).
int rnnt_depthwise_silu(const void* x, const void* gaps, const void* w, const void* b, void* out,
                        long long R, int D, int K, void* stream) {
  if (K != 31 || R <= 0 || D <= 0 || D % BC != 0 || D / BC > 65535 ||
      (R + BR - 1) / BR > 0x7fffffffLL || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<31>(x, gaps, w, b, out, R, D, static_cast<cudaStream_t>(stream)));
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
