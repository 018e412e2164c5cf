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
//
// The causal form (depthwise_causal) serves the cache-aware FastConformer's
// convolution module (ops/depthwise_cuda.py states it): per slot s, row t <
// C of its chunk and channel c
//   y[t, c] = sum_k w[k, c] xs[t + k, c] + b[c],  xs = [cache_s (K - 1 rows); x_s]
//   out     = silu(LayerNorm(y) over the D channels)
// and the slot's cache becomes the last K - 1 rows of xs, in the same
// launch.  A block of D / 2 threads owns a slot; a thread owns two
// neighbouring channels: their K taps, their K - 1 + C rows and their sums
// in registers (a warp reads 128 contiguous bytes a row), so the cache is
// read and rewritten by the thread that owns its channels and needs no
// barrier.  The LayerNorm's mean and then variance of each row are block
// reductions (warp shuffles, then one partial a warp in shared memory);
// sums in tap order, statistics and Swish in f32, the output rounded once
// to bf16.  Bound: bandwidth and, at a chunk's few rows, latency.

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

// ---- the causal form --------------------------------------------------------

constexpr int CMAX = 16;   // rows of a chunk
constexpr int WMAX = 16;   // warps of a block: D <= 1024

// the sum over the block of each thread's v[0 .. C), into tot[0 .. C)
__device__ __forceinline__ void block_sums(float (&v)[CMAX], int C, float (*red)[CMAX],
                                           float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 0; o < CMAX; ++o) {
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) v[o] = __fadd_rn(v[o], __shfl_xor_sync(0xffffffffu, v[o], sh));
  }
  if (lane == 0) {
#pragma unroll
    for (int o = 0; o < CMAX; ++o) red[warp][o] = v[o];
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s = __fadd_rn(s, red[w][threadIdx.x]);
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(512)
    depthwise_causal(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ cache,
                     const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ gain, const float* __restrict__ shift,
                     __nv_bfloat16* __restrict__ out, int C, int D, float eps) {
  __shared__ float red[WMAX][CMAX];
  __shared__ float mean[CMAX], var[CMAX];
  const long long s = blockIdx.x;
  const int col = 2 * threadIdx.x;
  __nv_bfloat16* cs = cache + s * (K - 1) * D + col;
  const __nv_bfloat16* xr = x + s * C * D + col;

  float2 xs[K - 1 + CMAX];
#pragma unroll
  for (int r = 0; r < K - 1; ++r)
    xs[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cs + (long long)r * D));
#pragma unroll
  for (int r = 0; r < CMAX; ++r)
    xs[K - 1 + r] = r < C ? __bfloat1622float2(
                                *reinterpret_cast<const __nv_bfloat162*>(xr + (long long)r * D))
                          : make_float2(0.0f, 0.0f);
  float wa[K], wb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float2 wk = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(w + (long long)k * D + col));
    wa[k] = wk.x;
    wb[k] = wk.y;
  }
  const float ba = bias[col], bb = bias[col + 1];
  float ya[CMAX], yb[CMAX], part[CMAX];
#pragma unroll
  for (int o = 0; o < CMAX; ++o) {
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sa = __fadd_rn(sa, __fmul_rn(wa[k], xs[o + k].x));
      sb = __fadd_rn(sb, __fmul_rn(wb[k], xs[o + k].y));
    }
    ya[o] = __fadd_rn(sa, ba);
    yb[o] = __fadd_rn(sb, bb);
    part[o] = o < C ? __fadd_rn(ya[o], yb[o]) : 0.0f;
  }
  // the new cache, rows C .. C + K - 2 of xs (each thread its own channels)
#pragma unroll
  for (int j = 0; j < K - 1 + CMAX; ++j)
    if (j >= C && j < C + K - 1)
      *reinterpret_cast<__nv_bfloat162*>(cs + (long long)(j - C) * D) =
          __floats2bfloat162_rn(xs[j].x, xs[j].y);

  const float inv_d = 1.0f / static_cast<float>(D);
  block_sums(part, C, red, mean);
#pragma unroll
  for (int o = 0; o < CMAX; ++o) {
    const float mu = o < C ? __fmul_rn(mean[o], inv_d) : 0.0f;
    const float da = __fsub_rn(ya[o], mu), db = __fsub_rn(yb[o], mu);
    part[o] = o < C ? __fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)) : 0.0f;
  }
  block_sums(part, C, red, var);
  const float ga = gain[col], gb = gain[col + 1], sa = shift[col], sb = shift[col + 1];
#pragma unroll
  for (int o = 0; o < CMAX; ++o) {
    if (o >= C) break;
    const float mu = __fmul_rn(mean[o], inv_d);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(var[o], inv_d), eps)));
    const float za = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(ya[o], mu), rstd), ga), sa);
    const float zb = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(yb[o], mu), rstd), gb), sb);
    *reinterpret_cast<__nv_bfloat162*>(out + (s * C + o) * D + col) =
        __floats2bfloat162_rn(__fmul_rn(za, sigmoid_f(za)), __fmul_rn(zb, sigmoid_f(zb)));
  }
}

}  // namespace

extern "C" {

// The causal form, one launch on `stream` over N slots: x (N C, D) bf16,
// cache (N, K - 1, D) bf16 (replaced in place by the last K - 1 rows of
// [cache; x]), w (K, D) bf16, b, gain, shift (D) f32 -> out (N C, D) bf16;
// K = 9 (the streaming FastConformer's), C <= 16, D a multiple of 64 up to
// 1,024.  Returns 0, or the CUDA error (cudaErrorInvalidValue for
// arguments it cannot take).
int rnnt_depthwise_causal(const void* x, void* cache, const void* w, const void* b,
                          const void* gain, const void* shift, void* out, int N, int C, int D,
                          int K, float eps, void* stream) {
  if (K != 9 || N <= 0 || C < 1 || C > CMAX || D <= 0 || D % 64 != 0 || D > 32 * 2 * WMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  depthwise_causal<9><<<N, D / 2, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(cache),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<const float*>(gain), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(out), C, D, eps);
  return static_cast<int>(cudaGetLastError());
}

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
