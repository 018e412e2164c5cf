// Kernel C: the float LSTM recurrence, one layer over T steps, for Hopper
// (sm_90a).
//
// Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_lstm_scan_kernel (reached
// through _lstm_recurrence and lstm_layer_pallas).  The input projection
// xw = x . W_ih + b is one large product outside the kernel (ops/lstm.py
// lstm_layer), stored in the compute dtype WT (bf16 or f32).  Per step t and
// lane n:
//   gates = float(xw_t) + h_{t-1} . W_hh         WT products, f32 sums
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)     f32
//   h_t   = sigmoid(o) * tanh(c), rounded to WT;  y_t = h_t
// bf16 products are exact in f32; f32 products use true f32 FMA (no TF32).
//
// What bounds it on an H100: each step reads all of W_hh (H x 4H: 8 MB in
// bf16, 16 MB in f32), which fits in the 50 MB L2 but not in shared memory,
// and does 2 N H 4H operations (1.07 GFLOP at N = 128, H = 1024).  The
// card's bound for a call is its operations at the tensor-core rate (bf16)
// or the f32 FMA rate (f32).  This first version runs every product on the
// CUDA cores in f32, so in bf16 its ceiling is the f32 FMA rate, and at
// small N each step waits on the weights coming from L2.
//
// Design (the simple, correct first version, after kernel A): one launch
// per time step.  A block owns UJ hidden units x BN lanes and computes all
// four gate rows (i, f, g, o) of its units, so the cell update stays in the
// block.  W_hh is pre-transposed once to (4H, H) rows, K contiguous, so a
// warp streams a gate row with 16-byte loads (8 bf16 or 2 x 4 f32 per
// lane).  h_{t-1} of the block's lanes is staged in shared memory as f32,
// each 8-value chunk split in two halves H/2 apart so that a warp's float4
// reads hit consecutive banks.  h_t is written to y_t, which the next step
// reads as h_{t-1}; c is updated in place.  Each gate sum is taken in a
// fixed order (per lane k = 8 lane + 256 i in order, then a butterfly over
// the warp).  The epilogue uses the _rn intrinsics and the file is built
// with --fmad=false, so it rounds as the plain twin (ops/lstm.py
// lstm_recurrence) does.  Tensor cores (mma/wgmma), a persistent kernel
// holding W_hh across the SMs' shared memory, and CUDA graphs over the
// step loop are for later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UJ = 8;              // hidden units per block
constexpr int ROWS = 4 * UJ;       // gate rows per block (i, f, g, o of each unit)
constexpr int BN = 16;             // lanes per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = ROWS / WARPS;  // gate rows per warp

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename WT>
__device__ __forceinline__ WT store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// torch.sigmoid's formula: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
lstm_scan_step(const WT* __restrict__ xw_t,  // (N, 4H) the step's projection, bias included
               const WT* __restrict__ h_in,  // (N, H) h_{t-1}
               const float* c_in,            // (N, H); may alias c_out
               const WT* __restrict__ w,     // (4H, H): W_hh transposed
               int N, int H,
               WT* __restrict__ y_t,         // (N, H) h_t
               WT* __restrict__ h_last,      // (N, H) h_t again, or null
               float* c_out) {               // (N, H)
  extern __shared__ __align__(16) float hs[];  // (BN, H) h_{t-1} as f32
  float* gsum = hs + BN * H;                   // (ROWS, BN) gate sums
  const int j0 = blockIdx.x * UJ;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int hv = H >> 3;     // 8-value chunks per row
  const int half = H >> 1;

  // 1. stage h_{t-1}: chunk c of row r goes to [r*H + 4c] and [r*H + H/2 + 4c]
  for (int idx = tid; idx < BN * hv; idx += THREADS) {
    const int r = idx / hv;
    const int c = idx - r * hv;
    const int n = n0 + r;
    float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (n < N) load8(h_in + (size_t)n * H + 8 * c, v);
    *reinterpret_cast<float4*>(hs + r * H + 4 * c) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(hs + r * H + half + 4 * c) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  // 2. gate sums: warp w owns block rows RPW*w .. RPW*w + RPW-1; block row r
  //    is gate r / UJ of unit j0 + r % UJ
  const int warp = tid >> 5, lane = tid & 31;
  const WT* wrow[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = warp * RPW + q;
    wrow[q] = w + (size_t)((r / UJ) * H + j0 + (r % UJ)) * H;
  }
  float acc[RPW][BN];
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int n = 0; n < BN; ++n) acc[q][n] = 0.0f;

  for (int c = lane; c < hv; c += 32) {
    float wv[RPW][8];
#pragma unroll
    for (int q = 0; q < RPW; ++q) load8(wrow[q] + 8 * c, wv[q]);
#pragma unroll
    for (int n = 0; n < BN; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(hs + n * H + 4 * c);
      const float4 b = *reinterpret_cast<const float4*>(hs + n * H + half + 4 * c);
      const float h8[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < RPW; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][n] = __fmaf_rn(h8[e], wv[q][e], acc[q][n]);
    }
  }
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
#pragma unroll
    for (int n = 0; n < BN; ++n) {
      float v = acc[q][n];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) gsum[(warp * RPW + q) * BN + n] = v;
    }
  }
  __syncthreads();

  // 3. epilogue: one thread per (lane, unit)
  if (tid < UJ * BN) {
    const int nl = tid / UJ, u = tid - nl * UJ;
    const int n = n0 + nl, j = j0 + u;
    if (n < N) {
      const WT* xr = xw_t + (size_t)n * 4 * H;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gate[g] = __fadd_rn(to_f(xr[g * H + j]), gsum[(g * UJ + u) * BN + nl]);
      const float ig = sigmoid_f(gate[0]);
      const float fg = sigmoid_f(gate[1]);
      const float gg = tanhf(gate[2]);
      const float og = sigmoid_f(gate[3]);
      const size_t off = (size_t)n * H + j;
      const float cn = __fadd_rn(__fmul_rn(fg, c_in[off]), __fmul_rn(ig, gg));
      const WT h = store_as<WT>(__fmul_rn(og, tanhf(cn)));
      c_out[off] = cn;
      y_t[off] = h;
      if (h_last != nullptr) h_last[off] = h;
    }
  }
}

template <typename WT>
cudaError_t run_layer(const WT* xw, const WT* w, const WT* h0, const float* c0, WT* y,
                      WT* hT, float* cT, int T, int N, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BN * H + (size_t)ROWS * BN);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_step<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H / UJ, (N + BN - 1) / BN);
  const size_t step = (size_t)N * H;
  for (int t = 0; t < T; ++t) {
    lstm_scan_step<WT><<<grid, THREADS, smem, stream>>>(
        xw + (size_t)t * 4 * step, t == 0 ? h0 : y + (t - 1) * step, t == 0 ? c0 : cT, w, N,
        H, y + t * step, t == T - 1 ? hT : nullptr, cT);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// T launches on `stream`; weight_bf16 selects the compute dtype (1: bf16,
// 0: f32).  Returns 0, or the CUDA error of the first refused launch.
int rnnt_lstm_scan(int weight_bf16, const void* xw, const void* w_t, const void* h0,
                   const void* c0, void* y, void* hT, void* cT, int T, int N, int H,
                   void* stream) {
  if (T <= 0 || N <= 0 || H <= 0 || H % 8 != 0 || (N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      weight_bf16
          ? run_layer<__nv_bfloat16>(
                static_cast<const __nv_bfloat16*>(xw), static_cast<const __nv_bfloat16*>(w_t),
                static_cast<const __nv_bfloat16*>(h0), static_cast<const float*>(c0),
                static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(hT),
                static_cast<float*>(cT), T, N, H, s)
          : run_layer<float>(static_cast<const float*>(xw), static_cast<const float*>(w_t),
                             static_cast<const float*>(h0), static_cast<const float*>(c0),
                             static_cast<float*>(y), static_cast<float*>(hT),
                             static_cast<float*>(cT), T, N, H, s);
  return static_cast<int>(err);
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
