// Kernel C: the float LSTM recurrence, one layer over T steps, for Hopper
// (sm_90a), as one persistent cooperative launch per layer call.
//
// Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_lstm_scan_kernel (reached
// through _lstm_recurrence and lstm_layer_pallas).  The input projection
// xw = x . W_ih + b is one large product outside the kernel (ops/lstm.py
// lstm_layer), stored in the compute dtype WT (bf16 or f32).  Per step t and
// lane n:
//   gates = float(xw_t) + h_{t-1} . W_hh         WT products, f32 sums
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)     f32
//   h_t   = sigmoid(o) * tanh(c), rounded to WT;  y_t = h_t
//
// What bounds it on an H100: a step does 2 N H 4H operations (1.07 GFLOP
// at N = 128, H = 1024: 1.1 us at the bf16 tensor-core rate, 16 us at the
// f32 FMA rate), and the steps run one after another, so each step also
// pays (1) a grid-wide barrier (about 1.2 us measured), and (2) every block
// reading all of h_{t-1} of its lanes from L2 (N H WT bytes per block:
// 256 KB in bf16 at N = 128, 32 MB per step over the grid), which arrives
// slowly right after the barrier (every SM asks for the same lines at
// once).  W_hh (8 MB bf16, 16 MB f32) does not fit one SM but fits the
// grid's shared memory.
//
// Design: one cooperative launch runs the whole time loop, with one grid
// barrier per step (none after the last); a grid that cannot be co-resident
// makes the launch fail and the wrapper raises.  Block b owns U hidden
// units j = b U .. b U + U - 1 and all four gate columns of each (i, f, g,
// o), so the cell update stays in the block; U = 8, so the grid (H / U
// blocks, one per SM) is co-resident up to H = 8 x the SM count: 128
// blocks at H = 1024.  The block's W_hh columns (H x 4U: 64 KB bf16,
// 128 KB f32) are copied into shared memory once and stay there for the
// call, laid out by the host (ops/cuda_build.py block_columns): in bf16 in mma fragment
// order, in f32 as (H, 4U) rows, in both with the columns ordered so that a
// thread's sums are all four gates of its units.  The block's c (N x U,
// f32) stays in shared memory from c0 to cT.  Each step is one pass
// (csrc/hopper.cuh pass_products) per 128 (bf16) or 64 (f32) lanes: h_{t-1}
// is copied with cp.async in chunks as wide as the shared memory left over
// allows (all of H at N = 16), the next chunk in flight while a chunk's
// products run, the warps spread over the lanes (or, for few lanes, over
// K, their sums added in a fixed order); the sums go to shared memory and
// every thread takes a share of the (lane, unit) cell updates, whose xw
// values it loads before the pass.  Products: bf16 on the tensor cores (mma.sync m16n8k16, lanes
// as M, f32 sums; bf16 products are exact in f32), f32 as FMA on the CUDA
// cores (no TF32), four lane rows per thread.  h_t goes to y_t in device
// memory, which every block reads back after the barrier; cp.async.cg
// reads through L2, never a stale L1 line.  The epilogue uses the _rn
// intrinsics and the file is built with --fmad=false, so it rounds as the
// plain twin (ops/lstm.py lstm_recurrence) does; only the summation order
// differs.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

struct Args {
  const void* xw;   // (T, N, 4 H) projection, bias included, WT
  const void* wop;  // per block: W_hh columns in kernel order
  const void* h0;   // (N, H) WT
  const float* c0;  // (N, H)
  void* y;          // (T, N, H) WT: read back after each barrier
  void* hT;         // (N, H) WT
  float* cT;        // (N, H)
  int T, N, H, ring_cap;
};

template <typename WT, int U>
__global__ void __launch_bounds__(THREADS, 1) lstm_scan(const Args a) {
  constexpr int NC = 4 * U, MT = Rows<WT>::MT, RMAX = Rows<WT>::RMAX;
  const WT* xw = static_cast<const WT*>(a.xw);
  const WT* h0 = static_cast<const WT*>(a.h0);
  WT* y = static_cast<WT*>(a.y);
  const int T = a.T, N = a.N, H = a.H, ring_cap = a.ring_cap;
  constexpr bool BF16 = sizeof(WT) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t wbytes = (size_t)H * NC * sizeof(WT);
  float* c_s = reinterpret_cast<float*>(smem + wbytes);                // (N, U)
  WT* ring = reinterpret_cast<WT*>(c_s + ((N * U + 3) & ~3));          // ring_cap elements
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * U;  // the block's first unit
  const size_t NH = (size_t)N * H;

  {  // the block's W_hh columns and c, for the whole call
    const uint4* src =
        reinterpret_cast<const uint4*>(static_cast<const char*>(a.wop) + blockIdx.x * wbytes);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < (int)(wbytes / 16); i += THREADS) dst[i] = src[i];
    for (int i = tid; i < N * U; i += THREADS) c_s[i] = a.c0[(size_t)(i / U) * H + j0 + i % U];
  }
  __syncthreads();

  // The epilogue is spread over all threads: pass pair q = tid + THREADS k
  // is lane row q / U, unit q % U.  Group 0's warps first leave the sums in
  // the ring (free once the pass is done) as sums[row][column], column
  // lcol(u, g) in the host's order (ops/cuda_build.py gate_columns).
  constexpr int KP = (RMAX * U + THREADS - 1) / THREADS;  // pairs per thread
  static_assert(RMAX * NC * 4 <= ring_min<WT>() * (int)sizeof(WT), "the sums fit the ring");
  auto lcol = [](int u, int g) {
    return BF16 ? 8 * (2 * (u / 4) + g / 2) + 2 * (u % 4) + g % 2 : 4 * u + g;
  };
  const int g8 = lane >> 2, q4 = lane & 3;
  float* sums = reinterpret_cast<float*>(ring);

  for (int t = 0; t < T; ++t) {
    const WT* hsrc = t == 0 ? h0 : y + (size_t)(t - 1) * NH;
    for (int p0 = 0; p0 < N; p0 += RMAX) {
      const int rows = min(RMAX, N - p0);
      const int WM = pass_wm(rows, MT), mt = warp % WM, kg = warp / WM;
      float xv[KP][4];  // the pairs' xw, loaded ahead of the products
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int q = tid + THREADS * k, n = p0 + q / U, u = q % U;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          xv[k][g] = q < rows * U
                         ? to_f(xw[((size_t)t * N + n) * 4 * H + (size_t)g * H + j0 + u])
                         : 0.0f;
      }
      PassAcc<WT, NC> acc;
      pass_products<WT, NC>(
          smem, H, rows, ring, ring_cap, xw,
          [&](int r) { return hsrc + (size_t)(p0 + r) * H; }, acc);
      if (kg == 0) {
        const float* flat = &acc.v[0][0];
#pragma unroll
        for (int r = 0; r < MT / 8; ++r) {
          float* srow = sums + (mt * MT + g8 + 8 * r) * NC;
#pragma unroll
          for (int c = 0; c < NC / 4; ++c) {  // the thread's columns
            const int col = BF16 ? 8 * (c / 2) + 2 * q4 + c % 2 : q4 * (NC / 4) + c;
            srow[col] = BF16 ? flat[(c / 2) * 4 + 2 * r + c % 2] : flat[r * (NC / 4) + c];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int q = tid + THREADS * k;
        if (q >= rows * U) break;
        const int row = q / U, u = q % U, n = p0 + row;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = __fadd_rn(xv[k][g], sums[row * NC + lcol(u, g)]);
        const float ig = sigmoid_f(gate[0]);
        const float fg = sigmoid_f(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoid_f(gate[3]);
        float* cp = c_s + n * U + u;
        const float cn = __fadd_rn(__fmul_rn(fg, *cp), __fmul_rn(ig, gg));
        *cp = cn;
        const WT h = store_as<WT>(__fmul_rn(og, tanhf(cn)));
        const size_t off = (size_t)n * H + j0 + u;
        y[(size_t)t * NH + off] = h;
        if (t == T - 1) static_cast<WT*>(a.hT)[off] = h;
      }
      __syncthreads();  // the ring is staged over next
    }
    if (t + 1 < T) cooperative_groups::this_grid().sync();  // y_t complete across the grid
  }
  __syncthreads();
  for (int i = tid; i < N * U; i += THREADS) a.cT[(size_t)(i / U) * H + j0 + i % U] = c_s[i];
}

template <typename WT, int U>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int N = a.N, H = a.H;
  // the staging ring takes what the block's other arrays leave
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = (size_t)H * 4 * U * sizeof(WT) + (size_t)((N * U + 3) & ~3) * 4;
  if (fixed + (size_t)ring_min<WT>() * sizeof(WT) > (size_t)limit) return cudaErrorInvalidValue;
  a.ring_cap = (int)(((size_t)limit - fixed) / sizeof(WT)) & ~7;
  const size_t smem = fixed + (size_t)a.ring_cap * sizeof(WT);
  auto kern = lstm_scan<WT, U>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(a.H / U),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One cooperative launch of H / U blocks on `stream` for all T steps;
// weight_bf16 selects the compute dtype (1: bf16, 0: f32), w_op is the
// layout of ops/cuda_build.py block_columns for U = 8 (the only unit
// count built).  Returns 0, or the CUDA error of a refused launch (a grid
// that cannot be co-resident: cudaErrorCooperativeLaunchTooLarge).
int rnnt_lstm_scan(int weight_bf16, int U, const void* xw, const void* w_op, const void* h0,
                   const void* c0, void* y, void* hT, void* cT, int T, int N, int H,
                   void* stream) {
  if (T <= 0 || N <= 0 || H <= 0 || H % 128 != 0 || U != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.xw = xw, a.wop = w_op, a.h0 = h0, a.c0 = static_cast<const float*>(c0);
  a.y = y, a.hT = hT, a.cT = static_cast<float*>(cT);
  a.T = T, a.N = N, a.H = H;
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(weight_bf16 ? launch<__nv_bfloat16, 8>(a, s) : launch<float, 8>(a, s));
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
