// Kernel A: one int8 LSTM layer over T steps, for Hopper (sm_90a), as one
// persistent cooperative launch per layer call.
//
// Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_quant_lstm_cat_kernel
// (reached through quant_lstm_layer_pallas).  Per step t and lane n:
//   acc   = x_t . W_ih + h_{t-1} . W_hh         int8 x int8 -> int32 (exact)
//   gates = float(acc) * rb + bias              f32
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h     = sigmoid(o) * tanh(c)
//   h_t   = quantize(h, in_scale)               int8, the recurrence
//   y_t   = quantize(h, out_scale) or h (f32, the last post layer)
// quantize = round half to even (__float2int_rn), clamp to [-128, 127].
//
// What bounds it on an H100: a step does 2 N (IC + H) 4H operations (1.6
// GOP at N = 64, IC = 2048, H = 1024: 0.8 us at the int8 tensor-core rate),
// but the steps run one after another, so each step also pays a grid-wide
// barrier and every block reading all of h_{t-1} (N H bytes) and x_t (N IC
// bytes) of its lanes from L2, right after the barrier for h.  The weights,
// (IC + H) 4H bytes (5.2, 8.4 or 12.6 MB by layer), fit the grid's shared
// memory but not one SM's.
//
// Design: one cooperative launch runs the whole time loop; a grid that
// cannot be co-resident makes the launch fail and the wrapper raises.
// Block b owns U = 8 hidden units j = 8 b .. 8 b + 7 and all four gate
// columns of each (i, f, g, o), so the cell update stays in the block: 128
// blocks at H = 1024, one to an SM.  The block's columns of W_ih and W_hh
// ((IC + H) x 32 int8: 40 KB at IC = 240, 96 KB at IC = 2048) are copied
// into shared memory once and stay there for the call, as the TPU kernel
// keeps both matrices in VMEM; the host lays them out once per weight set
// (ops/lstm_cuda.py kernel_operands) in mma fragment order, K padded with
// zero rows to a multiple of 64 (IC = 240 -> 256; cp.async's zero fill
// pads the x rows).  The block's c (N x U, f32) stays in shared memory
// from c0 to cT.  Products run on the int8 tensor cores (mma.sync
// m16n8k32, s32 sums, lanes as M) through the pass engine of
// csrc/hopper.cuh, up to 128 lanes per pass.
// x_t does not depend on h_{t-1}, so x_{t+1} . W_ih of the first 128
// lanes is computed between arriving at step t's grid barrier and waiting
// on it (hopper.cuh's split barrier: one word whose top bit is the
// generation), and its sums stay in the pass's registers, each warp's
// k-group share unreduced; after the wait the h_{t-1} . W_hh pass (K = H)
// adds onto them, every warp leaves its share in shared memory, and each
// epilogue thread adds the shares of its (lane, unit): the two products
// are summed in int32 before the float epilogue (float(ax + ah), as the
// twin; int32 sums are exact in any order).  Lanes past the first 128
// (a second pass) take their x product after the wait.  Every block reads
// all of x.
// The recurrent h is not y (y is quantized with out_scale, or f32), so h_t
// goes to a ping-pong int8 buffer (2, N, H) that every block reads after
// the barrier through cp.async.cg (L2, never a stale L1 line); hT and cT
// are written once at the end.  The epilogue is spread over all threads
// (pair q = tid + 256 k is lane q / 8, unit q % 8), uses the _rn
// intrinsics, and the file is built with --fmad=false, so it rounds as the
// plain twin (ops/lstm_int8.py quant_lstm_layer) does: the two agree bit
// for bit.
//
// Rank mode (tensor parallelism, parallel/tensor.py): model rank r of k
// holds units [j_base, j_base + Hl), Hl = H / k, of the layer (its weight
// slice, ops/lstm_cuda.py kernel_operands of parallel/mesh.py
// rank_weights), and one launch runs one step of Hl / U blocks: blocks
// that do exactly the work of one-card blocks j_base / U .. (j_base + Hl)
// / U - 1 with the same code.  It reads the full-width h_{t-1} (N, H) that
// every rank wrote, keeps c (N, Hl) in device memory between launches,
// and stores its h_t and y_t slices into each of the nr ranks' full-width
// buffers (peer pointers across cards): the exchange, done by the kernel.
// The one-card launch is the same code with nr = 1, Hl = H, j_base = 0.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int U = 8;                     // hidden units per block
constexpr int NC = 4 * U;                // gate columns per block
constexpr int MT = Rows<int8_t>::MT, RMAX = Rows<int8_t>::RMAX;
constexpr int KP = RMAX * U / THREADS;   // (lane, unit) pairs per thread in a pass
static_assert(THREADS % U == 0, "a thread keeps one unit in every pass");
constexpr int PST = NC + 8;              // words per row of the warps' sums: int2
                                         // stores and loads free of bank conflicts
static_assert(WARPS * MT * PST * 4 <= ring_min<int8_t>(), "the warps' sums fit the ring");

struct Args {
  const int8_t* x;     // (T, N, IC)
  const int8_t* wop;   // (Hl / U, (ICP + HP) NC): per block W_ih's, then W_hh's columns
  const float* bias;   // (4 Hl)
  const int8_t* h0;    // (N, H)
  const float* c0;     // (N, Hl)
  void* y[MAXR];       // (T, N, H) int8, or f32: each rank's, [0] this rank's
  int8_t* hT[MAXR];    // (N, H): each rank's, as y
  float* cT;           // (N, Hl)
  int8_t* hbuf;        // (2, N, H): h_t, read back by every block after the barrier
  unsigned* bar;       // the grid barrier (hopper.cuh grid_arrive)
  float rb, in_scale, out_scale;
  int T, N, IC, ICP, H, HP, ring_cap;
  int Hl, j_base, nr;  // units of this launch, the first one's index, ranks written
};

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const int q = __float2int_rn(__fmul_rn(v, scale));
  return static_cast<int8_t>(max(-128, min(127, q)));
}

template <bool EMIT_F32>
__global__ void __launch_bounds__(THREADS, 1) quant_lstm(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t wbytes = (size_t)(a.ICP + a.HP) * NC;
  const int8_t* wih_s = reinterpret_cast<const int8_t*>(smem);
  const int8_t* whh_s = wih_s + (size_t)a.ICP * NC;
  float* c_s = reinterpret_cast<float*>(smem + wbytes);               // (N, U)
  int8_t* ring = reinterpret_cast<int8_t*>(c_s + ((a.N * U + 3) & ~3));  // ring_cap bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q4 = lane & 3;
  // jl0: the block's first unit in this launch's slice; j0: in the layer
  const int N = a.N, H = a.H, Hl = a.Hl, jl0 = blockIdx.x * U, j0 = a.j_base + jl0;
  const size_t NH = (size_t)N * H;

  {  // the block's weight columns and c, for the whole call
    const uint4* src = reinterpret_cast<const uint4*>(a.wop + blockIdx.x * wbytes);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < (int)(wbytes / 16); i += THREADS) dst[i] = src[i];
    for (int i = tid; i < N * U; i += THREADS) c_s[i] = a.c0[(size_t)(i / U) * Hl + jl0 + i % U];
  }
  __syncthreads();

  // x_t . W_ih of lanes p0 .. p0 + rows - 1 into acc, unreduced: each
  // warp keeps its k-group's share for the h pass to add onto
  auto x_products = [&](int t, int p0, int rows, PassAcc<int8_t, NC>& acc) {
    const int8_t* xt = a.x + ((size_t)t * N + p0) * a.IC;
    pass_products<int8_t, NC>(
        wih_s, a.ICP, rows, ring, a.ring_cap, a.x,
        [&](int r) { return xt + (size_t)r * a.IC; }, acc, a.IC, false, false);
  };

  // The epilogue: pass pair q = tid + THREADS k is lane row q / U, unit
  // u = q % U = tid % U.  Every warp first leaves its k-group's sums in the
  // ring (free once the pass is done) as part[k-group][row][column], in the
  // host's column order (ops/cuda_build.py gate_columns): gates 0, 1 of
  // unit u are the int2 at c2 = 8 (u / 4) + u % 4 of a row, gates 2, 3 the
  // int2 at c2 + 4.
  const int u = tid % U, c2 = 8 * (u / 4) + u % 4;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = a.bias[g * Hl + jl0 + u];
  int* part = reinterpret_cast<int*>(ring);

  PassAcc<int8_t, NC> xacc;  // x_t . W_ih of the first pass's lanes, made before the step
  x_products(0, 0, min(RMAX, N), xacc);
  for (int t = 0; t < a.T; ++t) {
    const int8_t* hsrc = t == 0 ? a.h0 : a.hbuf + (size_t)((t - 1) & 1) * NH;
    int8_t* hdst = t == a.T - 1 ? nullptr : a.hbuf + (size_t)(t & 1) * NH;  // null: hT
    for (int p0 = 0; p0 < N; p0 += RMAX) {
      const int rows = min(RMAX, N - p0);
      const int WM = pass_wm(rows, MT), WK = WARPS / WM, mt = warp % WM, kg = warp / WM;
      PassAcc<int8_t, NC> acc;
      if (p0 == 0)
        acc = xacc;
      else
        x_products(t, p0, rows, acc);
      pass_products<int8_t, NC>(
          whh_s, a.HP, rows, ring, a.ring_cap, a.x,
          [&](int r) { return hsrc + (size_t)(p0 + r) * H; }, acc, H, true, false);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int2* prow = reinterpret_cast<int2*>(part + (kg * WM * MT + mt * MT + g8 + 8 * r) * PST);
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
          prow[4 * j + q4] = make_int2(acc.v[j][2 * r], acc.v[j][2 * r + 1]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int q = tid + THREADS * k;
        if (q >= rows * U) break;
        const int row = q / U, n = p0 + row;
        int sum[4] = {0, 0, 0, 0};
        for (int kq = 0; kq < WK; ++kq) {
          const int2* prow = reinterpret_cast<const int2*>(part + (kq * WM * MT + row) * PST);
          const int2 s01 = prow[c2], s23 = prow[c2 + 4];
          sum[0] += s01.x;
          sum[1] += s01.y;
          sum[2] += s23.x;
          sum[3] += s23.y;
        }
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gate[g] = __fadd_rn(__fmul_rn(__int2float_rn(sum[g]), a.rb), bias[g]);
        const float ig = sigmoid_f(gate[0]);
        const float fg = sigmoid_f(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoid_f(gate[3]);
        float* cp = c_s + n * U + u;
        const float cn = __fadd_rn(__fmul_rn(fg, *cp), __fmul_rn(ig, gg));
        *cp = cn;
        const float h = __fmul_rn(og, tanhf(cn));
        const size_t off = (size_t)n * H + j0 + u;
        const int8_t hq = quantize(h, a.in_scale);
        if (hdst) hdst[off] = hq;
        for (int r = 0; r < a.nr; ++r) {
          if (!hdst) a.hT[r][off] = hq;
          if (EMIT_F32)
            static_cast<float*>(a.y[r])[t * NH + off] = h;
          else
            static_cast<int8_t*>(a.y[r])[t * NH + off] = quantize(h, a.out_scale);
        }
      }
      __syncthreads();  // the ring is staged over next
    }
    if (t + 1 < a.T) {  // h_t complete across the grid after the wait
      const unsigned old = grid_arrive(a.bar);
      x_products(t + 1, 0, min(RMAX, N), xacc);  // needs no other block's h_t
      grid_wait(a.bar, old);
    }
  }
  __syncthreads();
  for (int i = tid; i < N * U; i += THREADS) a.cT[(size_t)(i / U) * Hl + jl0 + i % U] = c_s[i];
}

template <bool EMIT_F32>
cudaError_t launch(Args a, cudaStream_t stream) {
  // the staging ring takes what the block's other arrays leave
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = (size_t)(a.ICP + a.HP) * NC + (size_t)((a.N * U + 3) & ~3) * 4;
  if (fixed + (size_t)ring_min<int8_t>() > (size_t)limit) return cudaErrorInvalidValue;
  a.ring_cap = (int)((size_t)limit - fixed) & ~15;
  const size_t smem = fixed + (size_t)a.ring_cap;
  auto kern = quant_lstm<EMIT_F32>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(a.Hl / U),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One cooperative launch of H / 8 blocks on `stream` for all T steps.
// w_op is the layout of ops/lstm_cuda.py kernel_operands; hbuf (2, N, H)
// int8 is scratch; bar (one u32) is the grid barrier's state, zeroed once
// and reused by every launch on the stream.  Returns 0, or the CUDA error
// of a refused launch (a grid that cannot be co-resident:
// cudaErrorCooperativeLaunchTooLarge).
int rnnt_quant_lstm_layer(const void* x, const void* w_op, const void* bias, const void* h0,
                          const void* c0, void* y, void* hT, void* cT, void* hbuf, void* bar,
                          int T, int N, int IC, int H, float rb, float in_scale,
                          float out_scale, int emit_f32, void* stream) {
  if (T <= 0 || N <= 0 || IC <= 0 || H <= 0 || IC % 16 != 0 || H % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.wop = static_cast<const int8_t*>(w_op);
  a.bias = static_cast<const float*>(bias);
  a.h0 = static_cast<const int8_t*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.y[0] = y;
  a.hT[0] = static_cast<int8_t*>(hT);
  a.cT = static_cast<float*>(cT);
  a.hbuf = static_cast<int8_t*>(hbuf);
  a.bar = static_cast<unsigned*>(bar);
  a.rb = rb, a.in_scale = in_scale, a.out_scale = out_scale;
  a.T = T, a.N = N, a.IC = IC, a.ICP = (IC + 63) & ~63, a.H = H, a.HP = (H + 63) & ~63;
  a.Hl = H, a.j_base = 0, a.nr = 1;
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(emit_f32 ? launch<true>(a, s) : launch<false>(a, s));
}

// Rank mode: one step (x (N, IC), the full-width h (N, H)) of the Hl units
// from j_base on, Hl / 8 blocks; w_op and bias are the rank's slice
// (kernel_operands of its weights); c (N, Hl) f32 is read and written in
// place; h_dst[0..nr) (N, H) int8 and y_dst[0..nr) (N, H) int8 (or f32)
// are the ranks' full-width buffers, this rank's first, and the launch
// stores its slice of h_t and y_t into each.  Returns 0, or the CUDA error
// of a refused launch.
int rnnt_quant_lstm_rank_step(const void* x, const void* w_op, const void* bias,
                              const void* h, void* c, void* const* h_dst, void* const* y_dst,
                              int nr, int N, int IC, int H, int Hl, int j_base, float rb,
                              float in_scale, float out_scale, int emit_f32, void* stream) {
  if (N <= 0 || IC <= 0 || H <= 0 || IC % 16 != 0 || H % 16 != 0 || Hl <= 0 || Hl % U != 0 ||
      j_base < 0 || j_base % U != 0 || j_base + Hl > H || nr < 1 || nr > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.wop = static_cast<const int8_t*>(w_op);
  a.bias = static_cast<const float*>(bias);
  a.h0 = static_cast<const int8_t*>(h);
  a.c0 = static_cast<const float*>(c);
  a.cT = static_cast<float*>(c);
  for (int r = 0; r < nr; ++r) {
    a.hT[r] = static_cast<int8_t*>(h_dst[r]);
    a.y[r] = y_dst[r];
  }
  a.rb = rb, a.in_scale = in_scale, a.out_scale = out_scale;
  a.T = 1, a.N = N, a.IC = IC, a.ICP = (IC + 63) & ~63, a.H = H, a.HP = (H + 63) & ~63;
  a.Hl = Hl, a.j_base = j_base, a.nr = nr;
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(emit_f32 ? launch<true>(a, s) : launch<false>(a, s));
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
