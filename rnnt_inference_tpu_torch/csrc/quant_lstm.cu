// Kernel A: one int8 LSTM layer over T steps, for Hopper (sm_90a), as one
// persistent cooperative launch per layer call (on the hoisted path,
// below, after one launch of the GEMM for its input product).
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
// Hoisted path (the launch is given xw): for calls of many lanes, x_t .
// W_ih of every step and lane is computed first, as one int8 GEMM over all
// T N rows of the call (quant_lstm_xw, below), into s32 sums laid out as
// (T, H / U, N, U, 4): step t's sums of block b's units, gate innermost,
// one contiguous piece (128 KB at N = 1,024).  The time loop then stages
// W_hh alone (W_ih's shared memory goes to the ring), runs the h_{t-1} .
// W_hh passes, and each epilogue thread starts its (lane, unit) sums from
// that piece (16 bytes a pair, read while the pass runs); between the
// barrier's arrive and wait the block asks L2 for its next step's piece.
// The L2 reads of x (every block read all of x_t, N IC bytes, a step) and
// the x products of every lane past the first 128 leave the loop.  With
// 8 passes a step at N = 1,024, the rows of h_{t-1} stream through two
// ring slots in chunks of KCH inputs, pass after pass, the warps' sums kept
// past the slots: a chunk is copied while the one before it is multiplied,
// and the next pass's first chunk while a pass's epilogue runs.
// The recurrent h is not y (y is quantized with out_scale, or f32), so h_t
// goes to a ping-pong int8 buffer (2, N, H) that every block reads after
// the barrier through cp.async.cg (L2, never a stale L1 line); hT and cT
// are written once at the end.  The epilogue is spread over all threads
// (pair q = tid + 256 k is lane q / 8, unit q % 8), uses the _rn
// intrinsics, and the file is built with --fmad=false, so it rounds as the
// plain twin (ops/lstm_int8.py quant_lstm_layer) does: the two agree bit
// for bit.

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
constexpr int PART_BYTES = WARPS * MT * PST * 4;  // the warps' sums
constexpr int PAD = Rows<int8_t>::PAD;
static_assert(PART_BYTES <= ring_min<int8_t>(), "the warps' sums fit the ring");

struct Args {
  const int8_t* x;     // (T, N, IC)
  const int4* xw;      // hoisted: x . W_ih, (T, H / U, N, U) int4 (gates 0-3), else null
  const int8_t* wop;   // (H / U, (ICP + HP) NC): per block W_ih's, then W_hh's columns
  const float* bias;   // (4 H)
  const int8_t* h0;    // (N, H)
  const float* c0;     // (N, H)
  void* y;             // (T, N, H) int8, or f32
  int8_t* hT;          // (N, H)
  float* cT;           // (N, H)
  int8_t* hbuf;        // (2, N, H): h_t, read back by every block after the barrier
  unsigned* bar;       // the grid barrier (hopper.cuh grid_arrive)
  float rb, in_scale, out_scale;
  int T, N, IC, ICP, H, HP, ring_cap;
};

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const int q = __float2int_rn(__fmul_rn(v, scale));
  return static_cast<int8_t>(max(-128, min(127, q)));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// HOISTED: x . W_ih comes precomputed in a.xw, and only W_hh is staged
template <bool EMIT_F32, bool HOISTED>
__global__ void __launch_bounds__(THREADS, 1) quant_lstm(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ICS = HOISTED ? 0 : a.ICP;  // W_ih rows staged
  const size_t wbytes = (size_t)(ICS + a.HP) * NC;
  const int8_t* wih_s = reinterpret_cast<const int8_t*>(smem);
  const int8_t* whh_s = wih_s + (size_t)ICS * NC;
  float* c_s = reinterpret_cast<float*>(smem + wbytes);               // (N, U)
  int8_t* ring = reinterpret_cast<int8_t*>(c_s + ((a.N * U + 3) & ~3));  // ring_cap bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q4 = lane & 3;
  const int N = a.N, H = a.H, j0 = blockIdx.x * U;  // the block's first unit
  const size_t NH = (size_t)N * H;

  {  // the block's weight columns and c, for the whole call
    const uint4* src = reinterpret_cast<const uint4*>(
        a.wop + blockIdx.x * (size_t)(a.ICP + a.HP) * NC + (size_t)(a.ICP - ICS) * NC);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < (int)(wbytes / 16); i += THREADS) dst[i] = src[i];
    for (int i = tid; i < N * U; i += THREADS) c_s[i] = a.c0[(size_t)(i / U) * H + j0 + i % U];
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
  for (int g = 0; g < 4; ++g) bias[g] = a.bias[g * H + j0 + u];
  // HOISTED: h rows stream through two slots of RMAX rows x KCH inputs,
  // KCH the widest multiple of 64 dividing HP whose slots leave room for
  // the warps' sums (part) after them
  int KCH = 64;
  for (int m = a.HP / 64; m > 1; --m)
    if (a.HP % (64 * m) == 0 && 2 * RMAX * (64 * m + PAD) + PART_BYTES <= a.ring_cap) {
      KCH = 64 * m;
      break;
    }
  const int LDA = KCH + PAD, SLOT = RMAX * LDA, nch = a.HP / KCH;
  int* part = reinterpret_cast<int*>(HOISTED ? ring + 2 * SLOT : ring);
  // chunk i of a step's stream: pass i / nch's rows, inputs (i % nch) KCH ..
  auto stage_h = [&](const int8_t* hs, int i) {
    const int q0 = i / nch * RMAX, rows = min(RMAX, N - q0), k0 = i % nch * KCH;
    const int srows = pass_wm(rows, MT) * MT, ppr = KCH / 16;
    int8_t* dst = ring + (i & 1) * SLOT;
    for (int q = tid; q < srows * ppr; q += THREADS) {
      const int r = q / ppr, e = (q - r * ppr) * 16;
      const bool ok = r < rows && k0 + e < H;
      cp_async16(dst + r * LDA + e, ok ? hs + (size_t)(q0 + r) * H + k0 + e : a.x, ok);
    }
    cp_async_commit();
  };

  // HOISTED: the block's sums of step t, (N, U) int4, and its L2 prefetch
  auto xw_step = [&](int t) { return a.xw + ((size_t)t * gridDim.x + blockIdx.x) * N * U; };
  auto prefetch_xw = [&](int t) {
    const char* p = reinterpret_cast<const char*>(xw_step(t));
    for (int i = tid; i < N * U * 16 / 128; i += THREADS) prefetch_l2(p + 128 * i);
  };

  PassAcc<int8_t, NC> xacc;  // x_t . W_ih of the first pass's lanes, made before the step
  if constexpr (HOISTED)
    prefetch_xw(0);
  else
    x_products(0, 0, min(RMAX, N), xacc);
  for (int t = 0; t < a.T; ++t) {
    const int8_t* hsrc = t == 0 ? a.h0 : a.hbuf + (size_t)((t - 1) & 1) * NH;
    int8_t* hdst = t == a.T - 1 ? nullptr : a.hbuf + (size_t)(t & 1) * NH;  // null: hT
    const int chunks = (N + RMAX - 1) / RMAX * nch;  // HOISTED: the step's stream
    if constexpr (HOISTED) stage_h(hsrc, 0);
    for (int p0 = 0; p0 < N; p0 += RMAX) {
      const int rows = min(RMAX, N - p0);
      const int WM = pass_wm(rows, MT), WK = WARPS / WM, mt = warp % WM, kg = warp / WM;
      PassAcc<int8_t, NC> acc;
      int4 xs[KP];  // HOISTED: x_t . W_ih of this thread's pairs, loaded before the pass
      if constexpr (HOISTED) {
        const int4* src = xw_step(t) + (size_t)p0 * U;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int q = tid + THREADS * k;
          xs[k] = q < rows * U ? src[q] : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc.v[j][e] = 0;
        for (int c = 0; c < nch; ++c) {
          const int i = p0 / RMAX * nch + c, k0 = c * KCH, s_lo = k0 / 32;
          cp_async_wait<0>();
          __syncthreads();  // chunk i is in, and chunk i - 1's slot is free
          if (i + 1 < chunks) stage_h(hsrc, i + 1);
          const int s0 = s_lo + ((kg - s_lo) % WK + WK) % WK;  // this k-group's k-steps
          mma_rows16<NC / 8>(ring + (i & 1) * SLOT + mt * MT * LDA - k0, LDA,
                             reinterpret_cast<const uint2*>(whh_s), s0, s_lo + KCH / 32, WK,
                             acc.v);
        }
      } else {
        if (p0 == 0)
          acc = xacc;
        else
          x_products(t, p0, rows, acc);
        pass_products<int8_t, NC>(
            whh_s, a.HP, rows, ring, a.ring_cap, a.x,
            [&](int r) { return hsrc + (size_t)(p0 + r) * H; }, acc, H, true, false);
      }
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
        if constexpr (HOISTED) {
          sum[0] = xs[k].x, sum[1] = xs[k].y, sum[2] = xs[k].z, sum[3] = xs[k].w;
        }
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
        (hdst ? hdst : a.hT)[off] = hq;
        if (EMIT_F32)
          static_cast<float*>(a.y)[t * NH + off] = h;
        else
          static_cast<int8_t*>(a.y)[t * NH + off] = quantize(h, a.out_scale);
      }
      __syncthreads();  // the ring is staged over next
    }
    if (t + 1 < a.T) {  // h_t complete across the grid after the wait
      const unsigned old = grid_arrive(a.bar);
      if constexpr (HOISTED)
        prefetch_xw(t + 1);
      else
        x_products(t + 1, 0, min(RMAX, N), xacc);  // needs no other block's h_t
      grid_wait(a.bar, old);
    }
  }
  __syncthreads();
  for (int i = tid; i < N * U; i += THREADS) a.cT[(size_t)(i / U) * H + j0 + i % U] = c_s[i];
}

template <bool EMIT_F32, bool HOISTED>
cudaError_t launch(Args a, cudaStream_t stream) {
  // the staging ring takes what the block's other arrays leave
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed =
      (size_t)((HOISTED ? 0 : a.ICP) + a.HP) * NC + (size_t)((a.N * U + 3) & ~3) * 4;
  // the hoisted loop keeps the warps' sums beside its two slots
  if (fixed + (size_t)ring_min<int8_t>() + (HOISTED ? PART_BYTES : 0) > (size_t)limit)
    return cudaErrorInvalidValue;
  a.ring_cap = (int)((size_t)limit - fixed) & ~15;
  const size_t smem = fixed + (size_t)a.ring_cap;
  auto kern = quant_lstm<EMIT_F32, HOISTED>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(a.H / U),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The hoisted input product: xw = x (M = T N rows, IC) int8 . W_ih (IC, 4H)
// int8 in s32, exact, for all steps and lanes of a call before its time
// loop.  What bounds it: 2 M IC 4H operations at 1,979 TOP/s against x and
// W_ih read once and M 4H 4 bytes of sums written (and read back by the
// loop) at 3.35 TB/s; at IC = 240 the sums' bytes, at 1,024 and 2,048 the
// two about evenly.  Kernel E's design (projection.cu) on int8: output
// tiles of 128 x 256, K in stages of 128 inputs (one 128-byte swizzled
// row), a ring of 4 stages loaded by TMA from one thread of a producer
// warp; two consumer warpgroups of 64 rows on wgmma m64n256k32 s8 x s8 ->
// s32; one persistent block per SM walking the tiles N-major.  The
// operand is W_ih^T with its columns in (block, unit, gate) order
// (ops/lstm_cuda.py xw_operand), so a block's 32 columns of a row are
// one 128-byte row of its piece at (t, b, n, u, g).  The sums are written
// once and read once, 4 bytes each where x's inputs are 1, so the
// epilogue is the GEMM's larger half: each warpgroup passes its sums
// through shared memory one block's columns at a time, and 8 threads store
// each 128-byte row whole (8-byte stores straight from the fragments, a
// 32-byte piece of 8 rows each, wrote ~0.9 TB/s on an H100).  TMA fills
// rows past M and inputs past IC with zeros.

constexpr int XBM = 128, XBN = 256, XBK = 128, XSTAGES = 4, XCONSUMERS = 2;
constexpr int XTHREADS = 128 * XCONSUMERS + 32;  // + the producer warp
constexpr int XA_TILE = XBM * XBK, XB_TILE = XBN * XBK, XSTAGE = XA_TILE + XB_TILE;
constexpr int XPST = NC + 8;  // words a row of the epilogue's staging: no bank conflicts
// the ring, its barriers, each consumer's staging (64 rows of one block),
// and slack to align the ring to 1,024 bytes (the swizzle's period)
constexpr int XSMEM = XSTAGES * XSTAGE + 2 * XSTAGES * 8 + XCONSUMERS * 64 * XPST * 4 + 1024;

struct XwArgs {
  int* xw;            // (T, G / NC, N, NC) s32: the recurrence's layout
  int M, G, K, N;     // rows T N, columns 4H, inputs IC, lanes
};

// d (64 x 256, s32) += A (64 x 32) . B (32 x 256), both K-major int8 in
// shared memory
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// the 128 threads of consumer warpgroup `id - 1` meet (barrier 0 is
// __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__global__ void __launch_bounds__(XTHREADS, 1)
    quant_lstm_xw(__grid_constant__ const CUtensorMap map_x,
                  __grid_constant__ const CUtensorMap map_w, const XwArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + XSTAGES * XSTAGE);
  uint64_t* empty = full + XSTAGES;
  const int tiles_n = (p.G + XBN - 1) / XBN;
  const int tiles = (p.M + XBM - 1) / XBM * tiles_n;
  const int nk = (p.K + XBK - 1) / XBK;
  const int wg = threadIdx.x / 128;
  int* staged = reinterpret_cast<int*>(empty + XSTAGES) + wg * 64 * XPST;  // (64, XPST)

  if (threadIdx.x == 0) {
    for (int s = 0; s < XSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], XCONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == XCONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * XCONSUMERS) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * XBM, n0 = tile % tiles_n * XBN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);  // the first round passes at once
          uint8_t* st = ring + s * XSTAGE;
          mbar_expect_tx(&full[s], XSTAGE);
          tma_load(st, &map_x, &full[s], kb * XBK, m0);
          tma_load(st + XA_TILE, &map_w, &full[s], kb * XBK, n0);
          if (++s == XSTAGES) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg * 64 .. + 63 of each tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, q = lane % 4;
  int d[128];
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * XBM, n0 = tile % tiles_n * XBN;
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    int held = -1;  // the stage whose products may still be running
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], phase);
      const uint8_t* st = ring + s * XSTAGE;
      const uint64_t da = smem_desc(st + wg * 64 * XBK), db = smem_desc(st + XA_TILE);
      fence_sums(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < XBK / 32; ++kk)  // 32 bytes further along the swizzled rows
        wgmma_m64n256k32_s8(d, da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done once at most this group runs
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_sums(d);
      if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
      held = s;
      if (++s == XSTAGES) s = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_sums(d);
    if (t == 0) mbar_arrive(&empty[held]);
    // sum 4 j + 2 h + e sits at row 16 warp + lane / 4 + 8 h, column
    // 8 j + 2 q + e of the warpgroup's 64 x 256; columns jb NC .. jb NC +
    // NC - 1 (n-tiles 4 jb .. 4 jb + 3) are block n0 / NC + jb's
#pragma unroll
    for (int jb = 0; jb < XBN / NC; ++jb) {
      if (n0 + jb * NC >= p.G) break;
#pragma unroll
      for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 4 * jb + jj;
          *reinterpret_cast<int2*>(staged + (warp * 16 + lane / 4 + 8 * h) * XPST + 8 * jj +
                                   2 * q) = make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      warpgroup_sync(1 + wg);
      const size_t b = n0 / NC + jb;
#pragma unroll
      for (int k = 0; k < 64 * NC / 4 / 128; ++k) {  // 16 bytes a thread, 8 threads a row
        const int i = t + 128 * k, row = i / (NC / 4), c4 = i % (NC / 4);
        const int r = m0 + wg * 64 + row;
        if (r < p.M) {
          const int step = r / p.N, n = r - step * p.N;
          *reinterpret_cast<int4*>(p.xw + (((size_t)step * (p.G / NC) + b) * p.N + n) * NC +
                                   4 * c4) =
              *reinterpret_cast<const int4*>(staged + row * XPST + 4 * c4);
        }
      }
      warpgroup_sync(1 + wg);  // the staging is free again
    }
  }
}


cudaError_t launch_xw(const CUtensorMap& map_x, const CUtensorMap& map_w, const XwArgs& p,
                      int sms, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(quant_lstm_xw, cudaFuncAttributeMaxDynamicSharedMemorySize, XSMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (p.M + XBM - 1) / XBM * ((p.G + XBN - 1) / XBN);
  quant_lstm_xw<<<tiles < sms ? tiles : sms, XTHREADS, XSMEM, stream>>>(map_x, map_w, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xw (T, H / 8, N, 8, 4) s32 = x (T, N, IC) int8 . W_ih (IC, 4H) int8 on
// `stream`, one launch of up to `sms` blocks; w_xw is ops/lstm_cuda.py
// xw_operand(W_ih), (4H, IC).  IC a multiple of 16, x and w_xw on 16-byte
// boundaries (TMA's row strides and addresses).  Returns 0, or the CUDA
// error (an encoder that is missing or refuses the maps:
// cudaErrorSharedObjectSymbolNotFound or cudaErrorInvalidValue).
int rnnt_quant_lstm_xw(const void* x, const void* w_xw, void* xw, int T, int N, int IC, int H,
                       int sms, void* stream) {
  if (T <= 0 || N <= 0 || IC <= 0 || H <= 0 || IC % 16 != 0 || H % U != 0 || sms <= 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_xw)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  constexpr auto I8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap map_x, map_w;
  if (!encode_rows(fn, &map_x, x, T * N, IC, XBM, I8, 1) ||
      !encode_rows(fn, &map_w, w_xw, 4 * H, IC, XBN, I8, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const XwArgs p{static_cast<int*>(xw), T * N, 4 * H, IC, N};
  return static_cast<int>(launch_xw(map_x, map_w, p, sms, static_cast<cudaStream_t>(stream)));
}

// One cooperative launch of H / 8 blocks on `stream` for all T steps.
// w_op is the layout of ops/lstm_cuda.py kernel_operands; hbuf (2, N, H)
// int8 is scratch; bar (one u32) is the grid barrier's state, zeroed once
// and reused by every launch on the stream.  xw: null, or the hoisted
// path's x . W_ih (rnnt_quant_lstm_xw's output for this x), which the
// launch then reads in place of x.  Returns 0, or the CUDA error of a
// refused launch (a grid that cannot be co-resident:
// cudaErrorCooperativeLaunchTooLarge).
int rnnt_quant_lstm_layer(const void* x, const void* w_op, const void* bias, const void* h0,
                          const void* c0, void* y, void* hT, void* cT, void* hbuf, void* bar,
                          const void* xw, int T, int N, int IC, int H, float rb, float in_scale,
                          float out_scale, int emit_f32, void* stream) {
  if (T <= 0 || N <= 0 || IC <= 0 || H <= 0 || IC % 16 != 0 || H % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.xw = static_cast<const int4*>(xw);
  a.wop = static_cast<const int8_t*>(w_op);
  a.bias = static_cast<const float*>(bias);
  a.h0 = static_cast<const int8_t*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.y = y;
  a.hT = static_cast<int8_t*>(hT);
  a.cT = static_cast<float*>(cT);
  a.hbuf = static_cast<int8_t*>(hbuf);
  a.bar = static_cast<unsigned*>(bar);
  a.rb = rb, a.in_scale = in_scale, a.out_scale = out_scale;
  a.T = T, a.N = N, a.IC = IC, a.ICP = (IC + 63) & ~63, a.H = H, a.HP = (H + 63) & ~63;
  auto* s = static_cast<cudaStream_t>(stream);
  if (xw) return static_cast<int>(emit_f32 ? launch<true, true>(a, s) : launch<false, true>(a, s));
  return static_cast<int>(emit_f32 ? launch<true, false>(a, s) : launch<false, false>(a, s));
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
