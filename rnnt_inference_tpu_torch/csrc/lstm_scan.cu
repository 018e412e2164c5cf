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
// 256 KB in bf16 at N = 128), which arrives slowly right after the barrier
// (every SM asks for the same lines at once).  W_hh (8 MB bf16, 16 MB f32)
// does not fit one SM but fits the grid's shared memory.
//
// Design: one cooperative launch runs the whole time loop, with one grid
// barrier per step (none after the last); a grid that cannot be co-resident
// makes the launch fail and the wrapper raises.  Block b owns U hidden
// units j = b U .. b U + U - 1 and all four gate columns of each (i, f, g,
// o), so the cell update stays in the block; U = 8, so the grid (H / U
// blocks, one per SM) is co-resident up to H = 8 x the SM count: 128
// blocks at H = 1024.  The block's W_hh columns (H x 4U: 64 KB bf16,
// 128 KB f32) are brought into shared memory once and stay there for the
// call, laid out by the host (ops/cuda_build.py block_columns) with the
// columns ordered so that a thread's sums are all four gates of its units.
// The block's c (N x U, f32) stays in shared memory from c0 to cT.  h_t
// goes to y_t in device memory, which every block reads back after the
// barrier (through L2, never a stale L1 line).  The epilogue uses the _rn
// intrinsics and the file is built with --fmad=false, so it rounds as the
// plain twin (ops/lstm.py lstm_recurrence) does; only the summation order
// differs.
//
// bf16 calls of more than 128 lanes (lstm_scan_cluster; the packed
// runner's 1,024): every block needs all of h_{t-1} (N H 2 bytes, 2 MB at
// N = 1,024) each step, and 128 SMs asking L2 for the same lines at once
// after the barrier bound the loop (~152 us a step at N = 1,024 on an H100
// when each block copied its own, 256 MB a step through L2).  So the blocks run in
// clusters of cs (the wrapper's plan: 4 or 2 where the card holds the
// whole grid in such clusters, else 1), and each chunk of h_{t-1} (a pass's
// 128 lane rows x 64 inputs, one TMA box of 128-byte rows in the 128-byte
// swizzle) is loaded once per cluster, by its blocks in turn, and
// multicast into the same ring slot of every block of the cluster: L2
// delivers N H 2 / cs bytes per cluster a step.  A producer warp walks the
// step's chunks pass after pass, so the next pass's chunks land while a
// pass's epilogue runs: for each chunk it waits until every block of the
// cluster has released the slot (the slot's `empty` mbarrier counts one
// arrival from each block), arms its own `full` mbarrier with the chunk's
// bytes, and, when the chunk is its block's turn, issues the multicast
// load.  Two consumer warpgroups take the passes in turn, so that one's
// epilogue runs while the other multiplies: a warpgroup multiplies its
// pass's chunks with wgmma m64n32k16 (bf16, f32 sums; A the swizzled h
// tile, 64 lane rows a product, B the block's W_hh columns, K-major and
// swizzled, brought in by TMA at the start), and keeps the sums in
// registers: by the host's column order, a thread's 16 sums of an m-tile
// are the four gates of two units in two lane rows, so each thread updates
// its own (lane, unit) cells from its registers.  h_t is written by
// ordinary stores and read by TMA after the grid barrier, so every thread
// fences the async proxy after its stores and the producer before its
// loads.
//
// f32, and bf16 calls of one pass (lstm_scan, the pass engine): each step
// is one pass (csrc/hopper.cuh pass_products) per 128 (bf16) or 64 (f32)
// lanes: h_{t-1} is copied with cp.async in chunks as wide as the shared
// memory left over allows (all of H at N = 16), the next chunk in flight
// while a chunk's products run, the warps spread over the lanes (or, for
// few lanes, over K, their sums added in a fixed order); the sums go to
// shared memory and every thread takes a share of the (lane, unit) cell
// updates, whose xw values it loads before the pass.  Products: bf16 on
// the tensor cores (mma.sync m16n8k16, lanes as M, f32 sums), f32 as FMA on
// the CUDA cores (no TF32), four lane rows per thread.  On an H100 a step
// at N = 16 took 5.6 us here and 7.3 in the cluster loop, whose 16 chunks
// a pass each wait on their own barrier; at N = 128, 18.7 and 8.6.

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

// ---------------------------------------------------------------------------
// bf16: the cluster loop (see the head of the file)

constexpr int CU = 8, CNC = 4 * CU;             // units, gate columns of a block
constexpr int CW = 2;                            // consumer warpgroups
constexpr int CTHREADS = 128 * CW + 32;          // + the producer warp
constexpr int CROWS = 64 * CW;                   // lane rows of a pass
constexpr int KB = 64;                           // inputs of a chunk: one 128-byte row
constexpr int WSLAB = CNC * 128;                 // bytes of W_hh's columns per 64 inputs
constexpr int MAX_SLOTS = 16;

struct ClusterArgs {
  const __nv_bfloat16* xw;  // (T, N, 4 H)
  const float* c0;          // (N, H)
  __nv_bfloat16* y;         // (T, N, H): read back by TMA after each barrier
  __nv_bfloat16* hT;        // (N, H)
  float* cT;                // (N, H)
  int T, N, H, cs, slots, box_rows;
};

// d (64 x 32, f32) += A (64 x 16) . B (16 x 32), both K-major bf16 in
// shared memory in the 128-byte swizzle
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// a flag known at compile time, for the instantiations of a generic lambda
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// keep the compiler from moving accesses of the sums across the
// asynchronous products
__device__ __forceinline__ void fence_chains(float (&d)[2][2][16]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[m][k][i])::"memory");
}

// Shared memory, from a 1,024-byte boundary (the swizzle's period): the
// ring (slots of box_rows x 128 bytes), W_hh's columns (H / 64 slabs of 32
// rows x 128 bytes), c (N x 8 f32), then the mbarriers.
__host__ __device__ constexpr size_t cluster_smem(int N, int H, int slots, int box_rows) {
  return 1024 + (size_t)slots * box_rows * 128 + (size_t)H * CNC * 2 + (size_t)N * CU * 4 +
         (2 * MAX_SLOTS + 1 + CW) * 8;
}

__global__ void __launch_bounds__(CTHREADS, 1)
    lstm_scan_cluster(__grid_constant__ const CUtensorMap map_h0,
                      __grid_constant__ const CUtensorMap map_y,
                      __grid_constant__ const CUtensorMap map_w, const ClusterArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int T = a.T, N = a.N, H = a.H, S = a.slots, cs = a.cs;
  const int slot_bytes = a.box_rows * 128;
  uint8_t* w_s = ring + (size_t)S * slot_bytes;
  float* c_s = reinterpret_cast<float*>(w_s + (size_t)H * CNC * 2);  // (N, U)
  uint64_t* full = reinterpret_cast<uint64_t*>(c_s + N * CU);
  uint64_t* empty = full + MAX_SLOTS;
  uint64_t* wbar = empty + MAX_SLOTS;
  uint64_t* turn = wbar + 1;  // turn[w]: warpgroup w may take its next pass's chunks
  // the warpgroup's index, broadcast from lane 0 so that the compiler knows
  // it is the same in every thread of a warp: wgmma under a branch it
  // cannot prove uniform is serialized
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int j0 = blockIdx.x * CU;  // the block's first unit
  const int nchk = H / KB, npass = (N + CROWS - 1) / CROWS;
  const uint32_t rank = cluster_rank();

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cs);  // one warpgroup of each block of the cluster
    }
    mbar_init(wbar, 1);
    for (int w = 0; w < CW; ++w) mbar_init(&turn[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < N * CU; i += CTHREADS) c_s[i] = a.c0[(size_t)(i / CU) * H + j0 + i % CU];
  cluster_sync();  // every block's mbarriers are ready before a peer loads or arrives

  if (wg == CW) {  // the producer warp: one thread issues every load
    const bool issuer = tid == 128 * CW;
    if (issuer) {  // the block's W_hh columns, for the whole call
      mbar_expect_tx(wbar, H * CNC * 2);
      for (int q = 0; q < nchk; ++q)
        tma_load(w_s + q * WSLAB, &map_w, wbar, q * KB, blockIdx.x * CNC);
    }
    const uint16_t mask = static_cast<uint16_t>((1u << cs) - 1);
    uint32_t g = 0;  // chunks walked, over all steps: slot g % S, its use g / S
    for (int t = 0; t < T; ++t) {
      if (issuer) {
        fence_proxy_async_global();  // y_{t-1}'s stores, before the barrier, then TMA
        const CUtensorMap* map = t == 0 ? &map_h0 : &map_y;
        const int plane = t == 0 ? 0 : t - 1;
        for (int p = 0; p < npass; ++p)
          for (int c = 0; c < nchk; ++c, ++g) {
            const int s = g % S;
            mbar_wait_cluster(&empty[s], ((g / S) & 1) ^ 1);  // the first round passes at once
            mbar_expect_tx(&full[s], slot_bytes);
            if (g % cs == rank)
              tma_load_multicast(ring + (size_t)s * slot_bytes, map, &full[s], c * KB, p * CROWS,
                                 plane, mask);
          }
      }
      __syncwarp();
      if (t + 1 < T) cooperative_groups::this_grid().sync();
    }
  } else {  // consumer warpgroup wg: every other pass, in turn with the other
    const int t128 = tid % 128, warp = t128 / 32, lane = tid % 32, g8 = lane >> 2, q4 = lane & 3;
    const size_t NH = (size_t)N * H;
    // a slot is released to every block of the cluster once the warpgroup
    // is done with it: thread r arrives on rank r's barrier
    auto release = [&](int s) {
      if (t128 < cs) mbar_arrive_peer(&empty[s], t128);
    };
    mbar_wait(wbar, 0);
    for (int t = 0; t < T; ++t) {
      for (int p = 0; p < npass; ++p) {
        const uint32_t P = (uint32_t)t * npass + p;  // the pass's number in the call
        if ((int)(P % CW) != wg) continue;
        const int p0 = p * CROWS, rows = min(CROWS, N - p0);
        // the thread's cells: lane rows r = 64 mt + 16 warp + g8 + 8 h (m-tile
        // mt), units u = q4 + 4 i; their xw, asked for ahead of the products
        // and kept as loaded (converted only in the epilogue, so that nothing
        // waits for the loads before it)
        __nv_bfloat16 xv[2][2][2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 64 * mt + 16 * warp + g8 + 8 * h;
            const __nv_bfloat16* src = a.xw + ((size_t)t * N + p0 + r) * 4 * H + j0 + q4;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int gt = 0; gt < 4; ++gt)
                if (r < rows) xv[mt][h][i][gt] = src[(size_t)gt * H + 4 * i];
          }
        // the warpgroups take the ring's chunks in order: this pass's waits
        // start once the other has seen the last chunk of the pass before
        // (a wait may only name a slot's current or previous use)
        if (P > 0) mbar_wait(&turn[wg], ((P + wg) / CW + 1) & 1);
        // the sums of m-tile mt run in two chains (chunk parity), added after
        // the pass: a wgmma into a chain waits for the one before it
        float acc[2][2][16];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[mt][k][i] = 0.0f;
        fence_chains(acc);
        // the chunks of the pass, the second m-tile's products where it holds
        // lanes (a branch outside the loop: a wgmma under a branch is
        // serialized)
        int held = -1;  // the slot whose products may still be running
        auto mainloop = [&](auto two) {
          for (int c = 0; c < nchk; c += 2) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const uint32_t g = P * nchk + c + cc;  // the chunk's number in the ring's stream
              const int s = g % S;
              mbar_wait(&full[s], (g / S) & 1);
              const uint8_t* slot = ring + (size_t)s * slot_bytes;
              const uint64_t db = smem_desc(w_s + (c + cc) * WSLAB);
              asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
              for (int kk = 0; kk < KB / 16; ++kk) {  // 32 bytes further along the swizzled rows
                wgmma_m64n32k16(acc[0][cc], smem_desc(slot) + 2 * kk, db + 2 * kk);
                if constexpr (decltype(two)::value)
                  wgmma_m64n32k16(acc[1][cc], smem_desc(slot + 64 * 128) + 2 * kk, db + 2 * kk);
              }
              asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
              // the previous chunk's products are done once at most this group runs
              asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
              if (held >= 0) release(held);
              held = s;
            }
          }
        };
        if (rows > 64)
          mainloop(Flag<true>{});
        else
          mainloop(Flag<false>{});
        // this warpgroup has seen every chunk of the pass
        if (t128 == 0) mbar_arrive(&turn[1 - wg]);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_chains(acc);
        release(held);
        // sum 4 j + 2 h + e of m-tile mt: lane row 64 mt + 16 warp + g8 + 8 h,
        // column 8 j + 2 q4 + e, which is gate 2 (j % 2) + e of unit
        // 4 (j / 2) + q4 (cuda_build.gate_columns)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 64 * mt + 16 * warp + g8 + 8 * h;
            if (r >= rows) continue;
            const int n = p0 + r;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int u = q4 + 4 * i;
              float gate[4];
#pragma unroll
              for (int gt = 0; gt < 4; ++gt) {
                const int e = 4 * (2 * i + gt / 2) + 2 * h + gt % 2;
                gate[gt] = __fadd_rn(to_f(xv[mt][h][i][gt]),
                                     __fadd_rn(acc[mt][0][e], acc[mt][1][e]));
              }
              const float ig = sigmoid_f(gate[0]);
              const float fg = sigmoid_f(gate[1]);
              const float gg = tanhf(gate[2]);
              const float og = sigmoid_f(gate[3]);
              float* cp = c_s + n * CU + u;
              const float cn = __fadd_rn(__fmul_rn(fg, *cp), __fmul_rn(ig, gg));
              *cp = cn;
              const __nv_bfloat16 hv = __float2bfloat16_rn(__fmul_rn(og, tanhf(cn)));
              const size_t off = (size_t)n * H + j0 + u;
              a.y[(size_t)t * NH + off] = hv;
              if (t == T - 1) a.hT[off] = hv;
            }
          }
      }
      if (t + 1 < T) {
        fence_proxy_async_global();  // y_t's stores, then the peers' TMA after the barrier
        cooperative_groups::this_grid().sync();
      }
    }
  }
  cluster_sync();  // no block leaves while a peer may still arrive on its barriers; c is final
  for (int i = tid; i < N * CU; i += CTHREADS) a.cT[(size_t)(i / CU) * H + j0 + i % CU] = c_s[i];
}

// The cluster loop's launch configuration for N lanes, H units and
// clusters of cs: the ring takes what the block's other arrays leave, up to
// MAX_SLOTS slots of box_rows lane rows (64 for one pass of at most 64
// lanes, else 128); at least two.
cudaError_t cluster_config(int N, int H, int cs, ClusterArgs& a, size_t& smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  a.N = N, a.H = H, a.cs = cs;
  a.box_rows = N > 64 ? CROWS : 64;
  const size_t fixed = cluster_smem(N, H, 0, a.box_rows);
  const size_t slot = (size_t)a.box_rows * 128;
  if (fixed + 2 * slot > (size_t)limit) return cudaErrorInvalidValue;
  a.slots = (int)(((size_t)limit - fixed) / slot);
  if (a.slots > MAX_SLOTS) a.slots = MAX_SLOTS;
  smem = cluster_smem(N, H, a.slots, a.box_rows);
  return cudaFuncSetAttribute(lstm_scan_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// attrs[0]: the cluster's size; attrs[1]: cooperative (the launch only)
void cluster_launch_config(const ClusterArgs& a, size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attrs)[2]) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.cs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(a.H / CU);
  cfg.blockDim = dim3(CTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
}

cudaError_t launch_cluster(const void* xw, const void* w_op, const void* h0, const void* c0,
                           void* y, void* hT, void* cT, int T, int N, int H, int cs,
                           cudaStream_t stream) {
  if (cs != 1 && cs != 2 && cs != 4) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(w_op)) % 16 != 0)
    return cudaErrorInvalidValue;
  ClusterArgs a{};
  size_t smem = 0;
  cudaError_t err = cluster_config(N, H, cs, a, smem);
  if (err != cudaSuccess) return err;
  a.xw = static_cast<const __nv_bfloat16*>(xw);
  a.c0 = static_cast<const float*>(c0);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.hT = static_cast<__nv_bfloat16*>(hT);
  a.cT = static_cast<float*>(cT);
  a.T = T;
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn) return cudaErrorSharedObjectSymbolNotFound;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_h0, map_y, map_w;
  if (!encode_planes(fn, &map_h0, h0, 1, N, H, a.box_rows, BF16, 2) ||
      !encode_planes(fn, &map_y, y, T, N, H, a.box_rows, BF16, 2) ||
      !encode_rows(fn, &map_w, w_op, 4 * H, H, CNC, BF16, 2))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cluster_launch_config(a, smem, stream, cfg, attrs);
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, lstm_scan_cluster, map_h0, map_y, map_w, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One cooperative launch of H / U blocks on `stream` for all T steps;
// weight_bf16 selects the compute dtype (1: bf16, 0: f32); cs 0 runs the
// pass engine, cs = 1, 2 or 4 the cluster loop (bf16 only) in clusters of
// cs blocks; w_op is the layout of ops/lstm_scan_cuda.py recurrent_weight
// for U = 8 (the only unit count built), K-major for the cluster loop.
// Returns 0, or the CUDA error of a refused launch (a grid that cannot be
// co-resident: cudaErrorCooperativeLaunchTooLarge).
int rnnt_lstm_scan(int weight_bf16, int U, int cs, const void* xw, const void* w_op,
                   const void* h0, const void* c0, void* y, void* hT, void* cT, int T, int N,
                   int H, void* stream) {
  if (T <= 0 || N <= 0 || H <= 0 || H % 128 != 0 || U != 8 || (!weight_bf16 && cs != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<cudaStream_t>(stream);
  if (cs) return static_cast<int>(launch_cluster(xw, w_op, h0, c0, y, hT, cT, T, N, H, cs, s));
  Args a{};
  a.xw = xw, a.wop = w_op, a.h0 = h0, a.c0 = static_cast<const float*>(c0);
  a.y = y, a.hT = hT, a.cT = static_cast<float*>(cT);
  a.T = T, a.N = N, a.H = H;
  return static_cast<int>(weight_bf16 ? launch<__nv_bfloat16, 8>(a, s) : launch<float, 8>(a, s));
}

// How many clusters of cs blocks of the bf16 loop the card holds at once
// at its shared memory for N lanes and H units (cudaOccupancyMaxActiveClusters)
// into *clusters.  Returns 0 or the CUDA error.
int rnnt_lstm_scan_clusters(int cs, int N, int H, int* clusters) {
  if (N <= 0 || H <= 0 || H % 128 != 0 || (cs != 1 && cs != 2 && cs != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  ClusterArgs a{};
  size_t smem = 0;
  cudaError_t err = cluster_config(N, H, cs, a, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cluster_launch_config(a, smem, nullptr, cfg, attrs);
  cfg.numAttrs = 1;  // the cluster's size alone
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, lstm_scan_cluster, &cfg));
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
