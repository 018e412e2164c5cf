// Device helpers shared by the persistent kernels A (quant_lstm.cu), B
// (decode_step.cu) and C (lstm_scan.cu), and by kernel D (mel.cu), for
// Hopper (sm_90a): 16-byte cp.async copies into shared memory, the
// tensor-core products mma.sync m16n8k16 (bf16, f32 sums), m16n8k32 (int8,
// s32 sums) and m16n8k8 (tf32, f32 sums), the f32 FMA product on the CUDA
// cores, the rounding helpers, and a grid barrier split into arrive and
// wait; and, for the wgmma GEMMs (kernel E, projection.cu, and kernel A's
// input product) and kernel C's bf16 loop, TMA tile loads tracked by
// mbarriers, the shared-memory descriptor of a swizzled tile, the tensor
// maps' encoder, and the thread-block cluster's helpers (a load multicast
// to the cluster's blocks, arrivals on a peer block's mbarrier).
//
// pass_products (below) runs one product for up to 128 lane rows with
// every warp busy; the two product routines under it compute a warp's
// partial sums over a share of the input axis K for one tile of lane rows.
//
// bf16 and int8 operands B are laid out on the host in mma fragment order
// (ops/cuda_build.py b_fragments): for k-step s (32 bytes of inputs: 16
// bf16 or 32 int8) and n-tile j (8 columns), lane l = 4 g + t holds
// B[16 s + 2 t + {0, 1, 8, 9}, 8 j + g] (bf16) or
// B[32 s + 4 t + {0..3, 16..19}, 8 j + g] (int8) as one uint2, so a warp
// reads its fragment as 256 contiguous bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// torch.sigmoid's formula: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// 16 bytes global -> shared through L2 only (.cg: never a stale L1 line of
// data another block wrote before a grid barrier); !valid fills zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
// One k-step (32 bytes of inputs) of a 16 x 8 tile, by the type of its
// sums: bf16 m16n8k16 with f32 sums, or int8 m16n8k32 with s32 sums
// (exact, so sums of any order agree).
__device__ __forceinline__ void mma_k32bytes(float (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
__device__ __forceinline__ void mma_k32bytes(int (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// f32 rounded to tf32 (10 explicit mantissa bits, the low 13 bits zero):
// to nearest, ties away from zero, as cvt.rna.tf32.f32 and ops/features.py
// tf32_split round.  Adding half of the dropped range to the magnitude bits
// and clearing them rounds a finite value so (a carry into the exponent is
// the rounding up it should be); two integer instructions, where cvt also
// sorts out inf and NaN, which finite data never holds.
__device__ __forceinline__ unsigned to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// One k-step (8 inputs) of a 16 x 8 tile in tf32 with f32 sums: c += a b.
// A fragment, lane 4 g + t: a[0] (row g, col t), a[1] (g + 8, t), a[2]
// (g, t + 4), a[3] (g + 8, t + 4); B: b0 (row t, col g), b1 (t + 4, g); C
// as for bf16 (rows g and g + 8, columns 2 t and 2 t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The same product into fresh sums: d = a b.
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// Partial sums of a 16-row tile A of bf16 (f32 sums) or int8 (s32 sums)
// (shared memory, row stride lda elements, an odd multiple of 16 bytes so
// ldmatrix is free of bank conflicts) times B over the k-steps s = s0,
// s0 + ds, ... < s1; a k-step is 32 bytes of a row (16 bf16, 32 int8), and
// ldmatrix .b16 loads either type's A fragment unchanged.
// Bf: fragments [k-step][NT][32] (shared or global memory).
// acc[j] is the warp's C fragment of n-tile j: rows g and g + 8, columns
// 8 j + 2 t and + 1 (lane = 4 g + t).
template <int NT, typename T, typename S>
__device__ __forceinline__ void mma_rows16(const T* A, int lda, const uint2* Bf, int s0, int s1,
                                           int ds, S (&acc)[NT][4]) {
  constexpr int KS = 32 / (int)sizeof(T);  // elements per k-step
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, r = lane & 7;
  const T* arow = A + (r + 8 * (mat & 1)) * lda + (KS / 2) * (mat >> 1);
  int s = s0;
  for (; s + 3 * ds < s1; s += 4 * ds) {  // four k-steps: every load before the products
    unsigned a[4][4];
    uint2 b[4][NT];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ldmatrix_x4(a[u], arow + KS * (s + u * ds));
#pragma unroll
      for (int j = 0; j < NT; ++j) b[u][j] = Bf[((s + u * ds) * NT + j) * 32 + lane];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_k32bytes(acc[j], a[u], b[u][j]);
  }
  for (; s < s1; s += ds) {
    unsigned a[4];
    ldmatrix_x4(a, arow + KS * s);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_k32bytes(acc[j], a, Bf[(s * NT + j) * 32 + lane]);
  }
}

// Partial sums of a 32-row f32 tile A (shared memory, row stride lda
// floats, lda * 4 an odd multiple of 16 bytes) times B [K][4 CPT] over the
// groups of four inputs k = k0, k0 + 4 dq, ... < k1, as f32 FMA in k order.
// Lane 4 m + q owns rows m, m + 8, m + 16, m + 24 and columns q CPT ..
// q CPT + CPT - 1: each B value read feeds four rows, so the FMA pipe and
// not shared memory sets the pace.
template <int CPT>
__device__ __forceinline__ void fma_rows32(const float* A, int lda, const float* B, int k0,
                                           int k1, int dq, float (&acc)[4][CPT]) {
  constexpr int NC = 4 * CPT;
  const int lane = threadIdx.x & 31, m = lane >> 2, q = lane & 3;
  const float* arow = A + m * lda;
  const float* bcol = B + q * CPT;
  for (int k = k0; k < k1; k += 4 * dq) {
    float av[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(arow + 8 * r * lda + k);
      av[r][0] = a4.x; av[r][1] = a4.y; av[r][2] = a4.z; av[r][3] = a4.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* br = bcol + (size_t)(k + e) * NC;
      float w[CPT];
      if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CPT; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(br + c);
          w[c] = v.x; w[c + 1] = v.y; w[c + 2] = v.z; w[c + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; c += 2) {
          const float2 v = *reinterpret_cast<const float2*>(br + c);
          w[c] = v.x; w[c + 1] = v.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = __fmaf_rn(av[r][e], w[c], acc[r][c]);
    }
  }
}

// Lane rows per tile (MT), the row padding of a staged tile (PAD), and the
// most lane rows of one pass (RMAX = 8 warps x MT), by weight type: bf16
// and int8 tiles are mma's 16 rows; f32 tiles 32 rows (fma_rows32).
template <typename WT>
struct Rows;
template <>
struct Rows<__nv_bfloat16> {
  static constexpr int MT = 16;
  static constexpr int PAD = 8;  // elements: 16 bytes
  static constexpr int RMAX = 128;
};
template <>
struct Rows<int8_t> {
  static constexpr int MT = 16;
  static constexpr int PAD = 16;  // elements: 16 bytes
  static constexpr int RMAX = 128;
};
template <>
struct Rows<float> {
  static constexpr int MT = 32;
  static constexpr int PAD = 4;
  static constexpr int RMAX = 64;  // two m-tiles: the f32 weights leave less room
};

// ---------------------------------------------------------------------------
// One pass: the products of up to RMAX lane rows against a block's weight
// columns, with every warp busy.  The rows' inputs are staged in chunks of
// KC inputs through a ring of up to NSTAGE = 2 shared-memory slots (cp.async,
// one __syncthreads per chunk, the next chunk's copy in flight while a
// chunk's products run).  KC is the widest multiple of 64 dividing K whose
// slots fit the ring: every step starts after a grid barrier with a cold
// pipeline, and L2's latency under all SMs' reads is long, so the more of a
// pass is requested at once, the sooner it arrives (a pass of 16 bf16 rows
// asks for all of K in one chunk).  The 8 warps are WM m-tiles side by side
// times WK = 8 / WM groups that split the input axis (WM grows with the
// rows: many lanes take all warps across lanes, few lanes split K); a
// k-group's partial sums are added to group 0's in group order through
// shared memory, so the sums do not depend on scheduling.  Group 0's warps
// end with the sums in registers:
//   bf16 (f32 sums) and int8 (int32 sums), lane 4 g + t: rows g and g + 8
//        of its m-tile, columns 8 j + 2 t and + 1 of n-tile j
//        (acc.v[j][2 r + e]);
//   f32,  lane 4 m + q: rows m + 8 r (r < 4) of its m-tile, columns q NC/4
//        .. (acc.v[r][c]).

constexpr int NSTAGE = 2;

template <typename WT, int NC>
struct PassAcc;
template <int NC>
struct PassAcc<__nv_bfloat16, NC> {
  using Sum = float;
  static constexpr int NV = NC / 2;  // sums a lane holds
  float v[NC / 8][4];
};
template <int NC>
struct PassAcc<int8_t, NC> {
  using Sum = int;
  static constexpr int NV = NC / 2;
  int v[NC / 8][4];
};
template <int NC>
struct PassAcc<float, NC> {
  using Sum = float;
  static constexpr int NV = NC;
  float v[4][NC / 4];
};

__device__ __forceinline__ float add_sum(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add_sum(int a, int b) { return a + b; }

// m-tiles side by side for a pass of `rows` lane rows (1, 2, 4 or 8)
__device__ __forceinline__ int pass_wm(int rows, int mt) {
  const int tiles = (rows + mt - 1) / mt;
  return tiles > 4 ? 8 : tiles > 2 ? 4 : tiles;
}

// the least ring (elements) a pass may be given: NSTAGE slots of RMAX rows
// of 64 inputs.  After the products the ring holds the k-groups' sums,
// (WARPS - 1) x 32 x NV 4-byte sums.
template <typename WT>
__host__ __device__ constexpr int ring_min() {
  return NSTAGE * Rows<WT>::RMAX * (64 + Rows<WT>::PAD);
}

// row(r): the address of row r's inputs (16-byte aligned), or nullptr for
// zeros; a row holds kin inputs (a multiple of 16 bytes), and inputs kin ..
// K - 1 are zeros.  B: bf16 or int8 fragments [K / k-step][NC/8][32]
// (cuda_build.b_fragments) or f32 [K][NC], in shared or global memory.  K
// a multiple of 64.  ring: ring_cap >= ring_min elements.  gdummy: any
// global address (never read).  acc: zeroed first; with accumulate, the
// products are added to what acc holds, and without reduce each warp keeps
// its own k-group's partial sums (a later pass over the same number of
// rows may accumulate onto them and reduce: int32 sums, where any order
// gives the same result).
template <typename WT, int NC, typename Row>
__device__ __forceinline__ void pass_products(const void* B, int K, int rows, WT* ring,
                                              int ring_cap, const void* gdummy, Row row,
                                              PassAcc<WT, NC>& acc, int kin = 1 << 30,
                                              bool accumulate = false, bool reduce = true) {
  static_assert((WARPS - 1) * 32 * PassAcc<WT, NC>::NV * 4 <= ring_min<WT>() * (int)sizeof(WT),
                "the k-group sums must fit in the ring");
  using Sum = typename PassAcc<WT, NC>::Sum;
  constexpr bool MMA = sizeof(WT) < 4;  // bf16 or int8 on the tensor cores
  constexpr int MT = Rows<WT>::MT, PAD = Rows<WT>::PAD, EPP = 16 / (int)sizeof(WT);
  constexpr int NV = PassAcc<WT, NC>::NV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int WM = pass_wm(rows, MT), WK = WARPS / WM, mt = warp % WM, kg = warp / WM;
  const int srows = WM * MT;
  int KC = 64;  // the widest chunk whose slots fit the ring
  for (int m = K / 64; m > 1; --m) {
    const int kc = 64 * m, n = K / kc;
    if (K % kc == 0 && (n < NSTAGE ? n : NSTAGE) * srows * (kc + PAD) <= ring_cap) {
      KC = kc;
      break;
    }
  }
  const int LDA = KC + PAD, SLOT = srows * LDA, nch = K / KC;
  const int ppr = KC / EPP, pieces = srows * ppr;  // 16-byte pieces per row, per chunk
  auto stage = [&](int c) {
    if (c < nch) {
      WT* dst = ring + (c % NSTAGE) * SLOT;
      for (int i = tid; i < pieces; i += THREADS) {
        const int r = i / ppr, e = (i - r * ppr) * EPP, k = c * KC + e;
        const WT* p = r < rows && k < kin ? row(r) : nullptr;
        if (p) p += k;
        cp_async16(dst + r * LDA + e, p ? static_cast<const void*>(p) : gdummy, p != nullptr);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) stage(c);
  Sum* flat = reinterpret_cast<Sum*>(acc.v);  // NV sums, indexed in unrolled loops
  if (!accumulate) {
#pragma unroll
    for (int i = 0; i < NV; ++i) flat[i] = 0;
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk c is in, and chunk c - 1's slot is free
    stage(c + NSTAGE - 1);
    const WT* A = ring + (c % NSTAGE) * SLOT + mt * MT * LDA;
    const int k0 = c * KC;
    if constexpr (MMA) {
      constexpr int NT = NC / 8, KS = 32 / (int)sizeof(WT);
      // the chunk's k-steps s (global) with s % WK == kg
      const int s_lo = k0 / KS, s0 = s_lo + ((kg - s_lo) % WK + WK) % WK;
      mma_rows16<NT>(A - k0, LDA, static_cast<const uint2*>(B), s0, s_lo + KC / KS, WK, acc.v);
    } else {
      constexpr int CPT = NC / 4;
      const int q_lo = k0 / 4, q0 = q_lo + ((kg - q_lo) % WK + WK) % WK;
      fma_rows32<CPT>(A - k0, LDA, static_cast<const float*>(B), 4 * q0, k0 + KC, WK, acc.v);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  if (WK > 1 && reduce) {  // red[(group - 1, m-tile)][i][lane] in the ring: no bank conflicts
    Sum* red = reinterpret_cast<Sum*>(ring);
    Sum* mine = red + ((kg - 1) * WM + mt) * NV * 32 + lane;
    if (kg > 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) mine[32 * i] = flat[i];
    }
    __syncthreads();
    if (kg == 0)
      for (int g = 1; g < WK; ++g) {
        const Sum* other = red + ((g - 1) * WM + mt) * NV * 32 + lane;
#pragma unroll
        for (int i = 0; i < NV; ++i) flat[i] = add_sum(flat[i], other[32 * i]);
      }
    __syncthreads();  // the ring is free again
  }
}

// ---------------------------------------------------------------------------
// A grid barrier in two halves, so that a block can do work that needs no
// other block's writes between arriving and waiting (cooperative_groups'
// grid.sync cannot be split).  One 32-bit word: each block adds 1 to it,
// block 0 adds 2^31 - (blocks - 1), so its top bit (the generation) flips
// with the last arrival, which is itself the release, and its low bits
// return to 0.  bar is zeroed once when it is allocated and serves launch
// after launch (one launch at a time).  All blocks must be co-resident (a
// cooperative launch).  Every thread calls both halves.

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Returns the word before this block's arrival (thread 0's; the others'
// is unused).  The add is a release: the block's writes before the
// __syncthreads are visible to every block that has seen the flip.
__device__ __forceinline__ unsigned grid_arrive(unsigned* bar) {
  __syncthreads();
  unsigned old = 0;
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(bar), "r"(add) : "memory");
  }
  return old;
}

__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned old) {
  if (threadIdx.x == 0) {
    while (((ld_acquire(bar) ^ old) & 0x80000000u) == 0) {
    }
  }
  __syncthreads();  // every block's writes before its arrival are visible
}

// ---------------------------------------------------------------------------
// TMA and wgmma.  One thread of a producer warp loads tiles of a row-major
// 2-D tensor into shared memory (tma_load), each stage's bytes counted on
// its `full` mbarrier; consumer warpgroups multiply the tiles with wgmma,
// reading both operands from shared memory through smem_desc.  A tile row
// is 128 bytes (64 bf16 or 128 int8 inputs), stored in the 128-byte swizzle.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the tensor map at (inner coordinate c0, row c1) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters.  The blocks of a cluster run at once on SMs of one
// GPC and may address each other's shared memory: a TMA load can land in
// several of them at the same offset (multicast), each block's bytes
// counted on its own mbarrier at the same offset, and a block can arrive on
// a peer's mbarrier.

// the block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// a barrier of every thread of every block of the cluster (a release and an
// acquire at cluster scope); it also orders the block's own threads
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one arrival on the mbarrier at `bar`'s offset in the shared memory of the
// cluster's block `rank` (this block included).  Its release is at the
// block's scope, as CUTLASS's cluster pipelines release a slot: what it
// orders are the thread's reads of its own block's slot, done by then;
// .release.cluster made each arrival cost about as much as the products
// of a chunk (kernel C's loop at N = 1,024 on an H100: 110 against 55 us a
// step)
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(rank)
      : "memory");
}

// mbar_wait as an acquire at cluster scope: what the arrivals of peer
// blocks released (their reads of a slot done) is ordered before what
// follows
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of a 3-D tensor map at (inner coordinate c0, row c1, plane c2) into
// the shared memory at `dst`'s offset of every block of the cluster in
// `mask` (bit r: rank r), each block's bytes counted on its mbarrier at
// `bar`'s offset
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1, int c2,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// orders the thread's ordinary (generic proxy) accesses of global memory
// before it with TMA's (async proxy) accesses after it, on either side of a
// barrier: a block's stores before a grid barrier, another block's TMA
// loads of them after it
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (as TMA stores it): start address / 16, leading offset 16 bytes (unused
// by this layout), 1,024 bytes between groups of 8 rows, layout SWIZZLE_128B;
// + 2 moves it 32 bytes (one k-step) along the rows
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// keep the compiler from moving accesses of a warpgroup's sums across the
// asynchronous products
__device__ __forceinline__ void fence_sums(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_sums(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up at run time in the libcuda.so.1
// the CUDA runtime has loaded, so the library links against no libcuda stub
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// rows x cols elements of `type` (elem_bytes each), row-major, read in boxes
// of box_rows x 128 bytes, 128-byte swizzle, zeros outside
inline bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols,
                        int box_rows, CUtensorMapDataType type, int elem_bytes) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// planes x rows x cols elements of `type`, row-major, read in boxes of one
// plane x box_rows x 128 bytes, 128-byte swizzle, zeros outside
inline bool encode_planes(EncodeTiled fn, CUtensorMap* map, const void* ptr, int planes, int rows,
                          int cols, int box_rows, CUtensorMapDataType type, int elem_bytes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * elem_bytes,
                                 static_cast<cuuint64_t>(rows) * cols * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
