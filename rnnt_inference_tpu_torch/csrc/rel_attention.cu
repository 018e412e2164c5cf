// Kernel F: relative-position multi-head attention over many utterances of
// different lengths in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no attention.  It was added
// for the Conformer encoder (models/conformer.py), whose self-attention is
// NeMo's RelPositionMultiHeadAttention with untied biases.  For one head of
// one utterance of L rows (ops/attention_cuda.py states the layout):
//   score[i, j] = ((q_i + u) . k_j + (q_i + vb) . p(i - j)) / sqrt(D)
//   out_i       = sum_j softmax_j(score[i, :]) v_j
// where p(r) is row t_max - 1 - r of pos (NeMo's rel_shift written out).
// q + u and q + vb are formed in f32 and rounded to bf16; the three
// products are bf16 mma.sync m16n8k16 with f32 sums; the softmax is online
// (flash attention: the L x L scores never reach memory) in f32 on the
// exp2 scale; its unnormalized probabilities are rounded to bf16 for the
// product with v; the output is rounded once to bf16.
//
// What bounds it on an H100: per head and utterance 6 L^2 D operations
// against about 8 L D bytes (q, k, v, out) plus the position band, some
// L / 2 operations a byte, below the card's ridge (295) at the Conformer's
// L <= 376: bandwidth, and at short L the latency of the few tiles.
//
// Design.  A block of 4 warps owns one (query tile of BM = 64 rows, head,
// utterance); a warp owns 16 query rows, whose q + u and q + vb stay in
// registers as mma A fragments.  The block walks the utterance's key tiles
// of BN = 64 rows (nothing past its length is read or computed), two
// stages of K and V in shared memory by cp.async, the next tile's loads in
// flight during this tile's products.  For key tile j0 the pairs need
// relative positions i0 - j0 - 63 .. i0 - j0 + 63, the 127 rows of pos
// from p0 = t_max - 1 - i0 + j0 - 63; successive tiles' bands overlap by
// half, so pos is staged in chunks of 64 rows in a ring of three, and each
// tile loads one new chunk.  A warp's 16 rows need 79 of the band's rows;
// their product (q + vb) . p over 80 rows goes to the warp's scratch in
// shared memory, and each lane reads the score term of its C fragment from
// there at column j - i + 15 (the skew of rel_shift).  Then scale, mask the
// keys past L, the online softmax on the fragments (quad shuffles), the
// probabilities as A fragments of the product with V (ldmatrix .trans).
// 86 KB of shared memory a block: two blocks an SM.
//
// The streaming form (rel_attention_stream) serves the cache-aware
// FastConformer's chunked-limited attention (ops/attention_cuda.py states
// the layout): each of N slots brings C <= 16 query rows, one chunk, and
// attends to the keys of its last R <= 6 chunks, read in place from the
// slot's ring of K and V rows (a chunk a place), the position band of (R +
// 1) C - 1 rows shared by every slot.  A 64-row query tile would leave 78%
// of the tile empty at C = 14, so one warp owns one (slot, head): its C
// rows are one m16 tile of q + u and q + vb; it stages the R chunks' K and V
// (16 rows a chunk, rows it may not see zero-filled by cp.async: before the
// utterance, past its length, past C) and the band (112 rows) once, forms
// the band product (q + vb) . p over all 112 rows into shared memory, and
// reads each pair's term at band row C - 1 - i + m C + r, as the full form
// reads its skewed band.  All of a row's scores (16 R at most) stay in
// registers, so the softmax (f32, exp2 scale) is taken whole: max, exp2,
// sum, then the probabilities (bf16) . v.  A row that may see no key (a slot
// with no frames in this chunk) writes zeros.  55 KB of shared memory a
// warp: four warps an SM, every slot's heads in about two waves at N = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldmatrix_x4;
using hopper::mma_k32bytes;

constexpr int BM = 64;          // query rows a block
constexpr int BN = 64;          // key rows a tile; also the rows of a pos chunk
constexpr int THREADS_F = 128;  // 4 warps of 16 query rows
constexpr int WBAND = 80;       // band rows a warp's product covers (16 + BN - 1 used)
constexpr int BS = 84;          // row stride (floats) of a warp's band scratch
constexpr int PCH = 3;          // pos chunks in the ring

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *pos;
  const float *u, *vb;
  __nv_bfloat16* out;
  const int *starts, *lens;
  long long sq, sk, sv, sp, so;  // row strides, in elements
  int n_mt, t_max;
  float scale_log2;  // log2(e) / sqrt(D)
};

// shared memory, in bf16 elements: K and V in two stages each, the pos ring,
// then the warps' f32 band scratch.  LD = D + 8: a row is an odd multiple
// of 16 bytes, so ldmatrix is free of bank conflicts.  q + u and q + vb are
// staged in K's and V's second stage before the loop.
template <int D>
struct Smem {
  static constexpr int LD = D + 8;
  static constexpr int K0 = 0, V0 = 2 * BN * LD, P0 = 4 * BN * LD;
  static constexpr int END = P0 + PCH * BN * LD;
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * END + sizeof(float) * 4 * 16 * BS;
};

template <int D>
__global__ void __launch_bounds__(THREADS_F) rel_attention_fwd(const Args a) {
  using S = Smem<D>;
  constexpr int LD = S::LD, KD = D / 16, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int mt = blockIdx.x % a.n_mt, b = blockIdx.x / a.n_mt, h = blockIdx.y;
  const int L = a.lens[b], i0 = mt * BM;
  if (i0 >= L) return;
  const long long start = a.starts[b];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: which 8 x 8 matrix, which of its rows
  const int nkt = (L + BN - 1) / BN;
  const int p00 = a.t_max - 1 - i0 - (BM - 1);  // pos row of chunk 0's first row

  auto stage_kv = [&](int kt) {
    __nv_bfloat16* sk = sm + S::K0 + (kt & 1) * BN * LD;
    __nv_bfloat16* sv = sm + S::V0 + (kt & 1) * BN * LD;
    for (int c = tid; c < BN * CH; c += THREADS_F) {
      const int r = c / CH, e = (c % CH) * 8;
      const bool ok = kt * BN + r < L;
      const long long row = start + (ok ? kt * BN + r : 0);
      cp_async16(sk + r * LD + e, a.k + row * a.sk + h * D + e, ok);
      cp_async16(sv + r * LD + e, a.v + row * a.sv + h * D + e, ok);
    }
  };
  auto stage_pos = [&](int chunk) {
    __nv_bfloat16* sp = sm + S::P0 + (chunk % PCH) * BN * LD;
    for (int c = tid; c < BN * CH; c += THREADS_F) {
      const int r = c / CH, e = (c % CH) * 8;
      const int prow = p00 + chunk * BN + r;
      const bool ok = prow >= 0 && prow < 2 * a.t_max - 1;
      cp_async16(sp + r * LD + e, a.pos + (long long)(ok ? prow : 0) * a.sp + h * D + e, ok);
    }
  };

  stage_kv(0);
  stage_pos(0);
  stage_pos(1);
  cp_async_commit();

  // q + u and q + vb, rounded to bf16, into the second stage of K and V
  {
    __nv_bfloat16* squ = sm + S::K0 + BN * LD;
    __nv_bfloat16* sqv = sm + S::V0 + BN * LD;
    for (int c = tid; c < BM * (D / 2); c += THREADS_F) {
      const int r = c / (D / 2), e = (c % (D / 2)) * 2;
      float2 qf = make_float2(0.0f, 0.0f);
      if (i0 + r < L)
        qf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a.q + (start + i0 + r) * a.sq + h * D + e));
      const float* u = a.u + h * D + e;
      const float* vb = a.vb + h * D + e;
      *reinterpret_cast<__nv_bfloat162*>(squ + r * LD + e) =
          __floats2bfloat162_rn(__fadd_rn(qf.x, u[0]), __fadd_rn(qf.y, u[1]));
      *reinterpret_cast<__nv_bfloat162*>(sqv + r * LD + e) =
          __floats2bfloat162_rn(__fadd_rn(qf.x, vb[0]), __fadd_rn(qf.y, vb[1]));
    }
  }
  __syncthreads();
  unsigned aqu[KD][4], aqv[KD][4];
  {
    const int off = (16 * warp + r8 + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldmatrix_x4(aqu[kk], sm + S::K0 + BN * LD + off + 16 * kk);
      ldmatrix_x4(aqv[kk], sm + S::V0 + BN * LD + off + 16 * kk);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
  float* band = reinterpret_cast<float*>(sm + S::END) + warp * 16 * BS;
  const int wb = 48 - 16 * warp;  // the first band row this warp's rows need

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1 (and with q)
    if (kt + 1 < nkt) {
      stage_kv(kt + 1);
      stage_pos(kt + 2);
      cp_async_commit();
    }
    const int j0 = kt * BN;
    const __nv_bfloat16* sk = sm + S::K0 + (kt & 1) * BN * LD;
    const __nv_bfloat16* sv = sm + S::V0 + (kt & 1) * BN * LD;

    // (q + u) . k
    float sc[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        unsigned bb[4];
        ldmatrix_x4(bb, sk + (16 * np + r8 + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1));
        mma_k32bytes(sc[2 * np], aqu[kk], make_uint2(bb[0], bb[1]));
        mma_k32bytes(sc[2 * np + 1], aqu[kk], make_uint2(bb[2], bb[3]));
      }

    // (q + vb) . p over the warp's 80 band rows, into its scratch
#pragma unroll
    for (int np = 0; np < WBAND / 16; ++np) {
      const int w = wb + 16 * np;  // band row of this 16-row group, in one chunk
      const __nv_bfloat16* sp = sm + S::P0 + ((kt + w / BN) % PCH) * BN * LD + (w % BN) * LD;
      float bd[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned bb[4];
        ldmatrix_x4(bb, sp + (r8 + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1));
        mma_k32bytes(bd[0], aqv[kk], make_uint2(bb[0], bb[1]));
        mma_k32bytes(bd[1], aqv[kk], make_uint2(bb[2], bb[3]));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 16 * np + 8 * e + 2 * t;
        band[g * BS + col] = bd[e][0];
        band[g * BS + col + 1] = bd[e][1];
        band[(g + 8) * BS + col] = bd[e][2];
        band[(g + 8) * BS + col + 1] = bd[e][3];
      }
    }
    __syncwarp();

    // score (exp2 scale), keys past L masked; the row maxima
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
        float x = __fmul_rn(__fadd_rn(sc[n][e], band[r * BS + col - r + 15]), a.scale_log2);
        if (j0 + col >= L) x = -INFINITY;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      alpha[rr] = exp2f(m_r[rr] - mx[rr]);
      m_r[rr] = mx[rr];
      l_r[rr] = __fmul_rn(l_r[rr], alpha[rr]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] = __fmul_rn(o[n][0], alpha[0]);
      o[n][1] = __fmul_rn(o[n][1], alpha[0]);
      o[n][2] = __fmul_rn(o[n][2], alpha[1]);
      o[n][3] = __fmul_rn(o[n][3], alpha[1]);
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - m_r[e >> 1]);
        l_r[e >> 1] = __fadd_rn(l_r[e >> 1], sc[n][e]);
      }

    // probabilities (bf16) . v: the C fragments of key n-tiles 2 kk, 2 kk + 1
    // are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned bb[4];
        ldmatrix_x4_trans(bb, sv + (16 * kk + r8 + 8 * (mi & 1)) * LD + 16 * np + 8 * (mi >> 1));
        mma_k32bytes(o[2 * np], pa, make_uint2(bb[0], bb[1]));
        mma_k32bytes(o[2 * np + 1], pa, make_uint2(bb[2], bb[3]));
      }
    }
  }

  // the quad's partial sums of each row, then the output rows
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_r[rr] = __fadd_rn(l_r[rr], __shfl_xor_sync(0xffffffffu, l_r[rr], 1));
    l_r[rr] = __fadd_rn(l_r[rr], __shfl_xor_sync(0xffffffffu, l_r[rr], 2));
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + 16 * warp + g + 8 * rr;
    if (i >= L) continue;
    __nv_bfloat16* orow = a.out + (start + i) * a.so + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          __fdiv_rn(o[n][2 * rr], l_r[rr]), __fdiv_rn(o[n][2 * rr + 1], l_r[rr]));
  }
}

template <int D>
cudaError_t launch(const Args& a, int B, int H, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rel_attention_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  rel_attention_fwd<D><<<dim3(a.n_mt * B, H), THREADS_F, Smem<D>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

// ---- the streaming form ----------------------------------------------------

constexpr int ST = 16;          // rows of a chunk's tile: queries, keys, values
constexpr int SRING = 6;        // chunks the ring may hold
constexpr int SBAND = 112;      // band rows staged, >= (R + 1) C - 1
constexpr int SBS = SBAND + 4;  // row stride (floats) of the band product's scratch

struct StreamArgs {
  const __nv_bfloat16 *q, *kv, *band;
  const float *u, *vb;
  const int *chunk, *enc_len;
  __nv_bfloat16* out;
  long long sq, sband, so;  // row strides, in elements
  int H, C, R, pos;
  float scale_log2;  // log2(e) / sqrt(D)
};

// shared memory, in bf16 elements: K and V (SRING tiles of ST rows each), q +
// u and q + vb, the band; then the f32 scratch of the band product
template <int D>
struct StreamSmem {
  static constexpr int LD = D + 8;
  static constexpr int K0 = 0, V0 = SRING * ST * LD, Q0 = 2 * SRING * ST * LD;
  static constexpr int P0 = Q0 + 2 * ST * LD, END = P0 + SBAND * LD;
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * END + sizeof(float) * ST * SBS;
};

template <int D>
__global__ void __launch_bounds__(32) rel_attention_stream(const StreamArgs a) {
  using S = StreamSmem<D>;
  constexpr int LD = S::LD, KD = D / 16, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* scr = reinterpret_cast<float*>(sm + S::END);

  const int b = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int C = a.C, R = a.R, c = a.chunk[b], L = a.enc_len[b];
  const long long row0 = (long long)b * C;  // the slot's first query row
  if (L <= c * C) {  // no frame of the utterance in this chunk: zeros
    for (int i = lane; i < C * CH; i += 32)
      *reinterpret_cast<uint4*>(a.out + (row0 + i / CH) * a.so + h * D + (i % CH) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int cc0 = c - (R - 1);  // the chunk index of ring chunk m = 0
  const long long kvrow = 2LL * a.H * D;

  for (int i = lane; i < R * ST * CH; i += 32) {
    const int m = i / (ST * CH), r = (i / CH) % ST, e = (i % CH) * 8;
    const int cc = cc0 + m;
    const bool ok = r < C && cc >= 0 && cc * C + r < L;
    const int place = (a.pos - (R - 1) + m + R) % R;
    const __nv_bfloat16* src = a.kv + (((long long)b * R + place) * C + (ok ? r : 0)) * kvrow +
                               h * D + e;
    cp_async16(sm + S::K0 + (m * ST + r) * LD + e, src, ok);
    cp_async16(sm + S::V0 + (m * ST + r) * LD + e, src + (long long)a.H * D, ok);
  }
  const int nband = (R + 1) * C - 1;
  for (int i = lane; i < SBAND * CH; i += 32) {
    const int r = i / CH, e = (i % CH) * 8;
    const bool ok = r < nband;
    cp_async16(sm + S::P0 + r * LD + e, a.band + (long long)(ok ? r : 0) * a.sband + h * D + e,
               ok);
  }
  cp_async_commit();

  // q + u and q + vb, rounded to bf16 (rows past C from q = 0)
  for (int i = lane; i < ST * (D / 2); i += 32) {
    const int r = i / (D / 2), e = (i % (D / 2)) * 2;
    float2 qf = make_float2(0.0f, 0.0f);
    if (r < C)
      qf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.q + (row0 + r) * a.sq + h * D + e));
    const float* u = a.u + h * D + e;
    const float* vb = a.vb + h * D + e;
    *reinterpret_cast<__nv_bfloat162*>(sm + S::Q0 + r * LD + e) =
        __floats2bfloat162_rn(__fadd_rn(qf.x, u[0]), __fadd_rn(qf.y, u[1]));
    *reinterpret_cast<__nv_bfloat162*>(sm + S::Q0 + (ST + r) * LD + e) =
        __floats2bfloat162_rn(__fadd_rn(qf.x, vb[0]), __fadd_rn(qf.y, vb[1]));
  }
  cp_async_wait<0>();
  __syncthreads();

  unsigned aqu[KD][4], aqv[KD][4];
  {
    const int off = (r8 + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldmatrix_x4(aqu[kk], sm + S::Q0 + off + 16 * kk);
      ldmatrix_x4(aqv[kk], sm + S::Q0 + ST * LD + off + 16 * kk);
    }
  }

  // (q + vb) . p over the band's rows, into the scratch
#pragma unroll
  for (int np = 0; np < SBAND / 16; ++np) {
    const __nv_bfloat16* sp = sm + S::P0 + 16 * np * LD;
    float bd[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned bb[4];
      ldmatrix_x4(bb, sp + (r8 + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1));
      mma_k32bytes(bd[0], aqv[kk], make_uint2(bb[0], bb[1]));
      mma_k32bytes(bd[1], aqv[kk], make_uint2(bb[2], bb[3]));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 16 * np + 8 * e + 2 * t;
      scr[g * SBS + col] = bd[e][0];
      scr[g * SBS + col + 1] = bd[e][1];
      scr[(g + 8) * SBS + col] = bd[e][2];
      scr[(g + 8) * SBS + col + 1] = bd[e][3];
    }
  }

  // (q + u) . k for every chunk of the ring
  float sc[2 * SRING][4];
#pragma unroll
  for (int n = 0; n < 2 * SRING; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
  for (int m = 0; m < SRING; ++m) {
    if (m >= R) break;
    const __nv_bfloat16* sk = sm + S::K0 + m * ST * LD;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned bb[4];
      ldmatrix_x4(bb, sk + (r8 + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1));
      mma_k32bytes(sc[2 * m], aqu[kk], make_uint2(bb[0], bb[1]));
      mma_k32bytes(sc[2 * m + 1], aqu[kk], make_uint2(bb[2], bb[3]));
    }
  }
  __syncwarp();

  // scores (exp2 scale), pairs the mask hides at -inf; the rows' maxima
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * SRING; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = g + 8 * (e >> 1), m = n >> 1, r = 8 * (n & 1) + 2 * t + (e & 1);
      const int cc = cc0 + m;
      float x = -INFINITY;
      if (m < R && r < C && cc >= 0 && cc * C + r < L) {
        const int prow = min(max(C - 1 - qi + m * C + r, 0), SBAND - 1);
        x = __fmul_rn(__fadd_rn(sc[n][e], scr[qi * SBS + prow]), a.scale_log2);
      }
      sc[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float l_r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    if (mx[rr] == -INFINITY) mx[rr] = 0.0f;  // no key: every probability 0
  }
#pragma unroll
  for (int n = 0; n < 2 * SRING; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = exp2f(sc[n][e] - mx[e >> 1]);
      l_r[e >> 1] = __fadd_rn(l_r[e >> 1], sc[n][e]);
    }

  // probabilities (bf16) . v, a k-step a chunk
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int m = 0; m < SRING; ++m) {
    if (m >= R) break;
    const unsigned pa[4] = {pack_bf16(sc[2 * m][0], sc[2 * m][1]),
                            pack_bf16(sc[2 * m][2], sc[2 * m][3]),
                            pack_bf16(sc[2 * m + 1][0], sc[2 * m + 1][1]),
                            pack_bf16(sc[2 * m + 1][2], sc[2 * m + 1][3])};
    const __nv_bfloat16* sv = sm + S::V0 + m * ST * LD;
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned bb[4];
      ldmatrix_x4_trans(bb, sv + (r8 + 8 * (mi & 1)) * LD + 16 * np + 8 * (mi >> 1));
      mma_k32bytes(o[2 * np], pa, make_uint2(bb[0], bb[1]));
      mma_k32bytes(o[2 * np + 1], pa, make_uint2(bb[2], bb[3]));
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_r[rr] = __fadd_rn(l_r[rr], __shfl_xor_sync(0xffffffffu, l_r[rr], 1));
    l_r[rr] = __fadd_rn(l_r[rr], __shfl_xor_sync(0xffffffffu, l_r[rr], 2));
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = g + 8 * rr;
    if (qi >= C) continue;
    __nv_bfloat16* orow = a.out + (row0 + qi) * a.so + h * D + 2 * t;
    const float inv = l_r[rr] > 0.0f ? l_r[rr] : 1.0f;  // no key: o is 0
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          __fdiv_rn(o[n][2 * rr], inv), __fdiv_rn(o[n][2 * rr + 1], inv));
  }
}

template <int D>
cudaError_t launch_stream(const StreamArgs& a, int N, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(rel_attention_stream<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)StreamSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  rel_attention_stream<D><<<dim3(N, a.H), 32, StreamSmem<D>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The streaming form, one launch on `stream` over N slots and H heads of D =
// 64: q (N C rows, stride sq) bf16; kv (N, R, C, 2 H D) bf16, K then V of
// every head in a row, the ring (chunk m - (R - 1) back at place (pos - (R -
// 1) + m) mod R); band ((R + 1) C - 1 rows, stride sband) bf16; u, vb (H, D)
// f32; chunk, enc_len (N) int32; out (N C rows, stride so) bf16, every row
// written.  C <= 16, R <= 6.  Returns 0, or the CUDA error
// (cudaErrorInvalidValue for arguments it cannot take).
int rnnt_rel_attention_stream(const void* q, const void* kv, const void* band, const void* u,
                              const void* vb, const void* chunk, const void* enc_len, void* out,
                              long long sq, long long sband, long long so, int N, int H, int D,
                              int C, int R, int pos, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kv) |
                         reinterpret_cast<uintptr_t>(band) | reinterpret_cast<uintptr_t>(out);
  if (D != 64 || N <= 0 || H <= 0 || H > 65535 || C < 1 || C > ST || R < 1 || R > SRING ||
      (R + 1) * C - 1 > SBAND || pos < 0 || pos >= R || addr % 16 != 0 ||
      (sq | sband | so) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
                     static_cast<const __nv_bfloat16*>(band), static_cast<const float*>(u),
                     static_cast<const float*>(vb), static_cast<const int*>(chunk),
                     static_cast<const int*>(enc_len), static_cast<__nv_bfloat16*>(out),
                     sq, sband, so, H, C, R, pos,
                     static_cast<float>(1.4426950408889634 / sqrt((double)D))};
  return static_cast<int>(launch_stream<64>(a, N, static_cast<cudaStream_t>(stream)));
}

// One launch on `stream` over B utterances and H heads of D = 64 (the
// Conformer's): q, k, v (rows `starts[b]` .. + `lens[b]`, row strides sq,
// sk, sv) and pos (2 t_max - 1 rows, stride sp) bf16, their rows on
// 16-byte boundaries; u, vb (H, D) f32; out bf16 (stride so), written on
// the utterances' rows only.  Returns 0, or the CUDA error (of the refused
// launch; cudaErrorInvalidValue for arguments it cannot take).
int rnnt_rel_attention(const void* q, const void* k, const void* v, const void* pos,
                       const void* u, const void* vb, void* out, const void* starts,
                       const void* lens, long long sq, long long sk, long long sv, long long sp,
                       long long so, int B, int H, int D, int t_max, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(pos);
  const long long n_mt = (t_max + BM - 1) / BM;
  if (D != 64 || B <= 0 || H <= 0 || H > 65535 || t_max <= 0 || addr % 16 != 0 ||
      (sq | sk | sv | sp) % 8 != 0 || n_mt * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(pos),
               static_cast<const float*>(u), static_cast<const float*>(vb),
               static_cast<__nv_bfloat16*>(out), static_cast<const int*>(starts),
               static_cast<const int*>(lens), sq, sk, sv, sp, so, static_cast<int>(n_mt), t_max,
               static_cast<float>(1.4426950408889634 / sqrt((double)D))};
  return static_cast<int>(launch<64>(a, B, H, static_cast<cudaStream_t>(stream)));
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
