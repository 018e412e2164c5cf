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
// What bounds it on an H100: about 370 k operations per frame (the two
// products) against 640 bytes of waveform read and 320 bytes of features
// written, so operations.  The products run on the tensor cores in tf32
// with the operands split into pieces of 11 significant bits (3xTF32:
// a b ~ a0 b0 + a0 b1 + a1 b0), which keeps them near f32 as the f32
// contract asks (ROADMAP "Numeric contracts"); plain tf32 or bf16 would not.
// The first N3 bin tiles (bins 0-15 at N3 = 2) take both operands in
// three pieces, which represent an f32 value exactly, and six products:
// preemphasis scales those bins by 0.03-0.18, so their power is small
// against the frame's, and the log of a low-power bin magnifies the error
// of the two-piece split toward the 1e-4 gate (tools/mel_precision.py;
// PERF.md §6).  mma.sync, not wgmma: the f32 adds below need each
// k-step's sums in registers, which wgmma's asynchronous accumulators do
// not give without a wait per k-step.
//
// Design.  A block owns BM = 64 consecutive frames of one utterance.  It
// stages the (BM + 1) x hop samples they cover as rows of hop samples in
// shared memory (frame t is rows t and t + 1: no gather; a k-step of 8
// inputs lies in one row since hop % 8 == 0), splits them once into three
// arrays of tf32 pieces, and stages the filterbank fragments of the mel
// tiles' nonzero k-steps.  The K bins, padded to NBT = ceil(K / 8) bin
// tiles of 8 cos and 8 sin columns, are shared out among the warps, two
// tiles a pass (bin 256, alone in tile 32, goes to a warp without a
// three-piece tile); a warp computes its tiles for all BM frames, so each
// piece of the constants is read from L2 once per block, AHEAD k-steps
// ahead into registers.  Per k-step and 16 x 8 tile the products go into
// fresh tensor-core sums, one product of every m-tile before the next, and
// are added to the f32 running sum on the CUDA cores (IEEE rounding, which
// the tensor cores' accumulation across k-steps does not give).  The
// pass's power, re*re + im*im + dither^2, goes to shared memory.  Then the
// warps share out the (mel tile, m-tile) units: 3xTF32 products over only
// the k-steps where the filterbank tile has nonzero rows, + 1e-20, the log,
// and the (N, T, M) stores.  One launch per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldmatrix_x4;
using hopper::mma_tf32;
using hopper::mma_tf32_fresh;
using hopper::to_tf32;

constexpr int BM = 64;            // frames per block
constexpr int MTILES = BM / 16;   // m-tiles of 16 frames
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int AHEAD = 2;          // k-steps of constants loaded ahead into registers

struct Args {
  const float* x;        // (N, S), S % 4 == 0, 16-byte aligned
  const float4* dft;     // (NBT, SK, 2, 32): cos / sin pieces 0, 1 in fragment order
  const float4* dft3;    // (N3, SK, 32): third pieces of the first N3 bin tiles, cos and sin
  const float4* fb;      // (NBT, MP / 8, 32): fbT pieces 0, 1 in fragment order
  const int* fb_steps;   // (MP / 8, 2): the k-steps [lo, hi) of each mel tile's nonzero rows
  float* out;            // (N, T, M)
  int S, T, hop, K, M, NBT, MP, N3;
  float dither2;
};

// f32 pieces of 11 significant bits: v = p0 + p1 (+ p2, exact with three)
template <int P>
__device__ __forceinline__ void split(float v, unsigned (&p)[3]) {
  p[0] = to_tf32(v);
  const float r = __fsub_rn(v, __uint_as_float(p[0]));  // exact
  p[1] = to_tf32(r);
  if constexpr (P == 3) p[2] = to_tf32(__fsub_rn(r, __uint_as_float(p[1])));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest filled with zeros
__device__ __forceinline__ void cp_async_part(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

template <int V>
using Const = std::integral_constant<int, V>;

__global__ void __launch_bounds__(THREADS, 1) log_mel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int hop = a.hop, LDS = hop + 4, LDP = 8 * a.NBT + 4, SK = 2 * hop / 8, MPT = a.MP / 8;
  const int AS = (BM + 1) * LDS;
  float* apiece = sm;                // 3 x (BM + 1, LDS): the frames' tf32 pieces, rows of hop
  float* spec = sm + 3 * AS;         // (BM, LDP): power spectrum
  float* melb = spec + BM * LDP;     // the filterbank's fragments of the mel tiles' k-steps
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.y, t0 = blockIdx.x * BM;
  const float* xn = a.x + (size_t)n * a.S;

  // stage: the block's (BM + 1) rows of hop samples, four a copy, zeros
  // past S (the wrapper gives rows of a multiple of 4 samples from a
  // 16-byte boundary), and the filterbank fragments of every mel tile's
  // nonzero k-steps, tile after tile
  const long long base = (long long)t0 * hop;
  const int pieces = hop / 4;
  for (int i = tid; i < (BM + 1) * pieces; i += THREADS) {
    const int r = i / pieces, c = 4 * (i - r * pieces);
    const long long s = base + (long long)r * hop + c, left = a.S - s;
    const int bytes = 4 * (int)(left < 4 ? (left > 0 ? left : 0) : 4);
    cp_async_part(apiece + r * LDS + c, bytes ? xn + s : xn, bytes);
  }
  for (int j = 0, off = 0; j < MPT; ++j) {  // MPT <= 32
    const int lo = __ldg(a.fb_steps + 2 * j), len = __ldg(a.fb_steps + 2 * j + 1) - lo;
    for (int i = tid; i < 32 * len; i += THREADS)
      cp_async16(melb + 4 * (32 * off + i), a.fb + ((size_t)(lo + i / 32) * MPT + j) * 32 + i % 32,
                 true);
    off += len;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the frames split into tf32 pieces once, in place: p0, p1, p2 arrays
  for (int i = 4 * tid; i < AS; i += 4 * THREADS) {
    const float4 v = *reinterpret_cast<const float4*>(apiece + i);
    unsigned p[4][3];
    split<3>(v.x, p[0]);
    split<3>(v.y, p[1]);
    split<3>(v.z, p[2]);
    split<3>(v.w, p[3]);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<uint4*>(apiece + q * AS + i) = make_uint4(p[0][q], p[1][q], p[2][q], p[3][q]);
  }
  // each mel tile's k-steps [lo, lo + len) and its first fragment in melb,
  // held by lane j (MP / 8 <= 32)
  const int mlo = lane < MPT ? __ldg(a.fb_steps + 2 * lane) : 0;
  const int mlen = lane < MPT ? __ldg(a.fb_steps + 2 * lane + 1) - mlo : 0;
  int moff = mlen;  // inclusive scan, then exclusive
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, moff, d);
    if (lane >= d) moff += v;
  }
  moff -= mlen;
  __syncthreads();

  // The warp's bin tiles: w, w + 8, ... below the last multiple of 8, and
  // the tiles past it (bin 256 at K = 257) on the warps after the ones that
  // hold the three-piece tiles.  A pass takes two of them: tile(2p), tile(2p + 1).
  const int nfull = a.NBT / WARPS, extra = (warp - a.N3 % WARPS + WARPS) % WARPS;
  const bool has_extra = extra < a.NBT - nfull * WARPS;
  const int ntiles = nfull + has_extra, npass = (ntiles + 1) / 2;
  auto tile = [&](int i) { return i < nfull ? warp + WARPS * i : nfull * WARPS + extra; };

  // DFT bin tiles on the tensor cores.  ldmatrix lane l addresses row
  // (l & 7) + 8 ((l >> 3) & 1), column 4 (l >> 4) of a 16 x 8 A tile.
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 4 * (lane >> 4);
  // pieces: of tile(2p) (2 or 3); NT: n-tiles, cos and sin of one or two tiles
  auto pass = [&](int p, auto pieces_c, auto n_tiles) {
    constexpr int P = decltype(pieces_c)::value, NT = decltype(n_tiles)::value;
    const int ja = tile(2 * p);
    const float4* src[2] = {a.dft + (size_t)ja * SK * 64 + lane,
                            a.dft + (size_t)tile(2 * p + NT / 2 - 1) * SK * 64 + lane};
    const float4* src3 = a.dft3 + (size_t)ja * SK * 32 + lane;
    float4 bq[AHEAD][NT + 1];  // the constants of k-steps s .. s + AHEAD - 1
    auto load = [&](int d, int s) {
#pragma unroll
      for (int j = 0; j < NT; ++j) bq[d][j] = __ldg(src[j / 2] + s * 64 + 32 * (j & 1));
      if constexpr (P == 3) bq[d][NT] = __ldg(src3 + s * 32);
    };
#pragma unroll
    for (int d = 0; d < AHEAD; ++d)
      if (d < SK) load(d, d);
    float run[NT][MTILES][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int m = 0; m < MTILES; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[j][m][e] = 0.0f;
    for (int s0 = 0; s0 < SK; s0 += AHEAD) {
#pragma unroll
      for (int d = 0; d < AHEAD; ++d) {
        const int s = s0 + d;
        if (s >= SK) break;
        unsigned b[NT][3][2];  // [n-tile][piece][k = t, t + 4]
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          b[j][0][0] = __float_as_uint(bq[d][j].x);
          b[j][0][1] = __float_as_uint(bq[d][j].y);
          b[j][1][0] = __float_as_uint(bq[d][j].z);
          b[j][1][1] = __float_as_uint(bq[d][j].w);
        }
        if constexpr (P == 3) {
          b[0][2][0] = __float_as_uint(bq[d][NT].x);
          b[0][2][1] = __float_as_uint(bq[d][NT].y);
          b[1][2][0] = __float_as_uint(bq[d][NT].z);
          b[1][2][1] = __float_as_uint(bq[d][NT].w);
        }
        if (s + AHEAD < SK) load(d, s + AHEAD);
        const int up = 8 * s >= hop;  // the frame's second row of hop samples
        const float* arow = apiece + (lrow + up) * LDS + 8 * s - up * hop + lcol;
        unsigned pc[MTILES][3][4];  // [m-tile][piece]: A fragments
#pragma unroll
        for (int m = 0; m < MTILES; ++m)
#pragma unroll
          for (int q = 0; q < P; ++q) ldmatrix_x4(pc[m][q], arow + q * AS + 16 * m * LDS);
        // per n-tile, the k-step's products of the m-tiles into fresh sums,
        // smallest first, one product of every m-tile before the next (the
        // m-tiles' sums are independent, so the tensor pipe stays busy)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float d4[MTILES][4];
          const bool three = P == 3 && j < 2;
#pragma unroll
          for (int m = 0; m < MTILES; ++m)
            if (three)
              mma_tf32_fresh(d4[m], pc[m][2], b[j][0][0], b[j][0][1]);
            else
              mma_tf32_fresh(d4[m], pc[m][1], b[j][0][0], b[j][0][1]);
          if (three) {
#pragma unroll
            for (int m = 0; m < MTILES; ++m) mma_tf32(d4[m], pc[m][1], b[j][1][0], b[j][1][1]);
#pragma unroll
            for (int m = 0; m < MTILES; ++m) mma_tf32(d4[m], pc[m][0], b[j][2][0], b[j][2][1]);
#pragma unroll
            for (int m = 0; m < MTILES; ++m) mma_tf32(d4[m], pc[m][1], b[j][0][0], b[j][0][1]);
          }
#pragma unroll
          for (int m = 0; m < MTILES; ++m) mma_tf32(d4[m], pc[m][0], b[j][1][0], b[j][1][1]);
#pragma unroll
          for (int m = 0; m < MTILES; ++m) mma_tf32(d4[m], pc[m][0], b[j][0][0], b[j][0][1]);
#pragma unroll
          for (int m = 0; m < MTILES; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) run[j][m][e] = __fadd_rn(run[j][m][e], d4[m][e]);
        }
      }
    }
    // power of the pass's bins: C fragment rows g, g + 8, columns 2 t, 2 t + 1
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int jb = tile(2 * p + j / 2);
#pragma unroll
      for (int m = 0; m < MTILES; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float re = run[j][m][e], im = run[j + 1][m][e];
          const int row = 16 * m + g + 8 * (e >> 1), bin = 8 * jb + 2 * t + (e & 1);
          spec[row * LDP + bin] =
              __fadd_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), a.dither2);
        }
    }
  };
  for (int p = 0; p < npass; ++p) {  // only a pass's first tile can be a three-piece one
    const bool two = 2 * p + 1 < ntiles;
    if (tile(2 * p) < a.N3) {
      if (two)
        pass(p, Const<3>{}, Const<4>{});
      else
        pass(p, Const<3>{}, Const<2>{});
    } else if (two) {
      pass(p, Const<2>{}, Const<4>{});
    } else {
      pass(p, Const<2>{}, Const<2>{});
    }
  }
  __syncthreads();  // the power spectrum is complete

  // mel tiles in 3xTF32 over the k-steps of their nonzero filterbank rows,
  // by (mel tile, m-tile) units shared out among the warps
  for (int u = warp; u < MPT * MTILES; u += WARPS) {
    const int j = u / MTILES, m = u - j * MTILES;
    const int lo = __shfl_sync(0xffffffffu, mlo, j), len = __shfl_sync(0xffffffffu, mlen, j);
    const float* frag = melb + 128 * __shfl_sync(0xffffffffu, moff, j) + 4 * lane;
    const float* arow = spec + (16 * m + lrow) * LDP + 8 * lo + lcol;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < len; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(frag + 128 * s);
      unsigned raw[4], p[4][3];
      ldmatrix_x4(raw, arow + 8 * s);
#pragma unroll
      for (int e = 0; e < 4; ++e) split<2>(__uint_as_float(raw[e]), p[e]);
      const unsigned p0[4] = {p[0][0], p[1][0], p[2][0], p[3][0]};
      const unsigned p1[4] = {p[0][1], p[1][1], p[2][1], p[3][1]};
      mma_tf32(acc, p1, __float_as_uint(v.x), __float_as_uint(v.y));
      mma_tf32(acc, p0, __float_as_uint(v.z), __float_as_uint(v.w));
      mma_tf32(acc, p0, __float_as_uint(v.x), __float_as_uint(v.y));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * m + g + 8 * (e >> 1), mel = 8 * j + 2 * t + (e & 1);
      if (t0 + row < a.T && mel < a.M)
        a.out[((size_t)n * a.T + t0 + row) * a.M + mel] = logf(__fadd_rn(acc[e], 1e-20f));
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes, for NBT bin tiles and
// fb_frags filterbank fragments (the mel tiles' nonzero k-steps).
size_t rnnt_log_mel_smem(int hop, int NBT, int fb_frags) {
  return sizeof(float) * (3 * (size_t)(BM + 1) * (hop + 4) + (size_t)BM * (8 * NBT + 4) +
                          128 * (size_t)fb_frags);
}

// Frames per block (BM): the stamps of tools/kernel_phases.py are per block.
int rnnt_log_mel_frames_per_block() { return BM; }

// One launch on `stream`: x (N, S) -> out (N, T, M), S a multiple of 4 and
// x on a 16-byte boundary.  Returns 0 or the CUDA
// error of the refused launch.
int rnnt_log_mel(const void* x, const void* dft, const void* dft3, const void* fb,
                 const void* fb_steps, void* out, int N, int S, int T, int hop, int K, int M,
                 int N3, int fb_frags, float dither2, void* stream) {
  const int NBT = (K + 7) / 8, MP = (M + 7) / 8 * 8;
  if (N <= 0 || N > 65535 || T <= 0 || S < 0 || S % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || hop <= 0 || hop % 8 != 0 || K <= 0 || M <= 0 ||
      MP > 256 || N3 < 0 || N3 > WARPS || N3 > NBT || fb_frags < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rnnt_log_mel_smem(hop, NBT, fb_frags);
  cudaError_t err = cudaFuncSetAttribute(log_mel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const float*>(x), static_cast<const float4*>(dft),
         static_cast<const float4*>(dft3), static_cast<const float4*>(fb),
         static_cast<const int*>(fb_steps), static_cast<float*>(out), S, T, hop, K, M, NBT, MP,
         N3, dither2};
  const dim3 grid((T + BM - 1) / BM, N);
  log_mel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
