// Kernel E: a bf16 product summed in f32 on Hopper's tensor cores (sm_90a),
// the float encoder's hoisted input projection xw = x . W_ih + b first.
//
// Replaces no Pallas kernel: the JAX package leaves the product to XLA
// (jnp.dot(x, w_ih, preferred_element_type=jnp.float32),
// rnnt_inference_tpu/ops/lstm.py:64).  PyTorch's bf16 matmul rounds its
// result to bf16, so without a kernel the port upcasts both operands and
// runs an f32 GEMM on the CUDA cores.  Here C = A . B, A (M, K) bf16
// row-major, B (K, N) bf16 given as B^T (N, K) row-major (laid out once per
// weight by ops/projection_cuda.py weight_operand); the products of two
// bf16 values are exact in f32 and the tensor cores sum them in f32.  Two
// epilogues:
//   (a) out (M, N) bf16 = round_rn(C + bias), bias (N) f32: the projection
//       kernel C reads, rounded once as the plain twin rounds it; nothing
//       of size (M, N) in f32 reaches device memory;
//   (b) out (M, N) f32 = C (+ bias where given): the joint's fproj.
//
// What bounds it on an H100: 2 M N K operations at 989 TFLOP/s against
// (M K + K N) 2 + M N (2 or 4) bytes at 3.35 TB/s.  The encoder's shapes at
// K = 1,024 and 2,048, N = 4,096 are bound by operations, K = 240 by bytes.
// The design keeps the tensor cores fed:
//   - output tiles of 128 x 256, K in steps of 64 (128 bytes of bf16, one
//     row of the 128-byte swizzle); a ring of 4 stages, each an A tile
//     (16 KB) and a B^T tile (32 KB), loaded by TMA from one thread of a
//     producer warp and tracked by mbarriers (full: the stage's bytes have
//     landed; empty: both consumers are done with it);
//   - two consumer warpgroups, 64 rows x 256 columns each: wgmma
//     m64n256k16 reads both operands from shared memory and keeps 128 f32
//     sums a thread in registers;
//   - one persistent block per SM walking the tiles in N-major order (the
//     blocks in flight share A's rows and all of B in L2); the producer runs
//     ahead into the next tile while the consumers store this one.
// TMA fills rows past M or N and columns past K with zeros (K = 240 is no
// multiple of 64); the epilogue stores only rows < M and columns < N.  The
// epilogue uses the _rn intrinsics (the file is built with --fmad=false), so
// only the summation order differs from the twin's f32 product.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;  // tile rows: CONSUMERS x 64
constexpr int BN = 256;  // tile columns: one m64n256k16 a warpgroup
constexpr int BK = 64;   // k of a stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS_E = 128 * CONSUMERS + 32;  // + the producer warp
constexpr int A_TILE = BM * BK * 2;
constexpr int B_TILE = BN * BK * 2;
constexpr int STAGE_BYTES = A_TILE + B_TILE;
// the ring, its 2 x STAGES barriers, and slack to align the ring to 1,024
// bytes (the swizzle's period, which the wgmma descriptors assume)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

struct Params {
  const float* bias;  // (N) f32, or null
  void* out;          // (M, N) bf16 or f32
  int M, N, K;
};

// d (64 x 256, f32) += A (64 x 16) . B (16 x 256), both K-major bf16 in
// shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// columns c, c + 1 of one output row (c even); pairs: N even, so c + 1 < N
// whenever c < N and the pair is aligned for one store
template <bool BF16_OUT>
__device__ __forceinline__ void store_pair(void* out, size_t off, float v0, float v1, int c, int N,
                                           bool pairs) {
  if (BF16_OUT) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + off;
    if (pairs) {
      if (c < N) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (c < N) o[0] = __float2bfloat16_rn(v0);
      if (c + 1 < N) o[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* o = static_cast<float*>(out) + off;
    if (pairs) {
      if (c < N) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      if (c < N) o[0] = v0;
      if (c + 1 < N) o[1] = v1;
    }
  }
}

// lanes 4 g + q (q = 0..3) hold v[e] = element (q, e) of a 4 x 4 block of
// 32-bit values; afterwards lane q holds element (e, q) in v[e]: two rounds
// of exchanges across lane bits 0 and 1, indices fixed at compile time
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int k = 1; k <= 2; k <<= 1) {
    const bool hi = q & k;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e & k) continue;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? v[e] : v[e | k], k);
      if (hi) v[e] = got;
      else v[e | k] = got;
    }
  }
}

template <bool BF16_OUT>
__global__ void __launch_bounds__(THREADS_E, 1)
    projection(__grid_constant__ const CUtensorMap map_a, __grid_constant__ const CUtensorMap map_b,
               const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int M = p.M, N = p.N;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (p.K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);  // the first round passes at once
          uint8_t* st = ring + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load(st, &map_a, &full[s], kb * BK, m0);
          tma_load(st + A_TILE, &map_b, &full[s], kb * BK, n0);
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg * 64 .. + 63 of each tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, q = lane % 4;
  float d[128];
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int held = -1;  // the stage whose products may still be running
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], phase);
      const uint8_t* st = ring + s * STAGE_BYTES;
      const uint64_t da = smem_desc(st + wg * 64 * BK * 2), db = smem_desc(st + A_TILE);
      fence_sums(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 32 bytes further along the swizzled rows
        wgmma_m64n256k16(d, da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done once at most this group runs
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_sums(d);
      if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
      held = s;
      if (++s == STAGES) s = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_sums(d);
    if (t == 0) mbar_arrive(&empty[held]);
    // sum 4 j + 2 h + e sits at row 16 warp + lane / 4 + 8 h, column
    // 8 j + 2 q + e of the warpgroup's 64 x 256
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    if (BF16_OUT && N % 8 == 0) {
      // each thread of a quad holds 2 of 8 adjacent columns; they trade
      // (quad_transpose) so that each stores 8 of one row: 16 bytes
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 4) {
        float2 bias[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n0 + 8 * (j0 + e) + 2 * q;
          bias[e] = c < N ? *reinterpret_cast<const float2*>(p.bias + c) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * (j0 + e) + 2 * h;
            const __nv_bfloat162 b2 = __floats2bfloat162_rn(__fadd_rn(d[i], bias[e].x),
                                                            __fadd_rn(d[i + 1], bias[e].y));
            v[e] = *reinterpret_cast<const uint32_t*>(&b2);
          }
          quad_transpose(v, q);
          const int r = r0 + 8 * h, c = n0 + 8 * (j0 + q);
          if (r < M && c < N)
            *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) +
                                      static_cast<size_t>(r) * N + c) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    } else {
      const int c0 = n0 + 2 * q;
      const bool pairs = N % 2 == 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j;
        float b0 = 0.0f, b1 = 0.0f;
        if (p.bias) {
          if (c < N) b0 = p.bias[c];
          if (c + 1 < N) b1 = p.bias[c + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= M) continue;
          float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
          if (p.bias) v0 = __fadd_rn(v0, b0), v1 = __fadd_rn(v1, b1);
          store_pair<BF16_OUT>(p.out, static_cast<size_t>(r) * N + c, v0, v1, c, N, pairs);
        }
      }
    }
  }
}

template <bool BF16_OUT>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const Params& p, int sms,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(projection<BF16_OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = (p.M + BM - 1) / BM * ((p.N + BN - 1) / BN);
  projection<BF16_OUT><<<tiles < sms ? tiles : sms, THREADS_E, SMEM_BYTES, stream>>>(map_a, map_b,
                                                                                      p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = a (M, K) . wt (N, K)^T on `stream`, one launch of up to `sms`
// blocks.  out_bf16 1: out (M, N) bf16 = round(sum + bias), bias (N) f32
// required (epilogue a); 0: out (M, N) f32 = sum (+ bias if not null)
// (epilogue b).  K a multiple of 8 and a, wt on 16-byte boundaries (TMA's
// row strides and addresses).  Returns 0, or the CUDA error (an encoder
// that is missing or refuses the maps: cudaErrorSharedObjectSymbolNotFound
// or cudaErrorInvalidValue).
int rnnt_projection(const void* a, const void* wt, const void* bias, void* out, int M, int N, int K,
                    int out_bf16, int sms, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || sms <= 0 || (out_bf16 && !bias) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(wt)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_b;
  if (!encode_rows(fn, &map_a, a, M, K, BM, BF16, 2) ||
      !encode_rows(fn, &map_b, wt, N, K, BN, BF16, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(bias), out, M, N, K};
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_bf16 ? launch<true>(map_a, map_b, p, sms, s)
                                   : launch<false>(map_a, map_b, p, sms, s));
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
