// Kernel B: the greedy transducer symbol loop, up to `steps` iterations in
// one persistent cooperative launch, for Hopper (sm_90a).
//
// Replaces rnnt_inference_tpu/ops/decode_pallas.py::_decode_step_kernel
// (reached through decode_step_pallas) and folds in the two ops the JAX
// package runs around it: the per-lane gather of the hoisted joint
// projection fproj[time_idx] and the token write res[lane, write_idx]
// (writes at write_idx >= R are dropped).  One iteration, per lane:
//   y      = embed[pre_g]                 (SOS, or any index outside the
//                                          table, embeds to zeros)
//   layer l of the prediction LSTM:
//     gates = (y.W_ih[l] + b[l]) + h[l].W_hh[l];  i,f,g,o;  f32 cell
//     y     = h' rounded to the weight type
//   z      = relu(fproj[time] + y.W1p + b1) rounded to the weight type
//   logits = z.W2 + b2;  symbol = first argmax
//   update_g / update_f lane algebra (decoder.py), then h/c of every layer
//   committed only where update_g.
// The lane state lives in one (8, N) int32 array, updated in place:
//   0 pre_g, 1 time_idx, 2 symbols_added, 3 res_idx, 4 finish,
//   5 f_lens, 6 eos_idx (both read only), 7 symbol (output).
//
// Packed mode (a second instantiation; the bucketed one does none of this
// work): each lane's timeline holds several utterances back to back, and
// starts (T2, N) marks the frame each begins at (decoder.py
// greedy_decode_chunk_packed).  A lane that advances into a start frame
// "enters" a new utterance: its pre_g becomes SOS, its committed h, c and
// h.W_hh read as zero from the next iteration on, res_idx moves one on and
// a PACK_BOUNDARY (-2) is written there, and rb (N), the marker position of
// the lane's current utterance, becomes res_idx.  An emission advances
// res_idx and writes only while res_idx < rb + budget (budget 0: no gate);
// over budget it still commits pre_g, h and c.  Each lane writes at most
// once per iteration, a token or a marker.  The owner of a lane records
// update_g in upd as 0 or 1, and an entering lane as 2 (ENTERED): the
// phases read it where they choose between the committed state and the
// new one, and take zeros for 2.
//
// What bounds it on an H100: the weights are small (3.6 MB in bf16 at
// P = 320, J = 512; 7.2 MB in f32) and the work per iteration is a few
// MFLOP, but the iterations are serial and each is a chain of dependent
// products.  So an iteration costs (1) its grid barriers (one after each
// phase, four, about 1.1 us each measured), (2) every working block
// reading the phase's lane inputs from L2 right after a barrier (all N
// lanes' h: N P WT bytes, 40 KB in bf16 at N = 64), and (3) the latency of
// each phase's products and epilogue; the host's check of finish.all()
// comes once per launch.
//
// Design (two prediction layers): the prediction net's gate columns and
// the joint's W1p columns are split over the grid, and each block keeps its
// slices in shared memory for every iteration of the launch: block b owns
// UP units of each prediction layer with all four gates of each (so the
// cell update stays in the block) and UJ = 8 columns of W1p; at P = 320,
// UP = 4: 80 blocks.  The products are arranged so that no phase waits for
// a product it could have done earlier:
//   - layer 0's y is an embedding row, so y.W_ih[0] + b[0] is a row of a
//     table the host computes once (V x 4P, f32, kept in shared memory);
//   - h.W_hh of a layer is computed when h is made, where its h' is staged
//     anyway (layer 0's in layer 1's pass, layer 1's in the joint's pass),
//     into `spec`; the next iteration takes spec where the lane emitted
//     and the `keep` of the committed h (the launch's first h.W_hh comes
//     from one pass over hg at its start) where it did not.
// One iteration is four phases with a grid barrier after each:
//   1. layer 0: gates = table[pre_g] + h.W_hh[0] and the cell, no product;
//   2. layer 1: a pass over y = layer 0's h' against [W_ih[1] | W_hh[0]]:
//      layer 1's gates and cell, and spec of layer 0;
//   3. joint: a pass over y = layer 1's h' against [W1p | W_hh[1]]: z for
//      the block's 8 columns and spec of layer 1;
//   4. per lane tile (16 bf16 / 32 f32 lanes, tiles over the blocks):
//      z.W2 + b2, the first argmax (one warp per lane, one label per
//      thread), the lane algebra, the token write, update_g, and a count
//      that stays 0 once every lane has finished.
// A pass (csrc/hopper.cuh pass_products) covers up to 128 (bf16) or 64
// (f32) lanes: the lanes' inputs copied with cp.async in chunks as wide as
// the shared memory left over allows, the warps spread over the lanes or
// over K, the cell updates on the sums in registers.  W2 stays in shared
// memory in bf16; in f32 it is read from L2.
// New h/c are not committed in place: h' of iteration i goes to hn[i % 2]
// (the next phase's input), and the committed h of its start to hc[i % 2];
// the committed h of the next iteration is update_g ? hn : hc, which only
// the unit's owner reads; c and c' never leave the owner's shared memory.
// After the last barrier of an iteration every block reads the count of
// unfinished lanes and all leave together when it is 0; then each owner
// commits h/c of its units to hg/cg.  Every update is finish-gated, so the
// tokens are the same whether the launch stops early or runs all its
// iterations.  Data written by another block is read through L2 only
// (cp.async.cg, __ldcg), never from a stale L1 line.
//
// Products: bf16 on the tensor cores (mma.sync m16n8k16, lanes as M padded
// to 16, f32 sums; bf16 products are exact in f32), f32 as FMA on the CUDA
// cores (no TF32), four lane rows per thread.  Where warps split a
// product's input axis, their partial sums are added in a fixed order, so
// the sums do not depend on scheduling; the plain twin (ops/decode_cuda.py
// decode_step_reference) sums in the matmul library's order, so the two
// differ by f32 rounding (chip_smoke.py states the tolerance).  The f32 epilogues use the _rn
// intrinsics and the file is built with --fmad=false.
//
// A second kernel in this file, decode_loop_wide (its own section below),
// runs a one-layer prediction net over any number of labels (the
// Conformer-Transducer's 1,025) with W2's label columns split over the grid.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int UJ = 8;   // joint columns per block
constexpr int VP = 32;  // labels, padded: W2's columns in the operand
constexpr int ENTERED = 2;  // upd of a lane that entered an utterance (packed mode)
constexpr int PACK_BOUNDARY = -2;
enum { PRE_G = 0, TIME, SYMADD, RES_IDX, FINISH, F_LENS, EOS, SYMBOL };

struct Args {
  const float* fproj;  // (T2, N, J)
  int* lanes;          // (8, N)
  void* hg;            // (2, N, P) WT
  float* cg;           // (2, N, P)
  int8_t* res;         // (N, R)
  const void* whh;     // per block < P / UP: (2, P, 4UP) W_hh columns per layer
  const void* w1;      // per block < P / UP: (P, 8UP) y.[W_ih[1] | W_hh[0]] columns
  const void* w2;      // per block: (P, UJ + 4UP) y.[W1p | W_hh[1]] columns
  const float* b;      // (2, 4P)
  const float* b1;     // (J)
  const void* wout;    // W2 (J, VP), kernel order
  const float* b2;     // (V)
  const float* eproj;  // per block < P / UP: (V, UP, 4) embed.W_ih[0] + b[0], row V-1 = b[0]
  float* keep;         // per block: (2, N, UP, 4) h.W_hh of the committed h
  float* spec;         // per block: (2, N, UP, 4) h'.W_hh of an iteration's new h
  void* hn;            // (2, 2, N, P) WT: h' of an iteration
  void* hc;            // (2, 2, N, P) WT: committed h at an iteration's start
  void* z;             // (N, J) WT
  int* upd;            // (2, N) update_g of an iteration
  int* alive;          // (2) nonzero while a lane is unfinished after an iteration
  const unsigned char* starts;  // packed mode: (T2, N) 1 at an utterance's first frame
  int* rb;                      // packed mode: (N) marker position of the current utterance
  int steps, N, P, J, V, R, blank, sos, max_sym;
  int budget;  // packed mode: tokens per utterance, 0 = no gate
  int ring_cap;  // elements of the staging ring
};

// What both instantiations (decode_loop, decode_loop_wide) share.

// The LSTM cell of one unit from its gates (i, f, g, o) and the committed c
// it starts from: c' into cn, and h' (f32, before its rounding).
__device__ __forceinline__ float lstm_cell(const float (&gate)[4], float cprev, float& cn) {
  const float ig = sigmoid_f(gate[0]);
  const float fg = sigmoid_f(gate[1]);
  const float gg = tanhf(gate[2]);
  const float og = sigmoid_f(gate[3]);
  cn = __fadd_rn(__fmul_rn(fg, cprev), __fmul_rn(ig, gg));
  return __fmul_rn(og, tanhf(cn));
}

// (best, arg) becomes (ob, oa) where that is larger, or equal with a lower
// label: the first maximum
__device__ __forceinline__ void take_first_max(float& best, int& arg, float ob, int oa) {
  if (ob > best || (ob == best && oa < arg)) {
    best = ob;
    arg = oa;
  }
}

// the first maximum over the warp's 32 lanes, in every lane
__device__ __forceinline__ void warp_first_max(float& best, int& arg) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    take_first_max(best, arg, ob, oa);
  }
}

// The lane algebra of one iteration for lane n, which chose `sym`: from
// its lane row as the iteration found it (finish, symadd, res_idx, f_lens
// fl, eos eo; time and pre_g as staged in shared memory), the greedy rule
// (emit, or advance a frame; at most max_sym symbols a frame), packed
// mode's budget gate and its entry into an utterance (pre_g to SOS and a
// PACK_BOUNDARY marker), then the new lane row, the token write (TT: the
// token buffer's type) and update_g.  Returns 1 while the lane is
// unfinished.  A: either kernel's arguments.
template <bool PACKED, typename TT, typename A>
__device__ __forceinline__ int lane_step(const A& a, TT* res, int n, int p, int sym, bool finish,
                                         int symadd, int res_idx, int fl, int eo, int time_n,
                                         int pre_n) {
  const int N = a.N;
  const bool update_g = sym != a.blank && symadd != a.max_sym && !finish;
  // packed mode: an emission past the utterance's budget keeps the
  // dynamics but neither writes nor advances res_idx
  const bool adv = update_g && (!PACKED || a.budget == 0 ||
                                res_idx < __ldcg(a.rb + n) + a.budget);
  res_idx += adv;
  int write_idx = adv ? res_idx : a.R, val = sym, pre = update_g ? sym : pre_n;
  symadd += update_g;
  const bool update_f = !update_g && !finish;
  int t = time_n + update_f;
  const bool new_finish = finish || t >= fl;
  t = min(t, eo);
  if (update_f) symadd = 0;
  bool entering = false;
  if constexpr (PACKED) {  // advanced into the first frame of an utterance
    entering = update_f && !new_finish && t > time_n &&
               __ldg(a.starts + (size_t)t * N + n) != 0;
    if (entering) {
      pre = a.sos;
      write_idx = ++res_idx;
      val = PACK_BOUNDARY;
      a.rb[n] = res_idx;
    }
  }
  int* ln = a.lanes + n;
  ln[PRE_G * N] = pre;
  ln[TIME * N] = t;
  ln[SYMADD * N] = symadd;
  ln[RES_IDX * N] = res_idx;
  ln[FINISH * N] = new_finish;
  ln[SYMBOL * N] = sym;
  if (write_idx >= 0 && write_idx < a.R) res[(size_t)n * a.R + write_idx] = (TT)val;
  a.upd[p * N + n] = entering ? ENTERED : update_g;
  return !new_finish;
}

template <typename WT, int UP, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1) decode_loop(Args a) {
  constexpr int MT = Rows<WT>::MT, RMAX = Rows<WT>::RMAX, SLOTS = UP / 4;
  constexpr int NC1 = 8 * UP, NC2 = UJ + 4 * UP;  // layer 1's and the joint's columns
  constexpr bool BF16 = sizeof(WT) == 2;
  constexpr int RPT = MT / 8;  // lane rows a thread finishes in a pass: m-tile rows g8 + 8 r
  const int N = a.N, P = a.P, J = a.J, V = a.V;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, b = blockIdx.x;
  const int nbp = P / UP, nbj = J / UJ;
  const size_t LNP = (size_t)2 * N * P;
  const WT* hg = static_cast<const WT*>(a.hg);
  WT* hn = static_cast<WT*>(a.hn);
  WT* hc = static_cast<WT*>(a.hc);
  WT* z = static_cast<WT*>(a.z);
  float* keep = a.keep + (size_t)b * 2 * N * UP * 4;
  float* spec = a.spec + (size_t)b * 2 * N * UP * 4;
  const int pcol0 = b * UP;  // the block's first prediction unit

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t w1_bytes = (size_t)P * NC1 * sizeof(WT), w2_bytes = (size_t)P * NC2 * sizeof(WT);
  WT* w1_s = reinterpret_cast<WT*>(smem);
  WT* w2_s = reinterpret_cast<WT*>(smem + w1_bytes);
  // bf16: W2 (fragments, J VP 2 bytes) in shared memory too; f32 reads it
  // from L2 (its 64 KB would not leave room for the ring at N = 1024)
  const size_t wo_bytes = BF16 ? (size_t)J * VP * sizeof(WT) : 0;
  WT* wo_s = reinterpret_cast<WT*>(smem + w1_bytes + w2_bytes);
  const void* wout = BF16 ? static_cast<const void*>(wo_s) : a.wout;
  float* lg = reinterpret_cast<float*>(smem + w1_bytes + w2_bytes + wo_bytes);  // (MT, VP)
  float* e_s = lg + MT * VP;                            // (V, UP, 4) layer 0's input gates
  float* c_s = e_s + V * UP * 4;                        // (2, N, UP) committed
  float* cn_s = c_s + 2 * N * UP;                       // (2, N, UP) candidate
  const int Np = (N + 3) & ~3;                          // 16-byte rows
  int* pre_s = reinterpret_cast<int*>(cn_s + 2 * N * UP);  // (N) pre_g
  int* time_s = pre_s + Np;                             // (N) time_idx
  int* updp_s = time_s + Np;                            // (N) previous update_g
  WT* ring = reinterpret_cast<WT*>(updp_s + Np);        // a.ring_cap elements

  // the block's weight slices and c, for the whole launch
  if (b < nbp) {
    const uint4* src =
        reinterpret_cast<const uint4*>(static_cast<const char*>(a.w1) + b * w1_bytes);
    for (int i = tid; i < (int)(w1_bytes / 16); i += THREADS)
      reinterpret_cast<uint4*>(w1_s)[i] = src[i];
    for (int i = tid; i < 2 * N * UP; i += THREADS) {
      const int u = i % UP, ln = i / UP;  // ln = l N + n
      c_s[i] = a.cg[(size_t)ln * P + pcol0 + u];
    }
    for (int i = tid; i < V * UP * 4; i += THREADS) e_s[i] = a.eproj[(size_t)b * V * UP * 4 + i];
  }
  {
    const uint4* src =
        reinterpret_cast<const uint4*>(static_cast<const char*>(a.w2) + b * w2_bytes);
    for (int i = tid; i < (int)(w2_bytes / 16); i += THREADS)
      reinterpret_cast<uint4*>(w2_s)[i] = src[i];
    for (int i = tid; i < (int)(wo_bytes / 16); i += THREADS)
      reinterpret_cast<uint4*>(wo_s)[i] = static_cast<const uint4*>(a.wout)[i];
  }

  // a thread's share of a pass's epilogue: lane rows row(r) of its m-tile;
  // its units: bf16 4 i + q4 (n-tiles 2i, 2i + 1), f32 q4 SLOTS + i
  const int g8 = lane >> 2, q4 = lane & 3;
  auto row = [&](int mt, int r) { return mt * MT + g8 + 8 * r; };

  // h.W_hh of the launch's starting state, once: the first iteration's keep
  if (b < nbp) {
    for (int l = 0; l < 2; ++l)
      for (int p0 = 0; p0 < N; p0 += RMAX) {
        const int rows = min(RMAX, N - p0);
        const int WM = pass_wm(rows, MT), mt = warp % WM, kg = warp / WM;
        PassAcc<WT, 4 * UP> acc;
        pass_products<WT, 4 * UP>(
            static_cast<const WT*>(a.whh) + (size_t)(b * 2 + l) * P * 4 * UP, P, rows,
            ring, a.ring_cap, a.lanes, [&](int r) { return hg + ((size_t)l * N + p0 + r) * P; },
            acc);
        if (kg != 0) continue;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int n = p0 + row(mt, r);
          if (n >= N) continue;
#pragma unroll
          for (int i = 0; i < SLOTS; ++i) {
            const int u = BF16 ? 4 * i + q4 : q4 * SLOTS + i;
            float* kp = keep + (((size_t)l * N + n) * UP + u) * 4;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              kp[g] = BF16 ? (&acc.v[0][0])[(2 * i + g / 2) * 4 + 2 * r + g % 2]
                           : (&acc.v[0][0])[r * UP + 4 * i + g];
          }
        }
      }
  }
  __syncthreads();

  // the gates' h.W_hh of (layer l, lane n, unit u) at the iteration's start:
  // spec (h' of the last iteration) where it emitted, zero where it entered
  // an utterance, else keep; hh_keep makes it the new keep
  auto entered = [&](int n, int it) { return PACKED && it > 0 && updp_s[n] == ENTERED; };
  auto hh_load = [&](int l, int n, int u, int it, float (&hh)[4]) {
    if (entered(n, it)) {
      hh[0] = hh[1] = hh[2] = hh[3] = 0.0f;
      return;
    }
    const size_t o = (((size_t)l * N + n) * UP + u) * 4;
    const float4 v = __ldcg(reinterpret_cast<const float4*>((it > 0 && updp_s[n] ? spec : keep) + o));
    hh[0] = v.x; hh[1] = v.y; hh[2] = v.z; hh[3] = v.w;
  };
  auto hh_keep = [&](int l, int n, int u, int it, const float (&hh)[4]) {
    if (it > 0 && updp_s[n])
      *reinterpret_cast<float4*>(keep + (((size_t)l * N + n) * UP + u) * 4) =
          make_float4(hh[0], hh[1], hh[2], hh[3]);
  };
  // the cell of (layer l, lane n, unit u): commits c' where the last
  // iteration emitted (zero where it entered), writes h' and the committed
  // h it started from
  auto cell = [&](int l, int n, int u, int it, const float (&gate)[4], WT hold) {
    const size_t off = (size_t)(it & 1) * LNP + ((size_t)l * N + n) * P + pcol0 + u;
    hc[off] = hold;
    const int ci = (l * N + n) * UP + u;
    const float cprev = entered(n, it) ? 0.0f : it > 0 && updp_s[n] ? cn_s[ci] : c_s[ci];
    c_s[ci] = cprev;
    hn[off] = store_as<WT>(lstm_cell(gate, cprev, cn_s[ci]));
  };

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int it = 0;
  for (;; ++it) {
    const int p = it & 1;
    const WT* hn_prev = hn + (size_t)(p ^ 1) * LNP;
    const WT* hc_prev = hc + (size_t)(p ^ 1) * LNP;
    WT* hn_cur = hn + (size_t)p * LNP;
    // the committed h of (layer l, lane n, unit u) at the iteration's start
    auto h_at = [&](int l, int n, int u) {
      const size_t off = ((size_t)l * N + n) * P + pcol0 + u;
      return it == 0         ? hg[off]
             : entered(n, it) ? store_as<WT>(0.0f)
             : updp_s[n]      ? hn_prev[off]
                              : hc_prev[off];
    };
    if (b == 0 && tid == 0) a.alive[p] = 0;  // last read two barriers ago
    for (int n = tid; n < N; n += THREADS) {
      pre_s[n] = __ldcg(a.lanes + PRE_G * N + n);
      time_s[n] = __ldcg(a.lanes + TIME * N + n);
      updp_s[n] = it > 0 ? __ldcg(a.upd + (p ^ 1) * N + n) : 0;
    }
    __syncthreads();

    // phase 1: layer 0.  Its y is an embedding row, so y.W_ih[0] + b[0] is a
    // row of the table e_s, and h.W_hh[0] was computed when h was (keep /
    // spec): no product here.
    if (b < nbp) {
      for (int i = tid; i < N * UP; i += THREADS) {
        const int n = i / UP, u = i - n * UP;
        float hh[4];
        hh_load(0, n, u, it, hh);
        hh_keep(0, n, u, it, hh);
        const int pg = pre_s[n];
        const float* e = e_s + ((pg != a.sos && pg >= 0 && pg < V - 1 ? pg : V - 1) * UP + u) * 4;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = __fadd_rn(e[g], hh[g]);
        cell(0, n, u, it, gate, h_at(0, n, u));
      }
    }
    grid.sync();

    // phase 2: layer 1 on y = layer 0's h', and y.W_hh[0] for the next
    // iteration (spec of layer 0), in passes over [W_ih[1] | W_hh[0]]
    if (b < nbp) {
      const float* bl = a.b + 4 * P;
      for (int p0 = 0; p0 < N; p0 += RMAX) {
        const int rows = min(RMAX, N - p0);
        const int WM = pass_wm(rows, MT), mt = warp % WM, kg = warp / WM;
        // the thread's units of [layer 1 | layer 0]: v < UP is layer 1's
        auto unit1 = [&](int i) { return BF16 ? 4 * i + q4 : q4 * 2 * SLOTS + i; };
        float bias[2 * SLOTS][4], hh[RPT][2 * SLOTS][4];  // layer 1's, loaded ahead
        WT hold[RPT][2 * SLOTS];
        if (kg == 0) {
#pragma unroll
          for (int i = 0; i < 2 * SLOTS; ++i) {
            const int v = unit1(i);
            if (v >= UP) continue;
#pragma unroll
            for (int g = 0; g < 4; ++g) bias[i][g] = __ldg(bl + g * P + pcol0 + v);
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const int n = min(p0 + row(mt, r), N - 1);
              hh_load(1, n, v, it, hh[r][i]);
              hold[r][i] = h_at(1, n, v);
            }
          }
        }
        PassAcc<WT, NC1> acc;
        pass_products<WT, NC1>(
            w1_s, P, rows, ring, a.ring_cap, a.lanes,
            [&](int r) { return hn_cur + ((size_t)p0 + r) * P; }, acc);
        if (kg != 0) continue;
        const float* flat = &acc.v[0][0];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int n = p0 + row(mt, r);
          if (n >= N) continue;
#pragma unroll
          for (int i = 0; i < 2 * SLOTS; ++i) {
            const int v = unit1(i);
            float s[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              s[g] = BF16 ? flat[(2 * i + g / 2) * 4 + 2 * r + g % 2]
                          : flat[r * NC1 / 4 + 4 * i + g];
            if (v < UP) {
              float gate[4];
              hh_keep(1, n, v, it, hh[r][i]);
#pragma unroll
              for (int g = 0; g < 4; ++g)
                gate[g] = __fadd_rn(__fadd_rn(s[g], bias[i][g]), hh[r][i][g]);
              cell(1, n, v, it, gate, hold[r][i]);
            } else {
              float* sp = spec + ((size_t)n * UP + v - UP) * 4;  // layer 0
              *reinterpret_cast<float4*>(sp) = make_float4(s[0], s[1], s[2], s[3]);
            }
          }
        }
      }
    }
    grid.sync();

    // phase 3: the joint's hidden layer, UJ columns per block, and y.W_hh[1]
    // for the next iteration (spec of layer 1), y = layer 1's h'
    {
      const WT* y = hn_cur + (size_t)N * P;
      const int jc0 = b * UJ;
      for (int p0 = 0; p0 < N; p0 += RMAX) {
        const int rows = min(RMAX, N - p0);
        const int WM = pass_wm(rows, MT), mt = warp % WM, kg = warp / WM;
        float fb[RPT][2];  // fproj[time], loaded ahead
        if (kg == 0 && b < nbj) {
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const int n = min(p0 + row(mt, r), N - 1);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              fb[r][e] = __ldg(a.fproj + ((size_t)time_s[n] * N + n) * J + jc0 + 2 * q4 + e);
          }
        }
        PassAcc<WT, NC2> acc;
        pass_products<WT, NC2>(
            w2_s, P, rows, ring, a.ring_cap, a.lanes,
            [&](int r) { return y + ((size_t)p0 + r) * P; }, acc);
        if (kg != 0) continue;
        const float* flat = &acc.v[0][0];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int n = p0 + row(mt, r);
          if (n >= N) continue;
          if (b < nbj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float sum = BF16 ? flat[2 * r + e] : flat[r * NC2 / 4 + e];
              const int jc = jc0 + 2 * q4 + e;
              const float v = __fadd_rn(__fadd_rn(fb[r][e], sum), __ldg(a.b1 + jc));
              z[(size_t)n * J + jc] = store_as<WT>(fmaxf(v, 0.0f));
            }
          }
          if (b < nbp) {
#pragma unroll
            for (int i = 0; i < SLOTS; ++i) {
              const int u = BF16 ? 4 * i + q4 : q4 * SLOTS + i;
              float s[4];
#pragma unroll
              for (int g = 0; g < 4; ++g)
                s[g] = BF16 ? flat[(1 + 2 * i + g / 2) * 4 + 2 * r + g % 2]
                            : flat[r * NC2 / 4 + 2 + 4 * i + g];
              float* sp = spec + (((size_t)N + n) * UP + u) * 4;  // layer 1
              *reinterpret_cast<float4*>(sp) = make_float4(s[0], s[1], s[2], s[3]);
            }
          }
        }
      }
    }
    grid.sync();

    // phase 4: z.W2 + b2, first argmax and the lane algebra; lane tiles
    // of MT over the blocks, one pass each (all warps split K = J); then
    // warp w takes the tile's rows w, w + 8, ..., one label per lane
    for (int n0 = b * MT; n0 < N; n0 += gridDim.x * MT) {
      const int rows = min(MT, N - n0);
      int fin[RPT], sad[RPT], rix[RPT], fl[RPT], eo[RPT];
      if (lane == 0) {  // the rows' fields, ahead of the products
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int* ln = a.lanes + min(n0 + warp + 8 * r, N - 1);
          fin[r] = __ldcg(ln + FINISH * N);
          sad[r] = __ldcg(ln + SYMADD * N);
          rix[r] = __ldcg(ln + RES_IDX * N);
          fl[r] = __ldcg(ln + F_LENS * N);
          eo[r] = __ldcg(ln + EOS * N);
        }
      }
      PassAcc<WT, VP> acc;
      pass_products<WT, VP>(
          wout, J, rows, ring, a.ring_cap, a.lanes,
          [&](int r) { return z + (size_t)(n0 + r) * J; }, acc);
      if (warp == 0) {  // the one m-tile's sums: logits to shared memory
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int m = g8 + 8 * r;
          if constexpr (BF16) {
#pragma unroll
            for (int j = 0; j < VP / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int v = 8 * j + 2 * q4 + e;
                if (v < V) lg[m * VP + v] = __fadd_rn(acc.v[j][2 * r + e], a.b2[v]);
              }
          } else {
#pragma unroll
            for (int c = 0; c < VP / 4; ++c) {
              const int v = q4 * (VP / 4) + c;
              if (v < V) lg[m * VP + v] = __fadd_rn(acc.v[r][c], a.b2[v]);
            }
          }
        }
      }
      __syncthreads();
      int unfinished = 0;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int m = warp + 8 * r, n = n0 + m;
        if (m >= rows) break;
        float best = lane < V ? lg[m * VP + lane] : -INFINITY;
        int sym = lane;
        warp_first_max(best, sym);
        if (lane == 0)
          unfinished += lane_step<PACKED>(a, a.res, n, p, sym, fin[r] != 0, sad[r], rix[r], fl[r],
                                          eo[r], time_s[n], pre_s[n]);
      }
      const int count = __syncthreads_count(unfinished);  // lg is free again, too
      if (tid == 0 && count) atomicAdd(a.alive + p, count);
    }
    grid.sync();
    if (it + 1 >= a.steps || __ldcg(a.alive + p) == 0) break;  // the same for every block
  }

  // commit h/c of the block's units: h' and c' where the last iteration
  // emitted, zeros where it entered an utterance, else the state it
  // started from
  if (b < nbp) {
    const int p = it & 1;
    WT* hgw = static_cast<WT*>(a.hg);
    for (int i = tid; i < 2 * N * UP; i += THREADS) {
      const int u = i % UP, ln = i / UP, n = ln % N;
      const size_t off = (size_t)ln * P + pcol0 + u;
      const int upd = __ldcg(a.upd + p * N + n);
      const bool zero = PACKED && upd == ENTERED;
      // the block's own writes
      hgw[off] = zero ? store_as<WT>(0.0f) : ((upd ? hn : hc) + (size_t)p * LNP)[off];
      a.cg[off] = zero ? 0.0f : upd ? cn_s[i] : c_s[i];
    }
  }
}

template <typename WT, int UP, bool PACKED>
cudaError_t launch(Args a, cudaStream_t stream) {
  // the staging ring takes what the block's other arrays leave
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t es = sizeof(WT);
  const size_t fixed = (size_t)a.P * (8 * UP + UJ + 4 * UP) * es +
                       (es == 2 ? (size_t)a.J * VP * es : 0) +
                       (size_t)(Rows<WT>::MT * VP + a.V * UP * 4) * 4 +
                       (size_t)4 * a.N * UP * 4 + (size_t)3 * ((a.N + 3) & ~3) * 4;
  if (fixed + (size_t)ring_min<WT>() * es > (size_t)limit) return cudaErrorInvalidValue;
  a.ring_cap = (int)(((size_t)limit - fixed) / es) & ~7;
  const size_t smem = fixed + (size_t)a.ring_cap * es;
  auto kern = decode_loop<WT, UP, PACKED>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nbp = a.P / UP, nbj = a.J / UJ;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(nbp > nbj ? nbp : nbj), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide-vocabulary instantiation (decode_loop_wide): one prediction
// layer, any number of labels V (the Conformer-Transducer's 1,025), bf16
// weights.  W2 (J x V) no longer fits one block's shared memory, so its
// label columns are split over the grid, VB = 16 to a block, and the argmax
// becomes a grid-wide first maximum.  Block b owns UP = 8 units of the
// layer (P / 8 blocks: 80 at P = 640, within a one-block-per-SM grid, where
// UP = 4 would need 160), UJ = 8 joint columns and VB labels.  The layer's
// input product is eproj's row (read from L2: V x 4UP floats a block no
// longer fit beside W2's slice), and h.W_hh is made when h is, in the
// joint's pass, as layer 1's is above.  One iteration, a grid barrier after
// each phase:
//   1. the cell: gates = eproj[pre_g] + h.W_hh (keep or spec), h' and c';
//   2. a pass over y = h' against [W1p | W_hh]: z for the block's UJ
//      columns, and spec;
//   3. a pass over z against the block's VB columns of W2: each lane's
//      logits of those labels (+ b2) and their first maximum, to
//      best / arg (nbv, N);
//   4. a warp per lane: the first maximum over the nbv blocks' (lowest
//      label on a tie, so the first argmax over all V), then the lane
//      algebra, the token write (TT: int8 up to 127 labels, else int16),
//      update_g, and the count of unfinished lanes.
// The cell, the first maximum and the lane algebra (packed mode included)
// are the two-layer kernel's helpers; the commit and the finish-gating
// follow its code for one layer.

constexpr int UPW = 8;  // prediction units per block
constexpr int VB = 16;  // labels per block

struct WideArgs {
  const float* fproj;            // (T2, N, J)
  int* lanes;                    // (8, N)
  __nv_bfloat16* hg;             // (N, P)
  float* cg;                     // (N, P)
  void* res;                     // (N, R) TT
  const void* whh;               // per block < P / UP: (P, 4UP) W_hh columns, fragments
  const void* wj;                // per block < max(nbp, nbj): (P, UJ + 4UP) [W1p | W_hh]
  const float* b1;               // (J)
  const void* wout;              // per block < nbv: (J, VB) W2's columns, fragments
  const float* b2;               // (V)
  const float* eproj;            // per block < P / UP: (V, UP, 4), row V-1 = b
  float* keep;                   // per block: (N, UP, 4) h.W_hh of the committed h
  float* spec;                   // per block: (N, UP, 4) h'.W_hh
  __nv_bfloat16* hn;             // (2, N, P) h' of an iteration
  __nv_bfloat16* hc;             // (2, N, P) committed h at an iteration's start
  __nv_bfloat16* z;              // (N, J)
  float* best;                   // (nbv, N) each block's best logit of a lane
  int* arg;                      // (nbv, N) its label
  int* upd;                      // (2, N)
  int* alive;                    // (2)
  const unsigned char* starts;   // packed mode: (T2, N)
  int* rb;                       // packed mode: (N)
  int steps, N, P, J, V, R, blank, sos, max_sym, budget, ring_cap;
};

template <bool PACKED, typename TT>
__global__ void __launch_bounds__(THREADS, 1) decode_loop_wide(WideArgs a) {
  using WT = __nv_bfloat16;
  constexpr int UP = UPW, MT = Rows<WT>::MT, RMAX = Rows<WT>::RMAX, SLOTS = UP / 4;
  constexpr int NCJ = UJ + 4 * UP, RPT = MT / 8;
  const int N = a.N, P = a.P, J = a.J, V = a.V;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, b = blockIdx.x;
  const int nbp = P / UP, nbj = J / UJ, nbv = (V + VB - 1) / VB;
  const int nbjp = nbp > nbj ? nbp : nbj;
  const size_t NP = (size_t)N * P;
  float* keep = a.keep + (size_t)b * N * UP * 4;
  float* spec = a.spec + (size_t)b * N * UP * 4;
  const int pcol0 = b * UP;
  TT* res = static_cast<TT*>(a.res);

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t wj_bytes = (size_t)P * NCJ * sizeof(WT), wo_bytes = (size_t)J * VB * sizeof(WT);
  WT* wj_s = reinterpret_cast<WT*>(smem);
  WT* wo_s = reinterpret_cast<WT*>(smem + wj_bytes);
  float* c_s = reinterpret_cast<float*>(smem + wj_bytes + wo_bytes);  // (N, UP) committed c
  float* cn_s = c_s + N * UP;                                         // (N, UP) c'
  const int Np = (N + 3) & ~3;
  int* pre_s = reinterpret_cast<int*>(cn_s + N * UP);
  int* time_s = pre_s + Np;
  int* updp_s = time_s + Np;
  WT* ring = reinterpret_cast<WT*>(updp_s + Np);

  if (b < nbjp) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const char*>(a.wj) + b * wj_bytes);
    for (int i = tid; i < (int)(wj_bytes / 16); i += THREADS) reinterpret_cast<uint4*>(wj_s)[i] = src[i];
  }
  if (b < nbv) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const char*>(a.wout) + b * wo_bytes);
    for (int i = tid; i < (int)(wo_bytes / 16); i += THREADS) reinterpret_cast<uint4*>(wo_s)[i] = src[i];
  }
  if (b < nbp)
    for (int i = tid; i < N * UP; i += THREADS) c_s[i] = a.cg[(size_t)(i / UP) * P + pcol0 + i % UP];

  const int g8 = lane >> 2, q4 = lane & 3;
  auto row = [&](int mt, int r) { return mt * MT + g8 + 8 * r; };

  // h.W_hh of the launch's starting state, once: the first iteration's keep
  if (b < nbp) {
    for (int p0 = 0; p0 < N; p0 += RMAX) {
      const int rows = min(RMAX, N - p0);
      const int WM = pass_wm(rows, MT), mt = warp % WM, kg = warp / WM;
      PassAcc<WT, 4 * UP> acc;
      pass_products<WT, 4 * UP>(static_cast<const WT*>(a.whh) + (size_t)b * P * 4 * UP, P, rows,
                                ring, a.ring_cap, a.lanes,
                                [&](int r) { return a.hg + (size_t)(p0 + r) * P; }, acc);
      if (kg != 0) continue;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int n = p0 + row(mt, r);
        if (n >= N) continue;
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          float* kp = keep + ((size_t)n * UP + 4 * i + q4) * 4;
#pragma unroll
          for (int g = 0; g < 4; ++g) kp[g] = (&acc.v[0][0])[(2 * i + g / 2) * 4 + 2 * r + g % 2];
        }
      }
    }
  }
  __syncthreads();

  auto entered = [&](int n, int it) { return PACKED && it > 0 && updp_s[n] == ENTERED; };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int it = 0;
  for (;; ++it) {
    const int p = it & 1;
    const WT* hn_prev = a.hn + (size_t)(p ^ 1) * NP;
    const WT* hc_prev = a.hc + (size_t)(p ^ 1) * NP;
    WT* hn_cur = a.hn + (size_t)p * NP;
    if (b == 0 && tid == 0) a.alive[p] = 0;  // last read two barriers ago
    for (int n = tid; n < N; n += THREADS) {
      pre_s[n] = __ldcg(a.lanes + PRE_G * N + n);
      time_s[n] = __ldcg(a.lanes + TIME * N + n);
      updp_s[n] = it > 0 ? __ldcg(a.upd + (p ^ 1) * N + n) : 0;
    }
    __syncthreads();

    // phase 1: the cell.  gates = eproj[pre_g] + h.W_hh of the committed h:
    // spec where the last iteration emitted, zero where it entered an
    // utterance, else keep (which then becomes that value)
    if (b < nbp) {
      for (int i = tid; i < N * UP; i += THREADS) {
        const int n = i / UP, u = i - n * UP;
        float hh[4];
        if (entered(n, it)) {
          hh[0] = hh[1] = hh[2] = hh[3] = 0.0f;
        } else {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              (it > 0 && updp_s[n] ? spec : keep) + ((size_t)n * UP + u) * 4));
          hh[0] = v.x; hh[1] = v.y; hh[2] = v.z; hh[3] = v.w;
        }
        if (it > 0 && updp_s[n])
          *reinterpret_cast<float4*>(keep + ((size_t)n * UP + u) * 4) = make_float4(hh[0], hh[1], hh[2], hh[3]);
        const int pg = pre_s[n];
        const float4 e = __ldg(reinterpret_cast<const float4*>(
            a.eproj + (((size_t)b * V + (pg != a.sos && pg >= 0 && pg < V - 1 ? pg : V - 1)) * UP + u) * 4));
        const float gate[4] = {__fadd_rn(e.x, hh[0]), __fadd_rn(e.y, hh[1]), __fadd_rn(e.z, hh[2]),
                               __fadd_rn(e.w, hh[3])};
        const size_t off = (size_t)n * P + pcol0 + u;
        a.hc[(size_t)p * NP + off] = it == 0 ? a.hg[off]
                                     : entered(n, it) ? store_as<WT>(0.0f)
                                     : updp_s[n] ? hn_prev[off] : hc_prev[off];
        const float cprev = entered(n, it) ? 0.0f : it > 0 && updp_s[n] ? cn_s[i] : c_s[i];
        c_s[i] = cprev;
        hn_cur[off] = store_as<WT>(lstm_cell(gate, cprev, cn_s[i]));
      }
    }
    grid.sync();

    // phase 2: the joint's hidden layer, UJ columns per block, and h'.W_hh
    // for the next iteration (spec)
    if (b < nbjp) {
      const int jc0 = b * UJ;
      for (int p0 = 0; p0 < N; p0 += RMAX) {
        const int rows = min(RMAX, N - p0);
        const int WM = pass_wm(rows, MT), mt = warp % WM, kg = warp / WM;
        float fb[RPT][2];  // fproj[time], loaded ahead
        if (kg == 0 && b < nbj) {
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const int n = min(p0 + row(mt, r), N - 1);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              fb[r][e] = __ldg(a.fproj + ((size_t)time_s[n] * N + n) * J + jc0 + 2 * q4 + e);
          }
        }
        PassAcc<WT, NCJ> acc;
        pass_products<WT, NCJ>(wj_s, P, rows, ring, a.ring_cap, a.lanes,
                               [&](int r) { return hn_cur + (size_t)(p0 + r) * P; }, acc);
        if (kg != 0) continue;
        const float* flat = &acc.v[0][0];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int n = p0 + row(mt, r);
          if (n >= N) continue;
          if (b < nbj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jc = jc0 + 2 * q4 + e;
              const float v = __fadd_rn(__fadd_rn(fb[r][e], flat[2 * r + e]), __ldg(a.b1 + jc));
              a.z[(size_t)n * J + jc] = store_as<WT>(fmaxf(v, 0.0f));
            }
          }
          if (b < nbp) {
#pragma unroll
            for (int i = 0; i < SLOTS; ++i) {
              float s[4];
#pragma unroll
              for (int g = 0; g < 4; ++g) s[g] = flat[(1 + 2 * i + g / 2) * 4 + 2 * r + g % 2];
              *reinterpret_cast<float4*>(spec + ((size_t)n * UP + 4 * i + q4) * 4) =
                  make_float4(s[0], s[1], s[2], s[3]);
            }
          }
        }
      }
    }
    grid.sync();

    // phase 3: the block's VB labels' logits and their first maximum
    if (b < nbv) {
      for (int p0 = 0; p0 < N; p0 += RMAX) {
        const int rows = min(RMAX, N - p0);
        const int WM = pass_wm(rows, MT), mt = warp % WM, kg = warp / WM;
        PassAcc<WT, VB> acc;
        pass_products<WT, VB>(wo_s, J, rows, ring, a.ring_cap, a.lanes,
                              [&](int r) { return a.z + (size_t)(p0 + r) * J; }, acc);
        if (kg != 0) continue;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int n = p0 + row(mt, r);
          float best = -INFINITY;
          int arg = 0x7fffffff;
#pragma unroll
          for (int j = 0; j < VB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // ascending labels: the first maximum
              const int v = b * VB + 8 * j + 2 * q4 + e;
              if (v < V) {
                const float l = __fadd_rn(acc.v[j][2 * r + e], __ldg(a.b2 + v));
                if (l > best || arg == 0x7fffffff) {
                  best = l;
                  arg = v;
                }
              }
            }
#pragma unroll
          for (int o = 1; o < 4; o <<= 1)  // over the 4 lanes of the row
            take_first_max(best, arg, __shfl_xor_sync(0xffffffffu, best, o),
                           __shfl_xor_sync(0xffffffffu, arg, o));
          if (q4 == 0 && n < N) {
            a.best[(size_t)b * N + n] = best;
            a.arg[(size_t)b * N + n] = arg;
          }
        }
      }
    }
    grid.sync();

    // phase 4: a warp per lane: the grid's first maximum and the lane algebra
    int unfinished = 0;
    for (int n = b * WARPS + warp; n < N; n += gridDim.x * WARPS) {
      float best = -INFINITY;
      int sym = 0x7fffffff;
      for (int k = lane; k < nbv; k += 32) {
        take_first_max(best, sym, __ldcg(a.best + (size_t)k * N + n),
                       __ldcg(a.arg + (size_t)k * N + n));
      }
      warp_first_max(best, sym);
      if (lane == 0) {
        const int* ln = a.lanes + n;
        unfinished += lane_step<PACKED>(a, res, n, p, sym, __ldcg(ln + FINISH * N) != 0,
                                        __ldcg(ln + SYMADD * N), __ldcg(ln + RES_IDX * N),
                                        __ldcg(ln + F_LENS * N), __ldcg(ln + EOS * N), time_s[n],
                                        pre_s[n]);
      }
    }
    const int count = __syncthreads_count(unfinished);
    if (tid == 0 && count) atomicAdd(a.alive + p, count);
    grid.sync();
    const bool last = it + 1 >= a.steps || __ldcg(a.alive + p) == 0;  // the same for every block
    if (last) break;
  }

  // commit h/c of the block's units: h' and c' where the last iteration
  // emitted, zeros where it entered an utterance, else the state it
  // started from
  if (b < nbp) {
    const int p = it & 1;
    for (int i = tid; i < N * UP; i += THREADS) {
      const int n = i / UP, u = i - n * UP;
      const size_t off = (size_t)n * P + pcol0 + u;
      const int upd = __ldcg(a.upd + p * N + n);
      const bool zero = PACKED && upd == ENTERED;
      a.hg[off] = zero ? store_as<WT>(0.0f) : ((upd ? a.hn : a.hc) + (size_t)p * NP)[off];
      a.cg[off] = zero ? 0.0f : upd ? cn_s[i] : c_s[i];
    }
  }
}

template <bool PACKED, typename TT>
cudaError_t launch_wide(WideArgs a, cudaStream_t stream) {
  using WT = __nv_bfloat16;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = (size_t)a.P * (UJ + 4 * UPW) * sizeof(WT) + (size_t)a.J * VB * sizeof(WT) +
                       (size_t)2 * a.N * UPW * 4 + (size_t)3 * ((a.N + 3) & ~3) * 4;
  if (fixed + (size_t)ring_min<WT>() * sizeof(WT) > (size_t)limit) return cudaErrorInvalidValue;
  a.ring_cap = (int)(((size_t)limit - fixed) / sizeof(WT)) & ~7;
  const size_t smem = fixed + (size_t)a.ring_cap * sizeof(WT);
  auto kern = decode_loop_wide<PACKED, TT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nbp = a.P / UPW, nbj = a.J / UJ, nbv = (a.V + VB - 1) / VB;
  const int blocks = nbp > nbj ? (nbp > nbv ? nbp : nbv) : (nbj > nbv ? nbj : nbv);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Up to `steps` iterations in one cooperative launch on `stream`, leaving
// early once every lane has finished; two prediction layers.  weight_bf16
// selects the weight type (1: bf16, 0: f32); whh, w1, w2, wout, eproj are
// the layouts of ops/decode_cuda.py kernel_operands for UP = 4 (the only
// unit count built); keep, spec, hn, hc, z, upd and alive (two ints, each
// zeroed by the kernel before it counts into it) are scratch.  starts
// (T2, N) bytes selects packed mode, with rb (N) int32 and budget; null
// starts: the bucketed mode.  Returns 0, or the CUDA error of a refused
// launch (a grid that cannot be co-resident:
// cudaErrorCooperativeLaunchTooLarge).
int rnnt_decode_steps(int weight_bf16, int UP, int steps, const void* fproj, void* lanes,
                      void* hg, void* cg, void* res, const void* whh, const void* w1,
                      const void* w2, const void* b, const void* b1, const void* wout,
                      const void* b2, const void* eproj, void* keep, void* spec, void* hn,
                      void* hc, void* z, void* upd, void* alive, const void* starts, void* rb,
                      int N, int P, int J, int V, int R, int blank, int sos, int max_sym,
                      int budget, void* stream) {
  if (steps <= 0 || N <= 0 || P <= 0 || P % 64 != 0 || J <= 0 || J % 64 != 0 || V < 1 ||
      V > VP || UP != 4 || (starts != nullptr && (rb == nullptr || budget < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.fproj = static_cast<const float*>(fproj);
  a.lanes = static_cast<int*>(lanes);
  a.hg = hg, a.hn = hn, a.z = z, a.hc = hc;
  a.cg = static_cast<float*>(cg);
  a.res = static_cast<int8_t*>(res);
  a.whh = whh, a.w1 = w1, a.w2 = w2, a.wout = wout;
  a.b = static_cast<const float*>(b), a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2), a.eproj = static_cast<const float*>(eproj);
  a.keep = static_cast<float*>(keep), a.spec = static_cast<float*>(spec);
  a.upd = static_cast<int*>(upd), a.alive = static_cast<int*>(alive);
  a.starts = static_cast<const unsigned char*>(starts), a.rb = static_cast<int*>(rb);
  a.steps = steps, a.N = N, a.P = P, a.J = J, a.V = V, a.R = R;
  a.blank = blank, a.sos = sos, a.max_sym = max_sym, a.budget = budget;
  auto* s = static_cast<cudaStream_t>(stream);
  const bool packed = starts != nullptr;
  const cudaError_t err =
      weight_bf16 ? (packed ? launch<__nv_bfloat16, 4, true>(a, s)
                            : launch<__nv_bfloat16, 4, false>(a, s))
                  : (packed ? launch<float, 4, true>(a, s) : launch<float, 4, false>(a, s));
  return static_cast<int>(err);
}

// The wide-vocabulary instantiation (decode_loop_wide): up to `steps`
// iterations of a one-layer prediction net with bf16 weights and any number
// of labels, in one cooperative launch of max(P / 8, J / 8, ceil(V / 16))
// blocks, leaving early once every lane has finished.  whh (P/8, P, 32),
// wj (max(P/8, J/8), P, 40), wout (ceil(V/16), J, 16) and eproj (P/8, V, 8,
// 4) are the layouts of ops/decode_cuda.py kernel_operands_wide; keep,
// spec, hn, hc, z, best, arg, upd and alive are scratch.  res holds int16
// tokens when tok16, else int8.  starts selects packed mode, as above.
// Returns 0, or the CUDA error of a refused launch.
int rnnt_decode_steps_wide(int tok16, int steps, const void* fproj, void* lanes, void* hg,
                           void* cg, void* res, const void* whh, const void* wj, const void* b1,
                           const void* wout, const void* b2, const void* eproj, void* keep,
                           void* spec, void* hn, void* hc, void* z, void* best, void* arg,
                           void* upd, void* alive, const void* starts, void* rb, int N, int P,
                           int J, int V, int R, int blank, int sos, int max_sym, int budget,
                           void* stream) {
  if (steps <= 0 || N <= 0 || P <= 0 || P % 64 != 0 || J <= 0 || J % 64 != 0 || V < 1 ||
      (starts != nullptr && (rb == nullptr || budget < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  WideArgs a{};
  a.fproj = static_cast<const float*>(fproj);
  a.lanes = static_cast<int*>(lanes);
  a.hg = static_cast<__nv_bfloat16*>(hg);
  a.cg = static_cast<float*>(cg);
  a.res = res;
  a.whh = whh, a.wj = wj, a.wout = wout;
  a.b1 = static_cast<const float*>(b1), a.b2 = static_cast<const float*>(b2);
  a.eproj = static_cast<const float*>(eproj);
  a.keep = static_cast<float*>(keep), a.spec = static_cast<float*>(spec);
  a.hn = static_cast<__nv_bfloat16*>(hn), a.hc = static_cast<__nv_bfloat16*>(hc);
  a.z = static_cast<__nv_bfloat16*>(z);
  a.best = static_cast<float*>(best), a.arg = static_cast<int*>(arg);
  a.upd = static_cast<int*>(upd), a.alive = static_cast<int*>(alive);
  a.starts = static_cast<const unsigned char*>(starts), a.rb = static_cast<int*>(rb);
  a.steps = steps, a.N = N, a.P = P, a.J = J, a.V = V, a.R = R;
  a.blank = blank, a.sos = sos, a.max_sym = max_sym, a.budget = budget;
  auto* s = static_cast<cudaStream_t>(stream);
  const bool packed = starts != nullptr;
  const cudaError_t err =
      tok16 ? (packed ? launch_wide<true, int16_t>(a, s) : launch_wide<false, int16_t>(a, s))
            : (packed ? launch_wide<true, int8_t>(a, s) : launch_wide<false, int8_t>(a, s));
  return static_cast<int>(err);
}

const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
