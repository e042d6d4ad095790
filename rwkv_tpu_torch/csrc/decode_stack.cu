// One RWKV-v4 decode step over all L layers: q8 (kernel K1), q4 (kernel K4)
// or W8A8 (the stack of kernel K5), in one persistent, cooperative launch.
//
// Replaces rwkv_tpu/ops/pallas/decode_stack.py:_decode_stack_kernel, its q8
// branch, its q4 branch (_dot4/_fold4) and its a8 branch (_quant_rows,
// _dot_s8), reached through decode_stack() and forward_step_fused().
//
// Bound on the card: the weight bytes, L * 13 * E^2 in q8 (327 MB at 430M,
// 13.6 GB at 14B) and half that in q4 (164 MB), read once per step, over
// device memory bandwidth (~3.35 TB/s on an H100 SXM: ~0.1, ~4.1 and ~0.05
// ms per step). State, activations and scale/offset vectors add under 1%
// (2% in q4).
//
// Two kernels, by batch rows (ops/cuda/decode_stack.py's tc_path):
//
// * q8 at B* <= B <= 16 (the pool's 16 slots): decode_stack_kernel_tc, the
//   matvec phases on the tensor cores (stack_tc.cuh): each block's unit of
//   a phase streams its weight tiles through a TMA ring into wgmma with the
//   activations as three exact bf16 pieces, N = 48 columns for up to 16
//   rows, so every weight byte is read from device memory once a step for
//   all the rows. Bounded by the bytes at 14B, and at 430M by the chain of
//   barriers, the folded LayerNorms and the split-K epilogues that every
//   phase waits for.
// * q8 below B* (RWKV.generate's one stream, where a step is a chain of
//   barrier latencies and a ring fill a phase would add to it), q8 past 16
//   rows, q4 (K4) and a8 (K5's stack): decode_stack_kernel<BT, FMT>, each
//   matvec on qmv.cuh's CUDA-core tile, which keeps 4 batch rows in
//   registers and reads a block's weights again for each further group.
//
// Both are one cooperative launch a step with the same phases, barriers,
// stamps and ln_out phase, described below.
//
// The TPU kernel is one launch whose sequential grid carries the activation
// vector and the offset sums from step to step in VMEM. CUDA blocks run in
// no order and share nothing, and a launch costs more than its bytes at these
// sizes (a near-empty launch ~2.7 us, a 1 MB matvec 5.8-6.5 us on an H100:
// PERF.md), so the step is one cooperative launch of as many blocks as fit
// on the card at once (the occupancy API's blocks per SM times the SMs),
// every block resident, and layer l+1 waits for layer l at grid barriers
// (grid.cuh): four phases a layer, one after the last layer,
//
//   A. ln1 + token-shift mix, folded in: the k/v/r matvecs + the WKV step
//      -> sigmoid(r) * y, new aa/bb/pp, new xy (layer 0 first gathers the
//      embedding rows and runs ln0)
//   B. out-projection, added to the residual
//   C. ln2 + mix, folded in: relu(key)^2; the receptance mix and new dd
//   D. value projection * sigmoid(gate), added to the residual
//   H. ln_out, the head's scaled input and its offset row-sum (row.cuh),
//      which feed the head matvec, kernel K2 (mm8.cu), K3 or K5's head
//
// and 4 * L barriers between them. stack.cuh holds the machinery this
// kernel shares with the tensor-parallel stack (decode_stack_tp.cu, K7):
// the phase loop (stack_phases: each phase deals its (column tile, split)
// items over the blocks, qmv.cuh's tile as a device function, the next
// item's weights copied during the barrier's wait), the split rule, the
// folded row phases (FoldSrc: every block of phases A and C computes the
// LayerNorm and whole-row offset sums from x, with the same code, and writes
// its share of the [B, E] outputs: new xy and dd, the receptance mix that
// phase D reads, x after ln0; block 0 the receptance mix's [B] offset sum and
// maximum), the L2 prefetch and the cooperative launch.
//
// Every weight byte is read once per batch group of the CUDA-core kernel
// (qmv.cuh says how), once for all rows on the tensor cores. The rank-1 offset sums
// run over a matrix's whole input dim: the folded phases compute them whole
// for the inputs they produce, and the k/v/r and key epilogues leave one
// partial per column tile for the out-projection and the value projection,
// summed in a fixed order by their consumer (never atomically added), so
// every run gives the same bits.
//
// In q4 every matvec reads nibble-packed weights [L, K / 2, O] (qmv.cuh's Q4
// instantiation). att.output and ffn.value pair rows within their `block`
// (halves[] below), the others globally.
//
// In a8 (a8_block > 0) every matvec quantizes its input to int8 codes while
// staging it and runs s8 x s8 -> s32 dot products (qmv.cuh's A8
// instantiation). The inputs of att k/v/r, ffn key/receptance and the head
// are quantized per batch row over all E channels, from the row maxima the
// folded phases compute (and row.cuh for the head). The inputs of att.output
// and ffn.value are quantized per block of a8_block channels, as the TPU
// kernel quantizes each of its `tile`-wide slices: their producers (the WKV
// and relu^2 epilogues, 128 columns a block) write one max per 128-column
// tile, and the consumer takes the max of a block's tiles.
//
// A code is a rounding of the f32 value before it, and at RWKV-4 430M with
// random weights a code one apart changes the logits by ~2e-2 a few layers on
// (as much as a8 itself does). So the arithmetic up to every quantization is
// that of the plain version (ops/cuda/decode_stack.py's decode_stack_plain),
// bit for bit: the matvecs' exact integer sums scaled per block in its order
// (qmv.cuh), the LayerNorms' mean and variance and every rank-1 offset sum in
// double, rounded once (a double sum's order moves the f32 result only at a
// rounding tie), and each elementwise f32 operation rounded on its own in the
// plain version's order (__fmul_rn and friends: no contraction into FMAs).
// q8 and q4 share the epilogues; their LayerNorms and offset sums keep f32
// sums, within f32 rounding of the plain version.
//
// The new state is written to separate output tensors: the input state is
// never modified, as in the JAX function. With a stamp buffer, block 0
// writes %globaltimer at the start, after each barrier and at its end
// (4 * L + 2 stamps): tools/decode_profile.py reads the time of each phase.
#include <string.h>

#include "stack_tc.cuh"

namespace rwkv {

// Positions in the pointer table passed by rwkv_tpu_torch/ops/cuda/decode_stack.py
// (_POINTERS there lists the same names in the same order).
enum Ptr : int {
  P_TOKENS, P_EMB, P_LN0_W, P_LN0_B, P_LN1_W, P_LN1_B, P_LN2_W, P_LN2_B,
  P_ATT_MIX_K, P_ATT_MIX_V, P_ATT_MIX_R, P_ATT_DECAY, P_ATT_BONUS,
  P_ATT_K_W, P_ATT_K_S, P_ATT_K_O, P_ATT_V_W, P_ATT_V_S, P_ATT_V_O,
  P_ATT_R_W, P_ATT_R_S, P_ATT_R_O, P_ATT_O_W, P_ATT_O_S, P_ATT_O_O,
  P_FFN_MIX_K, P_FFN_MIX_R,
  P_FFN_K_W, P_FFN_K_S, P_FFN_K_O, P_FFN_V_W, P_FFN_V_S, P_FFN_V_O,
  P_FFN_R_W, P_FFN_R_S, P_FFN_R_O,
  P_LN_OUT_W, P_LN_OUT_B, P_HEAD_S, P_HEAD_O,
  P_XY_IN, P_AA_IN, P_BB_IN, P_PP_IN, P_DD_IN,
  P_XY_OUT, P_AA_OUT, P_BB_OUT, P_PP_OUT, P_DD_OUT,
  P_X, P_RWKV, P_FR, P_KK, P_XS_H, P_OFF_H,
  P_OFFS,       // [B] double: rank-1 term of ffn receptance
  P_OFF_PARTS,  // [E/128 + F/128, B] double: per-tile partials for att.output, ffn.value
  P_AMAX,       // [2, B], a8: row maxima of the inputs of ffn receptance and the head
  P_AMAX_PARTS, // [E/128 + F/128, B], a8: per-tile maxima of att.output's, ffn.value's input
  P_PARTIAL, P_COUNTERS,
  P_STAMPS,     // [4 L + 2] u64 %globaltimer stamps, or null
  P_FOLD_PARTS, // [E/128, kTcTileParts] double, TC kernel: the folded phases' sums (TcNext)
  P_COUNT
};

constexpr int kPhases = 4;  // per layer: A, B, C, D

struct StackArgs {
  void* p[P_COUNT];
  int L, B, E, F, n_emb, q4, a8_block;
  int halves[7];
  long long partial_cap;  // floats of split-K partials
  int counter_cap;        // split-K counters; the barrier's words follow them
  TcPlan tc;              // decode_stack_kernel_tc: each phase kind's splits and tile groups
};

// The matvec of phase `kind` (0..3: A..D) of layer l, written into q (shared
// memory, by one thread; no local arrays: local memory lives in L2 here, the
// shared memory leaving L1 little room). offs_sm, amax_sm: the folded mixes'
// rank-1 terms and maxima in shared memory, [3, B].
template <int FMT>
__device__ void phase_args(QmvArgs& q, const StackArgs& a, int l, int kind, double* offs_sm,
                           float* amax_sm) {
  const int B = a.B, E = a.E, F = a.F;
  const bool q4 = FMT == kQ4, a8 = FMT == kA8;
  auto f = [&](int i) { return static_cast<float*>(a.p[i]); };
  auto i8 = [&](int i) { return static_cast<const int8_t*>(a.p[i]); };
  const size_t EE = (size_t)E * E / (q4 ? 2 : 1), EF = (size_t)E * F / (q4 ? 2 : 1);
  const size_t lE = (size_t)l * E, lF = (size_t)l * F, lBE = (size_t)l * B * E;
  const int tiles_e = (E + kTileO - 1) / kTileO, tiles_f = (F + kTileO - 1) / kTileO;
  double* off_out = static_cast<double*>(a.p[P_OFF_PARTS]);  // [tiles_e, B]
  double* off_val = off_out + (size_t)tiles_e * B;             // [tiles_f, B]
  float* amax_out = f(P_AMAX_PARTS);
  float* amax_val = amax_out + (size_t)tiles_e * B;

  q = QmvArgs{};
  q.B = B;
  q.partial = f(P_PARTIAL);
  q.counters = static_cast<int*>(a.p[P_COUNTERS]);
  auto mat = [&](Mat& t, const float* x, const float* s, const double* off, int n_off,
                 const int8_t* w, int K, int half, const float* amax, int n_amax, int qblock) {
    t.x = x;
    t.scale = s;
    t.off = off;
    t.n_off = n_off;
    t.w = w;
    t.K = K;
    t.half = q4 ? half : 0;
    if (a8) {
      t.amax = amax;
      t.n_amax = n_amax;
      t.qblock = qblock;
    }
  };
  if (kind == 0) {  // A: k, v, r of the folded ln1 mixes, then the WKV step
    q.nmat = 3;
    mat(q.m[0], nullptr, f(P_ATT_K_S) + lE, offs_sm, 1, i8(P_ATT_K_W) + l * EE, E, a.halves[0],
        amax_sm, 1, E);
    mat(q.m[1], nullptr, f(P_ATT_V_S) + lE, offs_sm + B, 1, i8(P_ATT_V_W) + l * EE, E,
        a.halves[1], amax_sm + B, 1, E);
    mat(q.m[2], nullptr, f(P_ATT_R_S) + lE, offs_sm + 2 * B, 1, i8(P_ATT_R_W) + l * EE, E,
        a.halves[2], amax_sm + 2 * B, 1, E);
    q.O = E;
    q.epi = EPI_WKV;
    q.out = f(P_RWKV);
    q.aa_in = f(P_AA_IN) + lBE;
    q.bb_in = f(P_BB_IN) + lBE;
    q.pp_in = f(P_PP_IN) + lBE;
    q.aa_out = f(P_AA_OUT) + lBE;
    q.bb_out = f(P_BB_OUT) + lBE;
    q.pp_out = f(P_PP_OUT) + lBE;
    q.decay = f(P_ATT_DECAY) + lE;
    q.bonus = f(P_ATT_BONUS) + lE;
    q.next_offset = f(P_ATT_O_O) + lE;
    q.next_off = off_out;
    if (a8) {
      q.next_scale = f(P_ATT_O_S) + lE;
      q.next_amax = amax_out;
    }
  } else if (kind == 1) {  // B: the out-projection, added to x
    q.nmat = 1;
    mat(q.m[0], f(P_RWKV), f(P_ATT_O_S) + lE, off_out, tiles_e, i8(P_ATT_O_W) + l * EE, E,
        a.halves[3], amax_out, tiles_e, a8 ? a.a8_block : 0);
    q.O = E;
    q.epi = EPI_ADD;
    q.out = f(P_X);
  } else if (kind == 2) {  // C: key of the folded ln2 mix, relu^2
    q.nmat = 1;
    mat(q.m[0], nullptr, f(P_FFN_K_S) + lE, offs_sm, 1, i8(P_FFN_K_W) + l * EF, E, a.halves[4],
        amax_sm, 1, E);
    q.O = F;
    q.epi = EPI_RELU2;
    q.out = f(P_KK);
    q.next_offset = f(P_FFN_V_O) + lF;
    q.next_off = off_val;
    if (a8) {
      q.next_scale = f(P_FFN_V_S) + lF;
      q.next_amax = amax_val;
    }
  } else {  // D: value * sigmoid(receptance), added to x
    q.nmat = 2;
    mat(q.m[0], f(P_KK), f(P_FFN_V_S) + lF, off_val, tiles_f, i8(P_FFN_V_W) + l * EF, F,
        a.halves[5], amax_val, tiles_f, a8 ? a.a8_block : 0);
    mat(q.m[1], f(P_FR), f(P_FFN_R_S) + lE, static_cast<double*>(a.p[P_OFFS]), 1,
        i8(P_FFN_R_W) + l * EE, E, a.halves[6], f(P_AMAX), 1, E);
    q.O = E;
    q.epi = EPI_GATED_ADD;
    q.out = f(P_X);
  }
}

// The split of phase q; in a8, raised where needed until a8_exact_long
// holds (the plain version's bits), within kMaxSplit and the partial scratch.
template <int FMT>
__device__ __forceinline__ int phase_split(const StackArgs& a, const QmvArgs& q) {
  int S = stack_split((q.O + kTileO - 1) / kTileO, qmv_kmax<FMT>(q), q.nmat, a.B, q.O,
                      a.partial_cap, a.counter_cap, gridDim.x);
  if constexpr (FMT == kA8) {
    while (!qmv_short<FMT>(q, S) && !a8_exact_long<FMT>(q, S) && S < kMaxSplit &&
           (long long)(S + 1) * q.nmat * a.B * q.O <= a.partial_cap)
      ++S;
  }
  return S;
}

// The fold source of phase A (att) or C (ffn) of layer l, written into src
// (shared memory, by one thread).
template <int BT, bool EXACT>
__device__ void fold_src(FoldSrc<BT, EXACT>& src, const StackArgs& a, int l, bool att) {
  auto f = [&](int i) { return static_cast<float*>(a.p[i]); };
  const size_t lE = (size_t)l * a.E, lBE = (size_t)l * a.B * a.E;
  src.E = a.E;
  src.B = a.B;
  src.nfold = att ? 3 : 1;
  src.nmix = att ? 3 : 2;
  src.tokens = att && l == 0 ? static_cast<const int*>(a.p[P_TOKENS]) : nullptr;
  src.emb = f(P_EMB);
  src.n_emb = a.n_emb;
  src.ln0_w = f(P_LN0_W);
  src.ln0_b = f(P_LN0_B);
  src.resid = f(P_X);
  src.ln_w = f(att ? P_LN1_W : P_LN2_W) + lE;
  src.ln_b = f(att ? P_LN1_B : P_LN2_B) + lE;
  src.prev = f(att ? P_XY_IN : P_DD_IN) + lBE;
  src.prev_out = f(att ? P_XY_OUT : P_DD_OUT) + lBE;
  src.mix[0] = f(att ? P_ATT_MIX_K : P_FFN_MIX_K) + lE;
  src.mix[1] = f(att ? P_ATT_MIX_V : P_FFN_MIX_R) + lE;
  src.mix[2] = f(att ? P_ATT_MIX_R : P_FFN_MIX_R) + lE;
  src.offset[0] = f(att ? P_ATT_K_O : P_FFN_K_O) + lE;
  src.offset[1] = f(att ? P_ATT_V_O : P_FFN_R_O) + lE;
  src.offset[2] = f(att ? P_ATT_R_O : P_FFN_R_O) + lE;
  src.qscale[0] = f(att ? P_ATT_K_S : P_FFN_K_S) + lE;
  src.qscale[1] = f(att ? P_ATT_V_S : P_FFN_R_S) + lE;
  src.qscale[2] = f(att ? P_ATT_R_S : P_FFN_R_S) + lE;
  src.fr_out = att ? nullptr : f(P_FR);
  src.fr_off = att ? nullptr : static_cast<double*>(a.p[P_OFFS]);
  src.fr_amax = f(P_AMAX);
}

// The plan of decode_stack_kernel's phase loop (stack.cuh's stack_phases):
// threads 0 and 32 (two warps, at once) describe phase ph into the shared q
// and src; then every thread reads them.
template <int BT, int FMT>
struct StackPlan {
  static constexpr bool EXACT = FMT == kA8;
  using Fold = FoldSrc<BT, EXACT>;
  using acc_t = typename Fold::acc_t;
  const StackArgs& a;
  QmvArgs& q;  // shared: the current phase's matvec
  Fold& s;     // shared: its fold source (phases A and C)
  float* xx;
  double* offs;
  float* amax;
  acc_t* ascratch;
  float* fscratch;
  Stamps stamps;
  int kind, S, n_items;

  __device__ __forceinline__ void describe(int ph) {
    const int tid = threadIdx.x;
    kind = ph % kPhases;
    if (tid == 0) phase_args<FMT>(q, a, ph / kPhases, kind, offs, amax);
    if (tid == 32 && fold()) {
      fold_src<BT, EXACT>(s, a, ph / kPhases, kind == 0);
      s.xx = xx;
      s.offs = offs;
      s.amax = amax;
      s.ascratch = ascratch;
      s.fscratch = fscratch;
    }
    __syncthreads();
    S = phase_split<FMT>(a, q);
    n_items = (q.O + kTileO - 1) / kTileO * S;
  }
  __device__ __forceinline__ int items() const { return n_items; }
  __device__ __forceinline__ bool fold() const { return kind == 0 || kind == 2; }
  __device__ __forceinline__ const QmvArgs& item(int it, int& tile, int& sp, int& Sp) const {
    tile = it / S;
    sp = it % S;
    Sp = S;
    return q;
  }
  // the first item writes this block's share of the rows' outputs
  __device__ __forceinline__ void fold_item(int, int r) {
    const int G = gridDim.x, writers = n_items < G ? n_items : G;
    const int chunk = (a.E + writers - 1) / writers;
    if (threadIdx.x == 0) {
      s.lo = r == 0 ? min(a.E, (int)blockIdx.x * chunk) : 0;
      s.hi = r == 0 ? min(a.E, s.lo + chunk) : 0;
      if (r) s.fr_out = nullptr;
      if (r || blockIdx.x) s.fr_off = nullptr;
    }
    __syncthreads();
  }
  __device__ __forceinline__ const Fold& src() const { return s; }
  __device__ __forceinline__ void prefetch() const {
    prefetch_qmv(q);
    if (fold()) prefetch_fold(s);
  }
  __device__ __forceinline__ void stamp() { stamps(); }
  __device__ __forceinline__ void after_barrier() { stamps(); }
};

// One block a SM: the whole matvec path is inlined (qmv.cuh's qmv_run) and holds
// up to 255 registers without a spill; two blocks a SM (128 registers) spilled
// to local memory, which with this much shared memory lives in L2.
template <int BT, int FMT>
__global__ void __launch_bounds__(kThreads, 1) decode_stack_kernel(const __grid_constant__ StackArgs a) {
  constexpr bool EXACT = FMT == kA8;
  using acc_t = std::conditional_t<EXACT, double, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ acc_t ascratch[3 * BT * 33];
  __shared__ float fscratch[3 * BT * 33];
  __shared__ QmvArgs q;
  __shared__ FoldSrc<BT, EXACT> src;
  StackSmem<BT, FMT> m;
  m.carve(smem, a.E, a.B);

  const int B = a.B, E = a.E, G = gridDim.x;
  auto f = [&](int i) { return static_cast<float*>(a.p[i]); };
  GridBarrier bar;
  bar.init(static_cast<unsigned*>(a.p[P_COUNTERS]) + a.counter_cap, G);
  StackPlan<BT, FMT> plan{a, q, src, m.xx, m.offs, m.amax, ascratch, fscratch,
                          Stamps{static_cast<unsigned long long*>(a.p[P_STAMPS]), 0}};
  plan.stamp();
  stack_phases<BT, FMT>(plan, kPhases * a.L, true, bar, *m.sm, m.wsm);

  RowArgs rh = {};
  rh.mode = ROW_HEAD;
  rh.B = B;
  rh.E = E;
  rh.n_emb = a.n_emb;
  rh.x = f(P_X);
  rh.ln_w = f(P_LN_OUT_W);
  rh.ln_b = f(P_LN_OUT_B);
  rh.head_scale = f(P_HEAD_S);
  rh.offset[0] = f(P_HEAD_O);
  rh.off_h = f(P_OFF_H);
  rh.xs_h = f(P_XS_H);
  rh.amax[0] = EXACT ? f(P_AMAX) + B : nullptr;
  bar.finish();
  for (int b = blockIdx.x; b < B; b += G) row_run<EXACT>(rh, b, m.xx, fscratch, ascratch);
  plan.stamp();
}

// The folded phase that reads the x of phase `kind` of layer l (TcNext):
// phase B's feeds phase C (ln2, ffn key and receptance mixes), phase D's the
// next layer's phase A (ln1, att k, v, r mixes); the others, and the last
// layer's D (ln_out: row_run), none.
__device__ void tc_next(TcNext& nx, const StackArgs& a, int l, int kind) {
  auto f = [&](int i) { return static_cast<const float*>(a.p[i]); };
  nx = TcNext{};
  const bool c = kind == 1;
  if (!c && !(kind == 3 && l + 1 < a.L)) return;
  const int lf = c ? l : l + 1;
  const size_t lE = (size_t)lf * a.E, lBE = (size_t)lf * a.B * a.E;
  nx.parts = static_cast<double*>(a.p[P_FOLD_PARTS]);
  nx.ln_w = f(c ? P_LN2_W : P_LN1_W) + lE;
  nx.ln_b = f(c ? P_LN2_B : P_LN1_B) + lE;
  nx.prev = f(c ? P_DD_IN : P_XY_IN) + lBE;
  nx.nmix = c ? 2 : 3;
  nx.mix[0] = f(c ? P_FFN_MIX_K : P_ATT_MIX_K) + lE;
  nx.mix[1] = f(c ? P_FFN_MIX_R : P_ATT_MIX_V) + lE;
  nx.offset[0] = f(c ? P_FFN_K_O : P_ATT_K_O) + lE;
  nx.offset[1] = f(c ? P_FFN_R_O : P_ATT_V_O) + lE;
  if (!c) {
    nx.mix[2] = f(P_ATT_MIX_R) + lE;
    nx.offset[2] = f(P_ATT_R_O) + lE;
  }
}

// K1 on the tensor cores (stack_tc.cuh), q8 at 1 <= B <= 16: the phases of
// decode_stack_kernel and its barriers, stamps and ln_out phase, each
// matvec phase one unit a block (a matrix's split of the contraction over a
// group of column tiles) streamed through the TMA ring onto wgmma. The
// tensor maps are the first parameter: a map must be 64-byte aligned, and
// only the first parameter's offset is.
__global__ void __launch_bounds__(kThreads, 1)
    decode_stack_kernel_tc(const __grid_constant__ TcMaps maps, const __grid_constant__ StackArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ float ascratch[3 * 4 * 33];
  __shared__ float fscratch[3 * 4 * 33];
  __shared__ QmvArgs q;
  __shared__ FoldSrc<4, false> src;
  __shared__ float amax[3 * kTcMaxB];  // FoldSrc's row maxima (written, read in a8 only)
  __shared__ TcNext nx;
  __shared__ int elected;
  TcSmem sm;
  sm.carve(smem, a.E);
  const int tid = threadIdx.x, B = a.B, E = a.E, G = gridDim.x, n = kPhases * a.L;
  auto f = [&](int i) { return static_cast<float*>(a.p[i]); };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&maps.m[0])) : "memory");
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  GridBarrier bar;
  bar.init(static_cast<unsigned*>(a.p[P_COUNTERS]) + a.counter_cap, G);
  Stamps stamps{static_cast<unsigned long long*>(a.p[P_STAMPS]), 0};
  stamps();

  unsigned first = 0;  // the ring's stages consumed by this block before this phase
  int prod = 0;        // warp 0: the phase's stages issued
  TcUnit u;
  // phase ph into q, src and u; warp 0 then issues the first stages of u
  auto describe = [&](int ph) {
    const int kind = ph % kPhases, l = ph / kPhases;
    if (tid == 0) phase_args<kQ8>(q, a, l, kind, sm.offs, amax);
    if (tid == 64) tc_next(nx, a, l, kind);
    if (tid == 32 && (kind == 0 || kind == 2)) {
      fold_src<4, false>(src, a, l, kind == 0);
      src.xx = sm.xx;
      src.offs = sm.offs;
      src.amax = amax;
      src.ascratch = ascratch;
      src.fscratch = fscratch;
    }
    __syncthreads();
    u = tc_unit(q, kind, l, a.tc.ks[kind], a.tc.tiles[kind]);
    prod = 0;
    if (tid < 32 && u.live) tc_issue(u, maps, sm, first, prod, kTcStages, -1);
  };
  describe(0);
  for (int ph = 0; ph < n; ++ph) {
    const int kind = ph % kPhases;
    const bool fold = kind == 0 || kind == 2;
    if (u.live) {
      const Mat& mt = q.m[u.m];
      uint32_t* op = fold ? sm.op_fold : sm.op_free;
      const int R = u.ns * kTcRows;
      if (fold) {
        // the block's share of the rows' [B, E] outputs (FoldSrc), as the
        // CUDA-core path deals them over the units
        const int chunk = (E + u.units - 1) / u.units;
        if (tid == 0) {
          src.lo = min(E, (int)blockIdx.x * chunk);
          src.hi = min(E, src.lo + chunk);
          if (blockIdx.x) src.fr_off = nullptr;
        }
        __syncthreads();
        if (ph)  // from the sums phase B's or D's epilogues left
          tc_fold(src, static_cast<const double*>(a.p[P_FOLD_PARTS]), u.m, mt.scale, u.k0, R, op,
                  reinterpret_cast<double*>(sm.scratch));
        else for (int b0 = 0; b0 < kTcMaxB; b0 += 4) {
          if (b0 < B) src.prologue(b0, min(4, B - b0));
          tc_stage<4>(op, R, u.k0, b0, B, [&](int b, int bi, int k) {
            const float* mix = src.mix[u.m];
            const float* xr = sm.xx + bi * E;
            const float* pr = src.prev + (size_t)b * E;
            return make_float2(token_mix<false>(mix[k], xr[k], pr[k]) * mt.scale[k],
                               token_mix<false>(mix[k + 1], xr[k + 1], pr[k + 1]) * mt.scale[k + 1]);
          });
          __syncthreads();  // xx is rewritten by the next group's prologue
        }
      } else {
        tc_stage<kTcMaxB>(op, R, u.k0, 0, B, [&](int b, int, int k) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(mt.x + (size_t)b * mt.K + k));
          const float2 s = __ldg(reinterpret_cast<const float2*>(mt.scale + k));
          return make_float2(x.x * s.x, x.y * s.y);
        });
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before wgmma reads it
      __syncthreads();
      // Tile i's arrival is added after its partials; whether it was the
      // last is read after tile i + 1's sums, so the atomic's round trip
      // overlaps them, and its epilogue runs then.
      int j = 0;
      unsigned arrived = 0;  // thread 0: the pending arrival's count before it
      for (int i = 0; i <= u.nt; ++i) {
        if (i < u.nt) {
          float acc[kTcNT * 4];
          tc_tile_sums(acc, u, maps, sm, op, first, j, prod);
          tc_write_partial(acc, sm, q.partial, u.base + u.s, B, q.O, tc_tile(u, i) * kTileO);
        }
        // the partials were ordered before the barrier; thread 0's acq_rel
        // add releases them with its arrival and acquires every earlier
        // unit's for the last one
        __syncthreads();
        if (tid == 0) {
          elected = i > 0 && arrived == (unsigned)(u.arrivals - 1);
          if (i < u.nt)
            arrived = atom_add_acq_rel_gpu(
                reinterpret_cast<unsigned*>(&q.counters[tc_tile(u, i)]), 1u);
        }
        __syncthreads();
        if (elected) {
          const int tile = tc_tile(u, i - 1);
          if (tid == 0) q.counters[tile] = 0;  // ready for the next phase or launch
          tc_epilogue(q, u, sm, nx, tile, [&](int m) { return fold && m < src.nfold; });
        }
      }
      first += j;
    }
    bar.arrive();
    if (ph + 1 < n) {  // the next phase's vectors and first weights, fetched during the wait
      describe(ph + 1);
      prefetch_qmv(q);
      if (ph % kPhases == 1 || ph % kPhases == 3) prefetch_fold(src);
    }
    bar.wait();
    stamps();
  }

  RowArgs rh = {};
  rh.mode = ROW_HEAD;
  rh.B = B;
  rh.E = E;
  rh.n_emb = a.n_emb;
  rh.x = f(P_X);
  rh.ln_w = f(P_LN_OUT_W);
  rh.ln_b = f(P_LN_OUT_B);
  rh.head_scale = f(P_HEAD_S);
  rh.offset[0] = f(P_HEAD_O);
  rh.off_h = f(P_OFF_H);
  rh.xs_h = f(P_XS_H);
  bar.finish();
  for (int b = blockIdx.x; b < B; b += G) row_run<false>(rh, b, sm.xx, fscratch, ascratch);
  stamps();
}

template <int FMT>
cudaError_t launch_stack_fmt(const StackArgs& a, cudaStream_t st, int* grid) {
  const int bt = stack_bt(a.B);
#define RWKV_LAUNCH(BT_) \
  coop_launch(decode_stack_kernel<BT_, FMT>, a, stack_smem<BT_, FMT>(a.E, a.B), st, grid)
  if (bt == 1) return RWKV_LAUNCH(1);
  if (bt == 2) return RWKV_LAUNCH(2);
  return RWKV_LAUNCH(4);
#undef RWKV_LAUNCH
}

// N grid barriers and nothing else, at a given grid (tools/qmv_probe.py).
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(unsigned* word, int n) {
  GridBarrier bar;
  bar.init(word, gridDim.x);
  for (int i = 0; i < n; ++i) bar.sync();
  bar.finish();
}

}  // namespace rwkv

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rwkv_decode_stack_pointer_count() { return P_COUNT; }

// Blocks of the step's launch at batch B and width E, in *grid: q4 and a8
// select the instantiation. Returns the first CUDA error (0 if none).
extern "C" int rwkv_decode_stack_grid(int B, int E, int q4, int a8, int* grid) {
  const int fmt = a8 ? kA8 : (q4 ? kQ4 : kQ8);
  const int bt = stack_bt(B);
  cudaError_t e = cudaErrorInvalidValue;
#define RWKV_GRID(BT_, F_) \
  if (bt == BT_ && fmt == F_) e = coop_grid(decode_stack_kernel<BT_, F_>, stack_smem<BT_, F_>(E, B), grid)
  RWKV_GRID(1, kQ8); RWKV_GRID(2, kQ8); RWKV_GRID(4, kQ8);
  RWKV_GRID(1, kQ4); RWKV_GRID(2, kQ4); RWKV_GRID(4, kQ4);
  RWKV_GRID(1, kA8); RWKV_GRID(2, kA8); RWKV_GRID(4, kA8);
#undef RWKV_GRID
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// One cooperative launch of `grid` blocks that runs n grid barriers on the
// kBarrierWords words at `word`; returns the launch's CUDA error.
extern "C" int rwkv_barrier_probe(int grid, int n, void* word, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  unsigned* w = static_cast<unsigned*>(word);
  void* args[] = {&w, &n};
  cudaError_t e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(barrier_probe_kernel),
                                      args);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Enqueues one decode step on `stream` as one cooperative launch; returns the
// first CUDA error (0 if none), the number of kernels launched in
// *n_launched (1, or 0 on an error) and the launch's blocks in *grid. q4: the
// weight pointers are nibble-packed [L, K / 2, O], and halves[7] gives half
// the pairing block of att key, value, receptance, output, ffn key, value,
// receptance, in rows (K / 2 for global pairing). a8_block > 0: W8A8, with
// att.output's and ffn.value's inputs quantized per block of a8_block
// channels (a multiple of 128 that divides E and F); q8 weights only.
// counters holds counter_cap ints, zero before the first call: the split-K
// counters, then the grid barrier's kBarrierWords.
extern "C" int rwkv_decode_stack(void* const* p, int n_ptrs, int L, int B, int E, int F,
                                 int n_emb, int q4, const int* halves, int a8_block,
                                 long long partial_cap, int counter_cap, void* stream,
                                 int* n_launched, int* grid) {
  *n_launched = 0;
  *grid = 0;
  if (n_ptrs != P_COUNT || counter_cap <= kBarrierWords || E % 16 || F % 16)
    return (int)cudaErrorInvalidValue;
  const bool a8 = a8_block > 0;
  if (a8 && (q4 || a8_block % kTileO || E % a8_block || F % a8_block))
    return (int)cudaErrorInvalidValue;
  StackArgs a = {};
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = p[i];
  a.L = L;
  a.B = B;
  a.E = E;
  a.F = F;
  a.n_emb = n_emb;
  a.q4 = q4;
  a.a8_block = a8_block;
  for (int i = 0; i < 7; ++i) a.halves[i] = q4 ? halves[i] : 0;
  a.partial_cap = partial_cap;
  a.counter_cap = counter_cap - kBarrierWords;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a8 ? launch_stack_fmt<kA8>(a, st, grid)
                           : (q4 ? launch_stack_fmt<kQ4>(a, st, grid)
                                 : launch_stack_fmt<kQ8>(a, st, grid));
  if (e == cudaSuccess) *n_launched = 1;
  return (int)e;
}

// The TC kernel's stage and operand capacity and grid on the current
// device at width E: the weight rows of a stage (*stage_rows), the most
// stages of the folded phases' operand that fit beside the kernel's other
// shared memory (*op_stages), and the blocks of one cooperative launch with
// it (*grid). Returns the first CUDA error.
extern "C" int rwkv_decode_stack_tc_caps(int E, int* stage_rows, int* op_stages, int* grid) {
  *stage_rows = kTcRows;
  *op_stages = 0;
  *grid = 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, decode_stack_kernel_tc);
  if (e == cudaSuccess) {
    const long long room = (long long)optin - (long long)attr.sharedSizeBytes - (long long)tc_smem(E, 0);
    *op_stages = room > 0 ? (int)(room / (kTcRows * kTcRowBytes)) : 0;
    if (*op_stages < 1) e = cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) e = coop_grid(decode_stack_kernel_tc, tc_smem(E, *op_stages), grid);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// The TC kernel's tensor maps of the seven weight families (w[i]: the [L, K,
// O] int8 codes of att key, value, receptance, output, ffn key, value,
// receptance), written to out (kTcMaps * 128 bytes, 64-aligned): kTcRows
// rows x 128 columns a box over [L * K, O], the 128-byte swizzle. Returns
// the first CUDA error.
extern "C" int rwkv_decode_stack_tc_maps(void* const* w, int L, int E, int F, void* out) {
  EncodeTiled encode;
  cudaError_t e = encode_fn(&encode);
  if (e != cudaSuccess) return (int)e;
  if (reinterpret_cast<uintptr_t>(out) % 64) return (int)cudaErrorInvalidValue;
  const int K[kTcMaps] = {E, E, E, E, E, F, E}, O[kTcMaps] = {E, E, E, E, F, E, E};
  CUtensorMap* maps = static_cast<CUtensorMap*>(out);
  for (int i = 0; i < kTcMaps; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)O[i], (cuuint64_t)L * K[i]};
    const cuuint64_t strides[1] = {(cuuint64_t)O[i]};
    const cuuint32_t box[2] = {kTileO, kTcRows};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w[i], dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Enqueues one q8 decode step on the tensor cores (decode_stack_kernel_tc)
// on `stream` as one cooperative launch, as rwkv_decode_stack does: the same
// pointer table, B <= 16, E and F multiples of 128; plan: each phase kind's
// stages a split, then its column tiles a group (TcPlan); maps: the
// tensor maps of rwkv_decode_stack_tc_maps; op_stages: of
// rwkv_decode_stack_tc_caps. Returns the first CUDA error (0 if none), 1 or
// 0 launches in *n_launched and the launch's blocks in *grid.
extern "C" int rwkv_decode_stack_tc(void* const* p, int n_ptrs, int L, int B, int E, int F,
                                    int n_emb, const int* plan, const void* maps, int op_stages,
                                    long long partial_cap, int counter_cap, void* stream,
                                    int* n_launched, int* grid) {
  *n_launched = 0;
  *grid = 0;
  if (n_ptrs != P_COUNT || counter_cap <= kBarrierWords || B < 1 || B > kTcMaxB ||
      E % kTileO || F % kTileO || op_stages < 1)
    return (int)cudaErrorInvalidValue;
  StackArgs a = {};
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = p[i];
  a.L = L;
  a.B = B;
  a.E = E;
  a.F = F;
  a.n_emb = n_emb;
  for (int i = 0; i < 4; ++i) {
    a.tc.ks[i] = plan[i];
    a.tc.tiles[i] = plan[4 + i];
    if (plan[i] < 1 || plan[4 + i] < 1) return (int)cudaErrorInvalidValue;
  }
  a.partial_cap = partial_cap;
  a.counter_cap = counter_cap - kBarrierWords;
  TcMaps m;
  memcpy(&m, maps, sizeof(m));
  const size_t smem = tc_smem(E, op_stages);
  cudaError_t e = coop_grid(decode_stack_kernel_tc, smem, grid);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(*grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&m, &a};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(decode_stack_kernel_tc), args);
  const cudaError_t last = cudaGetLastError();  // read either way: nothing left behind
  if (e == cudaSuccess) e = last;
  if (e == cudaSuccess) *n_launched = 1;
  return (int)e;
}
