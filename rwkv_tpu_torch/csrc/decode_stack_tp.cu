// One tensor-parallel decode step of every model shard of a data row, q8 or
// q4 (kernel K7), in one persistent, cooperative launch.
//
// Replaces rwkv_tpu/ops/pallas/decode_stack_tp.py:_decode_stack_tp_kernel,
// reached through decode_stack_tp() from the "fused" body of
// rwkv_tpu/parallel/tp_step.py; here rwkv_tpu_torch/ops/cuda/decode_stack_tp.py
// wraps it and the "fused" body of rwkv_tpu_torch/parallel/tp_step.py calls it.
//
// A shard of a tp-wide mesh holds E_loc = E / tp channels (parallel/sharding.py):
// column shards [L, E, E_loc] of att key/value/receptance and ffn receptance
// and [L, E, F_loc] of ffn key, row shards [L, E_loc, E] of att.output and
// [L, F_loc, E] of ffn.value (the scale/offset slices with them), the head's
// columns [E, V_loc] and the embedding's rows [V_loc, E]. The TPU kernel runs
// one shard's whole step as one grid on each chip and exchanges the partials
// between chips by remote DMAs inside it. Here all shards of a data row lie
// on one card, and the whole step of all of them is one cooperative launch,
// built on the unsharded stack's machinery (stack.cuh, decode_stack.cu):
// 4 * L + 1 phases behind 4 * L grid barriers, the shard one more index of a
// phase's items (family, shard, column tile, split),
//
//   A. the previous layer's ffn exchange, x += gate * (vpart[0] + ... +
//      vpart[tp-1]) (layer 0: the vocab-sharded embedding gather summed over
//      the shards, then ln0; or a given x), ln1 + mix folded in: every
//      shard's k/v/r on its E_loc channels + the WKV step on its aa/bb/pp
//      slices -> sigmoid(r) * y
//   B. every shard's out-projection PARTIAL [B, E], its offset share folded in
//   C. the att exchange, x += apart[0] + ... + apart[tp-1], ln2 + mix folded
//      in: every shard's relu(key)^2 on its F_loc channels; the receptance
//      mix and its rank-1 term written for D
//   D. every shard's value PARTIAL [B, E], and, as items of their own
//      family, its gate sigmoid(receptance) on its E_loc channels (the
//      gate's O is E_loc, the value's E, and one matvec's matrices share O;
//      the blocks are dealt to the two by their bytes). The unsharded stack
//      runs the gate in D too: in C beside the key, on the same blocks, it
//      lengthened the key's splits, measured slower (PERF.md)
//   H. the last ffn exchange, ln_out folded in: every shard's V_loc head
//      columns, its local logits with no logit bias (the caller adds its
//      slice and gathers them)
//
// The exchange is part of the fold: every block of A, C and H sums the tp
// partials in the fixed order 0..tp-1, with the same code (FoldSrc's
// tp_rows4), as the JAX kernel sums the received chunks in sender order, so
// every block gets the same bits, and each element of x, xy and dd is written
// by one owner. x lives in two buffers: A reads x and writes x_mid, C reads
// x_mid and writes x, H reads x, so no phase writes the x it reads. A
// row-parallel family's rank-1 offset term is the sum over its shard's
// contraction slice, which the producing epilogue leaves per column tile
// (next_off), so each shard's partial carries its share and the sum of
// partials is the partial of the sum.
//
// Each shard keeps its own split-K partials and counters (the shards' items
// run in one phase at once); phase D's two families have a half each. The
// grid barrier's words follow the tp sets of counters, and the launch leaves
// all of them at zero, so a CUDA graph may replay it. With a stamp buffer,
// block 0 writes %globaltimer at the start, after each barrier and at its
// end (4 * L + 2 stamps).
//
// q4 (kernel K7 over packed weights): qmv.cuh's Q4 instantiation. The column
// families and the head pair rows globally over K = E; att.output and
// ffn.value pair within their block, which lies whole inside a shard
// (halves[] below).
//
// Bound on the card: the weight bytes of all shards per step, read once,
// over device memory bandwidth: at 430M, 379 MB in q8 and 189.5 MB in q4,
// head included: 0.113 and 0.057 ms on a 3.35 TB/s card. At tp = 1 it reads
// what K1 + K2 read, and runs K1's phases (its gate with the key, and the
// head in the launch).
//
// Across cards (`cards`): the shards of a data row on distinct GPUs, as the
// TPU kernel runs them on distinct chips; this replaces its remote DMAs
// (decode_stack_tp.py:136-210: _rs_dma/_red_finish, _gate_start/_gate_wait
// and the barrier semaphore at t == 0). Each card runs one cooperative launch
// of its own shard (nloc = 1, `me` its index), all of them enqueued back to
// back from one host thread. The exchanges are peer stores over NVLink (peer
// access enabled between every pair of the row's cards): the epilogue that
// produces a shard's B partial, D partial or gate stores each element into
// its own receive slot `me` on every card (QmvArgs::peer), and at B <= 8 a
// prologue stores the shard's gathered embedding rows the same way, so every
// card holds all tp partials in its own memory and sums them in the fold in
// shard order 0..tp-1, with the same code as on one card. A direct
// all-exchange of [B, E] partials was taken over the TPU kernel's
// reduce-scatter + all-gather: at B <= 8 and E = 5120 a partial is at most
// 160 KB, pushed once to each peer, and it needs one flag hop instead of two
// (the reduce-scatter's second round trip is the latency it would add, and
// latency, not NVLink bandwidth, is what an exchange costs at decode batch).
// A flag per exchange and shard replaces the one-device grid barrier: after
// the producing phase's local grid barrier (every block's peer stores fenced
// at system scope before it arrives), block 0 stores the epoch into the flag
// of its shard on every card with st.release.sys; every block of the
// consuming phase waits, with ld.acquire.sys, until the flags of all the other
// shards reach that epoch. Epochs grow with a step counter that each card
// keeps in its flag words (the last block to finish adds one), so the flags
// are never reset and a CUDA graph could replay the launch. The two things the
// TPU kernel guards with its t == 0 barrier hold here by the flags' order: a
// slot of shard j on card k is rewritten only after j waited on a flag that k
// set after its last read of that slot (the apart slots are read in C(l) and
// next written in B(l + 1), after A(l + 1) waited on k's D(l) flag; the vpart
// and gate slots are read in A(l + 1) or H and next written in D(l + 1) or
// the next step's D(0), after C waited on k's B flag of that layer; the
// embedding slots are read in A(0) and next written by the next step, after
// C(0) waited on k's B(0) flag); and the receive slots are persistent device
// memory, so a store may land before its target's launch has begun. A wait
// of more than 20 s traps. Bound per card: that card's weight bytes over
// device memory bandwidth (14B q8 at tp = 4: about 3.5 GB, 1.04 ms at 3.35
// TB/s), plus 3 L + 1 exchange latencies: the design keeps the latency to
// one flag hop per exchange and overlaps the next phase's weight loads with
// the barrier before it, as on one card. With stamps, block 0 also stamps
// the end of each wait (4 L + 2 onwards: the embedding exchange, then the
// att and ffn exchanges of each layer).
//
// Across processes (parallel/multihost.py's pod_mesh(model=tp), one card a
// process, tp processes a data row): the same launch of one shard a card,
// `me` the process's global shard index, and the same peer stores and
// flags. This replaces the TPU kernel's remote DMAs between chips that
// belong to different processes (its device ids are global, so one kernel
// serves such a row there). What differs is the set-up, which the wrapper
// makes once per batch size: each process allocates its card's receive
// slots, embedding slots and flag words as one region of its own
// (rwkv_ipc_alloc: cudaMalloc, zeroed, cudaIpcGetMemHandle), the processes
// all-gather the handles over the row's group, each opens its peers'
// regions (rwkv_ipc_open: cudaIpcOpenMemHandle with lazy peer access) and
// writes the opened addresses into its `peers` table, and the row meets at
// a barrier before any card launches: the host-side counterpart of the TPU
// kernel's barrier semaphore at t == 0, so that no store reaches a region
// its owner has not zeroed and every card's table exists before the first
// launch. Teardown mirrors it: every process closes its peers' mappings,
// the row meets at a barrier, then each frees its own region. The step
// counter lives in the flag words on the device and a region's addresses
// are fixed for its life, so no epoch or address reaches the launch as a
// host value, and each process's CUDA graph may replay its launch. A row
// whose processes share a card is refused by the wrapper: without MPS the
// cooperative kernels of two contexts do not run side by side, and one
// would spin on the other's flag until its 20 s wait traps. Bound per card
// as across cards: that card's weight bytes over device memory bandwidth
// (14B q8 at tp = 4: about 3.5 GB, 1.04 ms at 3.35 TB/s), plus 3 L + 1
// exchange latencies.
//
#include <cstring>

#include "stack.cuh"

namespace rwkv {

// Positions in the pointer table passed by rwkv_tpu_torch/ops/cuda/decode_stack_tp.py
// (_SHARED and _SHARD there list the same names in the same order): the
// data row's pointers, then tp blocks of one shard's.
enum SharedPtr : int {
  S_TOKENS, S_X_IN,
  S_X, S_X_MID,       // [B, E] x before ln1 (after the att exchange) and before ln2
  S_XY_IN, S_DD_IN, S_XY_OUT, S_DD_OUT,
  S_APART, S_VPART,   // [tp, B, E] partials
  S_GATE, S_RWKV,     // [tp, B, E_loc]
  S_KK,               // [tp, B, F_loc]
  S_FR,               // [B, E] the receptance mix, C -> D
  S_FR_OFF,           // [B] double: its rank-1 term
  S_OFF_PARTS,  // [tp, E_loc / 128 + F_loc / 128, B] double: per-tile offset shares
  S_LOGITS,     // [tp, B, V_loc]
  S_PARTIAL,    // tp times partial_cap floats
  S_COUNTERS,   // tp times counter_cap ints, then the barrier's kBarrierWords
  S_STAMPS,     // [4 L + 2] u64 %globaltimer stamps ([6 L + 3] across cards), or null
  // across cards, else null:
  S_EMB_SLOTS,  // [tp, B, E] each shard's gathered embedding rows
  S_FLAGS,      // [kFlagWords] u64: the step counter, then the exchanges' flags
  S_PEERS,      // [K_COUNT, kMaxShards] pointers: on card c, this shard's slot
                // (apart, vpart, gate, emb) and card c's flag words
  S_COUNT
};

// The receive slots and flags that S_PEERS points at, per card.
// (rwkv_tpu_torch/ops/cuda/decode_stack_tp.py's _PEER_KINDS lists the same names.)
enum PeerKind : int { K_APART, K_VPART, K_GATE, K_EMB, K_FLAGS, K_COUNT };
// The exchanges: the embedding rows, the att partials, the ffn partials and gates.
enum Exchange : int { X_EMB, X_ATT, X_FFN };
constexpr int kFlagStep = 0;    // the card's step counter
constexpr int kFlagBase = 16;   // flag (x, shard j) at kFlagBase + x * kMaxShards + j
constexpr int kFlagWords = 64;
constexpr unsigned long long kWaitNs = 20000000000ull;  // a wait this long traps

enum ShardPtr : int {
  D_EMB, D_LN0_W, D_LN0_B, D_LN1_W, D_LN1_B, D_LN2_W, D_LN2_B,
  D_ATT_MIX_K, D_ATT_MIX_V, D_ATT_MIX_R, D_FFN_MIX_K, D_FFN_MIX_R,
  D_ATT_K_W, D_ATT_K_S, D_ATT_K_O, D_ATT_V_W, D_ATT_V_S, D_ATT_V_O,
  D_ATT_R_W, D_ATT_R_S, D_ATT_R_O, D_ATT_O_W, D_ATT_O_S, D_ATT_O_O,
  D_FFN_K_W, D_FFN_K_S, D_FFN_K_O, D_FFN_V_W, D_FFN_V_S, D_FFN_V_O,
  D_FFN_R_W, D_FFN_R_S, D_FFN_R_O,
  D_LN_OUT_W, D_LN_OUT_B, D_HEAD_W, D_HEAD_S, D_HEAD_O,
  D_DECAY, D_BONUS,
  D_AA, D_BB, D_PP, D_AA_OUT, D_BB_OUT, D_PP_OUT,
  D_COUNT
};

// The matrix families in the order of rwkv_decode_stack_tp()'s halves[].
enum Fam : int { H_K, H_V, H_R, H_O, H_FK, H_FV, H_FR, H_HEAD, H_COUNT };

constexpr int kTpPhases = 4;  // per layer: A, B, C, D; then H
constexpr int kHead = 4;      // the kind of phase H
constexpr int kMaxFams = 2;   // matrix families of one phase (D: value and gate)

// tp: the row's shards; nloc: the shards this launch runs (tp on one device,
// 1 across cards), the first of them shard `me`; cards: across cards.
struct TpArgs {
  void* p[S_COUNT + kMaxShards * D_COUNT];
  int tp, nloc, me, cards, L, B, E, El, Fl, Vl, n_emb;
  int halves[H_COUNT];
  long long partial_cap;  // floats of split-K partials a shard
  int counter_cap;        // split-K counters a shard
};

__device__ __forceinline__ float* tp_f(const TpArgs& a, int i) {
  return static_cast<float*>(a.p[i]);
}

__device__ __forceinline__ double* tp_d(const TpArgs& a, int i) {
  return static_cast<double*>(a.p[i]);
}

// local shard j's pointer i
__device__ __forceinline__ void* tp_shard(const TpArgs& a, int j, int i) {
  return a.p[S_COUNT + j * D_COUNT + i];
}

// Across cards: the peer stores of exchange kind k (K_APART, K_VPART, K_GATE)
// into q.peer, every card's but this one's.
__device__ __forceinline__ void tp_peers(QmvArgs& q, const TpArgs& a, int k) {
  if (!a.cards) return;
  void* const* t = static_cast<void* const*>(a.p[S_PEERS]) + k * kMaxShards;
  int n = 0;
  for (int c = 0; c < a.tp; ++c)
    if (c != a.me) q.peer[n++] = static_cast<float*>(t[c]);
  q.n_peer = n;
}

// The matvec of family f, shard j, in phase `kind` (0..3: A..D, kHead: H)
// of layer l, written into q (shared memory, by one thread). offs_sm: the
// folded mixes' rank-1 terms in shared memory, [3, B].
template <int FMT>
__device__ void tp_phase_args(QmvArgs& q, const TpArgs& a, int l, int kind, int f, int j,
                              double* offs_sm) {
  const int B = a.B, E = a.E, El = a.El, Fl = a.Fl, g = a.me + j;  // g: the shard
  const bool q4 = FMT == kQ4;
  auto sf = [&](int i) { return static_cast<float*>(tp_shard(a, j, i)); };
  auto sw = [&](int i, size_t K, size_t O) {  // layer l of a [L, K, O] weight
    return static_cast<const int8_t*>(tp_shard(a, j, i)) + l * (K * O / (q4 ? 2 : 1));
  };
  const int tiles_el = (El + kTileO - 1) / kTileO, tiles_fl = (Fl + kTileO - 1) / kTileO;
  double* att_parts = tp_d(a, S_OFF_PARTS) + (size_t)j * (tiles_el + tiles_fl) * B;
  double* val_parts = att_parts + (size_t)tiles_el * B;
  const size_t lE = (size_t)l * E, lEl = (size_t)l * El, lFl = (size_t)l * Fl;

  q = QmvArgs{};
  q.B = B;
  q.nmat = 1;
  q.partial = tp_f(a, S_PARTIAL) + (size_t)j * a.partial_cap + (f ? a.partial_cap / 2 : 0);
  q.counters = static_cast<int*>(a.p[S_COUNTERS]) + (size_t)j * a.counter_cap +
               (f ? a.counter_cap / 2 : 0);
  auto mat = [&](Mat& t, const float* x, const float* s, const double* off, int n_off,
                 const int8_t* w, int K, int fam) {
    t.x = x;
    t.scale = s;
    t.off = off;
    t.n_off = n_off;
    t.w = w;
    t.K = K;
    t.half = q4 ? a.halves[fam] : 0;
  };
  if (kind == 0) {  // A: k, v, r of the folded ln1 mixes, then the WKV step
    const int ws[3] = {D_ATT_K_W, D_ATT_V_W, D_ATT_R_W}, ss[3] = {D_ATT_K_S, D_ATT_V_S, D_ATT_R_S};
    q.nmat = 3;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      mat(q.m[m], nullptr, sf(ss[m]) + lE, offs_sm + (size_t)m * B, 1, sw(ws[m], E, El), E, H_K + m);
    q.O = El;
    q.epi = EPI_WKV;
    q.out = tp_f(a, S_RWKV) + (size_t)j * B * El;
    const size_t lBEl = (size_t)l * B * El;
    q.aa_in = sf(D_AA) + lBEl;
    q.bb_in = sf(D_BB) + lBEl;
    q.pp_in = sf(D_PP) + lBEl;
    q.aa_out = sf(D_AA_OUT) + lBEl;
    q.bb_out = sf(D_BB_OUT) + lBEl;
    q.pp_out = sf(D_PP_OUT) + lBEl;
    q.decay = sf(D_DECAY) + lEl;
    q.bonus = sf(D_BONUS) + lEl;
    q.next_offset = sf(D_ATT_O_O) + lEl;  // the shard's slice of att.output's offset
    q.next_off = att_parts;
  } else if (kind == 1) {  // B: the shard's out-projection partial
    mat(q.m[0], tp_f(a, S_RWKV) + (size_t)j * B * El, sf(D_ATT_O_S) + lEl, att_parts, tiles_el,
        sw(D_ATT_O_W, El, E), El, H_O);
    q.O = E;
    q.epi = EPI_STORE;
    q.out = tp_f(a, S_APART) + (size_t)g * B * E;
    tp_peers(q, a, K_APART);
  } else if (kind == 2) {  // C: relu(key)^2 of the folded ln2 mix
    mat(q.m[0], nullptr, sf(D_FFN_K_S) + lE, offs_sm, 1, sw(D_FFN_K_W, E, Fl), E, H_FK);
    q.O = Fl;
    q.epi = EPI_RELU2;
    q.out = tp_f(a, S_KK) + (size_t)j * B * Fl;
    q.next_offset = sf(D_FFN_V_O) + lFl;
    q.next_off = val_parts;
  } else if (kind == 3 && f == 1) {  // D: the gate, sigmoid(receptance) of C's mix
    mat(q.m[0], tp_f(a, S_FR), sf(D_FFN_R_S) + lE, tp_d(a, S_FR_OFF), 1,
        sw(D_FFN_R_W, E, El), E, H_FR);
    q.O = El;
    q.epi = EPI_SIGMOID;
    q.out = tp_f(a, S_GATE) + (size_t)g * B * El;
    tp_peers(q, a, K_GATE);
  } else if (kind == 3) {  // D: the shard's value partial
    mat(q.m[0], tp_f(a, S_KK) + (size_t)j * B * Fl, sf(D_FFN_V_S) + lFl, val_parts, tiles_fl,
        sw(D_FFN_V_W, Fl, E), Fl, H_FV);
    q.O = E;
    q.epi = EPI_STORE;
    q.out = tp_f(a, S_VPART) + (size_t)g * B * E;
    tp_peers(q, a, K_VPART);
  } else {  // H: the shard's head columns of ln_out(x), its rank-1 term folded
    mat(q.m[0], nullptr, sf(D_HEAD_S), offs_sm, 1, static_cast<const int8_t*>(tp_shard(a, j, D_HEAD_W)),
        E, H_HEAD);
    q.O = a.Vl;
    q.epi = EPI_STORE;
    q.out = tp_f(a, S_LOGITS) + (size_t)j * B * a.Vl;
  }
}

// The fold source of phase A (kind 0), C (2) or H (kHead) of layer l,
// written into src (shared memory, by one thread). The replicated vectors
// (norms, mixes, the column families' offsets) are local shard 0's.
template <int BT>
__device__ void tp_fold_src(FoldSrc<BT, false, true>& src, const TpArgs& a, int l, int kind) {
  auto s0 = [&](int i) { return static_cast<const float*>(tp_shard(a, 0, i)); };
  const bool att = kind == 0, head = kind == kHead, first = att && l == 0;
  const size_t lE = (size_t)l * a.E, lBE = (size_t)l * a.B * a.E;
  src.E = a.E;
  src.B = a.B;
  src.tp = a.tp;
  src.El = a.El;
  src.n_emb = a.n_emb;
  src.cached = -1;
  src.head = head;
  src.nfold = att ? 3 : 1;
  src.nmix = att ? 3 : (head ? 1 : 2);
  src.tokens = first ? static_cast<const int*>(a.p[S_TOKENS]) : nullptr;
  src.emb = nullptr;
  for (int p = 0; p < a.nloc; ++p) src.embs[p] = static_cast<const float*>(tp_shard(a, p, D_EMB));
  src.emb_slots = a.cards ? tp_f(a, S_EMB_SLOTS) : nullptr;
  src.ln0_w = s0(D_LN0_W);
  src.ln0_b = s0(D_LN0_B);
  src.resid = tp_f(a, first ? S_X_IN : (kind == 2 ? S_X_MID : S_X));
  src.add = first ? nullptr : tp_f(a, kind == 2 ? S_APART : S_VPART);
  src.gate = first || kind == 2 ? nullptr : tp_f(a, S_GATE);
  src.resid_out = head ? nullptr : tp_f(a, att ? S_X_MID : S_X);
  src.ln_w = head ? s0(D_LN_OUT_W) : s0(att ? D_LN1_W : D_LN2_W) + lE;
  src.ln_b = head ? s0(D_LN_OUT_B) : s0(att ? D_LN1_B : D_LN2_B) + lE;
  src.prev = head ? nullptr : tp_f(a, att ? S_XY_IN : S_DD_IN) + lBE;
  src.prev_out = head ? nullptr : tp_f(a, att ? S_XY_OUT : S_DD_OUT) + lBE;
  for (int m = 0; m < 3; ++m) {
    src.mix[m] = nullptr;
    src.offset[m] = nullptr;
    src.qscale[m] = nullptr;
  }
  if (att) {
    src.mix[0] = s0(D_ATT_MIX_K) + lE;
    src.mix[1] = s0(D_ATT_MIX_V) + lE;
    src.mix[2] = s0(D_ATT_MIX_R) + lE;
    src.offset[0] = s0(D_ATT_K_O) + lE;
    src.offset[1] = s0(D_ATT_V_O) + lE;
    src.offset[2] = s0(D_ATT_R_O) + lE;
  } else if (!head) {
    src.mix[0] = s0(D_FFN_MIX_K) + lE;
    src.mix[1] = s0(D_FFN_MIX_R) + lE;
    src.offset[0] = s0(D_FFN_K_O) + lE;
    src.offset[1] = s0(D_FFN_R_O) + lE;
  } else {
    src.offset[0] = s0(D_HEAD_O);
  }
  src.fr_out = kind == 2 ? tp_f(a, S_FR) : nullptr;
  src.fr_off = kind == 2 ? tp_d(a, S_FR_OFF) : nullptr;
  src.fr_amax = nullptr;
}

// The plan of decode_stack_tp_kernel's phase loop (stack.cuh's
// stack_phases): threads 0 .. nfam * nloc - 1 describe one (family, shard)
// matvec each, thread 32 the fold source, at once; then every thread
// deals the items: family 0's, then family 1's, each shard-major. Across
// cards, after_barrier completes the exchange of the phase that ended.
template <int BT, int FMT>
struct TpPlan {
  using Fold = FoldSrc<BT, false, true>;
  const TpArgs& a;
  QmvArgs* qs;  // shared: [kMaxFams * nloc], family-major
  Fold& s;      // shared
  float* xx;
  double* offs;
  float* amax;
  float* ascratch;
  float* fscratch;
  Stamps stamps;
  unsigned long long step;  // across cards: the card's step counter at the launch
  int done;                 // barriers passed
  // the families' column tiles, splits and items (scalars: an array indexed
  // by the family would live in local memory)
  int kind, nfam, tiles0, tiles1, S0, S1, n0, n1;

  __device__ __forceinline__ void describe(int ph) {
    const int tid = threadIdx.x, nloc = a.nloc, l = ph / kTpPhases;
    kind = l < a.L ? ph % kTpPhases : kHead;
    nfam = kind == 3 ? 2 : 1;
    if (tid < nfam * nloc) tp_phase_args<FMT>(qs[tid], a, l, kind, tid / nloc, tid % nloc, offs);
    if (tid == 32 && fold()) {
      tp_fold_src<BT>(s, a, l, kind);
      s.xx = xx;
      s.offs = offs;
      s.amax = amax;
      s.ascratch = ascratch;
      s.fscratch = fscratch;
    }
    __syncthreads();
    // phase D: the blocks dealt to the value and the gate by their weight
    // bytes, each family within half the scratch
    const int G = gridDim.x;
    auto bytes = [](const QmvArgs& q) { return (long long)qmv_kmax<FMT>(q) * q.O; };
    const int g0 = nfam == 1 ? G
                             : max(1, min(G - 1, (int)(G * bytes(qs[0]) /
                                                       (bytes(qs[0]) + bytes(qs[nloc])))));
    const long long cap = nfam == 1 ? a.partial_cap : a.partial_cap / 2;
    const int cc = nfam == 1 ? a.counter_cap : a.counter_cap / 2;
    auto split = [&](const QmvArgs& q, int g, int& tiles, int& S, int& n) {
      tiles = (q.O + kTileO - 1) / kTileO;
      S = stack_split(nloc * tiles, qmv_kmax<FMT>(q), q.nmat, a.B, q.O, cap, nloc * cc, g);
      n = nloc * tiles * S;
    };
    split(qs[0], g0, tiles0, S0, n0);
    tiles1 = S1 = 1;
    n1 = 0;
    if (nfam == 2) split(qs[nloc], G - g0, tiles1, S1, n1);
  }
  __device__ __forceinline__ int items() const { return n0 + n1; }
  __device__ __forceinline__ bool fold() const { return kind == 0 || kind == 2 || kind == kHead; }
  __device__ __forceinline__ const QmvArgs& item(int it, int& tile, int& sp, int& Sp) const {
    const bool f = it >= n0;
    const int S = f ? S1 : S0, r = it - (f ? n0 : 0), per = (f ? tiles1 : tiles0) * S;
    const int j = r / per, rt = r - j * per;
    tile = rt / S;
    sp = rt % S;
    Sp = S;
    return qs[(f ? a.nloc : 0) + j];
  }
  // the first item writes this block's share of the rows' outputs, block 0
  // the receptance mix's rank-1 term
  __device__ __forceinline__ void fold_item(int, int r) {
    const int G = gridDim.x, total = items(), writers = total < G ? total : G;
    const int chunk = (a.E + writers - 1) / writers;
    if (threadIdx.x == 0) {
      s.lo = r == 0 ? min(a.E, (int)blockIdx.x * chunk) : 0;
      s.hi = r == 0 ? min(a.E, s.lo + chunk) : 0;
      if (r || blockIdx.x) s.fr_off = nullptr;
    }
    __syncthreads();
  }
  __device__ __forceinline__ const Fold& src() const { return s; }
  __device__ __forceinline__ void prefetch() const {
    for (int i = 0; i < nfam * a.nloc; ++i) prefetch_qmv(qs[i]);
    if (fold()) prefetch_fold(s);
  }
  __device__ __forceinline__ void stamp() { stamps(); }

  // Across cards: block 0 sets this shard's flag of exchange x to `epoch` on
  // every card; then every block waits until the other shards' flags reach
  // it, and block 0 stamps the wait's end at entry `at`.
  __device__ __forceinline__ void exchange(int x, unsigned long long epoch, int at) {
    void* const* t = static_cast<void* const*>(a.p[S_PEERS]) + K_FLAGS * kMaxShards;
    const int slot = kFlagBase + x * kMaxShards;
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0)
        for (int c = 0; c < a.tp; ++c)
          st_release_sys(static_cast<unsigned long long*>(t[c]) + slot + a.me, epoch);
      const unsigned long long* mine = static_cast<const unsigned long long*>(a.p[S_FLAGS]) + slot;
      const unsigned long long t0 = globaltimer();
      for (int c = 0; c < a.tp; ++c)
        while (c != a.me && ld_acquire_sys(mine + c) < epoch)
          if (globaltimer() - t0 > kWaitNs) __trap();
    }
    __syncthreads();
    stamps.at(at);
  }

  // After the barrier that ends phase `done`: across cards, phases B and D
  // complete their exchanges (the att partials; the ffn partials and gates).
  __device__ __forceinline__ void after_barrier() {
    stamps();
    const int ph = done++, l = ph / kTpPhases, k = ph % kTpPhases;
    if (!a.cards || l >= a.L || (k != 1 && k != 3)) return;
    exchange(k == 1 ? X_ATT : X_FFN, step * a.L + l + 1, 4 * a.L + 3 + 2 * l + (k == 3));
  }
};

// Across cards, at B <= 8: this shard's embedding rows of the batch's tokens
// (zero for a token outside its vocab) into its slot on every card, then the
// exchange, so that phase A of layer 0 sums the tp slots in shard order.
template <int BT, int FMT>
__device__ void push_embedding(const TpArgs& a, GridBarrier& bar, TpPlan<BT, FMT>& plan) {
  const int E4 = a.E / 4, total = a.B * E4;
  const float4* emb = static_cast<const float4*>(tp_shard(a, 0, D_EMB));
  const int* tokens = static_cast<const int*>(a.p[S_TOKENS]);
  void* const* t = static_cast<void* const*>(a.p[S_PEERS]) + K_EMB * kMaxShards;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    const int b = i / E4, k4 = i - b * E4, rel = tokens[b] - a.me * a.n_emb;
    const float4 e = rel >= 0 && rel < a.n_emb ? emb[(size_t)rel * E4 + k4]
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < a.tp; ++c) static_cast<float4*>(t[c])[i] = e;
  }
  __threadfence_system();
  bar.sync();
  plan.exchange(X_EMB, plan.step + 1, 4 * a.L + 2);
}

// One block a SM, as the unsharded stack (decode_stack.cu says why).
template <int BT, int FMT>
__global__ void __launch_bounds__(kThreads, 1) decode_stack_tp_kernel(const __grid_constant__ TpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ascratch[3 * BT * 33];
  __shared__ float fscratch[3 * BT * 33];
  __shared__ QmvArgs qs[kMaxFams * kMaxShards];
  __shared__ FoldSrc<BT, false, true> src;
  StackSmem<BT, FMT> m;
  m.carve(smem, a.E, a.B);
  GridBarrier bar;
  bar.init(static_cast<unsigned*>(a.p[S_COUNTERS]) + (size_t)a.nloc * a.counter_cap, gridDim.x);
  unsigned long long* flags = static_cast<unsigned long long*>(a.p[S_FLAGS]);
  TpPlan<BT, FMT> plan{a, qs, src, m.xx, m.offs, m.amax, ascratch, fscratch,
                       Stamps{static_cast<unsigned long long*>(a.p[S_STAMPS]), 0},
                       a.cards ? __ldcg(flags + kFlagStep) : 0ull, 0};
  plan.stamp();
  if (a.cards && a.p[S_TOKENS]) push_embedding<BT, FMT>(a, bar, plan);
  stack_phases<BT, FMT>(plan, kTpPhases * a.L + 1, false, bar, *m.sm, m.wsm);
  if (bar.finish() && a.cards) flags[kFlagStep] = plan.step + 1;  // read by the next launch
  plan.stamp();
}

template <int FMT>
cudaError_t launch_tp_fmt(const TpArgs& a, cudaStream_t st, int* grid) {
  const int bt = stack_bt(a.B);
#define RWKV_LAUNCH(BT_) \
  coop_launch(decode_stack_tp_kernel<BT_, FMT>, a, stack_smem<BT_, FMT>(a.E, a.B), st, grid)
  if (bt == 1) return RWKV_LAUNCH(1);
  if (bt == 2) return RWKV_LAUNCH(2);
  return RWKV_LAUNCH(4);
#undef RWKV_LAUNCH
}

}  // namespace rwkv

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rwkv_decode_stack_tp_shared_count() { return S_COUNT; }
extern "C" int rwkv_decode_stack_tp_shard_count() { return D_COUNT; }
extern "C" int rwkv_decode_stack_tp_max_shards() { return kMaxShards; }
extern "C" int rwkv_decode_stack_tp_barrier_words() { return kBarrierWords; }
extern "C" int rwkv_decode_stack_tp_flag_words() { return kFlagWords; }
extern "C" int rwkv_decode_stack_tp_peer_kinds() { return K_COUNT; }

// Lets device `dev` read and write device `peer`'s memory (K7 across cards:
// its peer stores); already enabled is no error. The current device is kept.
extern "C" int rwkv_enable_peer(int dev, int peer) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) e = cudaSuccess;
  cudaGetLastError();  // nothing left behind for the next launch's check
  const cudaError_t back = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : back);
}

// Across processes: the receive slots and flags of one card, one cudaMalloc
// region of the caller's size, zeroed, and its IPC handle (64 bytes) in
// *handle. The region is this library's own, not a caching allocator's, so
// the handle names exactly it. The current device is the card's.
extern "C" int rwkv_ipc_alloc(long long bytes, void** ptr, void* handle) {
  *ptr = nullptr;
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  if (e != cudaSuccess) {
    cudaGetLastError();
    if (*ptr) cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)e;
}

// Maps another process's region (its rwkv_ipc_alloc handle) into this one,
// on the current device, peer access enabled as the mapping needs it.
extern "C" int rwkv_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  const cudaError_t e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// Unmaps a region rwkv_ipc_open mapped; every importer does this before the
// exporter frees it (rwkv_ipc_free).
extern "C" int rwkv_ipc_close(void* ptr) {
  const cudaError_t e = cudaIpcCloseMemHandle(ptr);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

extern "C" int rwkv_ipc_free(void* ptr) {
  const cudaError_t e = cudaFree(ptr);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

extern "C" int rwkv_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// Blocks of the step's launch at batch B and width E, in *grid: q4 selects
// the instantiation. Returns the first CUDA error (0 if none).
extern "C" int rwkv_decode_stack_tp_grid(int B, int E, int q4, int* grid) {
  const int bt = stack_bt(B);
  cudaError_t e = cudaErrorInvalidValue;
#define RWKV_GRID(BT_, F_) \
  if (bt == BT_ && (q4 ? kQ4 : kQ8) == F_) \
    e = coop_grid(decode_stack_tp_kernel<BT_, F_>, stack_smem<BT_, F_>(E, B), grid)
  RWKV_GRID(1, kQ8); RWKV_GRID(2, kQ8); RWKV_GRID(4, kQ8);
  RWKV_GRID(1, kQ4); RWKV_GRID(2, kQ4); RWKV_GRID(4, kQ4);
#undef RWKV_GRID
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// Enqueues one decode step of the tp shards of a data row on `stream` as one
// cooperative launch of the current device; across cards (cards != 0), the
// step of shard `me` alone, whose peers' launches the caller enqueues on
// theirs. With tokens (S_TOKENS not null) layer 0 gathers the embedding rows;
// else x_in [B, E] is x after ln0. q4: the weights are nibble-packed and
// halves[8] gives half the pairing block of each family (enum Fam), in rows.
// partial_cap and counter_cap are each local shard's share of the split-K
// scratch (S_COUNTERS holds nloc * counter_cap + kBarrierWords ints, zero
// before the first call; across cards S_FLAGS holds kFlagWords u64, zero
// before the first call on every card of the row). Returns the first CUDA
// error (0 if none), the number of kernels launched in *n_launched (1, or 0
// on an error) and the launch's blocks in *grid.
extern "C" int rwkv_decode_stack_tp(void* const* p, int n_ptrs, int tp, int me, int cards, int L,
                                    int B, int E, int El, int Fl, int Vl, int n_emb, int q4,
                                    const int* halves, long long partial_cap, int counter_cap,
                                    void* stream, int* n_launched, int* grid) {
  *n_launched = 0;
  *grid = 0;
  const int nloc = cards ? 1 : tp;
  if (tp < 1 || tp > kMaxShards || n_ptrs != S_COUNT + nloc * D_COUNT || B < 1 || L < 1 ||
      E % 16 || El % 16 || Fl % 16 || Vl % 16 || El * tp != E || counter_cap < 2 ||
      partial_cap < 2 || me < 0 || me >= tp || (!cards && me) ||
      (cards && (!p[S_FLAGS] || !p[S_PEERS] || (p[S_TOKENS] && !p[S_EMB_SLOTS]))))
    return (int)cudaErrorInvalidValue;
  TpArgs a = {};
  for (int i = 0; i < n_ptrs; ++i) a.p[i] = p[i];
  a.tp = tp;
  a.nloc = nloc;
  a.me = me;
  a.cards = cards ? 1 : 0;
  a.L = L;
  a.B = B;
  a.E = E;
  a.El = El;
  a.Fl = Fl;
  a.Vl = Vl;
  a.n_emb = n_emb;
  for (int i = 0; i < H_COUNT; ++i) a.halves[i] = q4 ? halves[i] : 0;
  a.partial_cap = partial_cap;
  a.counter_cap = counter_cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = q4 ? launch_tp_fmt<kQ4>(a, st, grid) : launch_tp_fmt<kQ8>(a, st, grid);
  if (e == cudaSuccess) *n_launched = 1;
  return (int)e;
}
