// One tensor-parallel decode step of every model shard of a data row, q8 or
// q4 (kernel K7).
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
// on one card, and one host call, rwkv_decode_stack_tp(), enqueues the whole
// step of all of them on one stream: 7 * L + 2 launches whatever tp is.
//
//   per layer:
//   1. row_kernel ATT : (row.cuh) completes the previous layer's ffn exchange,
//                       x += gate * (vpart[0] + ... + vpart[tp-1]) (layer 0:
//                       the vocab-sharded embedding gather, its sum over the
//                       shards and ln0, or a given x), then ln1 + mix -> the
//                       k/v/r inputs, the new xy
//   2. qmv  k,v,r     : every shard's three column-parallel matvecs on its
//                       E_loc channels + the WKV step on its aa/bb/pp slices
//   3. qmv  output    : every shard's row-parallel out-projection PARTIAL
//                       [B, E], its offset share folded in
//   4. row_kernel FFN : x += apart[0] + ... + apart[tp-1]; ln2 + mix, new dd
//   5. qmv  gate      : every shard's sigmoid(receptance) on its E_loc channels
//   6. qmv  key       : every shard's relu(key)^2 on its F_loc channels
//   7. qmv  value     : every shard's row-parallel value PARTIAL [B, E]
//   then one row_kernel HEAD (the last ffn exchange, ln_out, the head's
//   scaled input and offset term) and one qmv over every shard's V_loc head
//   columns: the local logits, no logit bias (the caller adds its slice and
//   gathers them).
//
// The exchange. Each matvec launch's grid is (column tiles, split, shard):
// the shards run at once, each with its own split-K partials, counters and
// output slices, so nothing is shared between them but the inputs they read.
// The launch order on the stream is the barrier between the producers of the
// partials and their consumer: the next row kernel reads the tp partials in
// the fixed order 0..tp-1, as the JAX kernel sums the received chunks in
// sender order, so every shard's x is the same bits. The replicated state
// (x, xy, dd, and the column families' inputs and offset terms) is computed
// once per data row by the row kernel, never as racing identical stores: the
// row kernels read shard 0's replicated vectors. A row-parallel family's
// rank-1 offset term is the sum over its shard's contraction slice, which the
// producing epilogue leaves per column tile (next_off), so each shard's
// partial carries its share and the sum of partials is the partial of the sum.
//
// q4 (kernel K7 over packed weights): the same launches through qmv.cuh's Q4
// instantiation. The column families and the head pair rows globally over
// K = E; att.output and ffn.value pair within their block, which lies whole
// inside a shard (halves[] below).
//
// Bound on the card: the weight bytes of all shards per step, read once,
// over device memory bandwidth: at 430M, 379 MB in q8 and 189.5 MB in q4,
// head included: 0.113 and 0.057 ms on a 3.35 TB/s card. The launch design
// does what K1 does about it (qmv.cuh: every weight byte read once, the
// contraction split so that a launch fills the card, the launches of a step
// from one host call); the shards share each launch's blocks, so at tp > 1
// a launch covers the shards' slices at once, not tp launches one after the
// other.
//
// Left for a machine with two or more GPUs: the shards of a data row on
// distinct cards. The exchanges then cross cards: NCCL collectives between
// launches, or peer stores from the producing epilogues with a flag per
// shard; and a persistent kernel with grid-wide barriers would take the
// launch boundaries out. The wrapper refuses such a row.
#include "row.cuh"

namespace rwkv {

// Positions in the pointer table passed by rwkv_tpu_torch/ops/cuda/decode_stack_tp.py
// (_SHARED and _SHARD there list the same names in the same order): the
// data row's pointers, then tp blocks of one shard's.
enum SharedPtr : int {
  S_TOKENS, S_X_IN, S_X, S_XK, S_XV, S_XR, S_FK, S_FR, S_XS_H, S_OFF_H,
  S_OFFS,       // [5, B] double: rank-1 terms of k, v, r, ffn key, ffn receptance
  S_XY_IN, S_DD_IN, S_XY_OUT, S_DD_OUT,
  S_APART, S_VPART,  // [tp, B, E] partials
  S_GATE, S_RWKV,    // [tp, B, E_loc]
  S_KK,              // [tp, B, F_loc]
  S_OFF_PARTS,  // [tp, E_loc / 128 + F_loc / 128, B] double: per-tile offset shares
  S_LOGITS,     // [tp, B, V_loc]
  S_PARTIAL, S_COUNTERS,  // tp times partial_cap floats, counter_cap ints
  S_COUNT
};

enum ShardPtr : int {
  D_EMB, D_LN0_W, D_LN0_B, D_LN1_W, D_LN1_B, D_LN2_W, D_LN2_B,
  D_MIX_K, D_MIX_V, D_MIX_R, D_FMIX_K, D_FMIX_R,
  D_K_W, D_K_S, D_K_O, D_V_W, D_V_S, D_V_O, D_R_W, D_R_S, D_R_O, D_O_W, D_O_S, D_O_O,
  D_FK_W, D_FK_S, D_FK_O, D_FV_W, D_FV_S, D_FV_O, D_FR_W, D_FR_S, D_FR_O,
  D_LN_OUT_W, D_LN_OUT_B, D_HEAD_W, D_HEAD_S, D_HEAD_O,
  D_DECAY, D_BONUS,
  D_AA_IN, D_BB_IN, D_PP_IN, D_AA_OUT, D_BB_OUT, D_PP_OUT,
  D_COUNT
};

// The matrix families in the order of rwkv_decode_stack_tp()'s halves[].
enum Fam : int { H_K, H_V, H_R, H_O, H_FK, H_FV, H_FR, H_HEAD, H_COUNT };

struct Step {
  void* const* p;
  int tp, B, E, El, Fl, Vl, q4;
  const int* halves;
  long long partial_cap;
  int counter_cap, target_blocks;
  cudaStream_t st;
  int* n_launched;

  float* f(int i) const { return static_cast<float*>(p[i]); }
  double* d(int i) const { return static_cast<double*>(p[i]); }
  // shard j's pointer i
  float* sf(int j, int i) const { return static_cast<float*>(p[S_COUNT + j * D_COUNT + i]); }
  const int8_t* sw(int j, int i) const {
    return static_cast<const int8_t*>(p[S_COUNT + j * D_COUNT + i]);
  }
  // weight bytes of a [K, O] layer matrix: q4 packs two codes a byte
  size_t wbytes(size_t K, size_t O) const { return K * O / (q4 ? 2 : 1); }
  // shard j's offset shares: att.output's [El / 128, B], then ffn.value's
  double* att_parts(int j) const {
    const int tiles = (El + kTileO - 1) / kTileO + (Fl + kTileO - 1) / kTileO;
    return d(S_OFF_PARTS) + (size_t)j * tiles * B;
  }
  double* val_parts(int j) const { return att_parts(j) + (size_t)((El + kTileO - 1) / kTileO) * B; }

  QmvArgs qmv(int j, int nmat, int O, int epi, float* out) const {
    QmvArgs q = {};
    q.nmat = nmat;
    q.B = B;
    q.O = O;
    q.epi = epi;
    q.out = out;
    q.partial = f(S_PARTIAL) + (size_t)j * partial_cap;
    q.counters = static_cast<int*>(p[S_COUNTERS]) + (size_t)j * counter_cap;
    return q;
  }
  Mat mat(const float* x, const float* s, const double* off, int n_off, const int8_t* w, int K,
          int fam) const {
    Mat m = {};
    m.x = x;
    m.scale = s;
    m.off = off;
    m.n_off = n_off;
    m.w = w;
    m.K = K;
    m.half = q4 ? halves[fam] : K / 2;
    return m;
  }
  RowArgs row(int mode) const {
    RowArgs r = {};
    r.mode = mode;
    r.B = B;
    r.E = E;
    r.x = f(S_X);
    r.tp = tp;
    r.El = El;
    return r;
  }
  int done(cudaError_t e) const {  // after each launch
    ++*n_launched;
    return (int)e;
  }
  int rows(const RowArgs& r) const { return done(launch_rows<false>(r, st)); }
  int matvec(const QmvShards& q) const {
    return done(q4 ? launch_qmv_shards<kQ4>(q, tp, partial_cap, counter_cap, target_blocks, st)
                   : launch_qmv_shards<kQ8>(q, tp, partial_cap, counter_cap, target_blocks, st));
  }
};

}  // namespace rwkv

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rwkv_decode_stack_tp_shared_count() { return S_COUNT; }
extern "C" int rwkv_decode_stack_tp_shard_count() { return D_COUNT; }
extern "C" int rwkv_decode_stack_tp_max_shards() { return kMaxShards; }

// Enqueues one decode step of the tp shards of a data row on `stream`: 7 * L
// + 2 launches. With tokens (S_TOKENS not null) layer 0 gathers the
// embedding rows; else x_in [B, E] is x after ln0. q4: the weights are
// nibble-packed and halves[8] gives half the pairing block of each family
// (enum Fam), in rows. partial_cap, counter_cap and target_blocks are each
// shard's share of the split-K scratch and of the card's blocks. Returns the
// first CUDA error (0 if none) and the launch count in *n_launched.
extern "C" int rwkv_decode_stack_tp(void* const* p, int n_ptrs, int tp, int L, int B, int E,
                                    int El, int Fl, int Vl, int n_emb, int q4,
                                    const int* halves, long long partial_cap, int counter_cap,
                                    int target_blocks, void* stream, int* n_launched) {
  *n_launched = 0;
  if (tp < 1 || tp > kMaxShards || n_ptrs != S_COUNT + tp * D_COUNT || B < 1 || E % 16 ||
      El % 16 || Fl % 16 || Vl % 16 || El * tp != E)
    return (int)cudaErrorInvalidValue;
  const Step g = {p, tp, B, E, El, Fl, Vl, q4, halves, partial_cap, counter_cap,
                  target_blocks, static_cast<cudaStream_t>(stream), n_launched};
  const size_t BE = (size_t)B * E, BEl = (size_t)B * El, BFl = (size_t)B * Fl;
  const int tiles_el = (El + kTileO - 1) / kTileO, tiles_fl = (Fl + kTileO - 1) / kTileO;
  double* offs = g.d(S_OFFS);
  int err;

  for (int l = 0; l < L; ++l) {
    const size_t lE = (size_t)l * E, lEl = (size_t)l * El, lFl = (size_t)l * Fl;
    const size_t lBE = (size_t)l * BE, lBEl = (size_t)l * BEl;

    // 1. the previous layer's ffn exchange (or the embedding), ln1 + mix
    RowArgs ra = g.row(ROW_ATT);
    if (l == 0) {
      ra.tokens = static_cast<const int*>(p[S_TOKENS]);
      ra.x_in = ra.tokens ? nullptr : g.f(S_X_IN);
      ra.n_emb = n_emb;
      for (int j = 0; j < tp; ++j) ra.embs[j] = g.sf(j, D_EMB);
      ra.ln0_w = g.sf(0, D_LN0_W);
      ra.ln0_b = g.sf(0, D_LN0_B);
    } else {
      ra.add = g.f(S_VPART);
      ra.gate = g.f(S_GATE);
    }
    ra.ln_w = g.sf(0, D_LN1_W) + lE;
    ra.ln_b = g.sf(0, D_LN1_B) + lE;
    ra.prev = g.f(S_XY_IN) + lBE;
    ra.prev_out = g.f(S_XY_OUT) + lBE;
    const int mixes[3] = {D_MIX_K, D_MIX_V, D_MIX_R};
    const int mixed[3] = {S_XK, S_XV, S_XR};
    const int offsets[3] = {D_K_O, D_V_O, D_R_O};
    for (int j = 0; j < 3; ++j) {
      ra.mix[j] = g.sf(0, mixes[j]) + lE;
      ra.mixed[j] = g.f(mixed[j]);
      ra.offset[j] = g.sf(0, offsets[j]) + lE;
      ra.off[j] = offs + (size_t)j * B;
    }
    ra.nmix = 3;
    if ((err = g.rows(ra))) return err;

    // 2. k, v, r on each shard's El channels, then the WKV step on its slices
    QmvShards q;
    const int ws[3] = {D_K_W, D_V_W, D_R_W}, ss[3] = {D_K_S, D_V_S, D_R_S};
    for (int s = 0; s < tp; ++s) {
      QmvArgs& a = q.s[s];
      a = g.qmv(s, 3, El, EPI_WKV, g.f(S_RWKV) + s * BEl);
      for (int j = 0; j < 3; ++j)
        a.m[j] = g.mat(g.f(mixed[j]), g.sf(s, ss[j]) + lE, offs + (size_t)j * B, 1,
                       g.sw(s, ws[j]) + l * g.wbytes(E, El), E, H_K + j);
      a.aa_in = g.sf(s, D_AA_IN) + lBEl;
      a.bb_in = g.sf(s, D_BB_IN) + lBEl;
      a.pp_in = g.sf(s, D_PP_IN) + lBEl;
      a.aa_out = g.sf(s, D_AA_OUT) + lBEl;
      a.bb_out = g.sf(s, D_BB_OUT) + lBEl;
      a.pp_out = g.sf(s, D_PP_OUT) + lBEl;
      a.decay = g.sf(s, D_DECAY) + lEl;
      a.bonus = g.sf(s, D_BONUS) + lEl;
      a.next_offset = g.sf(s, D_O_O) + lEl;  // the shard's slice of att.output's offset
      a.next_off = g.att_parts(s);
    }
    if ((err = g.matvec(q))) return err;

    // 3. each shard's out-projection partial, its offset share folded in
    for (int s = 0; s < tp; ++s) {
      QmvArgs& a = q.s[s];
      a = g.qmv(s, 1, E, EPI_STORE, g.f(S_APART) + s * BE);
      a.m[0] = g.mat(g.f(S_RWKV) + s * BEl, g.sf(s, D_O_S) + lEl, g.att_parts(s), tiles_el,
                     g.sw(s, D_O_W) + l * g.wbytes(El, E), El, H_O);
    }
    if ((err = g.matvec(q))) return err;

    // 4. the att exchange, ln2 + mix
    RowArgs rf = g.row(ROW_FFN);
    rf.add = g.f(S_APART);
    rf.ln_w = g.sf(0, D_LN2_W) + lE;
    rf.ln_b = g.sf(0, D_LN2_B) + lE;
    rf.prev = g.f(S_DD_IN) + lBE;
    rf.prev_out = g.f(S_DD_OUT) + lBE;
    rf.mix[0] = g.sf(0, D_FMIX_K) + lE;
    rf.mix[1] = g.sf(0, D_FMIX_R) + lE;
    rf.mixed[0] = g.f(S_FK);
    rf.mixed[1] = g.f(S_FR);
    rf.offset[0] = g.sf(0, D_FK_O) + lE;
    rf.offset[1] = g.sf(0, D_FR_O) + lE;
    rf.off[0] = offs + 3 * (size_t)B;
    rf.off[1] = offs + 4 * (size_t)B;
    rf.nmix = 2;
    if ((err = g.rows(rf))) return err;

    // 5. the gate on each shard's El channels (its own launch: O = El)
    for (int s = 0; s < tp; ++s) {
      QmvArgs& a = q.s[s];
      a = g.qmv(s, 1, El, EPI_SIGMOID, g.f(S_GATE) + s * BEl);
      a.m[0] = g.mat(g.f(S_FR), g.sf(s, D_FR_S) + lE, offs + 4 * (size_t)B, 1,
                     g.sw(s, D_FR_W) + l * g.wbytes(E, El), E, H_FR);
    }
    if ((err = g.matvec(q))) return err;

    // 6. relu(key)^2 on each shard's Fl channels, leaving ffn.value's offset shares
    for (int s = 0; s < tp; ++s) {
      QmvArgs& a = q.s[s];
      a = g.qmv(s, 1, Fl, EPI_RELU2, g.f(S_KK) + s * BFl);
      a.m[0] = g.mat(g.f(S_FK), g.sf(s, D_FK_S) + lE, offs + 3 * (size_t)B, 1,
                     g.sw(s, D_FK_W) + l * g.wbytes(E, Fl), E, H_FK);
      a.next_offset = g.sf(s, D_FV_O) + lFl;
      a.next_off = g.val_parts(s);
    }
    if ((err = g.matvec(q))) return err;

    // 7. each shard's value partial
    for (int s = 0; s < tp; ++s) {
      QmvArgs& a = q.s[s];
      a = g.qmv(s, 1, E, EPI_STORE, g.f(S_VPART) + s * BE);
      a.m[0] = g.mat(g.f(S_KK) + s * BFl, g.sf(s, D_FV_S) + lFl, g.val_parts(s), tiles_fl,
                     g.sw(s, D_FV_W) + l * g.wbytes(Fl, E), Fl, H_FV);
    }
    if ((err = g.matvec(q))) return err;
  }

  // the last ffn exchange, ln_out, the head's input and offset term
  RowArgs rh = g.row(ROW_HEAD);
  rh.add = g.f(S_VPART);
  rh.gate = g.f(S_GATE);
  rh.ln_w = g.sf(0, D_LN_OUT_W);
  rh.ln_b = g.sf(0, D_LN_OUT_B);
  rh.head_scale = g.sf(0, D_HEAD_S);
  rh.offset[0] = g.sf(0, D_HEAD_O);
  rh.off_h = g.f(S_OFF_H);
  rh.xs_h = g.f(S_XS_H);
  if ((err = g.rows(rh))) return err;

  // each shard's head columns: its local logits
  QmvShards h;
  for (int s = 0; s < tp; ++s) {
    QmvArgs& a = h.s[s];
    a = g.qmv(s, 1, Vl, EPI_STORE, g.f(S_LOGITS) + (size_t)s * B * Vl);
    a.row_add = g.f(S_OFF_H);
    a.m[0] = g.mat(g.f(S_XS_H), nullptr, nullptr, 0, g.sw(s, D_HEAD_W), E, H_HEAD);
  }
  return g.matvec(h);
}
