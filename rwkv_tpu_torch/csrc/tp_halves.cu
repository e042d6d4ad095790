// One layer's two halves on one tensor-parallel shard (kernel K6): att_half
// and ffn_half, q8 weights.
//
// Replaces rwkv_tpu/ops/pallas/tp_halves.py: att_half (_att_half_kernel) and
// ffn_half (_ffn_half_kernel), reached from the "pallas" body of
// rwkv_tpu/parallel/tp_step.py; here the "halves" body of
// rwkv_tpu_torch/parallel/tp_step.py calls them between its collectives.
//
// A shard of a tp-wide mesh holds E_loc = E / tp channels: column shards
// [E, E_loc] of att key/value/receptance and ffn receptance, [E, F_loc] of ffn
// key (F_loc = F / tp), whose scale/offset vectors [E] are replicated, and
// row shards [E_loc, E] of att.output and [F_loc, E] of ffn.value, whose
// scale/offset vectors are the shard's [E_loc] / [F_loc] slices. Then
//
//   att_half: ln1 + token-shift mix (row kernel, row.cuh; writes the new xy,
//             which is the same on every shard) -> the three column-parallel
//             matvecs on E_loc channels + the WKV step on the shard's
//             aa/bb/pp slices -> sigmoid(r) * y -> the row-parallel
//             out-projection PARTIAL [B, E]: 3 launches;
//   ffn_half: ln2 + mix (row kernel; writes the new dd) -> the gate,
//             sigmoid of the column-parallel receptance on E_loc channels
//             -> relu(key)^2 on F_loc channels -> the row-parallel value
//             PARTIAL [B, E]: 4 launches.
//
// The partials are not added to the residual: the caller sums the shards'
// partials (a psum over the mesh) and adds x + psum(partial) and
// x + gate * psum(vpartial) after the collectives. The rank-1 offset term of
// a row-parallel matrix is the sum over the contracted dim of
// input * offset, so each shard adds its own slice's share into its partial
// (the WKV and relu^2 epilogues leave one share per column tile, from the
// shard's offset slice, as next_off), and the psum of the partials is the
// whole product: a sum of partials is the partial of the sum. The
// column-parallel matrices read the full, replicated input, and their offset
// terms come whole from the row kernel.
//
// Bound on the card: the shard's weight bytes per layer, 4 * E * E_loc for
// att_half and 2 * E * F_loc + E * E_loc for ffn_half (4.19 and 9.44 MB at
// 430M, tp = 1), over device memory bandwidth. The TPU kernel is one launch
// per half whose sequential grid carries its sums in VMEM; here, as in the
// decode stack, the matvecs are separate launches on one stream (the order is
// the dependency), each reading its weights once through qmv.cuh's split-K
// tile (any contraction length: 640 at 14B widths, tp = 8). The gate gets its
// own launch: its O is E_loc, the value's is E, and a qmv launch's matrices
// share O.
//
// Split-K scratch and the activation buffers come from the caller; the
// launches of one call run in order on one stream, and so do the shards of a
// mesh that names one device several times, so those shards may share them.
#include "row.cuh"

namespace rwkv {

// Positions in the pointer tables passed by rwkv_tpu_torch/ops/cuda/tp_halves.py
// (_ATT_POINTERS and _FFN_POINTERS there list the same names in the same order).
enum AttPtr : int {
  A_X, A_XY, A_LN1_W, A_LN1_B, A_ATT_MIX_K, A_ATT_MIX_V, A_ATT_MIX_R,
  A_ATT_K_W, A_ATT_K_S, A_ATT_K_O, A_ATT_V_W, A_ATT_V_S, A_ATT_V_O, A_ATT_R_W, A_ATT_R_S, A_ATT_R_O,
  A_ATT_O_W, A_ATT_O_S, A_ATT_O_O, A_DECAY, A_BONUS, A_AA, A_BB, A_PP,
  A_PARTIAL, A_AA_OUT, A_BB_OUT, A_PP_OUT, A_XY_OUT,
  A_XK, A_XV, A_XR, A_RWKV,
  A_OFFS,       // [3, B] double: rank-1 terms of k, v, r
  A_OFF_PARTS,  // [E_loc / 128, B] double: per-tile shares of att.output's term
  A_SPLIT, A_COUNTERS,
  A_COUNT
};

enum FfnPtr : int {
  F_X, F_DD, F_LN2_W, F_LN2_B, F_FFN_MIX_K, F_FFN_MIX_R,
  F_FFN_K_W, F_FFN_K_S, F_FFN_K_O, F_FFN_R_W, F_FFN_R_S, F_FFN_R_O, F_FFN_V_W, F_FFN_V_S, F_FFN_V_O,
  F_VPARTIAL, F_GATE, F_DD_OUT,
  F_FK, F_FR, F_KK,
  F_OFFS,       // [2, B] double: rank-1 terms of ffn key, ffn receptance
  F_OFF_PARTS,  // [F_loc / 128, B] double: per-tile shares of ffn.value's term
  F_SPLIT, F_COUNTERS,
  F_COUNT
};

struct Launcher {
  void* const* p;
  int B;
  long long partial_cap;
  int counter_cap, target_blocks;
  cudaStream_t st;
  int* n_launched;

  float* f(int i) const { return static_cast<float*>(p[i]); }
  const int8_t* i8(int i) const { return static_cast<const int8_t*>(p[i]); }
  double* d(int i) const { return static_cast<double*>(p[i]); }

  QmvArgs qmv(int nmat, int O, int epi, float* out, int split, int counters) const {
    QmvArgs q = {};
    q.nmat = nmat;
    q.B = B;
    q.O = O;
    q.epi = epi;
    q.out = out;
    q.partial = f(split);
    q.counters = static_cast<int*>(p[counters]);
    return q;
  }
  static Mat mat(const float* x, const float* s, const double* off, int n_off, const int8_t* w,
                 int K) {
    Mat m = {};
    m.x = x;
    m.scale = s;
    m.off = off;
    m.n_off = n_off;
    m.w = w;
    m.K = K;
    m.half = K / 2;
    return m;
  }
  int run(cudaError_t e) const {  // after each launch
    ++*n_launched;
    return (int)e;
  }
  int rows(const RowArgs& r) const { return run(launch_rows<false>(r, st)); }
  int matvec(const QmvArgs& q) const {
    return run(launch_qmv<kQ8>(q, partial_cap, counter_cap, target_blocks, st));
  }
};

}  // namespace rwkv

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rwkv_att_half_pointer_count() { return A_COUNT; }
extern "C" int rwkv_ffn_half_pointer_count() { return F_COUNT; }

// Enqueues layer l's att half of one shard on `stream`: 3 launches. Weights
// and vectors are the shard's [L, ...] tensors (the pointers are their
// starts); x, xy [B, E], aa/bb/pp [B, El] are this layer's. Returns the first
// CUDA error (0 if none) and the launch count in *n_launched.
extern "C" int rwkv_att_half(void* const* p, int n_ptrs, int l, int B, int E, int El,
                             long long partial_cap, int counter_cap, int target_blocks,
                             void* stream, int* n_launched) {
  *n_launched = 0;
  if (n_ptrs != A_COUNT || B < 1 || E % 16 || El % 16) return (int)cudaErrorInvalidValue;
  const Launcher g = {p, B, partial_cap, counter_cap, target_blocks,
                      static_cast<cudaStream_t>(stream), n_launched};
  const size_t lE = (size_t)l * E, lEl = (size_t)l * El, lW = (size_t)l * E * El;
  int err;

  RowArgs ra = {};
  ra.mode = ROW_ATT;
  ra.B = B;
  ra.E = E;
  ra.x = g.f(A_X);  // read only: no tokens
  ra.ln_w = g.f(A_LN1_W) + lE;
  ra.ln_b = g.f(A_LN1_B) + lE;
  ra.prev = g.f(A_XY);
  ra.prev_out = g.f(A_XY_OUT);
  const int mixes[3] = {A_ATT_MIX_K, A_ATT_MIX_V, A_ATT_MIX_R};
  const int mixed[3] = {A_XK, A_XV, A_XR};
  const int offsets[3] = {A_ATT_K_O, A_ATT_V_O, A_ATT_R_O};
  for (int j = 0; j < 3; ++j) {
    ra.mix[j] = g.f(mixes[j]) + lE;
    ra.mixed[j] = g.f(mixed[j]);
    ra.offset[j] = g.f(offsets[j]) + lE;
    ra.off[j] = g.d(A_OFFS) + (size_t)j * B;
  }
  ra.nmix = 3;
  if ((err = g.rows(ra))) return err;

  // k, v, r on the shard's El channels, then the WKV step on its state slices
  QmvArgs q = g.qmv(3, El, EPI_WKV, g.f(A_RWKV), A_SPLIT, A_COUNTERS);
  const int ws[3] = {A_ATT_K_W, A_ATT_V_W, A_ATT_R_W}, ss[3] = {A_ATT_K_S, A_ATT_V_S, A_ATT_R_S};
  for (int j = 0; j < 3; ++j)
    q.m[j] = Launcher::mat(g.f(mixed[j]), g.f(ss[j]) + lE, g.d(A_OFFS) + (size_t)j * B, 1,
                           g.i8(ws[j]) + lW, E);
  q.aa_in = g.f(A_AA);
  q.bb_in = g.f(A_BB);
  q.pp_in = g.f(A_PP);
  q.aa_out = g.f(A_AA_OUT);
  q.bb_out = g.f(A_BB_OUT);
  q.pp_out = g.f(A_PP_OUT);
  q.decay = g.f(A_DECAY) + lEl;
  q.bonus = g.f(A_BONUS) + lEl;
  q.next_offset = g.f(A_ATT_O_O) + lEl;  // the shard's slice of att.output's offset
  q.next_off = g.d(A_OFF_PARTS);
  if ((err = g.matvec(q))) return err;

  // the row-parallel out-projection's partial, its offset share folded in
  QmvArgs o = g.qmv(1, E, EPI_STORE, g.f(A_PARTIAL), A_SPLIT, A_COUNTERS);
  o.m[0] = Launcher::mat(g.f(A_RWKV), g.f(A_ATT_O_S) + lEl, g.d(A_OFF_PARTS),
                         (El + kTileO - 1) / kTileO, g.i8(A_ATT_O_W) + lW, El);
  return g.matvec(o);
}

// Enqueues layer l's ffn half of one shard on `stream`: 4 launches. x, dd
// [B, E] are this layer's; the gate [B, El] and the value partial [B, E] are
// written. Returns as rwkv_att_half.
extern "C" int rwkv_ffn_half(void* const* p, int n_ptrs, int l, int B, int E, int El, int Fl,
                             long long partial_cap, int counter_cap, int target_blocks,
                             void* stream, int* n_launched) {
  *n_launched = 0;
  if (n_ptrs != F_COUNT || B < 1 || E % 16 || El % 16 || Fl % 16)
    return (int)cudaErrorInvalidValue;
  const Launcher g = {p, B, partial_cap, counter_cap, target_blocks,
                      static_cast<cudaStream_t>(stream), n_launched};
  const size_t lE = (size_t)l * E, lFl = (size_t)l * Fl;
  int err;

  RowArgs rf = {};
  rf.mode = ROW_FFN;
  rf.B = B;
  rf.E = E;
  rf.x = g.f(F_X);
  rf.ln_w = g.f(F_LN2_W) + lE;
  rf.ln_b = g.f(F_LN2_B) + lE;
  rf.prev = g.f(F_DD);
  rf.prev_out = g.f(F_DD_OUT);
  rf.mix[0] = g.f(F_FFN_MIX_K) + lE;
  rf.mix[1] = g.f(F_FFN_MIX_R) + lE;
  rf.mixed[0] = g.f(F_FK);
  rf.mixed[1] = g.f(F_FR);
  rf.offset[0] = g.f(F_FFN_K_O) + lE;
  rf.offset[1] = g.f(F_FFN_R_O) + lE;
  rf.off[0] = g.d(F_OFFS);
  rf.off[1] = g.d(F_OFFS) + B;
  rf.nmix = 2;
  if ((err = g.rows(rf))) return err;

  // the gate on the shard's El channels
  QmvArgs r = g.qmv(1, El, EPI_SIGMOID, g.f(F_GATE), F_SPLIT, F_COUNTERS);
  r.m[0] = Launcher::mat(g.f(F_FR), g.f(F_FFN_R_S) + lE, g.d(F_OFFS) + B, 1,
                         g.i8(F_FFN_R_W) + (size_t)l * E * El, E);
  if ((err = g.matvec(r))) return err;

  // relu(key)^2 on the shard's Fl channels, leaving ffn.value's offset shares
  QmvArgs k = g.qmv(1, Fl, EPI_RELU2, g.f(F_KK), F_SPLIT, F_COUNTERS);
  k.m[0] = Launcher::mat(g.f(F_FK), g.f(F_FFN_K_S) + lE, g.d(F_OFFS), 1,
                         g.i8(F_FFN_K_W) + (size_t)l * E * Fl, E);
  k.next_offset = g.f(F_FFN_V_O) + lFl;
  k.next_off = g.d(F_OFF_PARTS);
  if ((err = g.matvec(k))) return err;

  // the row-parallel value partial
  QmvArgs v = g.qmv(1, E, EPI_STORE, g.f(F_VPARTIAL), F_SPLIT, F_COUNTERS);
  v.m[0] = Launcher::mat(g.f(F_KK), g.f(F_FFN_V_S) + lFl, g.d(F_OFF_PARTS),
                         (Fl + kTileO - 1) / kTileO, g.i8(F_FFN_V_W) + (size_t)l * Fl * E, Fl);
  return g.matvec(v);
}
