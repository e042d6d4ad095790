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
// scale/offset vectors are the shard's [E_loc] / [F_loc] slices. Then, in
// four launches of cluster_qmv.cuh's cluster matvec:
//
//   att_half  a1: ln1 + token-shift mix folded into the column-parallel
//                 k/v/r on the shard's E_loc channels, the WKV step on its
//                 aa/bb/pp slices, sigmoid(r) * y; cluster 0 writes the new
//                 xy (= ln1(x), the same on every shard);
//             a2: the row-parallel out-projection PARTIAL [B, E];
//   ffn_half  f1: ln2 + mix folded into two families in one launch: relu(key)^2
//                 on the F_loc channels and the gate sigmoid(receptance) on
//                 the E_loc channels; cluster 0 writes the new dd;
//             f2: the row-parallel value PARTIAL [B, E].
//
// The partials are not added to the residual: the caller sums the shards'
// partials (a psum over the mesh) and adds x + psum(partial) and
// x + gate * psum(vpartial) after the collectives. The rank-1 offset term of
// a matrix is sum_k input * offset over its contraction rows: every block
// sums its rows' share as it stages them, and the cluster adds the shares in
// rank order, so a row-parallel partial carries exactly its shard's share and
// the psum of the partials is the whole product.
//
// Bound on the card: the shard's weight bytes per layer, 4 * E * E_loc for
// att_half and 2 * E * F_loc + E * E_loc for ffn_half (4.19 and 9.44 MB at
// 430M, tp = 1), over device memory bandwidth. The TPU kernel is one launch
// per half whose sequential grid carries its sums in VMEM. Here each launch
// splits every 64-column tile's contraction over the blocks of one thread-
// block cluster, which reduce through distributed shared memory (no global
// split scratch, counter or atomic), and is chained to the launch before it
// by programmatic dependent launch: its blocks issue their weights into
// shared memory while that launch drains. The cluster size is picked so that
// a launch's blocks cover the card's SMs in one wave (cq_plan).
//
// The activation buffers come from the caller; the launches of one call run
// in order on one stream, and so do the shards of a mesh that names one
// device several times, so those shards may share them: every launch writes
// only after griddepcontrol.wait, when the launch before it has finished.
#include "cluster_qmv.cuh"

namespace rwkv {

// Positions in the pointer tables passed by rwkv_tpu_torch/ops/cuda/tp_halves.py
// (_ATT_POINTERS and _FFN_POINTERS there list the same names in the same order).
enum AttPtr : int {
  A_X, A_XY, A_LN1_W, A_LN1_B, A_ATT_MIX_K, A_ATT_MIX_V, A_ATT_MIX_R,
  A_ATT_K_W, A_ATT_K_S, A_ATT_K_O, A_ATT_V_W, A_ATT_V_S, A_ATT_V_O, A_ATT_R_W, A_ATT_R_S, A_ATT_R_O,
  A_ATT_O_W, A_ATT_O_S, A_ATT_O_O, A_DECAY, A_BONUS, A_AA, A_BB, A_PP,
  A_PARTIAL, A_AA_OUT, A_BB_OUT, A_PP_OUT, A_XY_OUT,
  A_RWKV,       // [B, E_loc]: sigmoid(r) * y, a1's output and a2's input
  A_COUNT
};

enum FfnPtr : int {
  F_X, F_DD, F_LN2_W, F_LN2_B, F_FFN_MIX_K, F_FFN_MIX_R,
  F_FFN_K_W, F_FFN_K_S, F_FFN_K_O, F_FFN_R_W, F_FFN_R_S, F_FFN_R_O, F_FFN_V_W, F_FFN_V_S, F_FFN_V_O,
  F_VPARTIAL, F_GATE, F_DD_OUT,
  F_KK,         // [B, F_loc]: relu(key)^2, f1's output and f2's input
  F_COUNT
};

// The four launches, in order.
enum HalfLaunch : int { H_A1, H_A2, H_F1, H_F2, H_LAUNCHES };

// The card's SM count and the shared memory a block may opt in to.
inline cudaError_t card_limits(int& sms, size_t& smem_max) {
  static int cached_sms[64], cached_smem[64];
  int d;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d < 64 && cached_sms[d]) {
    sms = cached_sms[d];
    smem_max = (size_t)cached_smem[d];
    return cudaSuccess;
  }
  int s, m;
  if ((e = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, d))) return e;
  if ((e = cudaDeviceGetAttribute(&m, cudaDevAttrMaxSharedMemoryPerBlockOptin, d))) return e;
  if (d < 64) {
    cached_sms[d] = s;
    cached_smem[d] = m;
  }
  sms = s;
  smem_max = (size_t)m;
  return cudaSuccess;
}

// (K, nmat, tiles) of launch h.
inline void half_shape(int h, int E, int El, int Fl, int& K, int& nmat, int& tiles) {
  auto t = [](int O) { return (O + kCqTile - 1) / kCqTile; };
  switch (h) {
    case H_A1: K = E; nmat = 3; tiles = t(El); break;
    case H_A2: K = El; nmat = 1; tiles = t(E); break;
    case H_F1: K = E; nmat = 1; tiles = t(Fl) + t(El); break;
    default: K = Fl; nmat = 1; tiles = t(E); break;
  }
}

inline cudaError_t half_plan(int h, int B, int E, int El, int Fl, CqPlan& p) {
  int sms;
  size_t smem_max;
  const cudaError_t e = card_limits(sms, smem_max);
  if (e != cudaSuccess) return e;
  int K, nmat, tiles;
  half_shape(h, E, El, Fl, K, nmat, tiles);
  p = cq_plan(B, K, nmat, tiles, sms, smem_max);
  return cudaSuccess;
}

struct Table {
  void* const* p;
  float* f(int i) const { return static_cast<float*>(p[i]); }
  const int8_t* i8(int i) const { return static_cast<const int8_t*>(p[i]); }
};

// The arguments of launch h for layer l (CqArgs::rows and pass_rows from
// the plan).
inline CqArgs half_args(int h, const Table& g, int l, int B, int E, int El, int Fl,
                        const CqPlan& plan) {
  CqArgs a = {};
  a.B = B;
  a.rows = plan.rows;
  a.pass_rows = plan.pass_rows;
  a.nfam = 1;
  const size_t lE = (size_t)l * E;
  auto fam = [&](CqFam& fm, int nmat, int O, int epi, float* out) {
    fm.nmat = nmat;
    fm.O = O;
    fm.tiles = (O + kCqTile - 1) / kCqTile;
    fm.epi = epi;
    fm.out = out;
  };
  switch (h) {
    case H_A1: {
      CqFam& fm = a.fam[0];
      fam(fm, 3, El, EPI_WKV, g.f(A_RWKV));
      const int ws[3] = {A_ATT_K_W, A_ATT_V_W, A_ATT_R_W}, ss[3] = {A_ATT_K_S, A_ATT_V_S, A_ATT_R_S};
      const int os[3] = {A_ATT_K_O, A_ATT_V_O, A_ATT_R_O};
      const int mixes[3] = {A_ATT_MIX_K, A_ATT_MIX_V, A_ATT_MIX_R};
      for (int m = 0; m < 3; ++m) {
        fm.w[m] = g.i8(ws[m]) + (size_t)l * E * El;
        fm.scale[m] = g.f(ss[m]) + lE;
        fm.offset[m] = g.f(os[m]) + lE;
        fm.mix[m] = g.f(mixes[m]) + lE;
      }
      fm.aa_in = g.f(A_AA);
      fm.bb_in = g.f(A_BB);
      fm.pp_in = g.f(A_PP);
      fm.aa_out = g.f(A_AA_OUT);
      fm.bb_out = g.f(A_BB_OUT);
      fm.pp_out = g.f(A_PP_OUT);
      fm.decay = g.f(A_DECAY) + (size_t)l * El;
      fm.bonus = g.f(A_BONUS) + (size_t)l * El;
      a.K = E;
      a.x = g.f(A_X);
      a.ln_w = g.f(A_LN1_W) + lE;
      a.ln_b = g.f(A_LN1_B) + lE;
      a.prev = g.f(A_XY);
      a.prev_out = g.f(A_XY_OUT);
      break;
    }
    case H_A2: {
      CqFam& fm = a.fam[0];
      fam(fm, 1, E, EPI_STORE, g.f(A_PARTIAL));
      fm.w[0] = g.i8(A_ATT_O_W) + (size_t)l * El * E;
      fm.scale[0] = g.f(A_ATT_O_S) + (size_t)l * El;
      fm.offset[0] = g.f(A_ATT_O_O) + (size_t)l * El;
      a.K = El;
      a.in = g.f(A_RWKV);
      break;
    }
    case H_F1: {
      a.nfam = 2;
      CqFam& key = a.fam[0];
      fam(key, 1, Fl, EPI_RELU2, g.f(F_KK));
      key.w[0] = g.i8(F_FFN_K_W) + (size_t)l * E * Fl;
      key.scale[0] = g.f(F_FFN_K_S) + lE;
      key.offset[0] = g.f(F_FFN_K_O) + lE;
      key.mix[0] = g.f(F_FFN_MIX_K) + lE;
      CqFam& gate = a.fam[1];
      fam(gate, 1, El, EPI_SIGMOID, g.f(F_GATE));
      gate.w[0] = g.i8(F_FFN_R_W) + (size_t)l * E * El;
      gate.scale[0] = g.f(F_FFN_R_S) + lE;
      gate.offset[0] = g.f(F_FFN_R_O) + lE;
      gate.mix[0] = g.f(F_FFN_MIX_R) + lE;
      a.K = E;
      a.x = g.f(F_X);
      a.ln_w = g.f(F_LN2_W) + lE;
      a.ln_b = g.f(F_LN2_B) + lE;
      a.prev = g.f(F_DD);
      a.prev_out = g.f(F_DD_OUT);
      break;
    }
    default: {
      CqFam& fm = a.fam[0];
      fam(fm, 1, E, EPI_STORE, g.f(F_VPARTIAL));
      fm.w[0] = g.i8(F_FFN_V_W) + (size_t)l * Fl * E;
      fm.scale[0] = g.f(F_FFN_V_S) + (size_t)l * Fl;
      fm.offset[0] = g.f(F_FFN_V_O) + (size_t)l * Fl;
      a.K = Fl;
      a.in = g.f(F_KK);
      break;
    }
  }
  a.nmat_max = a.fam[0].nmat;
  return a;
}

// Launches h0 and h0 + 1 (one half) for layer l on `st`; counts each launch
// the card took in *n_launched.
inline int run_half(int h0, void* const* p, int l, int B, int E, int El, int Fl,
                    cudaStream_t st, int* n_launched) {
  for (int h = h0; h < h0 + 2; ++h) {
    CqPlan plan;
    cudaError_t e = half_plan(h, B, E, El, Fl, plan);
    if (e != cudaSuccess) return (int)e;
    e = cq_launch(half_args(h, Table{p}, l, B, E, El, Fl, plan), plan, st);
    if (e != cudaSuccess) return (int)e;
    ++*n_launched;
  }
  return 0;
}

}  // namespace rwkv

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rwkv_att_half_pointer_count() { return A_COUNT; }
extern "C" int rwkv_ffn_half_pointer_count() { return F_COUNT; }

// Enqueues layer l's att half of one shard on `stream`: launches a1 and a2.
// Weights and vectors are the shard's [L, ...] tensors (the pointers are
// their starts); x, xy [B, E], aa/bb/pp [B, El] are this layer's. Returns the
// first CUDA error (0 if none) and the launches taken in *n_launched.
extern "C" int rwkv_att_half(void* const* p, int n_ptrs, int l, int B, int E, int El,
                             void* stream, int* n_launched) {
  *n_launched = 0;
  if (n_ptrs != A_COUNT || B < 1 || E % 16 || El % 16) return (int)cudaErrorInvalidValue;
  return run_half(H_A1, p, l, B, E, El, 0, static_cast<cudaStream_t>(stream), n_launched);
}

// Enqueues layer l's ffn half of one shard on `stream`: launches f1 and f2.
// x, dd [B, E] are this layer's; the gate [B, El] and the value partial
// [B, E] are written. Returns as rwkv_att_half.
extern "C" int rwkv_ffn_half(void* const* p, int n_ptrs, int l, int B, int E, int El, int Fl,
                             void* stream, int* n_launched) {
  *n_launched = 0;
  if (n_ptrs != F_COUNT || B < 1 || E % 16 || El % 16 || Fl % 16)
    return (int)cudaErrorInvalidValue;
  return run_half(H_F1, p, l, B, E, El, Fl, static_cast<cudaStream_t>(stream), n_launched);
}

// How launch h (0..3: a1, a2, f1, f2) is cut on the current device at these
// widths: out = {cluster size, blocks, dynamic shared memory bytes,
// contraction rows a block holds at once, co-resident clusters}. Launches
// nothing.
extern "C" int rwkv_halves_plan(int h, int B, int E, int El, int Fl, int* out) {
  if (h < 0 || h >= H_LAUNCHES || B < 1) return (int)cudaErrorInvalidValue;
  CqPlan plan;
  cudaError_t e = half_plan(h, B, E, El, Fl, plan);
  if (e != cudaSuccess) return (int)e;
  static void* const none[(int)A_COUNT > (int)F_COUNT ? (int)A_COUNT : (int)F_COUNT] = {};
  int active = 0;
  e = cq_launch(half_args(h, Table{none}, 0, B, E, El, Fl, plan), plan, nullptr, &active);
  if (e != cudaSuccess) return (int)e;
  out[0] = plan.S;
  out[1] = plan.ctas;
  out[2] = (int)plan.smem;
  out[3] = plan.pass_rows;
  out[4] = active;
  return 0;
}

// The CUDA runtime's and the driver's versions (1000 * major + 10 * minor):
// programmatic dependent launch inside a CUDA graph needs 12.3 or later.
extern "C" int rwkv_cuda_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDriverGetVersion(driver);
}
