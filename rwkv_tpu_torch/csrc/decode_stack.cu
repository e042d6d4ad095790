// One RWKV-v4 decode step over all L layers: q8 (kernel K1), q4 (kernel K4)
// or W8A8 (the stack of kernel K5).
//
// Replaces rwkv_tpu/ops/pallas/decode_stack.py:_decode_stack_kernel, its q8
// branch, its q4 branch (_dot4/_fold4) and its a8 branch (_quant_rows,
// _dot_s8), reached through decode_stack() and forward_step_fused().
//
// Bound on the card: the weight bytes, L * 13 * E^2 in q8 (327 MB at 430M)
// and half that in q4 (164 MB), read once per step, over device memory
// bandwidth (~3.35 TB/s on an H100 SXM: ~0.1 and ~0.05 ms per step). State,
// activations and scale/offset vectors add under 1% (2% in q4).
//
// The TPU kernel is one launch whose sequential grid carries the activation
// vector and the offset sums from step to step in VMEM. CUDA blocks run in no
// order and share nothing, so here layer l+1 waits for layer l through a fixed
// sequence of launches on one stream, six per layer:
//
//   1. row_kernel ATT : (row.cuh) ln1 + token-shift mix -> k/v/r inputs, new xy
//                       (layer 0 first gathers the embedding rows and runs ln0)
//   2. qmv  k,v,r     : three matvecs + the WKV step -> sigmoid(r) * y, new aa/bb/pp
//   3. qmv  output    : out-projection, added to the residual
//   4. row_kernel FFN : ln2 + mix -> key/gate inputs, new dd
//   5. qmv  key       : relu(key)^2
//   6. qmv  value,gate: value projection * sigmoid(gate), added to the residual
//
// and after the last layer one row_kernel HEAD (ln_out, scaled head input and
// its offset row-sum) that feeds the head matvec, kernel K2 (mm8.cu). All the
// launches of a step are enqueued by one host call, rwkv_decode_stack(), so
// the host pays one crossing into C per token. Every weight byte is read once
// (qmv.cuh says how). The rank-1 offset sums run over a matrix's whole input
// dim: the row kernels compute them whole for the inputs they produce, and
// the k/v/r and key epilogues leave one partial per column tile for the
// out-projection and the value projection, summed in a fixed order by their
// consumer (never atomically added), so every run gives the same bits.
//
// In q4 the launches are the same; every matvec reads nibble-packed weights
// [L, K / 2, O] (qmv.cuh's Q4 instantiation). att.output and ffn.value pair
// rows within their `block` (halves[] below), the others globally.
//
// In a8 (a8_block > 0) the launches are the same again; every matvec
// quantizes its input to int8 codes while staging it and runs s8 x s8 -> s32
// dot products (qmv.cuh's A8 instantiation). The inputs of att k/v/r, ffn
// key/receptance and the head are quantized per batch row over all E
// channels: their row kernels write each row's max|x * scale|. The inputs of
// att.output and ffn.value are quantized per block of a8_block channels, as
// the TPU kernel quantizes each of its `tile`-wide slices: their producers
// (the WKV and relu^2 epilogues, 128 columns a block) write one max per
// 128-column tile, and the consumer takes the max of a block's tiles. So no
// extra launch, and no extra pass over the activations.
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
// q8 and q4 share the epilogues; their row kernels keep f32 sums
// (row_kernel<false>: the double sums add ~1.4 us a launch on an H100 80GB
// HBM3 at 700 W, PERF.md), within f32 rounding of the plain version.
//
// The new state is written to separate output tensors: the input state is
// never modified, as in the JAX function.
#include "row.cuh"

namespace rwkv {

// Positions in the pointer table passed by rwkv_tpu_torch/ops/cuda/decode_stack.py
// (_POINTERS there lists the same names in the same order).
enum Ptr : int {
  P_TOKENS, P_EMB, P_LN0_W, P_LN0_B, P_LN1_W, P_LN1_B, P_LN2_W, P_LN2_B,
  P_ATT_MIX_K, P_ATT_MIX_V, P_ATT_MIX_R, P_DECAY, P_BONUS,
  P_ATT_K_W, P_ATT_K_S, P_ATT_K_O, P_ATT_V_W, P_ATT_V_S, P_ATT_V_O,
  P_ATT_R_W, P_ATT_R_S, P_ATT_R_O, P_ATT_O_W, P_ATT_O_S, P_ATT_O_O,
  P_FFN_MIX_K, P_FFN_MIX_R,
  P_FFN_K_W, P_FFN_K_S, P_FFN_K_O, P_FFN_V_W, P_FFN_V_S, P_FFN_V_O,
  P_FFN_R_W, P_FFN_R_S, P_FFN_R_O,
  P_LN_OUT_W, P_LN_OUT_B, P_HEAD_S, P_HEAD_O,
  P_XY_IN, P_AA_IN, P_BB_IN, P_PP_IN, P_DD_IN,
  P_XY_OUT, P_AA_OUT, P_BB_OUT, P_PP_OUT, P_DD_OUT,
  P_X, P_XK, P_XV, P_XR, P_RWKV, P_FK, P_FR, P_KK, P_XS_H, P_OFF_H,
  P_OFFS,       // [5, B] double: rank-1 terms of k, v, r, ffn key, ffn receptance
  P_OFF_PARTS,  // [E/128 + F/128, B] double: per-tile partials for att.output, ffn.value
  P_AMAX,       // [6, B], a8: row maxima of the inputs of k, v, r, ffn key, ffn r, head
  P_AMAX_PARTS, // [E/128 + F/128, B], a8: per-tile maxima of att.output's, ffn.value's input
  P_PARTIAL, P_COUNTERS,
  P_COUNT
};

}  // namespace rwkv

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rwkv_decode_stack_pointer_count() { return P_COUNT; }

// Enqueues one decode step on `stream`; returns the first CUDA error (0 if
// none) and the number of kernels launched in *n_launched. q4: the weight
// pointers are nibble-packed [L, K / 2, O], and halves[7] gives half the
// pairing block of att key, value, receptance, output, ffn key, value,
// receptance, in rows (K / 2 for global pairing). a8_block > 0: W8A8, with
// att.output's and ffn.value's inputs quantized per block of a8_block
// channels (a multiple of 128 that divides E and F); q8 weights only.
extern "C" int rwkv_decode_stack(void* const* p, int n_ptrs, int L, int B, int E, int F,
                                 int n_emb, int q4, const int* halves, int a8_block,
                                 long long partial_cap, int counter_cap, int target_blocks,
                                 void* stream, int* n_launched) {
  *n_launched = 0;
  if (n_ptrs != P_COUNT) return (int)cudaErrorInvalidValue;
  const bool a8 = a8_block > 0;
  if (a8 && (q4 || a8_block % kTileO || E % a8_block || F % a8_block))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [&](int i) { return static_cast<float*>(p[i]); };
  auto i8 = [&](int i) { return static_cast<const int8_t*>(p[i]); };
  // per-layer weight strides in bytes: q4 packs two codes a byte
  const size_t EE = (size_t)E * E / (q4 ? 2 : 1), EF = (size_t)E * F / (q4 ? 2 : 1);
  const size_t BE = (size_t)B * E;
  static const int kGlobal[7] = {0, 0, 0, 0, 0, 0, 0};
  const int* hv = q4 ? halves : kGlobal;
  // a8: the row kernels (row.cuh) repeat the plain version's arithmetic exactly
  auto rows = [&](const RowArgs& r) {
    return a8 ? launch_rows<true>(r, st) : launch_rows<false>(r, st);
  };
  const int tiles_e = (E + kTileO - 1) / kTileO;
  auto d = [&](int i) { return static_cast<double*>(p[i]); };
  double* offs = d(P_OFFS);
  double* off_out = d(P_OFF_PARTS);                   // [tiles_e, B]
  double* off_val = off_out + (size_t)tiles_e * B;    // [F / 128, B]
  float* partial = f(P_PARTIAL);
  int* counters = static_cast<int*>(p[P_COUNTERS]);
  float* amax = a8 ? f(P_AMAX) : nullptr;                      // [6, B]
  float* amax_out = a8 ? f(P_AMAX_PARTS) : nullptr;            // [tiles_e, B]
  float* amax_val = a8 ? amax_out + (size_t)tiles_e * B : nullptr;  // [F / 128, B]

  auto done = [&](cudaError_t e) -> int {  // after each launch
    ++*n_launched;
    return (int)e;
  };
  auto mat = [](const float* x, const float* s, const double* off, int n_off, const int8_t* w,
                int K, int half) {
    Mat m = {};
    m.x = x;
    m.scale = s;
    m.off = off;
    m.n_off = n_off;
    m.w = w;
    m.K = K;
    m.half = half;
    return m;
  };
  // a8: where matrix m's input maxima are (n parts over its K) and its block
  auto quant = [&](Mat& m, float* parts, int n, int qblock) {
    if (!a8) return;
    m.amax = parts;
    m.n_amax = n;
    m.qblock = qblock;
  };
  auto launch = [&](const QmvArgs& q) {
    if (a8) return launch_qmv<kA8>(q, partial_cap, counter_cap, target_blocks, st);
    return q4 ? launch_qmv<kQ4>(q, partial_cap, counter_cap, target_blocks, st)
              : launch_qmv<kQ8>(q, partial_cap, counter_cap, target_blocks, st);
  };
  auto qmv = [&](int nmat, int O, int epi, float* out) {
    QmvArgs q = {};
    q.nmat = nmat;
    q.B = B;
    q.O = O;
    q.epi = epi;
    q.out = out;
    q.partial = partial;
    q.counters = counters;
    return q;
  };

  for (int l = 0; l < L; ++l) {
    const size_t lE = (size_t)l * E, lF = (size_t)l * F, lBE = (size_t)l * BE;
    int err;

    RowArgs ra = {};
    ra.mode = ROW_ATT;
    ra.B = B;
    ra.E = E;
    ra.n_emb = n_emb;
    ra.x = f(P_X);
    ra.tokens = l == 0 ? static_cast<const int*>(p[P_TOKENS]) : nullptr;
    ra.emb = f(P_EMB);
    ra.ln0_w = f(P_LN0_W);
    ra.ln0_b = f(P_LN0_B);
    ra.ln_w = f(P_LN1_W) + lE;
    ra.ln_b = f(P_LN1_B) + lE;
    ra.prev = f(P_XY_IN) + lBE;
    ra.prev_out = f(P_XY_OUT) + lBE;
    const int mixes[3] = {P_ATT_MIX_K, P_ATT_MIX_V, P_ATT_MIX_R};
    const int outs[3] = {P_XK, P_XV, P_XR};
    const int offsets[3] = {P_ATT_K_O, P_ATT_V_O, P_ATT_R_O};
    const int scales[3] = {P_ATT_K_S, P_ATT_V_S, P_ATT_R_S};
    for (int j = 0; j < 3; ++j) {
      ra.mix[j] = f(mixes[j]) + lE;
      ra.mixed[j] = f(outs[j]);
      ra.offset[j] = f(offsets[j]) + lE;
      ra.off[j] = offs + (size_t)j * B;
      ra.qscale[j] = f(scales[j]) + lE;
      ra.amax[j] = a8 ? amax + (size_t)j * B : nullptr;
    }
    ra.nmix = 3;
    if ((err = done(rows(ra)))) return err;

    QmvArgs q = qmv(3, E, EPI_WKV, f(P_RWKV));
    q.m[0] = mat(f(P_XK), f(P_ATT_K_S) + lE, offs, 1, i8(P_ATT_K_W) + l * EE, E, hv[0]);
    q.m[1] = mat(f(P_XV), f(P_ATT_V_S) + lE, offs + B, 1, i8(P_ATT_V_W) + l * EE, E, hv[1]);
    q.m[2] = mat(f(P_XR), f(P_ATT_R_S) + lE, offs + 2 * B, 1, i8(P_ATT_R_W) + l * EE, E,
                 hv[2]);
    q.aa_in = f(P_AA_IN) + lBE;
    q.bb_in = f(P_BB_IN) + lBE;
    q.pp_in = f(P_PP_IN) + lBE;
    q.aa_out = f(P_AA_OUT) + lBE;
    q.bb_out = f(P_BB_OUT) + lBE;
    q.pp_out = f(P_PP_OUT) + lBE;
    q.decay = f(P_DECAY) + lE;
    q.bonus = f(P_BONUS) + lE;
    q.next_offset = f(P_ATT_O_O) + lE;
    q.next_off = off_out;
    for (int j = 0; j < 3; ++j) quant(q.m[j], amax + (a8 ? (size_t)j * B : 0), 1, E);
    if (a8) {
      q.next_scale = f(P_ATT_O_S) + lE;
      q.next_amax = amax_out;
    }
    if ((err = done(launch(q)))) return err;

    QmvArgs o = qmv(1, E, EPI_ADD, f(P_X));
    o.m[0] = mat(f(P_RWKV), f(P_ATT_O_S) + lE, off_out, tiles_e, i8(P_ATT_O_W) + l * EE, E,
                 hv[3]);
    quant(o.m[0], amax_out, tiles_e, a8_block);
    if ((err = done(launch(o)))) return err;

    RowArgs rf = {};
    rf.mode = ROW_FFN;
    rf.B = B;
    rf.E = E;
    rf.n_emb = n_emb;
    rf.x = f(P_X);
    rf.ln_w = f(P_LN2_W) + lE;
    rf.ln_b = f(P_LN2_B) + lE;
    rf.prev = f(P_DD_IN) + lBE;
    rf.prev_out = f(P_DD_OUT) + lBE;
    rf.mix[0] = f(P_FFN_MIX_K) + lE;
    rf.mix[1] = f(P_FFN_MIX_R) + lE;
    rf.mixed[0] = f(P_FK);
    rf.mixed[1] = f(P_FR);
    rf.offset[0] = f(P_FFN_K_O) + lE;
    rf.offset[1] = f(P_FFN_R_O) + lE;
    rf.off[0] = offs + 3 * B;
    rf.off[1] = offs + 4 * B;
    rf.qscale[0] = f(P_FFN_K_S) + lE;
    rf.qscale[1] = f(P_FFN_R_S) + lE;
    rf.amax[0] = a8 ? amax + 3 * B : nullptr;
    rf.amax[1] = a8 ? amax + 4 * B : nullptr;
    rf.nmix = 2;
    if ((err = done(rows(rf)))) return err;

    QmvArgs k = qmv(1, F, EPI_RELU2, f(P_KK));
    k.m[0] = mat(f(P_FK), f(P_FFN_K_S) + lE, offs + 3 * B, 1, i8(P_FFN_K_W) + l * EF, E,
                 hv[4]);
    k.next_offset = f(P_FFN_V_O) + lF;
    k.next_off = off_val;
    quant(k.m[0], amax + (a8 ? 3 * B : 0), 1, E);
    if (a8) {
      k.next_scale = f(P_FFN_V_S) + lF;
      k.next_amax = amax_val;
    }
    if ((err = done(launch(k)))) return err;

    QmvArgs v = qmv(2, E, EPI_GATED_ADD, f(P_X));
    v.m[0] = mat(f(P_KK), f(P_FFN_V_S) + lF, off_val, (F + kTileO - 1) / kTileO,
                 i8(P_FFN_V_W) + l * EF, F, hv[5]);
    v.m[1] = mat(f(P_FR), f(P_FFN_R_S) + lE, offs + 4 * B, 1, i8(P_FFN_R_W) + l * EE, E,
                 hv[6]);
    quant(v.m[0], amax_val, (F + kTileO - 1) / kTileO, a8_block);
    quant(v.m[1], amax + (a8 ? 4 * B : 0), 1, E);
    if ((err = done(launch(v)))) return err;
  }

  RowArgs rh = {};
  rh.mode = ROW_HEAD;
  rh.B = B;
  rh.E = E;
  rh.n_emb = n_emb;
  rh.x = f(P_X);
  rh.ln_w = f(P_LN_OUT_W);
  rh.ln_b = f(P_LN_OUT_B);
  rh.head_scale = f(P_HEAD_S);
  rh.offset[0] = f(P_HEAD_O);
  rh.off_h = f(P_OFF_H);
  rh.xs_h = f(P_XS_H);
  rh.amax[0] = a8 ? amax + 5 * B : nullptr;
  return done(rows(rh));
}
