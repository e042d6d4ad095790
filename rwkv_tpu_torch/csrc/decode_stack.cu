// One RWKV-v4 decode step over all L layers: q8 (kernel K1) or q4 (kernel K4).
//
// Replaces rwkv_tpu/ops/pallas/decode_stack.py:_decode_stack_kernel, its q8
// branch and its q4 branch (_dot4/_fold4), reached through decode_stack() and
// forward_step_fused().
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
//   1. row_kernel ATT : ln1 + token-shift mix -> k/v/r inputs, new xy
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
// The new state is written to separate output tensors: the input state is
// never modified, as in the JAX function.
#include "qmv.cuh"

namespace rwkv {

enum RowMode : int { ROW_ATT = 0, ROW_FFN = 1, ROW_HEAD = 2 };

struct RowArgs {
  int mode, B, E, n_emb;
  float* x;                  // [B, E] residual stream
  const int* tokens;         // [B], or null: x already holds the embedded rows
  const float* emb;          // [n_emb, E]
  const float* ln0_w;
  const float* ln0_b;
  const float* ln_w;         // ln1 / ln2 / ln_out
  const float* ln_b;
  const float* prev;         // [B, E] xy or dd before the step
  float* prev_out;           // [B, E] xy or dd after the step
  const float* mix[3];       // [E]
  float* mixed[3];           // [B, E] mixed matvec inputs
  const float* offset[3];    // [E] offset vector of the matrix that reads mixed[j]
  float* off[3];             // [B] its rank-1 term, sum_i mixed[j][b, i] * offset[j][i]
  int nmix;
  const float* head_scale;   // ROW_HEAD: xs_h = ln_out(x) * head_scale,
  float* xs_h;               // [B, E]   and off[0] = ln_out(x) . offset[0]
};

__device__ __forceinline__ float row_sum(float v, float* scratch) {
  float t[1] = {v};
  block_sums<1>(t, scratch);
  return t[0];
}

// LayerNorm of the row in v[0:E] (shared memory), in place; eps 1e-8.
__device__ void row_layer_norm(float* v, int E, const float* w, const float* b, float* scratch) {
  float s = 0.f;
  for (int i = threadIdx.x; i < E; i += blockDim.x) s += v[i];
  const float mean = row_sum(s, scratch) / (float)E;
  float q = 0.f;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const float c = v[i] - mean;
    q = fmaf(c, c, q);
  }
  const float rs = rsqrtf(row_sum(q, scratch) / (float)E + 1e-8f);
  for (int i = threadIdx.x; i < E; i += blockDim.x) v[i] = (v[i] - mean) * rs * w[i] + b[i];
  __syncthreads();
}

constexpr int kRowThreads = 1024;

// One block per batch row, one thread per element up to 1024: LayerNorm, the
// token-shift mixes, and the whole rank-1 offset sums of the matrices that
// read the mixed rows.
__global__ void __launch_bounds__(kRowThreads) row_kernel(const RowArgs a) {
  extern __shared__ float v[];  // [E]
  __shared__ float scratch[3 * 33];
  const int b = blockIdx.x, E = a.E;
  float* xrow = a.x + (size_t)b * E;
  if (a.tokens) {
    int t = a.tokens[b];
    t = t < 0 ? 0 : (t >= a.n_emb ? a.n_emb - 1 : t);  // clamp like a gather
    const float* er = a.emb + (size_t)t * E;
    for (int i = threadIdx.x; i < E; i += blockDim.x) v[i] = er[i];
    __syncthreads();
    row_layer_norm(v, E, a.ln0_w, a.ln0_b, scratch);
    for (int i = threadIdx.x; i < E; i += blockDim.x) xrow[i] = v[i];
  } else {
    for (int i = threadIdx.x; i < E; i += blockDim.x) v[i] = xrow[i];
    __syncthreads();
  }
  row_layer_norm(v, E, a.ln_w, a.ln_b, scratch);

  float sums[3] = {0.f, 0.f, 0.f};
  if (a.mode == ROW_HEAD) {
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      a.xs_h[(size_t)b * E + i] = v[i] * a.head_scale[i];
      sums[0] = fmaf(v[i], a.offset[0][i], sums[0]);
    }
  } else {
    const float* prev = a.prev + (size_t)b * E;
    float* prev_out = a.prev_out + (size_t)b * E;
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const float xx = v[i], p = prev[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j < a.nmix) {
          const float mj = a.mix[j][i];
          const float m = mj * xx + (1.f - mj) * p;
          a.mixed[j][(size_t)b * E + i] = m;
          sums[j] = fmaf(m, a.offset[j][i], sums[j]);
        }
      }
      prev_out[i] = xx;
    }
  }
  block_sums<3>(sums, scratch);
  if (threadIdx.x == 0) {
    const int n = a.mode == ROW_HEAD ? 1 : a.nmix;
    for (int j = 0; j < n; ++j) a.off[j][b] = sums[j];
  }
}

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
  P_OFFS,       // [5, B]: rank-1 terms of k, v, r, ffn key, ffn receptance
  P_OFF_PARTS,  // [E/128 + F/128, B]: per-tile partials for att.output, ffn.value
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
// receptance, in rows (K / 2 for global pairing).
extern "C" int rwkv_decode_stack(void* const* p, int n_ptrs, int L, int B, int E, int F,
                                 int n_emb, int q4, const int* halves, long long partial_cap,
                                 int counter_cap, int target_blocks, void* stream,
                                 int* n_launched) {
  *n_launched = 0;
  if (n_ptrs != P_COUNT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [&](int i) { return static_cast<float*>(p[i]); };
  auto i8 = [&](int i) { return static_cast<const int8_t*>(p[i]); };
  // per-layer weight strides in bytes: q4 packs two codes a byte
  const size_t EE = (size_t)E * E / (q4 ? 2 : 1), EF = (size_t)E * F / (q4 ? 2 : 1);
  const size_t BE = (size_t)B * E;
  static const int kGlobal[7] = {0, 0, 0, 0, 0, 0, 0};
  const int* hv = q4 ? halves : kGlobal;
  const size_t row_smem = (size_t)E * sizeof(float);
  const int row_threads = E < kRowThreads ? (E + 31) / 32 * 32 : kRowThreads;
  if (row_smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)row_smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_e = (E + kTileO - 1) / kTileO;
  float* offs = f(P_OFFS);
  float* off_out = f(P_OFF_PARTS);                    // [tiles_e, B]
  float* off_val = off_out + (size_t)tiles_e * B;     // [F / 128, B]
  float* partial = f(P_PARTIAL);
  int* counters = static_cast<int*>(p[P_COUNTERS]);

  auto done = [&](cudaError_t e) -> int {  // after each launch
    ++*n_launched;
    return (int)e;
  };
  auto mat = [](const float* x, const float* s, const float* off, int n_off, const int8_t* w,
                int K, int half) {
    Mat m;
    m.x = x;
    m.scale = s;
    m.off = off;
    m.n_off = n_off;
    m.w = w;
    m.K = K;
    m.half = half;
    return m;
  };
  auto launch = [&](const QmvArgs& q) {
    return q4 ? launch_qmv<true>(q, partial_cap, counter_cap, target_blocks, st)
              : launch_qmv<false>(q, partial_cap, counter_cap, target_blocks, st);
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
    for (int j = 0; j < 3; ++j) {
      ra.mix[j] = f(mixes[j]) + lE;
      ra.mixed[j] = f(outs[j]);
      ra.offset[j] = f(offsets[j]) + lE;
      ra.off[j] = offs + (size_t)j * B;
    }
    ra.nmix = 3;
    row_kernel<<<B, row_threads, row_smem, st>>>(ra);
    if ((err = done(cudaGetLastError()))) return err;

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
    if ((err = done(launch(q)))) return err;

    QmvArgs o = qmv(1, E, EPI_ADD, f(P_X));
    o.m[0] = mat(f(P_RWKV), f(P_ATT_O_S) + lE, off_out, tiles_e, i8(P_ATT_O_W) + l * EE, E,
                 hv[3]);
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
    rf.nmix = 2;
    row_kernel<<<B, row_threads, row_smem, st>>>(rf);
    if ((err = done(cudaGetLastError()))) return err;

    QmvArgs k = qmv(1, F, EPI_RELU2, f(P_KK));
    k.m[0] = mat(f(P_FK), f(P_FFN_K_S) + lE, offs + 3 * B, 1, i8(P_FFN_K_W) + l * EF, E,
                 hv[4]);
    k.next_offset = f(P_FFN_V_O) + lF;
    k.next_off = off_val;
    if ((err = done(launch(k)))) return err;

    QmvArgs v = qmv(2, E, EPI_GATED_ADD, f(P_X));
    v.m[0] = mat(f(P_KK), f(P_FFN_V_S) + lF, off_val, (F + kTileO - 1) / kTileO,
                 i8(P_FFN_V_W) + l * EF, F, hv[5]);
    v.m[1] = mat(f(P_FR), f(P_FFN_R_S) + lE, offs + 4 * B, 1, i8(P_FFN_R_W) + l * EE, E,
                 hv[6]);
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
  rh.off[0] = f(P_OFF_H);
  rh.xs_h = f(P_XS_H);
  row_kernel<<<B, row_threads, row_smem, st>>>(rh);
  return done(cudaGetLastError());
}
