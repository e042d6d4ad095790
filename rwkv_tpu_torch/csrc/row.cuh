// Row operations of the persistent decode stacks (stack.cuh; decode_stack.cu:
// kernels K1, K4 and K5's stack, whose ln_out phase is row_run).
//
// A batch row by a whole block: optionally the embedding gather + ln0, then a
// LayerNorm (ln1, ln2 or ln_out), the token-shift mixes that feed the next
// matvecs, and the whole rank-1 offset sums of the matrices that read the
// mixed rows (csrc/qmv.cuh says why they are computed here). Every operation
// reads and writes O(B * E) floats.
#pragma once

#include <type_traits>

#include "qmv.cuh"

namespace rwkv {

enum RowMode : int { ROW_ATT = 0, ROW_FFN = 1, ROW_HEAD = 2 };

struct RowArgs {
  int mode, B, E, n_emb;
  float* x;                  // [B, E] residual stream (written only after a gather)
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
  double* off[3];            // [B] its rank-1 term, sum_i mixed[j][b, i] * offset[j][i]
  int nmix;
  const float* head_scale;   // ROW_HEAD: xs_h = ln_out(x) * head_scale,
  float* xs_h;               // [B, E]   and off_h = ln_out(x) . offset[0]
  float* off_h;              // [B]
  const float* qscale[3];    // a8: [E] scale vector of the matrix that reads mixed[j]
  float* amax[3];            // a8: [B] max_i |mixed[j][b, i] * qscale[j][i]|
                             //   (ROW_HEAD: amax[0] = max_i |xs_h[b, i]|)
};

template <typename T>
__device__ __forceinline__ T row_sum(T v, T* scratch) {
  T t[1] = {v};
  block_sums<1>(t, scratch);
  return t[0];
}

// LayerNorm of the nb rows v[bi * ld : bi * ld + E] (shared memory), in
// place, all at once (one block reduction per statistic); eps 1e-8.
// EXACT (the a8 step): the arithmetic of ops/layernorm.py, mean and variance
// summed in double (exact products; the order of a double sum moves the f32
// result only at a rounding tie), each f32 operation rounded on its own.
// Else f32 sums and rsqrtf, within f32 rounding of it. scratch holds
// BT * 33 values.
template <bool EXACT, int BT>
__device__ __forceinline__ void rows_layer_norm(float* v, int nb, int ld, int E, const float* w, const float* b,
                                std::conditional_t<EXACT, double, float>* scratch) {
  using acc_t = std::conditional_t<EXACT, double, float>;
  acc_t s[BT], q[BT];
  float mean[BT], rs[BT];
#pragma unroll
  for (int bi = 0; bi < BT; ++bi) s[bi] = q[bi] = 0;
  for (int i = threadIdx.x; i < E; i += blockDim.x)
#pragma unroll
    for (int bi = 0; bi < BT; ++bi)
      if (bi < nb) s[bi] += (acc_t)v[bi * ld + i];
  block_sums<BT>(s, scratch);
#pragma unroll
  for (int bi = 0; bi < BT; ++bi) {
    if constexpr (EXACT) mean[bi] = (float)(s[bi] / (double)E);
    else mean[bi] = s[bi] / (float)E;
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x)
#pragma unroll
    for (int bi = 0; bi < BT; ++bi) {
      if (bi >= nb) continue;
      if constexpr (EXACT) {
        const double c = (double)__fsub_rn(v[bi * ld + i], mean[bi]);
        q[bi] += c * c;
      } else {
        const float c = v[bi * ld + i] - mean[bi];
        q[bi] = fmaf(c, c, q[bi]);
      }
    }
  block_sums<BT>(q, scratch);
#pragma unroll
  for (int bi = 0; bi < BT; ++bi) {
    if constexpr (EXACT) {
      const float var = (float)(q[bi] / (double)E);
      rs[bi] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-8f)));
    } else {
      rs[bi] = rsqrtf(q[bi] / (float)E + 1e-8f);
    }
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x)
#pragma unroll
    for (int bi = 0; bi < BT; ++bi) {
      if (bi >= nb) continue;
      float& x = v[bi * ld + i];
      if constexpr (EXACT) x = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean[bi]), rs[bi]), w[i]), b[i]);
      else x = (x - mean[bi]) * rs[bi] * w[i] + b[i];
    }
  __syncthreads();
}

// LayerNorm of the row in v[0:E] (shared memory), in place.
template <bool EXACT>
__device__ __forceinline__ void row_layer_norm(float* v, int E, const float* w, const float* b,
                                               std::conditional_t<EXACT, double, float>* scratch) {
  rows_layer_norm<EXACT, 1>(v, 1, E, E, w, b, scratch);
}

// The token-shift mix mix * xx + (1 - mix) * prev; EXACT: each operation
// rounded on its own, as the plain version.
template <bool EXACT>
__device__ __forceinline__ float token_mix(float mix, float xx, float prev) {
  if constexpr (EXACT) return __fadd_rn(__fmul_rn(mix, xx), __fmul_rn(__fsub_rn(1.f, mix), prev));
  else return mix * xx + (1.f - mix) * prev;
}

// Batch row b of a row operation, by the whole block: LayerNorm, the
// token-shift mixes, and the whole rank-1 offset sums of the matrices that
// read the mixed rows (EXACT: in double, rounded once by the consumer).
// v: E floats of shared memory; scratch, ascratch: 3 * 33 values each. x is
// read through L2: in the persistent decode stack an earlier phase of the
// same launch wrote it.
template <bool EXACT>
__device__ void row_run(const RowArgs& a, int b, float* v, float* scratch,
                        std::conditional_t<EXACT, double, float>* ascratch) {
  using acc_t = std::conditional_t<EXACT, double, float>;
  const int E = a.E;
  float* xrow = a.x + (size_t)b * E;
  if (a.tokens) {
    int t = a.tokens[b];
    t = t < 0 ? 0 : (t >= a.n_emb ? a.n_emb - 1 : t);  // clamp like a gather
    const float* er = a.emb + (size_t)t * E;
    for (int i = threadIdx.x; i < E; i += blockDim.x) v[i] = er[i];
    __syncthreads();
    row_layer_norm<EXACT>(v, E, a.ln0_w, a.ln0_b, ascratch);
    for (int i = threadIdx.x; i < E; i += blockDim.x) xrow[i] = v[i];
  } else {
    for (int i = threadIdx.x; i < E; i += blockDim.x) v[i] = __ldcg(xrow + i);
    __syncthreads();
  }
  row_layer_norm<EXACT>(v, E, a.ln_w, a.ln_b, ascratch);

  acc_t sums[3] = {0, 0, 0};  // EXACT: exact products, summed in double
  float maxes[3] = {0.f, 0.f, 0.f};
  if (a.mode == ROW_HEAD) {
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const float xs = v[i] * a.head_scale[i];
      a.xs_h[(size_t)b * E + i] = xs;
      sums[0] += (acc_t)v[i] * (acc_t)a.offset[0][i];
      if constexpr (EXACT) maxes[0] = fmaxf(maxes[0], fabsf(xs));
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
          const float m = token_mix<EXACT>(mj, xx, p);
          if constexpr (EXACT) maxes[j] = fmaxf(maxes[j], fabsf(m * a.qscale[j][i]));
          a.mixed[j][(size_t)b * E + i] = m;
          sums[j] += (acc_t)m * (acc_t)a.offset[j][i];
        }
      }
      prev_out[i] = xx;
    }
  }
  block_sums<3>(sums, ascratch);
  if constexpr (EXACT) block_maxes<3>(maxes, scratch);
  if (threadIdx.x == 0) {
    if (a.mode == ROW_HEAD) {
      a.off_h[b] = (float)sums[0];
      if constexpr (EXACT) a.amax[0][b] = maxes[0];
    } else {
      for (int j = 0; j < a.nmix; ++j) {
        a.off[j][b] = (double)sums[j];
        if constexpr (EXACT) a.amax[j][b] = maxes[j];
      }
    }
  }
}

}  // namespace rwkv
