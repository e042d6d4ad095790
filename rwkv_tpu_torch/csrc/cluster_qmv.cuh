// Split-K int8 matvec inside a thread-block cluster, chained to the launch
// before it by programmatic dependent launch (PDL): the launches of kernel
// K6 (tp_halves.cu).
//
// One launch computes, for one or two families of up to three matrices that
// share a contraction length K,
//
//     out_f[b, c] = epilogue( sum_k (a_m[b, k] * scale_m[k]) * W_m[k, c]  +  off_m[b] )
//
// with W_m int8 row-major [K, O_f] and off_m[b] = sum_k a_m[b, k] * offset_m[k]
// the rank-1 quant-offset term. The input a_m is either a plain [B, K] tensor
// (an earlier launch's output) or folded in: the token-shift mix
// mix_m * LayerNorm(x) + (1 - mix_m) * prev of a residual row x, whose
// LayerNorm every block computes from the whole row.
//
// Layout. A cluster of S blocks (S = 1, 2, 4 or 8) owns a tile of 64 output
// columns; block rank r of the cluster owns contraction rows
// [r * rows, (r + 1) * rows), rows = ceil(K / S). A block is 4 column
// threads x 16 columns (one 16-byte load a row) by 64 row slices.
//
// The split-K reduction never leaves the cluster: each block leaves its
// partial sums [B, 64] and its offset shares [B] in its own shared memory,
// the cluster synchronises, and rank r reduces columns
// [r * 64 / S, (r + 1) * 64 / S) by reading every rank's partial through
// distributed shared memory (cluster.map_shared_rank), in the fixed rank
// order 0..S-1, then runs the epilogue on them. A last cluster.sync() keeps
// every block's shared memory alive until its peers have read it. No global
// scratch, no counter, no atomic; one input gives the same bits on every call.
//
// The dependency. The launch is made with the programmatic-stream-
// serialization attribute, so it may start while the launch before it on
// the stream still runs. Before griddepcontrol.wait a block only reads what
// no launch writes: it issues all of its weights (its rows of its tile, for
// every matrix) into shared memory by cp.async, prefetches its small vectors
// into L2, and lets the next launch start (griddepcontrol.launch_dependents).
// Only after the wait does it read x, prev, the plain input or the WKV state,
// or write anything to device memory.
//
// Decode is bound by the weight bytes. Each block holds its share of the
// weights in shared memory (rows up to pass_rows; a longer share runs in
// passes, the later ones loaded after the first is summed) and reuses it for
// every group of BT batch rows.
#pragma once

#include <cooperative_groups.h>

#include "qmv.cuh"

namespace rwkv {

namespace cg = cooperative_groups;

constexpr int kCqTile = 64;                                  // output columns of a cluster
constexpr int kCqColThreads = kCqTile / kColsPerThread;      // 4
constexpr int kCqSlices = kThreads / kCqColThreads;          // 64 row slices (rows of a slab)
constexpr int kCqMaxCluster = 8;
constexpr int kCqMaxFams = 2;

struct CqFam {
  int nmat, O, tiles, epi;         // epi: EPI_STORE, EPI_WKV, EPI_RELU2 or EPI_SIGMOID
  const int8_t* w[kMaxMats];       // [K, O]
  const float* scale[kMaxMats];    // [K]
  const float* offset[kMaxMats];   // [K]
  const float* mix[kMaxMats];      // folded input: [K] token-shift mix of matrix m's input
  float* out;                      // [B, O]
  const float* aa_in;              // EPI_WKV: state slices [B, O]
  const float* bb_in;
  const float* pp_in;
  float* aa_out;
  float* bb_out;
  float* pp_out;
  const float* decay;              // EPI_WKV: [O]
  const float* bonus;
};

struct CqArgs {
  int B, K, nfam;
  CqFam fam[kCqMaxFams];
  const float* in;                 // [B, K] plain input, or null: the folded input below
  const float* x;                  // [B, K] residual rows
  const float* ln_w;               // [K]
  const float* ln_b;
  const float* prev;               // [B, K] token-shift memory before the step
  float* prev_out;                 // [B, K] LayerNorm(x), written by cluster 0 of family 0
  int rows;                        // contraction rows of a block: ceil(K / S)
  int pass_rows;                   // rows a pass holds, a multiple of kCqSlices
  int nmat_max;                    // every family's nmat, 1 or 3 (the kernel's NM)
};

__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// L2 prefetch of the 128-byte lines of n floats at p, dealt over the block.
__device__ __forceinline__ void cq_prefetch(const float* p, int n) {
  if (!p || n <= 0) return;
  for (int j = threadIdx.x; j * 32 < n; j += kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + (size_t)j * 32));
}

// Shared memory of a block, carved from one dynamic allocation.
struct CqSmem {
  int4* wsm;       // [nmat_max][pass_rows / 64][kThreads] weight slots, one per thread
  float* xs;       // [nmat_max][BT][pass_rows] staged, scaled activations
  float* res;      // [nmat_max][B][kCqTile] this block's partial sums (read by the cluster)
  double* offs;    // [nmat_max][B] this block's offset shares (read by the cluster)
  float* red;      // [kWarps][BT][kCqTile] per-warp sums
  float* stats;    // [B][2] mean and 1 / std of each batch row (folded input)
  double* dscr;    // [kMaxMats * BT * 33] block reduction scratch (doubles)
};

__host__ __device__ inline size_t cq_align(size_t n) { return (n + 15) / 16 * 16; }

// Bytes of CqSmem for a launch; carve != null lays the pointers out.
__host__ __device__ inline size_t cq_smem_bytes(int BT, int nmat, int pass_rows, int B,
                                                unsigned char* base = nullptr,
                                                CqSmem* carve = nullptr) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += cq_align(bytes);
    return p;
  };
  unsigned char* wsm = take((size_t)nmat * (pass_rows / kCqSlices) * kThreads * 16);
  unsigned char* offs = take((size_t)nmat * B * sizeof(double));
  unsigned char* dscr = take((size_t)kMaxMats * BT * 33 * sizeof(double));
  unsigned char* xs = take((size_t)nmat * BT * pass_rows * sizeof(float));
  unsigned char* res = take((size_t)nmat * B * kCqTile * sizeof(float));
  unsigned char* red = take((size_t)kWarps * BT * kCqTile * sizeof(float));
  unsigned char* stats = take((size_t)B * 2 * sizeof(float));
  if (carve) {
    carve->wsm = reinterpret_cast<int4*>(wsm);
    carve->offs = reinterpret_cast<double*>(offs);
    carve->dscr = reinterpret_cast<double*>(dscr);
    carve->xs = reinterpret_cast<float*>(xs);
    carve->res = reinterpret_cast<float*>(res);
    carve->red = reinterpret_cast<float*>(red);
    carve->stats = reinterpret_cast<float*>(stats);
  }
  return off;
}

// One pass's weights, rows [pk0, pk0 + pn) of every matrix, into this
// thread's slots by cp.async (a row past pn or a column past O zero-filled).
__device__ __forceinline__ void cq_load_weights(const CqFam& fm, int col, bool col_ok, int pk0,
                                                int pn, int nsl, int4* wsm) {
  const int tid = threadIdx.x, ks = tid / kCqColThreads;
  for (int m = 0; m < fm.nmat; ++m) {
    const int8_t* wb = fm.w[m] + (size_t)pk0 * fm.O + (col_ok ? col : 0);
    for (int u = 0; u < nsl; ++u) {
      const int r = ks + u * kCqSlices;
      const bool ok = col_ok && r < pn;
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(wsm + (m * nsl + u) * kThreads + tid));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                   "l"(ok ? wb + (size_t)r * fm.O : fm.w[m]), "r"(ok ? 16 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The epilogue of one output element: v[m] are matrix m's sums with their
// offset terms. Each operation rounded on its own, in the plain version's
// order (qmv.cuh's epilogue, operation for operation).
__device__ __forceinline__ void cq_epilogue(const CqFam& fm, const float (&v)[kMaxMats],
                                            size_t idx, int gc) {
  float o = 0.f;
  switch (fm.epi) {
    case EPI_STORE:
      o = v[0];
      break;
    case EPI_RELU2: {
      const float r = fmaxf(v[0], 0.f);
      o = __fmul_rn(r, r);
      break;
    }
    case EPI_SIGMOID:
      o = sigmoidf_(v[0]);
      break;
    case EPI_WKV: {  // ops/wkv.py::wkv_step
      const float k = v[0], vv = v[1], r = v[2];
      const float aa = __ldcg(fm.aa_in + idx), bb = __ldcg(fm.bb_in + idx),
                  pp = __ldcg(fm.pp_in + idx);
      const float ww = __fadd_rn(fm.bonus[gc], k);
      const float q = fmaxf(pp, ww);
      const float e1 = expf(__fsub_rn(pp, q)), e2 = expf(__fsub_rn(ww, q));
      const float y = __fdiv_rn(__fadd_rn(__fmul_rn(e1, aa), __fmul_rn(e2, vv)),
                                __fadd_rn(__fmul_rn(e1, bb), e2));
      const float ww2 = __fadd_rn(pp, fm.decay[gc]);
      const float p2 = fmaxf(ww2, k);
      const float f1 = expf(__fsub_rn(ww2, p2)), f2 = expf(__fsub_rn(k, p2));
      fm.aa_out[idx] = __fadd_rn(__fmul_rn(f1, aa), __fmul_rn(f2, vv));
      fm.bb_out[idx] = __fadd_rn(__fmul_rn(f1, bb), f2);
      fm.pp_out[idx] = p2;
      o = __fmul_rn(sigmoidf_(r), y);
      break;
    }
  }
  fm.out[idx] = o;
}

// The launch: blocks [S * c, S * (c + 1)) are cluster c, which owns tile c
// of family 0, or tile c - fam[0].tiles of family 1.
template <int BT, int NM>
__global__ void __launch_bounds__(kThreads, 2) cq_kernel(const __grid_constant__ CqArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / S;
  const int f = cid < a.fam[0].tiles ? 0 : 1;
  const CqFam& fm = a.fam[f];
  const int tile = f ? cid - a.fam[0].tiles : cid;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int ct = tid % kCqColThreads, ks = tid / kCqColThreads;
  const int col0 = tile * kCqTile, col = col0 + ct * kColsPerThread;
  const bool col_ok = col < fm.O;  // O % 16 == 0: a thread's 16 columns are all in or all out
  const int B = a.B, K = a.K;
  const int k0 = min(K, rank * a.rows), k1 = min(K, k0 + a.rows);
  const int nsl = a.pass_rows / kCqSlices;
  const bool fold = a.in == nullptr;
  const bool owner = fold && f == 0 && tile == 0;  // writes prev_out
  CqSmem sm;
  cq_smem_bytes(BT, a.nmat_max, a.pass_rows, B, smem_raw, &sm);

  // Before the wait: read-only weights and vectors only.
  cq_load_weights(fm, col, col_ok, k0, min(a.pass_rows, k1 - k0), nsl, sm.wsm);
  for (int m = 0; m < NM; ++m) {
    cq_prefetch(fm.scale[m] + k0, k1 - k0);
    cq_prefetch(fm.offset[m] + k0, k1 - k0);
    if (fold) cq_prefetch(fm.mix[m] + k0, k1 - k0);
  }
  if (fold) {
    cq_prefetch(a.ln_w, K);
    cq_prefetch(a.ln_b, K);
  }
  if (fm.epi == EPI_WKV) {
    cq_prefetch(fm.decay + col0, min(kCqTile, fm.O - col0));
    cq_prefetch(fm.bonus + col0, min(kCqTile, fm.O - col0));
  }
  griddep_launch_dependents();
  griddep_wait();

  // The LayerNorm statistics of every batch row, from the whole row of x,
  // as ops/layernorm.py takes them: mean and variance summed in double
  // (exact products) and rounded once, 1 / sqrt(var + 1e-8) in two
  // correctly rounded operations.
  if (fold) {
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      double s[BT], q[BT];
#pragma unroll
      for (int bi = 0; bi < BT; ++bi) s[bi] = q[bi] = 0.0;
      for (int i = tid; i < K; i += kThreads)
#pragma unroll
        for (int bi = 0; bi < BT; ++bi)
          if (bi < nb) s[bi] += (double)__ldcg(a.x + (size_t)(b0 + bi) * K + i);
      block_sums<BT>(s, sm.dscr);
      float mean[BT];
#pragma unroll
      for (int bi = 0; bi < BT; ++bi) mean[bi] = (float)(s[bi] / (double)K);
      for (int i = tid; i < K; i += kThreads)
#pragma unroll
        for (int bi = 0; bi < BT; ++bi)
          if (bi < nb) {
            const double c = (double)__fsub_rn(__ldcg(a.x + (size_t)(b0 + bi) * K + i), mean[bi]);
            q[bi] += c * c;
          }
      block_sums<BT>(q, sm.dscr);
      if (tid < nb) {
        const float var = (float)(q[tid] / (double)K);
        sm.stats[(b0 + tid) * 2] = mean[tid];
        sm.stats[(b0 + tid) * 2 + 1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-8f)));
      }
    }
    __syncthreads();
  }

  for (int pk0 = k0, pass = 0; pass == 0 || pk0 < k1; pk0 += a.pass_rows, ++pass) {
    const int pn = max(0, min(a.pass_rows, k1 - pk0));
    if (pass > 0) {
      __syncthreads();  // every thread is done with the last pass's weights
      cq_load_weights(fm, col, col_ok, pk0, pn, nsl, sm.wsm);
    }
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      // Stage the activations of rows [pk0, pk0 + pn), scaled, and sum
      // their offset shares (exact products, summed in double).
      double share[NM * BT];
#pragma unroll
      for (int j = 0; j < NM * BT; ++j) share[j] = 0.0;
#pragma unroll
      for (int bi = 0; bi < BT; ++bi) {
        const int b = b0 + bi;
        float mean = 0.f, rs = 0.f;
        if (fold && bi < nb) {
          mean = sm.stats[b * 2];
          rs = sm.stats[b * 2 + 1];
        }
        for (int r = tid; r < a.pass_rows; r += kThreads) {
          const bool ok = bi < nb && r < pn;
          const int k = pk0 + r;
          float act[NM];
          if (fold) {
            float xx = 0.f, pv = 0.f;
            if (ok) {
              const float c = __fsub_rn(__ldcg(a.x + (size_t)b * K + k), mean);
              xx = __fadd_rn(__fmul_rn(__fmul_rn(c, rs), a.ln_w[k]), a.ln_b[k]);
              pv = __ldcg(a.prev + (size_t)b * K + k);
              if (owner) a.prev_out[(size_t)b * K + k] = xx;
            }
#pragma unroll
            for (int m = 0; m < NM; ++m) {
              const float mj = ok ? fm.mix[m][k] : 0.f;
              act[m] = __fadd_rn(__fmul_rn(mj, xx), __fmul_rn(__fsub_rn(1.f, mj), pv));
            }
          } else {
            const float in = ok ? __ldcg(a.in + (size_t)b * K + k) : 0.f;
#pragma unroll
            for (int m = 0; m < NM; ++m) act[m] = in;
          }
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            float v = 0.f;
            if (ok) {
              share[m * BT + bi] += (double)act[m] * (double)fm.offset[m][k];
              v = __fmul_rn(act[m], fm.scale[m][k]);
            }
            sm.xs[(m * BT + bi) * a.pass_rows + r] = v;
          }
        }
      }
      block_sums<NM * BT>(share, sm.dscr);  // its barriers order the staging
      if (tid == 0)
        for (int m = 0; m < NM; ++m)
          for (int bi = 0; bi < nb; ++bi) {
            double& o = sm.offs[m * B + b0 + bi];
            o = pass == 0 ? share[m * BT + bi] : o + share[m * BT + bi];
          }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();  // every thread's weight slots have landed

#pragma unroll 1
      for (int m = 0; m < NM; ++m) {
        float acc[BT][kColsPerThread];
#pragma unroll
        for (int bi = 0; bi < BT; ++bi)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[bi][j] = 0.f;
        const float* xm = sm.xs + (size_t)m * BT * a.pass_rows + ks;
        const int4* wm = sm.wsm + (size_t)m * nsl * kThreads + tid;
#pragma unroll 4
        for (int u = 0; u < nsl; ++u)
          accumulate<BT, kQ8>(acc, wm[u * kThreads], xm + u * kCqSlices, a.pass_rows, 0);
        // the 8 row slices of a warp by shuffles (lane = slice * 4 + column
        // thread), then the 8 warps in order
#pragma unroll
        for (int bi = 0; bi < BT; ++bi)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            float v = acc[bi][j];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            acc[bi][j] = v;
          }
        if (lane < kCqColThreads)
#pragma unroll
          for (int bi = 0; bi < BT; ++bi)
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j)
              sm.red[(wid * BT + bi) * kCqTile + ct * kColsPerThread + j] = acc[bi][j];
        __syncthreads();
        for (int i = tid; i < nb * kCqTile; i += kThreads) {
          const int bi = i / kCqTile, c = i - bi * kCqTile;
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v += sm.red[(w * BT + bi) * kCqTile + c];
          float& o = sm.res[((size_t)m * B + b0 + bi) * kCqTile + c];
          o = pass == 0 ? v : o + v;
        }
        __syncthreads();  // red and xs are rewritten next
      }
    }
  }

  // The cluster's reduction: rank r sums columns [r * cw, (r + 1) * cw) of
  // every rank's partials, ranks in order, and runs the epilogue.
  cluster.sync();
  const int cw = kCqTile / S;
  for (int i = tid; i < B * cw; i += kThreads) {
    const int b = i / cw, c = rank * cw + (i - b * cw), gc = col0 + c;
    if (gc >= fm.O) continue;
    float v[kMaxMats] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float part[kCqMaxCluster];
      double offp[kCqMaxCluster];
#pragma unroll
      for (int q = 0; q < kCqMaxCluster; ++q) {  // every rank's loads in flight at once
        part[q] = 0.f;
        offp[q] = 0.0;
        if (q < S) {
          part[q] = cluster.map_shared_rank(sm.res, q)[((size_t)m * B + b) * kCqTile + c];
          offp[q] = cluster.map_shared_rank(sm.offs, q)[m * B + b];
        }
      }
      float sum = 0.f;
      double off = 0.0;
#pragma unroll
      for (int q = 0; q < kCqMaxCluster; ++q) {  // ranks in order (a missing rank adds 0)
        sum += part[q];
        off += offp[q];
      }
      v[m] = __fadd_rn(sum, (float)off);  // the rank-1 term summed in double, rounded once
    }
    cq_epilogue(fm, v, (size_t)b * fm.O + gc, gc);
  }
  cluster.sync();  // no block exits while a peer may still read its shared memory
}

// How a launch is cut: the cluster size S, the rows of a block and of a
// pass, and the dynamic shared memory.
struct CqPlan {
  int S, rows, pass_rows, ctas, BT;
  size_t smem;
};

inline int cq_bt(int B) { return B <= 1 ? 1 : (B <= 2 ? 2 : 4); }

// The fewest blocks a tile (a power of two up to 8) that still give every SM
// of the card a block, no rank left without rows; a block's share held in
// shared memory whole where it fits smem_max, else in passes.
inline CqPlan cq_plan(int B, int K, int nmat, int tiles, int sms, size_t smem_max) {
  CqPlan p = {};
  p.BT = cq_bt(B);
  int S = 1;
  while (S < kCqMaxCluster && S * tiles < sms) S *= 2;
  while (S > 1 && (S - 1) * ((K + S - 1) / S) >= K) S /= 2;
  p.S = S;
  p.rows = (K + S - 1) / S;
  const int whole = (p.rows + kCqSlices - 1) / kCqSlices * kCqSlices;
  int pr = whole;
  while (pr > kCqSlices && cq_smem_bytes(p.BT, nmat, pr, B) > smem_max) pr -= kCqSlices;
  p.pass_rows = pr;  // at one slab a pass, a launch that still does not fit is refused
  p.ctas = S * tiles;
  p.smem = cq_smem_bytes(p.BT, nmat, pr, B);
  return p;
}

template <int BT, int NM>
inline cudaError_t cq_launch_bt(const CqArgs& a, const CqPlan& p, cudaStream_t st,
                                int* max_clusters) {
  auto kern = cq_kernel<BT, NM>;
  static size_t opted[64];  // the shared memory this kernel is opted in to, by device
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d >= 64 || p.smem > opted[d]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // a refused call: not left behind for the next launch's check
      return e;
    }
    if (d < 64) opted[d] = p.smem;
  }
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.S;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  if (max_clusters)  // co-resident clusters: a launch of more runs in waves
    return cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  const cudaError_t last = cudaGetLastError();  // read either way: nothing left behind
  return e != cudaSuccess ? e : last;
}

// Launches (or, with max_clusters, only sizes: no launch) the cluster
// matvec of plan p on `st`; returns the CUDA error.
inline cudaError_t cq_launch(const CqArgs& a, const CqPlan& p, cudaStream_t st,
                             int* max_clusters = nullptr) {
  if (a.nmat_max == 3) {
    if (p.BT == 1) return cq_launch_bt<1, 3>(a, p, st, max_clusters);
    if (p.BT == 2) return cq_launch_bt<2, 3>(a, p, st, max_clusters);
    return cq_launch_bt<4, 3>(a, p, st, max_clusters);
  }
  if (a.nmat_max != 1) return cudaErrorInvalidValue;
  if (p.BT == 1) return cq_launch_bt<1, 1>(a, p, st, max_clusters);
  if (p.BT == 2) return cq_launch_bt<2, 1>(a, p, st, max_clusters);
  return cq_launch_bt<4, 1>(a, p, st, max_clusters);
}

}  // namespace rwkv
