// The machinery of a persistent decode stack, shared by the unsharded stack
// (decode_stack.cu: kernels K1, K4 and K5's stack) and the tensor-parallel
// stack (decode_stack_tp.cu: kernel K7).
//
// A stack kernel is one cooperative launch of as many blocks as fit on the
// card at once (coop_grid: the occupancy API's blocks per SM times the SMs),
// every block resident. Its phases are matvecs (qmv.cuh's qmv_run, inlined)
// separated by grid barriers (grid.cuh). A phase deals its (matrix, column
// tile, split) items over the blocks, at most one each where the card holds
// them all (stack_split). The assignment is static and the weights are
// read-only, so each block issues the loads of its next item's weights
// between arriving at the barrier and leaving it (qmv_load_async into wsm),
// and the small vectors of the next phase go to L2 in the same wait
// (prefetch_qmv, prefetch_fold): their memory round trips overlap the wait,
// and after the barrier only the activations are staged. stack_phases is
// that loop; a kernel gives it a plan that describes each phase.
//
// Folding a row phase (FoldSrc): a LayerNorm and a token-shift mix need the
// whole row of x, which the phase before wrote. So every block of a folded
// phase computes, from x, the LayerNorm of its batch rows, and the whole
// rank-1 offset sums and (a8) row maxima of the mixes, with the same code in
// the same order, so every block gets the same bits; it stages the mixes of
// its own contraction rows from those LayerNormed rows. The [B, E] outputs
// (x after ln0 or after an exchange, the new xy or dd, K1's receptance mix)
// are written in shares, each element by one block.
//
// In the tensor-parallel stack (TP) the fold also completes the shards'
// exchange, the step's only communication: x plus the tp shards' partials
// (times the ffn gate), summed in the fixed order 0..tp-1 as the JAX kernel
// sums the chunks it receives in sender order; or, at layer 0, the
// vocab-sharded embedding gather summed over the shards. Every block sums
// with the same code, so every block gets the same x; the block that owns a
// share writes it to a second x buffer (resid_out), never to the one the
// phase reads.
#pragma once

#include <type_traits>

#include "grid.cuh"
#include "row.cuh"

namespace rwkv {

constexpr int kMinSplitRows = 16;  // weight rows of the narrowest split

// Split of the contraction for one matvec phase over G resident blocks: as
// many (tile, split) items as there are blocks (one each: a second item a
// block would add a second chain of latencies, measured slower than one long
// split), within kMaxSplit, the partial scratch, and at least kMinSplitRows
// weight rows a split.
__device__ __host__ inline int stack_split(int tiles, int kmax, int nmat, int B, int O,
                                           long long cap, int counter_cap, int G) {
  if (tiles >= G || tiles > counter_cap) return 1;
  int S = G / tiles;
  S = S < kMaxSplit ? S : kMaxSplit;
  const int by_rows = kmax / kMinSplitRows > 1 ? kmax / kMinSplitRows : 1;
  S = S < by_rows ? S : by_rows;
  while (S > 1 && (long long)S * nmat * B * O > cap) --S;
  return S;
}

// Weight rows of the longest matrix of q.
template <int FMT>
__device__ __forceinline__ int qmv_kmax(const QmvArgs& q) {
  int kmax = 0;
  for (int m = 0; m < q.nmat; ++m) kmax = max(kmax, mat_rows<FMT>(q.m[m]));
  return kmax;
}

// Elementwise float4 sum and product, each rounded on its own.
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

// The source of a folded phase: matrices [0, nfold) read token-shift mixes
// of the LayerNormed rows xx, which prologue() computes for every batch
// group from x (K1's phase A of layer 0: from the embedding rows, after ln0),
// with the whole-row rank-1 terms (offs) and a8 maxima (amax) of all nmix
// mixes, in shared memory. A block's first item also writes its share
// [lo, hi) of the rows' [B, E] outputs (x after ln0, prev_out, and in K1's
// phase C the receptance mix fr_out) and, on block 0, the receptance mix's
// offset term and maximum.
//
// TP (kernel K7): x is resid plus the exchange (add, gate) or the summed
// vocab-sharded gather; the exchanged x goes to resid_out; `head`: the
// matrices read the LayerNormed rows themselves (ln_out before the head) and
// offset[0]'s sum is the head's rank-1 term. A prologue for the batch group
// xx already holds (`cached`) returns at once: a block's later items of one
// phase reuse it.
template <int BT, bool EXACT, bool TP = false>
struct FoldSrc {
  using acc_t = std::conditional_t<EXACT, double, float>;
  int E, B, nfold, nmix, lo, hi;
  const int* tokens;  // layer 0: gather + ln0 first
  const float* emb;
  const float* ln0_w;
  const float* ln0_b;
  float* resid;       // [B, E] x, the residual stream
  const float* ln_w;
  const float* ln_b;
  const float* prev;  // [B, E] xy or dd before the step
  float* prev_out;
  const float* mix[3];
  const float* offset[3];
  const float* qscale[3];
  float* fr_out;      // C: [B, E] the receptance mix, or null
  double* fr_off;     // C, block 0: [B] its rank-1 term, or null
  float* fr_amax;     // C, block 0, a8: [B] its maximum
  int n_emb;
  float* xx;          // shared: [BT, E]
  double* offs;       // shared: [3, B]
  float* amax;        // shared: [3, B]
  acc_t* ascratch;    // shared: 3 * BT * 33
  float* fscratch;    // shared: 3 * BT * 33
  // TP only
  int tp, El, cached;
  bool head;
  const float* embs[kMaxShards];  // shard p's vocab rows [p * n_emb, (p + 1) * n_emb)
  const float* emb_slots;         // or, across cards: [tp, B, E] each shard's gathered rows
  const float* add;               // [tp, B, E] partials, or null
  const float* gate;              // [tp, B, El], or null
  float* resid_out;               // [B, E] the exchanged x, or null

  __device__ __forceinline__ bool local(int m) const { return m < nfold; }

  __device__ __forceinline__ float x(const Mat& mt, int m, int b, int bi, int k) const {
    if (m < nfold) {
      if (TP && head) return xx[bi * E + k];
      return token_mix<EXACT>(mix[m][k], xx[bi * E + k], prev[(size_t)b * E + k]);
    }
    return __ldcg(mt.x + (size_t)b * mt.K + k);
  }

  // TP: x before the LayerNorm, in float4 elements base + u * kThreads of
  // rows [b0, b0 + nb), each operation rounded on its own in the plain
  // version's order; every load of the N elements issued before the first
  // use, so they share one memory round trip.
  template <int N>
  __device__ __forceinline__ void tp_rows4(int b0, int nb, int base, float4 (&t)[N]) const {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const int E4 = E / 4;
    if (tokens) {  // the vocab-sharded gather, summed over the shards
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int i = base + u * kThreads, bi = i / E4, k4 = i - bi * E4;
        t[u] = z;
        if (i >= nb * E4) continue;
        const int tk = tokens[b0 + bi];
        for (int p = 0; p < tp; ++p) {
          const int rel = tk - p * n_emb;
          float4 e = z;
          if (emb_slots)  // the row shard p gathered, zero outside its vocab
            e = __ldcg(reinterpret_cast<const float4*>(emb_slots) +
                       ((size_t)p * B + b0 + bi) * E4 + k4);
          else if (rel >= 0 && rel < n_emb)
            e = reinterpret_cast<const float4*>(embs[p] + (size_t)rel * E)[k4];
          t[u] = p == 0 ? e : add4(t[u], e);
        }
      }
      return;
    }
    const float4* r4 = reinterpret_cast<const float4*>(resid);
    const float4* a4 = reinterpret_cast<const float4*>(add);
    const size_t BE4 = (size_t)B * E4;
    float4 s[N], g[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = base + u * kThreads, bi = i / E4, k4 = i - bi * E4, k = 4 * k4, p = k / El;
      const bool ok = i < nb * E4;
      const size_t o = (size_t)(b0 + bi) * E4 + k4;
      t[u] = ok ? __ldcg(r4 + o) : z;
      s[u] = ok && add ? __ldcg(a4 + o) : z;
      g[u] = ok && gate ? __ldcg(reinterpret_cast<const float4*>(
                              gate + ((size_t)p * B + b0 + bi) * El + (k - p * El)))
                        : z;
    }
    for (int p = 1; p < tp; ++p) {
      float4 ap[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int i = base + u * kThreads, bi = i / E4, k4 = i - bi * E4;
        ap[u] = i < nb * E4 && add ? __ldcg(a4 + p * BE4 + (size_t)(b0 + bi) * E4 + k4) : z;
      }
#pragma unroll
      for (int u = 0; u < N; ++u) s[u] = add4(s[u], ap[u]);
    }
    if (add) {
#pragma unroll
      for (int u = 0; u < N; ++u) t[u] = add4(t[u], gate ? mul4(g[u], s[u]) : s[u]);
    }
  }

  __device__ __forceinline__ void prologue(int b0, int nb) const {
    if constexpr (TP) {
      if (b0 == cached) return;
    }
    const bool ident = TP && head;       // the head reads xx itself
    const int tid = threadIdx.x, E4 = E / 4;  // E % 16 == 0: rows of float4
    // the source rows, float4 at a time, kRowLoads loads in flight a thread
    constexpr int kRowLoads = 4;
    for (int base = tid; base < nb * E4; base += kRowLoads * kThreads) {
      float4 t[kRowLoads];
      if constexpr (TP) {
        tp_rows4(b0, nb, base, t);
      } else {
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) {
          const int i = base + u * kThreads, bi = i / E4, k4 = i - bi * E4;
          t[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < nb * E4) {
            if (tokens) {
              int tk = tokens[b0 + bi];
              tk = tk < 0 ? 0 : (tk >= n_emb ? n_emb - 1 : tk);  // clamp like a gather
              t[u] = reinterpret_cast<const float4*>(emb + (size_t)tk * E)[k4];
            } else {
              t[u] = __ldcg(reinterpret_cast<const float4*>(resid + (size_t)(b0 + bi) * E) + k4);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int i = base + u * kThreads;
        if (i < nb * E4) reinterpret_cast<float4*>(xx)[i] = t[u];
      }
    }
    __syncthreads();
    const int w = hi - lo;
    if constexpr (TP) {
      if (tokens) rows_layer_norm<EXACT, BT>(xx, nb, E, E, ln0_w, ln0_b, ascratch);
      if (resid_out)
        for (int i = tid; i < nb * w; i += kThreads) {
          const int bi = i / w, k = lo + i - bi * w;
          resid_out[(size_t)(b0 + bi) * E + k] = xx[bi * E + k];
        }
    } else if (tokens) {
      rows_layer_norm<EXACT, BT>(xx, nb, E, E, ln0_w, ln0_b, ascratch);
      for (int i = tid; i < nb * w; i += kThreads) {
        const int bi = i / w, k = lo + i - bi * w;
        resid[(size_t)(b0 + bi) * E + k] = xx[bi * E + k];
      }
    }
    rows_layer_norm<EXACT, BT>(xx, nb, E, E, ln_w, ln_b, ascratch);
    if (!ident)
      for (int i = tid; i < nb * w; i += kThreads) {
        const int bi = i / w, k = lo + i - bi * w;
        const size_t g = (size_t)(b0 + bi) * E + k;
        prev_out[g] = xx[bi * E + k];
        if (fr_out) fr_out[g] = token_mix<EXACT>(mix[1][k], xx[bi * E + k], prev[g]);
      }

    acc_t sums[3 * BT];  // EXACT: exact products, summed in double
    float maxes[3 * BT];
#pragma unroll
    for (int j = 0; j < 3 * BT; ++j) {
      sums[j] = 0;
      maxes[j] = 0.f;
    }
    for (int i4 = tid; i4 < E4; i4 += kThreads) {
      // four elements a thread, every load first (predicated, no early
      // exit), so they share one memory round trip
      float4 xv[BT], pv[BT], mj[3], oj[3], qj[3];
#pragma unroll
      for (int bi = 0; bi < BT; ++bi) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        xv[bi] = bi < nb ? reinterpret_cast<const float4*>(xx + bi * E)[i4] : z;
        pv[bi] = bi < nb && !ident ? reinterpret_cast<const float4*>(prev + (size_t)(b0 + bi) * E)[i4]
                                   : z;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        mj[j] = j < nmix && !ident ? reinterpret_cast<const float4*>(mix[j])[i4] : z;
        oj[j] = j < nmix ? reinterpret_cast<const float4*>(offset[j])[i4] : z;
        qj[j] = EXACT && j < nmix ? reinterpret_cast<const float4*>(qscale[j])[i4] : z;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int bi = 0; bi < BT; ++bi) {
          if (j >= nmix || bi >= nb) continue;
          const float xs[4] = {xv[bi].x, xv[bi].y, xv[bi].z, xv[bi].w};
          const float ps[4] = {pv[bi].x, pv[bi].y, pv[bi].z, pv[bi].w};
          const float ms[4] = {mj[j].x, mj[j].y, mj[j].z, mj[j].w};
          const float os[4] = {oj[j].x, oj[j].y, oj[j].z, oj[j].w};
          const float qs[4] = {qj[j].x, qj[j].y, qj[j].z, qj[j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float m = ident ? xs[e] : token_mix<EXACT>(ms[e], xs[e], ps[e]);
            sums[j * BT + bi] += (acc_t)m * (acc_t)os[e];
            if constexpr (EXACT) maxes[j * BT + bi] = fmaxf(maxes[j * BT + bi], fabsf(m * qs[e]));
          }
        }
    }
    block_sums<3 * BT>(sums, ascratch);
    if constexpr (EXACT) block_maxes<3 * BT>(maxes, fscratch);
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int bi = 0; bi < BT; ++bi) {
          if (j >= nmix || bi >= nb) continue;
          offs[j * B + b0 + bi] = (double)sums[j * BT + bi];
          amax[j * B + b0 + bi] = maxes[j * BT + bi];
          if (j == 1 && fr_off) {
            fr_off[b0 + bi] = (double)sums[j * BT + bi];
            if constexpr (EXACT) fr_amax[b0 + bi] = maxes[j * BT + bi];
          }
        }
      if constexpr (TP) const_cast<FoldSrc*>(this)->cached = b0;
    }
    __syncthreads();
  }
};

// L2 prefetch of `floats` floats at p, the 128-byte lines dealt over every
// thread of the grid (most threads take none).
__device__ __forceinline__ void prefetch_l2(const float* p, size_t floats) {
  if (!p) return;
  const size_t lines = (floats * sizeof(float) + 127) / 128, step = (size_t)gridDim.x * kThreads;
  for (size_t j = blockIdx.x + (size_t)gridDim.x * threadIdx.x; j < lines; j += step)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + j * 32));
}

// The small inputs of a phase's matvec q (scales, the state and the
// epilogue's vectors) and of its fold source (norms, mixes, offsets, the
// previous xy or dd), into L2 while the grid waits at the barrier before
// it; else each is a DRAM round trip in the phase's chain, the weights
// streaming past having evicted it since the last step.
__device__ __forceinline__ void prefetch_qmv(const QmvArgs& q) {
  const size_t BO = (size_t)q.B * q.O;
  for (int m = 0; m < q.nmat; ++m) prefetch_l2(q.m[m].scale, q.m[m].K);
  prefetch_l2(q.aa_in, BO);
  prefetch_l2(q.bb_in, BO);
  prefetch_l2(q.pp_in, BO);
  prefetch_l2(q.decay, q.O);
  prefetch_l2(q.bonus, q.O);
  prefetch_l2(q.next_offset, q.O);
  prefetch_l2(q.next_scale, q.O);
}

template <int BT, bool EXACT, bool TP>
__device__ __forceinline__ void prefetch_fold(const FoldSrc<BT, EXACT, TP>& src) {
  const int E = src.E;
  prefetch_l2(src.ln_w, E);
  prefetch_l2(src.ln_b, E);
  prefetch_l2(src.prev, (size_t)src.B * E);
  for (int j = 0; j < src.nmix; ++j) {
    prefetch_l2(src.mix[j], E);
    prefetch_l2(src.offset[j], E);
  }
}

// Bytes of the matvec tile's shared memory, rounded up to 16.
template <int BT, int FMT>
constexpr size_t kStackQmvBytes = (sizeof(QmvSmem<BT, FMT>) + 15) / 16 * 16;

constexpr size_t kWeightSlots = (size_t)kMaxMats * kUnroll * kThreads;  // 16-byte slots an item

// Dynamic shared memory of a stack kernel: the matvec tile, the weights of
// the block's next item (cp.async: all of a short split, the first 128-row
// group of a long one), BT LayerNormed rows, then the folded mixes' [3, B]
// offset terms and maxima.
template <int BT, int FMT>
inline size_t stack_smem(int E, int B) {
  return kStackQmvBytes<BT, FMT> + kWeightSlots * sizeof(int4) + (size_t)BT * E * sizeof(float) +
         3 * (size_t)B * (sizeof(double) + sizeof(float));
}

// The dynamic shared memory of a stack kernel, carved as stack_smem says.
template <int BT, int FMT>
struct StackSmem {
  QmvSmem<BT, FMT>* sm;
  int4* wsm;
  float* xx;
  double* offs;
  float* amax;

  __device__ __forceinline__ void carve(unsigned char* base, int E, int B) {
    sm = reinterpret_cast<QmvSmem<BT, FMT>*>(base);
    wsm = reinterpret_cast<int4*>(base + kStackQmvBytes<BT, FMT>);
    xx = reinterpret_cast<float*>(wsm + kWeightSlots);
    offs = reinterpret_cast<double*>(xx + (size_t)BT * E);  // E % 16 == 0: aligned
    amax = reinterpret_cast<float*>(offs + 3 * (size_t)B);
  }
};

// Block 0's %globaltimer stamps: one at the start, one after each barrier,
// one at the end, or none without a buffer.
struct Stamps {
  unsigned long long* t;
  int n;

  __device__ __forceinline__ void operator()() {
    at(n);
    ++n;
  }
  // a stamp at entry i of its own (K7 across cards: the end of each wait)
  __device__ __forceinline__ void at(int i) const {
    if (t && blockIdx.x == 0 && threadIdx.x == 0) t[i] = globaltimer();
  }
};

// The phase loop of a stack kernel: n matvec phases, a grid barrier after
// each but the last (and after the last too with last_barrier). The plan P
// describes phase ph for every thread (describe, ending in __syncthreads),
// deals its items (items; item: the matvec, column tile, split and splits
// of item it), says whether it is folded (fold; fold_item prepares the fold
// source for the block's r-th item of the phase; src), prefetches its
// vectors into L2 (prefetch) and runs what follows each barrier
// (after_barrier: the time stamp; K7 across cards, the exchange's flags).
template <int BT, int FMT, class P>
__device__ __forceinline__ void stack_phases(P& p, int n, bool last_barrier, GridBarrier& bar,
                                             QmvSmem<BT, FMT>& sm, int4* wsm) {
  using Fold = typename P::Fold;
  const int G = gridDim.x;
  p.describe(0);
  bool loaded = false;  // wsm holds this block's first item of the phase
  for (int ph = 0; ph < n; ++ph) {
    const int items = p.items();
    if (p.fold()) {
      for (int it = blockIdx.x, r = 0; it < items; it += G, ++r) {
        int tile, s, S;
        const QmvArgs& q = p.item(it, tile, s, S);
        p.fold_item(it, r);
        qmv_run<BT, FMT, Fold>(q, tile, s, S, sm, wsm, loaded && r == 0, p.src());
      }
    } else {
      for (int it = blockIdx.x, r = 0; it < items; it += G, ++r) {
        int tile, s, S;
        const QmvArgs& q = p.item(it, tile, s, S);
        qmv_run<BT, FMT, GlobalSrc>(q, tile, s, S, sm, wsm, loaded && r == 0, GlobalSrc());
      }
    }
    loaded = false;
    if (ph + 1 == n && !last_barrier) break;
    bar.arrive();
    if (ph + 1 < n) {  // the next phase's inputs, fetched during the wait
      p.describe(ph + 1);
      p.prefetch();
      if ((int)blockIdx.x < p.items()) {
        int tile, s, S;
        const QmvArgs& q = p.item(blockIdx.x, tile, s, S);
        qmv_load_async<FMT>(q, tile, s, S, wsm);
        loaded = true;
      }
    }
    bar.wait();
    p.after_barrier();
  }
}

// Blocks of one cooperative launch of `kern` on the current device with
// `smem` bytes of dynamic shared memory (occupancy per SM times the SMs),
// after allowing that shared memory.
template <class Kernel>
cudaError_t coop_grid(Kernel kern, size_t smem, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  return cudaSuccess;
}

// One cooperative launch of kern(a) at coop_grid's grid, on `st`; the blocks
// in *grid. Returns the first CUDA error, the sticky error state cleared.
template <class Kernel, class Args>
cudaError_t coop_launch(Kernel kern, const Args& a, size_t smem, cudaStream_t st, int* grid) {
  cudaError_t e = coop_grid(kern, smem, grid);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(*grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<Args*>(&a)};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), args);
  const cudaError_t last = cudaGetLastError();  // read either way: nothing left behind
  return e != cudaSuccess ? e : last;
}

// Batch rows a group: 1, 2 or 4.
inline int stack_bt(int B) { return B <= 1 ? 1 : (B <= 2 ? 2 : 4); }

}  // namespace rwkv
