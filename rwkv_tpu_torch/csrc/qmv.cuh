// Quantized-weight matvec tile shared by the mm8, mm4 and decode_stack kernels.
//
// Computes, for up to three matrices that share an output width O,
//
//     acc_m[b, c] = sum_k (x_m[b, k] * scale_m[k]) * W_m[k, c]  +  off_m[b]
//
// with W_m int8 row-major [K_m, O] (ops/quant.py's to_signed layout), or, in
// the 4-bit instantiation (Q4), nibble-packed [K_m / 2, O] (ops/quant.py's
// Quant4Linear): byte [j, c] holds the code of row lo(j) in its low nibble,
// unsigned, and that of row lo(j) + h in its high nibble, two's complement
// minus 8, where h is half the matrix's pairing block and
// lo(j) = (j / h) * 2h + j % h. Both halves widen to q - 8 in registers. Then it
// runs one fused epilogue per output column (store, residual add, relu^2,
// gated residual, or the WKV recurrence). off_m[b] is the rank-1 offset term
// sum_k x_m[b, k] * offset_m[k]; the kernel that produced x_m computed it
// (whole, or as one partial per column tile that is summed here in a fixed
// order), so no block has to walk the whole contraction dim for it.
//
// Decode is bound by the bytes of W: every weight byte is read once, with
// 16-byte loads in which neighbouring threads read neighbouring columns, and
// widened to float in registers (a byte-permute into the mantissa of 2^23,
// then one subtract: exact, and cheaper than a conversion instruction). In
// Q4 one such load is 16 columns of two contraction rows; the split of the
// contraction below runs over packed rows, and each packed row stages the
// activations of its two rows, so a split may start anywhere in a block.
//
// Layout of a block (256 threads): 8 column threads x 16 columns = a tile of
// 128 output columns; 32 row slices walk the contraction dim, each thread
// keeping partial sums for up to 4 batch rows in registers (more rows loop).
//
// A tile of 128 columns leaves too few blocks for the card when O is E (8
// tiles at E = 1024), so the contraction is also split across gridDim.y
// blocks, at most 128 rows each where that fits: then every thread issues
// all of its weight loads, for every matrix, before it stages the
// activations, so one memory round trip covers the whole block. Each block
// writes its partial to global scratch; the last block of a column tile to
// arrive (an atomic counter, used only to elect it) sums the S partials, all
// loads in flight, in the fixed order s = 0..S-1, so the result does not
// depend on which block finished first.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rwkv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;                       // one 16-byte load
constexpr int kColThreads = 8;
constexpr int kTileO = kColThreads * kColsPerThread;     // 128 columns per tile
constexpr int kKSlices = kThreads / kColThreads;         // 32 row slices
constexpr int kUnroll = 4;
constexpr int kGroupRows = kKSlices * kUnroll;           // 128 rows: 4 loads a thread
constexpr int kChunkK = 512;                             // staged rows, long path
constexpr int kMaxMats = 3;
constexpr int kMaxSplit = 32;

enum Epilogue : int {
  EPI_STORE = 0,      // out = acc0 (+ row_add[b]) (+ col_add[c])
  EPI_WKV = 1,        // mats k, v, r: WKV step on aa/bb/pp, out = sigmoid(r) * y
  EPI_ADD = 2,        // out += acc0 (residual)
  EPI_RELU2 = 3,      // out = relu(acc0)^2
  EPI_GATED_ADD = 4,  // mats value, gate: out += sigmoid(acc1) * acc0
};

struct Mat {
  const float* x;        // [B, K] activations
  const float* scale;    // [K], or null: x is already scaled
  const float* off;      // [n_off, B] partials of the rank-1 term, or null
  int n_off;
  const int8_t* w;       // [K, O] int8 row-major; Q4: [K / 2, O] packed
  int K;
  int half;              // Q4: half the pairing block, in rows (K / 2: global)
};

// Weight rows of a matrix: K, or K / 2 packed rows in Q4.
template <bool Q4>
__device__ __host__ __forceinline__ int mat_rows(const Mat& m) { return Q4 ? m.K / 2 : m.K; }

// The contraction row that packed row j's low (hi = 0) or high (hi = 1)
// nibble holds; in q8 row j itself.
template <bool Q4>
__device__ __forceinline__ int src_row(const Mat& m, int j, int hi) {
  if constexpr (!Q4) return j;
  const int blk = j / m.half;
  return blk * 2 * m.half + (j - blk * m.half) + hi * m.half;
}

struct QmvArgs {
  Mat m[kMaxMats];
  int nmat, B, O, epi;
  float* out;                   // [B, O]
  const float* row_add;         // EPI_STORE: [B] or null
  const float* col_add;         // EPI_STORE: [O] or null
  const float* aa_in;           // EPI_WKV: state slices [B, O]
  const float* bb_in;
  const float* pp_in;
  float* aa_out;
  float* bb_out;
  float* pp_out;
  const float* decay;           // EPI_WKV: [O]
  const float* bonus;
  const float* next_offset;     // [O] or null: offset vector of the matrix that reads `out`
  float* next_off;              // [gridDim.x, B]: per-tile sum_c out[b, c] * next_offset[c]
  float* partial;               // [S, nmat, B, O] when gridDim.y > 1
  int* counters;                // [gridDim.x], zero between launches
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// N sums over the block (up to 1024 threads, a multiple of 32) at once, each
// in a fixed order; every thread gets the results. scratch holds N * 33 floats.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_sum(v[j]);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < N; ++j) scratch[j * 32 + wid] = v[j];
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float t = lane < (int)(blockDim.x >> 5) ? scratch[j * 32 + lane] : 0.f;
      t = warp_sum(t);
      if (lane == 0) scratch[N * 32 + j] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = scratch[N * 32 + j];
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// 16 int8 -> 16 float, exactly: (x ^ 0x80) is x + 128 as an unsigned byte;
// placed in the low mantissa byte of 2^23 it reads as 2^23 + x + 128.
__device__ __forceinline__ void widen16(const int4& v, float (&f)[16]) {
  const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z, (unsigned)v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned u = w[q] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[q * 4 + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - 8388736.f;
  }
}

// 16 nibble-packed bytes -> 16 + 16 floats, exactly: lo = (p & 0xF) - 8, and
// hi = p >> 4 (arithmetic), the high nibble's signed value. The unsigned high
// nibble u is that value's two's complement, so (u ^ 8) - 8 gives it back;
// both then widen as in widen16 with 2^23 + 8 subtracted.
__device__ __forceinline__ void widen16_q4(const int4& v, float (&lo)[16], float (&hi)[16]) {
  const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z, (unsigned)v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned l = w[q] & 0x0F0F0F0Fu;
    const unsigned h = ((w[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[q * 4 + j] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540u + j)) - 8388616.f;
      hi[q * 4 + j] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540u + j)) - 8388616.f;
    }
  }
}

// Staged activations a thread block holds: kMaxMats matrices of one 128-row
// group (twice that in Q4: each packed row stages two rows), or one chunk.
template <int BT, bool Q4>
constexpr int xs_floats() {
  constexpr int group = kMaxMats * (Q4 ? 2 : 1) * kGroupRows;
  return BT * (group > kChunkK ? group : kChunkK);
}

template <int BT, bool Q4>
struct QmvSmem {
  float xs[xs_floats<BT, Q4>()];       // staged, scaled activations
  float red[kWarps][BT][kTileO];       // per-warp partial sums
  float res[kMaxMats][BT][kTileO];     // the tile's sums, before the epilogue
  float offs[kMaxMats][BT];
  float contrib[BT][kTileO];           // out * next_offset, per column
  int last;
};

// acc[bi][j] += xs[bi * bstride] * W[row, col + j]; in Q4 also
// + xs[bi * bstride + hoff] * (the high nibbles' row)
template <int BT, bool Q4>
__device__ __forceinline__ void accumulate(float (&acc)[BT][kColsPerThread], const int4& wv,
                                           const float* xs, int bstride, int hoff) {
  if constexpr (Q4) {
    float lo[kColsPerThread], hi[kColsPerThread];
    widen16_q4(wv, lo, hi);
#pragma unroll
    for (int bi = 0; bi < BT; ++bi) {
      const float xl = xs[bi * bstride], xh = xs[bi * bstride + hoff];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        acc[bi][j] = fmaf(xh, hi[j], fmaf(xl, lo[j], acc[bi][j]));
    }
  } else {
    float wf[kColsPerThread];
    widen16(wv, wf);
#pragma unroll
    for (int bi = 0; bi < BT; ++bi) {
      const float xv = xs[bi * bstride];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[bi][j] = fmaf(xv, wf[j], acc[bi][j]);
    }
  }
}

// Sum acc over the block's 32 row slices: the 4 slices of a warp by shuffles
// (lane = slice * 8 + column thread), then the 8 warps through shared
// memory. Writes dst[bi * stride + c] for the tile's columns c < O - col0.
template <int BT, bool Q4>
__device__ void reduce_tile(float (&acc)[BT][kColsPerThread], int nb, int O, int col0,
                            QmvSmem<BT, Q4>& sm, float* dst, int stride) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, ct = tid % kColThreads;
#pragma unroll
  for (int bi = 0; bi < BT; ++bi)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      float v = acc[bi][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[bi][j] = v;
    }
  if (lane < kColThreads)
#pragma unroll
    for (int bi = 0; bi < BT; ++bi)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) sm.red[wid][bi][ct * kColsPerThread + j] = acc[bi][j];
  __syncthreads();
  for (int i = tid; i < nb * kTileO; i += kThreads) {
    const int bi = i / kTileO, c = i - bi * kTileO;
    if (col0 + c < O) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += sm.red[w][bi][c];
      dst[(size_t)bi * stride + c] = v;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void split_range(int K, int s, int S, int& k0, int& k1) {
  const int rows = (K + S - 1) / S;
  k0 = min(K, s * rows);
  k1 = min(K, k0 + rows);
}

// Rows [b0, b0 + nb) of every matrix over this block's share of the
// contraction, where that share is at most kGroupRows weight rows: all
// weight loads first, then the activations, one barrier, the FMAs. Matrix
// m's sums go to dst[m * mstride + bi * stride + c].
template <int BT, bool Q4>
__device__ void partial_short(const QmvArgs& a, int col0, int b0, int nb, int s, int S,
                              QmvSmem<BT, Q4>& sm, float* dst, size_t mstride, int stride) {
  constexpr int R = Q4 ? 2 : 1;           // staged rows per weight row
  constexpr int G = R * kGroupRows;       // staged floats per matrix and batch row
  const int tid = threadIdx.x, ct = tid % kColThreads, ks = tid / kColThreads;
  const int col = col0 + ct * kColsPerThread;
  const bool col_ok = col < a.O;  // O % 16 == 0: a column group is all in or all out
  int4 wv[kMaxMats][kUnroll];
#pragma unroll
  for (int m = 0; m < kMaxMats; ++m) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) wv[m][u] = make_int4(0, 0, 0, 0);
    if (m < a.nmat && col_ok) {
      int k0, k1;
      split_range(mat_rows<Q4>(a.m[m]), s, S, k0, k1);
      const int8_t* wb = a.m[m].w + (size_t)k0 * a.O + col;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = ks + u * kKSlices;
        if (k0 + r < k1) wv[m][u] = __ldcs(reinterpret_cast<const int4*>(wb + (size_t)r * a.O));
      }
    }
  }
  for (int m = 0; m < a.nmat; ++m) {
    const Mat& mt = a.m[m];
    int k0, k1;
    split_range(mat_rows<Q4>(mt), s, S, k0, k1);
    const int rows = k1 - k0;
    for (int i = tid; i < BT * G; i += kThreads) {
      const int bi = i / G, rr = i - bi * G;
      const int hi = rr / kGroupRows, r = rr - hi * kGroupRows;
      float v = 0.f;
      if (bi < nb && r < rows) {
        const int k = src_row<Q4>(mt, k0 + r, hi);
        v = mt.x[(size_t)(b0 + bi) * mt.K + k];
        if (mt.scale) v *= mt.scale[k];
      }
      sm.xs[(m * BT + bi) * G + rr] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMaxMats; ++m) {
    if (m >= a.nmat) break;
    float acc[BT][kColsPerThread];
#pragma unroll
    for (int bi = 0; bi < BT; ++bi)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[bi][j] = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      accumulate<BT, Q4>(acc, wv[m][u], &sm.xs[m * BT * G + ks + u * kKSlices], G, kGroupRows);
    reduce_tile<BT, Q4>(acc, nb, a.O, col0, sm, dst + m * mstride, stride);
  }
}

// One matrix over weight rows [k0, k1) of any length: activations staged in
// chunks of kChunkK floats per batch row (CR weight rows), and the loads of
// the next 128-row group issued before the FMAs of the current one.
template <int BT, bool Q4>
__device__ void partial_long(const Mat& mt, int O, int col0, int b0, int nb, int k0, int k1,
                             QmvSmem<BT, Q4>& sm, float* dst, int stride) {
  constexpr int R = Q4 ? 2 : 1;
  constexpr int CR = kChunkK / R;
  const int tid = threadIdx.x, ct = tid % kColThreads, ks = tid / kColThreads;
  const int col = col0 + ct * kColsPerThread;
  const bool col_ok = col < O;
  float acc[BT][kColsPerThread];
#pragma unroll
  for (int bi = 0; bi < BT; ++bi)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[bi][j] = 0.f;

  for (int kc = k0; kc < k1; kc += CR) {
    const int kn = min(CR, k1 - kc);
    const int8_t* wb = mt.w + (size_t)kc * O + col;
    int4 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = ks + u * kKSlices;
      wv[u] = col_ok && r < kn ? __ldcs(reinterpret_cast<const int4*>(wb + (size_t)r * O))
                               : make_int4(0, 0, 0, 0);
    }
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < BT * R * kn; i += kThreads) {
      const int bi = i / (R * kn), rr = i - bi * R * kn;
      const int hi = rr / kn, k = rr - hi * kn;
      float v = 0.f;
      if (bi < nb) {
        const int row = src_row<Q4>(mt, kc + k, hi);
        v = mt.x[(size_t)(b0 + bi) * mt.K + row];
        if (mt.scale) v *= mt.scale[row];
      }
      sm.xs[bi * kChunkK + hi * CR + k] = v;
    }
    __syncthreads();
    for (int g = 0; g < kn; g += kGroupRows) {
      int4 nx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = g + kGroupRows + ks + u * kKSlices;
        nx[u] = col_ok && r < kn ? __ldcs(reinterpret_cast<const int4*>(wb + (size_t)r * O))
                                 : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = g + ks + u * kKSlices;
        if (r < kn) accumulate<BT, Q4>(acc, wv[u], &sm.xs[r], kChunkK, CR);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wv[u] = nx[u];
    }
  }
  reduce_tile<BT, Q4>(acc, nb, O, col0, sm, dst, stride);
}

template <int BT, bool Q4>
__global__ void __launch_bounds__(kThreads) qmv_kernel(const QmvArgs a) {
  __shared__ QmvSmem<BT, Q4> sm;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, col0 = tile * kTileO;
  const int S = gridDim.y, s = blockIdx.y;
  const int nbg = (a.B + BT - 1) / BT;
  int kmax = 0;
  for (int m = 0; m < a.nmat; ++m) kmax = max(kmax, mat_rows<Q4>(a.m[m]));
  const bool short_path = (kmax + S - 1) / S <= kGroupRows;
  const size_t sstride = (size_t)a.nmat * a.B * a.O;  // one split's partials

  // This block's partial sums for batch rows [b0, b0 + nb) into dst.
  auto partials = [&](int b0, int nb, float* dst, size_t mstride, int stride) {
    if (short_path) {
      partial_short<BT, Q4>(a, col0, b0, nb, s, S, sm, dst, mstride, stride);
    } else {
      for (int m = 0; m < a.nmat; ++m) {
        int k0, k1;
        split_range(mat_rows<Q4>(a.m[m]), s, S, k0, k1);
        partial_long<BT, Q4>(a.m[m], a.O, col0, b0, nb, k0, k1, sm, dst + m * mstride, stride);
      }
    }
  };

  if (S > 1) {
    for (int g = 0; g < nbg; ++g) {
      const int b0 = g * BT, nb = min(BT, a.B - b0);
      partials(b0, nb, a.partial + s * sstride + (size_t)b0 * a.O + col0, (size_t)a.B * a.O,
               a.O);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(&a.counters[tile], 1) == S - 1;
    __syncthreads();
    if (!sm.last) return;
    if (tid == 0) a.counters[tile] = 0;  // ready for the next launch
    __threadfence();
  }

  for (int g = 0; g < nbg; ++g) {
    const int b0 = g * BT, nb = min(BT, a.B - b0);
    if (S == 1) {
      partials(b0, nb, &sm.res[0][0][0], (size_t)BT * kTileO, kTileO);
    } else {
      for (int i = tid; i < a.nmat * nb * kTileO; i += kThreads) {
        const int m = i / (nb * kTileO), rem = i - m * nb * kTileO;
        const int bi = rem / kTileO, c = rem - bi * kTileO;
        if (col0 + c >= a.O) continue;
        const float* p = a.partial + ((size_t)m * a.B + b0 + bi) * a.O + col0 + c;
        float v[kMaxSplit];
#pragma unroll
        for (int ss = 0; ss < kMaxSplit; ++ss) v[ss] = ss < S ? __ldcg(p + ss * sstride) : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int ss = 0; ss < kMaxSplit; ++ss) sum += v[ss];
        sm.res[m][bi][c] = sum;
      }
    }
    if (tid < a.nmat * BT) {
      const int m = tid / BT, bi = tid - m * BT;
      const Mat& mt = a.m[m];
      float v = 0.f;
      if (bi < nb && mt.off) {
#pragma unroll 8
        for (int p = 0; p < mt.n_off; ++p) v += __ldcg(mt.off + (size_t)p * a.B + b0 + bi);
      }
      sm.offs[m][bi] = v;
    }
    __syncthreads();

    for (int i = tid; i < nb * kTileO; i += kThreads) {
      const int bi = i / kTileO, c = i - bi * kTileO, gc = col0 + c;
      sm.contrib[bi][c] = 0.f;
      if (gc >= a.O) continue;
      const size_t idx = (size_t)(b0 + bi) * a.O + gc;
      const float v0 = sm.res[0][bi][c] + sm.offs[0][bi];
      float o = 0.f;
      switch (a.epi) {
        case EPI_STORE:
          o = v0;
          if (a.row_add) o += a.row_add[b0 + bi];
          if (a.col_add) o += a.col_add[gc];
          break;
        case EPI_ADD:
          o = a.out[idx] + v0;
          break;
        case EPI_RELU2: {
          const float r = fmaxf(v0, 0.f);
          o = r * r;
          break;
        }
        case EPI_GATED_ADD:
          o = a.out[idx] + sigmoidf_(sm.res[1][bi][c] + sm.offs[1][bi]) * v0;
          break;
        case EPI_WKV: {
          const float k = v0;
          const float v = sm.res[1][bi][c] + sm.offs[1][bi];
          const float r = sm.res[2][bi][c] + sm.offs[2][bi];
          const float aa = a.aa_in[idx], bb = a.bb_in[idx], pp = a.pp_in[idx];
          const float ww = a.bonus[gc] + k;
          const float q = fmaxf(pp, ww);
          const float e1 = expf(pp - q), e2 = expf(ww - q);
          const float y = (e1 * aa + e2 * v) / (e1 * bb + e2);
          const float ww2 = pp + a.decay[gc];
          const float p2 = fmaxf(ww2, k);
          const float f1 = expf(ww2 - p2), f2 = expf(k - p2);
          a.aa_out[idx] = f1 * aa + f2 * v;
          a.bb_out[idx] = f1 * bb + f2;
          a.pp_out[idx] = p2;
          o = sigmoidf_(r) * y;
          break;
        }
      }
      a.out[idx] = o;
      if (a.next_offset) sm.contrib[bi][c] = o * a.next_offset[gc];
    }
    if (a.next_offset) {
      __syncthreads();
      const int lane = tid & 31, wid = tid >> 5;
      if (wid < nb) {  // one warp per batch row, a fixed order
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kTileO / 32; ++j) v += sm.contrib[wid][lane + 32 * j];
        v = warp_sum(v);
        if (lane == 0) a.next_off[(size_t)tile * a.B + b0 + wid] = v;
      }
    }
    __syncthreads();  // res/offs/contrib are rewritten by the next batch group
  }
}

// Split of the contraction dim: enough blocks to fill the card, and at least
// enough splits that a block's share is one 128-row group (the short path),
// within kMaxSplit and the partial scratch.
inline int qmv_split(int tiles, int kmax, int nmat, int B, int O, long long partial_cap,
                     int counter_cap, int target_blocks) {
  if (tiles > counter_cap) return 1;
  int S = (target_blocks + tiles - 1) / tiles;
  if (S <= 1) return 1;
  const int for_short = (kmax + kGroupRows - 1) / kGroupRows;
  S = S > for_short ? S : for_short;
  S = S < kMaxSplit ? S : kMaxSplit;
  const int by_rows = kmax / kKSlices;
  S = S < by_rows ? S : by_rows;
  while (S > 1 && (long long)S * nmat * B * O > partial_cap) --S;
  return S < 1 ? 1 : S;
}

// Q4: every matrix of `a` is nibble-packed (Mat::w [K / 2, O], Mat::half set).
template <bool Q4>
inline cudaError_t launch_qmv(const QmvArgs& a, long long partial_cap, int counter_cap,
                              int target_blocks, cudaStream_t st) {
  const int tiles = (a.O + kTileO - 1) / kTileO;
  int kmax = 0;
  for (int m = 0; m < a.nmat; ++m) kmax = mat_rows<Q4>(a.m[m]) > kmax ? mat_rows<Q4>(a.m[m]) : kmax;
  const int S = qmv_split(tiles, kmax, a.nmat, a.B, a.O, partial_cap, counter_cap, target_blocks);
  const dim3 grid(tiles, S);
  if (a.B <= 1)
    qmv_kernel<1, Q4><<<grid, kThreads, 0, st>>>(a);
  else if (a.B <= 2)
    qmv_kernel<2, Q4><<<grid, kThreads, 0, st>>>(a);
  else
    qmv_kernel<4, Q4><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace rwkv
