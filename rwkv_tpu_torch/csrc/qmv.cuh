// Quantized-weight matvec tile shared by the decode_stack, tp_halves and
// decode_stack_tp kernels.
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
// gated residual, sigmoid, or the WKV recurrence). off_m[b] is the rank-1 offset term
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
// W8A8 (FMT kA8, kernel K5): W is int8 as in q8, and the activations are
// quantized to int8 while they are staged: code = clip(rint(v / s), -127, 127)
// with v = x * scale and s = max|v| / 127 (floored at 1e-30) over a block of
// qblock input channels of the batch row (the whole row, or a block of a
// row-tiled family). The producer of x leaves max|v| as partial maxima over
// equal column ranges (Mat::amax: one per row from the row kernels, one per
// 128-column tile from the epilogues), so the consumer takes the max of a
// block's parts: a max is exact in any order. Each thread's 4 weight rows of
// a group (rows ks + 32u) are transposed by byte-permutes into 16 words of 4
// rows each, one per column, and __dp4a multiplies them by the 4 packed codes
// of those rows into int32 sums: exact. With blocks smaller than K, a split of
// the contraction covers a power of two of rows up to 128, or a multiple of
// 128 (mat_split), so every 128-row group lies inside one block.
//
// On the short path (a split of at most 128 rows) a split's sum stays an
// exact integer (at most 128 * 127^2, exact in float through the block's
// reduction); the reduction adds the integers of each block's splits, then
// takes sum_j float(int_j) * s_j over the blocks in order, each product and
// sum rounded once: the plain version's arithmetic (ops/cuda/mm8.py's
// mm8_a8_plain), so the decode stack's matvecs give its bits. On the long
// path (the head: one split of all K rows) each 4-row integer sum is scaled
// into a float accumulator, within f32 rounding of the plain version.
//
// Layout of a block (256 threads): 8 column threads x 16 columns = a tile of
// 128 output columns; 32 row slices walk the contraction dim, each thread
// keeping partial sums for up to 4 batch rows in registers. More rows loop:
// the block's weights are read again for each group of 4 rows (from shared
// memory on the short path, from device memory or L2 on the long one), and
// every product is an f32 FMA on the CUDA cores. So this tile serves the
// steps where a read per group costs little: K1 below B* rows (the q8 stack
// from B* to 16 rows runs stack_tc.cuh's tensor-core phases, which read each
// weight byte once for all rows), K4, K5's stack, K6 and K7.
//
// A tile of 128 columns leaves too few blocks for the card when O is E (8
// tiles at E = 1024), so the contraction is also split across S
// blocks, at most 128 rows each where that fits: then every thread issues
// all of its weight loads, for every matrix, before it stages the
// activations, so one memory round trip covers the whole block. Each block
// writes its partial to global scratch; the last block of a column tile to
// arrive (an atomic counter, used only to elect it) sums the S partials, all
// loads in flight, in the fixed order s = 0..S-1, so the result does not
// depend on which block finished first.
//
// qmv_run is a device function: the caller gives it the tile, the split, S
// and the shared memory, and may load the block's weights ahead of the call
// (qmv_load_async): the persistent decode stacks (stack.cuh) run it once
// per phase, inlined whole, with the weights of the
// next phase copied to shared memory while it waits at the grid barrier
// that separates them. A source policy (GlobalSrc here) says where the
// activations come from: the persistent stack computes the token-shift mixes
// of the matvec inputs while staging them (decode_stack.cu's FoldSrc). Data
// another block wrote earlier in the same launch is read with __ldcg (L2,
// never a stale L1 line).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rwkv {

// Memory-order primitives at gpu scope: the split-K election below and the
// grid barrier (grid.cuh).
__device__ __forceinline__ unsigned atom_add_acq_rel_gpu(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_gpu(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void red_release_gpu(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Memory-order primitives at system scope: kernel K7's flags between cards
// (decode_stack_tp.cu), written by a peer over NVLink.
__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

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
// Model shards of one tensor-parallel data row (kernel K7, decode_stack_tp.cu).
constexpr int kMaxShards = 8;

// Weight formats: int8 rows (q8), nibble-packed rows (q4), int8 rows times
// int8 activation codes (a8).
enum Fmt : int { kQ8 = 0, kQ4 = 1, kA8 = 2 };

enum Epilogue : int {
  EPI_STORE = 0,      // out = acc0 (+ row_add[b]) (+ col_add[c])
  EPI_WKV = 1,        // mats k, v, r: WKV step on aa/bb/pp, out = sigmoid(r) * y
  EPI_ADD = 2,        // out += acc0 (residual)
  EPI_RELU2 = 3,      // out = relu(acc0)^2
  EPI_GATED_ADD = 4,  // mats value, gate: out += sigmoid(acc1) * acc0
  EPI_SIGMOID = 5,    // out = sigmoid(acc0) (the tensor-parallel ffn gate)
};

struct Mat {
  const float* x;        // [B, K] activations
  const float* scale;    // [K], or null: x is already scaled
  const double* off;     // [n_off, B] partials of the rank-1 term (double), or null
  int n_off;
  const int8_t* w;       // [K, O] int8 row-major; Q4: [K / 2, O] packed
  int K;
  int half;              // Q4: half the pairing block, in rows (K / 2: global)
  const float* amax;     // A8: [n_amax, B] partial max|x * scale| over equal column ranges
  int n_amax;
  int qblock;            // A8: input channels per activation scale (K, or a multiple of 128)
  int8_t* codes;         // A8, or null: [B, K] the codes, written by column tile 0
};

// Weight rows of a matrix: K, or K / 2 packed rows in Q4.
template <int FMT>
__device__ __host__ __forceinline__ int mat_rows(const Mat& m) {
  return FMT == kQ4 ? m.K / 2 : m.K;
}

// The contraction row that packed row j's low (hi = 0) or high (hi = 1)
// nibble holds; in q8 and a8 row j itself.
template <int FMT>
__device__ __forceinline__ int src_row(const Mat& m, int j, int hi) {
  if constexpr (FMT != kQ4) return j;
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
  double* next_off;             // [tiles, B]: per-tile sum_c out[b, c] * next_offset[c]
  const float* next_scale;      // [O] or null: scale vector of the a8 matrix that reads `out`
  float* next_amax;             // [tiles, B]: per-tile max_c |out[b, c] * next_scale[c]|
  float* partial;               // [S, nmat, B, O] when S > 1
  int* counters;                // [tiles], zero between launches (and phases)
  // K7 across cards: the same [B, O] output on n_peer other cards (peer
  // stores over NVLink), each thread's stores then fenced at system scope
  float* peer[kMaxShards - 1];
  int n_peer;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// N sums over the block (up to 1024 threads, a multiple of 32) at once, each
// in a fixed order; every thread gets the results. scratch holds N * 33 values.
template <int N, typename T>
__device__ __forceinline__ void block_sums(T (&v)[N], T* scratch) {
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
      T t = lane < (int)(blockDim.x >> 5) ? scratch[j * 32 + lane] : T(0);
      t = warp_sum(t);
      if (lane == 0) scratch[N * 32 + j] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = scratch[N * 32 + j];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// As block_sums, for maxima.
template <int N>
__device__ __forceinline__ void block_maxes(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_max(v[j]);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < N; ++j) scratch[j * 32 + wid] = v[j];
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float t = lane < (int)(blockDim.x >> 5) ? scratch[j * 32 + lane] : 0.f;
      t = warp_max(t);
      if (lane == 0) scratch[N * 32 + j] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = scratch[N * 32 + j];
}

// torch.sigmoid's float arithmetic
__device__ __forceinline__ float sigmoidf_(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

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

// Where a matvec's inputs come from: device memory, written by an earlier
// launch or phase (read through L2). prologue(b0, nb) runs before the rows
// [b0, b0 + nb) are staged; local(m): matrix m's rank-1 term and a8 maxima
// are in shared memory.
struct GlobalSrc {
  __device__ __forceinline__ void prologue(int, int) const {}
  __device__ __forceinline__ bool local(int) const { return false; }
  __device__ __forceinline__ float x(const Mat& mt, int, int b, int, int k) const {
    return __ldcg(mt.x + (size_t)b * mt.K + k);
  }
};

// Staged activations a thread block holds: kMaxMats matrices of one 128-row
// group (twice that in Q4: each packed row stages two rows), or one chunk.
// (A8 stages one byte per row in the same space.)
template <int BT, int FMT>
constexpr int xs_floats() {
  constexpr int group = kMaxMats * (FMT == kQ4 ? 2 : 1) * kGroupRows;
  return BT * (group > kChunkK ? group : kChunkK);
}

template <int BT, int FMT>
struct QmvSmem {
  float xs[xs_floats<BT, FMT>()];      // staged, scaled activations (A8: int8 codes)
  float red[kWarps][BT][kTileO];       // per-warp partial sums
  float res[kMaxMats][BT][kTileO];     // the tile's sums, before the epilogue
  float offs[kMaxMats][BT];
  double contrib[BT][kTileO];          // out * next_offset, per column
  float amaxc[BT][kTileO];             // |out * next_scale|, per column
  float qs[kChunkK / kGroupRows * BT]; // A8: activation scales of the staged groups
  // A8, short path: the scale of each split's block, per matrix and batch row,
  // and each split's block (-1: an empty split)
  float bscale[FMT == kA8 ? kMaxMats * BT * kMaxSplit : 1];
  int sblock[FMT == kA8 ? kMaxMats * kMaxSplit : 1];
  int last;
};

// A8: the activation scale of the block holding input row k of batch row b
// (local: the maxima are in shared memory).
__device__ __forceinline__ float a8_scale(const Mat& m, int B, int b, int k, bool local) {
  const int parts = m.n_amax * m.qblock / m.K;  // partial maxima per block
  const float* p = m.amax + (size_t)(k / m.qblock) * parts * B + b;
  float mx = 0.f;
  for (int i = 0; i < parts; ++i) mx = fmaxf(mx, local ? p[(size_t)i * B] : __ldcg(p + (size_t)i * B));
  return fmaxf(mx / 127.f, 1e-30f);
}

// A8: round half to even, as the JAX package's jnp.round; a true division.
__device__ __forceinline__ int a8_code(float v, float s) {
  return min(127, max(-127, __float2int_rn(v / s)));
}

// A8: where the code of row r of a 128-row group goes in its 128 staged
// bytes: word r % 32 holds rows r % 32 + 32u in byte u, the 4 rows whose
// weights one thread holds.
__device__ __forceinline__ int a8_slot(int r) { return (r & 31) * 4 + ((r >> 5) & 3); }

// A8: the 4 weight rows of wv (rows ks + 32u of a group) as 16 words of 4
// rows each, one per column: a 4x4 byte transpose per 4 columns.
__device__ __forceinline__ void a8_transpose(const int4 (&wv)[kUnroll],
                                             int (&t)[kColsPerThread]) {
  const int a[4] = {wv[0].x, wv[0].y, wv[0].z, wv[0].w};
  const int b[4] = {wv[1].x, wv[1].y, wv[1].z, wv[1].w};
  const int c[4] = {wv[2].x, wv[2].y, wv[2].z, wv[2].w};
  const int d[4] = {wv[3].x, wv[3].y, wv[3].z, wv[3].w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // columns 4q..4q+3
    const unsigned ab_lo = __byte_perm(a[q], b[q], 0x5140), ab_hi = __byte_perm(a[q], b[q], 0x7362);
    const unsigned cd_lo = __byte_perm(c[q], d[q], 0x5140), cd_hi = __byte_perm(c[q], d[q], 0x7362);
    t[q * 4 + 0] = (int)__byte_perm(ab_lo, cd_lo, 0x5410);
    t[q * 4 + 1] = (int)__byte_perm(ab_lo, cd_lo, 0x7632);
    t[q * 4 + 2] = (int)__byte_perm(ab_hi, cd_hi, 0x5410);
    t[q * 4 + 3] = (int)__byte_perm(ab_hi, cd_hi, 0x7632);
  }
}

// A8, short path: iacc[bi][j] += sum_u code(row u, bi) * W[row u, col + j],
// exactly, for the 4 rows of wv; xw[bi * bstride] packs their 4 codes.
template <int BT>
__device__ __forceinline__ void accumulate_a8(int (&iacc)[BT][kColsPerThread],
                                              const int4 (&wv)[kUnroll], const int* xw,
                                              int bstride) {
  int t[kColsPerThread];
  a8_transpose(wv, t);
#pragma unroll
  for (int bi = 0; bi < BT; ++bi) {
    const int x = xw[bi * bstride];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) iacc[bi][j] = __dp4a(t[j], x, iacc[bi][j]);
  }
}

// A8, long path: acc[bi][j] += s[bi * sstride] * (the same 4-row sum), the
// group's exact integer (at most 4 * 127^2) scaled into a float accumulator:
// one accumulator a column, as in q8, not two.
template <int BT>
__device__ __forceinline__ void accumulate_a8_scaled(float (&acc)[BT][kColsPerThread],
                                                     const int4 (&wv)[kUnroll], const int* xw,
                                                     int bstride, const float* s, int sstride) {
  int t[kColsPerThread];
  a8_transpose(wv, t);
#pragma unroll
  for (int bi = 0; bi < BT; ++bi) {
    const int x = xw[bi * bstride];
    const float sc = s[bi * sstride];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      acc[bi][j] = fmaf(__int2float_rn(__dp4a(t[j], x, 0)), sc, acc[bi][j]);
  }
}

// acc[bi][j] += xs[bi * bstride] * W[row, col + j]; in Q4 also
// + xs[bi * bstride + hoff] * (the high nibbles' row)
template <int BT, int FMT>
__device__ __forceinline__ void accumulate(float (&acc)[BT][kColsPerThread], const int4& wv,
                                           const float* xs, int bstride, int hoff) {
  if constexpr (FMT == kQ4) {
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
template <int BT, int FMT>
__device__ __forceinline__ void reduce_tile(float (&acc)[BT][kColsPerThread], int nb, int O,
                                                 int col0, QmvSmem<BT, FMT>& sm, float* dst,
                                                 int stride) {
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

// Weight rows [k0, k1) of split s of S. In A8 with blocks smaller than K,
// every 128-row group of a split lies inside one activation block.
template <int FMT>
__device__ __forceinline__ void mat_split(const Mat& m, int s, int S, int& k0, int& k1) {
  const int K = mat_rows<FMT>(m);
  int rows = (K + S - 1) / S;
  if (FMT == kA8 && m.qblock < m.K) {
    if (rows <= kGroupRows) {
      int p = 1;
      while (p < rows) p <<= 1;
      rows = p;  // divides kGroupRows, which divides the block
    } else {
      rows = (rows + kGroupRows - 1) / kGroupRows * kGroupRows;
    }
  }
  k0 = min(K, s * rows);
  k1 = min(K, k0 + rows);
}

// The block's weights on the short path (a share of at most kGroupRows
// weight rows of every matrix): every load issued at once, 16 bytes a
// thread and row. Weights are read-only, so a caller may issue them before
// the barrier that makes the activations ready.
template <int FMT>
__device__ __forceinline__ void qmv_load(const QmvArgs& a, int tile, int s, int S,
                                         int4 (&wv)[kMaxMats][kUnroll]) {
  const int tid = threadIdx.x, ct = tid % kColThreads, ks = tid / kColThreads;
  const int col = tile * kTileO + ct * kColsPerThread;
  const bool col_ok = col < a.O;  // O % 16 == 0: a column group is all in or all out
#pragma unroll
  for (int m = 0; m < kMaxMats; ++m) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) wv[m][u] = make_int4(0, 0, 0, 0);
    if (m < a.nmat && col_ok) {
      int k0, k1;
      mat_split<FMT>(a.m[m], s, S, k0, k1);
      const int8_t* wb = a.m[m].w + (size_t)k0 * a.O + col;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = ks + u * kKSlices;
        if (k0 + r < k1) wv[m][u] = __ldcs(reinterpret_cast<const int4*>(wb + (size_t)r * a.O));
      }
    }
  }
}

// As qmv_load, into shared memory with cp.async (no registers held): wsm
// holds kMaxMats * kUnroll * kThreads 16-byte slots, each thread's its own.
// A row outside the split, or a column outside O, is zero-filled. On the
// long path this is the first 128-row group of each matrix's split.
template <int FMT>
__device__ __forceinline__ void qmv_load_async(const QmvArgs& a, int tile, int s, int S,
                                               int4* wsm) {
  const int tid = threadIdx.x, ct = tid % kColThreads, ks = tid / kColThreads;
  const int col = tile * kTileO + ct * kColsPerThread;
  const bool col_ok = col < a.O;
  for (int m = 0; m < a.nmat; ++m) {
    int k0, k1;
    mat_split<FMT>(a.m[m], s, S, k0, k1);
    const int8_t* wb = a.m[m].w + (size_t)k0 * a.O + (col_ok ? col : 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = ks + u * kKSlices;
      const bool ok = col_ok && k0 + r < k1;
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(wsm + (m * kUnroll + u) * kThreads + tid));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                   "l"(ok ? wb + (size_t)r * a.O : a.m[m].w), "r"(ok ? 16 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Rows [b0, b0 + nb) of every matrix over this block's share of the
// contraction, where that share is at most kGroupRows weight rows: all
// weight loads first (qmv_load), or, with wsm, the weights already copied to
// this thread's slots of wsm (qmv_load_async); then the activations, one
// barrier, the FMAs. Matrix m's sums go to dst[m * mstride + bi * stride + c].
template <int BT, int FMT, class Src>
__device__ __forceinline__ void partial_short_body(const QmvArgs& a, const int4* wsm, int tile,
                                                   int b0, int nb, int s, int S,
                                                   QmvSmem<BT, FMT>& sm, float* dst,
                                                   size_t mstride, int stride, const Src& src) {
  constexpr int R = FMT == kQ4 ? 2 : 1;   // staged rows per weight row
  constexpr int G = R * kGroupRows;       // staged values per matrix and batch row
  const int tid = threadIdx.x, ks = tid / kColThreads;
  const int col0 = tile * kTileO;
  int4 wv[kMaxMats][kUnroll];
  if (!wsm) qmv_load<FMT>(a, tile, s, S, wv);
  if constexpr (FMT == kA8) {
    // the split lies inside one activation block: one scale per (m, bi)
    if (tid < a.nmat * BT) {
      const int m = tid / BT, bi = tid - m * BT;
      int k0, k1;
      mat_split<FMT>(a.m[m], s, S, k0, k1);
      sm.qs[tid] = bi < nb && k0 < k1 ? a8_scale(a.m[m], a.B, b0 + bi, k0, src.local(m)) : 1.f;
    }
    __syncthreads();
  }
  // Every matrix's activations: all loads first, into registers, then the
  // stores to shared memory, so the loads share one memory round trip.
  constexpr int kIt = (BT * G + kThreads - 1) / kThreads;
  float v[kMaxMats][kIt];
  int kk[kMaxMats][kIt];
#pragma unroll
  for (int m = 0; m < kMaxMats; ++m) {
    int k0 = 0, k1 = 0;
    if (m < a.nmat) mat_split<FMT>(a.m[m], s, S, k0, k1);
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kThreads;
      const int bi = i / G, rr = i - bi * G;
      const int hi = rr / kGroupRows, r = rr - hi * kGroupRows;
      v[m][it] = 0.f;
      kk[m][it] = -1;
      if (m < a.nmat && i < BT * G && bi < nb && r < k1 - k0) {
        const Mat& mt = a.m[m];
        const int k = src_row<FMT>(mt, k0 + r, hi);
        float x = src.x(mt, m, b0 + bi, bi, k);
        if (mt.scale) x *= mt.scale[k];
        v[m][it] = x;
        kk[m][it] = k;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxMats; ++m) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kThreads;
      if (m >= a.nmat || i >= BT * G) continue;
      const int bi = i / G, rr = i - bi * G, r = rr % kGroupRows;
      if constexpr (FMT == kA8) {
        int q = 0;
        if (kk[m][it] >= 0) {
          q = a8_code(v[m][it], sm.qs[m * BT + bi]);
          const Mat& mt = a.m[m];
          if (mt.codes && tile == 0) mt.codes[(size_t)(b0 + bi) * mt.K + kk[m][it]] = (int8_t)q;
        }
        reinterpret_cast<int8_t*>(sm.xs)[(m * BT + bi) * G + a8_slot(r)] = (int8_t)q;
      } else {
        sm.xs[(m * BT + bi) * G + rr] = v[m][it];
      }
    }
  }
  // wsm: this thread's own slots, so the wait needs no barrier of its own
  if (wsm) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMaxMats; ++m) {
    if (m >= a.nmat) break;
    if (wsm) {  // one matrix's weights in registers at a time
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wv[m][u] = wsm[(m * kUnroll + u) * kThreads + tid];
    }
    float acc[BT][kColsPerThread];
#pragma unroll
    for (int bi = 0; bi < BT; ++bi)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[bi][j] = 0.f;
    if constexpr (FMT == kA8) {
      // the split's exact integer sum, unscaled (see the A8 note above)
      int iacc[BT][kColsPerThread];
#pragma unroll
      for (int bi = 0; bi < BT; ++bi)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) iacc[bi][j] = 0;
      accumulate_a8<BT>(iacc, wv[m], reinterpret_cast<const int*>(sm.xs) + m * BT * (G / 4) + ks,
                        G / 4);
#pragma unroll
      for (int bi = 0; bi < BT; ++bi)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[bi][j] = __int2float_rn(iacc[bi][j]);
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        accumulate<BT, FMT>(acc, wv[m][u], &sm.xs[m * BT * G + ks + u * kKSlices], G, kGroupRows);
    }
    reduce_tile<BT, FMT>(acc, nb, a.O, col0, sm, dst + m * mstride, stride);
  }
}

// One matrix over weight rows [k0, k1) of any length: activations staged in
// chunks of kChunkK floats per batch row (CR weight rows), and the loads of
// the next 128-row group issued before the FMAs of the current one.
template <int BT, int FMT, class Src>
__device__ __forceinline__ void partial_long_body(const Mat& mt, int m, int B, int O, int tile,
                                                  int b0, int nb, int k0, int k1,
                                                  QmvSmem<BT, FMT>& sm, float* dst, int stride,
                                                  const Src& src, const int4* wsm, bool raw) {
  constexpr int R = FMT == kQ4 ? 2 : 1;
  constexpr int CR = kChunkK / R;
  constexpr int NG = kChunkK / kGroupRows;  // A8: groups per chunk
  const int tid = threadIdx.x, ct = tid % kColThreads, ks = tid / kColThreads;
  const int col0 = tile * kTileO, col = col0 + ct * kColsPerThread;
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
    if (wsm && kc == k0) {  // the first group, copied ahead (qmv_load_async)
      asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wv[u] = wsm[(m * kUnroll + u) * kThreads + tid];
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = ks + u * kKSlices;
        wv[u] = col_ok && r < kn ? __ldcs(reinterpret_cast<const int4*>(wb + (size_t)r * O))
                                 : make_int4(0, 0, 0, 0);
      }
    }
    __syncthreads();  // the previous chunk's readers are done
    if constexpr (FMT == kA8) {
      // each 128-row group lies inside one activation block
      if (tid < BT * NG) {
        const int bi = tid / NG, g = tid - bi * NG;
        sm.qs[tid] = bi < nb && g * kGroupRows < kn
                         ? a8_scale(mt, B, b0 + bi, kc + g * kGroupRows, src.local(m)) : 1.f;
      }
      __syncthreads();
      for (int i = tid; i < BT * kn; i += kThreads) {
        const int bi = i / kn, k = i - bi * kn;
        int q = 0;
        if (bi < nb) {
          float v = src.x(mt, m, b0 + bi, bi, kc + k);
          if (mt.scale) v *= mt.scale[kc + k];
          q = a8_code(v, sm.qs[bi * NG + k / kGroupRows]);
          if (mt.codes && tile == 0) mt.codes[(size_t)(b0 + bi) * mt.K + kc + k] = (int8_t)q;
        }
        reinterpret_cast<int8_t*>(sm.xs)[bi * kChunkK + (k & ~(kGroupRows - 1)) + a8_slot(k)] =
            (int8_t)q;
      }
    } else {
      for (int i = tid; i < BT * R * kn; i += kThreads) {
        const int bi = i / (R * kn), rr = i - bi * R * kn;
        const int hi = rr / kn, k = rr - hi * kn;
        float v = 0.f;
        if (bi < nb) {
          const int row = src_row<FMT>(mt, kc + k, hi);
          v = src.x(mt, m, b0 + bi, bi, row);
          if (mt.scale) v *= mt.scale[row];
        }
        sm.xs[bi * kChunkK + hi * CR + k] = v;
      }
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
      if constexpr (FMT == kA8) {
        // rows past kn have zero weights, whatever codes their bytes hold;
        // raw: the exact integer sums, each 4-row sum times 1 (a8_exact_long)
        const float one = 1.f;
        accumulate_a8_scaled<BT>(acc, wv, reinterpret_cast<const int*>(sm.xs) + (g >> 2) + ks,
                                 kChunkK / 4, raw ? &one : &sm.qs[g / kGroupRows], raw ? 0 : NG);
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = g + ks + u * kKSlices;
          if (r < kn) accumulate<BT, FMT>(acc, wv[u], &sm.xs[r], kChunkK, CR);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wv[u] = nx[u];
    }
  }
  reduce_tile<BT, FMT>(acc, nb, O, col0, sm, dst, stride);
}

// A8, short path: r = sum_j float(int_j) * s_j over the blocks in order, the
// plain version's rounding (no contraction).
__device__ __forceinline__ void a8_block_term(float& r, bool& first, int isum, float s) {
  const float t = __fmul_rn(__int2float_rn(isum), s);
  r = first ? t : __fadd_rn(r, t);
  first = false;
}

// Whether a's splits of S take the short path (at most kGroupRows weight
// rows of every matrix a block: its weights fit in registers, qmv_load).
template <int FMT>
__device__ __host__ __forceinline__ bool qmv_short(const QmvArgs& a, int S) {
  int kmax = 0;
  for (int m = 0; m < a.nmat; ++m) kmax = mat_rows<FMT>(a.m[m]) > kmax ? mat_rows<FMT>(a.m[m]) : kmax;
  return (kmax + S - 1) / S <= kGroupRows;
}

// A8, long path: whether every split of every matrix lies inside one
// activation block and its integer sum (at most rows * 127^2) is exact in
// float, so a split's partial can be its exact integer sum, scaled per block
// in order by the reduction, as on the short path: the plain version's bits.
template <int FMT>
__device__ __forceinline__ bool a8_exact_long(const QmvArgs& a, int S) {
  for (int m = 0; m < a.nmat; ++m) {
    int k0, k1;
    mat_split<FMT>(a.m[m], 0, S, k0, k1);  // the first split is the longest
    const int rows = k1 - k0;
    if (rows * 127 * 127 > (1 << 24) || (a.m[m].qblock < a.m[m].K && a.m[m].qblock % rows))
      return false;
  }
  return true;
}

// One block of a matvec: column tile `tile`, split s of S, shared memory sm.
// On the short path the block's weights go to registers for each batch
// group, or with wsm to shared memory by cp.async once, where `loaded` says
// they already are (qmv_load_async before the call). The body of each
// matvec phase of the persistent decode stacks, everything inlined (a
// call's register saves would go to local memory, each reload a cache round
// trip on a chain of latencies).
template <int BT, int FMT, class Src = GlobalSrc>
__device__ __forceinline__ void qmv_run(const QmvArgs& a, int tile, int s, int S,
                                        QmvSmem<BT, FMT>& sm, int4* wsm = nullptr,
                                        bool loaded = false, const Src& src = Src()) {
  const int tid = threadIdx.x;
  const int col0 = tile * kTileO;
  const int nbg = (a.B + BT - 1) / BT;
  const bool short_path = qmv_short<FMT>(a, S);
  // A8: the partials are unscaled integers, on the short path, and inlined
  // (the persistent stack) on a long one that a8_exact_long allows
  const bool a8_raw = FMT == kA8 && (short_path || a8_exact_long<FMT>(a, S));
  const size_t sstride = (size_t)a.nmat * a.B * a.O;  // one split's partials
  if (wsm && !loaded) qmv_load_async<FMT>(a, tile, s, S, wsm);

  // This block's partial sums for batch rows [b0, b0 + nb) into dst.
  auto partials = [&](int b0, int nb, float* dst, size_t mstride, int stride) {
    src.prologue(b0, nb);
    if (short_path) {
      partial_short_body<BT, FMT>(a, wsm, tile, b0, nb, s, S, sm, dst, mstride, stride, src);
    } else {
      for (int m = 0; m < a.nmat; ++m) {
        int k0, k1;
        mat_split<FMT>(a.m[m], s, S, k0, k1);
        partial_long_body<BT, FMT>(a.m[m], m, a.B, a.O, tile, b0, nb, k0, k1, sm,
                                   dst + m * mstride, stride, src, wsm, a8_raw);
      }
    }
  };

  if (S > 1) {
    for (int g = 0; g < nbg; ++g) {
      const int b0 = g * BT, nb = min(BT, a.B - b0);
      partials(b0, nb, a.partial + s * sstride + (size_t)b0 * a.O + col0, (size_t)a.B * a.O,
               a.O);
    }
    // The block's partials were ordered before the barrier; thread 0's
    // acq_rel add releases them with its arrival, and acquires every earlier
    // block's for the last one (no fence in every thread).
    __syncthreads();
    if (tid == 0)
      sm.last = atom_add_acq_rel_gpu(reinterpret_cast<unsigned*>(&a.counters[tile]), 1u) ==
                (unsigned)(S - 1);
    __syncthreads();
    if (!sm.last) return;
    if (tid == 0) a.counters[tile] = 0;  // ready for the next launch or phase
  }

  constexpr bool kA8Fmt = FMT == kA8;
  // The epilogue's inputs other than the sums (the residual x, the WKV
  // state), loaded first, so their memory round trip overlaps the sums'.
  constexpr int kEp = (BT * kTileO + kThreads - 1) / kThreads;  // columns a thread
  const bool wkv = a.epi == EPI_WKV, resid = a.epi == EPI_ADD || a.epi == EPI_GATED_ADD;
  for (int g = 0; g < nbg; ++g) {
    const int b0 = g * BT, nb = min(BT, a.B - b0);
    float e_x[kEp], e_aa[kEp], e_bb[kEp], e_pp[kEp];
#pragma unroll
    for (int it = 0; it < kEp; ++it) {
      const int i = tid + it * kThreads, bi = i / kTileO, gc = col0 + i - bi * kTileO;
      const bool ok = i < nb * kTileO && gc < a.O;
      const size_t idx = (size_t)(b0 + bi) * a.O + gc;
      e_x[it] = ok && resid ? __ldcg(a.out + idx) : 0.f;
      e_aa[it] = ok && wkv ? a.aa_in[idx] : 0.f;
      e_bb[it] = ok && wkv ? a.bb_in[idx] : 0.f;
      e_pp[it] = ok && wkv ? a.pp_in[idx] : 0.f;
    }
    if (S == 1) partials(b0, nb, &sm.res[0][0][0], (size_t)BT * kTileO, kTileO);
    if constexpr (kA8Fmt) {
      if (a8_raw) {  // after the prologue, which may write the maxima
        for (int i = tid; i < a.nmat * BT * S; i += kThreads) {
          const int m = i / (BT * S), rem = i - m * BT * S, bi = rem / S, ss = rem - bi * S;
          int k0, k1;
          mat_split<FMT>(a.m[m], ss, S, k0, k1);
          const bool live = k0 < k1;
          sm.bscale[(m * BT + bi) * kMaxSplit + ss] =
              live && bi < nb ? a8_scale(a.m[m], a.B, b0 + bi, k0, src.local(m)) : 0.f;
          if (bi == 0) sm.sblock[m * kMaxSplit + ss] = live ? k0 / a.m[m].qblock : -1;
        }
        __syncthreads();
      }
    }
    if (S == 1) {
      if constexpr (kA8Fmt) {
        if (a8_raw) {
          for (int i = tid; i < a.nmat * nb * kTileO; i += kThreads) {
            const int m = i / (nb * kTileO), rem = i - m * nb * kTileO;
            const int bi = rem / kTileO, c = rem - bi * kTileO;
            sm.res[m][bi][c] = __fmul_rn(sm.res[m][bi][c], sm.bscale[(m * BT + bi) * kMaxSplit]);
          }
        }
      }
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
        bool summed = false;
        if constexpr (kA8Fmt) {
          if (a8_raw) {
            // the integers of each block's splits, then the blocks in order
            bool first = true;
            int isum = 0, cur = -1;
            float sc = 0.f;
#pragma unroll
            for (int ss = 0; ss < kMaxSplit; ++ss) {
              const int blk = ss < S ? sm.sblock[m * kMaxSplit + ss] : -1;
              if (blk < 0) continue;
              if (blk != cur) {
                if (cur >= 0) a8_block_term(sum, first, isum, sc);
                cur = blk;
                isum = 0;
                sc = sm.bscale[(m * BT + bi) * kMaxSplit + ss];
              }
              isum += __float2int_rn(v[ss]);
            }
            if (cur >= 0) a8_block_term(sum, first, isum, sc);
            summed = true;
          }
        }
        if (!summed) {
#pragma unroll
          for (int ss = 0; ss < kMaxSplit; ++ss) sum += v[ss];
        }
        sm.res[m][bi][c] = sum;
      }
    }
    if (tid < a.nmat * BT) {
      const int m = tid / BT, bi = tid - m * BT;
      const Mat& mt = a.m[m];
      double v = 0.0;
      if (bi < nb && mt.off) {
        const bool local = src.local(m);
#pragma unroll 8
        for (int p = 0; p < mt.n_off; ++p) {
          const double* o = mt.off + (size_t)p * a.B + b0 + bi;
          v += local ? *o : __ldcg(o);
        }
      }
      sm.offs[m][bi] = (float)v;  // the rank-1 term summed in double, rounded once
    }
    __syncthreads();

#pragma unroll
    for (int it = 0; it < kEp; ++it) {
      const int i = tid + it * kThreads;
      if (i >= nb * kTileO) continue;
      const int bi = i / kTileO, c = i - bi * kTileO, gc = col0 + c;
      sm.contrib[bi][c] = 0.0;
      sm.amaxc[bi][c] = 0.f;
      if (gc >= a.O) continue;
      const size_t idx = (size_t)(b0 + bi) * a.O + gc;
      // each operation rounded on its own, in the plain version's order
      const float v0 = __fadd_rn(sm.res[0][bi][c], sm.offs[0][bi]);
      float o = 0.f;
      switch (a.epi) {
        case EPI_STORE:
          o = v0;
          if (a.row_add) o = __fadd_rn(o, a.row_add[b0 + bi]);
          if (a.col_add) o = __fadd_rn(o, a.col_add[gc]);
          break;
        case EPI_ADD:
          o = __fadd_rn(e_x[it], v0);
          break;
        case EPI_RELU2: {
          const float r = fmaxf(v0, 0.f);
          o = __fmul_rn(r, r);
          break;
        }
        case EPI_SIGMOID:
          o = sigmoidf_(v0);
          break;
        case EPI_GATED_ADD:
          o = __fadd_rn(e_x[it],
                        __fmul_rn(sigmoidf_(__fadd_rn(sm.res[1][bi][c], sm.offs[1][bi])), v0));
          break;
        case EPI_WKV: {
          // ops/wkv.py::wkv_step, operation for operation
          const float k = v0;
          const float v = __fadd_rn(sm.res[1][bi][c], sm.offs[1][bi]);
          const float r = __fadd_rn(sm.res[2][bi][c], sm.offs[2][bi]);
          const float aa = e_aa[it], bb = e_bb[it], pp = e_pp[it];
          const float ww = __fadd_rn(a.bonus[gc], k);
          const float q = fmaxf(pp, ww);
          const float e1 = expf(__fsub_rn(pp, q)), e2 = expf(__fsub_rn(ww, q));
          const float y = __fdiv_rn(__fadd_rn(__fmul_rn(e1, aa), __fmul_rn(e2, v)),
                                    __fadd_rn(__fmul_rn(e1, bb), e2));
          const float ww2 = __fadd_rn(pp, a.decay[gc]);
          const float p2 = fmaxf(ww2, k);
          const float f1 = expf(__fsub_rn(ww2, p2)), f2 = expf(__fsub_rn(k, p2));
          a.aa_out[idx] = __fadd_rn(__fmul_rn(f1, aa), __fmul_rn(f2, v));
          a.bb_out[idx] = __fadd_rn(__fmul_rn(f1, bb), f2);
          a.pp_out[idx] = p2;
          o = __fmul_rn(sigmoidf_(r), y);
          break;
        }
      }
      a.out[idx] = o;
      for (int p = 0; p < a.n_peer; ++p) a.peer[p][idx] = o;
      if (a.next_offset) sm.contrib[bi][c] = (double)o * (double)a.next_offset[gc];  // exact
      if (a.next_amax) sm.amaxc[bi][c] = fabsf(o * a.next_scale[gc]);
    }
    if (a.next_offset || a.next_amax) {
      __syncthreads();
      const int lane = tid & 31, wid = tid >> 5;
      if (wid < nb) {  // one warp per batch row, a fixed order
        double v = 0.0;
        float mx = 0.f;
#pragma unroll
        for (int j = 0; j < kTileO / 32; ++j) {
          v += sm.contrib[wid][lane + 32 * j];
          mx = fmaxf(mx, sm.amaxc[wid][lane + 32 * j]);
        }
        v = warp_sum(v);
        mx = warp_max(mx);
        if (lane == 0 && a.next_offset) a.next_off[(size_t)tile * a.B + b0 + wid] = v;
        if (lane == 0 && a.next_amax) a.next_amax[(size_t)tile * a.B + b0 + wid] = mx;
      }
    }
    __syncthreads();  // res/offs/contrib are rewritten by the next batch group
  }
  // the peer stores complete before the caller's barrier arrival releases them
  if (a.n_peer) __threadfence_system();
}

}  // namespace rwkv
