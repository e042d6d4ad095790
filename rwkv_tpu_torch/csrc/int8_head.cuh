// The int8-weight heads on the tensor cores, one kernel for two formats:
// kernel K2 (mm8.cu: f32 activations) and K5's head (mm8_a8.cu: int8 codes),
//
//     out[b, c] = sum_k x[b, k] * W[k, c] (+ row_add[b]) (+ col_add[c]),
//
// W [K, O] int8 row-major. K3's design (mm4.cu) carried over to whole bytes:
//
// * The weight stream. A persistent grid, one block a SM, walks slabs of
//   128 * MT columns (MT TMA boxes of 64 weight rows x 128 columns, the
//   128-byte swizzle). One thread of a producer warpgroup keeps a ring of
//   104 KB of stages in flight with mbarriers; the 8 warps of two consumer
//   warpgroups each own one 16-column chunk of every box, load a stage's 64
//   rows of it with two ldmatrix.x4.trans a box, and release the stage.
//   setmaxnreg gives the consumers 232 registers a thread.
// * The product, out^T[c, n] = sum_k W[k, c] * X[k, n], on wgmma: M the
//   output columns (64 a warpgroup), N the batch, A the weights from
//   registers, B the activations from shared memory. ldmatrix.trans gives a
//   thread the bytes of rows (2t, 2t + 1) and columns (2g, 2g + 1) of an 8 x
//   16 block; columns 2g and 2g + 1 are the A fragment's rows g and g + 8.
//   - f32 activations (K2): m64nNk16, bf16 in, f32 accumulate. A byte
//     widens to an exact bf16 integer: xored with 0x80 and byte-permuted
//     into the mantissa of 2^23, an f32 subtract of 2^23 + 128 leaves w,
//     whose high half is its bf16 (a byte has one bit more than bf16
//     stores, so K3's one-fma widening does not carry over). The k order of
//     a k16 step is the rows' own. Each activation is three bf16 pieces, hi
//     = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x;
//     three columns of N (n = 3b + piece, N = 3B rounded up to 8); every
//     product is exact, the f32 accumulation the only rounding, and the
//     epilogue adds a row's three columns in a fixed order.
//   - int8 codes (K5's head): m64nNk32, s8 x s8 -> s32, N = B rounded up
//     to 8. wgmma takes no transposed 8-bit operand, so A comes from
//     registers: one byte permute of two ldmatrix words gives 4 k of one
//     column, the k order of a k32 step rows (2t, 2t + 1, 2t + 8, 2t + 9)
//     of each half. Each block quantizes the codes while it stages them
//     (code = clip(rint(x / s), -127, 127), s = max|row| / 127 floored at
//     1e-30), from the row maxima of the caller or its own. The integer
//     sum is exact; the epilogue rounds it to f32, times s, + row_add, +
//     col_add, each rounded once: mm8_a8_plain's bits.
// * The batch. Up to 16 rows ride in one pass: every weight byte is read
//   from device memory once. More rows take more passes of the slab. When
//   the staged activations of all K do not fit in their 96 KB, a slab walks
//   the contraction in chunks that do, restaged between chunks, the sums
//   kept in registers.
// * No split of the contraction across blocks, no scratch in device memory,
//   no atomics: each output is summed in one order, so two calls give the
//   same bits.
#pragma once

#include <type_traits>

#include "tma_wgmma.cuh"

namespace rwkv {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup (one thread works)
// Registers a thread, after setmaxnreg moves them from the producer to the
// consumers: 2 x 128 x 232 + 128 x 40 <= 65536.
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kRows = 64;                  // weight rows a stage
constexpr int kBoxCols = 128;              // columns a box: the 128-byte swizzle span
constexpr int kBoxBytes = kRows * kBoxCols;
constexpr int kRingBytes = 104 * 1024;
constexpr int kStagedBytes = 96 * 1024;    // the activations' operand
constexpr int kMaxRows = 16;               // batch rows a pass
constexpr int kRed = 16 + kConsumerWarps * 16;  // floats: a pass's row scales + the max reduction

__host__ __device__ constexpr int ring_stages(int MT) { return kRingBytes / (MT * kBoxBytes); }
// Batch rows a pass with NT n-tiles of 8: one column a row for codes, three
// for bf16 pieces.
template <bool A8>
__host__ __device__ constexpr int pass_rows(int NT) {
  return (A8 ? 8 * NT : 8 * NT / 3) < kMaxRows ? (A8 ? 8 * NT : 8 * NT / 3) : kMaxRows;
}
// Bytes of the activations' operand a weight row.
template <bool A8>
__host__ __device__ constexpr int staged_row_bytes(int NT) {
  return A8 ? 8 * NT : 16 * NT;
}

struct HeadArgs {
  const float* xs;
  const float* row_add;  // [B] or null
  const float* col_add;  // [O] or null
  const float* amax;     // codes: [B] row maxima from the caller, or null
  float* amax_out;       // codes: [B] the row maxima block 0 found, or null
  int8_t* codes;         // codes: [B, K] the codes block 0 staged, or null
  float* out;
  int B, K, O;
  int slabs;       // ceil(O / (128 * MT))
  int chunk_rows;  // weight rows of one staging of the activations, a multiple of kRows
};

// The consumer warps' named barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-30f);
}
__device__ __forceinline__ int quant(float v, float s) {
  return min(127, max(-127, __float2int_rn(__fdiv_rn(v, s))));
}

// K2's operand: the bf16 pieces of batch rows b0.. and weight rows
// [r0, r0 + pc), n = 3b + piece, the k order the rows' own: the word of rows
// (2p, 2p + 1) of the chunk is step p / 8's k half (p / 4) % 2, its word p %
// 4. A row past K, and a column past the pass's rows, is zero. A thread takes
// every 256th row pair and issues the loads of all its pairs' batch rows
// before it splits any, one round trip; with `signal` it then lets the
// producer start the weight stream, so the loads do not queue behind it.
template <int NT>
__device__ void stage_pieces(uint32_t* pieces, const HeadArgs& a, int b0, int r0, int pc,
                             bool signal) {
  constexpr int N = 8 * NT;
  constexpr int slots = (N + 2) / 3;
  constexpr int iters = (kStagedBytes / (32 * NT) + kConsumers - 1) / kConsumers;
  const int nrows = min(pass_rows<false>(NT), a.B - b0);
  float x[iters][slots][2];
#pragma unroll
  for (int it = 0; it < iters; ++it) {
    const int p = threadIdx.x + it * kConsumers, k = r0 + 2 * p;
    const bool in0 = 2 * p < pc && k < a.K, in1 = 2 * p < pc && k + 1 < a.K;
    const float* x0 = a.xs + (size_t)b0 * a.K + (in0 ? k : 0);
#pragma unroll
    for (int b = 0; b < slots; ++b) {
      x[it][b][0] = in0 && b < nrows ? __ldg(x0 + (size_t)b * a.K) : 0.f;
      x[it][b][1] = in1 && b < nrows ? __ldg(x0 + (size_t)b * a.K + 1) : 0.f;
    }
  }
  if (signal) asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers + 32) : "memory");
#pragma unroll
  for (int it = 0; it < iters; ++it) {
    const int p = threadIdx.x + it * kConsumers;
    if (2 * p >= pc) break;
    uint32_t* dst = pieces + (p >> 3) * NT * 64 + ((p >> 2) & 1) * 32 + (p & 3);
#pragma unroll
    for (int b = 0; b < slots; ++b) {
      const uint32_t hi = bf16x2(x[it][b][0], x[it][b][1]);
      const float e0 = x[it][b][0] - bf16_lo(hi), e1 = x[it][b][1] - bf16_hi(hi);
      const uint32_t mid = bf16x2(e0, e1);
      const uint32_t piece[3] = {hi, mid, bf16x2(e0 - bf16_lo(mid), e1 - bf16_hi(mid))};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int n = 3 * b + q;
        if (n < N) dst[(n >> 3) * 64 + (n & 7) * 4] = piece[q];
      }
    }
  }
}

// K5's scales: row b's s = max|row| / 127 (floored at 1e-30) into
// red[b], from the caller's maxima or this block's; block 0 writes the
// maxima it found to amax_out. Columns past the pass's rows get 1. A thread
// issues the loads of 4 of its columns of every row before it takes any max.
template <int NT>
__device__ void stage_scales(float* red, const HeadArgs& a, int b0) {
  constexpr int N = 8 * NT;
  const int nrows = min(N, a.B - b0);
  const int tid = threadIdx.x;
  if (a.amax) {
    if (tid < N) red[tid] = tid < nrows ? row_scale(__ldg(a.amax + b0 + tid)) : 1.f;
    return;
  }
  float m[N];
#pragma unroll
  for (int b = 0; b < N; ++b) m[b] = 0.f;
  for (int k0 = tid; k0 < a.K; k0 += 4 * kConsumers) {
    float v[4][N];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * kConsumers;
      const float* x0 = a.xs + (size_t)b0 * a.K + k;
#pragma unroll
      for (int b = 0; b < N; ++b)
        v[j][b] = b < nrows && k < a.K ? __ldg(x0 + (size_t)b * a.K) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < N; ++b) m[b] = fmaxf(m[b], fabsf(v[j][b]));
  }
  float* part = red + 16;
#pragma unroll
  for (int b = 0; b < N; ++b) {
    m[b] = warp_max(m[b]);
    if ((tid & 31) == 0) part[(tid >> 5) * 16 + b] = m[b];
  }
  consumers_sync();
  if (tid < N) {
    float v = part[tid];
#pragma unroll
    for (int w = 1; w < kConsumerWarps; ++w) v = fmaxf(v, part[w * 16 + tid]);
    red[tid] = tid < nrows ? row_scale(v) : 1.f;
    if (a.amax_out && blockIdx.x == 0 && tid < nrows) a.amax_out[b0 + tid] = v;
  }
}

// K5's operand: the codes of batch rows b0.. and weight rows [r0, r0 + pc),
// one byte a code. Word (u, n), u = 8q + 4h + t, holds k 16h + 4t .. + 3 of
// step q, rows 32q + 16h + (2t, 2t + 1, 2t + 8, 2t + 9) of the chunk: the
// k order of the A fragments. A row past K, and a column past the pass's
// rows, is zero. Block 0 also writes the codes to a.codes. With `signal`,
// once every consumer has issued its first loads, the producer may start
// the weight stream.
template <int NT>
__device__ void stage_codes(uint32_t* codes, const float* scale, const HeadArgs& a, int b0,
                            int r0, int pc, bool signal) {
  constexpr int N = 8 * NT;
  const int nrows = min(N, a.B - b0);
  int8_t* out = blockIdx.x == 0 ? a.codes : nullptr;
  const int quads = pc / 4, iters = (quads + kConsumers - 1) / kConsumers;
  for (int it = 0; it < iters; ++it) {
    const int u = threadIdx.x + it * kConsumers;
    const bool in = u < quads;
    const int q = u >> 3, h = (u >> 2) & 1, t = u & 3;
    const int k0 = r0 + 32 * q + 16 * h + 2 * t;
    const int ks[4] = {k0, k0 + 1, k0 + 8, k0 + 9};
    float x[N][4];
#pragma unroll
    for (int b = 0; b < N; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[b][i] = in && b < nrows && ks[i] < a.K ? __ldg(a.xs + (size_t)(b0 + b) * a.K + ks[i])
                                                 : 0.f;
    if (signal && it == 0) asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers + 32) : "memory");
    if (!in) continue;
    uint32_t* dst = codes + q * N * 8 + h * 32 + t;
#pragma unroll
    for (int b = 0; b < N; ++b) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = quant(x[b][i], scale[b]);
        word |= (uint32_t)(c & 0xFF) << (8 * i);
        if (out && b < nrows && ks[i] < a.K) out[(size_t)(b0 + b) * a.K + ks[i]] = (int8_t)c;
      }
      dst[(b >> 3) * 64 + (b & 7) * 4] = word;
    }
  }
}

template <bool A8, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_head_kernel(const __grid_constant__ CUtensorMap wmap, const HeadArgs a) {
  using Acc = typename std::conditional<A8, int, float>::type;
  constexpr int S = ring_stages(MT);
  constexpr int N = 8 * NT;
  constexpr int G = pass_rows<A8>(NT);
  constexpr int ES = N + 1;  // epilogue row stride, in words
  // The weight stream waits until the consumers have issued their loads of
  // xs: queued behind it they take longer (mm4.cu). K2 from 6 batch rows on,
  // K5 always (streaming first, its head given the row maxima took 2 us more
  // at one row on an H100 80GB HBM3).
  constexpr bool loads_first = A8 || NT >= 3;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // the swizzle's 1 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * MT * kBoxBytes);
  uint64_t* empty = full + S;
  float* scratch = reinterpret_cast<float*>(empty + S);
  float* red = scratch + kConsumerWarps * 16 * ES;  // codes: the pass's scales, the max reduction
  uint32_t* staged = reinterpret_cast<uint32_t*>(red + kRed);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == kConsumers)  // the producer: fetch the descriptor early
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int J = a.K;
  const int passes = (a.B + G - 1) / G;
  const int chunks = (J + a.chunk_rows - 1) / a.chunk_rows;

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps) {
      if (loads_first) asm volatile("bar.sync 2, %0;" ::"n"(kConsumers + 32) : "memory");
      if (lane == 0) {
        int stage = 0;
        unsigned phase = 0;
        for (int slab = blockIdx.x; slab < a.slabs; slab += gridDim.x)
          for (int pass = 0; pass < passes; ++pass)
            for (int c = 0; c < chunks; ++c) {
              const int r0 = c * a.chunk_rows, rows = min(a.chunk_rows, J - r0);
              for (int r = 0; r < rows; r += kRows) {
                mbar_wait(&empty[stage], phase ^ 1);
                const int col0 = slab * MT * kBoxCols;
                const int boxes = min(MT, (a.O - col0 + kBoxCols - 1) / kBoxCols);
                mbar_expect_tx(&full[stage], boxes * kBoxBytes);
                for (int m = 0; m < boxes; ++m)
                  tma_load(ring + (stage * MT + m) * kBoxBytes, &wmap, &full[stage],
                           col0 + m * kBoxCols, r0 + r);
                if (++stage == S) {
                  stage = 0;
                  phase ^= 1;
                }
              }
            }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    int stage = 0;
    unsigned phase = 0;
    int key = -1;     // pass * chunks + chunk of the operand in shared memory
    int scaled = -1;  // codes: the pass whose scales are in red
    float* sc = scratch + warp * 16 * ES;
    for (int slab = blockIdx.x; slab < a.slabs; slab += gridDim.x) {
      for (int pass = 0; pass < passes; ++pass) {
        Acc acc[MT][NT * 4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < NT * 4; ++i) acc[m][i] = 0;
        for (int c = 0; c < chunks; ++c) {
          const int r0 = c * a.chunk_rows, rows = min(a.chunk_rows, J - r0);
          if (pass * chunks + c != key) {
            if (key >= 0) consumers_sync();  // every warp is done with the old operand
            if constexpr (A8) {
              if (pass != scaled) {
                stage_scales<NT>(red, a, pass * G);
                consumers_sync();  // the scales before the codes
                scaled = pass;
              }
              stage_codes<NT>(staged, red, a, pass * G, r0, a.chunk_rows, loads_first && key < 0);
            } else {
              stage_pieces<NT>(staged, a, pass * G, r0, a.chunk_rows, loads_first && key < 0);
            }
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before wgmma reads it
            consumers_sync();
            key = pass * chunks + c;
          }
          const uint64_t desc0 = b_desc(staged);
          for (int r = 0; r < rows; r += kRows) {
            mbar_wait(&full[stage], phase);
            uint32_t w[MT][8];  // word 4i + j: rows 32i + 8j + (2t, 2t + 1), columns (2g, 2g + 1)
            const uint8_t* st = ring + stage * MT * kBoxBytes;
#pragma unroll
            for (int m = 0; m < MT; ++m)  // lane L: row 32i + L of the stage, chunk `warp`
#pragma unroll
              for (int i = 0; i < 2; ++i)
                ldmatrix_x4_trans(&w[m][4 * i], st + m * kBoxBytes + (32 * i + lane) * kBoxCols +
                                                    ((warp ^ (lane & 7)) << 4));
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[stage]);
            if (++stage == S) {
              stage = 0;
              phase ^= 1;
            }
            if constexpr (A8) {
#pragma unroll
              for (int s = 0; s < 2; ++s) {  // k32 steps: words 4s .. 4s + 3
                uint32_t A[MT][4];
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                  A[m][0] = __byte_perm(w[m][4 * s], w[m][4 * s + 1], 0x6420);
                  A[m][1] = __byte_perm(w[m][4 * s], w[m][4 * s + 1], 0x7531);
                  A[m][2] = __byte_perm(w[m][4 * s + 2], w[m][4 * s + 3], 0x6420);
                  A[m][3] = __byte_perm(w[m][4 * s + 2], w[m][4 * s + 3], 0x7531);
                }
                const int q = (r >> 5) + s;
                wgmma_fence();
#pragma unroll
                for (int m = 0; m < MT; ++m)
                  wgmma_s8<NT>(acc[m], A[m], desc0 + ((q * N * 32) >> 4));
                wgmma_commit();
                wgmma_wait<1>();  // the group before this one is done with its A registers
              }
            } else {
#pragma unroll
              for (int s = 0; s < 4; ++s) {  // k16 steps: words 2s, 2s + 1
                uint32_t A[MT][4];
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                  widen8(w[m][2 * s], A[m][0], A[m][1]);
                  widen8(w[m][2 * s + 1], A[m][2], A[m][3]);
                }
                const int q = (r >> 4) + s;
                wgmma_fence();
#pragma unroll
                for (int m = 0; m < MT; ++m)
                  wgmma_bf16<NT>(acc[m], A[m], desc0 + ((q * N * 32) >> 4));
                wgmma_commit();
                wgmma_wait<1>();
              }
            }
          }
          wgmma_wait<0>();  // the operand may be restaged, the sums read
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < NT * 4; ++i) fence_operand(acc[m][i]);
        }
        // Epilogue: accumulator rows g, g + 8 are the chunk's columns 2g, 2g + 1;
        // through this warp's scratch each warp store writes 16 consecutive
        // columns. K2 sums a row's three pieces in a fixed order; K5 rounds
        // its integer sum to f32 and scales it.
        const int b0 = pass * G;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int col0 = slab * MT * kBoxCols + m * kBoxCols + warp * 16;
          if (col0 >= a.O) continue;  // O is a multiple of 16: whole chunks
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float* s0 = sc + 2 * g * ES + 8 * n + 2 * t;
            if constexpr (A8) {
              s0[0] = __int_as_float(acc[m][4 * n]);
              s0[1] = __int_as_float(acc[m][4 * n + 1]);
              s0[ES] = __int_as_float(acc[m][4 * n + 2]);
              s0[ES + 1] = __int_as_float(acc[m][4 * n + 3]);
            } else {
              s0[0] = acc[m][4 * n];
              s0[1] = acc[m][4 * n + 1];
              s0[ES] = acc[m][4 * n + 2];
              s0[ES + 1] = acc[m][4 * n + 3];
            }
          }
          __syncwarp();
          for (int e = lane; e < 16 * G; e += 32) {
            const int cl = e & 15, b = e >> 4, row = b0 + b;
            if (row < a.B) {
              float v;
              if constexpr (A8) {
                v = __fmul_rn(__int2float_rn(__float_as_int(sc[cl * ES + b])), red[b]);
              } else {
                const float* s = sc + cl * ES + 3 * b;
                v = __fadd_rn(__fadd_rn(s[2], s[1]), s[0]);
              }
              if (a.row_add) v = __fadd_rn(v, __ldg(a.row_add + row));
              if (a.col_add) v = __fadd_rn(v, __ldg(a.col_add + col0 + cl));
              a.out[(size_t)row * a.O + col0 + cl] = v;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <bool A8, int MT, int NT>
size_t smem_bytes(int chunk_rows) {
  return 1024 + (size_t)ring_stages(MT) * (MT * kBoxBytes + 16) +
         (size_t)kConsumerWarps * 16 * (8 * NT + 1) * 4 + kRed * 4 +
         (size_t)chunk_rows * staged_row_bytes<A8>(NT);
}

template <bool A8, int MT, int NT>
cudaError_t launch(const CUtensorMap& map, const HeadArgs& a, int grid, cudaStream_t st) {
  const size_t smem = smem_bytes<A8, MT, NT>(a.chunk_rows);
  cudaError_t e = cudaFuncSetAttribute(int8_head_kernel<A8, MT, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused call: not left behind for the next launch's check
    return e;
  }
  int8_head_kernel<A8, MT, NT><<<grid, kThreads, smem, st>>>(map, a);
  return cudaGetLastError();
}

template <bool A8, int MT>
cudaError_t launch_nt(int NT, const CUtensorMap& map, const HeadArgs& a, int grid,
                      cudaStream_t st) {
  if constexpr (A8) {
    return NT == 1 ? launch<A8, MT, 1>(map, a, grid, st) : launch<A8, MT, 2>(map, a, grid, st);
  } else {
    switch (NT) {
      case 1: return launch<A8, MT, 1>(map, a, grid, st);
      case 2: return launch<A8, MT, 2>(map, a, grid, st);
      case 3: return launch<A8, MT, 3>(map, a, grid, st);
      case 4: return launch<A8, MT, 4>(map, a, grid, st);
      case 5: return launch<A8, MT, 5>(map, a, grid, st);
      default: return launch<A8, MT, 6>(map, a, grid, st);
    }
  }
}

// How a call is cut: MT boxes a slab (the fewest waves of slabs over the SMs
// times the slab's width, ties to the wider slab), NT n-tiles (16 rows a
// pass: one column a row for codes, three for pieces), the weight rows of
// one staging of the activations.
template <bool A8>
void plan(int B, int K, int O, int sms, int* mt, int* nt, int* slabs, int* chunk_rows) {
  int best = 0, best_cost = 0;
  for (int m = 4; m >= 1; --m) {
    const int s = (O + m * kBoxCols - 1) / (m * kBoxCols);
    const int cost = (s + sms - 1) / sms * m;
    if (best == 0 || cost < best_cost) {
      best = m;
      best_cost = cost;
    }
  }
  *mt = best;
  *slabs = (O + best * kBoxCols - 1) / (best * kBoxCols);
  const int rows = B < kMaxRows ? B : kMaxRows;
  *nt = A8 ? (rows + 7) / 8 : (3 * rows + 7) / 8;
  const int J = (K + kRows - 1) / kRows * kRows;
  const int fit = kStagedBytes / staged_row_bytes<A8>(*nt) / kRows * kRows;
  *chunk_rows = J < fit ? J : fit;
}

// Enqueues the head on `stream` for the weight w [K, O] int8; returns the
// launch's CUDA error (0 if none).
template <bool A8>
int run(HeadArgs a, const void* w, cudaStream_t st) {
  cudaError_t e;
  const int sms = sm_count(&e);
  if (!sms) return (int)e;
  EncodeTiled encode;
  if ((e = encode_fn(&encode)) != cudaSuccess) return (int)e;
  int MT, NT;
  plan<A8>(a.B, a.K, a.O, sms, &MT, &NT, &a.slabs, &a.chunk_rows);
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)a.O, (cuuint64_t)a.K};
  const cuuint64_t strides[1] = {(cuuint64_t)a.O};
  const cuuint32_t box[2] = {kBoxCols, kRows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int grid = a.slabs < sms ? a.slabs : sms;
  switch (MT) {
    case 1: return (int)launch_nt<A8, 1>(NT, map, a, grid, st);
    case 2: return (int)launch_nt<A8, 2>(NT, map, a, grid, st);
    case 3: return (int)launch_nt<A8, 3>(NT, map, a, grid, st);
    default: return (int)launch_nt<A8, 4>(NT, map, a, grid, st);
  }
}

}  // namespace rwkv
