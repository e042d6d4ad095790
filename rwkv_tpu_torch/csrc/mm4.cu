// 4-bit-weight head, xs [B, K] f32 x nibble-packed wp [K / 2, O] int8 ->
// [B, O] f32 (kernel K3), on the tensor cores.
//
// Replaces rwkv_tpu/ops/pallas/mm4.py:mm4 (_mm4_kernel_two_dot and
// _mm4_kernel), reached through qmatmul4_pallas(). The caller pre-scales xs
// by the per-row scale; the offset term x . offset arrives as row_add [B], and
// a per-column bias (the logit_bias of a padded vocab) as col_add [O], so the
// q4 decode head is one launch:
//
//     out[b, c] = sum_k xs[b, k] * unpack4(wp, 2h)[k, c] (+ row_add[b]) (+ col_add[c])
//
// where byte [j, c] of wp holds row lo(j) = (j / h) * 2h + j % h in its low
// nibble (unsigned, minus 8) and row lo(j) + h in its high nibble (two's
// complement), h half the pairing block.
//
// Bound on the card: the K * O / 2 packed bytes over device memory bandwidth
// (the 430M head, 1024 x 50688, is 26 MB: 7.7 us at 3.35 TB/s); the products
// on the tensor cores stay under it up to 16 batch rows. The design:
//
// * The weight stream. A persistent grid, one block a SM, walks slabs of
//   128 * MT columns (MT TMA boxes of 64 packed rows x 128 columns, the
//   128-byte swizzle). One thread of a producer warpgroup keeps a ring of
//   104 KB of stages in flight with mbarriers (full: the TMA's bytes
//   arrived; empty: every consumer warp has its words in registers); the 8
//   warps of two consumer warpgroups each own one 16-column chunk of every
//   box of the slab, load the stage's 8 k16 steps of it with two
//   ldmatrix.x4.trans a box, and release the stage. setmaxnreg gives the
//   consumers 232 registers a thread. A slab's epilogue overlaps the
//   producer's loads for the next one.
// * The product, out^T[c, n] = sum_k W[k, c] * P[k, n], on wgmma
//   m64nNk16 (bf16 in, f32 accumulate): M the output columns (64 a
//   warpgroup), N the batch, A from registers, B from shared memory. Each
//   warpgroup keeps two k16 steps of products in flight. ldmatrix.trans of
//   the packed rows gives a thread the bytes of rows (2t, 2t + 1) and
//   columns (2g, 2g + 1) of an 8 x 16 block, which are its A fragment's rows
//   g and g + 8; so the k order of one k16 step is (row 2t low nibble, row
//   2t high nibble, ..., row 2t + 1 low nibble at 2t + 8, ...) and the two
//   nibbles of a byte are neighbouring k's: one A register. A nibble widens
//   to a bf16 integer in -8..7, exactly: a byte-permute and a lop3 put it
//   into the mantissa of 128 (the high nibble xor 8), one bf16x2 fma takes
//   136 off both halves. (mma.sync m16n8k16 from the same registers, with B
//   fragments loaded from shared memory, measured 10-12% slower at B = 8
//   and 16 and no faster at B = 1 on an H100.)
// * f32 accuracy from bf16 operands. Each activation is split into three
//   bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
//   whose sum is x exactly; they are three columns of N (n = 3b + piece, N =
//   3B rounded up to 8), staged once in shared memory in the A operand's k
//   order. Every product of a piece and an integer weight is exact, so the
//   only rounding is the f32 accumulation; the epilogue adds a row's three
//   columns in a fixed order.
// * The batch. Up to 16 rows (N = 48) ride in one pass: every weight byte is
//   read from device memory once. More rows take more passes of the slab.
//   When the pieces of all K do not fit in their 96 KB (N * K * 2 bytes), a
//   slab walks the contraction in chunks that do, the pieces restaged
//   between chunks and the sums kept in registers.
// * No split of the contraction across blocks, no scratch in device memory,
//   no atomics: each output is summed in one order, so two calls give the
//   same bits.
// The mbarrier, TMA and wgmma wrappers are tma_wgmma.cuh's, shared with the
// int8 heads (int8_head.cuh), which carry this design over to whole bytes.
#include "tma_wgmma.cuh"

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup (one thread works)
// Registers a thread, after setmaxnreg moves them from the producer to the
// consumers: 2 x 128 x 232 + 128 x 40 <= 65536.
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kRows = 64;                  // packed rows a stage
constexpr int kSteps = kRows / 8;          // k16 steps a stage
constexpr int kBoxCols = 128;              // columns a box: the 128-byte swizzle span
constexpr int kBoxBytes = kRows * kBoxCols;
constexpr int kRingBytes = 104 * 1024;
constexpr int kPieceBytes = 96 * 1024;
constexpr int kMaxRows = 16;  // batch rows a pass

__host__ __device__ constexpr int ring_stages(int MT) { return kRingBytes / (MT * kBoxBytes); }
// Batch rows a pass with NT n-tiles of 8: three columns a row.
__host__ __device__ constexpr int pass_rows(int NT) {
  return 8 * NT / 3 < kMaxRows ? 8 * NT / 3 : kMaxRows;
}

struct Mm4Args {
  const float* xs;
  float* out;
  const float* row_add;  // [B] or null
  const float* col_add;  // [O] or null
  int B, K, O, half;
  int slabs;       // ceil(O / (128 * MT))
  int chunk_rows;  // packed rows of one staging of the pieces, a multiple of kRows
};

// The consumer warps' named barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The four bytes of an A word (ldmatrix.trans: rows 2t, 2t + 1 x columns
// 2g, 2g + 1) as the four A registers of m16n8k16, byte i -> register i: low
// half the low nibble minus 8, high half the signed high nibble, each a
// bf16 integer: bytes [R_i, -, (R >> 4)_i, -], masked to the two nibbles and
// xored into 0x4300 (128) with the high one's sign bit flipped, minus 136.
__device__ __forceinline__ void widen(uint32_t R, uint32_t (&A)[4]) {
  const uint32_t Rs = R >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = __byte_perm(R, Rs, (unsigned)(i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12)));
    asm("lop3.b32 %0, %0, %1, %2, 0x6A;" : "+r"(v) : "r"(0x000F000Fu), "r"(0x43084300u));
    asm("fma.rn.bf16x2 %0, %0, %1, %2;" : "+r"(v) : "r"(0x3F803F80u), "r"(0xC308C308u));
    A[i] = v;
  }
}

// The bf16 pieces of batch rows b0.. and packed rows [r0, r0 + pc) as wgmma's
// B operand, one k16 step after another (N * 32 bytes each): core matrix
// (n-tile, k half) at (2 * ntile + khalf) * 128 bytes, its row n % 8 at 16
// bytes, k % 8 at 2 bytes. The k order is the A registers': k = 2t, 2t + 1
// are packed row 8q + 2t's low and high nibble (one word), k = 2t + 8, 2t + 9
// packed row 8q + 2t + 1's. A packed row past K / 2, and a column past the
// pass's rows, is zero. A thread takes every 256th packed row and issues the
// loads of all its rows' batch rows before it splits any, one round trip;
// with `signal` it then lets the producer start the weight stream, so the
// loads do not queue behind it.
template <int NT>
__device__ void stage_pieces(uint32_t* pieces, const Mm4Args& a, int b0, int r0, int pc,
                             bool signal) {
  constexpr int N = 8 * NT;
  constexpr int slots = (N + 2) / 3;
  constexpr int iters = (kPieceBytes / (32 * NT) + kConsumers - 1) / kConsumers;
  const int J = a.K / 2, h = a.half;
  const int nrows = min(pass_rows(NT), a.B - b0);
  float x[iters][slots][2];
#pragma unroll
  for (int it = 0; it < iters; ++it) {
    const int jl = threadIdx.x + it * kConsumers, j = r0 + jl;
    const bool in = jl < pc && j < J;
    const float* x0 = a.xs + (size_t)b0 * a.K + (in ? (j / h) * 2 * h + j % h : 0);
#pragma unroll
    for (int b = 0; b < slots; ++b) {
      const bool ok = in && b < nrows;
      x[it][b][0] = ok ? __ldg(x0 + (size_t)b * a.K) : 0.f;
      x[it][b][1] = ok ? __ldg(x0 + (size_t)b * a.K + h) : 0.f;
    }
  }
  if (signal) asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers + 32) : "memory");
#pragma unroll
  for (int it = 0; it < iters; ++it) {
    const int jl = threadIdx.x + it * kConsumers;
    if (jl >= pc) break;
    const int q = jl >> 3, t = (jl & 7) >> 1, second = jl & 1;
    uint32_t* dst = pieces + q * NT * 64 + second * 32 + t;
#pragma unroll
    for (int b = 0; b < slots; ++b) {
      const uint32_t hi = bf16x2(x[it][b][0], x[it][b][1]);
      const float e0 = x[it][b][0] - bf16_lo(hi), e1 = x[it][b][1] - bf16_hi(hi);
      const uint32_t mid = bf16x2(e0, e1);
      const uint32_t piece[3] = {hi, mid, bf16x2(e0 - bf16_lo(mid), e1 - bf16_hi(mid))};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int n = 3 * b + p;
        if (n < N) dst[(n >> 3) * 64 + (n & 7) * 4] = piece[p];
      }
    }
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    mm4_kernel(const __grid_constant__ CUtensorMap wmap, const Mm4Args a) {
  constexpr int S = ring_stages(MT);
  constexpr int N = 8 * NT;
  constexpr int G = pass_rows(NT);
  constexpr int ES = N + 1;  // epilogue row stride, in floats
  // From 6 batch rows on, the weight stream waits until the consumers have
  // issued their loads of xs: queued behind it they took 3 us more at
  // B = 16, while at B = 1 holding it back costs 1 us (H100 80GB HBM3).
  constexpr bool loads_first = NT >= 3;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // the swizzle's 1 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * MT * kBoxBytes);
  uint64_t* empty = full + S;
  float* scratch = reinterpret_cast<float*>(empty + S);
  uint32_t* pieces = reinterpret_cast<uint32_t*>(scratch + kConsumerWarps * 16 * ES);

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

  const int J = a.K / 2;
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
    int staged = -1;  // pass * chunks + chunk of the pieces in shared memory
    float* sc = scratch + warp * 16 * ES;
    for (int slab = blockIdx.x; slab < a.slabs; slab += gridDim.x) {
      for (int pass = 0; pass < passes; ++pass) {
        float acc[MT][NT * 4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < NT * 4; ++i) acc[m][i] = 0.f;
        for (int c = 0; c < chunks; ++c) {
          const int r0 = c * a.chunk_rows, rows = min(a.chunk_rows, J - r0);
          if (pass * chunks + c != staged) {
            if (staged >= 0) consumers_sync();  // every warp is done with the old pieces
            stage_pieces<NT>(pieces, a, pass * G, r0, a.chunk_rows, loads_first && staged < 0);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before wgmma reads them
            consumers_sync();
            staged = pass * chunks + c;
          }
          const uint64_t desc0 = b_desc(pieces);
          for (int r = 0; r < rows; r += kRows) {
            mbar_wait(&full[stage], phase);
            uint32_t w[MT][kSteps];
            const uint8_t* st = ring + stage * MT * kBoxBytes;
#pragma unroll
            for (int m = 0; m < MT; ++m)  // lane L: row 32i + L of the stage, chunk `warp`, swizzled
#pragma unroll
              for (int i = 0; i < kSteps / 4; ++i)
                ldmatrix_x4_trans(&w[m][4 * i], st + m * kBoxBytes + (32 * i + lane) * kBoxCols +
                                                    ((warp ^ (lane & 7)) << 4));
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[stage]);
            if (++stage == S) {
              stage = 0;
              phase ^= 1;
            }
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) {
              const int q = (r >> 3) + ks;
              uint32_t A[MT][4];
#pragma unroll
              for (int m = 0; m < MT; ++m) widen(w[m][ks], A[m]);
              wgmma_fence();
#pragma unroll
              for (int m = 0; m < MT; ++m) wgmma_bf16<NT>(acc[m], A[m], desc0 + ((q * N * 32) >> 4));
              wgmma_commit();
              wgmma_wait<1>();  // the group before this one is done with its A registers
            }
          }
          wgmma_wait<0>();  // the pieces may be restaged, the sums read
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < NT * 4; ++i) fence_operand(acc[m][i]);
        }
        // Epilogue: accumulator rows g, g + 8 are the chunk's columns 2g, 2g + 1;
        // through this warp's scratch, a row's three pieces are summed in a
        // fixed order and each warp store writes 16 consecutive columns.
        const int b0 = pass * G;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int col0 = slab * MT * kBoxCols + m * kBoxCols + warp * 16;
          if (col0 >= a.O) continue;  // O is a multiple of 16: whole chunks
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float* s0 = sc + 2 * g * ES + 8 * n + 2 * t;
            s0[0] = acc[m][4 * n];
            s0[1] = acc[m][4 * n + 1];
            s0[ES] = acc[m][4 * n + 2];
            s0[ES + 1] = acc[m][4 * n + 3];
          }
          __syncwarp();
          for (int e = lane; e < 16 * G; e += 32) {
            const int cl = e & 15, b = e >> 4, row = b0 + b;
            if (row < a.B) {
              const float* s = sc + cl * ES + 3 * b;
              float v = (s[2] + s[1]) + s[0];
              if (a.row_add) v += __ldg(a.row_add + row);
              if (a.col_add) v += __ldg(a.col_add + col0 + cl);
              a.out[(size_t)row * a.O + col0 + cl] = v;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int MT, int NT>
size_t smem_bytes(int chunk_rows) {
  return 1024 + (size_t)ring_stages(MT) * (MT * kBoxBytes + 16) +
         (size_t)kConsumerWarps * 16 * (8 * NT + 1) * 4 + (size_t)chunk_rows * 32 * NT;
}

template <int MT, int NT>
cudaError_t launch(const CUtensorMap& map, const Mm4Args& a, int grid, cudaStream_t st) {
  const size_t smem = smem_bytes<MT, NT>(a.chunk_rows);
  cudaError_t e = cudaFuncSetAttribute(mm4_kernel<MT, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused call: not left behind for the next launch's check
    return e;
  }
  mm4_kernel<MT, NT><<<grid, kThreads, smem, st>>>(map, a);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_nt(int NT, const CUtensorMap& map, const Mm4Args& a, int grid,
                      cudaStream_t st) {
  switch (NT) {
    case 1: return launch<MT, 1>(map, a, grid, st);
    case 2: return launch<MT, 2>(map, a, grid, st);
    case 3: return launch<MT, 3>(map, a, grid, st);
    case 4: return launch<MT, 4>(map, a, grid, st);
    case 5: return launch<MT, 5>(map, a, grid, st);
    default: return launch<MT, 6>(map, a, grid, st);
  }
}

}  // namespace

// How a call is cut: MT boxes a slab (the fewest waves of slabs over the SMs
// times the slab's width, ties to the wider slab), NT n-tiles (three columns
// a batch row, 16 rows a pass), the packed rows of one staging of the pieces.
extern "C" void rwkv_mm4_plan(int B, int K, int O, int sms, int* mt, int* nt, int* slabs,
                              int* chunk_rows) {
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
  *nt = (3 * rows + 7) / 8;
  const int J = (K / 2 + kRows - 1) / kRows * kRows;
  const int fit = kPieceBytes / (32 * *nt) / kRows * kRows;
  *chunk_rows = J < fit ? J : fit;
}

// Enqueues out = xs @ unpack4(wp, 2 * half) (+ row_add[:, None]) (+ col_add)
// on `stream`; returns the launch's CUDA error (0 if none).
extern "C" int rwkv_mm4(const void* xs, const void* wp, void* out, const void* row_add,
                        const void* col_add, int B, int K, int O, int half, void* stream) {
  cudaError_t e;
  const int sms = sm_count(&e);
  if (!sms) return (int)e;
  EncodeTiled encode;
  if ((e = encode_fn(&encode)) != cudaSuccess) return (int)e;
  int MT, NT, slabs, chunk_rows;
  rwkv_mm4_plan(B, K, O, sms, &MT, &NT, &slabs, &chunk_rows);
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)O, (cuuint64_t)(K / 2)};
  const cuuint64_t strides[1] = {(cuuint64_t)O};
  const cuuint32_t box[2] = {kBoxCols, kRows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wp), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  Mm4Args a;
  a.xs = static_cast<const float*>(xs);
  a.out = static_cast<float*>(out);
  a.row_add = static_cast<const float*>(row_add);
  a.col_add = static_cast<const float*>(col_add);
  a.B = B;
  a.K = K;
  a.O = O;
  a.half = half;
  a.slabs = slabs;
  a.chunk_rows = chunk_rows;
  const int grid = slabs < sms ? slabs : sms;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (MT) {
    case 1: return (int)launch_nt<1>(NT, map, a, grid, st);
    case 2: return (int)launch_nt<2>(NT, map, a, grid, st);
    case 3: return (int)launch_nt<3>(NT, map, a, grid, st);
    default: return (int)launch_nt<4>(NT, map, a, grid, st);
  }
}
