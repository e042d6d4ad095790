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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A wait of seconds
// can only be a fault: trap, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const uint32_t addr = smem_u32(b);
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t0 == 0)
      t0 = t;
    else if (t - t0 > 2000000000ull)
      __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

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

// Two floats rounded to bf16, packed: lo in the low half (cvt.rn.bf16x2
// puts its first source in the high half), and each half back as a float.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// wgmma with A from registers (the widened weights, 64 columns a
// warpgroup) and B from shared memory (the pieces of one k16 step, no
// swizzle: 8 x 16-byte core matrices, K-adjacent ones kLbo apart, N-adjacent
// ones kSbo apart), f32 accumulators in the m16n8k16 C layout per n-tile.
constexpr int kLbo = 128, kSbo = 256;

__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }

template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NT * 4], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<1>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %9, 0; "
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<2>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %13, 0; "
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<3>(float (&d)[12], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %17, 0; "
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<4>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %21, 0; "
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<5>(float (&d)[20], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %25, 0; "
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<6>(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %29, 0; "
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

int sm_count(cudaError_t* e) {
  static int cached[64];
  int d = 0, s = 0;
  if ((*e = cudaGetDevice(&d)) != cudaSuccess) return 0;
  if (d < 64 && cached[d]) return cached[d];
  if ((*e = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, d)) != cudaSuccess) return 0;
  if (d < 64) cached[d] = s;
  return s;
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
