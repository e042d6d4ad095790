// Hopper building blocks shared by the kernels on the tensor cores (mm4.cu,
// kernel K3; int8_head.cuh, kernels K2 and K5's head; stack_tc.cuh, kernel
// K1's matvecs): mbarriers, the TMA's 2-D tile load, ldmatrix.trans, bf16
// packing, the widening of int8 codes to bf16, the wgmma wrappers (A from
// registers, B from shared memory without swizzle, f32 or s32 accumulators)
// and the driver's tensor-map encoder, found through the runtime.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rwkv {

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

// Whether the barrier's phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* b, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2; "
      "selp.u32 %0, 1, 0, p; }"
      : "=r"(done)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait by a whole warp that leaves the wait together (a vote on every
// poll): code after it is not on a divergent path, which ptxas would
// otherwise take as a reason to serialize the wgmma that follow. More than
// ~2^24 polls (seconds) can only be a fault: trap.
__device__ __forceinline__ void mbar_wait_warp(uint64_t* b, unsigned parity) {
  const uint32_t addr = smem_u32(b);
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (__all_sync(0xffffffffu, done)) return;
    if (polls == (1u << 24)) __trap();
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

// Two floats rounded to bf16, packed: lo in the low half (cvt.rn.bf16x2
// puts its first source in the high half), and each half back as a float.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// One ldmatrix.trans word (bytes: row 2t x columns 2g, 2g + 1, then row
// 2t + 1's) as two bf16x2 A registers of m64nNk16: column 2g's two rows
// and column 2g + 1's, each byte an exact bf16 integer.
__device__ __forceinline__ void widen8(uint32_t W, uint32_t& c0, uint32_t& c1) {
  const uint32_t X = W ^ 0x80808080u;  // w + 128, unsigned
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // bits 0x4B0000uu: 2^23 + uu, exactly; minus 2^23 + 128
    f[i] = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(X, 0x4B000000u, 0x7440u | i)),
                                     8388736.f));
  c0 = __byte_perm(f[0], f[2], 0x7632);  // the high halves: an integer of 8 bits is its bf16
  c1 = __byte_perm(f[1], f[3], 0x7632);
}

// The activations' operand, one wgmma step after another (N * 32 bytes
// each, 16 k of bf16 or 32 of int8): 8 x 16-byte core matrices, core matrix
// (n-tile, k half) at (2 * ntile + khalf) * 128 bytes, its row n % 8 at 16
// bytes. No swizzle.
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
__device__ __forceinline__ void fence_operand(int& x) { asm volatile("" : "+r"(x)::"memory"); }

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

template <int NT>
__device__ __forceinline__ void wgmma_s8(int (&d)[NT * 4], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<1>(int (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %9, 0; "
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p; }"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<2>(int (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %13, 0; "
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p; }"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_fn(EncodeTiled* fn) {
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

// SMs of the current device (the wrapper makes the tensors' card current).
inline int sm_count(cudaError_t* e) {
  static int cached[64];
  int d = 0, s = 0;
  if ((*e = cudaGetDevice(&d)) != cudaSuccess) return 0;
  if (d < 64 && cached[d]) return cached[d];
  if ((*e = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, d)) != cudaSuccess) return 0;
  if (d < 64) cached[d] = s;
  return s;
}

}  // namespace rwkv
