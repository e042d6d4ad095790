// W8A8 matvec, xs [B, K] f32 -> int8 codes x W [K, O] int8 -> [B, O] f32: the
// head of kernel K5.
//
// Replaces rwkv_tpu/ops/pallas/mm8.py:mm8_a8 (_mm8_a8_kernel): each row of xs
// is quantized with its own scale sx = max|row| / 127 (floored at 1e-30) to
// codes clip(round-half-even(xs / sx), -127, 127); the product of codes and
// weights is exact in integers, then times sx. The caller adds the rank-1
// offset term (row_add [B]) and a per-column bias (col_add [O]) in the
// epilogue, as in mm8.cu.
//
// Bound on the card: the K * O weight bytes over device memory bandwidth, as
// mm8's (52 MB for the decode head, ~16 us at 3.35 TB/s); the integer dot
// products (__dp4a, 4 multiply-adds an instruction) do not come near the
// card's int8 rate at B <= 16. Design (qmv.cuh, FMT kA8): the activations are
// quantized while they are staged, the weights read once with 16-byte loads
// and byte-transposed in registers for __dp4a. The row maxima come from the
// caller where it has them (the decode stack's ln_out kernel), else from a
// first launch here, one block per row.
#include "qmv.cuh"

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

constexpr int kAmaxThreads = 256;

// amax[b] = max_k |xs[b, k]|, one block per row.
__global__ void __launch_bounds__(kAmaxThreads) row_amax_kernel(const float* xs, int K,
                                                                float* amax) {
  __shared__ float scratch[2 * 32];
  const float* row = xs + (size_t)blockIdx.x * K;
  float v[1] = {0.f};
  for (int k = threadIdx.x; k < K; k += blockDim.x) v[0] = fmaxf(v[0], fabsf(row[k]));
  block_maxes<1>(v, scratch);
  if (threadIdx.x == 0) amax[blockIdx.x] = v[0];
}

}  // namespace

// Enqueues out = a8(xs) @ w (+ row_add[:, None]) (+ col_add) on `stream`.
// amax_in: [B] row maxima of xs, or null: then the first launch writes them
// to amax_out. codes: [B, K] int8, or null: the codes the product used.
// Returns the first CUDA error (0 if none).
extern "C" int rwkv_mm8_a8(const void* xs, const void* w, void* out, const void* row_add,
                           const void* col_add, const void* amax_in, void* amax_out,
                           void* codes, int B, int K, int O, void* partial,
                           long long partial_cap, void* counters, int counter_cap,
                           int target_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* amax = static_cast<const float*>(amax_in);
  if (!amax) {
    row_amax_kernel<<<B, kAmaxThreads, 0, st>>>(static_cast<const float*>(xs), K,
                                                static_cast<float*>(amax_out));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    amax = static_cast<const float*>(amax_out);
  }
  QmvArgs a = {};
  a.m[0].x = static_cast<const float*>(xs);
  a.m[0].w = static_cast<const int8_t*>(w);
  a.m[0].K = K;
  a.m[0].amax = amax;
  a.m[0].n_amax = 1;
  a.m[0].qblock = K;
  a.m[0].codes = static_cast<int8_t*>(codes);
  a.nmat = 1;
  a.B = B;
  a.O = O;
  a.epi = EPI_STORE;
  a.out = static_cast<float*>(out);
  a.row_add = static_cast<const float*>(row_add);
  a.col_add = static_cast<const float*>(col_add);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  return (int)launch_qmv<kA8>(a, partial_cap, counter_cap, target_blocks, st);
}
