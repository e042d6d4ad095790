// W8A8 head, xs [B, K] f32 -> int8 codes x W [K, O] int8 -> [B, O] f32: the
// head of kernel K5, on the tensor cores.
//
// Replaces rwkv_tpu/ops/pallas/mm8.py:mm8_a8 (_mm8_a8_kernel :132,
// pallas_call :174): each row of xs is quantized with its own scale sx =
// max|row| / 127 (floored at 1e-30) to codes clip(round-half-even(xs / sx),
// -127, 127); the product of codes and weights is exact in integers (the
// TPU's s8 x s8 -> s32 matrix unit, here wgmma .s32.s8.s8), then times sx.
// The caller adds the rank-1 offset term (row_add [B]) and a per-column
// bias (col_add [O]) in the epilogue, as in mm8.cu.
//
// Bound on the card: the K * O weight bytes over device memory bandwidth, as
// mm8's (52 MB for the decode head, 15.5 us at 3.35 TB/s); the s8 products
// (N = B rounded up to 8) are far under it. The design (int8_head.cuh, K3's
// from mm4.cu): a TMA ring feeding wgmma in a persistent grid reads each
// weight byte once for up to 16 batch rows; every block quantizes the
// codes while it stages them, from the caller's row maxima (the decode
// stack's ln_out kernel writes them) or its own, so one launch does it all.
// The integer sums are exact, and the epilogue rounds as mm8_a8_plain does:
// the same bits. No split-K, no scratch, no atomics.
#include "int8_head.cuh"

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How a call is cut (int8_head.cuh plan): boxes of 128 columns a slab,
// n-tiles of 8, slabs, the weight rows of one staging of the codes.
extern "C" void rwkv_mm8_a8_plan(int B, int K, int O, int sms, int* mt, int* nt, int* slabs,
                                 int* chunk_rows) {
  rwkv::plan<true>(B, K, O, sms, mt, nt, slabs, chunk_rows);
}

// Enqueues out = a8(xs) @ w (+ row_add[:, None]) (+ col_add) on `stream`.
// amax_in: [B] row maxima of xs, or null: then the kernel finds them and
// writes them to amax_out (if not null). codes: [B, K] int8, or null: the
// codes the product used. Returns the launch's CUDA error (0 if none).
extern "C" int rwkv_mm8_a8(const void* xs, const void* w, void* out, const void* row_add,
                           const void* col_add, const void* amax_in, void* amax_out,
                           void* codes, int B, int K, int O, void* stream) {
  rwkv::HeadArgs a = {};
  a.xs = static_cast<const float*>(xs);
  a.row_add = static_cast<const float*>(row_add);
  a.col_add = static_cast<const float*>(col_add);
  a.amax = static_cast<const float*>(amax_in);
  a.amax_out = static_cast<float*>(amax_out);
  a.codes = static_cast<int8_t*>(codes);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.K = K;
  a.O = O;
  return rwkv::run<true>(a, w, static_cast<cudaStream_t>(stream));
}
