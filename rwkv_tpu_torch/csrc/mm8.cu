// Int8-weight head, xs [B, K] f32 x W [K, O] int8 -> [B, O] f32 (kernel K2),
// on the tensor cores.
//
// Replaces rwkv_tpu/ops/pallas/mm8.py:mm8 (_mm8_kernel_f32 :39, the f32-lhs
// default, pallas_call :96), reached through qmatmul_pallas(). The caller
// pre-scales xs by the per-row scale; the offset term x . offset arrives as
// row_add [B], and a per-column bias (the logit_bias of a padded vocab) as
// col_add [O], so the decode head is one launch. The TPU kernel multiplies
// the f32 activations by the widened weights on the matrix unit in several
// bf16 passes; this one does the same on wgmma with exact pieces.
//
// Bound on the card: the K * O weight bytes over device memory bandwidth
// (the 430M head, 1024 x 50688, is 52 MB: 15.5 us at 3.35 TB/s); the
// products on bf16 tensor cores (N = 3B columns, up to 48) stay under it.
// The design (int8_head.cuh, K3's from mm4.cu): a TMA ring feeding wgmma
// in a persistent grid reads each weight byte once for up to 16 batch
// rows; each byte widens to an exact bf16 integer in registers, each
// activation is three bf16 pieces, the f32 accumulation the only rounding.
// No split-K, no scratch, no atomics: two calls give the same bits.
#include "int8_head.cuh"

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How a call is cut (int8_head.cuh plan): boxes of 128 columns a slab,
// n-tiles of 8, slabs, the weight rows of one staging of the pieces.
extern "C" void rwkv_mm8_plan(int B, int K, int O, int sms, int* mt, int* nt, int* slabs,
                              int* chunk_rows) {
  rwkv::plan<false>(B, K, O, sms, mt, nt, slabs, chunk_rows);
}

// Enqueues out = xs @ w (+ row_add[:, None]) (+ col_add) on `stream`;
// returns the launch's CUDA error (0 if none).
extern "C" int rwkv_mm8(const void* xs, const void* w, void* out, const void* row_add,
                        const void* col_add, int B, int K, int O, void* stream) {
  rwkv::HeadArgs a = {};
  a.xs = static_cast<const float*>(xs);
  a.row_add = static_cast<const float*>(row_add);
  a.col_add = static_cast<const float*>(col_add);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.K = K;
  a.O = O;
  return rwkv::run<false>(a, w, static_cast<cudaStream_t>(stream));
}
