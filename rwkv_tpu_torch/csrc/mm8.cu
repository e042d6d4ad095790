// Int8-weight matvec, xs [B, K] f32 x W [K, O] int8 -> [B, O] f32 (kernel K2).
//
// Replaces rwkv_tpu/ops/pallas/mm8.py:mm8 (_mm8_kernel_f32, the f32-lhs
// default), reached through qmatmul_pallas(). The caller pre-scales xs by the
// per-row scale and adds the rank-1 offset term x . offset; this kernel can
// add it in its epilogue (row_add [B]), together with a per-column bias
// (col_add [O], the logit_bias of a padded vocab), so the decode head is one
// launch.
//
// Bound on the card: the K * O weight bytes over device memory bandwidth. On
// the decode head (K = 1024, O = 50688) that is 52 MB, ~16 us at 3.35 TB/s.
// Design against it (qmv.cuh): each byte is read once with 16-byte loads,
// widened to f32 in registers, f32 accumulation; 396 column tiles of 128
// fill the card without splitting the contraction.
#include "qmv.cuh"

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Enqueues out = xs @ w (+ row_add[:, None]) (+ col_add) on `stream`;
// returns the launch's CUDA error (0 if none).
extern "C" int rwkv_mm8(const void* xs, const void* w, void* out, const void* row_add,
                        const void* col_add, int B, int K, int O, void* partial,
                        long long partial_cap, void* counters, int counter_cap,
                        int target_blocks, void* stream) {
  QmvArgs a = {};
  a.m[0].x = static_cast<const float*>(xs);
  a.m[0].w = static_cast<const int8_t*>(w);
  a.m[0].K = K;
  a.nmat = 1;
  a.B = B;
  a.O = O;
  a.epi = EPI_STORE;
  a.out = static_cast<float*>(out);
  a.row_add = static_cast<const float*>(row_add);
  a.col_add = static_cast<const float*>(col_add);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  return (int)launch_qmv<false>(a, partial_cap, counter_cap, target_blocks,
                                static_cast<cudaStream_t>(stream));
}
