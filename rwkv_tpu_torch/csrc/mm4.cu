// 4-bit-weight matvec, xs [B, K] f32 x nibble-packed wp [K / 2, O] int8 ->
// [B, O] f32 (kernel K3).
//
// Replaces rwkv_tpu/ops/pallas/mm4.py:mm4 (_mm4_kernel_two_dot and
// _mm4_kernel), reached through qmatmul4_pallas(). The caller pre-scales xs
// by the per-row scale; the offset term x . offset (which already holds the
// +8 * scale centering) arrives as row_add [B], and a per-column bias (the
// logit_bias of a padded vocab) as col_add [O], so the q4 decode head is one
// launch. The TPU kernel folds the activations (a_lo - a_hi / 16 | a_hi / 16)
// because its compiler has no int8 shift; here both nibbles widen directly
// in registers ((p & 0xF) - 8, and p >> 4), with f32 activations and f32
// accumulation: what the TPU kernel computes, not how it blocks it.
//
// Bound on the card: the K * O / 2 packed bytes over device memory
// bandwidth. On the 430M head (K = 1024, O = 50688) that is 26 MB, ~7.7 us at
// 3.35 TB/s. Design against it (qmv.cuh): each byte is read once with 16-byte
// loads (16 columns x 2 rows), 396 column tiles of 128 fill the card.
#include "qmv.cuh"

using namespace rwkv;

extern "C" const char* rwkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Enqueues out = xs @ unpack4(wp, 2 * half) (+ row_add[:, None]) (+ col_add)
// on `stream`, rows paired within blocks of 2 * half (half = K / 2: global);
// returns the launch's CUDA error (0 if none).
extern "C" int rwkv_mm4(const void* xs, const void* wp, void* out, const void* row_add,
                        const void* col_add, int B, int K, int O, int half, void* partial,
                        long long partial_cap, void* counters, int counter_cap,
                        int target_blocks, void* stream) {
  QmvArgs a = {};
  a.m[0].x = static_cast<const float*>(xs);
  a.m[0].w = static_cast<const int8_t*>(wp);
  a.m[0].K = K;
  a.m[0].half = half;
  a.nmat = 1;
  a.B = B;
  a.O = O;
  a.epi = EPI_STORE;
  a.out = static_cast<float*>(out);
  a.row_add = static_cast<const float*>(row_add);
  a.col_add = static_cast<const float*>(col_add);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  return (int)launch_qmv<true>(a, partial_cap, counter_cap, target_blocks,
                               static_cast<cudaStream_t>(stream));
}
