// Grid-wide barrier of a cooperative, persistent launch (the decode stack,
// decode_stack.cu), and the %globaltimer stamps that time its phases.
//
// The launch is cooperative (cudaLaunchAttributeCooperative), at most as
// many blocks as the occupancy API says fit on the card at once, so every
// block is resident and a block that spins cannot starve one that has not
// started. Two words of device memory hold the barrier, on two 128-byte
// lines: a count of arrivals since the launch began, and a count of blocks
// done with the launch. At its k-th barrier a block adds one to the first
// with a release reduction at gpu scope (its threads' writes were ordered
// before it by __syncthreads, and the release makes them visible with it)
// and waits, with acquire loads, until it reaches k times the grid: no
// atomic round trip and no second store stand between the last arrival and
// the others leaving. So what any block wrote before the barrier is visible
// to every block after it (reads of such data use __ldcg all the same: no
// L1 line from before the barrier is read). At the end each block adds one
// to the second word; the last puts both back to 0, when no block can read
// them again in this launch. So no reset launch is needed and a CUDA graph
// may replay the launch any number of times.
//
// The barrier is split in two, arrive() and wait(), so a block can issue the
// loads of its next phase between them: weights and vectors are read-only,
// and their memory round trip then overlaps the wait.
#pragma once

#include "qmv.cuh"

namespace rwkv {

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int kBarrierDone = 32;    // the done count's offset from the arrivals, in words
constexpr int kBarrierWords = 64;   // words a barrier takes

// word[0]: arrivals since the launch began; word[kBarrierDone]: blocks done.
struct GridBarrier {
  unsigned* word;
  unsigned nblocks;
  unsigned target;  // arrivals that end the barrier this block is at

  __device__ __forceinline__ void init(unsigned* w, unsigned n) {
    word = w;
    nblocks = n;
    target = 0;
  }

  __device__ __forceinline__ void arrive() {
    __syncthreads();
    target += nblocks;
    if (threadIdx.x == 0) red_release_gpu(word, 1u);
  }

  // A wait of more than ~2^22 polls (seconds) can only be a fault: trap, so
  // the launch fails with an error instead of holding the card.
  __device__ __forceinline__ void wait() {
    if (threadIdx.x == 0) {
      unsigned polls = 0;
      while (ld_acquire_gpu(word) < target)
        if (++polls == (1u << 22)) __trap();
    }
    __syncthreads();
  }

  __device__ __forceinline__ void sync() {
    arrive();
    wait();
  }

  // After the block's last wait: the last block of the launch resets both
  // words for the next launch. Returns, in thread 0, whether this block was
  // the last.
  __device__ __forceinline__ bool finish() {
    if (threadIdx.x == 0 && atom_add_acq_rel_gpu(word + kBarrierDone, 1u) == nblocks - 1) {
      st_relaxed_gpu(word, 0u);
      st_relaxed_gpu(word + kBarrierDone, 0u);
      return true;
    }
    return false;
  }
};

}  // namespace rwkv
