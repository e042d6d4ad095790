// The matvec phases of the q8 decode stack on the tensor cores (kernel K1 at
// batch rows B* <= B <= 16: decode_stack.cu's decode_stack_kernel_tc), on the
// design of the int8 heads (int8_head.cuh) and the building blocks of
// tma_wgmma.cuh.
//
// What bounds K1 at 16 rows: each phase reads 26-131 MB of int8 weights at
// RWKV-4 14B widths (1-5 MB at 430M), and the CUDA-core path (qmv.cuh) keeps
// partial sums for at most 4 batch rows in registers, so at B = 16 it reads
// each weight byte up to four times and runs every product as an f32 FMA.
// Here every weight byte is read from device memory once a step, for all B
// rows, and the products run on wgmma:
//
// * The work of a phase. Each matrix of the phase (A: k, v, r; B: output;
//   C: ffn key; D: ffn value and receptance) is cut into splits of ks
//   stages (kTcRows rows) of its contraction and groups of T column tiles
//   of 128; a unit is one (matrix, split, tile group), and each block of the
//   cooperative grid takes at most one unit a phase (tc_unit). The host
//   picks ks and T per phase (ops/cuda/decode_stack.py's tc_plan) so the
//   units fill the grid and the operand below fits in shared memory.
// * The weight stream. Every weight family is one TMA tensor map over its
//   [L * K, O] codes (kTcRows rows x 128 columns a box, the 128-byte
//   swizzle), encoded once when the wrapper prepares the parameters. Warp 0
//   keeps a ring of kTcStages boxes in flight with mbarriers: a unit walks its
//   tiles (in an order rotated by its split, so the splits of one tile
//   finish at different times) and each tile's stages. The first stages of
//   the next phase's unit are issued before the block waits at the grid
//   barrier: the weights do not depend on it.
// * The product, out^T[c, n] = sum_k W[k, c] * X[k, n] on wgmma m64n48k16,
//   as in K2: each warp widens its 16 columns of a stage (ldmatrix.trans,
//   then each byte an exact bf16 integer) into the A fragments; B is the
//   block's operand, the unit's rows of the (scaled) activations as three
//   bf16 pieces a value (hi, mid, lo, whose sum is the value: every product
//   exact, the f32 accumulation the only rounding), n = 3b + piece, N = 48
//   for up to 16 rows (rows past B are zero). The operand holds only the
//   unit's split of the contraction, staged once a phase: in B and D from
//   the activations the phase before wrote; in the folded phases (A, C) from
//   each row's LayerNorm statistics and the mixes' rank-1 offset sums over
//   all of E, which tc_fold takes from per-tile sums the producing phase's
//   epilogues left (TcNext), and each value's LayerNorm and token-shift mix
//   computed where it is staged. Layer 0's phase A, whose x is the embedding
//   after ln0, computes them from whole rows as the CUDA-core path does
//   (stack.cuh's FoldSrc, 4 rows at a time).
// * Split-K. Each unit writes its tile's partial [B, 128] (the three pieces
//   of a row summed in a fixed order) to global scratch; the last unit of a
//   tile to arrive (an atomic counter elects it, and is reset by it) sums the
//   partials of every split of every matrix in the fixed order s = 0..S-1,
//   never atomically added, and runs the phase's epilogue (WKV, residual
//   add, relu^2, gated residual, and the per-tile offset sums of the next
//   matrix, and TcNext's sums), so two launches give the same bits.
#pragma once

#include "stack.cuh"
#include "tma_wgmma.cuh"

namespace rwkv {

// A stage: one TMA box of 128 weight rows x 128 columns, 16 KB. Boxes of 64
// rows took 16 % longer a layer at 14B widths on an H100 (each stage costs
// its waits and hand-offs whatever its size), 4 % less at 430M's.
constexpr int kTcRows = 128;                   // weight rows a stage (a TMA box)
constexpr int kTcBox = kTcRows * kTileO;       // bytes a stage
constexpr int kTcStages = 4;                   // the ring
constexpr int kTcMaxB = 16;                    // batch rows of the operand
constexpr int kTcNT = 6;                       // n-tiles of 8: N = 3 pieces x 16 rows
constexpr int kTcN = 8 * kTcNT;
constexpr int kTcRowBytes = 2 * kTcN;          // operand bytes a weight row
constexpr int kTcHalfES = kTcN / 2 + 1;        // a warp's scratch stride: 8 rows' pieces + 1
constexpr int kTcMaps = 7;                     // att k, v, r, output; ffn key, value, receptance

// The weight families' tensor maps, [L * K, O] int8 each, in the order of
// kTcMaps (decode_stack.cu's rwkv_decode_stack_tc_maps encodes them).
struct TcMaps {
  CUtensorMap m[kTcMaps];
};

// Per phase kind (A, B, C, D): stages a split, column tiles a group.
struct TcPlan {
  int ks[4];
  int tiles[4];
};

// The folded phase that reads the x a phase's epilogue writes (phase B's:
// ln2 and the ffn mixes; phase D's: the next layer's ln1 and att mixes), or
// parts == nullptr. The epilogue leaves, per column tile t of x, the sums
// over its 128 columns that the folded phase needs of each batch row b
// (tc_fold): parts[t][b][0..7] = sum x, sum x^2, and per mix j
// sum x * w * mix_j * off_j, sum (1 - mix_j) * prev * off_j; parts[t][16][0..5]
// = per mix j sum mix_j * w * off_j, sum mix_j * bias * off_j, each a double
// sum of exact double products.
struct TcNext {
  double* parts;
  const float* ln_w;
  const float* ln_b;
  const float* prev;
  const float* mix[3];
  const float* offset[3];
  int nmix;
};
constexpr int kTcParts = 8;                            // doubles a row of a tile
constexpr int kTcTileParts = kTcMaxB * kTcParts + 6;   // doubles a tile

// Bytes of the TC kernel's dynamic shared memory before the LayerNormed rows:
// the ring (1024-aligned for the swizzle), its mbarriers, each warp's
// epilogue scratch, the folded mixes' [3, 16] offset terms (double) and the
// epilogue's [3, 16] summed offset terms.
constexpr size_t kTcFixedBytes = 1024 + (size_t)kTcStages * kTcBox + 2 * kTcStages * 8 +
                                 (size_t)kWarps * 16 * kTcHalfES * 4 + 3 * kTcMaxB * 8 +
                                 3 * kTcMaxB * 4;

// The whole dynamic shared memory: the fixed part, 4 LayerNormed rows of E
// and the folded phases' operand of op_stages stages (the other phases'
// operand starts at the rows and may also take their space).
inline size_t tc_smem(int E, int op_stages) {
  return kTcFixedBytes + (size_t)4 * E * sizeof(float) +
         (size_t)op_stages * kTcRows * kTcRowBytes;
}

struct TcSmem {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  float* scratch;     // [8 warps][16 columns][kTcHalfES]
  double* offs;       // [3, B] the folded mixes' rank-1 terms (FoldSrc)
  float* offv;        // [3, 16] each matrix's rank-1 term, rounded once
  float* xx;          // [4, E]
  uint32_t* op_fold;  // the operand in phases A and C
  uint32_t* op_free;  // in phases B and D (over xx)

  __device__ __forceinline__ void carve(unsigned char* base, int E) {
    ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(base) + 1023) & ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(ring + (size_t)kTcStages * kTcBox);
    empty = full + kTcStages;
    scratch = reinterpret_cast<float*>(empty + kTcStages);
    offs = reinterpret_cast<double*>(scratch + kWarps * 16 * kTcHalfES);
    offv = reinterpret_cast<float*>(offs + 3 * kTcMaxB);
    xx = offv + 3 * kTcMaxB;  // 16-byte aligned: every part above is a multiple of 16 bytes
    op_fold = reinterpret_cast<uint32_t*>(xx + 4 * (size_t)E);
    op_free = reinterpret_cast<uint32_t*>(xx);
  }
};

// A block's unit of a phase: matrix m of q, split s of its S, column tiles
// [t0, t0 + nt), weight rows [k0, k0 + 64 ns); its partials go to scratch
// slot base + s (slots: the splits of matrices 0..m-1 first, ks stages a
// split), and each tile takes `arrivals` units (every split of every
// matrix); the phase has `units` units.
struct TcUnit {
  int live, m, s, ks, k0, ns, t0, nt, map, row0, base, arrivals, units;
};

// Unit blockIdx.x of the phase q of kind `kind` at layer l (every thread
// computes the same), for the plan's ks and tiles a group.
__device__ __forceinline__ TcUnit tc_unit(const QmvArgs& q, int kind, int l, int ks, int T) {
  TcUnit u = {};
  u.ks = ks;
  const int tiles = q.O / kTileO, groups = (tiles + T - 1) / T;
  int n = 0, slots = 0;
  for (int m = 0; m < q.nmat; ++m) {
    const int kst = q.m[m].K / kTcRows, S = (kst + ks - 1) / ks, cnt = S * groups;
    const int r = (int)blockIdx.x - n;
    if (!u.live && r >= 0 && r < cnt) {
      u.live = 1;
      u.m = m;
      u.s = r / groups;
      const int g = r - u.s * groups;
      u.k0 = u.s * ks * kTcRows;
      u.ns = min(ks, kst - u.s * ks);
      u.t0 = g * T;
      u.nt = min(T, tiles - u.t0);
      u.map = (kind ? kind + 2 : 0) + m;  // A: 0..2, B: 3, C: 4, D: 5..6
      u.row0 = l * q.m[m].K + u.k0;
      u.base = slots;
    }
    n += cnt;
    slots += S;
  }
  u.arrivals = slots;
  u.units = n;
  return u;
}

// The tile of a unit's i-th sweep: rotated by the split.
__device__ __forceinline__ int tc_tile(const TcUnit& u, int i) { return u.t0 + (i + u.s) % u.nt; }

// Warp 0, lane 0 issuing: the unit's stages [prod, upto) into the ring, stage j of
// the phase into slot (first + j) % kTcStages once the stage before it in
// that slot has been released by every warp. It waits for that only up to
// stage `need` (the one the warps read next); past it, it stops at the first
// slot not yet free, and issues the rest at a later stage: a wait there
// would hold its warp, and with it its warpgroup's wgmma, behind the
// slowest warp of the other warpgroup. The whole warp runs the loop and
// the waits (one lane issues), so the path to the wgmma that follows is not
// divergent: on a divergent one ptxas serializes the wgmma.
__device__ __forceinline__ void tc_issue(const TcUnit& u, const TcMaps& maps, const TcSmem& sm,
                                         unsigned first, int& prod, int upto, int need) {
  const int J = u.nt * u.ns;
  upto = min(upto, J);
  for (; prod < upto; ++prod) {
    const unsigned g = first + prod, slot = g % kTcStages, parity = ((g / kTcStages) & 1) ^ 1;
    if (prod <= need)
      mbar_wait_warp(&sm.empty[slot], parity);
    else if (!__all_sync(0xffffffffu, mbar_test(&sm.empty[slot], parity)))
      break;
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(&sm.full[slot], kTcBox);
      const int i = prod / u.ns, st = prod - i * u.ns;
      tma_load(sm.ring + (size_t)slot * kTcBox, &maps.m[u.map], &sm.full[slot],
               tc_tile(u, i) * kTileO, u.row0 + st * kTcRows);
    }
    __syncwarp();
  }
}

// Operand words of the unit's weight rows [k0, k0 + R) (R / 2 row pairs)
// for batch rows b0 .. b0 + W - 1 (W = 4 or 16): get(b, bi, k) is the scaled
// activation pair (k, k + 1) of batch row b (bi = b - b0), rows b >= B zero.
// Pair p's word for column n: step p / 8, k half (p / 4) % 2, word p % 4 of
// the core matrix of n-tile n / 8, its row n % 8 (tma_wgmma.cuh's layout).
// A warp takes 4 pairs x 8 batch rows: 32 distinct banks for each piece.
template <int W, class Get>
__device__ __forceinline__ void tc_stage(uint32_t* op, int R, int k0, int b0, int B,
                                         const Get& get) {
  constexpr int kU = 4;  // items a thread with their loads in flight
  const int items = (R >> 1) * W;
  for (int i0 = threadIdx.x; i0 < items; i0 += kU * kThreads) {
    float2 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads, bi = (i >> 2) % W, p = (i >> 2) / W * 4 + (i & 3);
      v[u] = i < items && b0 + bi < B ? get(b0 + bi, bi, k0 + 2 * p) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= items) break;
      const int bi = (i >> 2) % W, p = (i >> 2) / W * 4 + (i & 3), b = b0 + bi;
      uint32_t* dst = op + (p >> 3) * kTcNT * 64 + ((p >> 2) & 1) * 32 + (p & 3);
      const uint32_t hi = bf16x2(v[u].x, v[u].y);
      const float e0 = v[u].x - bf16_lo(hi), e1 = v[u].y - bf16_hi(hi);
      const uint32_t mid = bf16x2(e0, e1);
      const uint32_t piece[3] = {hi, mid, bf16x2(e0 - bf16_lo(mid), e1 - bf16_hi(mid))};
#pragma unroll
      for (int qq = 0; qq < 3; ++qq) {
        const int n = 3 * b + qq;
        dst[(n >> 3) * 64 + (n & 7) * 4] = piece[qq];
      }
    }
  }
}

// A folded phase's rows (A: ln1 and the k, v, r mixes; C: ln2, the key and
// receptance mixes) from the sums its producer's epilogues left per column
// tile (TcNext): each row's mean and variance over E, and each mix's
// rank-1 sum over E,
//   sum_k (mix * ln + (1 - mix) * prev) * off
//     = rs * (sum x w mix off - mean * sum mix w off) + sum mix bias off
//       + sum (1 - mix) prev off,   ln = (x - mean) * rs * w + bias,
// all in double and rounded once: within f32 rounding of the plain version,
// without a block reading all B rows of x. Then the block's share [lo, hi)
// of the rows' [B, E] outputs and its unit's operand rows, each value's
// LayerNorm taken from x where it is read. Layer 0's phase A, whose x is the
// embedding after ln0, runs FoldSrc's prologue instead.
__device__ __forceinline__ void tc_fold(const FoldSrc<4, false>& s, const double* parts, int mu,
                                        const float* scale, int k0, int R, uint32_t* op,
                                        double* red) {
  __shared__ float mean[kTcMaxB], rs[kTcMaxB];
  const int tid = threadIdx.x, E = s.E, B = s.B, tiles = E / kTileO;
  if (tid < kTcMaxB * kTcParts + 6) {  // each sum over the tiles, in order
    const int b = tid / kTcParts;
    double v = 0.0;
    if (b < B || b == kTcMaxB) {
#pragma unroll 8
      for (int t = 0; t < tiles; ++t) v += __ldcg(parts + (size_t)t * kTcTileParts + tid);
    }
    red[tid] = v;
  }
  __syncthreads();
  if (tid < B) {
    const double* r = red + tid * kTcParts;
    const double* c = red + kTcMaxB * kTcParts;
    const double m = r[0] / E;
    const float mf = (float)m, rf = rsqrtf((float)(r[1] / E - m * m) + 1e-8f);
    mean[tid] = mf;
    rs[tid] = rf;
    for (int j = 0; j < s.nmix; ++j) {
      const double v = (double)rf * (r[2 + j] - (double)mf * c[2 * j]) + c[2 * j + 1] + r[5 + j];
      s.offs[j * B + tid] = (double)(float)v;
      if (j == 1 && s.fr_off) s.fr_off[tid] = (double)(float)v;
    }
  }
  __syncthreads();
  auto ln = [&](int b, int k) {
    return (__ldcg(s.resid + (size_t)b * E + k) - mean[b]) * rs[b] * s.ln_w[k] + s.ln_b[k];
  };
  const int w = s.hi - s.lo;
  for (int i = tid; i < B * w; i += kThreads) {
    const int b = i / w, k = s.lo + i - b * w;
    const size_t g = (size_t)b * E + k;
    const float v = ln(b, k);
    s.prev_out[g] = v;
    if (s.fr_out) s.fr_out[g] = token_mix<false>(s.mix[1][k], v, s.prev[g]);
  }
  const float* mix = s.mix[mu];
  tc_stage<kTcMaxB>(op, R, k0, 0, B, [&](int b, int, int k) {
    const float* pr = s.prev + (size_t)b * E;
    return make_float2(token_mix<false>(mix[k], ln(b, k), pr[k]) * scale[k],
                       token_mix<false>(mix[k + 1], ln(b, k + 1), pr[k + 1]) * scale[k + 1]);
  });
}

// One tile of a unit: its ns stages through the ring into acc (every warp:
// wgmma m64n48k16 over its warpgroup's 64 columns), warp 0 issuing the
// stages ahead. A stage's four k16 steps go out back to back as one group
// (one accumulator chain the tensor cores pipeline), its 16 A registers
// held until the group is done: the next stage waits for that after its
// ldmatrix, before it widens into them. j: the phase's stages consumed so
// far (updated).
__device__ __forceinline__ void tc_tile_sums(float (&acc)[kTcNT * 4], const TcUnit& u,
                                             const TcMaps& maps, const TcSmem& sm,
                                             const uint32_t* op, unsigned first, int& j,
                                             int& prod) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kTcNT * 4; ++i) acc[i] = 0.f;
  const uint64_t desc0 = b_desc(op);
  uint32_t A[4][4];
  for (int st = 0; st < u.ns; ++st, ++j) {
    if (warp == 0) tc_issue(u, maps, sm, first, prod, j + kTcStages, j);
    const unsigned g = first + j, slot = g % kTcStages;
    mbar_wait_warp(&sm.full[slot], (g / kTcStages) & 1);
    // per 64 rows h of the stage: word 4i + jj holds rows 64h + 32i + 8jj +
    // (2t, 2t + 1), columns (2g, 2g + 1)
    uint32_t w[kTcRows / 64][8];
    const uint8_t* sp = sm.ring + (size_t)slot * kTcBox;
#pragma unroll
    for (int h = 0; h < kTcRows / 64; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4_trans(&w[h][4 * i], sp + (64 * h + 32 * i + lane) * kTileO +
                                            ((warp ^ (lane & 7)) << 4));
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[slot]);
#pragma unroll
    for (int h = 0; h < kTcRows / 64; ++h) {
      wgmma_wait<0>();  // the group before is done with A
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // k16 steps: words 2s, 2s + 1
        widen8(w[h][2 * s], A[s][0], A[s][1]);
        widen8(w[h][2 * s + 1], A[s][2], A[s][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int qk = (kTcRows / 16) * st + 4 * h + s;
        wgmma_bf16<kTcNT>(acc, A[s], desc0 + ((qk * kTcN * 32) >> 4));
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kTcNT * 4; ++i) fence_operand(acc[i]);
}

// The tile's partial of split slot `slot` for batch rows < B: accumulator
// rows g, g + 8 of a warp are its columns 2g, 2g + 1; each half of the
// n-tiles (8 batch rows) goes through the warp's scratch, and a row's three
// pieces are summed lo + mid + hi.
__device__ __forceinline__ void tc_write_partial(const float (&acc)[kTcNT * 4], const TcSmem& sm,
                                                 float* partial, int slot, int B, int O,
                                                 int col0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sc = sm.scratch + warp * 16 * kTcHalfES;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (8 * h >= B) break;
#pragma unroll
    for (int n = 0; n < kTcNT / 2; ++n) {
      const int nn = h * (kTcNT / 2) + n;
      float* s0 = sc + 2 * g * kTcHalfES + 8 * n + 2 * t;
      s0[0] = acc[4 * nn];
      s0[1] = acc[4 * nn + 1];
      s0[kTcHalfES] = acc[4 * nn + 2];
      s0[kTcHalfES + 1] = acc[4 * nn + 3];
    }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * 8; e += 32) {
      const int cl = e & 15, bl = e >> 4, b = 8 * h + bl;
      if (b < B) {
        const float* s = sc + cl * kTcHalfES + 3 * bl;
        __stcg(partial + ((size_t)slot * B + b) * O + col0 + warp * 16 + cl,
               __fadd_rn(__fadd_rn(s[2], s[1]), s[0]));
      }
    }
    __syncwarp();
  }
}

// The epilogue of tile `tile`, by the block its last unit ran on: each
// matrix's partials summed over its splits in order, its rank-1 term added,
// then the phase's epilogue (qmv.cuh's, operation for operation) and the
// per-tile offset sums of the matrix that reads the output. local(m): the
// rank-1 term of matrix m is in shared memory (the folded phases). Thread
// (b, c8) takes batch row b = tid / 16 and columns 8 c8 .. 8 c8 + 7.
template <class Local>
__device__ __forceinline__ void tc_epilogue(const QmvArgs& a, const TcUnit& u, const TcSmem& sm,
                                            const TcNext& nx, int tile, const Local& local) {
  const int tid = threadIdx.x, B = a.B, O = a.O;
  {
    // each rank-1 term summed in double by `lanes` lanes in a fixed order
    // (lane i takes parts i, i + lanes, ...; then the lanes pairwise), rounded once
    const int lanes = a.nmat == 1 ? 16 : (a.nmat == 2 ? 8 : 4);
    const int pair = tid / lanes, li = tid - pair * lanes, m = pair / kTcMaxB, b = pair % kTcMaxB;
    double v = 0.0;
    if (m < a.nmat && b < B && a.m[m].off) {
      const Mat& mt = a.m[m];
      const bool loc = local(m);
#pragma unroll 4
      for (int p = li; p < mt.n_off; p += lanes) {
        const double* o = mt.off + (size_t)p * B + b;
        v += loc ? *o : __ldcg(o);
      }
    }
    for (int o = 1; o < lanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (m < a.nmat && li == 0) sm.offv[m * kTcMaxB + b] = (float)v;
  }
  __syncthreads();
  const int b = tid >> 4, c8 = tid & 15;
  constexpr int kC = 8;  // columns a thread
  double contrib = 0.0;
  double part[kTcParts + 6];  // this thread's share of nx's sums (TcNext)
#pragma unroll
  for (int i = 0; i < kTcParts + 6; ++i) part[i] = 0.0;
  if (b < B) {
    const bool wkv = a.epi == EPI_WKV, resid = a.epi == EPI_ADD || a.epi == EPI_GATED_ADD;
    const size_t row = (size_t)b * O + tile * kTileO + kC * c8;
    float e_x[kC], e_aa[kC], e_bb[kC], e_pp[kC];
    auto load8 = [&](float (&d)[kC], const float* src, bool cg) {
      const float4* s4 = reinterpret_cast<const float4*>(src + row);
      const float4 lo = cg ? __ldcg(s4) : s4[0], hi = cg ? __ldcg(s4 + 1) : s4[1];
      d[0] = lo.x; d[1] = lo.y; d[2] = lo.z; d[3] = lo.w;
      d[4] = hi.x; d[5] = hi.y; d[6] = hi.z; d[7] = hi.w;
    };
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) e_x[jj] = e_aa[jj] = e_bb[jj] = e_pp[jj] = 0.f;
    float e_bonus[kC], e_decay[kC], e_next[kC];
    const int c0 = tile * kTileO + kC * c8;  // the thread's first column
    auto col8 = [&](float (&d)[kC], const float* src) {
      const float4 lo = reinterpret_cast<const float4*>(src + c0)[0];
      const float4 hi = reinterpret_cast<const float4*>(src + c0)[1];
      d[0] = lo.x; d[1] = lo.y; d[2] = lo.z; d[3] = lo.w;
      d[4] = hi.x; d[5] = hi.y; d[6] = hi.z; d[7] = hi.w;
    };
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) e_bonus[jj] = e_decay[jj] = e_next[jj] = 0.f;
    if (resid) load8(e_x, a.out, true);
    if (wkv) {
      load8(e_aa, a.aa_in, false);
      load8(e_bb, a.bb_in, false);
      load8(e_pp, a.pp_in, false);
      col8(e_bonus, a.bonus);
      col8(e_decay, a.decay);
    }
    if (a.next_offset) col8(e_next, a.next_offset);
    // nx's vectors at the thread's columns, and its previous rows (TcNext)
    float n_w[kC], n_b[kC], n_p[kC], n_mix[3][kC], n_off[3][kC];
    if (nx.parts) {
      col8(n_w, nx.ln_w);
      col8(n_b, nx.ln_b);
      load8(n_p, nx.prev, false);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        if (m < nx.nmix) {
          col8(n_mix[m], nx.mix[m]);
          col8(n_off[m], nx.offset[m]);
        }
      }
    }
    float v[kMaxMats][kC];
    int slot = 0;
#pragma unroll
    for (int m = 0; m < kMaxMats; ++m) {
#pragma unroll
      for (int jj = 0; jj < kC; ++jj) v[m][jj] = 0.f;
      if (m >= a.nmat) continue;
      const int S = (a.m[m].K / kTcRows + u.ks - 1) / u.ks;
      const float4* p = reinterpret_cast<const float4*>(a.partial + (size_t)slot * B * O + row);
      const size_t step = (size_t)B * O / 4;
#pragma unroll 8
      for (int s = 0; s < S; ++s) {
        const float4 lo = __ldcg(p + s * step), hi = __ldcg(p + s * step + 1);
        v[m][0] += lo.x; v[m][1] += lo.y; v[m][2] += lo.z; v[m][3] += lo.w;
        v[m][4] += hi.x; v[m][5] += hi.y; v[m][6] += hi.z; v[m][7] += hi.w;
      }
      slot += S;
    }
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      const size_t idx = row + jj;
      // each operation rounded on its own, in the plain version's order
      const float v0 = __fadd_rn(v[0][jj], sm.offv[b]);
      float o = 0.f;
      switch (a.epi) {
        case EPI_ADD:
          o = __fadd_rn(e_x[jj], v0);
          break;
        case EPI_RELU2: {
          const float r = fmaxf(v0, 0.f);
          o = __fmul_rn(r, r);
          break;
        }
        case EPI_GATED_ADD:
          o = __fadd_rn(e_x[jj],
                        __fmul_rn(sigmoidf_(__fadd_rn(v[1][jj], sm.offv[kTcMaxB + b])), v0));
          break;
        case EPI_WKV: {
          // ops/wkv.py::wkv_step, operation for operation
          const float k = v0;
          const float vv = __fadd_rn(v[1][jj], sm.offv[kTcMaxB + b]);
          const float r = __fadd_rn(v[2][jj], sm.offv[2 * kTcMaxB + b]);
          const float aa = e_aa[jj], bb = e_bb[jj], pp = e_pp[jj];
          const float ww = __fadd_rn(e_bonus[jj], k);
          const float qq = fmaxf(pp, ww);
          const float e1 = expf(__fsub_rn(pp, qq)), e2 = expf(__fsub_rn(ww, qq));
          const float y = __fdiv_rn(__fadd_rn(__fmul_rn(e1, aa), __fmul_rn(e2, vv)),
                                    __fadd_rn(__fmul_rn(e1, bb), e2));
          const float ww2 = __fadd_rn(pp, e_decay[jj]);
          const float p2 = fmaxf(ww2, k);
          const float f1 = expf(__fsub_rn(ww2, p2)), f2 = expf(__fsub_rn(k, p2));
          a.aa_out[idx] = __fadd_rn(__fmul_rn(f1, aa), __fmul_rn(f2, vv));
          a.bb_out[idx] = __fadd_rn(__fmul_rn(f1, bb), f2);
          a.pp_out[idx] = p2;
          o = __fmul_rn(sigmoidf_(r), y);
          break;
        }
        default:  // EPI_STORE
          o = v0;
      }
      a.out[idx] = o;
      if (a.next_offset) contrib += (double)o * (double)e_next[jj];  // exact products
      if (nx.parts) {
        const double x = o, w = n_w[jj], p = n_p[jj];
        part[0] += x;
        part[1] += x * x;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if (m >= nx.nmix) continue;
          const float mj = n_mix[m][jj];
          const double off = n_off[m][jj];
          part[2 + m] += x * w * (double)mj * off;
          part[5 + m] += (double)__fsub_rn(1.f, mj) * p * off;
          if (b == 0) {  // the tile's constants, once
            part[kTcParts + 2 * m] += (double)mj * w * off;
            part[kTcParts + 2 * m + 1] += (double)mj * (double)n_b[jj] * off;
          }
        }
      }
    }
  }
  if (nx.parts) {  // over the row's 16 lanes, a fixed order
#pragma unroll
    for (int i = 0; i < kTcParts + 6; ++i)
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
    double* dst = nx.parts + (size_t)tile * kTcTileParts;
    if (b < B && c8 < kTcParts) {
      double v = part[0];
#pragma unroll
      for (int i = 1; i < kTcParts; ++i) v = c8 == i ? part[i] : v;
      dst[b * kTcParts + c8] = v;
    }
    if (b == 0 && c8 < 6) {
      double v = part[kTcParts];
#pragma unroll
      for (int i = 1; i < 6; ++i) v = c8 == i ? part[kTcParts + i] : v;
      dst[kTcMaxB * kTcParts + c8] = v;
    }
  }
  // the tile's offset sum of row b over its 128 columns: 16 lanes, a fixed order
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) contrib += __shfl_xor_sync(0xffffffffu, contrib, o);
  if (b < B && c8 == 0 && a.next_offset) a.next_off[(size_t)tile * B + b] = contrib;
  __syncthreads();  // offv is rewritten by the next tile's epilogue
}

}  // namespace rwkv
