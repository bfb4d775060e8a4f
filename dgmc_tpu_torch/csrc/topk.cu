// Streaming exact top-k of h_s @ h_t^T for Hopper (sm_90a), float32 or
// bfloat16 inputs.
//
// Replaces dgmc_tpu/ops/pallas/topk.py::_kernel (the Pallas TPU kernel
// behind pallas_topk). For each source row it returns the k largest inner
// products with the target rows, sorted by value descending with the
// lowest target index first among equal values (the lax.top_k rule), and
// never materializes the N_s x N_t score matrix.
//
// bf16 inputs (the precision policy's variant, dgmc_topk_bf16): products
// and sums in float32 as for float32 inputs, then each score rounded to
// bf16 (round to nearest even) and carried in float32, masked targets at
// -finfo(bf16).max, as the TPU kernel does (its scores round through the
// input dtype); the wrapper returns the values in bf16. The ring stages
// bf16 rows as they are (half the bytes a slot); each slot that lands is
// widened once into a float32 slot that the product then reads as for
// float32 inputs (a barrier more a slot), instead of every thread widening
// each value it reads (16 times over: a quarter more instructions than the
// FMAs they feed).
//
// Bound on the H100: 2*N_s*N_t*C FLOPs at the card's float32 rate (FMAs
// outside the tensor cores, for bf16 inputs too: no tensor-core tile
// yet; the port's float32 contract keeps TF32 off),
// with device-memory traffic of h_s + h_t + t_mask + out, each read or
// written once. At the DBP15K shape (15000 x 20000, C = 256, k = 10) that
// is 153.6 GFLOP against ~36 MB: bound by operations. A 16-64-row query
// against the same table is bound by the 20 MB read of h_t instead.
//
// Design. The TPU kernel keeps its running top-k in VMEM across a
// sequential grid axis over target blocks; CUDA blocks run in no order,
// so each block owns TS source rows (TS in {16, 32, 64, 128}, the
// wrapper's choice: a small query gets a row tile of its own size, so no
// FMA goes to padding rows) and LOOPS over the TT = 128-target tiles of
// one segment of the target axis:
//   1. Product. A ring of 3 shared-memory slots (2 where a large carry
//      leaves no room), each holding BK = 32 channels of the TS h_s rows
//      and the TT h_t rows in their global (channel-contiguous) layout,
//      filled by cp.async two slots ahead of the one being multiplied:
//      one barrier per 32 channels, the loads of the next slots in flight
//      meanwhile, across tile boundaries too. 256 threads in a 16 x 16
//      grid, each a (TS/16) x 8 register tile: rows ty + 16i, targets
//      tx + 16j, read as float4s along the channels (the row pitch of
//      BK + 4 floats makes those reads conflict-free). Every score sums
//      its channels in order. A block may use 255 registers, so the 64
//      accumulators and 36 operand registers of TS = 128 do not spill.
//   2. Selection from registers, no barrier. The 16 threads that hold a
//      row's scores form one half-warp, so a row is selected there: only
//      scores strictly above the row's k-th carried value are candidates
//      (carried indices are all lower), and for k <= 16 a tile's scores
//      below the k-th largest of the 16 threads' maxima are dropped too
//      (they cannot reach the tile's own top k). After the first tiles a
//      tile costs a comparison per score and one ballot per row. A row
//      with candidates loads its carry (row-major in shared memory) into
//      the half-warp's registers, entry e in lane e % 16. Where a
//      half-warp has more than BATCH_MIN candidates (k <= 16; the first
//      tiles of a segment), they go in batches of up to 16, one a lane: a
//      16-lane bitonic sort, then the better of each (carry, batch) pair
//      and a bitonic merge leave the best 16 of both in order, a fixed 15
//      shuffle stages a batch instead of a chain of collectives per
//      candidate. Otherwise (and for k > 16) each candidate is placed by
//      a ballot count of the entries better than it, those behind it
//      moving up a lane. Keys order by value descending, then index
//      ascending, so the result does not depend on the order of
//      insertion. With one block on the SM, every warp waits at the next
//      barrier for the slowest warp's selection, so its cost shows in
//      full (PERF.md).
//   3. Masked targets score -FLT_MAX (strictly below every real score,
//      which DGMC's arithmetic entry mask relies on); targets past the
//      segment are never candidates. The carry starts at -inf, below
//      -FLT_MAX, so when k exceeds the valid targets the masked ones fill
//      in index order.
// Small queries would occupy few SMs, so the wrapper cuts the target
// axis into segments (blockIdx.y); each block writes the partial top-k of
// its segment, and merge_lists merges the segments' lists: W warps per
// row each fold a strided share of the lists into a running top-K2
// (K2 = 32, 64 or 128 >= k) held in registers, a bitonic sort of each
// batch of K2 candidates then a bitonic merge; batches that hold nothing
// above the running k-th entry are skipped; warp 0 folds the W partial
// lists. Keys are compared by value, then index, so every path gives the
// same exact top-k. Deterministic: no atomics, fixed summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int TT = 128;        // targets per tile
constexpr int BK = 32;         // channels per ring slot
constexpr int PITCH = BK + 4;  // elements per staged row: 4-element reads
                               // (16 bytes float32, 8 bytes bf16) at an odd
                               // multiple of their size (conflict-free)
constexpr int THREADS = 256;   // 16 x 16
constexpr int K_MAX = 128;     // carry: 8 * TS * k bytes of shared memory
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 0x7fffffff;  // index of an empty carry entry
constexpr int BATCH_MIN = 4;  // a half-warp inserts more candidates (k <= 16)
constexpr int ROW_TILES[] = {16, 32, 64, 128};  // source rows per block
constexpr int N_ROW_TILES = sizeof(ROW_TILES) / sizeof(ROW_TILES[0]);

// Blocks of TS rows per SM that the launch bounds ask for: a 128-row
// block takes the whole register file (255 registers a thread), smaller
// row tiles share an SM two at a time. The wrapper's launch plan reads
// this through dgmc_topk_blocks_per_sm.
constexpr int blocks_per_sm(int ts) { return ts == 128 ? 1 : 2; }
                              // as a sorted batch, fewer one at a time

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

using bf16 = __nv_bfloat16;

// A score as selection sees it: float32 as summed, or rounded to bf16
// (round to nearest even) for bf16 inputs; and the masked targets' score,
// -finfo.max of the input dtype.
__device__ __forceinline__ float as_score(float x, const float*) { return x; }
__device__ __forceinline__ float as_score(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float masked_score(const float*) { return -FLT_MAX; }
__device__ __forceinline__ float masked_score(const bf16*) {
  return -0x1.fep127f;   // -finfo(bfloat16).max
}

// Four consecutive channels from a staged row, widened to float32.
__device__ __forceinline__ float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read4(const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y),
                     __bfloat162float(hi.x), __bfloat162float(hi.y));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(pred ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(pred ? BYTES : 0));
}

// Four elements (vec), or one, from src to staged dst: asynchronous,
// zero-filled where !pred. A single bf16 (2 bytes, below cp.async's
// least) is copied by the thread itself; the ring's barrier orders it.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool pred) {
  cp_async<16>(dst, src, pred);
}
__device__ __forceinline__ void copy4(bf16* dst, const bf16* src, bool pred) {
  cp_async<8>(dst, src, pred);
}
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      bool pred) {
  cp_async<4>(dst, src, pred);
}
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src, bool pred) {
  *dst = pred ? *src : __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until the oldest of the ring's in-flight slots has landed.
__device__ __forceinline__ void cp_wait_ring(int stages) {
  if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy channels [c0, c0 + BK) of rows [r0, r0 + rows) of src (bounded by
// n rows and C channels; the rest zero-filled) into dst [rows][PITCH].
// vec: copies of 4 elements (C % 4 == 0 and rows aligned to 4 elements),
// else of one.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0,
                                      int rows, int n, int C, int c0,
                                      bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      const bool ok = r0 + r < n && c0 + c < C;
      copy4(dst + r * PITCH + c,
            ok ? src + (size_t)(r0 + r) * C + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const bool ok = r0 + r < n && c0 + c < C;
      copy1(dst + r * PITCH + c,
            ok ? src + (size_t)(r0 + r) * C + c0 + c : src, ok);
    }
  }
}

// Candidates of a half-warp (the set bits of `cand` over its 16 lanes).
__device__ __forceinline__ int half_count(unsigned cand) {
  int cnt = __popc(cand);
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) cnt += __shfl_xor_sync(FULL, cnt, d, 16);
  return cnt;
}

// One compare-exchange step of a bitonic network over the 16 lanes of
// each half-warp: pairs (l, l ^ d); the lower lane keeps the better key
// where `desc`, the worse one elsewhere.
__device__ __forceinline__ void cx16(float& v, int& x, int d, bool desc,
                                     int l16) {
  const float ov = __shfl_xor_sync(FULL, v, d, 16);
  const int ox = __shfl_xor_sync(FULL, x, d, 16);
  if (better(ov, ox, v, x) == (((l16 & d) == 0) == desc)) {
    v = ov;
    x = ox;
  }
}

// Fold one tile's scores (acc, rows ty + 16i, targets t0 + tx + 16j) into
// the carry (cv/ci [TS][k], each row sorted by key); see the header, step
// 2. Q = ceil(k / 16) carry entries per lane (1, or 8 for any k <= 128).
// scr: 64 words of scratch per warp. T: the input dtype (its scores and
// masked score, as_score and masked_score).
template <typename T, int TS, int Q>
__device__ __forceinline__ void select_tile(
    const float (&acc)[TS / 16][8], float* cv, int* ci, int* scr, int k,
    int t0, int t_end, const uint8_t* __restrict__ m) {
  constexpr int RM = TS / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, l16 = lane % 16;
  const unsigned hmask = 0xffffu << (lane & 16);
  bool valid[8], masked[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gt = t0 + tx + 16 * j;
    valid[j] = gt < t_end;
    masked[j] = valid[j] && m != nullptr && m[gt] == 0;
  }
  const T* const dtype = nullptr;
  auto score = [&](float x, int j) {
    return !valid[j] ? -INFINITY
                     : (masked[j] ? masked_score(dtype) : as_score(x, dtype));
  };
  // Which of the thread's rows have a candidate anywhere in the warp
  // (warp-uniform); only those are selected, one row at a time.
  unsigned rows = 0;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float thr = cv[(ty + 16 * i) * k + k - 1];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) any |= valid[j] && score(acc[i][j], j) > thr;
    if (__ballot_sync(FULL, any)) rows |= 1u << i;
  }
#pragma unroll 1
  for (int i = 0; i < RM; ++i) {
    if (!((rows >> i) & 1)) continue;
    const int r = ty + 16 * i;
    float s[8];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii)
      if (ii == i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] = score(acc[ii][j], j);
      }
    const float thr = cv[r * k + k - 1];
    unsigned cand = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (valid[j] && s[j] > thr) cand |= 1u << j;
    float ev[Q];
    int ei[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int e = q * 16 + l16;
      ev[q] = e < k ? cv[r * k + e] : -INFINITY;
      ei[q] = e < k ? ci[r * k + e] : NO_INDEX;
    }
    if constexpr (Q == 1) {
      const int cnt = half_count(cand);
      if (__any_sync(FULL, cnt > k)) {
        // The k-th largest of the half-warp's 16 maxima bounds the tile's
        // own k-th largest score from below.
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, s[j]);
        int above = 0;
#pragma unroll
        for (int l = 0; l < 16; ++l)
          above += __shfl_sync(FULL, mx, l, 16) > mx;
        float theta = above < k ? mx : INFINITY;
#pragma unroll
        for (int d = 8; d > 0; d >>= 1)
          theta = fminf(theta, __shfl_xor_sync(FULL, theta, d, 16));
        if (cnt > k) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!(s[j] >= theta)) cand &= ~(1u << j);
        }
      }
    }
    if (Q == 1 && __any_sync(FULL, half_count(cand) > BATCH_MIN)) {
      // Batches of up to 16 candidates, one a lane (in lane order),
      // sorted by a bitonic network and merged into the carry held one
      // entry a lane: the better of each pair (carry descending, batch
      // ascending) is the best 16 of both, then a bitonic merge.
      const int own = __popc(cand);
      int upto = own;
#pragma unroll
      for (int d = 1; d < 16; d <<= 1) {
        const int t = __shfl_up_sync(FULL, upto, d, 16);
        if (l16 >= d) upto += t;
      }
      const int total = __shfl_sync(FULL, upto, 15, 16);
      float* sv = reinterpret_cast<float*>(scr) + (lane & 16);
      int* sx = scr + 32 + (lane & 16);
      for (int base = 0; __any_sync(FULL, base < total); base += 16) {
        unsigned c = cand;
        for (int slot = upto - own; c; ++slot) {
          const int jj = __ffs(c) - 1;
          c &= c - 1;
          if (slot >= base && slot < base + 16) {
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j == jj) v = s[j];
            sv[slot - base] = v;
            sx[slot - base] = t0 + tx + 16 * jj;
          }
        }
        __syncwarp();
        float bv = base + l16 < total ? sv[l16] : -INFINITY;
        int bx = base + l16 < total ? sx[l16] : NO_INDEX;
        __syncwarp();
#pragma unroll
        for (int size = 2; size <= 16; size <<= 1)
#pragma unroll
          for (int d = size / 2; d > 0; d >>= 1)
            cx16(bv, bx, d, (l16 & size) != 0, l16);
        if (better(bv, bx, ev[0], ei[0])) {
          ev[0] = bv;
          ei[0] = bx;
        }
#pragma unroll
        for (int d = 8; d > 0; d >>= 1) cx16(ev[0], ei[0], d, true, l16);
      }
    } else {
      // One candidate at a time (few of them, or k > 16): its position is
      // a ballot count of the entries better than it; those behind it
      // move up a lane.
      for (;;) {
        const unsigned all = __ballot_sync(FULL, cand != 0);
        if (all == 0) break;
        const unsigned mine = all & hmask;
        const int src = mine ? __ffs(mine) - 1 : 0;
        float v = 0.f;
        int idx = 0;
        if (mine && lane == src) {
          const int jj = __ffs(cand) - 1;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j == jj) v = s[j];
          idx = t0 + tx + 16 * jj;
          cand &= cand - 1;
        }
        v = __shfl_sync(FULL, v, src);
        idx = __shfl_sync(FULL, idx, src);
        int p = 0;
#pragma unroll
        for (int q = 0; q < Q; ++q)
          p += __popc(__ballot_sync(FULL, mine && q * 16 + l16 < k &&
                                              better(ev[q], ei[q], v, idx)) &
                      hmask);
        float up_v[Q], last_v[Q];
        int up_i[Q], last_i[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          up_v[q] = __shfl_up_sync(FULL, ev[q], 1, 16);
          up_i[q] = __shfl_up_sync(FULL, ei[q], 1, 16);
          last_v[q] = __shfl_sync(FULL, ev[q], 15, 16);
          last_i[q] = __shfl_sync(FULL, ei[q], 15, 16);
        }
        if (mine && p < k) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int e = q * 16 + l16;
            if (e == p) {
              ev[q] = v;
              ei[q] = idx;
            } else if (e > p) {
              ev[q] = l16 ? up_v[q] : (q ? last_v[q - 1] : ev[q]);
              ei[q] = l16 ? up_i[q] : (q ? last_i[q - 1] : ei[q]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int e = q * 16 + l16;
      if (e < k) {
        cv[r * k + e] = ev[q];
        ci[r * k + e] = ei[q];
      }
    }
    __syncwarp();
  }
}

template <typename T, int TS, int Q>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(TS))
topk_tiles(const T* __restrict__ h_s, const T* __restrict__ h_t,
           const uint8_t* __restrict__ t_mask, float* __restrict__ out_v,
           int* __restrict__ out_i, int N_s, int N_t, int C, int k,
           int nseg, int tiles_per_seg, int stages, bool vec) {
  constexpr int RM = TS / 16;
  constexpr bool WIDEN = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  T* As = reinterpret_cast<T*>(smem);        // [stages][TS][PITCH]
  T* Bs = As + stages * TS * PITCH;          // [stages][TT][PITCH]
  // bf16: the landed slot widened, [TS + TT][PITCH] (the ring's bytes are
  // a multiple of 16)
  float* wide = reinterpret_cast<float*>(Bs + stages * TT * PITCH);
  float* cv = wide + (WIDEN ? (TS + TT) * PITCH : 0);  // [TS][k] carry
  int* ci = reinterpret_cast<int*>(cv + k * TS);  // [TS][k] carry indices
  int* scr = ci + k * TS + threadIdx.x / 32 * 64;  // selection scratch

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * TS;
  const int seg = blockIdx.y;
  const int b = blockIdx.z;
  const T* hs = h_s + (size_t)b * N_s * C;
  const T* ht = h_t + (size_t)b * N_t * C;
  const uint8_t* m = t_mask ? t_mask + (size_t)b * N_t : nullptr;

  for (int e = threadIdx.x; e < k * TS; e += THREADS) {
    cv[e] = -INFINITY;
    ci[e] = NO_INDEX;
  }

  const int t_begin = seg * tiles_per_seg * TT;
  const int t_end = min(N_t, t_begin + tiles_per_seg * TT);
  const int nk = (C + BK - 1) / BK;             // ring slots per tile
  const int steps = (t_end - t_begin + TT - 1) / TT * nk;

  auto load = [&](int g) {
    const int slot = g % stages;
    const int t0 = t_begin + g / nk * TT, c0 = g % nk * BK;
    stage(As + slot * TS * PITCH, hs, row0, TS, N_s, C, c0, vec);
    stage(Bs + slot * TT * PITCH, ht, t0, TT, t_end, C, c0, vec);
  };
  for (int g = 0; g < stages - 1; ++g) {
    if (g < steps) load(g);
    cp_commit();
  }

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < steps; ++g) {
    cp_wait_ring(stages);
    __syncthreads();  // slot g landed for all; slot g - 1 free to refill
    if (g + stages - 1 < steps) load(g + stages - 1);
    cp_commit();
    const T* a_s = As + (g % stages) * TS * PITCH;
    const T* b_s = Bs + (g % stages) * TT * PITCH;
    const float* a_f;
    const float* b_f;
    if constexpr (WIDEN) {
      // Every thread is past the product that read `wide` last slot.
      for (int e = threadIdx.x; e < (TS + TT) * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), c = e % (BK / 4) * 4;
        *reinterpret_cast<float4*>(wide + r * PITCH + c) =
            read4(r < TS ? a_s + r * PITCH + c : b_s + (r - TS) * PITCH + c);
      }
      __syncthreads();
      a_f = wide;
      b_f = wide + TS * PITCH;
    } else {
      a_f = a_s;
      b_f = b_s;
    }
#pragma unroll
    for (int c = 0; c < BK; c += 4) {
      float4 bq[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bq[j] = read4(b_f + (tx + 16 * j) * PITCH + c);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = read4(a_f + (ty + 16 * i) * PITCH + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, bq[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, bq[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, bq[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, bq[j].w, acc[i][j]);
        }
      }
    }
    if (g % nk == nk - 1) {
      select_tile<T, TS, Q>(acc, cv, ci, scr, k, t_begin + g / nk * TT,
                            t_end, m);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }
  __syncthreads();

  // out layout: [B * N_s][nseg][k] (with one segment, [B, N_s, k]).
  for (int e = threadIdx.x; e < TS * k; e += THREADS) {
    const int r = e / k, j = e % k;
    const int gr = row0 + r;
    if (gr < N_s) {
      const size_t o = (((size_t)b * N_s + gr) * nseg + seg) * k + j;
      out_v[o] = cv[r * k + j];
      out_i[o] = ci[r * k + j];
    }
  }
}

// One step of a bitonic network over K2 = 32 * P keys held by a warp,
// element e = q * 32 + lane: pairs (e, e ^ d); the lower element of a
// pair keeps the better key where `desc(e)`, the worse one elsewhere.
template <int P, typename F>
__device__ __forceinline__ void bitonic_step(float (&v)[P], int (&x)[P],
                                             int d, F desc) {
  const int lane = threadIdx.x % 32;
  if (d < 32) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float ov = __shfl_xor_sync(FULL, v[q], d);
      const int ox = __shfl_xor_sync(FULL, x[q], d);
      const int e = q * 32 + lane;
      const bool lower = (e & d) == 0;
      const bool keep_better = lower == desc(e);
      if (better(ov, ox, v[q], x[q]) == keep_better) {
        v[q] = ov;
        x[q] = ox;
      }
    }
  } else {
    const int dq = d / 32;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int q2 = q ^ dq;
      if (q2 > q) {
        const bool b = better(v[q2], x[q2], v[q], x[q]);
        if (b == desc(q * 32 + lane)) {
          const float tv = v[q];
          const int ti = x[q];
          v[q] = v[q2];
          x[q] = x[q2];
          v[q2] = tv;
          x[q2] = ti;
        }
      }
    }
  }
}

// Fold a batch of K2 candidates (bv, bx) into the running list (rv, rx,
// sorted by key, best first) of one warp: afterwards rv holds the best K2
// of both, sorted. Candidates not better than the running k-th are
// dropped first; a batch with none left is skipped.
template <int P>
__device__ __forceinline__ void fold(float (&rv)[P], int (&rx)[P],
                                     float (&bv)[P], int (&bx)[P], int k) {
  constexpr int K2 = 32 * P;
  const int qk = (k - 1) / 32;
  float kv = 0.f;
  int kx = 0;
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (q == qk) {
      kv = rv[q];
      kx = rx[q];
    }
  kv = __shfl_sync(FULL, kv, (k - 1) % 32);
  kx = __shfl_sync(FULL, kx, (k - 1) % 32);
  bool any = false;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (!better(bv[q], bx[q], kv, kx)) {
      bv[q] = -INFINITY;
      bx[q] = NO_INDEX;
    } else {
      any = true;
    }
  }
  if (!__any_sync(FULL, any)) return;
  // Sort the batch ascending (worst first).
  for (int size = 2; size <= K2; size <<= 1)
    for (int d = size / 2; d > 0; d >>= 1)
      bitonic_step<P>(bv, bx, d, [&](int e) { return (e & size) != 0; });
  // Best of each pair (descending running list against ascending batch):
  // the best K2 of both, as a bitonic sequence.
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (better(bv[q], bx[q], rv[q], rx[q])) {
      rv[q] = bv[q];
      rx[q] = bx[q];
    }
  for (int d = K2 / 2; d > 0; d >>= 1)
    bitonic_step<P>(rv, rx, d, [](int) { return true; });
}

// rows x nseg sorted lists of k (part_v/part_i [rows][nseg][k]) → the
// top k of each row's nseg * k candidates (out [rows][k]). A block holds
// blockDim.x / 32 / W rows, W warps each.
template <int P>
__global__ void merge_lists(const float* __restrict__ part_v,
                            const int* __restrict__ part_i,
                            float* __restrict__ out_v,
                            int* __restrict__ out_i, int rows, int k,
                            int nseg, int W) {
  constexpr int K2 = 32 * P;
  __shared__ float sv[THREADS / 32][K2];
  __shared__ int sx[THREADS / 32][K2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp % W;
  const int row = blockIdx.x * (blockDim.x / 32 / W) + warp / W;
  const bool live = row < rows;
  const int n = nseg * k;
  const float* pv = part_v + (size_t)row * n;
  const int* pi = part_i + (size_t)row * n;

  float rv[P], bv[P];
  int rx[P], bx[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    rv[q] = -INFINITY;
    rx[q] = NO_INDEX;
  }
  if (live) {
    for (int base = w * K2; base < n; base += W * K2) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int e = base + q * 32 + lane;
        bv[q] = e < n ? pv[e] : -INFINITY;
        bx[q] = e < n ? pi[e] : NO_INDEX;
      }
      fold<P>(rv, rx, bv, bx, k);
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    sv[warp][q * 32 + lane] = rv[q];
    sx[warp][q * 32 + lane] = rx[q];
  }
  __syncthreads();
  if (!live || w != 0) return;
  for (int u = 1; u < W; ++u) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      bv[q] = sv[warp + u][q * 32 + lane];
      bx[q] = sx[warp + u][q * 32 + lane];
    }
    fold<P>(rv, rx, bv, bx, k);
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int e = q * 32 + lane;
    if (e < k) {
      out_v[(size_t)row * k + e] = rv[q];
      out_i[(size_t)row * k + e] = rx[q];
    }
  }
}

template <typename T, int TS, int Q>
int launch_tiles(const T* h_s, const T* h_t, const uint8_t* t_mask,
                 float* tv, int* ti, int B, int N_s, int N_t, int C, int k,
                 int nseg, int tiles_per_seg, bool vec, cudaStream_t st) {
  const size_t carry = (sizeof(float) + sizeof(int)) * (size_t)k * TS +
                       sizeof(int) * 2 * THREADS;     // + selection scratch
  const size_t slot = sizeof(T) * (TS + TT) * PITCH;
  const size_t wide = std::is_same<T, float>::value
                          ? 0 : sizeof(float) * (TS + TT) * PITCH;
  const int stages = carry + wide + 3 * slot <= SMEM_MAX ? 3 : 2;
  const size_t smem = carry + wide + stages * slot;
  cudaError_t err = cudaFuncSetAttribute(
      topk_tiles<T, TS, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N_s + TS - 1) / TS, nseg, B);
  topk_tiles<T, TS, Q><<<grid, THREADS, smem, st>>>(
      h_s, h_t, t_mask, tv, ti, N_s, N_t, C, k, nseg, tiles_per_seg, stages,
      vec);
  return (int)cudaGetLastError();
}

template <typename T, int TS>
int launch_tiles(const T* h_s, const T* h_t, const uint8_t* t_mask,
                 float* tv, int* ti, int B, int N_s, int N_t, int C, int k,
                 int nseg, int tiles_per_seg, bool vec, cudaStream_t st) {
  return k <= 16
             ? launch_tiles<T, TS, 1>(h_s, h_t, t_mask, tv, ti, B, N_s, N_t,
                                      C, k, nseg, tiles_per_seg, vec, st)
             : launch_tiles<T, TS, K_MAX / 16>(h_s, h_t, t_mask, tv, ti, B,
                                               N_s, N_t, C, k, nseg,
                                               tiles_per_seg, vec, st);
}

template <int P>
int launch_merge(const float* part_v, const int* part_i, float* out_v,
                 int* out_i, int rows, int k, int nseg, cudaStream_t st) {
  constexpr int K2 = 32 * P;
  const int batches = (nseg * k + K2 - 1) / K2;
  const int W = batches >= 16 ? 8 : batches >= 4 ? 4 : batches >= 2 ? 2 : 1;
  const int per_block = THREADS / 32 / W;
  merge_lists<P><<<(rows + per_block - 1) / per_block, THREADS, 0, st>>>(
      part_v, part_i, out_v, out_i, rows, k, nseg, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* h_s, const T* h_t, const uint8_t* t_mask,
           float* part_v, int* part_i, float* out_v, int* out_i, int B,
           int N_s, int N_t, int C, int k, int ts, int nseg,
           int tiles_per_seg, cudaStream_t st) {
  const bool vec = C % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(h_s) |
                     reinterpret_cast<uintptr_t>(h_t)) % (4 * sizeof(T))) ==
                       0;
  float* tv = nseg > 1 ? part_v : out_v;
  int* ti = nseg > 1 ? part_i : out_i;
  int err;
  switch (ts) {
    case 16:
      err = launch_tiles<T, 16>(h_s, h_t, t_mask, tv, ti, B, N_s, N_t,
                                C, k, nseg, tiles_per_seg, vec, st);
      break;
    case 32:
      err = launch_tiles<T, 32>(h_s, h_t, t_mask, tv, ti, B, N_s, N_t,
                                C, k, nseg, tiles_per_seg, vec, st);
      break;
    case 64:
      err = launch_tiles<T, 64>(h_s, h_t, t_mask, tv, ti, B, N_s, N_t,
                                C, k, nseg, tiles_per_seg, vec, st);
      break;
    default:
      err = launch_tiles<T, 128>(h_s, h_t, t_mask, tv, ti, B, N_s, N_t,
                                 C, k, nseg, tiles_per_seg, vec, st);
  }
  if (err != cudaSuccess || nseg == 1) return err;
  const int rows = B * N_s;
  if (k <= 32)
    return launch_merge<1>(part_v, part_i, out_v, out_i, rows, k, nseg, st);
  if (k <= 64)
    return launch_merge<2>(part_v, part_i, out_v, out_i, rows, k, nseg, st);
  return launch_merge<4>(part_v, part_i, out_v, out_i, rows, k, nseg, st);
}

template <typename T>
int topk_entry(const T* h_s, const T* h_t, const uint8_t* t_mask,
               float* part_v, int* part_i, float* out_v, int* out_i, int B,
               int N_s, int N_t, int C, int k, int ts, int nseg,
               int tiles_per_seg, int device, void* stream) {
  if (k < 1 || k > K_MAX || k > N_t || B < 1 || N_s < 1 || C < 1 ||
      (ts != 16 && ts != 32 && ts != 64 && ts != 128) || nseg < 1 ||
      tiles_per_seg < 1 || (long long)nseg * tiles_per_seg * TT < N_t ||
      (long long)(nseg - 1) * tiles_per_seg * TT >= N_t)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    return launch<T>(h_s, h_t, t_mask, part_v, part_i, out_v, out_i, B, N_s,
                     N_t, C, k, ts, nseg, tiles_per_seg,
                     reinterpret_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

int dgmc_topk_k_max() { return K_MAX; }
int dgmc_topk_targets_per_tile() { return TT; }
// The i-th row tile the kernel is built for (ascending), 0 past the last.
int dgmc_topk_row_tile(int i) {
  return i >= 0 && i < N_ROW_TILES ? ROW_TILES[i] : 0;
}
int dgmc_topk_blocks_per_sm(int ts) { return blocks_per_sm(ts); }

// h_s [B, N_s, C], h_t [B, N_t, C] contiguous, float32 (dgmc_topk_f32) or
// bfloat16 (dgmc_topk_bf16); t_mask [B, N_t] uint8, or null for no mask.
// Outputs out_v [B, N_s, k] float32 (for bf16 inputs, values that bf16
// holds exactly) and out_i [B, N_s, k] int32. ts (16, 32, 64 or 128)
// source rows per block; the target axis is cut into nseg segments of
// tiles_per_seg tiles of TT, none empty; with nseg > 1, part_v / part_i
// hold [B * N_s, nseg, k] float32 / int32 scratch. Launches on `stream` on
// `device`, does not synchronize, restores the calling thread's current
// device, returns cudaGetLastError().
int dgmc_topk_f32(const float* h_s, const float* h_t, const uint8_t* t_mask,
                  float* part_v, int* part_i, float* out_v, int* out_i,
                  int B, int N_s, int N_t, int C, int k, int ts, int nseg,
                  int tiles_per_seg, int device, void* stream) {
  return topk_entry(h_s, h_t, t_mask, part_v, part_i, out_v, out_i, B, N_s,
                    N_t, C, k, ts, nseg, tiles_per_seg, device, stream);
}

int dgmc_topk_bf16(const void* h_s, const void* h_t, const uint8_t* t_mask,
                   float* part_v, int* part_i, float* out_v, int* out_i,
                   int B, int N_s, int N_t, int C, int k, int ts, int nseg,
                   int tiles_per_seg, int device, void* stream) {
  return topk_entry(static_cast<const bf16*>(h_s),
                    static_cast<const bf16*>(h_t), t_mask, part_v, part_i,
                    out_v, out_i, B, N_s, N_t, C, k, ts, nseg, tiles_per_seg,
                    device, stream);
}

}  // extern "C"
