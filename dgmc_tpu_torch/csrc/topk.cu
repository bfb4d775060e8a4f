// Streaming exact top-k of h_s @ h_t^T for Hopper (sm_90a), float32 or
// bfloat16 inputs.
//
// Replaces dgmc_tpu/ops/pallas/topk.py::_kernel (the Pallas TPU kernel
// behind pallas_topk). For each source row it returns the k largest inner
// products with the target rows, sorted by value descending with the
// lowest target index first among equal values (the lax.top_k rule), and
// never materializes the N_s x N_t score matrix.
//
// bf16 inputs (the precision policy's variant): products and sums in
// float32, then each score rounded to bf16 (round to nearest even) and
// carried in float32, masked targets at -finfo(bf16).max, as the TPU
// kernel does (its scores round through the input dtype); the wrapper
// returns the values in bf16. Two entries:
//   - dgmc_topk_bf16_tc, the tensor-core tile (the main path's: the
//     wrapper's route sends it every shape with C % 8 == 0, C <= 640 and
//     k <= 16; "Tensor-core tile" below);
//   - dgmc_topk_bf16, the FMA tiles below for the other shapes: the ring
//     stages bf16 rows as they are and widens each landed slot once into
//     a float32 slot that the product reads as for float32 inputs.
//
// Bounds on the H100: 2*N_s*N_t*C FLOPs, with device-memory traffic of
// h_s + h_t + t_mask + out, each read or written once. The float32 entry
// and the bf16 FMA entry run at the card's float32 rate outside the
// tensor cores (67 TFLOP/s; the port's float32 contract keeps TF32 off):
// at the DBP15K shape (15000 x 20000, C = 256, k = 10), 153.6 GFLOP
// against ~36 MB, 2.29 ms, bound by operations. The tensor-core entry
// runs at the bf16 peak (989 TFLOP/s): 0.155 ms at that shape, still
// bound by operations (~18 MB in bf16). A 16-64-row query against the
// same table is bound by the read of h_t instead.
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
//
// Tensor-core tile (dgmc_topk_bf16_tc). The FMA entry held bf16 inputs to
// the float32 rate (6.7 ms at the DBP15K shape on the H100, above the
// float32 kernel on the same values): every product ran on FMAs after a
// widening pass. Here the product runs on wgmma and selection reads the
// accumulators where they land:
//   1. A block owns 128 source rows (two consumer warpgroups of 64) and
//      loops over the 128-target tiles of its segment. A producer warp
//      loads by TMA (3D boxes of 64 channels x 128 rows of one batch,
//      128-byte swizzled, zero-filled past N and C, so a ragged C, N_s or
//      N_t needs no code): the block's h_s stripe once (C <= 640: at most
//      160 KB, resident for all its tiles), then each tile's h_t in
//      64-channel chunks through a ring of 4 slots of 16 KB on mbarriers
//      (full: the TMA's bytes; empty: one arrival a consumer warp).
//   2. Each warpgroup multiplies its 64 rows by the tile with
//      wgmma.m64n128k16 (bf16 operands, K-major from shared memory, f32
//      accumulators: 64 a thread), 4 a chunk, and releases the slot.
//   3. Selection from the accumulators: in wgmma's layout a thread holds
//      32 scores of each of 2 rows, a row's 128 in the 4 lanes of a quad.
//      Each row's carry (its best 16, sorted by key) sits in registers,
//      the same in the quad's 4 lanes. A thread rounds the maximum of its
//      32 scores (rounding is monotone) and compares it with the row's
//      k-th carried value: once the first tiles have passed that is the
//      whole cost of a tile. Only scores strictly above the k-th are
//      candidates (the tile's indices all follow the carried ones); a
//      masked target (looked up only for candidates) scores -bf16 max;
//      where a quad has more than k, the k-th largest of its 16 group
//      maxima (8 targets a group) drops the scores below it; the rest
//      enter one a round, broadcast from their lane and inserted by a
//      compare-and-swap pass down the carry. Keys order by value
//      descending, then index ascending, so the result does not depend
//      on the order of insertion.
// Segments and their merge are the FMA path's (merge_lists); one block an
// SM (288 threads may take the whole register file); no atomics, so
// repeats are bit-identical.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// bf16 inputs on the tensor cores (dgmc_topk_bf16_tc); see the header.
namespace tc {

constexpr int ROWS = 128;             // source rows a block: 2 warpgroups
constexpr int TGT = 128;              // targets a tile: wgmma's N
constexpr int KC = 64;                // channels a chunk: one 128-byte row
constexpr int CHUNK = 128 * KC * 2;   // bytes of a chunk of 128 rows
constexpr int STAGES = 4;             // h_t chunks in flight
constexpr int C_MAX = 640;            // the resident h_s stripe: 10 chunks
constexpr int K_CAP = 16;             // carry entries a row, in registers
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int ALIGN = 1024;           // the 128-byte swizzle's period
constexpr float NEG = -0x1.fep127f;   // -finfo(bfloat16).max

constexpr size_t smem_bytes(int C) {
  return ALIGN + (size_t)((C + KC - 1) / KC + STAGES) * CHUNK +
         8 * (2 * STAGES + 1);
}

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of {64 channels, 128 rows, 1 batch} from `map` into shared dst
// (128-byte swizzled), completing on `bar`; rows and channels past the
// tensor's edge land as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(row), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Orders the accumulators' ordinary reads and writes against the
// asynchronous wgmma (the compiler sees them as written here).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] B[128 x 16]^T, both K-major bf16 in shared memory,
// f32 accumulators; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The thread's u-th score of its row I (u < 32: target 8(u/2) + 2q + u%2
// of the tile, q = lane % 4; wgmma's accumulator layout), as summed.
template <int I>
__device__ __forceinline__ float at(const float (&acc)[64], int u) {
  return acc[4 * (u >> 1) + 2 * I + (u & 1)];
}

// The thread's u-th score of its row i (0 or 1 at run time).
__device__ __forceinline__ float at(const float (&acc)[64], int i, int u) {
  return i ? at<1>(acc, u) : at<0>(acc, u);
}

// at() with a runtime u: a tree of selects, no local memory.
__device__ __forceinline__ float pick(const float (&acc)[64], int i, int u) {
  float s[32];
#pragma unroll
  for (int h = 0; h < 32; ++h) s[h] = at(acc, i, h);
  // Constant trip counts: a loop on w >>= 1 is not unrolled, and an
  // array it indexes would live in local memory.
#pragma unroll
  for (int lvl = 0; lvl < 5; ++lvl)
#pragma unroll
    for (int h = 0; h < 16; ++h)
      if (h < 16 >> lvl) s[h] = (u & 16 >> lvl) ? s[h + (16 >> lvl)] : s[h];
  return s[0];
}

__device__ __forceinline__ int target_of(int t0, int q, int u) {
  return t0 + 8 * (u >> 1) + 2 * q + (u & 1);
}

// A row's carry, spread over the 4 lanes of its quad: entry e (its best
// K_CAP, sorted by key) in lane e % 4, slot e / 4.
constexpr int SLOTS = K_CAP / 4;

// Insert (v, x) (the same in the quad's 4 lanes) into the quad's carry,
// keeping the best K_CAP: its place p is the count of entries better than
// it; the entries from p on move one place down (from the lane before, the
// last lane's wrapping into the next slot). Every lane of the warp calls
// this; quads that are not `active` keep their carry.
__device__ __forceinline__ void insert(float (&cv)[SLOTS], int (&cx)[SLOTS],
                                       float v, int x, bool active) {
  const int lane = threadIdx.x % 32, q = lane & 3, quad = lane & ~3;
  int p = 0;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) p += better(cv[j], cx[j], v, x);
  p += __shfl_xor_sync(FULL, p, 1);
  p += __shfl_xor_sync(FULL, p, 2);
  float up_v[SLOTS];
  int up_x[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    up_v[j] = __shfl_sync(FULL, cv[j], quad | ((q + 3) & 3));
    up_x[j] = __shfl_sync(FULL, cx[j], quad | ((q + 3) & 3));
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int e = 4 * j + q;
    if (e == p) {
      cv[j] = v;
      cx[j] = x;
    } else if (e > p) {   // e >= 1: the entry before it
      cv[j] = q ? up_v[j] : up_v[j > 0 ? j - 1 : 0];
      cx[j] = q ? up_x[j] : up_x[j > 0 ? j - 1 : 0];
    }
  }
}

// Entry e of the quad's carry (e < K_CAP), in every lane of the quad.
__device__ __forceinline__ float entry(const float (&cv)[SLOTS], int e) {
  float t = cv[0];
#pragma unroll
  for (int j = 1; j < SLOTS; ++j)
    if (e >> 2 == j) t = cv[j];
  return __shfl_sync(FULL, t, (threadIdx.x % 32 & ~3) | (e & 3));
}

// The least float32 whose bf16 rounding lies above thr (a bf16 value or
// -inf): the scores x that round above thr are exactly x >= bound(thr),
// so the hot path compares sums as they land, unrounded. Round to nearest
// even sends the midpoint between thr and the next bf16 up to whichever
// of the two is even (their last bits differ); above +inf, or at NaN, the
// bound is NaN and nothing compares above it.
__device__ __forceinline__ float bound(float thr) {
  if (thr == -INFINITY) return -INFINITY;
  const uint32_t u = __float_as_uint(thr == 0.f ? 0.f : thr);  // -0 as +0
  const bool neg = u >> 31;
  const uint32_t mid = neg ? u - 0x8000u : u + 0x8000u;
  // An odd thr: the midpoint rounds up, away from it; an even one: the
  // next float above the midpoint is the least that does.
  return __uint_as_float((u >> 16) & 1 ? mid : (neg ? mid - 1 : mid + 1));
}

// Maximum of the thread's 32 sums of its row I, as a tree.
template <int I>
__device__ __forceinline__ float row_max(const float (&acc)[64]) {
  float t[16];
#pragma unroll
  for (int h = 0; h < 16; ++h) t[h] = fmaxf(at<I>(acc, h), at<I>(acc, h + 16));
#pragma unroll
  for (int lvl = 0; lvl < 4; ++lvl)
#pragma unroll
    for (int h = 0; h < 8; ++h)
      if (h < 8 >> lvl) t[h] = fmaxf(t[h], t[h + (8 >> lvl)]);
  return t[0];
}

// The rare parts of selection stay out of line, so that the code a tile
// runs fits the instruction cache.

// The bits u of a thread's 32 targets that lie before t_end.
__device__ __noinline__ unsigned valid_bits(int t0, int t_end, int q) {
  unsigned bits = 0;
  for (int u = 0; u < 32; ++u)
    if (target_of(t0, q, u) < t_end) bits |= 1u << u;
  return bits;
}

// The bits u of a thread's 32 targets (before t_end) that m masks.
__device__ __noinline__ unsigned masked_bits(const uint8_t* m, int t0,
                                             int t_end, int q) {
  unsigned bits = 0;
  for (int u = 0; u < 32; ++u) {
    const int gt = target_of(t0, q, u);
    if (gt < t_end && m[gt] == 0) bits |= 1u << u;
  }
  return bits;
}

// The k-th largest of the quad's 16 values g (4 a lane), in every lane;
// every lane of the warp calls it.
__device__ __noinline__ float kth_of_quad(float g0, float g1, float g2,
                                          float g3, int k) {
  const int quad = threadIdx.x % 32 & ~3;
  const float own[4] = {g0, g1, g2, g3};
  float all[16];
#pragma unroll
  for (int src = 0; src < 4; ++src)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      all[4 * src + g] = __shfl_sync(FULL, own[g], quad | src);
  float theta = INFINITY;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    int above = 0;
#pragma unroll
    for (int h = 0; h < 16; ++h) above += all[h] > own[g];
    if (above < k) theta = fminf(theta, own[g]);
  }
  theta = fminf(theta, __shfl_xor_sync(FULL, theta, 1));
  return fminf(theta, __shfl_xor_sync(FULL, theta, 2));
}

// Fold the tile's scores of the thread's row i (hot in the warp: some
// lane's maximum reached lo = bound(thr)) into its quad's carry (cv, cx;
// thr its k-th value). pre: this lane's maximum did. valid: the bits u
// whose target lies before t_end; mk: those masked (loaded once a tile,
// at the first candidate). Every lane of the warp calls it.
__device__ __forceinline__ void select_row(
    const float (&acc)[64], int i, bool pre, float (&cv)[SLOTS],
    int (&cx)[SLOTS], float& thr, float& lo, int k, int t0, int t_end,
    unsigned valid, const uint8_t* __restrict__ m, unsigned& mk,
    bool& mk_loaded) {
  const int lane = threadIdx.x % 32, q = lane & 3, quad = lane & ~3;
  unsigned cand = 0;
  if (pre) {
#pragma unroll
    for (int u = 0; u < 32; ++u)
      cand |= (unsigned)(at(acc, i, u) >= lo) << u;
    cand &= valid;
    if (cand && m != nullptr) {
      if (!mk_loaded) {
        mk = masked_bits(m, t0, t_end, q);
        mk_loaded = true;
      }
      // A masked target scores NEG: a candidate only while the carry is
      // not full (thr = -inf).
      if (!(NEG > thr)) cand &= ~mk;
    }
  }
  // A quad with more than k candidates has a lane with more than k / 4.
  if (__any_sync(FULL, 4 * __popc(cand) > k)) {
    int cnt = __popc(cand);
    cnt += __shfl_xor_sync(FULL, cnt, 1);
    cnt += __shfl_xor_sync(FULL, cnt, 2);
    // More candidates than k (the first tiles): the k-th largest of the
    // quad's 16 group maxima (8 targets a group) bounds the tile's own
    // k-th largest from below; scores under it cannot reach the top k.
    float gm[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float x = -INFINITY;
      bool masked = false;
#pragma unroll
      for (int u = 8 * g; u < 8 * g + 8; ++u)
        if ((cand >> u) & 1) {
          if ((mk >> u) & 1)
            masked = true;
          else
            x = fmaxf(x, at(acc, i, u));
        }
      // Rounding is monotone: the rounded maximum is the maximum rounded.
      gm[g] = fmaxf(x == -INFINITY ? x : rnd(x), masked ? NEG : -INFINITY);
    }
    const float theta = kth_of_quad(gm[0], gm[1], gm[2], gm[3], k);
    if (cnt > k) {
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (!((((mk >> u) & 1) ? NEG : rnd(at(acc, i, u))) >= theta))
          cand &= ~(1u << u);
    }
  }
  // One candidate of each quad a round: the quad's lowest lane with one
  // left hands its lowest to the four lanes, which insert it.
  unsigned has = __ballot_sync(FULL, cand != 0);
  if (!has) return;
  do {
    const unsigned qm = (has >> quad) & 0xFu;
    const int src = qm ? __ffs(qm) - 1 : 0;
    float v = 0.f;
    int x = 0;
    if (qm && q == src) {
      const int u = __ffs(cand) - 1;
      cand &= cand - 1;
      v = ((mk >> u) & 1) ? NEG : rnd(pick(acc, i, u));
      x = target_of(t0, q, u);
    }
    v = __shfl_sync(FULL, v, quad | src);
    x = __shfl_sync(FULL, x, quad | src);
    insert(cv, cx, v, x, qm != 0);
    has = __ballot_sync(FULL, cand != 0);
  } while (has);
  thr = entry(cv, k - 1);
  lo = bound(thr);
}

// out[j] = the sum of a[c] b_j[c] over c < C (C % 8 == 0, 16-byte
// aligned rows), each by float32 FMAs in channel order: the FMA kernels'
// summation, which is also that of cuBLAS's float32 product on the plain
// side. The SLOTS sums run side by side (one read of a).
__device__ __forceinline__ void dots_in_order(const bf16* a,
                                              const bf16* const (&b)[SLOTS],
                                              int C, float (&out)[SLOTS]) {
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) out[j] = 0.f;
  for (int c = 0; c < C; c += 8) {
    const uint4 qa = *reinterpret_cast<const uint4*>(a + c);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&qa);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const uint4 qb = *reinterpret_cast<const uint4*>(b[j] + c);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&qb);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        out[j] = fmaf(__bfloat162float(pa[h].x), __bfloat162float(pb[h].x),
                      out[j]);
        out[j] = fmaf(__bfloat162float(pa[h].y), __bfloat162float(pb[h].y),
                      out[j]);
      }
    }
  }
}

// Block: 128 source rows (blockIdx.x) of batch blockIdx.z against the
// target tiles of segment blockIdx.y. Warps 0-7 (two warpgroups, 64 rows
// each) multiply and select; warp 8 loads.
__global__ void __launch_bounds__(THREADS, 1)
topk_tc(const __grid_constant__ CUtensorMap map_s,
        const __grid_constant__ CUtensorMap map_t,
        const bf16* __restrict__ h_s, const bf16* __restrict__ h_t,
        const uint8_t* __restrict__ t_mask, float* __restrict__ out_v,
        int* __restrict__ out_i, int N_s, int N_t, int C, int k, int nseg,
        int tiles_per_seg) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + ALIGN -
       1) & ~(uint32_t)(ALIGN - 1);
  const int nk = (C + KC - 1) / KC;
  const uint32_t hs = base;                     // [nk][128 rows][64]
  const uint32_t ring = hs + nk * CHUNK;        // [STAGES][128 targets][64]
  const uint32_t full = ring + STAGES * CHUNK;  // mbarriers [STAGES]
  const uint32_t empty = full + 8 * STAGES;     // [STAGES]
  const uint32_t hs_bar = empty + 8 * STAGES;

  const int row0 = blockIdx.x * ROWS, seg = blockIdx.y, b = blockIdx.z;
  const int t_begin = seg * tiles_per_seg * TGT;
  const int t_end = min(N_t, t_begin + tiles_per_seg * TGT);
  const int ntiles = (t_end - t_begin + TGT - 1) / TGT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    mbar_init(hs_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // Producer: the block's h_s stripe once, then the h_t chunks in
    // order, each into the ring slot its consumers have released.
    if (lane == 0) {
      mbar_expect(hs_bar, nk * CHUNK);
      for (int c = 0; c < nk; ++c)
        tma_load(hs + c * CHUNK, &map_s, c * KC, row0, b, hs_bar);
      const int steps = ntiles * nk;
      for (int g = 0; g < steps; ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty + 8 * s, ((g / STAGES) - 1) & 1);
        mbar_expect(full + 8 * s, CHUNK);
        tma_load(ring + s * CHUNK, &map_t, (g % nk) * KC,
                 t_begin + (g / nk) * TGT, b, full + 8 * s);
      }
    }
    return;
  }

  // Consumers. Warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of the
  // stripe; thread (warp w, lane l) holds rows 16 (w % 4) + l / 4 (+ 8)
  // of them, 32 targets of each row a tile.
  const int wg = warp / 4, q = lane & 3, quad = lane & ~3;
  const int r0 = row0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const uint8_t* m = t_mask ? t_mask + (size_t)b * N_t : nullptr;
  float cv[2][SLOTS];
  int cx[2][SLOTS];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      cv[i][j] = -INFINITY;
      cx[i][j] = NO_INDEX;
    }
  float thr[2] = {-INFINITY, -INFINITY};
  float lo[2] = {-INFINITY, -INFINITY};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const uint32_t a_base = hs + wg * 64 * (KC * 2);
  mbar_wait(hs_bar, 0);
  for (int j = 0; j < ntiles; ++j) {
    // One chunk's wgmma group in flight behind the next: a slot is
    // released once the group that read it has completed.
    for (int c = 0; c < nk; ++c) {
      const int g = j * nk + c, s = g % STAGES;
      mbar_wait(full + 8 * s, (g / STAGES) & 1);
      __syncwarp();
      fence_acc(acc);
      wgmma_fence();
      const uint32_t a = a_base + c * CHUNK, bt = ring + s * CHUNK;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_128(acc, sw128(a + 32 * kk), sw128(bt + 32 * kk), c | kk);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait1();
        if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
      }
    }
    wgmma_wait0();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((j * nk + nk - 1) % STAGES));
    // Selection: a tile costs each thread the maxima of its two rows'
    // 32 sums, unless some lane of the warp has a candidate.
    const bool pre0 = row_max<0>(acc) >= lo[0];
    const bool pre1 = row_max<1>(acc) >= lo[1];
    const unsigned hot = (__any_sync(FULL, pre0) ? 1u : 0u) |
                         (__any_sync(FULL, pre1) ? 2u : 0u);
    if (hot) {
      const int t0 = t_begin + j * TGT;
      const unsigned valid =
          t0 + TGT > t_end ? valid_bits(t0, t_end, q) : ~0u;
      unsigned mk = 0;
      bool mk_loaded = false;
      // One copy of the code for both rows: their carries pass through
      // selects, not local memory.
#pragma unroll 1
      for (int i = 0; i < 2; ++i) {
        if (!((hot >> i) & 1)) continue;
        float rv[SLOTS];
        int rx[SLOTS];
#pragma unroll
        for (int e = 0; e < SLOTS; ++e) {
          rv[e] = i ? cv[1][e] : cv[0][e];
          rx[e] = i ? cx[1][e] : cx[0][e];
        }
        float t = i ? thr[1] : thr[0], l = i ? lo[1] : lo[0];
        select_row(acc, i, i ? pre1 : pre0, rv, rx, t, l, k, t0, t_end,
                   valid, m, mk, mk_loaded);
#pragma unroll
        for (int e = 0; e < SLOTS; ++e) {
          cv[0][e] = i ? cv[0][e] : rv[e];
          cx[0][e] = i ? cx[0][e] : rx[e];
          cv[1][e] = i ? rv[e] : cv[1][e];
          cx[1][e] = i ? rx[e] : cx[1][e];
        }
        thr[0] = i ? thr[0] : t;
        thr[1] = i ? t : thr[1];
        lo[0] = i ? lo[0] : l;
        lo[1] = i ? l : lo[1];
      }
    }
  }

  // The carry was selected by the tensor cores' sums, whose rounding
  // differs from an in-order float32 sum's; each carried pick is scored
  // again in order, and the row keeps the best k of its K_CAP by those
  // scores. Lane q writes each of its entries at its rank among the
  // quad's, out layout [B * N_s][nseg][k].
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = r0 + 8 * i;
    if (gr < N_s) {
      const bf16* bt[SLOTS];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j)
        bt[j] = h_t + ((size_t)b * N_t + (cx[i][j] != NO_INDEX ? cx[i][j]
                                                                : 0)) * C;
      float d[SLOTS];
      dots_in_order(h_s + ((size_t)b * N_s + gr) * C, bt, C, d);
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int x = cx[i][j];
        if (x != NO_INDEX)
          cv[i][j] = m != nullptr && m[x] == 0 ? NEG : rnd(d[j]);
      }
    }
    float av[K_CAP];
    int ax[K_CAP];
#pragma unroll
    for (int src = 0; src < 4; ++src)
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        av[4 * j + src] = __shfl_sync(FULL, cv[i][j], quad | src);
        ax[4 * j + src] = __shfl_sync(FULL, cx[i][j], quad | src);
      }
    if (gr >= N_s) continue;
    const size_t o = (((size_t)b * N_s + gr) * nseg + seg) * k;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      int rank = 0;
#pragma unroll
      for (int e = 0; e < K_CAP; ++e)
        rank += better(av[e], ax[e], cv[i][j], cx[i][j]);
      if (rank < k) {
        out_v[o + rank] = cv[i][j];
        out_i[o + rank] = cx[i][j];
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, N, C] bf16 as TMA boxes of {64 channels, 128 rows, 1 batch}, 128-byte
// swizzled; what lies past N rows or C channels loads as zeros.
bool make_map(CUtensorMap* map, const bf16* x, int B, int N, int C) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(bf16),
                                 (cuuint64_t)N * C * sizeof(bf16)};
  const cuuint32_t box[3] = {KC, 128, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<bf16*>(x), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const bf16* h_s, const bf16* h_t, const uint8_t* t_mask,
           float* part_v, int* part_i, float* out_v, int* out_i, int B,
           int N_s, int N_t, int C, int k, int nseg, int tiles_per_seg,
           cudaStream_t st) {
  CUtensorMap map_s, map_t;
  if (!make_map(&map_s, h_s, B, N_s, C) || !make_map(&map_t, h_t, B, N_t, C))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      topk_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* tv = nseg > 1 ? part_v : out_v;
  int* ti = nseg > 1 ? part_i : out_i;
  dim3 grid((N_s + ROWS - 1) / ROWS, nseg, B);
  topk_tc<<<grid, THREADS, smem, st>>>(map_s, map_t, h_s, h_t, t_mask, tv,
                                       ti, N_s, N_t, C, k, nseg,
                                       tiles_per_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 1) return (int)err;
  return launch_merge<1>(part_v, part_i, out_v, out_i, B * N_s, k, nseg, st);
}

}  // namespace tc

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

// The tensor-core tile's constants (the wrapper's route and launch plan
// read them): rows a block, targets a tile, ring stages, largest k and C,
// and the dynamic shared memory of a block at C channels.
int dgmc_topk_tc_rows() { return tc::ROWS; }
int dgmc_topk_tc_targets_per_tile() { return tc::TGT; }
int dgmc_topk_tc_stages() { return tc::STAGES; }
int dgmc_topk_tc_k_max() { return tc::K_CAP; }
int dgmc_topk_tc_c_max() { return tc::C_MAX; }
int dgmc_topk_tc_smem_bytes(int C) { return (int)tc::smem_bytes(C); }

// As dgmc_topk_bf16, on the tensor cores: the same arguments and outputs,
// 128 source rows a block (no ts), target segments of tiles_per_seg tiles
// of 128. Takes 1 <= k <= 16, C % 8 == 0 (TMA's 16-byte row stride),
// C <= 640, h_s and h_t 16-byte aligned.
int dgmc_topk_bf16_tc(const void* h_s, const void* h_t, const uint8_t* t_mask,
                      float* part_v, int* part_i, float* out_v, int* out_i,
                      int B, int N_s, int N_t, int C, int k, int nseg,
                      int tiles_per_seg, int device, void* stream) {
  if (k < 1 || k > tc::K_CAP || k > N_t || B < 1 || N_s < 1 || C < 8 ||
      C % 8 != 0 || C > tc::C_MAX || nseg < 1 || tiles_per_seg < 1 ||
      (long long)nseg * tiles_per_seg * tc::TGT < N_t ||
      (long long)(nseg - 1) * tiles_per_seg * tc::TGT >= N_t ||
      ((reinterpret_cast<uintptr_t>(h_s) | reinterpret_cast<uintptr_t>(h_t)) %
       16) != 0)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    return tc::launch(static_cast<const bf16*>(h_s),
                      static_cast<const bf16*>(h_t), t_mask, part_v, part_i,
                      out_v, out_i, B, N_s, N_t, C, k, nseg, tiles_per_seg,
                      reinterpret_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
