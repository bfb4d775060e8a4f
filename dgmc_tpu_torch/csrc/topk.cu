// Streaming exact top-k of h_s @ h_t^T for Hopper (sm_90a), float32.
//
// Replaces dgmc_tpu/ops/pallas/topk.py::_kernel (the Pallas TPU kernel
// behind pallas_topk). For each source row it returns the k largest inner
// products with the target rows, sorted by value descending with the
// lowest target index first among equal values (the lax.top_k rule), and
// never materializes the N_s x N_t score matrix.
//
// Bound on the H100: 2*N_s*N_t*C FLOPs at the card's float32 rate, with
// device-memory traffic of only h_s + h_t + t_mask + out (each read or
// written once). At the DBP15K shape (15000 x 20000, C = 256, k = 10)
// that is 153.6 GFLOP against ~36 MB, so it is bound by operations.
//
// Design. The TPU kernel keeps its running top-k in VMEM across a
// sequential grid axis over target blocks; CUDA blocks run in no order,
// so here each block owns TS source rows and LOOPS over its target tiles:
//   1. a SIMT register-tiled product builds one TS x TT float32 score
//      tile: 256 threads, each an 8 x 8 register tile fed by four 16-byte
//      shared-memory loads per channel (64 FMAs), so the FMA units and
//      not shared-memory bandwidth set the pace. Channel slices of h_s
//      and h_t are staged in double-buffered shared memory (the next
//      slice's global loads are in flight while the current one is
//      multiplied); every score sums its channels in order;
//   2. masked targets score -FLT_MAX (strictly below every real score,
//      which DGMC's arithmetic entry mask relies on); targets past N_t
//      are never candidates;
//   3. one thread per row merges the tile into the row's sorted carry of
//      k (value desc, index asc) held in shared memory. A candidate
//      enters only when STRICTLY greater than the carry's k-th value and
//      moves past every entry >= it; tile candidates always carry larger
//      indices than the carry, so lowest-index-wins holds by
//      construction. The carry starts at -inf, below -FLT_MAX, so when k
//      exceeds the valid targets the masked ones fill in index order.

// Small queries have one row tile, which alone would occupy one SM; the
// target axis is therefore split into segments (blockIdx.y), each block
// writes a partial top-k, and a second kernel merges the segments in
// order with the same insertion rule (segment s holds larger indices
// than segments < s). The result does not depend on the segmentation.
// Both kernels are deterministic: no atomics, fixed summation order.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int TS = 128;       // source rows per block
constexpr int TT = 128;       // targets per score tile
constexpr int BK = 8;         // channels staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int LD = TS + 4;    // staged row stride: 16-byte aligned, and
                              // the transposing stores hit distinct banks
constexpr int K_MAX = 128;    // carry: 8 * TS * k bytes of shared memory

static_assert(TS == TT, "the staging loops assume square tiles");

// Stage channels [c0, c0 + BK) of rows [r0, r0 + TS) (bounded by n rows
// and C channels) into registers: thread t owns row t / 2, channels
// (t % 2) * 4 .. + 3.
__device__ __forceinline__ void load_slice(const float* __restrict__ src,
                                           int r0, int n, int C, int c0,
                                           int tid, float (&reg)[4]) {
  const int r = r0 + tid / 2;
  const int c = c0 + (tid % 2) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reg[j] = (r < n && c + j < C) ? src[(size_t)r * C + c + j] : 0.f;
}

__device__ __forceinline__ void store_slice(float* dst, int tid,
                                            const float (&reg)[4]) {
  const int r = tid / 2;
  const int c = (tid % 2) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[(c + j) * LD + r] = reg[j];
}

__global__ void __launch_bounds__(THREADS, 2)
topk_tiles(const float* __restrict__ h_s, const float* __restrict__ h_t,
           const uint8_t* __restrict__ t_mask, float* __restrict__ out_v,
           int* __restrict__ out_i, int B, int N_s, int N_t, int C, int k,
           int tiles_per_seg) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                     // [2][BK][LD] h_s slices
  float* Bs = As + 2 * BK * LD;         // [2][BK][LD] h_t slices
  float* S = Bs + 2 * BK * LD;          // [TS][TT + 1] score tile
  float* cv = S + TS * (TT + 1);        // [k][TS] carry values
  int* ci = reinterpret_cast<int*>(cv + k * TS);  // [k][TS] carry indices

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * TS;
  const int seg = blockIdx.y;
  const int b = blockIdx.z;
  const float* hs = h_s + (size_t)b * N_s * C;
  const float* ht = h_t + (size_t)b * N_t * C;
  const uint8_t* m = t_mask + (size_t)b * N_t;
  const int n_slices = (C + BK - 1) / BK;

  for (int e = tid; e < k * TS; e += THREADS) {
    cv[e] = -INFINITY;
    ci[e] = 0;
  }
  float thr = -INFINITY;  // row tid's k-th carry value (threads < TS)
  __syncthreads();

  const int t_begin = seg * tiles_per_seg * TT;
  const int t_end = min(N_t, t_begin + tiles_per_seg * TT);
  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float ra[4], rb[4];
    load_slice(hs, row0, N_s, C, 0, tid, ra);
    load_slice(ht, t0, t_end, C, 0, tid, rb);
    store_slice(As, tid, ra);
    store_slice(Bs, tid, rb);
    __syncthreads();
    for (int sl = 0; sl < n_slices; ++sl) {
      const int cur = sl & 1;
      const bool more = sl + 1 < n_slices;
      if (more) {  // in flight while this slice is multiplied
        load_slice(hs, row0, N_s, C, (sl + 1) * BK, tid, ra);
        load_slice(ht, t0, t_end, C, (sl + 1) * BK, tid, rb);
      }
      const float* a_s = As + cur * BK * LD;
      const float* b_s = Bs + cur * BK * LD;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            a_s + kk * LD + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(
            a_s + kk * LD + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(
            b_s + kk * LD + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            b_s + kk * LD + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                             b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      if (more) {
        store_slice(As + (cur ^ 1) * BK * LD, tid, ra);
        store_slice(Bs + (cur ^ 1) * BK * LD, tid, rb);
      }
      __syncthreads();
    }

    // Thread (ty, tx) holds rows ty*4 + {0..3}, 64 + ty*4 + {0..3} and
    // columns tx*4 + {0..3}, 64 + tx*4 + {0..3} of the tile.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      const int gt = t0 + t;
      const bool valid = gt < t_end && m[gt] != 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        S[r * (TT + 1) + t] = valid ? acc[i][j] : -FLT_MAX;
      }
    }
    __syncthreads();

    if (tid < TS) {
      const int r = tid;
      const int n = min(TT, t_end - t0);
      for (int t = 0; t < n; ++t) {
        const float v = S[r * (TT + 1) + t];
        if (v > thr) {
          int p = k - 1;
          while (p > 0 && cv[(p - 1) * TS + r] < v) {
            cv[p * TS + r] = cv[(p - 1) * TS + r];
            ci[p * TS + r] = ci[(p - 1) * TS + r];
            --p;
          }
          cv[p * TS + r] = v;
          ci[p * TS + r] = t0 + t;
          thr = cv[(k - 1) * TS + r];
        }
      }
    }
    __syncthreads();
  }

  // out layout: [segments][B][N_s][k]
  const size_t base = ((size_t)seg * B + b) * N_s;
  for (int e = tid; e < TS * k; e += THREADS) {
    const int r = e / k, j = e % k;
    const int gr = row0 + r;
    if (gr < N_s) {
      out_v[(base + gr) * k + j] = cv[j * TS + r];
      out_i[(base + gr) * k + j] = ci[j * TS + r];
    }
  }
}

// Merge the per-segment partial lists of each row, in segment order.
__global__ void merge_segments(const float* __restrict__ part_v,
                               const int* __restrict__ part_i,
                               float* __restrict__ out_v,
                               int* __restrict__ out_i, int rows, int k,
                               int nseg) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float* ov = out_v + (size_t)row * k;
  int* oi = out_i + (size_t)row * k;
  for (int j = 0; j < k; ++j) {
    ov[j] = part_v[(size_t)row * k + j];
    oi[j] = part_i[(size_t)row * k + j];
  }
  float thr = ov[k - 1];
  for (int s = 1; s < nseg; ++s) {
    const float* pv = part_v + ((size_t)s * rows + row) * k;
    const int* pi = part_i + ((size_t)s * rows + row) * k;
    for (int j = 0; j < k; ++j) {
      const float v = pv[j];
      if (!(v > thr)) break;  // the partial list is sorted descending
      int p = k - 1;
      while (p > 0 && ov[p - 1] < v) {
        ov[p] = ov[p - 1];
        oi[p] = oi[p - 1];
        --p;
      }
      ov[p] = v;
      oi[p] = pi[j];
      thr = ov[k - 1];
    }
  }
}

int launch(const float* h_s, const float* h_t, const uint8_t* t_mask,
           float* part_v, int* part_i, float* out_v, int* out_i, int B,
           int N_s, int N_t, int C, int k, int nseg, int tiles_per_seg,
           cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (4 * BK * LD + TS * (TT + 1)) +
      (sizeof(float) + sizeof(int)) * (size_t)k * TS;
  cudaError_t err = cudaFuncSetAttribute(
      topk_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N_s + TS - 1) / TS, nseg, B);
  float* tv = nseg > 1 ? part_v : out_v;
  int* ti = nseg > 1 ? part_i : out_i;
  topk_tiles<<<grid, THREADS, smem, st>>>(h_s, h_t, t_mask, tv, ti, B, N_s,
                                          N_t, C, k, tiles_per_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 1) return (int)err;
  const int rows = B * N_s;
  merge_segments<<<(rows + 127) / 128, 128, 0, st>>>(part_v, part_i, out_v,
                                                    out_i, rows, k, nseg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dgmc_topk_k_max() { return K_MAX; }
int dgmc_topk_rows_per_block() { return TS; }
int dgmc_topk_targets_per_tile() { return TT; }

// h_s [B, N_s, C], h_t [B, N_t, C] float32 contiguous; t_mask [B, N_t]
// uint8. Outputs out_v [B, N_s, k] float32 and out_i [B, N_s, k] int32.
// With nseg > 1, part_v / part_i hold [nseg, B, N_s, k] scratch and the
// target axis is cut into nseg segments of tiles_per_seg tiles of TT.
// Launches on `stream` on `device`, does not synchronize, restores the
// calling thread's current device, returns cudaGetLastError().
int dgmc_topk_f32(const float* h_s, const float* h_t, const uint8_t* t_mask,
                  float* part_v, int* part_i, float* out_v, int* out_i,
                  int B, int N_s, int N_t, int C, int k, int nseg,
                  int tiles_per_seg, int device, void* stream) {
  if (k < 1 || k > K_MAX || k > N_t || nseg < 1 || tiles_per_seg < 1 ||
      (long long)nseg * tiles_per_seg * TT < N_t || B < 1 || N_s < 1 ||
      C < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    return launch(h_s, h_t, t_mask, part_v, part_i, out_v, out_i, B, N_s,
                  N_t, C, k, nseg, tiles_per_seg,
                  reinterpret_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
