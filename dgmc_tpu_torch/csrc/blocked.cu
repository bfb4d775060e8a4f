// Blocked edge->node aggregation for Hopper (sm_90a).
//
// out[b, n, c] = sum over the edges e with destination n of h[b, src_e, c],
// read straight from the blocked adjacency tables of ops/blocked.py (the JAX
// package's dgmc_tpu/ops/blocked.py, which computes the same sum as XLA
// one-hot einsums, ops/blocked.py:148-218; there is no Pallas kernel). The
// tables: edges stable-sorted by destination, cut into blocks of at most
// E_b edges whose destinations lie in one aligned range of `rows` nodes,
// source order within a block; src / dst_local [B, NB, E_b] int32,
// mask [B, NB, E_b] uint8, range_ptr [B, num_ranges + 1] int32 (range r's
// blocks are range_ptr[r] .. range_ptr[r + 1] - 1). The same entry serves
// the backward: the gradient of h is this sum over the transposed tables.
//
// Design. One block of threads per (range, channel tile, batch element):
// the range's output rows x a tile of CT = 32 V channels live in shared
// memory as float32 accumulators ([rows][CT], 64 KB at rows = 128, V = 4).
// Warp w owns the rows whose offset in the range is w modulo 8. The warps
// walk the range's blocks in order, 32 edges at a time: each lane reads
// one edge's (mask, src, dst_local), a ballot marks the warp's own edges,
// and the warp takes them lowest lane first, GROUP at a time: it loads
// their rows (lane l reads channels c0 + l + 32 j, coalesced: 128 bytes a
// warp per j for float32, 64 for bf16) and then adds them to the owned
// accumulator rows in edge order. Each (row, channel) therefore has one
// fixed summation order — the range's blocks in order, each block's edges
// in order — and one thread: no atomics, repeats bit-identical. The
// range combine of the JAX form is folded in (a block of threads owns its
// range's rows), and neither the one-hot matrix nor the [E, C] message
// tensor exists. The accumulators are written once, rows past M cut.
//
// Rows are float32, or bf16 where ops/blocked.py casts them (gather_dtype
// at C * 2 >= 512), widened to float32 as they are read; sums in float32.
//
// Bound on the H100 (bytes): the h table read once, the output written
// once, the tables read once. psi_1 at C = 256 on the synthetic DBP15K
// source KG (15000 nodes, 100000 edges, ~250 blocks of 512): 15.4 MB + 15.4
// MB + ~1.2 MB, about 9.5 us at 3.35 TB/s; the h table fits in the 50 MB
// L2, so the gather's repeated row reads (each row ~6.7 times) are L2
// traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// Edges whose rows a warp loads before it adds them (loads in flight).
constexpr int GROUP = 4;
constexpr int V_MAX = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    blocked_aggregate(const T* __restrict__ h, const int* __restrict__ src,
                      const int* __restrict__ dst,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ range_ptr,
                      float* __restrict__ out, int M, int NB, int E_b,
                      int num_ranges, int rows, int C) {
  constexpr int CT = 32 * V;
  extern __shared__ float acc[];  // [rows][CT]
  const int range = blockIdx.x, b = blockIdx.z;
  const int c0 = blockIdx.y * CT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < rows * CT; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  const T* hb = h + (size_t)b * M * C;
  const int* ptr = range_ptr + (size_t)b * (num_ranges + 1);
  const int first = ptr[range], last = ptr[range + 1];
  for (int blk = first; blk < last; ++blk) {
    const size_t base = ((size_t)b * NB + blk) * E_b;
    for (int e0 = 0; e0 < E_b; e0 += 32) {
      const int e = e0 + lane;
      int s = 0, d = 0;
      bool real = false;
      if (e < E_b && mask[base + e]) {
        s = src[base + e];
        d = dst[base + e];
        real = true;
      }
      // Warp-uniform from here on: `mine` is a ballot.
      unsigned mine = __ballot_sync(FULL, real && d % WARPS == warp);
      while (mine) {
        int gs[GROUP], gd[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int l = mine ? __ffs(mine) - 1 : 0;
          const int su = __shfl_sync(FULL, s, l);
          const int du = __shfl_sync(FULL, d, l);
          gs[u] = su;
          gd[u] = mine ? du : -1;
          mine &= mine - 1;
        }
        float v[GROUP][V];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int c = c0 + lane + 32 * j;
            v[u][j] = (gd[u] >= 0 && c < C)
                          ? widen(hb + (size_t)gs[u] * C + c)
                          : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          if (gd[u] >= 0) {
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[gd[u] * CT + lane + 32 * j] += v[u][j];
          }
        }
      }
    }
  }
  __syncthreads();

  const int row0 = range * rows;
  float* ob = out + (size_t)b * M * C;
  for (int i = threadIdx.x; i < rows * CT; i += THREADS) {
    const int r = i / CT, c = c0 + i % CT, n = row0 + r;
    if (n < M && c < C) ob[(size_t)n * C + c] = acc[i];
  }
}

template <typename T, int V>
int launch_v(const T* h, const int* src, const int* dst, const uint8_t* mask,
             const int* range_ptr, float* out, int B, int M, int NB, int E_b,
             int num_ranges, int rows, int C, cudaStream_t stream) {
  constexpr int CT = 32 * V;
  const size_t smem = (size_t)rows * CT * sizeof(float);
  auto kernel = blocked_aggregate<T, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_ranges, (C + CT - 1) / CT, B);
  kernel<<<grid, THREADS, smem, stream>>>(h, src, dst, mask, range_ptr, out,
                                          M, NB, E_b, num_ranges, rows, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* h, const int* src, const int* dst, const uint8_t* mask,
           const int* range_ptr, float* out, int B, int M, int NB, int E_b,
           int num_ranges, int rows, int C, cudaStream_t stream) {
  const int v = (C + 31) / 32 < V_MAX ? (C + 31) / 32 : V_MAX;
  switch (v) {
    case 1:
      return launch_v<T, 1>(h, src, dst, mask, range_ptr, out, B, M, NB, E_b,
                            num_ranges, rows, C, stream);
    case 2:
      return launch_v<T, 2>(h, src, dst, mask, range_ptr, out, B, M, NB, E_b,
                            num_ranges, rows, C, stream);
    case 3:
      return launch_v<T, 3>(h, src, dst, mask, range_ptr, out, B, M, NB, E_b,
                            num_ranges, rows, C, stream);
    default:
      return launch_v<T, 4>(h, src, dst, mask, range_ptr, out, B, M, NB, E_b,
                            num_ranges, rows, C, stream);
  }
}

}  // namespace

extern "C" {

// Warps a block of threads, edges a warp loads before it adds them, and
// the largest channel tile (checked by the wrapper at load).
int dgmc_blocked_warps() { return WARPS; }
int dgmc_blocked_group() { return GROUP; }
int dgmc_blocked_channel_tile() { return 32 * V_MAX; }

// h [B, M, C] float32 (bf16 = 0) or bf16 (bf16 = 1); out [B, M, C] float32,
// every element written. Launches on `stream` on `device`, does not
// synchronize, restores the calling thread's current device, returns the
// first CUDA error.
int dgmc_blocked_aggregate(const void* h, int bf16, const int* src,
                           const int* dst_local, const uint8_t* mask,
                           const int* range_ptr, float* out, int B, int M,
                           int NB, int E_b, int num_ranges, int rows, int C,
                           int device, void* stream) {
  if (B <= 0 || M <= 0 || C <= 0) return (int)cudaSuccess;
  if (num_ranges <= 0 || rows <= 0 || B > 65535 ||
      (size_t)rows * 32 * V_MAX * sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
      return launch(static_cast<const __nv_bfloat16*>(h), src, dst_local,
                    mask, range_ptr, out, B, M, NB, E_b, num_ranges, rows, C,
                    s);
    return launch(static_cast<const float*>(h), src, dst_local, mask,
                  range_ptr, out, B, M, NB, E_b, num_ranges, rows, C, s);
  });
}

}  // extern "C"
