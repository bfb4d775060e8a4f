// Sparse consensus delta for Hopper (sm_90a), float32: forward and backward.
//
// Replaces dgmc_tpu/ops/pallas/sparse_consensus.py::_fwd_kernel and
// ::_bwd_kernel (behind fused_candidate_delta and sparse_consensus_delta):
//
//   delta[b,s,k] = relu((o_s[b,s] - o_t[b, idx[b,s,k]]) @ W1 + b1) @ w2 + b2
//
// Form. The first layer is linear, so (o_s - o_t) @ W1 + b1 = u_s - u_t
// with u_s = o_s @ W1 + b1 and u_t = o_t @ W1 (the factored form that
// csrc/consensus.cu uses too). A prologue kernel, sc_project, forms u_s
// and u_t once per node row (N_s + N_t rows instead of N_s * K) with W1
// and b1 in shared memory; the candidate kernels then do all the
// per-candidate work: relu(u_s[s] - u_t[idx]) . w2 + b2 forward, about 3R
// operations per candidate instead of the 2R^2 of the direct form. The
// [B, N_s, K, R] candidate tensor never exists. Forward and backward run
// the same prologue, so the backward's ReLU mask is the forward's, bit for
// bit.
//
// Layout. One warp per row, lane q holding channels q, q + 32, ...
// (R <= R_MAX = 128, four per lane), so a candidate's u_t row is one
// coalesced 128-byte read at R = 32. Each warp first loads up to 32 of its
// row's candidate indices (and, backward, their output gradients) with one
// read per lane and passes them on by shuffles. Dot products end in an XOR
// butterfly, which leaves the same bits in every lane.
//
// Backward (recomputes u and pre = u_s[s] - u_t[t], as the TPU kernel
// recomputes its tile), with g = dL/d delta and d_pre = g * w2 where
// pre > 0:
//   sc_bwd_src: one warp per source row: d_u_s[s] = sum_k d_pre, summed in
//     registers in k order; per block, partial sums of d_w2 = sum g *
//     relu(pre) and d_b2 = sum g (the TPU kernel's += across grid steps
//     would race between concurrent blocks);
//   sc_reduce: those partials summed per column in a fixed order;
//   sc_bwd_tgt: d_u_t[t] = -sum d_pre over the slots pointing at t, from
//     the shortlist's receiver order (a CSR list per target, built once
//     per forward by a stable sort). Top-k shortlists have hubs, targets
//     in thousands of lists, so one warp per target would serialize on
//     them: each target's list is cut into chunks of `chunk` slots, one
//     warp sums a chunk in slot order (its target found by a binary search
//     over the chunks' prefix sum), and sc_tgt_sum adds each target's
//     chunk sums in chunk order.
// The node-level products d_o_s = d_u_s W1^T, d_o_t = d_u_t W1^T and
// d_W1 = o_s^T d_u_s + o_t^T d_u_t are the wrapper's. No atomics anywhere:
// repeats are bit-identical.
//
// Bound on the H100. Bytes: at the DBP15K training shape (N_s = 15000,
// K = 20, N_t = 20000, R = 32) the function reads o_s, o_t and the
// shortlist (4 bytes a slot, as top-k emits it; these kernels read it as
// int64) and writes delta, about 6.9 MB (2.1 us at 3.35 TB/s); its
// operations in the factored form, the u products included, are about
// 0.1 GFLOP (1.5 us at 67 TFLOP/s in float32). The candidate reads are
// random 128-byte rows of u_t, which stays in the 50 MB L2; what limits
// this simple design is the latency of those dependent reads, hidden only
// by the number of warps in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int WARPS = 8;                 // rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int R_MAX = 128;
constexpr int RPL = R_MAX / 32;          // channels per lane
constexpr int PARTIAL_BLOCKS = 1024;     // grid of sc_bwd_src, at most
constexpr int PROJECT_BLOCKS = 1024;     // grid of sc_project, at most
constexpr int PROJ_ROWS = 8;             // rows per warp in sc_project
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

__device__ __forceinline__ void load_row(const float* row, int R, int lane,
                                         float (&x)[RPL]) {
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int q = lane + 32 * i;
    x[i] = q < R ? row[q] : 0.0f;
  }
}

// u_s = o_s @ W1 + b1 and u_t = o_t @ W1 ([R, R] row-major, (in, out)),
// the rows of o_s first, then those of o_t. Each warp takes PROJ_ROWS rows
// at a time, staged in shared memory as [R][PROJ_ROWS] beside W1 and b1;
// lane q keeps channels q, q + 32, ... (NC = ceil(R / 32) of them) of all
// those rows in registers, so one read of W1[r] feeds PROJ_ROWS * NC
// FMAs. Every output sums over r = 0, 1, ... in order.
template <int NC>
__global__ void sc_project(const float* __restrict__ o_s,
                           const float* __restrict__ o_t,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           float* __restrict__ u_s, float* __restrict__ u_t,
                           int64_t rows_s, int64_t rows_t, int R) {
  extern __shared__ float smem[];
  float* sw = smem;                        // [R][R]
  float* sb = sw + R * R;                  // [R]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sx = sb + R + warp * PROJ_ROWS * R;   // this warp's [R][PROJ_ROWS]
  for (int i = threadIdx.x; i < R * R; i += THREADS) sw[i] = w1[i];
  for (int i = threadIdx.x; i < R; i += THREADS) sb[i] = b1[i];
  __syncthreads();
  const int64_t rows = rows_s + rows_t;
  for (int64_t t0 = ((int64_t)blockIdx.x * WARPS + warp) * PROJ_ROWS;
       t0 < rows; t0 += (int64_t)gridDim.x * WARPS * PROJ_ROWS) {
    __syncwarp();
    for (int j = 0; j < PROJ_ROWS; ++j) {
      const int64_t row = t0 + j;
      const float* x =
          row < rows_s ? o_s + row * R : o_t + (row - rows_s) * R;
      for (int q = lane; q < R; q += 32)
        sx[q * PROJ_ROWS + j] = row < rows ? x[q] : 0.0f;
    }
    __syncwarp();
    float acc[PROJ_ROWS][NC] = {};
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float w[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int q = lane + 32 * c;
        w[c] = q < R ? sw[r * R + q] : 0.0f;
      }
      const float* v = sx + r * PROJ_ROWS;
#pragma unroll
      for (int j = 0; j < PROJ_ROWS; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[j][c] = fmaf(v[j], w[c], acc[j][c]);
    }
#pragma unroll
    for (int j = 0; j < PROJ_ROWS; ++j) {
      const int64_t row = t0 + j;
      if (row >= rows) break;
      const bool src = row < rows_s;
      float* u = src ? u_s + row * R : u_t + (row - rows_s) * R;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int q = lane + 32 * c;
        if (q < R) u[q] = src ? acc[j][c] + sb[q] : acc[j][c];
      }
    }
  }
}

__global__ void sc_fwd(const float* __restrict__ u_s,
                       const float* __restrict__ u_t,
                       const int64_t* __restrict__ idx,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2, float* __restrict__ out,
                       int64_t rows, int N_s, int N_t, int K, int R) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t b = row / N_s;
  float us[RPL], w[RPL];
  load_row(u_s + row * R, R, lane, us);
  load_row(w2, R, lane, w);
  const float bias = b2[0];
  const float* ut_b = u_t + b * N_t * (int64_t)R;
  const int64_t* ids = idx + row * K;
  float* o = out + row * K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int n = min(32, K - k0);
    const int64_t my_t = lane < n ? ids[k0 + lane] : 0;
    float mine = 0.0f;
    for (int j = 0; j < n; ++j) {
      const int64_t t = __shfl_sync(FULL, my_t, j);
      float ut[RPL];
      load_row(ut_b + t * R, R, lane, ut);
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < RPL; ++i) acc += fmaxf(us[i] - ut[i], 0.0f) * w[i];
      acc = warp_sum(acc);
      if (lane == j) mine = acc + bias;
    }
    if (lane < n) o[k0 + lane] = mine;
  }
}

__global__ void sc_bwd_src(const float* __restrict__ u_s,
                           const float* __restrict__ u_t,
                           const int64_t* __restrict__ idx,
                           const float* __restrict__ w2,
                           const float* __restrict__ g,
                           float* __restrict__ d_us,
                           float* __restrict__ partial, int64_t rows, int N_s,
                           int N_t, int K, int R) {
  __shared__ float red[WARPS][R_MAX + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float w[RPL], dw2[RPL] = {};
  float gsum = 0.0f;
  load_row(w2, R, lane, w);
  for (int64_t row = (int64_t)blockIdx.x * WARPS + warp; row < rows;
       row += (int64_t)gridDim.x * WARPS) {
    const int64_t b = row / N_s;
    float us[RPL], dus[RPL] = {};
    load_row(u_s + row * R, R, lane, us);
    const float* ut_b = u_t + b * N_t * (int64_t)R;
    const int64_t* ids = idx + row * K;
    const float* gr = g + row * K;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int n = min(32, K - k0);
      const int64_t my_t = lane < n ? ids[k0 + lane] : 0;
      const float my_g = lane < n ? gr[k0 + lane] : 0.0f;
      for (int j = 0; j < n; ++j) {
        const int64_t t = __shfl_sync(FULL, my_t, j);
        const float gk = __shfl_sync(FULL, my_g, j);
        float ut[RPL];
        load_row(ut_b + t * R, R, lane, ut);
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          const float pre = us[i] - ut[i];
          if (pre > 0.0f) {
            dus[i] += gk * w[i];
            dw2[i] += gk * pre;
          }
        }
        gsum += gk;
      }
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int q = lane + 32 * i;
      if (q < R) d_us[row * R + q] = dus[i];
    }
  }
  // Block partials: the warps' sums added in warp order.
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int q = lane + 32 * i;
    if (q < R) red[warp][q] = dw2[i];
  }
  if (lane == 0) red[warp][R] = gsum;
  __syncthreads();
  for (int q = threadIdx.x; q <= R; q += THREADS) {
    float s = 0.0f;
    for (int v = 0; v < WARPS; ++v) s += red[v][q];
    partial[(int64_t)blockIdx.x * (R + 1) + q] = s;
  }
}

// One warp per column of partial [blocks, cols]: lane j sums blocks j,
// j + 32, ... in order, then the butterfly.
__global__ void sc_reduce(const float* __restrict__ partial,
                          float* __restrict__ out, int blocks, int cols) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= cols) return;
  float s = 0.0f;
  for (int j = lane; j < blocks; j += 32) s += partial[(int64_t)j * cols + c];
  s = warp_sum(s);
  if (lane == 0) out[c] = s;
}

// chunk_start [rows + 1]: exclusive prefix sum of ceil(deg_t / chunk);
// chunk c of target t covers its slots (c - chunk_start[t]) * chunk + [0,
// chunk), chunk <= 32. Writes the chunk's sum of d_pre to partial[c].
__global__ void sc_bwd_tgt(const float* __restrict__ u_s,
                           const float* __restrict__ u_t,
                           const float* __restrict__ w2,
                           const float* __restrict__ g,
                           const int64_t* __restrict__ order,
                           const int64_t* __restrict__ offsets,
                           const int64_t* __restrict__ chunk_start,
                           float* __restrict__ partial, int64_t rows, int K,
                           int R, int chunk) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= chunk_start[rows]) return;
  // The target: the last row whose first chunk is <= c (it has >= 1).
  int64_t lo = 0, hi = rows;
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    if (chunk_start[mid] <= c) lo = mid; else hi = mid;
  }
  const int64_t beg = offsets[lo] + (c - chunk_start[lo]) * chunk;
  const int64_t left = offsets[lo + 1] - beg;
  const int n = left < chunk ? (int)left : chunk;
  float w[RPL], ut[RPL], acc[RPL] = {};
  load_row(w2, R, lane, w);
  load_row(u_t + lo * R, R, lane, ut);
  const int64_t my_slot = lane < n ? order[beg + lane] : 0;
  const float my_g = lane < n ? g[my_slot] : 0.0f;
  for (int j = 0; j < n; ++j) {
    const int64_t slot = __shfl_sync(FULL, my_slot, j);
    const float gk = __shfl_sync(FULL, my_g, j);
    float us[RPL];
    // slot = (b * N_s + s) * K + k: its source row is slot / K.
    load_row(u_s + (slot / K) * R, R, lane, us);
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      if (us[i] - ut[i] > 0.0f) acc[i] += gk * w[i];
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int q = lane + 32 * i;
    if (q < R) partial[c * R + q] = acc[i];
  }
}

// One warp per target row: d_u_t = -(its chunk sums, added in order).
__global__ void sc_tgt_sum(const float* __restrict__ partial,
                           const int64_t* __restrict__ chunk_start,
                           float* __restrict__ d_ut, int64_t rows, int R) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  float acc[RPL] = {};
  for (int64_t c = chunk_start[row]; c < chunk_start[row + 1]; ++c) {
    float x[RPL];
    load_row(partial + c * R, R, lane, x);
#pragma unroll
    for (int i = 0; i < RPL; ++i) acc[i] += x[i];
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int q = lane + 32 * i;
    if (q < R) d_ut[row * R + q] = -acc[i];
  }
}

unsigned blocks_for(int64_t rows) {
  return (unsigned)((rows + WARPS - 1) / WARPS);
}

bool bad_shape(int B, int N_s, int N_t, int K, int R) {
  return B < 1 || N_s < 1 || N_t < 1 || K < 1 || R < 1 || R > R_MAX;
}

// The prologue: u_s and u_t from o_s, o_t, W1 and b1.
template <int NC>
cudaError_t project_nc(const float* o_s, const float* o_t, const float* w1,
                       const float* b1, float* u_s, float* u_t,
                       int64_t rows_s, int64_t rows_t, int R,
                       cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)R * R + R + (size_t)WARPS * PROJ_ROWS * R);
  cudaError_t err = cudaFuncSetAttribute(
      sc_project<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (rows_s + rows_t + PROJ_ROWS - 1) / PROJ_ROWS;
  const unsigned blocks = blocks_for(tiles);
  sc_project<NC><<<blocks < PROJECT_BLOCKS ? blocks : PROJECT_BLOCKS,
                   THREADS, smem, st>>>(o_s, o_t, w1, b1, u_s, u_t, rows_s,
                                        rows_t, R);
  return cudaGetLastError();
}

cudaError_t project(const float* o_s, const float* o_t, const float* w1,
                    const float* b1, float* u_s, float* u_t, int64_t rows_s,
                    int64_t rows_t, int R, cudaStream_t st) {
  switch ((R + 31) / 32) {
    case 1: return project_nc<1>(o_s, o_t, w1, b1, u_s, u_t, rows_s, rows_t,
                                 R, st);
    case 2: return project_nc<2>(o_s, o_t, w1, b1, u_s, u_t, rows_s, rows_t,
                                 R, st);
    case 3: return project_nc<3>(o_s, o_t, w1, b1, u_s, u_t, rows_s, rows_t,
                                 R, st);
    default: return project_nc<4>(o_s, o_t, w1, b1, u_s, u_t, rows_s,
                                  rows_t, R, st);
  }
}

}  // namespace

extern "C" {

int dgmc_sc_r_max() { return R_MAX; }

// Rows of the backward's partial-sum scratch for B * N_s source rows.
int dgmc_sc_partials(long long rows) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  return (int)(blocks < PARTIAL_BLOCKS ? blocks : PARTIAL_BLOCKS);
}

// o_s [B, N_s, R], o_t [B, N_t, R], idx [B, N_s, K] int64 in [0, N_t)
// (unchecked), w1 [R, R], b1 [R], w2 [R], b2 [1]: float32, contiguous;
// scratch u_s [B, N_s, R], u_t [B, N_t, R]. Writes out [B, N_s, K].
// Launches on `stream` on `device`, does not synchronize, restores the
// calling thread's current device, returns the first CUDA error.
int dgmc_sc_fwd_f32(const float* o_s, const float* o_t, const int64_t* idx,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, float* u_s, float* u_t, float* out,
                    int B, int N_s, int N_t, int K, int R, int device,
                    void* stream) {
  if (bad_shape(B, N_s, N_t, K, R)) return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    const int64_t rows = (int64_t)B * N_s;
    cudaError_t err = project(o_s, o_t, w1, b1, u_s, u_t, rows,
                              (int64_t)B * N_t, R, st);
    if (err != cudaSuccess) return (int)err;
    sc_fwd<<<blocks_for(rows), THREADS, 0, st>>>(u_s, u_t, idx, w2, b2, out,
                                                 rows, N_s, N_t, K, R);
    return (int)cudaGetLastError();
  });
}

// As the forward (b2 aside), plus g [B, N_s, K] (dL/d delta), order
// [B*N_s*K] int64 slot ids sorted by (b, target), offsets [B*N_t + 1]
// int64 CSR bounds into order, chunk_start [B*N_t + 1] int64 (the
// exclusive prefix sum of ceil(deg / chunk) per target, 1 <= chunk <= 32),
// and scratch partial [dgmc_sc_partials(B*N_s), R + 1] and tgt_partial
// [max_chunks, R], where max_chunks >= chunk_start[B*N_t] bounds the target
// pass's grid. Writes d_us [B, N_s, R], d_ut [B, N_t, R] and d_w2b2
// [R + 1] (d_w2, then d_b2).
int dgmc_sc_bwd_f32(const float* o_s, const float* o_t, const int64_t* idx,
                    const float* w1, const float* b1, const float* w2,
                    const float* g, const int64_t* order,
                    const int64_t* offsets, const int64_t* chunk_start,
                    float* u_s, float* u_t, float* d_us, float* d_ut,
                    float* partial, float* tgt_partial, float* d_w2b2, int B,
                    int N_s, int N_t, int K, int R, int chunk,
                    long long max_chunks, int device, void* stream) {
  if (bad_shape(B, N_s, N_t, K, R) || chunk < 1 || chunk > 32 ||
      max_chunks < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    const int64_t rows_s = (int64_t)B * N_s, rows_t = (int64_t)B * N_t;
    const int parts = dgmc_sc_partials(rows_s);
    cudaError_t err = project(o_s, o_t, w1, b1, u_s, u_t, rows_s, rows_t,
                              R, st);
    if (err != cudaSuccess) return (int)err;
    sc_bwd_src<<<parts, THREADS, 0, st>>>(u_s, u_t, idx, w2, g, d_us,
                                          partial, rows_s, N_s, N_t, K, R);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sc_reduce<<<(R + 1 + WARPS - 1) / WARPS, THREADS, 0, st>>>(
        partial, d_w2b2, parts, R + 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sc_bwd_tgt<<<blocks_for(max_chunks), THREADS, 0, st>>>(
        u_s, u_t, w2, g, order, offsets, chunk_start, tgt_partial, rows_t,
        K, R, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sc_tgt_sum<<<blocks_for(rows_t), THREADS, 0, st>>>(
        tgt_partial, chunk_start, d_ut, rows_t, R);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
