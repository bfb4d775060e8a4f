// Dense consensus update for Hopper (sm_90a), float32 forward.
//
// Replaces dgmc_tpu/ops/pallas/consensus.py::_consensus_kernel (behind
// consensus_update):
//
//   delta[b,s,t] = relu((o_s[b,s] - o_t[b,t]) @ W1 + b1) @ W2 + b2
//
// without materialising the [B, N_s, N_t, R] difference tensor.
//
// Design. The TPU kernel runs the per-pair [R] x [R, R] product on the MXU
// for every (s, t) of its 128 x 128 tile. The first layer is linear, so
// (o_s - o_t) @ W1 + b1 = u_s - u_t with u_s = o_s @ W1 + b1 and
// u_t = o_t @ W1 (the factored form the JAX dense path uses off-TPU). Two
// launches:
//   project_rows (csrc/project.cuh, shared with the sparse kernels): u_s
//     and u_t once per node row into the wrapper's scratch;
//   consensus_pairs: one block per TS x TT tile of one graph pair copies
//     the tile's u_s and u_t rows into shared memory (cp.async); each
//     thread keeps a 4 x 4 micro-tile of pairs in registers, so 16-byte
//     reads of 4 channels of 4 u_s rows and of 4 u_t rows feed 16 pairs:
//     relu(u_s - u_t) . w2 + b2, about 3R operations a pair instead of
//     2R^2. The tile is the wrapper's launch plan (consensus.launch_plan):
//     at [64, 80, 80] it is 40 x 80, 128 blocks of 200 threads, one wave
//     on 132 SMs with no padded pair (of the tiles tried on the card,
//     16-80 x 20-80, the fastest). Ragged tiles stage zero rows and skip
//     their stores, so any N_s, N_t work.
// Forming u inside every 32 x 32 tile instead (each node row projected
// N / 32 times, W1 copied by every block) took 0.061 ms there. On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) the two launches take
// about 0.015 ms at [64, 80, 80], R = 64, about 0.006 of it the
// projection.
//
// Bound on the H100: operations. Per graph pair the projection is
// 2 (N_s + N_t) R^2 and the pairs 3 N_s N_t R; the bytes are o_s, o_t and
// the [N_s, N_t] output only. At [64, 80, 80], R = 64 that is about
// 0.16 GFLOP against 4.2 MB (2.4 us at 67 TFLOP/s). Every sum runs in one
// order with no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "project.cuh"

namespace {

constexpr int R_MAX = 128;
constexpr int MICRO = 4;          // pairs per thread along s and along t
constexpr int TILE_MAX = 128;     // largest TS and TT
constexpr int MAX_THREADS = 256;  // (TS / 4) * (TT / 4), at most

__global__ void __launch_bounds__(MAX_THREADS)
consensus_pairs(const float* __restrict__ u_s, const float* __restrict__ u_t,
                const float* __restrict__ w2, const float* __restrict__ b2,
                float* __restrict__ out, int N_s, int N_t, int R, int TS,
                int TT) {
  extern __shared__ float4 smem4[];
  const int R4 = dgmc::proj_r4(R), LD = dgmc::tile_ld(R);
  float* ss = reinterpret_cast<float*>(smem4);   // [TS][LD] u_s rows
  float* st = ss + TS * LD;                      // [TT][LD] u_t rows
  float* sw = st + TT * LD;                      // [R4] w2
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * TS, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, nthr = blockDim.x;
  dgmc::copy_rows_async(u_s + ((int64_t)b * N_s + s0) * R, ss,
                        min(TS, N_s - s0), TS, R, LD, tid, nthr);
  dgmc::copy_rows_async(u_t + ((int64_t)b * N_t + t0) * R, st,
                        min(TT, N_t - t0), TT, R, LD, tid, nthr);
  for (int i = tid; i < R4; i += nthr) sw[i] = i < R ? w2[i] : 0.0f;
  dgmc::cp_wait_all();
  __syncthreads();

  // Channels 4 at a time: 16-byte reads of 4 u_s rows, 4 u_t rows and w2
  // feed the 16 pairs' 4 channels each, in channel order.
  const int cols = TT / MICRO;
  const int tx = tid % cols, ty = tid / cols;
  float acc[MICRO][MICRO] = {};
#pragma unroll 2
  for (int q = 0; q < R4; q += 4) {
    float sv[MICRO][4], tv[MICRO][4];
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(ss + (ty * MICRO + i) * LD + q);
      sv[i][0] = x.x; sv[i][1] = x.y; sv[i][2] = x.z; sv[i][3] = x.w;
      const float4 y =
          *reinterpret_cast<const float4*>(st + (tx * MICRO + i) * LD + q);
      tv[i][0] = y.x; tv[i][1] = y.y; tv[i][2] = y.z; tv[i][3] = y.w;
    }
    const float4 w4 = *reinterpret_cast<const float4*>(sw + q);
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          acc[i][j] = fmaf(fmaxf(sv[i][k] - tv[j][k], 0.0f), wv[k],
                           acc[i][j]);
  }
  const float bias = b2[0];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int s = s0 + ty * MICRO + i;
    if (s >= N_s) break;
    float* o = out + ((int64_t)b * N_s + s) * N_t;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int t = t0 + tx * MICRO + j;
      if (t < N_t) o[t] = acc[i][j] + bias;
    }
  }
}

bool bad_tile(int n) { return n < MICRO || n > TILE_MAX || n % MICRO; }

}  // namespace

extern "C" {

int dgmc_consensus_r_max() { return R_MAX; }
int dgmc_consensus_micro() { return MICRO; }
int dgmc_consensus_tile_max() { return TILE_MAX; }
int dgmc_consensus_max_threads() { return MAX_THREADS; }

// o_s [B, N_s, R], o_t [B, N_t, R], w1 [R, R] ([in, out]), b1 [R],
// w2 [R] (the [R, 1] kernel), b2 [1]: float32, contiguous; scratch
// u_s [B, N_s, R], u_t [B, N_t, R]. Writes out [B, N_s, N_t] in tiles of
// TS x TT (multiples of 4, at most 128, (TS / 4) (TT / 4) <= 256: the
// wrapper's launch plan). Launches on `stream` on `device`, does not
// synchronize, restores the calling thread's current device, returns the
// first CUDA error.
int dgmc_consensus_fwd_f32(const float* o_s, const float* o_t,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, float* u_s, float* u_t,
                           float* out, int B, int N_s, int N_t, int R,
                           int TS, int TT, int device, void* stream) {
  if (B < 1 || B > 65535 || N_s < 1 || N_t < 1 || R < 1 || R > R_MAX ||
      bad_tile(TS) || bad_tile(TT) ||
      (TS / MICRO) * (TT / MICRO) > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err = dgmc::project(o_s, o_t, w1, b1, u_s, u_t,
                                    (int64_t)B * N_s, (int64_t)B * N_t, R,
                                    st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(float) * ((size_t)dgmc::tile_ld(R) * (TS + TT) +
                                         dgmc::proj_r4(R));
    err = cudaFuncSetAttribute(consensus_pairs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N_t + TT - 1) / TT, (N_s + TS - 1) / TS, B);
    consensus_pairs<<<grid, (TS / MICRO) * (TT / MICRO), smem, st>>>(
        u_s, u_t, w2, b2, out, N_s, N_t, R, TS, TT);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
