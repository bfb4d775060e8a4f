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
// u_t = o_t @ W1 (the factored form the JAX dense path uses off-TPU). Each
// block owns a TS x TT tile of one graph pair: a prologue stages W1, b1,
// W2 and the tile's o_s / o_t rows in shared memory and forms u_s and u_t
// there (the R x R product stays inside the kernel); then every pair costs
// relu(u_s - u_t) . w2 + b2, about 3R operations instead of 2R^2. Ragged
// tiles load zero rows and skip their stores, so any N_s, N_t work.
//
// Bound on the H100: operations. Per graph pair the prologue is
// 2 (N_s + N_t) R^2 and the pairs 3 N_s N_t R; the bytes are o_s, o_t and
// the [N_s, N_t] output only. At [64, 80, 80], R = 64 that is about
// 0.16 GFLOP against 4.2 MB. Each block recomputes u for its tile rows
// (N_t / TT times per source row), which costs less than one more pass
// over device memory at these sizes. Every sum runs in one order with no
// atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int TS = 32;         // source rows per tile
constexpr int TT = 32;         // target rows per tile (one per lane)
constexpr int THREADS = 256;   // 8 warps: warp w owns rows w, w+8, ...
constexpr int R_MAX = 128;

__global__ void consensus_fwd(const float* __restrict__ o_s,
                              const float* __restrict__ o_t,
                              const float* __restrict__ w1,
                              const float* __restrict__ b1,
                              const float* __restrict__ w2,
                              const float* __restrict__ b2,
                              float* __restrict__ out, int N_s, int N_t,
                              int R) {
  extern __shared__ float smem[];
  const int LD = R + 1;          // padded stride: lane t reads row t
  float* sw1 = smem;             // [R][R]
  float* sb1 = sw1 + R * R;      // [R]
  float* sw2 = sb1 + R;          // [R]
  float* xs = sw2 + R;           // [TS][R]  o_s rows, then reused
  float* xt = xs + TS * R;       // [TT][R]  o_t rows
  float* us = xt + TT * R;       // [TS][LD] u_s
  float* ut = us + TS * LD;      // [TT][LD] u_t

  const int b = blockIdx.z;
  const int s0 = blockIdx.y * TS, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;

  for (int i = tid; i < R * R; i += THREADS) sw1[i] = w1[i];
  for (int i = tid; i < R; i += THREADS) {
    sb1[i] = b1[i];
    sw2[i] = w2[i];
  }
  const float* os = o_s + ((int64_t)b * N_s + s0) * R;
  const float* ot = o_t + ((int64_t)b * N_t + t0) * R;
  for (int i = tid; i < TS * R; i += THREADS)
    xs[i] = (s0 + i / R < N_s) ? os[i] : 0.0f;
  for (int i = tid; i < TT * R; i += THREADS)
    xt[i] = (t0 + i / R < N_t) ? ot[i] : 0.0f;
  __syncthreads();

  // Prologue: u_s = o_s @ W1 + b1 and u_t = o_t @ W1 for the tile rows.
  // Consecutive threads take consecutive output columns q, so W1 reads
  // are conflict-free and the row read is a broadcast.
  for (int i = tid; i < (TS + TT) * R; i += THREADS) {
    const int row = i / R, q = i - row * R;
    const float* x = row < TS ? xs + row * R : xt + (row - TS) * R;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) acc += x[r] * sw1[r * R + q];
    if (row < TS)
      us[row * LD + q] = acc + sb1[q];
    else
      ut[(row - TS) * LD + q] = acc;
  }
  __syncthreads();

  // Pairs: lane = target row, warp = source rows w, w + 8, ...
  const int lane = tid & 31, warp = tid >> 5;
  const float bias2 = b2[0];
  const float* u_t = ut + lane * LD;
  for (int s = warp; s < TS; s += THREADS / 32) {
    const float* u_s = us + s * LD;
    float acc = 0.0f;
    for (int q = 0; q < R; ++q)
      acc += fmaxf(u_s[q] - u_t[q], 0.0f) * sw2[q];
    if (s0 + s < N_s && t0 + lane < N_t)
      out[((int64_t)b * N_s + s0 + s) * N_t + t0 + lane] = acc + bias2;
  }
}

size_t smem_bytes(int R) {
  return sizeof(float) *
         ((size_t)R * R + 2 * R + (TS + TT) * R + (TS + TT) * (R + 1));
}

}  // namespace

extern "C" {

int dgmc_consensus_r_max() { return R_MAX; }
int dgmc_consensus_tile_s() { return TS; }
int dgmc_consensus_tile_t() { return TT; }

// o_s [B, N_s, R], o_t [B, N_t, R], w1 [R, R] ([in, out]), b1 [R],
// w2 [R] (the [R, 1] kernel), b2 [1]: float32, contiguous. Writes
// out [B, N_s, N_t]. Launches on `stream` on `device`, does not
// synchronize, restores the calling thread's current device, returns
// cudaGetLastError().
int dgmc_consensus_fwd_f32(const float* o_s, const float* o_t,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, float* out, int B, int N_s,
                           int N_t, int R, int device, void* stream) {
  if (B < 1 || N_s < 1 || N_t < 1 || R < 1 || R > R_MAX)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const size_t smem = smem_bytes(R);
    cudaError_t err = cudaFuncSetAttribute(
        consensus_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N_t + TT - 1) / TT, (N_s + TS - 1) / TS, B);
    consensus_fwd<<<grid, THREADS, smem,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
        o_s, o_t, w1, b1, w2, b2, out, N_s, N_t, R);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
