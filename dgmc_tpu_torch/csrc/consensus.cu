// Dense consensus update for Hopper (sm_90a), forward, float32 or
// bfloat16 inputs (float32 output).
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
// bf16 inputs (the precision policy's variant, dgmc_consensus_fwd_bf16):
// o_s, o_t and the MLP's weights all bf16. The pairs round where the JAX
// package's factored form (its dense path at these sizes) rounds: u as
// project.cuh says, then h = relu(bf16(u_s - u_t)), and h . w2 + b2 summed
// in float32; u_s and u_t travel as bf16 scratch (half the bytes) and are
// staged as they are, and each pair forms two channels of h at a time by
// bf16x2 arithmetic (a float32 difference rounded to bf16 would spend a
// conversion instruction a channel, which made the pairs 3x slower).
//
// Bound on the H100: operations. Per graph pair the projection is
// 2 (N_s + N_t) R^2 and the pairs 3 N_s N_t R; the bytes are o_s, o_t and
// the [N_s, N_t] output only. At [64, 80, 80], R = 64 that is about
// 0.16 GFLOP against 4.2 MB (2.4 us at 67 TFLOP/s). Every sum runs in one
// order with no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"
#include "project.cuh"

namespace {

constexpr int R_MAX = 128;
constexpr int MICRO = 4;          // pairs per thread along s and along t
constexpr int TILE_MAX = 128;     // largest TS and TT
constexpr int MAX_THREADS = 256;  // (TS / 4) * (TT / 4), at most

// Row stride of a staged tile of u rows: float32 as project.cuh stages
// them (tile_ld), bf16 as they are, R rounded up to 4 plus 4 (8-byte rows:
// 8-byte reads of 4 channels).
template <typename T>
__host__ __device__ inline int pair_ld(int R) {
  return std::is_same<T, float>::value ? dgmc::tile_ld(R)
                                       : dgmc::proj_r4(R) + 4;
}

// bf16 rows x [n, R] into s [T][LD] as they are, zero past n and R:
// 8-byte cp.async copies where R % 4 == 0 and x is 8-byte aligned, else an
// element a thread at a time (plain stores, published by the caller's
// barrier like the copies).
__device__ __forceinline__ void stage_bf16(const dgmc::bf16* __restrict__ x,
                                           dgmc::bf16* s, int n, int T,
                                           int R, int LD, int tid,
                                           int nthr) {
  if (R % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0) {
    const int per_row = LD / 4;
    for (int i = tid; i < T * per_row; i += nthr) {
      const int row = i / per_row, q = 4 * (i - row * per_row);
      const bool real = row < n && q < R;
      const unsigned d =
          static_cast<unsigned>(__cvta_generic_to_shared(s + row * LD + q));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(real ? x + row * R + q : x), "r"(real ? 8 : 0));
    }
  } else {
    for (int i = tid; i < T * LD; i += nthr) {
      const int row = i / LD, q = i - row * LD;
      s[row * LD + q] = row < n && q < R ? x[row * R + q]
                                         : __float2bfloat16_rn(0.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
consensus_pairs(const T* __restrict__ u_s, const T* __restrict__ u_t,
                const T* __restrict__ w2, const T* __restrict__ b2,
                float* __restrict__ out, int N_s, int N_t, int R, int TS,
                int TT) {
  constexpr bool PACKED = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int R4 = dgmc::proj_r4(R), LD = pair_ld<T>(R);
  T* ss = reinterpret_cast<T*>(smem4);           // [TS][LD] u_s rows
  T* st = ss + TS * LD;                          // [TT][LD] u_t rows
  float* sw = reinterpret_cast<float*>(st + TT * LD);   // [R4] w2
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * TS, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n_s = min(TS, N_s - s0), n_t = min(TT, N_t - t0);
  if constexpr (PACKED) {
    stage_bf16(u_s + ((int64_t)b * N_s + s0) * R, ss, n_s, TS, R, LD, tid,
               nthr);
    stage_bf16(u_t + ((int64_t)b * N_t + t0) * R, st, n_t, TT, R, LD, tid,
               nthr);
  } else {
    dgmc::copy_rows_async(u_s + ((int64_t)b * N_s + s0) * R, ss, n_s, TS, R,
                          LD, tid, nthr);
    dgmc::copy_rows_async(u_t + ((int64_t)b * N_t + t0) * R, st, n_t, TT, R,
                          LD, tid, nthr);
  }
  for (int i = tid; i < R4; i += nthr)
    sw[i] = i < R ? dgmc::to_f(w2[i]) : 0.0f;
  dgmc::cp_wait_all();
  __syncthreads();

  // Channels 4 at a time: reads of 4 channels of 4 u_s rows, 4 u_t rows
  // and w2 feed the 16 pairs' 4 channels each, in channel order.
  const int cols = TT / MICRO;
  const int tx = tid % cols, ty = tid / cols;
  float acc[MICRO][MICRO] = {};
  if constexpr (PACKED) {
    // bf16: two channels at a time in bf16x2, relu(u_s - u_t) rounded to
    // nearest even by the subtraction itself (u_s and u_t are bf16, so
    // it equals rounding their float32 difference), then each widened
    // into its float32 FMA. No conversion instruction per pair.
    const dgmc::bf16 z = __float2bfloat16_rn(0.0f);
    const __nv_bfloat162 zero2 = __halves2bfloat162(z, z);
#pragma unroll 2
    for (int q = 0; q < R4; q += 4) {
      __nv_bfloat162 sv[MICRO][2], tv[MICRO][2];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        const uint2 x =
            *reinterpret_cast<const uint2*>(ss + (ty * MICRO + i) * LD + q);
        sv[i][0] = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
        sv[i][1] = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
        const uint2 y =
            *reinterpret_cast<const uint2*>(st + (tx * MICRO + i) * LD + q);
        tv[i][0] = *reinterpret_cast<const __nv_bfloat162*>(&y.x);
        tv[i][1] = *reinterpret_cast<const __nv_bfloat162*>(&y.y);
      }
      const float4 w4 = *reinterpret_cast<const float4*>(sw + q);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < MICRO; ++i)
#pragma unroll
          for (int j = 0; j < MICRO; ++j) {
            const __nv_bfloat162 h =
                __hmax2(__hsub2(sv[i][k], tv[j][k]), zero2);
            acc[i][j] = fmaf(__bfloat162float(h.x), wv[2 * k], acc[i][j]);
            acc[i][j] =
                fmaf(__bfloat162float(h.y), wv[2 * k + 1], acc[i][j]);
          }
    }
  } else {
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
  }
  const float bias = dgmc::to_f(b2[0]);
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

template <typename T>
int consensus_entry(const T* o_s, const T* o_t, const T* w1, const T* b1,
                    const T* w2, const T* b2, T* u_s, T* u_t, float* out,
                    int B, int N_s, int N_t, int R, int TS, int TT,
                    int device, void* stream) {
  if (B < 1 || B > 65535 || N_s < 1 || N_t < 1 || R < 1 || R > R_MAX ||
      bad_tile(TS) || bad_tile(TT) ||
      (TS / MICRO) * (TT / MICRO) > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err = dgmc::project<T>(o_s, o_t, w1, b1, u_s, u_t,
                                       (int64_t)B * N_s, (int64_t)B * N_t, R,
                                       st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(T) * (size_t)pair_ld<T>(R) * (TS + TT) +
                        sizeof(float) * dgmc::proj_r4(R);
    err = cudaFuncSetAttribute(consensus_pairs<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N_t + TT - 1) / TT, (N_s + TS - 1) / TS, B);
    consensus_pairs<T><<<grid, (TS / MICRO) * (TT / MICRO), smem, st>>>(
        u_s, u_t, w2, b2, out, N_s, N_t, R, TS, TT);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

int dgmc_consensus_r_max() { return R_MAX; }
int dgmc_consensus_micro() { return MICRO; }
int dgmc_consensus_tile_max() { return TILE_MAX; }
int dgmc_consensus_max_threads() { return MAX_THREADS; }

// o_s [B, N_s, R], o_t [B, N_t, R], w1 [R, R] ([in, out]), b1 [R],
// w2 [R] (the [R, 1] kernel), b2 [1]: all float32 (_f32) or all bfloat16
// (_bf16), contiguous; scratch u_s [B, N_s, R], u_t [B, N_t, R] in the
// same dtype. Writes out [B, N_s, N_t] float32 in tiles of TS x TT
// (multiples of 4, at most 128, (TS / 4) (TT / 4) <= 256: the wrapper's
// launch plan). Launches on `stream` on `device`, does not synchronize,
// restores the calling thread's current device, returns the first CUDA
// error.
int dgmc_consensus_fwd_f32(const float* o_s, const float* o_t,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, float* u_s, float* u_t,
                           float* out, int B, int N_s, int N_t, int R,
                           int TS, int TT, int device, void* stream) {
  return consensus_entry(o_s, o_t, w1, b1, w2, b2, u_s, u_t, out, B, N_s,
                         N_t, R, TS, TT, device, stream);
}

int dgmc_consensus_fwd_bf16(const void* o_s, const void* o_t, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            void* u_s, void* u_t, float* out, int B, int N_s,
                            int N_t, int R, int TS, int TT, int device,
                            void* stream) {
  using T = dgmc::bf16;
  return consensus_entry(
      static_cast<const T*>(o_s), static_cast<const T*>(o_t),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(u_s), static_cast<T*>(u_t), out, B, N_s, N_t, R, TS,
      TT, device, stream);
}

}  // extern "C"
