// Node-row projection shared by csrc/consensus.cu and
// csrc/sparse_consensus.cu (float32 or bfloat16 rows, sm_90a).
//
// Both consensus kernels use the factored form of the MLP's first layer:
// (o_s - o_t) @ W1 + b1 = u_s - u_t with u_s = o_s @ W1 + b1 and
// u_t = o_t @ W1. project_rows forms u once per node row, so the pair or
// candidate kernels that follow do about 3R operations per pair instead of
// 2R^2, and both sources sum each u in the same order (r = 0, 1, ...,
// then b1).
//
// Design: a small GEMM [rows, R] x [R, R]. A block owns BR = 4 * 128 /
// (R4 / 4) consecutive rows of o_s or of o_t (R4 = R rounded up to 4): it
// copies them into shared memory beside W1 with cp.async (all of a
// thread's copies in flight at once), and each thread computes a 4-row x
// 4-column tile, 8 16-byte shared-memory reads for 64 FMAs. At R = 32 a
// block takes 64 rows (the DBP15K pair: 547 blocks), at R = 64 32 rows
// (the PascalPF batch: 320 blocks): small blocks, so that the SMs share
// the rows evenly. Giving each warp 8 rows against broadcast reads of W1
// instead left the projection bound by the latency of its staging.
// The helpers below also stage the tiles of consensus_pairs and of the
// sparse backward's node pass.
//
// bf16 rows (the precision policy's variant): staged widened to float32
// (plain loads; cp.async copies bytes as they are), products summed in
// float32 in the same order, and u rounded where the JAX package's
// factored form rounds it: u_s = bf16(bf16(o_s W1) + b1), u_t =
// bf16(o_t W1) (round to nearest even). The kernels that read u widen it
// again; each keeps its own sums in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dgmc {

using bf16 = __nv_bfloat16;

// Element conversions: to float32, from float32 (bf16 rounds to nearest
// even), and rounding a float32 through T (the identity for float).
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// a - b rounded to the operands' dtype, as float32: for bf16 the bf16
// subtraction, which rounds the exact difference to nearest even, as
// rounding the float32 difference of two bf16 values would (see
// relu_diff4), without a conversion instruction.
__device__ __forceinline__ float sub_rounded(float a, float b) {
  return a - b;
}
__device__ __forceinline__ float sub_rounded(bf16 a, bf16 b) {
  return __bfloat162float(__hsub(a, b));
}

constexpr int PROJ_THREADS = 128;

__host__ __device__ inline int proj_r4(int R) { return (R + 3) / 4 * 4; }
// Threads per row group (4 output columns each) and rows per block.
__host__ __device__ inline int proj_cols(int R) { return proj_r4(R) / 4; }
__host__ __device__ inline int proj_block_rows(int R) {
  return 4 * (PROJ_THREADS / proj_cols(R));
}

// Row stride of a staged row tile: R rounded up to 4, plus 4, so rows
// start 16-byte aligned and 16-byte reads of 8 consecutive rows hit
// different banks.
__host__ __device__ inline int tile_ld(int R) { return proj_r4(R) + 4; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

// Waits for this thread's copies; the caller then syncs the block.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// x [n, R] row-major into s [T][LD] (LD % 4 == 0, LD >= R4): rows n..T-1
// and channels R..LD-1 zero-filled. Asynchronous copies (cp.async, 16
// bytes where R % 4 == 0 and x is 16-byte aligned, else 4), so every
// thread issues all its copies before waiting once (cp_wait_all).
__device__ __forceinline__ void copy_rows_async(const float* __restrict__ x,
                                                float* s, int n, int T,
                                                int R, int LD, int tid,
                                                int nthr) {
  if (R % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int per_row = LD / 4;
    for (int i = tid; i < T * per_row; i += nthr) {
      const int row = i / per_row, q = 4 * (i - row * per_row);
      const bool real = row < n && q < R;
      cp_async16(s + row * LD + q, real ? x + row * R + q : x, real);
    }
  } else {
    for (int i = tid; i < T * LD; i += nthr) {
      const int row = i / LD, q = i - row * LD;
      const bool real = row < n && q < R;
      cp_async4(s + row * LD + q, real ? x + row * R + q : x, real);
    }
  }
}

// relu(s - t) of four bf16 channels each (8 bytes as loaded), widened
// to float32: the subtraction in bf16x2 rounds the exact difference to
// nearest even, which for bf16 operands equals rounding their float32
// difference (exact unless the exponents lie 17 or more apart, and then
// both round to s); no conversion instruction a channel.
__device__ __forceinline__ void relu_diff4(uint2 s, uint2 t,
                                           float (&h)[4]) {
  const bf16 z = __float2bfloat16_rn(0.0f);
  const __nv_bfloat162 zero2 = __halves2bfloat162(z, z);
  const __nv_bfloat162 lo = __hmax2(
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&s.x),
              *reinterpret_cast<const __nv_bfloat162*>(&t.x)),
      zero2);
  const __nv_bfloat162 hi = __hmax2(
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&s.y),
              *reinterpret_cast<const __nv_bfloat162*>(&t.y)),
      zero2);
  h[0] = __bfloat162float(lo.x);
  h[1] = __bfloat162float(lo.y);
  h[2] = __bfloat162float(hi.x);
  h[3] = __bfloat162float(hi.y);
}

// Four bf16 values (8 bytes, aligned) widened to float32.
__device__ __forceinline__ float4 widen4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y),
                     __bfloat162float(hi.x), __bfloat162float(hi.y));
}

// The same for bf16 rows, widened to float32 in s: plain loads (cp.async
// would copy the 2-byte elements as they are), 8 bytes each where R % 4
// == 0 and x is 8-byte aligned; the caller's barrier (after cp_wait_all)
// publishes them like the asynchronous copies.
__device__ __forceinline__ void copy_rows_async(const bf16* __restrict__ x,
                                                float* s, int n, int T,
                                                int R, int LD, int tid,
                                                int nthr) {
  if (R % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0) {
    const int per_row = LD / 4;
    for (int i = tid; i < T * per_row; i += nthr) {
      const int row = i / per_row, q = 4 * (i - row * per_row);
      *reinterpret_cast<float4*>(s + row * LD + q) =
          row < n && q < R ? widen4(x + row * R + q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < T * LD; i += nthr) {
      const int row = i / LD, q = i - row * LD;
      s[row * LD + q] = row < n && q < R ? to_f(x[row * R + q]) : 0.0f;
    }
  }
}

// W1 [R, R] into s [R4][ld] transposed, s[q][r] = W1[r][q], zero past R
// (ld % 4 == 0, ld >= R4; ld = R4 + 4 spreads the transposing stores over
// 8 banks): coalesced loads, each thread's issued before its stores.
template <typename T>
__device__ __forceinline__ void stage_w_transposed(
    const T* __restrict__ w1, float* s, int R, int ld, int tid, int nthr) {
  constexpr int BATCH = 8;
  const int R4 = proj_r4(R);
  for (int i0 = tid; i0 < R4 * R4; i0 += BATCH * nthr) {
    float v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * nthr;
      const int r = i / R4, q = i - r * R4;
      v[b] = r < R && q < R ? to_f(w1[r * R + q]) : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * nthr;
      const int r = i / R4, q = i - r * R4;
      if (i < R4 * R4) s[q * ld + r] = v[b];
    }
  }
}

// acc[i][j] = sum over k < R4, in order, of a[row0 + i][k] b[k][col0 + j]
// (fmaf), a row-major with stride lda, b row-major with stride ldb, both
// in shared memory and zero past R: 16-byte reads, 4 k at a time.
__device__ __forceinline__ void tile_product(const float* a, int lda,
                                             const float* b, int ldb,
                                             int row0, int col0, int R4,
                                             float (&acc)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < R4; k += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(a + (row0 + i) * lda + k);
      av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
      const float4 y =
          *reinterpret_cast<const float4*>(b + (k + i) * ldb + col0);
      bv[i][0] = y.x; bv[i][1] = y.y; bv[i][2] = y.z; bv[i][3] = y.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i][kk], bv[kk][j], acc[i][j]);
  }
}

// Block b < tiles_s projects rows [b BR, (b+1) BR) of o_s (adding b1),
// the others the rows of o_t after them: the rows and W1 land in shared
// memory by cp.async, one wait, then each thread forms a 4-row x
// 4-column tile of u. Every output sums over r = 0, 1, ... in order with
// fmaf, then adds b1 (for bf16, to the sum rounded to bf16, and the total
// rounded again).
template <typename T>
__global__ void __launch_bounds__(PROJ_THREADS)
project_rows(const T* __restrict__ o_s, const T* __restrict__ o_t,
             const T* __restrict__ w1, const T* __restrict__ b1,
             T* __restrict__ u_s, T* __restrict__ u_t,
             int64_t rows_s, int64_t rows_t, int R, int tiles_s) {
  extern __shared__ float4 proj_smem4[];
  const int R4 = proj_r4(R), cols = proj_cols(R), BR = proj_block_rows(R);
  const int LD = tile_ld(R);
  float* sw = reinterpret_cast<float*>(proj_smem4);   // [R4][R4] W1
  float* sx = sw + R4 * R4;                           // [BR][LD] rows
  const bool src = (int)blockIdx.x < tiles_s;
  const int64_t r0 =
      (int64_t)(src ? blockIdx.x : blockIdx.x - tiles_s) * BR;
  const int64_t rows = src ? rows_s : rows_t;
  const int n = (int)(rows - r0 < BR ? rows - r0 : BR);
  const int tid = threadIdx.x;
  copy_rows_async(w1, sw, R, R4, R, R4, tid, PROJ_THREADS);
  copy_rows_async((src ? o_s : o_t) + r0 * R, sx, n, BR, R, LD, tid,
                  PROJ_THREADS);
  cp_wait_all();
  __syncthreads();
  const int tx = tid % cols, ty = tid / cols;
  if (ty * 4 >= BR) return;
  float acc[4][4] = {};
  tile_product(sx, LD, sw, R4, ty * 4, tx * 4, R4, acc);
  T* u = (src ? u_s : u_t) + r0 * R;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= n) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = tx * 4 + j;
      if (q < R)
        u[(int64_t)row * R + q] =
            src ? from_f<T>(rnd<T>(acc[i][j]) + to_f(b1[q]))
                : from_f<T>(acc[i][j]);
    }
  }
}

// One launch: u_s [rows_s, R] and u_t [rows_t, R], 1 <= R <= 128.
template <typename T>
inline cudaError_t project(const T* o_s, const T* o_t, const T* w1,
                           const T* b1, T* u_s, T* u_t, int64_t rows_s,
                           int64_t rows_t, int R, cudaStream_t st) {
  const int BR = proj_block_rows(R), R4 = proj_r4(R);
  const size_t smem = sizeof(float) * ((size_t)R4 * R4 +
                                       (size_t)BR * tile_ld(R));
  cudaError_t err = cudaFuncSetAttribute(
      project_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles_s = (rows_s + BR - 1) / BR;
  const int64_t tiles_t = (rows_t + BR - 1) / BR;
  project_rows<T><<<(unsigned)(tiles_s + tiles_t), PROJ_THREADS, smem,
                    st>>>(o_s, o_t, w1, b1, u_s, u_t, rows_s, rows_t, R,
                          (int)tiles_s);
  return cudaGetLastError();
}

}  // namespace dgmc
