// Sparse consensus delta for Hopper (sm_90a), float32: forward and backward.
//
// Replaces dgmc_tpu/ops/pallas/sparse_consensus.py::_fwd_kernel and
// ::_bwd_kernel (behind fused_candidate_delta and sparse_consensus_delta):
//
//   delta[b,s,k] = relu((o_s[b,s] - o_t[b, idx[b,s,k]]) @ W1 + b1) @ w2 + b2
//
// Form. The first layer is linear, so (o_s - o_t) @ W1 + b1 = u_s - u_t
// with u_s = o_s @ W1 + b1 and u_t = o_t @ W1 (the factored form that
// csrc/consensus.cu uses too). The forward's first launch, project_rows
// (csrc/project.cuh), forms u_s and u_t once per node row into the
// wrapper's buffers; sc_fwd then does all the per-candidate work,
// relu(u_s[s] - u_t[idx]) . w2 + b2, about 3R operations per candidate
// instead of the 2R^2 of the direct form. The [B, N_s, K, R] candidate
// tensor never exists. Asked for the state its backward needs, the
// forward also writes the ReLU mask, one bit per candidate and channel
// (pre > 0, ballot of the warp), and the wrapper keeps u_s and u_t: the
// backward runs no projection, and its ReLU mask is the forward's.
//
// Layout. One warp per row, lane q holding channels q, q + 32, ...
// (NC = ceil(R / 32) of them, R <= R_MAX = 128), so a candidate's u row is
// one coalesced 128-byte read at R = 32. A warp loads up to 32 of its
// row's candidate indices (and, backward, their output gradients) with one
// read per lane and passes them on by shuffles. Indices are int32, as
// top-k emits them. Dot products end in an XOR butterfly, which leaves the
// same bits in every lane.
//
// Backward, with g = dL/d delta, pre = u_s[s] - u_t[t] and d_pre = g * w2
// where pre > 0. Four launches, no atomics, repeats bit-identical:
//   sc_bwd_cand, two kinds of block in disjoint ranges of one grid, both
//     walking their items BWD_WARPS at a time and pipelined (the next
//     item's reads in flight behind the current one's):
//     - source blocks, a warp per source row: d_u_s[s] = sum_k d_pre in k
//       order, 16 / NC candidate rows of u_t in flight; d_w2 = sum g
//       relu(pre) and d_b2 = sum g per block (the warps' sums in order);
//     - chunk blocks, a warp per chunk of one target's list in the
//       shortlist's receiver order: the chunk's sum of d_pre from each
//       slot's gradient and the forward's mask (a lane a slot, passed on
//       by shuffles), no u row read. A list of d slots is cut into chunks
//       of 32 ceil(sqrt(d) / 32) slots, so a top-k hub (a target in
//       thousands of lists) costs its chunk warps and its target warp
//       about sqrt(d) / 32 rounds each. A chunk's target, first slot and
//       length come from the Shortlist's chunk map (int32, built once per
//       shortlist), so no warp searches for them;
//   sc_bwd_tgt: a warp per TGT_PER_WARP target rows adds each row's chunk
//     sums in chunk order, d_u_t = -(their sum);
//   sc_bwd_nodes: the node-level products as project_rows does its own,
//     from rows copied into shared memory: d_o = d_u W1^T, and each
//     block's share of d_W1 = o^T d_u and d_b1 = sum d_u_s;
//   sc_reduce: the blocks' shares (d_W1, d_b1; d_w2, d_b2) summed per
//     column in block order.
// (Running the projection again, reading u rows one dependent load at a
// time, searching each chunk's target and leaving the node products to
// four cuBLAS calls took 9 or more launches and nearly three times as
// long.)
//
// Bound on the H100. At the DBP15K training shape (N_s = 15000, K = 20,
// N_t = 20000, R = 32) the forward reads o_s, o_t and the shortlist and
// writes delta, about 6.9 MB (2.1 us at 3.35 TB/s); its operations, the
// u products included, are about 0.1 GFLOP (1.5 us at 67 TFLOP/s). The
// backward's least work is that of the form that projects again: about
// 0.27 GFLOP (4.1 us) against 11 MB; given the forward's u it would read
// about 16 MB (4.7 us), more time than the product it saves. What limits
// both is the random 128-byte u_t row per candidate (300000 at K = 20,
// 38 MB from L2): the source blocks alone take about 0.02 ms with every block of the card in flight. On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) the backward takes
// about 0.048 ms at K = 20, the forward 0.023 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"
#include "project.cuh"

namespace {

constexpr int WARPS = 8;                 // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int R_MAX = 128;
constexpr int RED_WARPS = 32;            // warps per block of sc_reduce
constexpr int TGT_PER_WARP = 4;          // target rows per warp of sc_bwd_tgt
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

template <int NC>
__device__ __forceinline__ void load_row(const float* row, int R, int lane,
                                         float (&x)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q = lane + 32 * c;
    x[c] = q < R ? row[q] : 0.0f;
  }
}

// out = the delta; mask (unless null) [rows * K][NC]: bit l
// of word c of a candidate is pre > 0 in channel l + 32 c, the ReLU mask
// the backward's target side reads instead of u rows.
template <int NC>
__global__ void sc_fwd(const float* __restrict__ u_s,
                       const float* __restrict__ u_t,
                       const int* __restrict__ idx,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2, float* __restrict__ out,
                       unsigned* __restrict__ mask, int rows, int N_s,
                       int N_t, int K, int R) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  float us[NC], w[NC];
  load_row(u_s + (int64_t)row * R, R, lane, us);
  load_row(w2, R, lane, w);
  const float bias = b2[0];
  const float* ut_b = u_t + (int64_t)(row / N_s) * N_t * R;
  const int* ids = idx + (int64_t)row * K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int n = min(32, K - k0);
    const int my_t = lane < n ? ids[k0 + lane] : 0;
    float mine = 0.0f;
    unsigned my_mask[NC] = {};
    for (int j = 0; j < n; ++j) {
      const int t = __shfl_sync(FULL, my_t, j);
      float ut[NC];
      load_row(ut_b + (int64_t)t * R, R, lane, ut);
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc += fmaxf(us[c] - ut[c], 0.0f) * w[c];
        if (mask) {   // warp-uniform
          const unsigned bits = __ballot_sync(FULL, us[c] - ut[c] > 0.0f);
          if (lane == j) my_mask[c] = bits;
        }
      }
      acc = warp_sum(acc);
      if (lane == j) mine = acc + bias;
    }
    const int64_t slot = (int64_t)row * K + k0 + lane;
    if (lane < n) {
      out[slot] = mine;
      if (mask)
#pragma unroll
        for (int c = 0; c < NC; ++c) mask[slot * NC + c] = my_mask[c];
    }
  }
}

// Source blocks (blockIdx < src_blocks): warps walk source rows row =
// blockIdx * WARPS + warp, + src_blocks * WARPS, ...: d_u_s[s] = sum_k
// d_pre in k order into d_us; the block's share of d_w2 = sum g relu(pre)
// and d_b2 = sum g into wpart[blockIdx] (the warps' sums in warp order).
// Chunk blocks: one warp per chunk of the Shortlist's chunk map, the
// chunk's sum of d_pre into tgt_partial[c].
template <int NC>
__global__ void __launch_bounds__(THREADS)
sc_bwd_cand(const float* __restrict__ u_s, const float* __restrict__ u_t,
            const int* __restrict__ idx, const float* __restrict__ w2,
            const float* __restrict__ g, const unsigned* __restrict__ mask,
            const int* __restrict__ order,
            const int4* __restrict__ chunk_map, float* __restrict__ d_us,
            float* __restrict__ tgt_partial, float* __restrict__ wpart,
            int rows_s, int N_s, int N_t, int K, int R, int src_blocks,
            int n_chunks) {
  constexpr int U = 16 / NC;   // rows in flight: 16 registers of them
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float w[NC];
  load_row(w2, R, lane, w);
  if ((int)blockIdx.x >= src_blocks) {
    // Chunk warps walk chunks c, c + stride, ... in a three-stage
    // pipeline, so each chunk costs one round of loads: while chunk c is
    // summed, the gradients and ReLU masks of chunk c + stride (a lane a
    // slot), the order entries of chunk c + 2 stride and the map entry of
    // chunk c + 3 stride are in flight. The slots' values pass to the
    // channel lanes by shuffles, in slot order.
    const int stride = ((int)gridDim.x - src_blocks) * WARPS;
    const int first = ((int)blockIdx.x - src_blocks) * WARPS + warp;
    const int4 none = make_int4(-1, 0, 0, 0);
    auto map_at = [&](int i) { return i < n_chunks ? chunk_map[i] : none; };
    // Slots of a chunk's first 32 that lane reads (chunks past the last,
    // all at the end of the map, have none).
    auto head = [&](int4 m) { return m.x >= 0 ? min(32, m.z) : 0; };
    auto order_at = [&](int4 m, int s0) {
      return lane < min(32, m.z - s0) && m.x >= 0 ? order[m.y + s0 + lane]
                                                   : 0;
    };
    int c = first;
    int4 m0 = map_at(c), m1 = map_at(c + stride), m2 = map_at(c + 2 * stride);
    int s0 = order_at(m0, 0), s1 = order_at(m1, 0);
    float g0 = lane < head(m0) ? g[s0] : 0.0f;
    unsigned k0[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i)
      k0[i] = lane < head(m0) ? mask[(int64_t)s0 * NC + i] : 0u;
    while (m0.x >= 0) {
      const int4 m3 = map_at(c + 3 * stride);
      const int s2 = order_at(m2, 0);
      const float g1 = lane < head(m1) ? g[s1] : 0.0f;
      unsigned k1[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        k1[i] = lane < head(m1) ? mask[(int64_t)s1 * NC + i] : 0u;
      float acc[NC] = {};
      for (int t0 = 0; t0 < m0.z; t0 += 32) {
        const int n = min(32, m0.z - t0);
        if (t0) {   // a hub's chunk: its next 32 slots
          const int slot = order_at(m0, t0);
          g0 = lane < n ? g[slot] : 0.0f;
#pragma unroll
          for (int i = 0; i < NC; ++i)
            k0[i] = lane < n ? mask[(int64_t)slot * NC + i] : 0u;
        }
        for (int j = 0; j < n; ++j) {
          const float gk = __shfl_sync(FULL, g0, j);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const unsigned bits = __shfl_sync(FULL, k0[i], j);
            if (bits >> lane & 1u) acc[i] += gk * w[i];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int q = lane + 32 * i;
        if (q < R) tgt_partial[(int64_t)c * R + q] = acc[i];
      }
      c += stride;
      m0 = m1;
      m1 = m2;
      m2 = m3;
      s1 = s2;
      g0 = g1;
#pragma unroll
      for (int i = 0; i < NC; ++i) k0[i] = k1[i];
    }
    return;
  }

  // Source rows, software-pipelined: the next row's indices, gradients and
  // u_s row are loaded while this row's candidates are in flight.
  __shared__ float red[WARPS][32 * NC + 1];
  float dw2[NC] = {}, gsum = 0.0f;
  const int stride = src_blocks * WARPS;
  int row = blockIdx.x * WARPS + warp;
  int my_t = 0;
  float my_g = 0.0f, us[NC] = {};
  if (row < rows_s) {
    if (lane < K) {
      my_t = idx[(int64_t)row * K + lane];
      my_g = g[(int64_t)row * K + lane];
    }
    load_row(u_s + (int64_t)row * R, R, lane, us);
  }
  for (; row < rows_s; row += stride) {
    const int next = row + stride;
    int n_t = 0;
    float n_g = 0.0f, n_us[NC] = {}, dus[NC] = {};
    const float* ut_b = u_t + (int64_t)(row / N_s) * N_t * R;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int n = min(32, K - k0);
      if (k0) {   // K > 32: the next 32 candidates
        my_t = lane < n ? idx[(int64_t)row * K + k0 + lane] : 0;
        my_g = lane < n ? g[(int64_t)row * K + k0 + lane] : 0.0f;
      }
      for (int j0 = 0; j0 < n; j0 += U) {
        float ut[U][NC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = __shfl_sync(FULL, my_t, (j0 + u) & 31);
          if (j0 + u < n) load_row(ut_b + (int64_t)t * R, R, lane, ut[u]);
        }
        if (k0 == 0 && j0 == 0 && next < rows_s) {
          if (lane < K) {
            n_t = idx[(int64_t)next * K + lane];
            n_g = g[(int64_t)next * K + lane];
          }
          load_row(u_s + (int64_t)next * R, R, lane, n_us);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float gk = __shfl_sync(FULL, my_g, (j0 + u) & 31);
          if (j0 + u < n) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const float pre = us[c] - ut[u][c];
              if (pre > 0.0f) {
                dus[c] += gk * w[c];
                dw2[c] += gk * pre;
              }
            }
            gsum += gk;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int q = lane + 32 * c;
      if (q < R) d_us[(int64_t)row * R + q] = dus[c];
      us[c] = n_us[c];
    }
    my_t = n_t;
    my_g = n_g;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) red[warp][lane + 32 * c] = dw2[c];
  if (lane == 0) red[warp][32 * NC] = gsum;
  __syncthreads();
  for (int q = threadIdx.x; q <= R; q += THREADS) {
    const int col = q < R ? q : 32 * NC;
    float s = 0.0f;
    for (int v = 0; v < WARPS; ++v) s += red[v][col];
    wpart[(int64_t)blockIdx.x * (R + 1) + q] = s;
  }
}

// TGT_PER_WARP target rows per warp: d_u_t = -(each row's chunk sums,
// chunk_start[t] ... chunk_start[t + 1] - 1, added in chunk order); one
// read of chunk_start, then the chunk sums of all its rows in flight
// together, U at a time.
template <int NC>
__global__ void __launch_bounds__(THREADS)
sc_bwd_tgt(const float* __restrict__ tgt_partial,
           const int* __restrict__ chunk_start, float* __restrict__ d_ut,
           int rows_t, int R) {
  constexpr int U = 16 / NC;
  constexpr int TW = TGT_PER_WARP;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * TW;
  if (row0 >= rows_t) return;
  const int rows = min(TW, rows_t - row0);
  const int my_b = lane <= rows ? chunk_start[row0 + lane] : 0;
  int bound[TW + 1];
#pragma unroll
  for (int i = 0; i <= TW; ++i)
    bound[i] = __shfl_sync(FULL, my_b, min(i, rows));
  float acc[TW][NC] = {};
  for (int c0 = bound[0]; c0 < bound[TW]; c0 += U) {
    float x[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < bound[TW])
        load_row(tgt_partial + (int64_t)(c0 + u) * R, R, lane, x[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c >= bound[TW]) break;
#pragma unroll
      for (int i = 0; i < TW; ++i)
        if (c >= bound[i] && c < bound[i + 1])
#pragma unroll
          for (int q = 0; q < NC; ++q) acc[i][q] += x[u][q];
    }
  }
#pragma unroll
  for (int i = 0; i < TW; ++i) {
    if (i >= rows) break;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int q = lane + 32 * c;
      if (q < R) d_ut[(int64_t)(row0 + i) * R + q] = -acc[i][c];
    }
  }
}

// The node-level products, a block per BR = proj_block_rows(R) rows of the
// source rows, then of the target rows (as project_rows): d_o = d_u W1^T
// (4 x 4 outputs a thread, W1^T staged in shared memory), and the block's
// share of d_W1 = o^T d_u over its rows (each thread one or more 4 x 4
// tiles of d_W1, over all the rows, or over a slice of them whose sums
// are then added in slice order) and, source blocks, of d_b1 = sum d_u.
// Writes npart[blockIdx] = (d_W1 share row-major, d_b1 share).
constexpr int NODE_RED = 4096;   // floats of the slice sums

size_t node_smem(int R) {
  const int R4 = dgmc::proj_r4(R), BR = dgmc::proj_block_rows(R);
  return sizeof(float) *
         ((size_t)R4 * (R4 + 4) + 2 * (size_t)BR * dgmc::tile_ld(R) +
          NODE_RED);
}

__global__ void __launch_bounds__(dgmc::PROJ_THREADS)
sc_bwd_nodes(const float* __restrict__ o_s, const float* __restrict__ o_t,
             const float* __restrict__ d_us, const float* __restrict__ d_ut,
             const float* __restrict__ w1, float* __restrict__ d_os,
             float* __restrict__ d_ot, float* __restrict__ npart,
             int rows_s, int rows_t, int R, int tiles_s) {
  constexpr int NT = dgmc::PROJ_THREADS;
  extern __shared__ float4 node_smem4[];
  const int R4 = dgmc::proj_r4(R), cols = dgmc::proj_cols(R);
  const int BR = dgmc::proj_block_rows(R), LD = dgmc::tile_ld(R);
  float* swt = reinterpret_cast<float*>(node_smem4);   // [R4][R4+4] W1^T
  float* sd = swt + R4 * (R4 + 4);                     // [BR][LD] d_u
  float* so = sd + BR * LD;                            // [BR][LD] o
  float* red = so + BR * LD;                           // [NODE_RED]
  const bool src = (int)blockIdx.x < tiles_s;
  const int r0 = (src ? blockIdx.x : blockIdx.x - tiles_s) * BR;
  const int rows = src ? rows_s : rows_t;
  const int n = rows - r0 < BR ? rows - r0 : BR;
  const int tid = threadIdx.x;
  dgmc::copy_rows_async((src ? d_us : d_ut) + (int64_t)r0 * R, sd, n, BR,
                        R, LD, tid, NT);
  dgmc::copy_rows_async((src ? o_s : o_t) + (int64_t)r0 * R, so, n, BR, R,
                        LD, tid, NT);
  dgmc::stage_w_transposed(w1, swt, R, R4 + 4, tid, NT);
  dgmc::cp_wait_all();
  __syncthreads();

  // d_o[row][r] = sum_q d_u[row][q] W1[r][q], q in order.
  const int tx = tid % cols, ty = tid / cols;
  if (ty * 4 < BR) {
    float acc[4][4] = {};
    dgmc::tile_product(sd, LD, swt, R4 + 4, ty * 4, tx * 4, R4, acc);
    float* d_o = (src ? d_os : d_ot) + (int64_t)r0 * R;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      if (row >= n) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx * 4 + j < R) d_o[(int64_t)row * R + tx * 4 + j] = acc[i][j];
    }
  }

  // d_W1[r][q] share: sum over rows of o[row][r] d_u[row][q].
  const int side = R4 / 4, tiles = side * side;
  const int cols_all = R * R + R;
  float* p = npart + (int64_t)blockIdx.x * cols_all;
  if (tiles >= NT) {
    for (int t = tid; t < tiles; t += NT) {
      const int tr = t / side, tq = t - tr * side;
      float acc[4][4] = {};
#pragma unroll 4
      for (int row = 0; row < BR; ++row) {
        const float4 a = *reinterpret_cast<const float4*>(so + row * LD +
                                                          tr * 4);
        const float4 d = *reinterpret_cast<const float4*>(sd + row * LD +
                                                          tq * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tr * 4 + i < R && tq * 4 + j < R)
            p[(tr * 4 + i) * R + tq * 4 + j] = acc[i][j];
    }
  } else {
    // Fewer tiles than threads: slice the rows, then add the slices.
    const int slices = NT / tiles;
    const int len = (BR + slices - 1) / slices;
    const int t = tid % tiles, sl = tid / tiles;
    const int tr = t / side, tq = t - tr * side;
    float acc[4][4] = {};
    if (sl < slices) {
      const int end = min(BR, (sl + 1) * len);
#pragma unroll 4
      for (int row = sl * len; row < end; ++row) {
        const float4 a = *reinterpret_cast<const float4*>(so + row * LD +
                                                          tr * 4);
        const float4 d = *reinterpret_cast<const float4*>(sd + row * LD +
                                                          tq * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[(sl * tiles + t) * 16 + i * 4 + j] =
            acc[i][j];
    }
    __syncthreads();
    for (int e = tid; e < tiles * 16; e += NT) {
      const int t2 = e / 16, i = (e / 4) % 4, j = e % 4;
      const int r = (t2 / side) * 4 + i, q = (t2 % side) * 4 + j;
      float s = 0.0f;
      for (int v = 0; v < slices; ++v)
        s += red[(v * tiles + t2) * 16 + 4 * i + j];
      if (r < R && q < R) p[r * R + q] = s;
    }
  }
  // d_b1 share: the source rows' d_u summed in row order.
  for (int q = tid; q < R; q += NT) {
    float s = 0.0f;
    if (src) {
#pragma unroll 8
      for (int row = 0; row < BR; ++row) s += sd[row * LD + q];
    }
    p[R * R + q] = s;
  }
}

// out[c] = sum over the rows of partial [rows, cols], in row order within
// each of the RED_WARPS warps' strided shares, then in warp order. Blocks
// [0, blocks_a) reduce a into out_a, the others b into out_b.
__global__ void sc_reduce(const float* __restrict__ a,
                          float* __restrict__ out_a, int rows_a, int cols_a,
                          int blocks_a, const float* __restrict__ b,
                          float* __restrict__ out_b, int rows_b, int cols_b) {
  __shared__ float red[RED_WARPS][33];
  const bool first = (int)blockIdx.x < blocks_a;
  const float* partial = first ? a : b;
  float* out = first ? out_a : out_b;
  const int rows = first ? rows_a : rows_b, cols = first ? cols_a : cols_b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (first ? blockIdx.x : blockIdx.x - blocks_a) * 32 + lane;
  float s = 0.0f;
  if (col < cols) {
#pragma unroll 8
    for (int j = warp; j < rows; j += RED_WARPS)
      s += partial[(int64_t)j * cols + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.0f;
    for (int v = 0; v < RED_WARPS; ++v) t += red[v][lane];
    out[col] = t;
  }
}

bool bad_shape(int B, int N_s, int N_t, int K, int R) {
  return B < 1 || N_s < 1 || N_t < 1 || K < 1 || R < 1 || R > R_MAX ||
         (int64_t)B * N_s * K > INT32_MAX || (int64_t)B * N_t > INT32_MAX;
}

template <int NC>
int cand_blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sc_bwd_cand<NC>, THREADS, 0);
  return err == cudaSuccess ? n : -(int)err;
}

// f(std::integral_constant<int, NC>()) for NC = ceil(R / 32), 1 <= R <=
// R_MAX: each kernel is built for each channel count a lane may hold.
template <class F>
int with_nc(int R, F&& f) {
  switch ((R + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    default: return f(std::integral_constant<int, 4>());
  }
}

template <int NC>
int fwd_nc(const float* u_s, const float* u_t, const int* idx,
           const float* w2, const float* b2, float* out, unsigned* mask,
           int rows, int N_s, int N_t, int K, int R, cudaStream_t st) {
  sc_fwd<NC><<<(rows + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      u_s, u_t, idx, w2, b2, out, mask, rows, N_s, N_t, K, R);
  return (int)cudaGetLastError();
}

template <int NC>
int bwd_nc(const float* o_s, const float* o_t, const int* idx,
           const float* w1, const float* w2, const float* g,
           const unsigned* mask, const int* order, const int4* chunk_map,
           const int* chunk_start,
           const float* u_s, const float* u_t, float* d_us, float* d_ut,
           float* d_os, float* d_ot, float* tgt_partial, float* wpart,
           float* npart, float* grads, int rows_s, int rows_t, int N_s,
           int N_t, int K, int R, int n_chunks, int src_blocks,
           int chunk_blocks, cudaStream_t st) {
  cudaError_t err;
  sc_bwd_cand<NC><<<src_blocks + chunk_blocks, THREADS, 0, st>>>(
      u_s, u_t, idx, w2, g, mask, order, chunk_map, d_us, tgt_partial, wpart,
      rows_s, N_s, N_t, K, R, src_blocks, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int tgt_rows = WARPS * TGT_PER_WARP;
  sc_bwd_tgt<NC><<<(rows_t + tgt_rows - 1) / tgt_rows, THREADS, 0, st>>>(
      tgt_partial, chunk_start, d_ut, rows_t, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int BR = dgmc::proj_block_rows(R);
  const int tiles_s = (rows_s + BR - 1) / BR;
  const int node_blocks = tiles_s + (rows_t + BR - 1) / BR;
  const size_t smem = node_smem(R);
  err = cudaFuncSetAttribute(sc_bwd_nodes,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  sc_bwd_nodes<<<node_blocks, dgmc::PROJ_THREADS, smem, st>>>(
      o_s, o_t, d_us, d_ut, w1, d_os, d_ot, npart, rows_s, rows_t, R,
      tiles_s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int cols_a = R * R + R;
  const int blocks_a = (cols_a + 31) / 32;
  sc_reduce<<<blocks_a + (R + 1 + 31) / 32, 32 * RED_WARPS, 0, st>>>(
      npart, grads, node_blocks, cols_a, blocks_a, wpart, grads + cols_a,
      src_blocks, R + 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dgmc_sc_r_max() { return R_MAX; }
// Rows per block of the backward's node pass (and of project_rows).
int dgmc_sc_node_rows(int R) { return dgmc::proj_block_rows(R); }

// Blocks of the backward's candidate kernel that fit on one SM at this R,
// or minus a CUDA error.
int dgmc_sc_bwd_blocks_per_sm(int R, int device) {
  if (R < 1 || R > R_MAX) return -(int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    return with_nc(R, [](auto nc) {
      return cand_blocks_per_sm<decltype(nc)::value>();
    });
  });
}

// o_s [B, N_s, R], o_t [B, N_t, R], idx [B, N_s, K] int32 in [0, N_t)
// (unchecked), w1 [R, R], b1 [R], w2 [R], b2 [1]: float32, contiguous.
// Writes u_s [B, N_s, R], u_t [B, N_t, R] (the factored form's node rows,
// which the backward takes), out [B, N_s, K] and, unless mask is null,
// the ReLU mask [B*N_s*K][ceil(R / 32)] (uint32 words, for the backward).
// Launches on `stream` on `device`, does not synchronize, restores the
// calling thread's current device, returns the first CUDA error.
int dgmc_sc_fwd_f32(const float* o_s, const float* o_t, const int* idx,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, float* u_s, float* u_t, float* out,
                    unsigned* mask, int B, int N_s, int N_t, int K, int R,
                    int device, void* stream) {
  if (bad_shape(B, N_s, N_t, K, R)) return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    const int rows = B * N_s;
    cudaError_t err = dgmc::project(o_s, o_t, w1, b1, u_s, u_t, rows,
                                    (int64_t)B * N_t, R, st);
    if (err != cudaSuccess) return (int)err;
    return with_nc(R, [&](auto nc) {
      return fwd_nc<decltype(nc)::value>(u_s, u_t, idx, w2, b2, out, mask,
                                         rows, N_s, N_t, K, R, st);
    });
  });
}

// o_s, o_t, idx, w1 and w2 as the forward's, plus g [B, N_s, K] (dL/d
// delta) and the shortlist's receiver order: order [B*N_s*K] int32 slot
// ids sorted by (b, target); chunk_map [n_chunks, 4] int32, one (target
// row, first position in order, slots, unused) per chunk of a target's
// list, (-1, 0, 0, 0) past the last; chunk_start [B*N_t + 1] int32, each
// target's first chunk. u_s, u_t and mask [B*N_s*K][ceil(R / 32)]
// (uint32) are the forward's (dgmc_sc_fwd_f32 with a mask). Scratch: d_us
// [B*N_s, R], d_ut [B*N_t, R], tgt_partial [n_chunks, R], wpart
// [src_blocks, R + 1] and npart [node_blocks, R*R + R], node_blocks =
// ceil(B*N_s / BR) + ceil(B*N_t / BR), BR = dgmc_sc_node_rows(R);
// src_blocks, chunk_blocks >= 1 (the wrapper's launch plan). Writes d_os
// [B, N_s, R], d_ot [B, N_t, R] and grads [R*R + 2R + 1] (d_W1 row-major,
// d_b1, d_w2, d_b2).
int dgmc_sc_bwd_f32(const float* o_s, const float* o_t, const int* idx,
                    const float* w1, const float* w2, const float* g,
                    const int* order, const int* chunk_map,
                    const int* chunk_start, const float* u_s,
                    const float* u_t, const unsigned* mask, float* d_us,
                    float* d_ut, float* d_os, float* d_ot,
                    float* tgt_partial, float* wpart, float* npart,
                    float* grads, int B, int N_s, int N_t,
                    int K, int R, int n_chunks, int src_blocks,
                    int chunk_blocks, int device, void* stream) {
  if (bad_shape(B, N_s, N_t, K, R) || n_chunks < 1 || src_blocks < 1 ||
      chunk_blocks < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    const int rows_s = B * N_s, rows_t = B * N_t;
    const auto map = reinterpret_cast<const int4*>(chunk_map);
    return with_nc(R, [&](auto nc) {
      return bwd_nc<decltype(nc)::value>(
          o_s, o_t, idx, w1, w2, g, mask, order, map, chunk_start, u_s, u_t,
          d_us, d_ut, d_os, d_ot, tgt_partial, wpart, npart, grads, rows_s,
          rows_t, N_s, N_t, K, R, n_chunks, src_blocks, chunk_blocks, st);
    });
  });
}

}  // extern "C"
