// Sparse consensus delta for Hopper (sm_90a), float32 or bfloat16 inputs:
// forward and backward.
//
// Replaces dgmc_tpu/ops/pallas/sparse_consensus.py::_fwd_kernel and
// ::_bwd_kernel (behind fused_candidate_delta and sparse_consensus_delta):
//
//   delta[b,s,k] = relu((o_s[b,s] - o_t[b, idx[b,s,k]]) @ W1 + b1) @ w2 + b2
//
// Form. The first layer is linear, so (o_s - o_t) @ W1 + b1 = u_s - u_t
// with u_s = o_s @ W1 + b1 and u_t = o_t @ W1 (the factored form that
// csrc/consensus.cu uses too). The per-candidate work is then
// relu(u_s[s] - u_t[idx]) . w2 + b2, about 3R operations per candidate
// instead of the 2R^2 of the direct form. The [B, N_s, K, R] candidate
// tensor never exists. Asked for the state its backward needs, the
// forward also writes the ReLU mask, one bit per candidate and channel
// (bit l of word c: pre > 0 in channel l + 32 c), and hands u_s and u_t
// over: the backward runs no projection, and its ReLU mask is the
// forward's.
//
// Forward, sc_fwd. A warp owns a source row. Its lanes split into groups
// of L lanes sized to R (L = the power of two >= R / 4, lane j of a group
// holding channels 4j..4j+3 as one 16-byte vector; R % 4 != 0 falls back
// to L = 32 lanes of ceil(R / 32) scalar channels), so one warp load
// covers 32 / L candidates: 4 at R = 32. A row's candidate indices come
// in with one read per lane; all of its candidate rows are then loaded
// (up to 8 rounds of 32 / L) before any is used, each group's dot product
// ends in log2(L) XOR shuffles (3 at R = 32), and each candidate's mask
// word is the OR of its group's bits. Where the shortlist holds fewer
// candidates than there are target rows (B N_s K < B N_t: the serve and
// query shapes), the same kernel forms u_s and u_t itself from o_s, o_t
// and W1 staged in shared memory, one row per source row and one per
// candidate, and no projection of all target rows runs; elsewhere
// project_rows (csrc/project.cuh) forms u_s and u_t for every node row
// first. Both forms sum each u in one order (r = 0, 1, ..., then b1), so
// they agree bit for bit.
//
// bf16 inputs (the precision policy's variant, the *_bf16 entry points):
// o_s, o_t and the MLP's weights all bf16, u_s and u_t bf16 as
// project.cuh rounds them (half the bytes of every candidate row the
// kernels gather), pre = bf16(u_s - u_t) (the factored form's rounding:
// the JAX package's sparse path takes the direct form, which rounds
// elsewhere), and every sum in float32. The forward's delta is float32;
// the backward's gradients leave its float32 sums rounded to bf16 once
// (d_o_s and d_o_t by sc_bwd_nodes, the weights' by the wrapper). The
// touched-row form is float32 only (the serve path, which stays float32):
// bf16 always projects every row first.
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
// u products included, are about 0.1 GFLOP (1.5 us at 67 TFLOP/s). At a
// query's shapes (16 to 64 rows, K = 10, over 20000 targets) only the
// rows the shortlist touches count, under 0.1 MB. The backward's least
// work is that of the form that projects again: about 0.27 GFLOP
// (4.1 us) against 11 MB; given the forward's u it would read about
// 16 MB (4.7 us), more time than the product it saves. What limits both
// at the training shape is the random 128-byte u_t row per candidate
// (300000 at K = 20, 38 MB from L2): without the mask sc_fwd gathers
// them at about 3.7 TB/s. At a query's shapes it is the latency of two dependent reads (indices,
// then candidate rows) and of the projection. On an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py) the forward takes about 0.019 ms at
// K = 20 writing the ReLU mask (sc_fwd 0.013, project_rows 0.006) and
// 0.003 ms at a query's shapes, the backward about 0.048 ms. (One
// candidate at a time per warp, a dependent 128-byte load and a 5-step
// butterfly each, took 0.025 ms at K = 20 and 0.008 ms at a query's
// shapes, where the projection of all 20000 target rows came first.
// Forming u_s in the candidate kernel at the training shape, in place of
// project_rows, measured slower.)

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "launch.cuh"
#include "project.cuh"

namespace {

constexpr int WARPS = 8;                 // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int R_MAX = 128;
constexpr int RED_WARPS = 32;            // warps per block of sc_reduce
constexpr int TGT_PER_WARP = 4;          // target rows per warp of sc_bwd_tgt
constexpr int PROJ_WARPS = 2;            // warps per block of sc_fwd projecting
constexpr unsigned FULL = 0xffffffffu;

template <int NC, typename T>
__device__ __forceinline__ void load_row(const T* row, int R, int lane,
                                         float (&x)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q = lane + 32 * c;
    x[c] = q < R ? dgmc::to_f(row[q]) : 0.0f;
  }
}

// The same, each element kept in its dtype.
template <int NC, typename T>
__device__ __forceinline__ void load_raw(const T* row, int R, int lane,
                                         T (&x)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q = lane + 32 * c;
    x[c] = q < R ? row[q] : dgmc::from_f<T>(0.0f);
  }
}

// The forward's channel layout: a group of L lanes holds one row of R
// channels, lane j of the group J vectors of V channels, channel
// (i L + j) V + v in element [i][v] (V = 4 with J = 1, or V = 1 with L =
// 32). Rows are read and written through it, zero past R.
template <int V, int L, int J>
struct Piece {
  static constexpr int G = 32 / L;          // rows (candidates) a warp load
  static constexpr int CS = J * L * V;      // channels a group spans
  float x[J][V];

  __device__ __forceinline__ static int ch(int j, int i, int v) {
    return (i * L + j) * V + v;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) x[i][v] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* row, int R, int j) {
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int c = ch(j, i, 0);
      if constexpr (V == 4) {
        const float4 q = c < R ? *reinterpret_cast<const float4*>(row + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        x[i][0] = q.x; x[i][1] = q.y; x[i][2] = q.z; x[i][3] = q.w;
      } else {
        x[i][0] = c < R ? row[c] : 0.0f;
      }
    }
  }
  // bf16 rows, widened: V = 4 reads 8 bytes a lane.
  __device__ __forceinline__ void load(const dgmc::bf16* row, int R, int j) {
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int c = ch(j, i, 0);
      if constexpr (V == 4) {
        uint2 q = make_uint2(0u, 0u);
        if (c < R) q = *reinterpret_cast<const uint2*>(row + c);
        const __nv_bfloat162 lo =
            *reinterpret_cast<const __nv_bfloat162*>(&q.x);
        const __nv_bfloat162 hi =
            *reinterpret_cast<const __nv_bfloat162*>(&q.y);
        x[i][0] = __bfloat162float(lo.x); x[i][1] = __bfloat162float(lo.y);
        x[i][2] = __bfloat162float(hi.x); x[i][3] = __bfloat162float(hi.y);
      } else {
        x[i][0] = c < R ? __bfloat162float(row[c]) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store(float* row, int R, int j) const {
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int c = ch(j, i, 0);
      if (c >= R) continue;
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
      else
        row[c] = x[i][0];
    }
  }
};

// Each u[k] = xs[k] times W1, for the N rows xs[k] (row k held as a
// Piece by each group's lanes): element (i, v) of u[k] is the sum over r,
// in order, of row[r] W1[r][channel] (fmaf), as project_rows sums (the
// channels past R hold zeros, whose products leave a sum unchanged). sw:
// W1 in shared memory, [CS][CS] row-major, zero past R. One W1 vector a
// lane and r serves all N rows, whose N sums are independent chains.
template <int V, int L, int J, int N>
__device__ __forceinline__ void project(const Piece<V, L, J> (&xs)[N],
                                        const float* sw, int lane,
                                        Piece<V, L, J> (&u)[N]) {
  using P = Piece<V, L, J>;
  const int base = lane & ~(L - 1), j = lane & (L - 1);
#pragma unroll
  for (int k = 0; k < N; ++k) u[k].zero();
#pragma unroll
  for (int i2 = 0; i2 < J; ++i2)
#pragma unroll
    for (int jj = 0; jj < L; ++jj)
#pragma unroll
      for (int v2 = 0; v2 < V; ++v2) {
        const float* wr = sw + ((i2 * L + jj) * V + v2) * P::CS;
        float w[J][V];
#pragma unroll
        for (int i = 0; i < J; ++i) {
          if constexpr (V == 4) {
            const float4 q =
                *reinterpret_cast<const float4*>(wr + P::ch(j, i, 0));
            w[i][0] = q.x; w[i][1] = q.y; w[i][2] = q.z; w[i][3] = q.w;
          } else {
            w[i][0] = wr[P::ch(j, i, 0)];
          }
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float xr = __shfl_sync(FULL, xs[k].x[i2][v2], base + jj);
#pragma unroll
          for (int i = 0; i < J; ++i)
#pragma unroll
            for (int v = 0; v < V; ++v)
              u[k].x[i][v] = fmaf(xr, w[i][v], u[k].x[i][v]);
        }
      }
}

// Transposed reduction over the L lanes of a group of N values a lane
// (N <= L, both powers of two; Op: + or |): after log2(N) halving steps
// (masks L/2 ... L/N: a lane keeps half its values and adds its partner's
// copy of them) and log2(L/N) plain ones, v[0] of lane j holds value j /
// (L / N) summed over the group, in a fixed order. N - 1 + log2(L/N)
// shuffles instead of N log2(L).
template <int L, int N, class T, class Op>
__device__ __forceinline__ T transpose_reduce(T (&v)[N], int lane, Op op) {
#pragma unroll
  for (int n = N, m = L / 2; n > 1; n >>= 1, m >>= 1) {
    const bool hi = lane & m;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const T send = hi ? v[i] : v[i + n / 2];
      const T keep = hi ? v[i + n / 2] : v[i];
      v[i] = op(keep, __shfl_xor_sync(FULL, send, m));
    }
  }
#pragma unroll
  for (int m = L / N / 2; m > 0; m >>= 1)
    v[0] = op(v[0], __shfl_xor_sync(FULL, v[0], m));
  return v[0];
}

// delta and (MASK) the ReLU mask [rows * K][ceil(R / 32)] words. Warps
// walk source rows row, row + stride, ...
// PROJ = false: x_s, x_t are u_s, u_t (project_rows formed them); each
// row's first 32 indices and its u_s row are loaded while the row before
// is reduced.
// PROJ = true: x_s, x_t are o_s, o_t; the grid covers the rows (a warp
// each). Each block stages W1 in shared memory by cp.async while its
// warps load their first candidate rows; each warp then forms its row's
// u_s and each candidate's u_t itself (the row with the first batch of
// candidates, in one pass over W1), writing them into st_s / st_t where
// those are not null (the backward's state; a target row in several
// lists gets the same bits from each). PROJ is built for float only.
// T: the dtype of x_s, x_t and the weights; pre rounds through it.
template <typename T, int V, int L, int J, bool PROJ, bool MASK, int RBMAX>
__global__ void __launch_bounds__(THREADS)
sc_fwd(const T* __restrict__ x_s, const T* __restrict__ x_t,
       const int* __restrict__ idx, const T* __restrict__ w1,
       const T* __restrict__ b1, const T* __restrict__ w2,
       const T* __restrict__ b2, float* __restrict__ out,
       unsigned* __restrict__ mask, T* __restrict__ st_s,
       T* __restrict__ st_t, int rows, int N_s, int N_t, int K, int R) {
  using P = Piece<V, L, J>;
  constexpr int G = P::G;
  // A window of 32 candidates is 32 / G = L rounds of G; RB rounds are in
  // flight at once, their sums and mask words reduced together (RBMAX: 4
  // where K <= 16 or each candidate row is projected, K = 10 being 3
  // rounds at R = 32, else 8). A mask word spans LM lanes.
  constexpr int RB = L < RBMAX ? L : RBMAX;
  constexpr int LM = L < 8 ? L : 8;
  extern __shared__ float4 fwd_smem4[];
  float* sw = reinterpret_cast<float*>(fwd_smem4);   // [CS][CS] W1
  if constexpr (PROJ)
    dgmc::copy_rows_async(w1, sw, R, P::CS, R, P::CS, threadIdx.x,
                          blockDim.x);
  const int lane = threadIdx.x & 31, j = lane & (L - 1), g = lane / L;
  const int warps = blockDim.x >> 5, stride = gridDim.x * warps;
  int row = blockIdx.x * warps + (threadIdx.x >> 5);
  int my_t = 0, tt[RB];
  P us, w, b, ut[RB];
  us.zero();
  // bf16 rows of 4 channels a lane stay as loaded (8 bytes): the
  // differences are formed in bf16x2 (rounded by the subtraction itself,
  // as rounding their float32 difference would), no conversion a channel.
  constexpr bool PACKED = !std::is_same<T, float>::value && V == 4;
  uint2 us_h = make_uint2(0u, 0u), ut_h[RB];
  auto load_h = [&](const T* row) {   // this lane's channels, 0 past R
    const int c = P::ch(j, 0, 0);
    return c < R ? *reinterpret_cast<const uint2*>(row + c)
                 : make_uint2(0u, 0u);
  };
  // Loads the candidate rows of rounds r0 ... r0 + RB - 1 of a window of
  // n candidates into ut (zeros past n).
  auto load_batch = [&](int64_t tb, int r0, int n) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      const int slot = (r0 + rr) * G + g;
      tt[rr] = __shfl_sync(FULL, my_t, slot & 31);
      if constexpr (PACKED)
        ut_h[rr] = slot < n ? load_h(x_t + tb + (int64_t)tt[rr] * R)
                            : make_uint2(0u, 0u);
      else if (slot < n)
        ut[rr].load(x_t + tb + (int64_t)tt[rr] * R, R, j);
      else
        ut[rr].zero();
    }
  };
  if (row < rows) {
    my_t = lane < K ? idx[(int64_t)row * K + lane] : 0;
    if constexpr (PACKED)
      us_h = load_h(x_s + (int64_t)row * R);
    else
      us.load(x_s + (int64_t)row * R, R, j);
  }
  w.load(w2, R, j);
  bool loaded = false;   // the batch to come is in ut already
  if constexpr (PROJ) {
    b.load(b1, R, j);
    if (row < rows) {
      load_batch((int64_t)(row / N_s) * N_t * R, 0, min(32, K));
      loaded = true;
    }
    dgmc::cp_wait_all();
    __syncthreads();
  }
  const float bias = dgmc::to_f(b2[0]);
  const int nc = (R + 31) / 32;
  // The lanes that store: the sum of round j / (L / RB) of a batch, and
  // word j / 8 of the mask of round (j % LM) / (LM / RB).
  const int r_sum = j / (L / RB), r_word = (j % LM) / (LM / RB);
  for (; row < rows; row += stride) {
    const int next = row + stride;
    int next_t = 0;
    P next_us;
    next_us.zero();
    uint2 next_us_h = make_uint2(0u, 0u);
    if (next < rows) {
      next_t = lane < K ? idx[(int64_t)next * K + lane] : 0;
      if constexpr (PACKED)
        next_us_h = load_h(x_s + (int64_t)next * R);
      else
        next_us.load(x_s + (int64_t)next * R, R, j);
    }
    const int64_t tb = (int64_t)(row / N_s) * N_t * R;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int n = min(32, K - k0);
      if (k0) my_t = lane < n ? idx[(int64_t)row * K + k0 + lane] : 0;
      const int64_t first = (int64_t)row * K + k0;
      for (int r0 = 0; r0 * G < n; r0 += RB) {
        // Every candidate row of the batch in flight before any use.
        if (!loaded) load_batch(tb, r0, n);
        loaded = false;
        if constexpr (PROJ) {
          if (k0 == 0 && r0 == 0) {   // the row's u_s with the first batch
            P xin[RB + 1], u[RB + 1];
#pragma unroll
            for (int rr = 0; rr < RB; ++rr) xin[rr] = ut[rr];
            xin[RB] = us;
            project(xin, sw, lane, u);
#pragma unroll
            for (int rr = 0; rr < RB; ++rr) ut[rr] = u[rr];
            us = u[RB];
#pragma unroll
            for (int i = 0; i < J; ++i)
#pragma unroll
              for (int v = 0; v < V; ++v) us.x[i][v] += b.x[i][v];
            if (st_s && g == 0) us.store(st_s + (int64_t)row * R, R, j);
          } else {
            P xin[RB];
#pragma unroll
            for (int rr = 0; rr < RB; ++rr) xin[rr] = ut[rr];
            project(xin, sw, lane, ut);
          }
          if (st_t)
#pragma unroll
            for (int rr = 0; rr < RB; ++rr)
              if ((r0 + rr) * G + g < n)
                ut[rr].store(st_t + tb + (int64_t)tt[rr] * R, R, j);
        }
        float acc[RB];
        unsigned bits[RB];
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          acc[rr] = 0.0f;
          bits[rr] = 0u;
          if ((r0 + rr) * G >= n) continue;   // warp-uniform: no candidate
          if constexpr (PACKED) {
            float h[4];
            dgmc::relu_diff4(us_h, ut_h[rr], h);
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc[rr] += h[v] * w.x[0][v];
              if constexpr (MASK)   // channels 4j..4j+3: bits of word j / 8
                bits[rr] |= (h[v] > 0.0f ? 1u : 0u) << ((4 * j + v) & 31);
            }
            continue;
          }
#pragma unroll
          for (int i = 0; i < J; ++i)
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float pre = dgmc::rnd<T>(us.x[i][v] - ut[rr].x[i][v]);
              acc[rr] += fmaxf(pre, 0.0f) * w.x[i][v];
              if constexpr (MASK && V == 4) {
                // channels 4j..4j+3: bits of word j / 8
                bits[rr] |= (pre > 0.0f ? 1u : 0u) << ((4 * j + v) & 31);
              } else if constexpr (MASK) {
                // L = 32: word i is the warp's ballot of element i
                const unsigned wd = __ballot_sync(FULL, pre > 0.0f);
                if (lane == i) mask[(first + r0 + rr) * nc + i] = wd;
              }
            }
        }
        const float sum = transpose_reduce<L, RB>(
            acc, lane, [](float a, float c) { return a + c; });
        const int slot = (r0 + r_sum) * G + g;
        if (slot < n && j % (L / RB) == 0) out[first + slot] = sum + bias;
        if constexpr (MASK && V == 4) {
          // OR over each LM lanes of one word.
          const unsigned wd = transpose_reduce<LM, RB>(
              bits, lane, [](unsigned a, unsigned c) { return a | c; });
          const int ws = (r0 + r_word) * G + g;
          if (ws < n && j % (LM / RB) == 0 && j / 8 < nc)
            mask[(first + ws) * nc + j / 8] = wd;
        }
      }
    }
    my_t = next_t;
    us = next_us;
    us_h = next_us_h;
  }
}

// Source blocks (blockIdx < src_blocks): warps walk source rows row =
// blockIdx * WARPS + warp, + src_blocks * WARPS, ...: d_u_s[s] = sum_k
// d_pre in k order into d_us; the block's share of d_w2 = sum g relu(pre)
// and d_b2 = sum g into wpart[blockIdx] (the warps' sums in warp order).
// Chunk blocks: one warp per chunk of the Shortlist's chunk map, the
// chunk's sum of d_pre into tgt_partial[c].
template <int NC, typename T>
__global__ void __launch_bounds__(THREADS)
sc_bwd_cand(const T* __restrict__ u_s, const T* __restrict__ u_t,
            const int* __restrict__ idx, const T* __restrict__ w2,
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
  // u rows stay in their dtype; each difference is rounded as the
  // forward's (sub_rounded: in bf16, no conversion a channel).
  float my_g = 0.0f;
  T us[NC] = {};
  if (row < rows_s) {
    if (lane < K) {
      my_t = idx[(int64_t)row * K + lane];
      my_g = g[(int64_t)row * K + lane];
    }
    load_raw(u_s + (int64_t)row * R, R, lane, us);
  }
  for (; row < rows_s; row += stride) {
    const int next = row + stride;
    int n_t = 0;
    float n_g = 0.0f, dus[NC] = {};
    T n_us[NC] = {};
    const T* ut_b = u_t + (int64_t)(row / N_s) * N_t * R;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int n = min(32, K - k0);
      if (k0) {   // K > 32: the next 32 candidates
        my_t = lane < n ? idx[(int64_t)row * K + k0 + lane] : 0;
        my_g = lane < n ? g[(int64_t)row * K + k0 + lane] : 0.0f;
      }
      for (int j0 = 0; j0 < n; j0 += U) {
        T ut[U][NC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = __shfl_sync(FULL, my_t, (j0 + u) & 31);
          if (j0 + u < n) load_raw(ut_b + (int64_t)t * R, R, lane, ut[u]);
        }
        if (k0 == 0 && j0 == 0 && next < rows_s) {
          if (lane < K) {
            n_t = idx[(int64_t)next * K + lane];
            n_g = g[(int64_t)next * K + lane];
          }
          load_raw(u_s + (int64_t)next * R, R, lane, n_us);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float gk = __shfl_sync(FULL, my_g, (j0 + u) & 31);
          if (j0 + u < n) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const float pre = dgmc::sub_rounded(us[c], ut[u][c]);
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

// T: the dtype of o_s, o_t, W1 and of d_o_s, d_o_t (rounded once).
template <typename T>
__global__ void __launch_bounds__(dgmc::PROJ_THREADS)
sc_bwd_nodes(const T* __restrict__ o_s, const T* __restrict__ o_t,
             const float* __restrict__ d_us, const float* __restrict__ d_ut,
             const T* __restrict__ w1, T* __restrict__ d_os,
             T* __restrict__ d_ot, float* __restrict__ npart,
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
    T* d_o = (src ? d_os : d_ot) + (int64_t)r0 * R;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      if (row >= n) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx * 4 + j < R)
          d_o[(int64_t)row * R + tx * 4 + j] = dgmc::from_f<T>(acc[i][j]);
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

template <int NC, typename T>
int cand_blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sc_bwd_cand<NC, T>, THREADS, 0);
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

// f(std::integral_constant<int, L>()) for the forward's lanes per
// candidate at R (R % 4 == 0): the power of two >= R / 4.
template <class F>
int with_lanes(int R, F&& f) {
  const int v = R / 4;
  if (v <= 1) return f(std::integral_constant<int, 1>());
  if (v <= 2) return f(std::integral_constant<int, 2>());
  if (v <= 4) return f(std::integral_constant<int, 4>());
  if (v <= 8) return f(std::integral_constant<int, 8>());
  if (v <= 16) return f(std::integral_constant<int, 16>());
  return f(std::integral_constant<int, 32>());
}

template <typename T, int V, int L, int J, bool MASK>
int fwd_launch(bool proj, const T* x_s, const T* x_t, const int* idx,
               const T* w1, const T* b1, const T* w2, const T* b2,
               float* out, unsigned* mask, T* st_s, T* st_t, int rows,
               int N_s, int N_t, int K, int R, int device, cudaStream_t st) {
  if (!proj) {
    // One block per WARPS rows, at most as many as the card holds at
    // once: the warps then walk the rows.
    const auto kernel = K > 16 ? sc_fwd<T, V, L, J, false, MASK, 8>
                               : sc_fwd<T, V, L, J, false, MASK, 4>;
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return (int)err;
    const int want = (rows + WARPS - 1) / WARPS;
    const int grid = want < per_sm * sms ? want : per_sm * sms;
    kernel<<<grid, THREADS, 0, st>>>(x_s, x_t, idx, w1, b1, w2, b2, out,
                                     mask, st_s, st_t, rows, N_s, N_t, K, R);
    return (int)cudaGetLastError();
  }
  // Few rows (a query's): small blocks, so that they spread over the SMs.
  // The touched-row form is built for float32 only (serving's dtype).
  if constexpr (!std::is_same<T, float>::value) {
    return (int)cudaErrorInvalidValue;
  } else {
    const auto kernel = sc_fwd<T, V, L, J, true, MASK, 4>;
    constexpr int CS = Piece<V, L, J>::CS;
    const size_t smem = sizeof(float) * CS * CS;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(rows + PROJ_WARPS - 1) / PROJ_WARPS, 32 * PROJ_WARPS, smem,
             st>>>(x_s, x_t, idx, w1, b1, w2, b2, out, mask, st_s, st_t,
                   rows, N_s, N_t, K, R);
    return (int)cudaGetLastError();
  }
}

template <typename T, int V, int L, int J>
int fwd_launch(bool proj, const T* x_s, const T* x_t, const int* idx,
               const T* w1, const T* b1, const T* w2, const T* b2,
               float* out, unsigned* mask, T* st_s, T* st_t, int rows,
               int N_s, int N_t, int K, int R, int device, cudaStream_t st) {
  return mask ? fwd_launch<T, V, L, J, true>(proj, x_s, x_t, idx, w1, b1,
                                             w2, b2, out, mask, st_s, st_t,
                                             rows, N_s, N_t, K, R, device,
                                             st)
              : fwd_launch<T, V, L, J, false>(proj, x_s, x_t, idx, w1, b1,
                                              w2, b2, out, mask, st_s, st_t,
                                              rows, N_s, N_t, K, R, device,
                                              st);
}

// True where every non-null pointer is aligned to `bytes`.
bool aligned(std::initializer_list<const void*> ptrs, size_t bytes) {
  for (const void* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % bytes) return false;
  return true;
}

template <int NC, typename T>
int bwd_nc(const T* o_s, const T* o_t, const int* idx, const T* w1,
           const T* w2, const float* g, const unsigned* mask,
           const int* order, const int4* chunk_map, const int* chunk_start,
           const T* u_s, const T* u_t, float* d_us, float* d_ut, T* d_os,
           T* d_ot, float* tgt_partial, float* wpart, float* npart,
           float* grads, int rows_s, int rows_t, int N_s, int N_t, int K,
           int R, int n_chunks, int src_blocks, int chunk_blocks,
           cudaStream_t st) {
  cudaError_t err;
  sc_bwd_cand<NC, T><<<src_blocks + chunk_blocks, THREADS, 0, st>>>(
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
  err = cudaFuncSetAttribute(sc_bwd_nodes<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  sc_bwd_nodes<T><<<node_blocks, dgmc::PROJ_THREADS, smem, st>>>(
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

template <typename T>
int sc_fwd_entry(const T* o_s, const T* o_t, const int* idx, const T* w1,
                 const T* b1, const T* w2, const T* b2, T* u_s, T* u_t,
                 float* out, unsigned* mask, int B, int N_s, int N_t, int K,
                 int R, int touched, int device, void* stream) {
  if (bad_shape(B, N_s, N_t, K, R) || (!touched && !(u_s && u_t)) ||
      (touched && !std::is_same<T, float>::value))
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    const int rows = B * N_s;
    const T* x_s = touched ? o_s : u_s;
    const T* x_t = touched ? o_t : u_t;
    if (!touched) {
      const cudaError_t err = dgmc::project<T>(o_s, o_t, w1, b1, u_s, u_t,
                                               rows, (int64_t)B * N_t, R,
                                               st);
      if (err != cudaSuccess) return (int)err;
    }
    T* st_s = touched ? u_s : nullptr;
    T* st_t = touched ? u_t : nullptr;
    if (R % 4 == 0 &&
        aligned({x_s, x_t, w2, b1, st_s, st_t}, 4 * sizeof(T)))
      return with_lanes(R, [&](auto l) {
        return fwd_launch<T, 4, decltype(l)::value, 1>(
            touched, x_s, x_t, idx, w1, b1, w2, b2, out, mask, st_s, st_t,
            rows, N_s, N_t, K, R, device, st);
      });
    return with_nc(R, [&](auto nc) {
      return fwd_launch<T, 1, 32, decltype(nc)::value>(
          touched, x_s, x_t, idx, w1, b1, w2, b2, out, mask, st_s, st_t, rows,
          N_s, N_t, K, R, device, st);
    });
  });
}

template <typename T>
int sc_bwd_entry(const T* o_s, const T* o_t, const int* idx, const T* w1,
                 const T* w2, const float* g, const int* order,
                 const int* chunk_map, const int* chunk_start, const T* u_s,
                 const T* u_t, const unsigned* mask, float* d_us,
                 float* d_ut, T* d_os, T* d_ot, float* tgt_partial,
                 float* wpart, float* npart, float* grads, int B, int N_s,
                 int N_t, int K, int R, int n_chunks, int src_blocks,
                 int chunk_blocks, int device, void* stream) {
  if (bad_shape(B, N_s, N_t, K, R) || n_chunks < 1 || src_blocks < 1 ||
      chunk_blocks < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    const int rows_s = B * N_s, rows_t = B * N_t;
    const auto map = reinterpret_cast<const int4*>(chunk_map);
    return with_nc(R, [&](auto nc) {
      return bwd_nc<decltype(nc)::value, T>(
          o_s, o_t, idx, w1, w2, g, mask, order, map, chunk_start, u_s, u_t,
          d_us, d_ut, d_os, d_ot, tgt_partial, wpart, npart, grads, rows_s,
          rows_t, N_s, N_t, K, R, n_chunks, src_blocks, chunk_blocks, st);
    });
  });
}

}  // namespace

extern "C" {

int dgmc_sc_r_max() { return R_MAX; }
// Rows per block of the backward's node pass (and of project_rows).
int dgmc_sc_node_rows(int R) { return dgmc::proj_block_rows(R); }

// Blocks of the backward's candidate kernel that fit on one SM at this R
// for float32 (bf16 = 0) or bfloat16 (bf16 = 1) inputs, or minus a CUDA
// error.
int dgmc_sc_bwd_blocks_per_sm(int R, int bf16, int device) {
  if (R < 1 || R > R_MAX) return -(int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    return with_nc(R, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      return bf16 ? cand_blocks_per_sm<NC, dgmc::bf16>()
                  : cand_blocks_per_sm<NC, float>();
    });
  });
}

// o_s [B, N_s, R], o_t [B, N_t, R], idx [B, N_s, K] int32 in [0, N_t)
// (unchecked), w1 [R, R], b1 [R], w2 [R], b2 [1]: all float32 (_f32) or
// all bfloat16 (_bf16), contiguous. Writes out [B, N_s, K] float32 and,
// unless mask is null, the ReLU mask [B*N_s*K][ceil(R / 32)] (uint32
// words, for the backward).
// touched = 0: project_rows forms u_s [B, N_s, R] and u_t [B, N_t, R]
// (the factored form's node rows in the inputs' dtype, which the backward
// takes) into u_s and u_t, both required, then sc_fwd reads them.
// touched = 1 (float32 only): sc_fwd forms u_s and the u_t of each
// candidate itself and, where u_s / u_t are not null, writes u_s and the
// u_t rows the shortlist touches (the caller zeroes the others). Launches
// on `stream` on `device`, does not synchronize, restores the calling
// thread's current device, returns the first CUDA error.
int dgmc_sc_fwd_f32(const float* o_s, const float* o_t, const int* idx,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, float* u_s, float* u_t, float* out,
                    unsigned* mask, int B, int N_s, int N_t, int K, int R,
                    int touched, int device, void* stream) {
  return sc_fwd_entry(o_s, o_t, idx, w1, b1, w2, b2, u_s, u_t, out, mask,
                      B, N_s, N_t, K, R, touched, device, stream);
}

int dgmc_sc_fwd_bf16(const void* o_s, const void* o_t, const int* idx,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, void* u_s, void* u_t, float* out,
                     unsigned* mask, int B, int N_s, int N_t, int K, int R,
                     int touched, int device, void* stream) {
  using T = dgmc::bf16;
  return sc_fwd_entry(
      static_cast<const T*>(o_s), static_cast<const T*>(o_t), idx,
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(u_s), static_cast<T*>(u_t), out, mask, B, N_s, N_t, K,
      R, touched, device, stream);
}

// o_s, o_t, idx, w1 and w2 as the forward's (one dtype), plus g
// [B, N_s, K] float32 (dL/d delta) and the shortlist's receiver order:
// order [B*N_s*K] int32 slot ids sorted by (b, target); chunk_map
// [n_chunks, 4] int32, one (target row, first position in order, slots,
// unused) per chunk of a target's list, (-1, 0, 0, 0) past the last;
// chunk_start [B*N_t + 1] int32, each target's first chunk. u_s, u_t and
// mask [B*N_s*K][ceil(R / 32)] (uint32) are the forward's (its entry point
// of the same dtype, with a mask). Scratch, float32: d_us [B*N_s, R],
// d_ut [B*N_t, R], tgt_partial [n_chunks, R], wpart [src_blocks, R + 1]
// and npart [node_blocks, R*R + R], node_blocks = ceil(B*N_s / BR) +
// ceil(B*N_t / BR), BR = dgmc_sc_node_rows(R); src_blocks, chunk_blocks
// >= 1 (the wrapper's launch plan). Writes d_os [B, N_s, R] and d_ot
// [B, N_t, R] in the inputs' dtype and grads [R*R + 2R + 1] float32
// (d_W1 row-major, d_b1, d_w2, d_b2).
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
  return sc_bwd_entry(o_s, o_t, idx, w1, w2, g, order, chunk_map,
                      chunk_start, u_s, u_t, mask, d_us, d_ut, d_os, d_ot,
                      tgt_partial, wpart, npart, grads, B, N_s, N_t, K, R,
                      n_chunks, src_blocks, chunk_blocks, device, stream);
}

int dgmc_sc_bwd_bf16(const void* o_s, const void* o_t, const int* idx,
                     const void* w1, const void* w2, const float* g,
                     const int* order, const int* chunk_map,
                     const int* chunk_start, const void* u_s,
                     const void* u_t, const unsigned* mask, float* d_us,
                     float* d_ut, void* d_os, void* d_ot,
                     float* tgt_partial, float* wpart, float* npart,
                     float* grads, int B, int N_s, int N_t,
                     int K, int R, int n_chunks, int src_blocks,
                     int chunk_blocks, int device, void* stream) {
  using T = dgmc::bf16;
  return sc_bwd_entry(
      static_cast<const T*>(o_s), static_cast<const T*>(o_t), idx,
      static_cast<const T*>(w1), static_cast<const T*>(w2), g, order,
      chunk_map, chunk_start, static_cast<const T*>(u_s),
      static_cast<const T*>(u_t), mask, d_us, d_ut, static_cast<T*>(d_os),
      static_cast<T*>(d_ot), tgt_partial, wpart, npart, grads, B, N_s, N_t,
      K, R, n_chunks, src_blocks, chunk_blocks, device, stream);
}

}  // extern "C"
