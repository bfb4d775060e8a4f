// SplineConv routing and masked-mean aggregation for Hopper (sm_90a),
// float32: the forward and its transpose (the gradient w.r.t. t).
//
// Replaces dgmc_tpu/ops/pallas/spline.py::_fwd_kernel and ::_bwd_kernel
// (behind route_aggregate). With t [B, M, O] the node features through all
// K^D kernel matrices (M = N * K^D), flat / basis [B, E, A] the A = 2^D
// active (sender, knot) rows of each edge and their B-spline weights:
//
//   forward  out[b,n,:] = sum_{e: rcv_e = n, mask_e} sum_a
//                          basis[b,e,a] * t[b, flat[b,e,a], :] / max(deg_n, 1)
//   backward d_t[b,m,:] = sum_{(e,a): flat[b,e,a] = m, mask_e}
//                          basis[b,e,a] * g[b, rcv_e, :] / max(deg_rcv_e, 1)
//
// Bound on the H100: bytes. Each output row costs 2 operations per gathered
// float, so the work is a gather of the touched t rows (forward) or a read
// of g and a write of the whole d_t (backward) at 3.35 TB/s.
//
// Design. The TPU kernel builds one-hot routing matrices in VMEM and
// accumulates over M tiles with += in grid order, which only a sequential
// grid allows. Here every output row is owned by one group of threads
// (each thread 4 neighbouring channels through 16-byte loads and stores
// where O % 4 == 0, blockDim.y rows per block) that walks a CSR list in a
// fixed order: receiver-sorted edges for the forward,
// flat-sorted (e, a) slots for the backward. The wrapper builds both lists
// with a stable sort (index preprocessing). Masked edges sort into a
// sentinel segment past the last row and are never read. Every sum runs in
// one order with no atomics, so repeats are bit-identical. Edge metadata
// reads are the same address across a row's threads (broadcasts); the t
// and g rows are read with neighbouring threads on neighbouring channels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;

// V consecutive channels per thread: 4 (16-byte loads and stores) when
// O % 4 == 0 and the rows are 16-byte aligned, else 1.
template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

template <int V>
__global__ void route_fwd(const float* __restrict__ t,
                          const int64_t* __restrict__ flat,
                          const float* __restrict__ basis,
                          const int64_t* __restrict__ order,
                          const int64_t* __restrict__ offsets,
                          float* __restrict__ out, int64_t rows, int N,
                          int64_t M, int O, int A) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const int64_t b = r / N;
  const int64_t beg = offsets[r], end = offsets[r + 1];
  const float deg = fmaxf((float)(end - beg), 1.0f);
  const float* tb = t + b * M * O;
  for (int o = threadIdx.x * V; o < O; o += blockDim.x * V) {
    float acc[V] = {};
    for (int64_t j = beg; j < end; ++j) {
      const int64_t e = order[j];           // edge id in the flat batch
      float msg[V] = {};
      for (int a = 0; a < A; ++a) {
        const float w = basis[e * A + a];
        float x[V];
        load<V>(tb + flat[e * A + a] * O + o, x);
        for (int v = 0; v < V; ++v) msg[v] += w * x[v];
      }
      for (int v = 0; v < V; ++v) acc[v] += msg[v];
    }
    for (int v = 0; v < V; ++v) acc[v] = acc[v] / deg;
    store<V>(out + r * O + o, acc);
  }
}

template <int V>
__global__ void route_dt(const float* __restrict__ g,
                         const int64_t* __restrict__ receivers,
                         const float* __restrict__ basis,
                         const int64_t* __restrict__ slot_order,
                         const int64_t* __restrict__ slot_offsets,
                         const int64_t* __restrict__ rcv_offsets,
                         float* __restrict__ d_t, int64_t rows, int N,
                         int64_t M, int O, int A) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const int64_t b = r / M;
  const int64_t beg = slot_offsets[r], end = slot_offsets[r + 1];
  for (int o = threadIdx.x * V; o < O; o += blockDim.x * V) {
    float acc[V] = {};
    for (int64_t j = beg; j < end; ++j) {
      const int64_t s = slot_order[j];      // (edge, a) slot in the batch
      const int64_t node = b * N + receivers[s / A];
      const float deg =
          fmaxf((float)(rcv_offsets[node + 1] - rcv_offsets[node]), 1.0f);
      const float w = basis[s];
      float x[V];
      load<V>(g + node * O + o, x);
      for (int v = 0; v < V; ++v) acc[v] += w * (x[v] / deg);
    }
    store<V>(d_t + r * O + o, acc);
  }
}

// A row group of `tpr` threads (a power of two up to THREADS) covers the
// O / V vectors of a row in one pass up to O = 256 V; a block holds
// THREADS / tpr rows.
dim3 block_of(int O, int V) {
  int tpr = 1;
  while (tpr < (O + V - 1) / V && tpr < THREADS) tpr *= 2;
  return dim3(tpr, THREADS / tpr);
}

unsigned grid_of(int64_t rows, const dim3& block) {
  return (unsigned)((rows + block.y - 1) / block.y);
}

int vec_width(int O, const void* a, const void* b) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  return (O % 4 == 0 && bits % 16 == 0) ? 4 : 1;
}

}  // namespace

extern "C" {

// t [B, M, O] float32; flat [B, E, A] int64 (< M); basis [B, E, A]
// float32; order [B*E] int64 edge ids sorted by (b, receiver) with masked
// edges last; offsets [B*N + 1] int64 CSR bounds into order. Writes out
// [B, N, O]. Launches on `stream` on `device`, does not synchronize,
// restores the calling thread's current device, returns cudaGetLastError().
int dgmc_spline_route_fwd_f32(const float* t, const int64_t* flat,
                              const float* basis, const int64_t* order,
                              const int64_t* offsets, float* out, int B,
                              int N, long long M, int O, int A, int device,
                              void* stream) {
  if (B < 1 || N < 1 || M < 1 || O < 1 || A < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const int64_t rows = (int64_t)B * N;
    const int V = vec_width(O, t, out);
    const dim3 block = block_of(O, V);
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    if (V == 4)
      route_fwd<4><<<grid_of(rows, block), block, 0, st>>>(
          t, flat, basis, order, offsets, out, rows, N, M, O, A);
    else
      route_fwd<1><<<grid_of(rows, block), block, 0, st>>>(
          t, flat, basis, order, offsets, out, rows, N, M, O, A);
    return (int)cudaGetLastError();
  });
}

// g [B, N, O] float32; receivers [B, E] int64; basis [B, E, A] float32;
// slot_order [B*E*A] int64 slot ids sorted by (b, flat) with masked slots
// last; slot_offsets [B*M + 1] int64; rcv_offsets [B*N + 1] int64 (the
// forward's receiver CSR bounds, for the degrees). Writes every row of
// d_t [B, M, O] (zeros where no slot points).
int dgmc_spline_route_dt_f32(const float* g, const int64_t* receivers,
                             const float* basis, const int64_t* slot_order,
                             const int64_t* slot_offsets,
                             const int64_t* rcv_offsets, float* d_t, int B,
                             int N, long long M, int O, int A, int device,
                             void* stream) {
  if (B < 1 || N < 1 || M < 1 || O < 1 || A < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const int64_t rows = (int64_t)B * M;
    const int V = vec_width(O, g, d_t);
    const dim3 block = block_of(O, V);
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    if (V == 4)
      route_dt<4><<<grid_of(rows, block), block, 0, st>>>(
          g, receivers, basis, slot_order, slot_offsets, rcv_offsets, d_t,
          rows, N, M, O, A);
    else
      route_dt<1><<<grid_of(rows, block), block, 0, st>>>(
          g, receivers, basis, slot_order, slot_offsets, rcv_offsets, d_t,
          rows, N, M, O, A);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
