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
// that walks a CSR list in a fixed order (receiver-sorted edges for the
// forward, flat-sorted (e, a) slots for the backward), so every sum runs
// in one order with no atomics and repeats are bit-identical. The wrapper
// builds both lists with a stable sort (index preprocessing); masked
// edges sort into a sentinel segment past the last row and are never read.
//
// route_fwd: a group of threads per receiver row (each thread 4
// neighbouring channels through 16-byte loads and stores where O % 4 ==
// 0, blockDim.y rows per block); edge metadata reads are the same address
// across a row's threads (broadcasts).
//
// route_dt is bound by the write of d_t (B*M*O floats, most rows without a
// slot: on the dense training batch 0.875 slots a row, 73.5% of rows
// empty), so it is built to keep that write streaming:
//   - g_norm first divides each receiver's g row by max(deg, 1) once
//     (B*N*O divisions, against one per slot and channel otherwise, which
//     made the kernel issue-bound), into a scratch buffer; deg is read
//     from the receiver CSR offsets that route_fwd reads too;
//   - each slot is one 8-byte record in slot order (receiver node of the
//     flattened batch, basis weight), so a slot costs one record and one
//     g row instead of a chain of dependent int64 loads. slot_records
//     builds them, and the int32 row offsets, in one launch once per
//     routing and basis (the wrapper caches them);
//   - a warp owns 32 consecutive rows: one coalesced load of their 33
//     offsets, one coalesced copy of their records into shared memory
//     (handed out from there; a window with more than DT_CAP slots reads
//     the rest from global memory), then its lanes split into 32 / L row
//     groups of L lanes (L sized to O, two 16-byte vectors a lane), so at
//     O = 64 a warp covers four rows at once;
//   - a row without a slot stores its zeros at once, with streaming
//     (evict-first) 16-byte stores like every row of d_t.
// Each slot adds w * (g / deg) rounded as the plain version rounds it
// (division, product, sum; no contraction into an FMA), in slot order.

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
__device__ __forceinline__ void store_stream(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  else
    __stcs(p, x[0]);
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int DT_ROWS = 32;  // rows of d_t per warp
constexpr int DT_CAP = 128;  // slot records staged per warp
constexpr int DT_NV = 2;     // vectors per lane per pass

// The d_t kernel's slot records, a thread a slot: for slot j of the
// flat-sorted order, rec[j] = (b*N + receivers[b, e], bits of
// basis[b, e, a]) where order[j] = (b*E + e)*A + a; and the row offsets
// as int32.
__global__ void slot_records(const int64_t* __restrict__ order,
                             const int64_t* __restrict__ receivers,
                             const float* __restrict__ basis,
                             const int64_t* __restrict__ offsets,
                             int2* __restrict__ rec, int* __restrict__ off32,
                             int64_t S, int64_t n_off, int E, int A, int N) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < S) {
    const int64_t slot = order[j], e = slot / A;
    rec[j] = make_int2((int)((e / E) * N + receivers[e]),
                       __float_as_int(basis[slot]));
  }
  if (j < n_off) off32[j] = (int)offsets[j];
}

// gn[n, :] = g[n, :] / max(deg_n, 1) for the B*N receiver rows, deg_n
// from the receiver CSR offsets (V floats a thread; O % V == 0).
template <int V>
__global__ void g_norm(const float* __restrict__ g,
                       const int64_t* __restrict__ rcv_off,
                       float* __restrict__ gn, int64_t n, int O) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= n) return;
  const int64_t r = e / O;
  const float d = fmaxf((float)(rcv_off[r + 1] - rcv_off[r]), 1.0f);
  float x[V];
  load<V>(g + e, x);
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = __fdiv_rn(x[v], d);
  store<V>(gn + e, x);
}

template <int V>
__global__ void __launch_bounds__(THREADS)
route_dt(const float* __restrict__ gn, const int* __restrict__ rec,
         const int* __restrict__ offsets, float* __restrict__ d_t,
         int64_t rows, int O, int L) {
  __shared__ int staged[THREADS / 32][2 * DT_CAP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r0 =
      ((int64_t)blockIdx.x * (THREADS / 32) + warp) * DT_ROWS;
  if (r0 >= rows) return;
  const int nrows = rows - r0 < DT_ROWS ? (int)(rows - r0) : DT_ROWS;
  int beg = 0, end = 0;
  if (lane < nrows) {
    beg = offsets[r0 + lane];
    end = offsets[r0 + lane + 1];
  }
  const int s0 = __shfl_sync(FULL, beg, 0);
  const int n_staged = min(__shfl_sync(FULL, end, nrows - 1) - s0, DT_CAP);
  int* sr = staged[warp];
  for (int w = lane; w < 2 * n_staged; w += 32)
    sr[w] = rec[2 * (int64_t)s0 + w];
  __syncwarp();

  const int groups = 32 / L, sub = lane % L;
  const int nvec = O / V;
  for (int rr = lane / L; rr < DT_ROWS; rr += groups) {
    const int b_ = __shfl_sync(FULL, beg, rr);
    const int e_ = __shfl_sync(FULL, end, rr);
    if (rr >= nrows) continue;
    float* out = d_t + (r0 + rr) * O;
    for (int c0 = sub; c0 < nvec; c0 += L * DT_NV) {
      float acc[DT_NV][V] = {};
      for (int j = b_; j < e_; ++j) {
        const int* r = j - s0 < DT_CAP ? sr + 2 * (j - s0)
                                       : rec + 2 * (int64_t)j;
        const float* gr = gn + (int64_t)r[0] * O;
        const float w = __int_as_float(r[1]);
        float x[DT_NV][V];
#pragma unroll
        for (int u = 0; u < DT_NV; ++u) {
          const int c = c0 + u * L;
          if (c < nvec) {
            load<V>(gr + c * V, x[u]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) x[u][v] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < DT_NV; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[u][v] = __fadd_rn(acc[u][v], __fmul_rn(w, x[u][v]));
      }
#pragma unroll
      for (int u = 0; u < DT_NV; ++u) {
        const int c = c0 + u * L;
        if (c < nvec) store_stream<V>(out + c * V, acc[u]);
      }
    }
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

// order [S] int64 slot ids (b*E + e)*A + a sorted by (b, flat) with
// masked slots last; receivers [B, E] int64; basis [B, E, A] float32;
// offsets [n_off] int64 CSR bounds into order. Writes rec [S, 2] int32
// (receiver node b*N + rcv, basis weight bits) and off32 [n_off] int32.
int dgmc_spline_slot_records(const int64_t* order, const int64_t* receivers,
                             const float* basis, const int64_t* offsets,
                             int* rec, int* off32, long long S,
                             long long n_off, int E, int A, int N,
                             int device, void* stream) {
  if (S < 0 || n_off < 1 || A < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const long long n = S > n_off ? S : n_off;
    const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    slot_records<<<grid, THREADS, 0, st>>>(order, receivers, basis, offsets,
                                           reinterpret_cast<int2*>(rec),
                                           off32, S, n_off, E, A, N);
    return (int)cudaGetLastError();
  });
}

// g [B, N, O] float32; rec [S, 2] int32 slot records in the slot order
// of the flat-sorted CSR list (receiver node b*N + rcv, basis weight
// bits); offsets [B*M + 1] int32 row bounds into rec; rcv_off [B*N + 1]
// int64 receiver CSR bounds (deg = rcv_off[n+1] - rcv_off[n]); gn
// [B, N, O] float32 scratch. Writes every row of d_t [B, M, O] (zeros
// where no slot points).
int dgmc_spline_route_dt_f32(const float* g, const int* rec,
                             const int* offsets, const int64_t* rcv_off,
                             float* gn, float* d_t, int B, int N,
                             long long M, int O, int device, void* stream) {
  if (B < 1 || N < 1 || M < 1 || O < 1) return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const int64_t rows = (int64_t)B * M, n = (int64_t)B * N * O;
    const int V = vec_width(O, g, d_t) == 4 &&
                          reinterpret_cast<uintptr_t>(gn) % 16 == 0
                      ? 4
                      : 1;
    int L = 1;  // lanes per row: two vectors a lane cover the row
    while (L < 32 && DT_NV * L < O / V) L *= 2;
    const int64_t warps = (rows + DT_ROWS - 1) / DT_ROWS;
    const unsigned grid = (unsigned)((warps + THREADS / 32 - 1) /
                                     (THREADS / 32));
    const unsigned ngrid = (unsigned)((n / V + THREADS - 1) / THREADS);
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    if (V == 4) {
      g_norm<4><<<ngrid, THREADS, 0, st>>>(g, rcv_off, gn, n, O);
      route_dt<4><<<grid, THREADS, 0, st>>>(gn, rec, offsets, d_t, rows, O,
                                             L);
    } else {
      g_norm<1><<<ngrid, THREADS, 0, st>>>(g, rcv_off, gn, n, O);
      route_dt<1><<<grid, THREADS, 0, st>>>(gn, rec, offsets, d_t, rows, O,
                                             L);
    }
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
