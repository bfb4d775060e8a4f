// SplineConv routing and masked-mean aggregation for Hopper (sm_90a),
// float32 or bfloat16 t and g: the forward and its transpose (the
// gradient w.r.t. t).
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
// bf16 t and g (the precision policy's variant, the *_bf16 entry points):
// the basis weights and every sum stay float32, and each output row is
// rounded to bf16 once (round to nearest even), as the TPU kernel writes
// its float32 sums in t's (g's) dtype. The forward gathers bf16 t rows
// (half the bytes); route_dt's g / deg scratch stays float32 (the TPU
// kernel divides g in float32), and it writes bf16 d_t rows.
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
// Both kernels read 8-byte records built by one launch of `records` once
// per routing and basis (the wrapper caches them: the two convolutions of
// a SplineCNN call and their two backward launches share one build):
//   - route_fwd's edge records, in receiver order, A a edge: the row of t
//     in the flattened batch, b*M + flat[b,e,a], and the basis weight's
//     bits, with int32 slot offsets;
//   - route_dt's slot records, in slot order: the receiver node of the
//     flattened batch and the basis weight's bits, with int32 row offsets.
// So a slot costs one record and one t (or g) row instead of a chain of
// dependent int64 loads (offsets -> order -> flat and basis -> t).
//
// route_fwd:
//   - a block owns FW_ROWS (8) receiver rows, its warps 32 / L rows at a
//     time: a group of L lanes a row, sized to O (16-byte vectors, one a
//     lane up to 32 of them, two above: at O = 64 16 lanes a row and two
//     rows a warp, at O = 256 the warp, two vectors a lane);
//   - each group reads its slots' records straight from memory (L1) and
//     loads the t rows of FW_VECTORS / NV slots (8 vectors a lane: two
//     edges at O = 64, one at O = 256) before the first FMA;
//   - a row without an edge stores its zeros at once; every output store
//     streams (evict-first).
// Staging a warp's records in shared memory first, one row a warp with
// 8-byte vectors, more slots in flight, and blocks that own a whole
// graph all measured slower on the H100. At the dense training batch the
// gather of every slot's t row through L2 is what is left: 112000 real
// slots read 28.7 MB at O = 64, 3.3 reads of each of 33954 distinct rows,
// at about 4 TB/s (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W: 0.0072
// ms at O = 64, 0.024 ms at O = 256). Sums keep the plain version's
// order: an edge's A rows blended in slot order, edges added in receiver
// order, then the division by max(deg, 1).

// route_dt is bound by the write of d_t (B*M*O floats, most rows without a
// slot: on the dense training batch 0.875 slots a row, 73.5% of rows
// empty), so it is built to keep that write streaming:
//   - g_norm first divides each receiver's g row by max(deg, 1) once
//     (B*N*O divisions, against one per slot and channel otherwise, which
//     made the kernel issue-bound), into a scratch buffer; deg is read
//     from the receiver CSR offsets;
//   - each slot is one slot record (above);
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
using bf16 = __nv_bfloat16;

// V consecutive channels per thread: 4 (one 4-element load or store: 16
// bytes of float32, 8 of bf16) when O % 4 == 0 and the rows are aligned to
// 4 elements, else 1. Values are float32 in registers.
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
__device__ __forceinline__ void load(const bf16* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    x[0] = __bfloat162float(lo.x);
    x[1] = __bfloat162float(lo.y);
    x[2] = __bfloat162float(hi.x);
    x[3] = __bfloat162float(hi.y);
  } else {
    x[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

// Streaming (evict-first) stores; bf16 rows are rounded to nearest even.
template <int V>
__device__ __forceinline__ void store_stream(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  else
    __stcs(p, x[0]);
}

template <int V>
__device__ __forceinline__ void store_stream(bf16* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(x[0]);
    lo.y = __float2bfloat16_rn(x[1]);
    hi.x = __float2bfloat16_rn(x[2]);
    hi.y = __float2bfloat16_rn(x[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), q);
  } else {
    *p = __float2bfloat16_rn(x[0]);
  }
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int FW_VECTORS = 8;    // route_fwd: t vectors in flight a lane
constexpr int FW_THREADS = 256;  // route_fwd: most threads a block
constexpr int FW_ROWS = 8;       // route_fwd: receiver rows a block
constexpr int DT_ROWS = 32;  // rows of d_t per warp
constexpr int DT_CAP = 128;  // slot records staged per warp
constexpr int DT_NV = 2;     // vectors per lane per pass

// Both record sets, a thread a slot: edge record i of the receiver-sorted
// edge order rcv_order[i / A] = b*E + e is (b*M + flat[b, e, a], bits of
// basis[b, e, a]) with a = i % A; slot record j of the flat-sorted slot
// order slot_order[j] = (b*E + e)*A + a is (b*N + receivers[b, e], bits
// of basis[b, e, a]). Also both offset lists as int32: the slot offsets
// of the forward (A times the receiver CSR's edge offsets) and the row
// offsets of the slot CSR.
__global__ void records(const int64_t* __restrict__ rcv_order,
                        const int64_t* __restrict__ slot_order,
                        const int64_t* __restrict__ flat,
                        const int64_t* __restrict__ receivers,
                        const float* __restrict__ basis,
                        const int64_t* __restrict__ rcv_off,
                        const int64_t* __restrict__ slot_off,
                        int2* __restrict__ edge_rec, int* __restrict__ edge_off,
                        int2* __restrict__ slot_rec, int* __restrict__ row_off,
                        int64_t S, int64_t n_rcv, int64_t n_slot, int E,
                        int A, int N, int64_t M) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < S) {
    const int64_t jj = i / A, e = rcv_order[jj];
    const int64_t slot = e * A + (i - jj * A);
    edge_rec[i] = make_int2((int)((e / E) * M + flat[slot]),
                            __float_as_int(basis[slot]));
    const int64_t s2 = slot_order[i], e2 = s2 / A;
    slot_rec[i] = make_int2((int)((e2 / E) * N + receivers[e2]),
                            __float_as_int(basis[s2]));
  }
  if (i < n_rcv) edge_off[i] = (int)(rcv_off[i] * A);
  if (i < n_slot) row_off[i] = (int)slot_off[i];
}

// out[r] = (sum over r's edges in order of (sum over the edge's A slots
// of w * t[row])) / max(deg, 1). Block b owns receiver rows [b FW_ROWS,
// (b+1) FW_ROWS); its warps take 32 / L of them at a time, a group of L lanes a
// row, NV vectors of V floats a lane (covering L * NV vectors of the row
// a pass over columns). A group reads its slots' records straight from
// memory, SB at a time, and each record's t row as soon as it has it.
template <typename T, int V, int NV>
__global__ void __launch_bounds__(FW_THREADS)
route_fwd(const T* __restrict__ t, const int2* __restrict__ rec,
          const int* __restrict__ off, T* __restrict__ out, int64_t rows,
          int O, int L, int A) {
  constexpr int SB = FW_VECTORS / NV;   // slots loaded ahead of their FMAs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, groups = 32 / L;
  const int g = lane / L, sub = lane % L;
  const int nvec = O / V;
  for (int w0 = (warp * groups + g); w0 < FW_ROWS; w0 += warps * groups) {
    const int64_t r = (int64_t)blockIdx.x * FW_ROWS + w0;
    if (r >= rows) break;
    const int beg = off[r], end = off[r + 1];
    const float deg = fmaxf((float)((end - beg) / A), 1.0f);
    T* o = out + r * O;
    for (int c0 = sub; c0 < nvec; c0 += L * NV) {
      float acc[NV][V] = {}, msg[NV][V] = {};
      int a = 0;
      for (int j0 = beg; j0 < end; j0 += SB) {
        float x[SB][NV][V];
        float w[SB];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          const int j = j0 + s;
          const int2 rc = j < end ? rec[j] : make_int2(0, 0);
          w[s] = __int_as_float(rc.y);
          const T* tr = t + (int64_t)rc.x * O;
#pragma unroll
          for (int u = 0; u < NV; ++u) {
            const int c = c0 + u * L;
            if (j < end && c < nvec) {
              load<V>(tr + c * V, x[s][u]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) x[s][u][v] = 0.f;
            }
          }
        }
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          if (j0 + s >= end) break;
#pragma unroll
          for (int u = 0; u < NV; ++u)
#pragma unroll
            for (int v = 0; v < V; ++v)
              msg[u][v] = a ? msg[u][v] + w[s] * x[s][u][v]
                            : w[s] * x[s][u][v];
          if (++a == A) {
            a = 0;
#pragma unroll
            for (int u = 0; u < NV; ++u)
#pragma unroll
              for (int v = 0; v < V; ++v) acc[u][v] += msg[u][v];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int c = c0 + u * L;
        if (c >= nvec) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u][v] = acc[u][v] / deg;
        store_stream<V>(o + c * V, acc[u]);
      }
    }
  }
}

// gn[n, :] = g[n, :] / max(deg_n, 1) for the B*N receiver rows, deg_n
// from the receiver CSR offsets (V floats a thread; O % V == 0).
template <typename T, int V>
__global__ void g_norm(const T* __restrict__ g,
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

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
route_dt(const float* __restrict__ gn, const int* __restrict__ rec,
         const int* __restrict__ offsets, T* __restrict__ d_t,
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
    T* out = d_t + (r0 + rr) * O;
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

// 4 where O % 4 == 0 and both rows start aligned to 4 elements of T.
template <typename T>
int vec_width(int O, const void* a, const void* b) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  return (O % 4 == 0 && bits % (4 * sizeof(T)) == 0) ? 4 : 1;
}

template <typename T>
int route_fwd_entry(const T* t, const int* rec, const int* off, T* out,
                    int B, int N, long long M, int O, int A, int device,
                    void* stream) {
  if (B < 1 || N < 1 || M < 1 || O < 1 || A < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const int64_t rows = (int64_t)B * N;
    const int V = vec_width<T>(O, t, out), nvec = O / V;
    int L = 2;   // lanes a row: one vector a lane up to 32, then two
    while (L < 32 && L < nvec) L *= 2;
    const int NV = nvec > L ? 2 : 1, groups = 32 / L;
    const int windows = (FW_ROWS + groups - 1) / groups;
    const int threads =
        32 * (windows < FW_THREADS / 32 ? windows : FW_THREADS / 32);
    const unsigned grid = (unsigned)((rows + FW_ROWS - 1) / FW_ROWS);
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    const auto r2 = reinterpret_cast<const int2*>(rec);
    if (V == 4 && NV == 2)
      route_fwd<T, 4, 2><<<grid, threads, 0, st>>>(t, r2, off, out, rows, O,
                                                   L, A);
    else if (V == 4)
      route_fwd<T, 4, 1><<<grid, threads, 0, st>>>(t, r2, off, out, rows, O,
                                                   L, A);
    else if (NV == 2)
      route_fwd<T, 1, 2><<<grid, threads, 0, st>>>(t, r2, off, out, rows, O,
                                                   L, A);
    else
      route_fwd<T, 1, 1><<<grid, threads, 0, st>>>(t, r2, off, out, rows, O,
                                                   L, A);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int route_dt_entry(const T* g, const int* rec, const int* offsets,
                   const int64_t* rcv_off, float* gn, T* d_t, int B, int N,
                   long long M, int O, int device, void* stream) {
  if (B < 1 || N < 1 || M < 1 || O < 1) return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const int64_t rows = (int64_t)B * M, n = (int64_t)B * N * O;
    const int V = vec_width<T>(O, g, d_t) == 4 &&
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
      g_norm<T, 4><<<ngrid, THREADS, 0, st>>>(g, rcv_off, gn, n, O);
      route_dt<T, 4><<<grid, THREADS, 0, st>>>(gn, rec, offsets, d_t, rows,
                                                O, L);
    } else {
      g_norm<T, 1><<<ngrid, THREADS, 0, st>>>(g, rcv_off, gn, n, O);
      route_dt<T, 1><<<grid, THREADS, 0, st>>>(gn, rec, offsets, d_t, rows,
                                                O, L);
    }
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// t [B, M, O] float32 (_f32) or bfloat16 (_bf16); rec [B*E*A, 2] int32
// and off [B*N + 1] int32 the edge records and slot offsets
// dgmc_spline_records writes. Writes out [B, N, O] in t's dtype. Launches
// on `stream` on `device`, does not synchronize, restores the calling
// thread's current device, returns cudaGetLastError().
int dgmc_spline_route_fwd_f32(const float* t, const int* rec, const int* off,
                              float* out, int B, int N, long long M, int O,
                              int A, int device, void* stream) {
  return route_fwd_entry(t, rec, off, out, B, N, M, O, A, device, stream);
}

int dgmc_spline_route_fwd_bf16(const void* t, const int* rec, const int* off,
                               void* out, int B, int N, long long M, int O,
                               int A, int device, void* stream) {
  return route_fwd_entry(static_cast<const bf16*>(t), rec, off,
                         static_cast<bf16*>(out), B, N, M, O, A, device,
                         stream);
}

// rcv_order [B*E] int64 edge ids sorted by (b, receiver) and slot_order
// [S = B*E*A] int64 slot ids (b*E + e)*A + a sorted by (b, flat), masked
// ones last in both; flat [B, E, A] int64 (< M); receivers [B, E] int64;
// basis [B, E, A] float32; rcv_off [n_rcv] and slot_off [n_slot] int64
// CSR bounds into the two orders. Writes edge_rec [S, 2] int32 (row b*M +
// flat, basis weight bits, in receiver order), edge_off [n_rcv] int32 (A
// times rcv_off), slot_rec [S, 2] int32 (receiver node b*N + rcv, basis
// weight bits, in slot order) and row_off [n_slot] int32 (slot_off).
int dgmc_spline_records(const int64_t* rcv_order, const int64_t* slot_order,
                        const int64_t* flat, const int64_t* receivers,
                        const float* basis, const int64_t* rcv_off,
                        const int64_t* slot_off, int* edge_rec, int* edge_off,
                        int* slot_rec, int* row_off, long long S,
                        long long n_rcv, long long n_slot, int E, int A,
                        int N, long long M, int device, void* stream) {
  if (S < 0 || n_rcv < 1 || n_slot < 1 || A < 1 || N < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    long long n = S > n_rcv ? S : n_rcv;
    n = n > n_slot ? n : n_slot;
    const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
    const auto st = reinterpret_cast<cudaStream_t>(stream);
    records<<<grid, THREADS, 0, st>>>(
        rcv_order, slot_order, flat, receivers, basis, rcv_off, slot_off,
        reinterpret_cast<int2*>(edge_rec), edge_off,
        reinterpret_cast<int2*>(slot_rec), row_off, S, n_rcv, n_slot, E, A,
        N, M);
    return (int)cudaGetLastError();
  });
}

// g [B, N, O] float32 (_f32) or bfloat16 (_bf16); rec [S, 2] int32 slot
// records in the slot order of the flat-sorted CSR list (receiver node
// b*N + rcv, basis weight bits); offsets [B*M + 1] int32 row bounds into
// rec; rcv_off [B*N + 1] int64 receiver CSR bounds (deg = rcv_off[n+1] -
// rcv_off[n]); gn [B, N, O] float32 scratch. Writes every row of d_t
// [B, M, O] in g's dtype (zeros where no slot points).
int dgmc_spline_route_dt_f32(const float* g, const int* rec,
                             const int* offsets, const int64_t* rcv_off,
                             float* gn, float* d_t, int B, int N,
                             long long M, int O, int device, void* stream) {
  return route_dt_entry(g, rec, offsets, rcv_off, gn, d_t, B, N, M, O,
                        device, stream);
}

int dgmc_spline_route_dt_bf16(const void* g, const int* rec,
                              const int* offsets, const int64_t* rcv_off,
                              float* gn, void* d_t, int B, int N,
                              long long M, int O, int device, void* stream) {
  return route_dt_entry(static_cast<const bf16*>(g), rec, offsets, rcv_off,
                        gn, static_cast<bf16*>(d_t), B, N, M, O, device,
                        stream);
}

}  // extern "C"
