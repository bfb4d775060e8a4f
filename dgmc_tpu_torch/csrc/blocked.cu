// Blocked edge->node aggregation for Hopper (sm_90a).
//
// out[b, n, c] = sum over the edges e with destination n of h[b, src_e, c],
// the sum of the JAX package's blocked adjacency (dgmc_tpu/ops/blocked.py,
// which computes it as XLA one-hot einsums, ops/blocked.py:148-218; there
// is no Pallas kernel). It reads the row table that ops/blocked.py builds
// beside JAX's blocks, a CSR over destination rows: row_ptr [B, M + 1]
// int32, row_src [B, E_max] int32, node n's sources
// row_src[row_ptr[n] .. row_ptr[n + 1] - 1] in the blocks' order (the
// node's range's blocks in order, each block's slots in order). The same
// entry serves the backward: the gradient of h is this sum over the
// transposed direction's table.
//
// Design. One output row per group of L lanes: L = 32 (a warp a row)
// where a row is at least 32 16-byte vectors wide (C = 256 / 320 in
// float32, 256 in bf16), fewer at narrow C (C = 32 float32: 8 lanes, four
// rows a warp), at least 4. Lanes span the channels with 16-byte loads
// (float4, or 8 bf16 as one uint4 widened in registers; narrower where C
// or the base address does not allow them), TT vectors a lane; wider rows
// take several channel tiles (grid.y). The group reads its row's sources
// coalesced, L at a time, the next L already in flight, and broadcasts
// them by shuffles; it loads the rows of UNROLL edges a stage, and issues
// the next stage's loads before it adds the current stage's, so 2 x UNROLL
// rows a group (at least 8 a warp) are in flight. Each (row, channel) is
// summed by one thread into a float32 register that starts at 0, in the
// table's order: the summation order of the earlier shared-memory kernel
// (blocks in order, slots in order), so the result is the same bit for bit
// on every input. No shared memory, no ballot, no atomics; repeats
// bit-identical; each output element written once, coalesced. A hub row
// is one group's serial sum.
//
// Rows are float32, or bf16 where ops/blocked.py casts them (gather_dtype
// at C * 2 >= 512), widened to float32 exactly (the bits shifted up).
//
// The second entry, dgmc_blocked_route, serves the sparse correspondence
// routing of ops/corr_route.py (JAX's dgmc_tpu/ops/corr_route.py, whose
// routed sums are the same one-hot einsums): the table has its own row
// count (N_s rows for the indicator projection, N_s * K for the candidate
// gather's backward, against n_t output rows), and an optional float32
// row_scale [B, E_max], aligned with row_src, multiplies each row before
// it is added: acc = acc + scale * x as a rounded multiply and a rounded
// add (__fmul_rn, __fadd_rn: no FMA contraction), so that torch's
// ordered_aggregate with the same scale is its bit-for-bit reference. With
// bf16 rows the product is rounded to bf16 (the rows' dtype, as JAX's
// `g * scale.astype(g.dtype)`), the scale arriving rounded to bf16 too.
//
// Bound on the H100 (bytes, the work's least, whatever implements it): h
// read once, the float32 output written once, the E sources read once.
// psi_1 at C = 256 on the synthetic DBP15K source KG (15000 nodes, 100000
// edges): 15.4 MB + 15.4 MB + 0.4 MB, about 9.3 us at 3.35 TB/s. The h
// table fits in the 50 MB L2, so the gather's repeated row reads (each
// row ~6.7 times) are L2 traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// Edges whose rows a lane group loads per stage (two stages in flight);
// also the fewest lanes a row, so that a stage never straddles a batch
// of sources.
constexpr int UNROLL = 4;
// Vectors a lane holds per row at most; wider rows take channel tiles.
constexpr int TT_MAX = 4;
constexpr unsigned FULL = 0xffffffffu;

// VW elements of type T as one load.
template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<4> {
  using type = unsigned;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};

__device__ __forceinline__ void words(uint4 r, unsigned (&w)[4]) {
  w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
}
__device__ __forceinline__ void words(uint2 r, unsigned (&w)[2]) {
  w[0] = r.x, w[1] = r.y;
}
__device__ __forceinline__ void words(unsigned r, unsigned (&w)[1]) {
  w[0] = r;
}

// The VW values of a raw load of T as float32 (bf16: the bits shifted
// up, exact).
template <typename T, int VW, typename Raw>
__device__ __forceinline__ void widen(Raw r, float (&v)[VW]) {
  if constexpr (sizeof(Raw) == 2) {
    v[0] = __uint_as_float((unsigned)r << 16);
  } else {
    unsigned w[sizeof(Raw) / 4];
    words(r, w);
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < VW; ++i) v[i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VW / 2; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

template <int VW>
__device__ __forceinline__ void store(float* p, const float (&v)[VW]) {
  if constexpr (VW == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// T: float (float32 rows) or unsigned short (bf16 rows' bits); s: the
// stage's scales (the scaled entry only).
template <typename T, int VW, int TT>
struct Stage {
  using Raw = typename RawOf<sizeof(T) * VW>::type;
  Raw r[UNROLL][TT];
  float s[UNROLL];
};

// Loads the rows of the stage's UNROLL edges k = kk .. kk + UNROLL - 1
// (sources and scales: lane (k mod L) of the group holds edge k's in `src`
// and `scl`).
template <bool SCALED, typename T, int VW, int TT>
__device__ __forceinline__ void issue(Stage<T, VW, TT>& st, int src, float scl,
                                      int kk, int deg, int L, const T* hb,
                                      int C, int c_first, int c_step) {
  using Raw = typename Stage<T, VW, TT>::Raw;
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const int k = kk + j;
    const int s = __shfl_sync(FULL, src, k & (L - 1), L);
    if constexpr (SCALED) st.s[j] = __shfl_sync(FULL, scl, k & (L - 1), L);
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const int c = c_first + t * c_step;
      st.r[j][t] = Raw{};
      if (k < deg && c < C)
        st.r[j][t] =
            __ldg(reinterpret_cast<const Raw*>(hb + (size_t)s * C + c));
    }
  }
}

// Adds the stage's real edges, in order (scaled: the rounded product,
// rounded again to bf16 for bf16 rows, then the rounded add).
template <bool SCALED, typename T, int VW, int TT>
__device__ __forceinline__ void add(const Stage<T, VW, TT>& st, int kk, int deg,
                                    float (&acc)[TT][VW]) {
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    if (kk + j < deg) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        float v[VW];
        widen<T, VW>(st.r[j][t], v);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          if constexpr (SCALED) {
            float p = __fmul_rn(st.s[j], v[i]);
            if constexpr (sizeof(T) == 2)
              p = __bfloat162float(__float2bfloat16_rn(p));
            acc[t][i] = __fadd_rn(acc[t][i], p);
          } else {
            acc[t][i] += v[i];
          }
        }
      }
    }
  }
}

// Grid: (row groups' blocks, channel tiles, B). Lane group g of warp w
// of block x owns row (x * WARPS + w) * (32 / L) + g; lane `sub` of it
// the vectors sub + L * t (t < TT) of the block's channel tile. M output
// rows, M_tab table rows; row_scale is read only when SCALED.
template <bool SCALED, typename T, int VW, int TT>
__global__ void __launch_bounds__(THREADS)
    blocked_aggregate(const T* __restrict__ h, const int* __restrict__ row_ptr,
                      const int* __restrict__ row_src,
                      const float* __restrict__ row_scale,
                      float* __restrict__ out, int M, int M_tab, int E_max,
                      int C, int L) {
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const int row = ((blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32 + lane) / L;
  const int c_step = L * VW;
  const int c_first = blockIdx.y * TT * c_step + sub * VW;

  const int* ptr = row_ptr + (size_t)b * (M + 1);
  const int* rs = row_src + (size_t)b * E_max;
  const float* sc = SCALED ? row_scale + (size_t)b * E_max : nullptr;
  int beg = 0, deg = 0;
  if (row < M) {
    beg = ptr[row];
    deg = ptr[row + 1] - beg;
  }
  // Warp-uniform trip count: the shuffles take every lane.
  const int steps = __reduce_max_sync(FULL, deg);

  float acc[TT][VW];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[t][i] = 0.f;

  if (steps > 0) {
    const T* hb = h + (size_t)b * M_tab * C;
    // Sources (and scales) of edges [base, base + L) and [base + L,
    // base + 2L).
    int src = sub < deg ? rs[beg + sub] : 0;
    int src_next = L + sub < deg ? rs[beg + L + sub] : 0;
    float scl = 0.f, scl_next = 0.f;
    if constexpr (SCALED) {
      scl = sub < deg ? sc[beg + sub] : 0.f;
      scl_next = L + sub < deg ? sc[beg + L + sub] : 0.f;
    }
    Stage<T, VW, TT> a, n;
    issue<SCALED>(a, src, scl, 0, deg, L, hb, C, c_first, c_step);
    // Stage kk's loads are in `a` on entry; each pass adds two stages.
    for (int kk = 0; kk < steps; kk += 2 * UNROLL) {
      int k1 = kk + UNROLL;
      if (k1 < steps) {
        if ((k1 & (L - 1)) == 0) {
          src = src_next;
          src_next = k1 + L + sub < deg ? rs[beg + k1 + L + sub] : 0;
          if constexpr (SCALED) {
            scl = scl_next;
            scl_next = k1 + L + sub < deg ? sc[beg + k1 + L + sub] : 0.f;
          }
        }
        issue<SCALED>(n, src, scl, k1, deg, L, hb, C, c_first, c_step);
      }
      add<SCALED>(a, kk, deg, acc);
      if (k1 >= steps) break;
      const int k2 = k1 + UNROLL;
      if (k2 < steps) {
        if ((k2 & (L - 1)) == 0) {
          src = src_next;
          src_next = k2 + L + sub < deg ? rs[beg + k2 + L + sub] : 0;
          if constexpr (SCALED) {
            scl = scl_next;
            scl_next = k2 + L + sub < deg ? sc[beg + k2 + L + sub] : 0.f;
          }
        }
        issue<SCALED>(a, src, scl, k2, deg, L, hb, C, c_first, c_step);
      }
      add<SCALED>(n, k1, deg, acc);
    }
  }

  if (row < M) {
    float* ob = out + ((size_t)b * M + row) * C;
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const int c = c_first + t * c_step;
      if (c < C) store<VW>(ob + c, acc[t]);
    }
  }
}

// The widest load of 16, 8, 4 or `elem` bytes that C and the base address
// allow, in elements.
int vector_width(const void* h, int C, int elem) {
  for (int vw = 16 / elem; vw > 1; vw /= 2)
    if (C % vw == 0 && (uintptr_t)h % (vw * elem) == 0) return vw;
  return 1;
}

// One launch's arguments beside the rows.
struct Args {
  const int* row_ptr;
  const int* row_src;
  const float* row_scale;  // null: unscaled
  float* out;
  int B, M, M_tab, E_max, C;
  cudaStream_t stream;
};

template <bool SCALED, typename T, int VW, int TT>
int launch_tt(const T* h, const Args& a, int L) {
  const int vectors = a.C / VW;
  const int tiles = (vectors + L * TT - 1) / (L * TT);
  const int rows_per_block = WARPS * 32 / L;
  const long long blocks =
      ((long long)a.M + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, tiles, a.B);
  blocked_aggregate<SCALED, T, VW, TT><<<grid, THREADS, 0, a.stream>>>(
      h, a.row_ptr, a.row_src, a.row_scale, a.out, a.M, a.M_tab, a.E_max, a.C,
      L);
  return (int)cudaGetLastError();
}

template <bool SCALED, typename T, int VW>
int launch_vw(const T* h, const Args& a) {
  const int vectors = a.C / VW;
  int L = UNROLL;
  while (L < 32 && L < vectors) L *= 2;
  const int tt = (vectors + L - 1) / L;
  switch (tt < TT_MAX ? tt : TT_MAX) {
    case 1:
      return launch_tt<SCALED, T, VW, 1>(h, a, L);
    case 2:
      return launch_tt<SCALED, T, VW, 2>(h, a, L);
    case 3:
      return launch_tt<SCALED, T, VW, 3>(h, a, L);
    default:
      return launch_tt<SCALED, T, VW, TT_MAX>(h, a, L);
  }
}

template <bool SCALED>
int launch_rows(const void* h, int bf16, const Args& a) {
  if (bf16) {
    const auto* x = static_cast<const unsigned short*>(h);
    switch (vector_width(h, a.C, 2)) {
      case 8:
        return launch_vw<SCALED, unsigned short, 8>(x, a);
      case 4:
        return launch_vw<SCALED, unsigned short, 4>(x, a);
      case 2:
        return launch_vw<SCALED, unsigned short, 2>(x, a);
      default:
        return launch_vw<SCALED, unsigned short, 1>(x, a);
    }
  }
  const auto* x = static_cast<const float*>(h);
  switch (vector_width(h, a.C, 4)) {
    case 4:
      return launch_vw<SCALED, float, 4>(x, a);
    case 2:
      return launch_vw<SCALED, float, 2>(x, a);
    default:
      return launch_vw<SCALED, float, 1>(x, a);
  }
}

}  // namespace

extern "C" {

// Warps a block of threads, edges a lane group loads per stage (the
// fewest lanes a row), and vectors a lane holds per row and channel tile
// at most (checked by the wrapper at load).
int dgmc_blocked_warps() { return WARPS; }
int dgmc_blocked_unroll() { return UNROLL; }
int dgmc_blocked_vectors_per_lane() { return TT_MAX; }

// h [B, M, C] float32 (bf16 = 0) or bf16 (bf16 = 1); row_ptr [B, M + 1],
// row_src [B, E_max] int32; out [B, M, C] float32, every element written.
// Launches on `stream` on `device`, does not synchronize, restores the
// calling thread's current device, returns the first CUDA error.
int dgmc_blocked_aggregate(const void* h, int bf16, const int* row_ptr,
                           const int* row_src, float* out, int B, int M,
                           int E_max, int C, int device, void* stream) {
  if (B <= 0 || M <= 0 || C <= 0) return (int)cudaSuccess;
  if (E_max <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const Args a{row_ptr, row_src, nullptr, out, B, M, M, E_max, C,
                 (cudaStream_t)stream};
    return launch_rows<false>(h, bf16, a);
  });
}

// The routed sum: h [B, M_tab, C] (float32 or bf16 as above), row_ptr
// [B, M_out + 1], row_src [B, E_max] int32 rows of h, row_scale [B, E_max]
// float32 aligned with row_src or null; out [B, M_out, C] float32, every
// element written. As dgmc_blocked_aggregate otherwise. Each row reads
// row_src from the offset its pointer holds, so row_ptr may be a slice of
// a larger table's pointers whose first offset is not 0: a rank's row
// block of a graph (ops/blocked.py row_slice), the whole table as h.
int dgmc_blocked_route(const void* h, int bf16, const int* row_ptr,
                       const int* row_src, const float* row_scale, float* out,
                       int B, int M_out, int M_tab, int E_max, int C,
                       int device, void* stream) {
  if (B <= 0 || M_out <= 0 || C <= 0) return (int)cudaSuccess;
  if (E_max <= 0 || M_tab <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    const Args a{row_ptr, row_src, row_scale, out, B, M_out, M_tab, E_max, C,
                 (cudaStream_t)stream};
    return row_scale ? launch_rows<true>(h, bf16, a)
                     : launch_rows<false>(h, bf16, a);
  });
}

}  // extern "C"
