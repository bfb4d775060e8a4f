// Counter-based random draws for Hopper (sm_90a): Philox4x32-10.
//
// The port's counterpart of jax.random on the device. The JAX package
// draws each pair's indicator noise (jax.random.normal) and negatives
// (jax.random.uniform) inside its jitted step, keyed by fold_in of the
// step's key with the pair's index (dgmc_tpu/models/dgmc.py:515-526,
// :733-738); threefry's bits are not reproduced here. This is no port of a
// Pallas kernel: the TPU draws inside XLA.
//
// The stream. Key = the 64-bit seed (k0 = low word, k1 = high word).
// Element e of pair b's draw (its flat index within that pair's draw) is
// word e % 4 of the Philox4x32-10 block at counter
//   (q_lo, q_hi, pair_offset + b, stream),   q = e / 4,
// so a batch of pairs draws exactly what the same pairs draw one at a time
// at their pair_offset, and a draw is a function of its counter alone, on
// any device (ops/kernels/rng.py holds the same arithmetic in torch
// integer ops: the plain version).
//
//   uniform  u  = (x >> 8) * 2^-24                       in [0, 1), float32
//   negative    = min(floor(u * float(n_valid[b])), max(n_valid[b] - 1, 0))
//                 (float32 product, int64 out)
//   normal   Box-Muller on words (x0, x1) and (x2, x3) of a block, in
//            float64: u1 = ((x0 >> 8) + 1) * 2^-24 in (0, 1],
//            u2 = (x1 >> 8) * 2^-24, r = sqrt(-2 log u1),
//            z0 = r cos(2 pi u2), z1 = r sin(2 pi u2), each rounded to
//            float32 once. The kernel takes cos and sin from one
//            sincospi(2 u2) (2 u2 is exact, so no reduction by pi); the
//            plain version from float64 cos and sin of 2 pi u2.
// Uniforms and negatives are integer and IEEE-exact arithmetic (no
// product is followed by an add, so no FMA contraction changes them):
// bit-equal to the plain version. Normals agree unless CUDA's and the
// CPU's float64 log / sincospi / sin / cos (each within an ulp or two of
// float64) straddle a float32 rounding boundary: at most one float32 ulp.
// float32 transcendentals would miss that contract, so log and sqrt stay
// float64.
//
// Layout. A draw is `steps` blocks of P elements per pair, stored
// [steps, B, P] (noise: [num_steps, B, N_s * R], e = step * P + i * R + c;
// negatives: steps = 1, [B, N_s * num_rnd]). One thread per Philox block,
// four outputs; where P is a multiple of 4 (so a block's four normals lie
// in one row, 16-byte aligned: both main-path shapes, P = 480000 and 5120)
// they go out as one 16-byte store, else as four scalar ones.
//
// The key is read from device memory (a 0-d int64 tensor holding the 64
// bits in two's complement), so that a captured CUDA graph of a step reads
// each replay's seed instead of the one it was captured with.
//
// Bound on the H100: bytes written (each output once; nothing is read but
// n_valid and the key). The dense step's noise [10, 64, 80, 64] float32 is
// 13.1 MB, about 3.9 us at 3.35 TB/s; the KG step's [10, 1, 15000, 32]
// 19.2 MB.
// Normals also spend a float64 log, sqrt and sincospi per two outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr int THREADS = 256;

struct Block {
  uint32_t x[4];
};

__device__ __forceinline__ Block philox(uint32_t c0, uint32_t c1,
                                        uint32_t c2, uint32_t c3,
                                        uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t lo0 = PHILOX_M0 * c0, hi0 = __umulhi(PHILOX_M0, c0);
    const uint32_t lo1 = PHILOX_M1 * c2, hi1 = __umulhi(PHILOX_M1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Block{{c0, c1, c2, c3}};
}

__device__ __forceinline__ float uniform24(uint32_t x) {
  return (float)(x >> 8) * 5.9604644775390625e-08f;  // 2^-24, exact
}

enum Kind { NORMAL = 0, NEGATIVES = 1 };

// Thread t draws block q = t % Q of pair b = t / Q (Q blocks a pair) and
// stores its (up to) four elements e = 4q .. 4q + 3 < n = steps * P at
// [e / P, b, e % P]; with `vec4` (normals, P % 4 == 0, `out` 16-byte
// aligned) as one float4.
template <int KIND, typename Out>
__global__ void __launch_bounds__(THREADS)
    draw(Out* __restrict__ out, const int64_t* __restrict__ n_valid,
         long long P, long long n, long long Q, int B,
         const unsigned long long* __restrict__ key, uint32_t pair_offset,
         uint32_t stream, bool vec4) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= Q * B) return;
  const unsigned long long k = *key;
  const uint32_t k0 = (uint32_t)k, k1 = (uint32_t)(k >> 32);
  const int b = (int)(t / Q);
  const long long q = t - (long long)b * Q;
  const Block blk = philox((uint32_t)q, (uint32_t)(q >> 32),
                           pair_offset + (uint32_t)b, stream, k0, k1);
  float v[4];
  if (KIND == NORMAL) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double u1 = (double)((blk.x[2 * h] >> 8) + 1u) * 0x1p-24;
      const double u2 = (double)(blk.x[2 * h + 1] >> 8) * 0x1p-24;
      const double r = sqrt(-2.0 * log(u1));
      double s, c;
      sincospi(2.0 * u2, &s, &c);
      v[2 * h] = (float)(r * c);
      v[2 * h + 1] = (float)(r * s);
    }
    if (vec4) {
      const long long e = 4 * q, step = e / P;
      *reinterpret_cast<float4*>(out + (step * B + b) * P + (e - step * P)) =
          make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = uniform24(blk.x[j]);
  }
  long long nv = 0;
  if (KIND == NEGATIVES) nv = n_valid[b];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long e = 4 * q + j;
    if (e >= n) break;
    const long long step = e / P;
    Out* dst = out + (step * B + b) * P + (e - step * P);
    if (KIND == NEGATIVES) {
      const float col = floorf(__fmul_rn(v[j], (float)nv));
      const long long hi = nv > 0 ? nv - 1 : 0;
      const long long c = (long long)col;
      *dst = (Out)(c < hi ? c : hi);
    } else {
      *dst = (Out)v[j];
    }
  }
}

template <int KIND, typename Out>
int launch(Out* out, const int64_t* n_valid, long long steps, long long P,
           int B, const unsigned long long* key, unsigned pair_offset,
           unsigned stream_id, int device, void* stream) {
  const bool vec4 =
      KIND == NORMAL && P % 4 == 0 && (uintptr_t)out % 16 == 0;
  const long long n = steps * P;
  const long long Q = (n + 3) / 4;
  if (B <= 0 || Q <= 0) return (int)cudaSuccess;
  const long long threads = Q * B;
  const long long grid = (threads + THREADS - 1) / THREADS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return dgmc::on_device(device, [&]() {
    draw<KIND, Out><<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        out, n_valid, P, n, Q, B, key, pair_offset, stream_id, vec4);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Each entry writes pair b's draw of `steps` blocks of P elements at
// out[step, b, :] ([steps, B, P], contiguous) from counter
// (q, pair_offset + b, stream) under the key at `seed` (one 64-bit word on
// the device; see above). Launches on `stream` on `device`, does not
// synchronize, restores the calling thread's current device, returns the
// first CUDA error.
int dgmc_philox_normal(float* out, long long steps, long long P, int B,
                       const unsigned long long* seed, unsigned pair_offset,
                       unsigned stream_id, int device, void* stream) {
  return launch<NORMAL, float>(out, nullptr, steps, P, B, seed, pair_offset,
                               stream_id, device, stream);
}

// n_valid [B] int64 on the device; out [B, P] int64 (steps = 1). With
// n_valid = 2^24 a negative is the uniform's 24 bits, x >> 8, exactly.
int dgmc_philox_negatives(long long* out, const long long* n_valid,
                          long long P, int B, const unsigned long long* seed,
                          unsigned pair_offset, unsigned stream_id,
                          int device, void* stream) {
  return launch<NEGATIVES, long long>(
      out, reinterpret_cast<const int64_t*>(n_valid), 1, P, B, seed,
      pair_offset, stream_id, device, stream);
}

}  // extern "C"
