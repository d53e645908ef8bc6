// Fused ancestral DDPM update for Hopper (sm_90a): the CUDA counterpart of
// the TPU kernel diffusionremotesensing_tpu/ops/fused_update.py:
// ancestral_update (:115; _update_kernel :71, _update_kernel_bits :91).
// Over the sampler's state (any shape, n elements) it computes
//
//   x' = ca*x - cb*eps + cn*z
//
// with the math in float32 and x' in x's type. cn = 0 at the last step
// carries the reference's zero noise there. The products and sums are
// rounded one by one (no contraction into FMA), as the plain version's
// tensor ops round them, so at cn = 0 the result is exactly ca*x - cb*eps.
//
// The noise. A Philox4x32-10 generator (Salmon et al., SC'11) stands in for
// the TPU's hardware PRNG: key = the sampler call's two seed words (read
// from device memory, so the sampler draws them without a host-device
// synchronisation), counter = (quad index low, quad index high, step, 0),
// the step passed by value. One call gives the four words (w0, w1, w2, w3)
// of quad q, elements 4q .. 4q + 3. The quad index counts from `quad0`, the
// first quad of x within the whole state: a slice of the state (one
// replica's share of a chunk split over devices) that starts at quad quad0
// draws the noise the whole state draws there. A band of rows of B items
// (one band of an image split over devices by height) is not contiguous in
// the whole state: x holds `band_quads` quads of each item, and quad q of x
// is quad quad0 + (q / band_quads) * item_quads + q % band_quads of the
// whole state, item_quads the quads of a whole item and quad0 those before
// the band's first row. band_quads = 0 (or item_quads) is the contiguous
// slice above, the same stream bit for bit. Each word pair is one Box-Muller draw
// by the reference's mantissa map (fused_update.py:_bits_to_normal, :53):
// u1 = 2 - f(b1), u2 = f(b2) - 1, f(b) = the float32 whose bits are
// 0x3F800000 | (b >> 9); r = sqrt(-2 log u1). Its two outputs are two
// independent normals:
//
//   z[4q]     = r(w0) cos(2 pi u2(w1))   z[4q + 1] = r(w0) sin(2 pi u2(w1))
//   z[4q + 2] = r(w2) cos(2 pi u2(w3))   z[4q + 3] = r(w2) sin(2 pi u2(w3))
//
// the angle from sincospif(2 u2), which needs no reduction by pi. With
// `bits` given (two uint32 planes of n, as the reference's
// _update_kernel_bits takes them) the generator is not used and element e
// takes (bits[e], bits[n + e]), cosine only: the reference's own map.
//
// What bounds it. At the main path's shape (B=48, 64x64 s2d pixels, 12
// channels: n = 2,359,296) it reads x and eps and writes x' once, 28.3 MB
// in float32: 8.45 us at the H100's 3.35 TB/s. The arithmetic is what a
// thread spends its time on: a Philox call is ~100 integer instructions and
// an accurate log, sqrt and sincospi ~80 more, here shared by four and two
// elements: ~55 instructions an element, ~4.5 us of issue over 132 SMs,
// under the bytes.
//
// Design. A grid-stride loop over quads on as many blocks as the card holds
// at once (the SM count and the blocks an SM holds, read once); each quad's
// x and eps are loaded first, 16 bytes each (8 in bf16), then its noise is
// made while they are in flight, and x' is stored in 16 (8) bytes. A quad
// past n's last multiple of 4, or any quad when a base pointer is not
// aligned to a quad's bytes, takes the same noise through scalar loads and
// stores: nothing raises, and the noise of an element does not depend on
// the path. A band of rows (band_quads != item_quads) costs one 64-bit
// division a quad; a contiguous call takes the uniform branch past it. No shared memory, no tensor cores, no TMA: a pass over
// contiguous data needs only coalesced wide accesses and enough of them in
// flight (2048 threads an SM x 32 bytes, far above the ~15 KB an SM needs
// to cover HBM's latency).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key increments

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// A quad's four elements as one 16-byte (float32) or 8-byte (bf16) access.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  float4 q;
  q.x = v[0];
  q.y = v[1];
  q.z = v[2];
  q.w = v[3];
  *reinterpret_cast<float4*>(p) = q;
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  uint2 q;
  q.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  q.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = q;
}

// Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1).
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c[0], hi0 = __umulhi(kM0, c[0]);
    const uint32_t lo1 = kM1 * c[2], hi1 = __umulhi(kM1, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The four words of quad q at `step`.
__device__ __forceinline__ void quad_bits(uint32_t w[4], long long q, uint32_t step, uint32_t k0,
                                          uint32_t k1) {
  w[0] = (uint32_t)q;
  w[1] = (uint32_t)((unsigned long long)q >> 32);
  w[2] = step;
  w[3] = 0u;
  philox4x32_10(w, k0, k1);
}

// The reference's map of two words to u1 in (0, 1] (log stays finite) and
// 2 u2 in [0, 2).
__device__ __forceinline__ float radius(uint32_t b1) {
  const float u1 = 2.0f - __uint_as_float(0x3F800000u | (b1 >> 9));
  return sqrtf(-2.0f * logf(u1));
}
__device__ __forceinline__ float twice_u2(uint32_t b2) {
  return 2.0f * (__uint_as_float(0x3F800000u | (b2 >> 9)) - 1.0f);
}

// Both Box-Muller outputs of one word pair: (r cos, r sin).
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2, float* c, float* s) {
  const float r = radius(b1);
  float sn, cs;
  sincospif(twice_u2(b2), &sn, &cs);
  *c = r * cs;
  *s = r * sn;
}

// The whole state's quad index of quad q of x: x a contiguous slice from
// quad0 (band_quads = 0, or equal to item_quads), or a band of band_quads
// quads of each item, items item_quads quads apart, the first band at quad0.
__device__ __forceinline__ long long state_quad(long long q, long long quad0, long long item_quads,
                                                long long band_quads) {
  if (band_quads > 0 && band_quads != item_quads)
    return quad0 + (q / band_quads) * item_quads + q % band_quads;
  return quad0 + q;
}

__device__ __forceinline__ float update(float ca, float x, float cb, float e, float cn, float z) {
  return __fadd_rn(__fsub_rn(__fmul_rn(ca, x), __fmul_rn(cb, e)), __fmul_rn(cn, z));
}

// Grid-stride over the ceil(n / 4) quads, NTHREADS threads a block. VEC: x,
// eps and out all start on a quad's bytes, so full quads take the wide
// accesses. bits: null, or two planes of n uint32.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
ancestral_update_kernel(const T* __restrict__ x, const T* __restrict__ eps,
                        const uint32_t* __restrict__ bits, const long long* __restrict__ seed,
                        T* __restrict__ out, long long n, float ca, float cb, float cn,
                        uint32_t step, long long quad0, long long item_quads = 0,
                        long long band_quads = 0) {
  const long long nq = (n + 3) / 4;
  const uint32_t k0 = bits == nullptr ? (uint32_t)seed[0] : 0u;
  const uint32_t k1 = bits == nullptr ? (uint32_t)seed[1] : 0u;
  for (long long q = (long long)blockIdx.x * NTHREADS + threadIdx.x; q < nq;
       q += (long long)gridDim.x * NTHREADS) {
    const long long e0 = 4 * q;
    const bool wide = VEC && e0 + 4 <= n;
    float xv[4], ev[4];
    if (wide) {
      load4(x + e0, xv);
      load4(eps + e0, ev);
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        xv[l] = e0 + l < n ? to_f(x[e0 + l]) : 0.0f;
        ev[l] = e0 + l < n ? to_f(eps[e0 + l]) : 0.0f;
      }
    }
    float z[4];
    if (bits == nullptr) {
      uint32_t w[4];
      quad_bits(w, state_quad(q, quad0, item_quads, band_quads), step, k0, k1);
      box_muller(w[0], w[1], &z[0], &z[1]);
      box_muller(w[2], w[3], &z[2], &z[3]);
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l)
        z[l] = e0 + l < n ? radius(bits[e0 + l]) * cospif(twice_u2(bits[n + e0 + l])) : 0.0f;
    }
    float o[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) o[l] = update(ca, xv[l], cb, ev[l], cn, z[l]);
    if (wide) {
      store4(out + e0, o);
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (e0 + l < n) put(out + e0 + l, o[l]);
    }
  }
}

// The generator's words of the nq quads of x at `step` (x laid out as
// ancestral_update_kernel's quad0, item_quads and band_quads say), one quad
// a thread: out[4q + j] = word j of quad q of x. What
// ancestral_update_kernel draws, for checking it.
__global__ void __launch_bounds__(NTHREADS)
philox_bits_kernel(const long long* __restrict__ seed, uint32_t* __restrict__ out, long long nq,
                   uint32_t step, long long quad0, long long item_quads = 0,
                   long long band_quads = 0) {
  const long long q = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (q >= nq) return;
  uint32_t w[4];
  quad_bits(w, state_quad(q, quad0, item_quads, band_quads), step, (uint32_t)seed[0],
            (uint32_t)seed[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[4 * q + j] = w[j];
}

// Whether x, eps and out all start on a quad's bytes (16 in float32, 8 in
// bf16), so that full quads take the wide accesses.
inline bool quads_aligned(const void* x, const void* eps, const void* out, int is_bf16) {
  const uintptr_t quad_bytes = is_bf16 ? 8 : 16;
  return (((uintptr_t)x | (uintptr_t)eps | (uintptr_t)out) & (quad_bytes - 1)) == 0;
}

}  // namespace

// ---- host launchers (plain C interface, bound with ctypes)

namespace {

// Blocks of `kernel` the card holds at once: SMs x blocks an SM holds, read
// once per kernel (the port runs on one kind of card).
template <typename K>
unsigned resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, 0);
  return (unsigned)((sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1));
}

unsigned grid_for(long long nq, unsigned resident) {
  const long long need = (nq + NTHREADS - 1) / NTHREADS;
  return (unsigned)(need < resident ? need : resident);
}

template <typename T, bool VEC>
void launch(const void* x, const void* eps, const uint32_t* bits, const long long* seed, void* out,
            long long n, float ca, float cb, float cn, unsigned step, long long quad0,
            long long item_quads, long long band_quads, cudaStream_t s) {
  static const unsigned resident = resident_blocks(ancestral_update_kernel<T, VEC>);
  ancestral_update_kernel<T, VEC><<<grid_for((n + 3) / 4, resident), NTHREADS, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(eps), bits, seed, static_cast<T*>(out),
          n, ca, cb, cn, step, quad0, item_quads, band_quads);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// x, eps, out: n contiguous elements of one type, bfloat16 (is_bf16 != 0) or
// float32, at any alignment of the type; bits: null or 2*n uint32; seed: 2
// int64 words on the device (read when bits is null), each < 2**32; quad0:
// the generator's quad index of x's first element (0 for a whole state);
// item_quads, band_quads: 0, or x a band of band_quads quads of each item
// of item_quads quads (n a multiple of 4 * band_quads).
extern "C" int ancestral_update_launch(const void* x, const void* eps, const void* bits,
                                       const void* seed, void* out, long long n, float ca,
                                       float cb, float cn, unsigned step, long long quad0,
                                       long long item_quads, long long band_quads, int is_bf16,
                                       void* stream) {
  if (n < 1 || quad0 < 0 || (bits == nullptr && seed == nullptr) || band_quads < 0 ||
      (band_quads > 0 && (n % (4 * band_quads) || item_quads < band_quads)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* sd = static_cast<const long long*>(seed);
  const bool vec = quads_aligned(x, eps, out, is_bf16);
  if (is_bf16) {
    if (vec)
      launch<bf16, true>(x, eps, b, sd, out, n, ca, cb, cn, step, quad0, item_quads,
                         band_quads, s);
    else
      launch<bf16, false>(x, eps, b, sd, out, n, ca, cb, cn, step, quad0, item_quads,
                          band_quads, s);
  } else {
    if (vec)
      launch<float, true>(x, eps, b, sd, out, n, ca, cb, cn, step, quad0, item_quads,
                          band_quads, s);
    else
      launch<float, false>(x, eps, b, sd, out, n, ca, cb, cn, step, quad0, item_quads,
                           band_quads, s);
  }
  return (int)cudaGetLastError();
}

// out: 4 * ceil(n / 4) uint32, the words of x's quads in turn (quad0,
// item_quads and band_quads as ancestral_update_launch takes them).
extern "C" int philox_bits_launch(const void* seed, void* out, long long n, unsigned step,
                                  long long quad0, long long item_quads, long long band_quads,
                                  void* stream) {
  if (n < 1 || band_quads < 0 ||
      (band_quads > 0 && (n % (4 * band_quads) || item_quads < band_quads)))
    return (int)cudaErrorInvalidValue;
  const long long nq = (n + 3) / 4;
  philox_bits_kernel<<<(unsigned)((nq + NTHREADS - 1) / NTHREADS), NTHREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), static_cast<uint32_t*>(out), nq, step, quad0,
      item_quads, band_quads);
  return (int)cudaGetLastError();
}
