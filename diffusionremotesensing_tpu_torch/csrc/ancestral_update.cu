// Fused ancestral DDPM update for Hopper (sm_90a): the CUDA counterpart of
// the TPU kernel diffusionremotesensing_tpu/ops/fused_update.py:
// ancestral_update (:115; _update_kernel :71, _update_kernel_bits :91).
// Over the sampler's state (any shape, n elements) it computes
//
//   x' = ca*x - cb*eps + cn*z,   z = sqrt(-2 log u1) cos(2 pi u2)
//
// with the math in float32 and x' in x's type. u1 = 2 - f1 and u2 = f2 - 1,
// f = the float32 whose bits are 0x3F800000 | (b >> 9): the reference's own
// bits -> normal map (fused_update.py:_bits_to_normal, :53). The bits come
// from a Philox4x32-10 generator (Salmon et al., SC'11) in place of the
// TPU's hardware PRNG: key = the sampler call's two seed words, counter =
// (pair index low, pair index high, step index, 0), and one call gives the
// (b1, b2) of two neighbouring elements: element 2p takes words 0 and 1,
// element 2p + 1 words 2 and 3. With `bits` given (two uint32 planes of n,
// as the reference's _update_kernel_bits takes them) the generator is not
// used. cn = 0 at the last step carries the reference's zero noise there.
// The products and sums are rounded one by one (no contraction into FMA),
// as the plain version's tensor ops round them, so at cn = 0 the result is
// exactly ca*x - cb*eps.
//
// What bounds it. At the main path's shape (B=48, 64x64 s2d pixels, 12
// channels: n = 2,359,296) it reads x and eps and writes x' once, 28.3 MB
// in float32: 8.5 us at the H100's 3.35 TB/s. Its arithmetic (10 Philox
// rounds per pair, a log, a sqrt and a cos per element) is a few hundred
// integer and float operations per element, well under the memory time.
//
// Design. One thread per element pair: one Philox call, two Box-Muller
// draws, coalesced loads and stores (a warp covers 64 consecutive
// elements). The seed words are read from device memory, so the sampler
// draws them once per call without a host-device synchronisation, and the
// step index enters by value: no noise tensor is ever written.

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

// The four words of pair p at `step`.
__device__ __forceinline__ void pair_bits(uint32_t r[4], long long p, uint32_t step,
                                          const long long* seed) {
  r[0] = (uint32_t)p;
  r[1] = (uint32_t)((unsigned long long)p >> 32);
  r[2] = step;
  r[3] = 0u;
  philox4x32_10(r, (uint32_t)seed[0], (uint32_t)seed[1]);
}

__device__ __forceinline__ float bits_to_normal(uint32_t b1, uint32_t b2) {
  const float f1 = __uint_as_float(0x3F800000u | (b1 >> 9));
  const float f2 = __uint_as_float(0x3F800000u | (b2 >> 9));
  const float u1 = 2.0f - f1;  // (0, 1]: log stays finite
  const float u2 = f2 - 1.0f;  // [0, 1)
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// Grid ceil(ceil(n/2) / NTHREADS), NTHREADS threads; thread p owns
// elements 2p and 2p + 1. bits: null, or two planes of n uint32.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
ancestral_update_kernel(const T* __restrict__ x, const T* __restrict__ eps,
                        const uint32_t* __restrict__ bits, const long long* __restrict__ seed,
                        T* __restrict__ out, long long n, float ca, float cb, float cn,
                        uint32_t step) {
  const long long p = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const long long e0 = 2 * p;
  if (e0 >= n) return;
  uint32_t r[4];
  if (bits == nullptr) {
    pair_bits(r, p, step, seed);
  } else {
    r[0] = bits[e0];
    r[1] = bits[n + e0];
    r[2] = e0 + 1 < n ? bits[e0 + 1] : 0u;
    r[3] = e0 + 1 < n ? bits[n + e0 + 1] : 0u;
  }
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const long long e = e0 + l;
    if (e >= n) break;
    const float z = bits_to_normal(r[2 * l], r[2 * l + 1]);
    const float v = __fadd_rn(__fsub_rn(__fmul_rn(ca, to_f(x[e])), __fmul_rn(cb, to_f(eps[e]))),
                              __fmul_rn(cn, z));
    put(out + e, v);
  }
}

// The generator's words for elements [0, n) at `step`, as two planes of n
// (b1 then b2): what ancestral_update_kernel draws, for checking it.
__global__ void __launch_bounds__(NTHREADS)
philox_bits_kernel(const long long* __restrict__ seed, uint32_t* __restrict__ out, long long n,
                   uint32_t step) {
  const long long p = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const long long e0 = 2 * p;
  if (e0 >= n) return;
  uint32_t r[4];
  pair_bits(r, p, step, seed);
  out[e0] = r[0];
  out[n + e0] = r[1];
  if (e0 + 1 < n) {
    out[e0 + 1] = r[2];
    out[n + e0 + 1] = r[3];
  }
}

unsigned grid_for(long long n) {
  return (unsigned)(((n + 1) / 2 + NTHREADS - 1) / NTHREADS);
}

}  // namespace

// ---- host launchers (plain C interface, bound with ctypes)

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// x, eps, out: n contiguous elements of one type, bfloat16 (is_bf16 != 0) or
// float32; bits: null or 2*n uint32; seed: 2 int64 words on the device
// (read when bits is null), each < 2**32.
extern "C" int ancestral_update_launch(const void* x, const void* eps, const void* bits,
                                       const void* seed, void* out, long long n, float ca,
                                       float cb, float cn, unsigned step, int is_bf16,
                                       void* stream) {
  if (n < 1 || (bits == nullptr && seed == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* sd = static_cast<const long long*>(seed);
  if (is_bf16)
    ancestral_update_kernel<bf16><<<grid_for(n), NTHREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(eps), b, sd,
        static_cast<bf16*>(out), n, ca, cb, cn, step);
  else
    ancestral_update_kernel<float><<<grid_for(n), NTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(eps), b, sd,
        static_cast<float*>(out), n, ca, cb, cn, step);
  return (int)cudaGetLastError();
}

// out: 2*n uint32 (b1 plane, then b2 plane).
extern "C" int philox_bits_launch(const void* seed, void* out, long long n, unsigned step,
                                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_bits_kernel<<<grid_for(n), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), static_cast<uint32_t*>(out), n, step);
  return (int)cudaGetLastError();
}
