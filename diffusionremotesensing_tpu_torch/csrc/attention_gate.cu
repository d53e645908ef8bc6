// Fused additive attention gate for Hopper (sm_90a): the CUDA counterpart
// of the TPU kernel diffusionremotesensing_tpu/ops/pallas_kernels.py:
// fused_attention_gate (:94; _gate_kernel :50). Per gating pixel (i, j) of
// g (B, H/2, W/2, C) and the 2x2 taps x_t = x[2i+di, 2j+dj] (t = 2 di + dj)
// of x (B, H, W, C):
//
//   a     = relu(g @ Wg + bg + sum_t x_t @ Wx_t + bx)   (w_g 1x1, w_x 2x2/s2)
//   psi   = sigmoid(a @ wpsi + bpsi)                    (one channel)
//   r_t   = (x_t * psi) @ Wr + br                       (result 1x1 conv)
//   out_t = (r_t - mean) * rsqrt(var + 1e-5) * scale + bias   (inference BN)
//
// all in float32, as the TPU kernel computes it (its weights are float32),
// with only out rounded to x's type. psi is one value per gating pixel,
// broadcast over the 2x2 taps (the reference's nearest x2 upsample), and
// the result conv is four C x C products, not the TPU kernel's
// block-diagonal (4C, 4C) matrix, whose zeros are not multiplied.
//
// What bounds it. The gate reads x and g and writes out once. At the main
// path's shapes (B=48, HR 128) gate 1 (C=64, x 64x64) moves 56.6 MB in
// bfloat16 (17 us at 3.35 TB/s) for 2*9*C*C = 73.7 KFLOP per gating pixel,
// 3.6 GFLOP (4 us at 989 TFLOP/s bf16); gate 0 (C=128, x 32x32) 28.3 MB
// (8 us) and 3.6 GFLOP. Both are bound by bytes at the bf16 rate. The
// kernel computes in float32 on the CUDA cores (67 TFLOP/s), where the same
// products take 54 us: the float32 arithmetic the reference fixes, not the
// bytes, is what bounds this kernel.
//
// Design. The TPU kernel ran one program per batch item over the whole
// (H/2, W/2) grid in VMEM, with the s2d / d2s layout transforms outside
// the call. Here a block takes P = 32 gating pixels (flattened over
// B x H/2 x W/2) and gathers their 2x2 taps itself from x in NHWC, so no
// layout copy exists: x (as float32) and g go to shared memory once; a
// thread owns 4 output channels of P*C/1024 pixels (then 4P*C/1024 tap
// rows) and reads each float32 weight row once per block through the
// caches, 4 columns at a time. psi is one thread per pixel. No tensor
// cores (float32), no copy/compute overlap.

#include "warp_tile.cuh"

namespace {

using wt::bf16;
using wt::from_f;
using wt::to_f;

constexpr int NTHREADS = 256;
constexpr int P = 32;  // gating pixels a block

// The gate's float32 weights, each contiguous: wg (C, C) and wx (4C, C) as
// [in][out] (wx's rows tap-major: t*C + c), wr (C, C), the rest (C,);
// bpsi (1,).
struct GateWeights {
  const float *wg, *bg, *wx, *bx, *wpsi, *bpsi, *wr, *br, *scale, *bias, *mean, *var;
};

template <int C> struct Smem {
  static constexpr int LDX = 4 * C + 4;  // x taps of a pixel (float32)
  static constexpr int LDG = C + 4;      // g of a pixel
  static constexpr int LDA = C + 1;      // a of a pixel (read down a column for psi)
  static constexpr size_t xs = 0;
  static constexpr size_t gs = wt::align128(xs + sizeof(float) * P * LDX);
  static constexpr size_t as = wt::align128(gs + sizeof(float) * P * LDG);
  static constexpr size_t ps = wt::align128(as + sizeof(float) * P * LDA);
  static constexpr size_t bytes = ps + sizeof(float) * P;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][0..3] += sum_k A[off_i + k] * W[k][4 tc .. 4 tc + 3], k < K (W's
// rows C floats long): row i of the operand starts at A + off_i
template <int C, int R>
__device__ __forceinline__ void rows_times(float (*acc)[4], const float* A, const int* off,
                                           const float* W, int K, int tc) {
  for (int k = 0; k < K; ++k) {
    const float4 w = load4(W + (size_t)k * C + 4 * tc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a = A[off[i] + k];
      acc[i][0] = fmaf(a, w.x, acc[i][0]);
      acc[i][1] = fmaf(a, w.y, acc[i][1]);
      acc[i][2] = fmaf(a, w.z, acc[i][2]);
      acc[i][3] = fmaf(a, w.w, acc[i][3]);
    }
  }
}

// Grid ceil(B * Hg * Wg / P), NTHREADS threads, dynamic shared memory
// Smem<C>::bytes. x (B, 2Hg, 2Wg, C), g (B, Hg, Wg, C), out like x.
template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
attention_gate_kernel(const T* __restrict__ x, const T* __restrict__ g, GateWeights w,
                      T* __restrict__ out, int N, int Hg, int Wg) {
  using L = Smem<C>;
  constexpr int CG = C / 4;            // column groups of 4 output channels
  constexpr int NPG = NTHREADS / CG;   // pixel groups
  constexpr int PX = P / NPG;          // pixels a thread (phase 2)
  constexpr int RX = 4 * P / NPG;      // tap rows a thread (phase 4)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw + L::xs);
  float* gs = reinterpret_cast<float*>(smem_raw + L::gs);
  float* as = reinterpret_cast<float*>(smem_raw + L::as);
  float* ps = reinterpret_cast<float*>(smem_raw + L::ps);
  const int n0 = blockIdx.x * P;
  const int tc = threadIdx.x % CG, tp = threadIdx.x / CG;
  const int W = 2 * Wg;

  // ---- phase 1: the block's x taps and g, as float32 (zero past N)
  for (int e = threadIdx.x; e < P * 4 * C; e += NTHREADS) {
    const int p = e / (4 * C), k = e % (4 * C), t = k / C, c = k % C, n = n0 + p;
    float v = 0.f;
    if (n < N) {
      const int b = n / (Hg * Wg), ij = n % (Hg * Wg), i = ij / Wg, j = ij % Wg;
      v = to_f(x[(((size_t)b * 2 * Hg + 2 * i + (t >> 1)) * W + 2 * j + (t & 1)) * C + c]);
    }
    xs[p * L::LDX + k] = v;
  }
  for (int e = threadIdx.x; e < P * C; e += NTHREADS) {
    const int p = e / C, c = e % C, n = n0 + p;
    gs[p * L::LDG + c] = n < N ? to_f(g[(size_t)n * C + c]) : 0.f;
  }
  __syncthreads();

  // ---- phase 2: a = relu(g @ Wg + x @ Wx + bg + bx)
  {
    int og[PX], ox[PX];
    float acc[PX][4] = {};
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      og[i] = (tp * PX + i) * L::LDG;
      ox[i] = (tp * PX + i) * L::LDX;
    }
    rows_times<C, PX>(acc, gs, og, w.wg, C, tc);
    rows_times<C, PX>(acc, xs, ox, w.wx, 4 * C, tc);
#pragma unroll
    for (int i = 0; i < PX; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * tc + q;
        as[(tp * PX + i) * L::LDA + c] = fmaxf(acc[i][q] + w.bg[c] + w.bx[c], 0.f);
      }
  }
  __syncthreads();

  // ---- phase 3: psi = sigmoid(a @ wpsi + bpsi), one thread a pixel
  for (int p = threadIdx.x; p < P; p += NTHREADS) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(as[p * L::LDA + c], w.wpsi[c], s);
    ps[p] = 1.f / (1.f + expf(-(s + w.bpsi[0])));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < P * 4 * C; e += NTHREADS) {  // gated = x * psi, in place
    const int p = e / (4 * C), k = e % (4 * C);
    xs[p * L::LDX + k] *= ps[p];
  }
  __syncthreads();

  // ---- phase 4: out_t = BN(gated_t @ Wr + br), tap row (p, t) = 4 p + t
  {
    int off[RX];  // tap row (p, t)'s operand: the C floats of xs at pixel p, tap t
    float acc[RX][4] = {};
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const int row = tp * RX + i;
      off[i] = (row >> 2) * L::LDX + (row & 3) * C;
    }
    rows_times<C, RX>(acc, xs, off, w.wr, C, tc);
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const int row = tp * RX + i, p = row >> 2, t = row & 3, n = n0 + p;
      if (n >= N) continue;
      const int b = n / (Hg * Wg), ij = n % (Hg * Wg), gi = ij / Wg, gj = ij % Wg;
      T* o = out + (((size_t)b * 2 * Hg + 2 * gi + (t >> 1)) * W + 2 * gj + (t & 1)) * C;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * tc + q;
        const float r = acc[i][q] + w.br[c];
        o[c] = from_f<T>((r - w.mean[c]) * rsqrtf(w.var[c] + 1e-5f) * w.scale[c] + w.bias[c]);
      }
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T, int C>
int launch(const void* x, const void* g, const GateWeights& w, void* out, int N, int Hg, int Wg,
           cudaStream_t s) {
  const size_t smem = Smem<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_gate_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_gate_kernel<T, C><<<(N + P - 1) / P, NTHREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w, static_cast<T*>(out), N, Hg, Wg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const void* x, const void* g, const GateWeights& w, void* out, int N, int Hg, int Wg,
             int C, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 32>(x, g, w, out, N, Hg, Wg, s);
    case 64: return launch<T, 64>(x, g, w, out, N, Hg, Wg, s);
    case 128: return launch<T, 128>(x, g, w, out, N, Hg, Wg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// x (B, 2Hg, 2Wg, C) and g (B, Hg, Wg, C) in one type, bfloat16 (is_bf16
// != 0) or float32; wp: the 12 float32 weights in GateWeights' order;
// out like x. C is 32, 64 or 128.
extern "C" int attention_gate_launch(const void* x, const void* g, const void* const* wp,
                                     void* out, int B, int Hg, int Wg, int C, int is_bf16,
                                     void* stream) {
  if (B < 1 || Hg < 1 || Wg < 1) return (int)cudaErrorInvalidValue;
  const float* f[12];
  for (int i = 0; i < 12; ++i) f[i] = static_cast<const float*>(wp[i]);
  const GateWeights w = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = B * Hg * Wg;
  return is_bf16 ? launch_c<bf16>(x, g, w, out, N, Hg, Wg, C, s)
                 : launch_c<float>(x, g, w, out, N, Hg, Wg, C, s);
}
