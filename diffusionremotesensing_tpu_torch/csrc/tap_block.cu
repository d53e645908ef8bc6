// Fused s2d ResConvBlock for Hopper (sm_90a): the CUDA counterpart of the
// TPU kernel diffusionremotesensing_tpu/ops/tap_block.py:tap_block (:427,
// pallas_call :437; _tap_block_kernel :76). For one batch item and one tile
// of s2d output pixels it computes
//
//   X1  = im2col4x4(x)                               (16*Ci columns)
//   Y   = X1 @ W1,  W1 = [W_conv1' | W_skip | W_short']  (16Ci x 3*CO4)
//   h   = round(relu(Y_c1 + b1') + Y_sk + b_sk + te4)   (zero outside the
//                                                      image: conv2's SAME padding)
//   out = round(relu(im2col4x4(h) @ W2 + b2' + Y_sh + b_sh'))
//
// with the BatchNorms folded into W1/W2 by ops/tap_block.py:build_block_weights.
// Level 1's block (tap44='l1': Ci=32, Co=64) has no skip conv: W1 is
// [W_conv1' | W_short'] and h = round(relu(Y_c1 + b1') + b_sk + te4), b_sk
// zero. Products accumulate in float32; h and out are rounded to the input
// type where the TPU kernel rounds them.
//
// What bounds it. At the main path's shape (B=48, 128x128 pixels = 64x64
// s2d pixels, Ci=16, Co=32) the block's own work is conv1 and skip (3x3,
// 16->32), conv2 (3x3, 32->32) and the shortcut (1x1, 16->32):
// 2*48*128*128*(2*9*16*32 + 9*32*32 + 16*32) = 29.8 GFLOP, 30 us at the
// H100's 989 TFLOP/s bf16, against 75.5 MB of x, out and weights read or
// written once, 22.5 us at 3.35 TB/s: bound by operations. Level 1 (B=48,
// 32x32 s2d pixels): 22.5 GFLOP against 38.8 MB, 23 us against 12 us.
//
// The products the bfloat16 kernel issues (the tap form's structural zeros
// included): phase A X1 @ [W_conv1' | W_skip] 2*48*64*64*256*256 = 25.8
// GFLOP, phase B im2col4x4(h) @ W2 plus the shortcut's centre rows
// 2*48*64*64*(512 + 64)*128 = 29.0, 54.8 in all at level 0; level 1 12.9 +
// 29.0 = 41.9. The first design multiplied the shortcut over all 16 of its
// row blocks (12 are zero) and issued 64.4 and 51.5.
//
// The bfloat16 kernel is tap_block_sm90.cuh's tap_tc_kernel, two launches
// (phase A into h, phase B from h), which that header describes; its shared
// memory is 231,568 bytes at both levels (3 input planes of 44,032, 6 weight
// pieces of 16,384, 1024 of alignment, 18 mbarriers). The first design (a
// block per 16x16 tile, WMMA 16x16x16 from a staging buffer, each 64-pixel
// pass restaging its weight slice from L2 with no copy/compute overlap, the
// accumulators through a float32 buffer) took 1.41 ms at level 0 and 0.88
// at level 1, B=48.
//
// The seam, a measured choice. (a) h stays in shared memory and each tile
// recomputes its one-pixel halo: over an 8 x 32 tile phase A runs on 10 x 34
// pixels, 6 M-tiles of 64 instead of 4 (1.5x); (b) h goes through device
// memory between two launches. Phase A over 1.5x the pixels (B=72) took
// 0.0809 ms against 0.0575 at B=48, so (a) costs ~0.023 ms, against at most
// 0.030 ms for h's 50,331,648 bytes written and read once at 3.35 TB/s
// (h is read right after it is written, mostly from the 50 MB L2). (a) also
// needs h's 10 x 34 x 128 slab (87 KB) in shared memory beside phase B's
// planes and weight ring, which leaves no room for either ring. (b) is the
// design.
//
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W), bf16, B=48: level 0 0.140 ms (phase A 0.058, phase B 0.076),
// level 1 0.103 ms (0.029, 0.067), against 1.20 and 0.52 ms for the cuDNN
// dense-s2d block; B=1 (device time) 0.024 and 0.033 ms. ptxas: 168
// registers at launch (the most a 384-thread block gets), raised to 232 in
// the consumers by setmaxnreg, no spills; at 168 the consumers spilled
// 112-140 bytes.
//
// float32 (the golden and model phases' type, not the served one) keeps the
// first design's passes as FMA on the CUDA cores (tap_block_fma_kernel): K
// staged 32 rows at a time, each of 256 threads owning 4 pixels x 8 columns,
// h and its halo in shared memory.

#include "tap_block_sm90.cuh"

namespace {

constexpr int TW = 16;              // output tile width, s2d pixels
constexpr int SW = TW + 2;          // h slab width: tile + one-pixel halo
constexpr int NTHREADS = 256;
constexpr int MP = 64;              // pixels per GEMM pass
constexpr int NP = 128;             // columns per GEMM pass


// Output tile rows for 4Co channels: 16 at level 0, 8 at level 1 (its h
// slab would not fit beside the staging otherwise).
__host__ __device__ constexpr int tile_rows(int CO4) { return CO4 <= 128 ? 16 : 8; }


// ---------------------------------------- float32: FMA kernel (first design)

constexpr int KC = 32;              // K rows staged per step
constexpr int MPS = MP + 1;         // As row stride: the staging stores, 32
                                    // consecutive K rows of one pixel, hit
                                    // 32 different banks

// Column k of im2col4x4(x) at s2d pixel (y, x), zero outside the image.
__device__ __forceinline__ float x_im2col(const float* __restrict__ xb, int y, int x, int k,
                                          int Ci, int H2, int W2, int C4) {
  const int piece = k / Ci;
  const int c = k - piece * Ci;
  const int yy = y + kPieceRow[piece] - 1;
  const int xx = x + kPieceCol[piece] - 1;
  if (yy < 0 || yy >= H2 || xx < 0 || xx >= W2) return 0.f;
  return xb[((size_t)yy * W2 + xx) * C4 + (piece & 3) * Ci + c];
}

// Column k of im2col4x4(h) at tile pixel (oy, ox), from the h slab in shared
// memory (slab pixel (oy + 1, ox + 1) is the output pixel itself).
__device__ __forceinline__ float h_im2col(const float* hs, int oy, int ox, int k, int Cm,
                                          int CO4) {
  const int piece = k / Cm;
  const int c = k - piece * Cm;
  return hs[((oy + kPieceRow[piece]) * SW + ox + kPieceCol[piece]) * CO4 + (piece & 3) * Cm + c];
}

// acc[i][j] += sum_kk As[kk][tm + 16 i] * Bs[kk][col_j], with col_j =
// 4 tn + j for j < 4 and 64 + 4 tn + (j - 4) for j >= 4.
__device__ __forceinline__ void fma_chunk(const float* As, const float* Bs, float acc[4][8],
                                          int tm, int tn) {
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk * MPS + tm + 16 * i];
    const float4 lo = *reinterpret_cast<const float4*>(Bs + kk * NP + 4 * tn);
    const float4 hi = *reinterpret_cast<const float4*>(Bs + kk * NP + 64 + 4 * tn);
    const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Grid (ceil(W2/16), ceil(H2/TH), B), NTHREADS threads, dynamic shared
// memory fma_smem_bytes(CO4). Requires C4 % 8 == 0, CO4 % 128 == 0.
template <int TH, bool SKIP>
__global__ void __launch_bounds__(NTHREADS)
tap_block_fma_kernel(const float* __restrict__ x, const float* __restrict__ te4,
                     const float* __restrict__ w1, const float* __restrict__ w2,
                     const float* __restrict__ b1, const float* __restrict__ bsk,
                     const float* __restrict__ bsh, const float* __restrict__ b2,
                     float* __restrict__ out, int H2, int W2, int C4, int CO4) {
  constexpr int SH = TH + 2;                       // h slab rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [KC][MPS]
  float* Bs = As + KC * MPS;                       // [KC][NP]
  float* hs = Bs + KC * NP;                        // [SH * SW][CO4]

  const int tid = threadIdx.x;
  const int tm = tid / 16;
  const int tn = tid % 16;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int Ci = C4 / 4;
  const int Cm = CO4 / 4;
  const int K1 = 16 * Ci;   // x im2col width (rows of W1)
  const int K2 = 16 * Cm;   // h im2col width (rows of W2)
  const int N1 = (SKIP ? 3 : 2) * CO4;  // row length of W1
  const float* xb = x + (size_t)b * H2 * W2 * C4;

  // ---- phase A: h on the slab. With the skip, 64 h channels per pass: W1
  // columns [n0, n0+64) (conv1) and [CO4+n0, CO4+n0+64) (skip) side by
  // side; without it, 128 h channels: conv1 columns [n0, n0+128)
  const int hi_col = SKIP ? CO4 : 64;  // W1 column of Bs column 64, less n0
  for (int n0 = 0; n0 < CO4; n0 += (SKIP ? 64 : 128)) {
    for (int p0 = 0; p0 < SH * SW; p0 += MP) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K1; k0 += KC) {
        for (int e = tid; e < KC * MP; e += NTHREADS) {
          const int kk = e % KC, pp = e / KC, p = p0 + pp;
          float v = 0.f;
          if (p < SH * SW)
            v = x_im2col(xb, y0 - 1 + p / SW, x0 - 1 + p % SW, k0 + kk, Ci, H2, W2, C4);
          As[kk * MPS + pp] = v;
        }
        for (int e = tid; e < KC * NP; e += NTHREADS) {
          const int kk = e / NP, c = e % NP;
          const int col = c < 64 ? n0 + c : hi_col + n0 + (c - 64);
          Bs[kk * NP + c] = w1[(size_t)(k0 + kk) * N1 + col];
        }
        __syncthreads();
        fma_chunk(As, Bs, acc, tm, tn);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + tm + 16 * i;
        if (p >= SH * SW) continue;
        const int hy = y0 - 1 + p / SW, hx = x0 - 1 + p % SW;
        const bool inside = hy >= 0 && hy < H2 && hx >= 0 && hx < W2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // with the skip, column j + 4 is channel j's skip term
          if (SKIP && j >= 4) break;
          const int n = n0 + (j < 4 ? 4 * tn + j : 64 + 4 * tn + (j - 4));
          const float sk = SKIP ? acc[i][4 + j] : 0.f;
          hs[p * CO4 + n] = inside ? fmaxf(acc[i][j] + b1[n], 0.f) + sk + bsk[n] +
                                         te4[(size_t)b * CO4 + n]
                                   : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // ---- phase B: conv2 on the slab (K rows [0, K2) of W2) plus the shortcut
  // (K rows [K2, K2+K1): the x im2col against W1's last CO4 columns)
  for (int n0 = 0; n0 < CO4; n0 += NP) {
    for (int p0 = 0; p0 < TH * TW; p0 += MP) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K2 + K1; k0 += KC) {
        for (int e = tid; e < KC * MP; e += NTHREADS) {
          const int kk = e % KC, pp = e / KC, p = p0 + pp, k = k0 + kk;
          const int oy = p / TW, ox = p % TW;
          As[kk * MPS + pp] = k < K2 ? h_im2col(hs, oy, ox, k, Cm, CO4)
                                     : x_im2col(xb, y0 + oy, x0 + ox, k - K2, Ci, H2, W2, C4);
        }
        for (int e = tid; e < KC * NP; e += NTHREADS) {
          const int kk = e / NP, c = e % NP, k = k0 + kk;
          Bs[kk * NP + c] = k < K2 ? w2[(size_t)k * CO4 + n0 + c]
                                   : w1[(size_t)(k - K2) * N1 + N1 - CO4 + n0 + c];
        }
        __syncthreads();
        fma_chunk(As, Bs, acc, tm, tn);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + tm + 16 * i;
        const int gy = y0 + p / TW, gx = x0 + p % TW;
        if (gy >= H2 || gx >= W2) continue;
        float* o = out + (((size_t)b * H2 + gy) * W2 + gx) * CO4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + (j < 4 ? 4 * tn + j : 64 + 4 * tn + (j - 4));
          o[n] = fmaxf(acc[i][j] + b2[n] + bsh[n], 0.f);
        }
      }
    }
  }
}

size_t fma_smem_bytes(int CO4) {
  return (size_t)(KC * MPS + KC * NP + (tile_rows(CO4) + 2) * SW * CO4) * sizeof(float);
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*, const T*,
                        const T*, T*, int, int, int, int);

Kernel<float> pick_fma(int th, bool skip) {
  return th == 16 ? (skip ? tap_block_fma_kernel<16, true> : tap_block_fma_kernel<16, false>)
                  : (skip ? tap_block_fma_kernel<8, true> : tap_block_fma_kernel<8, false>);
}

// p: x, te4, w1, w2, b1, bsk, bsh, b2
int launch_fma(const void* const* p, void* out, int B, int H2, int W2, int C4, int CO4,
               bool skip, cudaStream_t s) {
  const int th = tile_rows(CO4);
  Kernel<float> kernel = pick_fma(th, skip);
  const size_t smem = fma_smem_bytes(CO4);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W2 + TW - 1) / TW, (H2 + th - 1) / th, B);
  auto a = [&](int i) { return static_cast<const float*>(p[i]); };
  kernel<<<grid, NTHREADS, smem, s>>>(a(0), a(1), a(2), a(3), a(4), a(5), a(6), a(7),
                                      static_cast<float*>(out), H2, W2, C4, CO4);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" size_t tap_block_smem(int CO4, int is_bf16) {
  return is_bf16 ? (size_t)TC_BYTES : fma_smem_bytes(CO4);
}

// Launch on `stream`; returns the first cudaError_t (0 on success). Shapes:
// x (B,H2,W2,C4), te4 (B,CO4), w1 (4*C4, 3*CO4), or (4*C4, 2*CO4) with
// has_skip == 0, w2 (4*CO4, CO4), b1/bsk/bsh/b2 (CO4,), out and h
// (B,H2,W2,CO4); all contiguous, all of one type. bfloat16 (is_bf16 != 0)
// takes level 0 (C4 = 64, CO4 = 128, has_skip) and level 1 (C4 = 128,
// CO4 = 256, no skip), with h the seam between its two launches; float32
// takes C4 % 8 == 0, CO4 % 128 == 0, CO4 <= 256, and no h (may be null).
extern "C" int tap_block_launch(const void* x, const void* te4, const void* w1, const void* w2,
                                const void* b1, const void* bsk, const void* bsh, const void* b2,
                                void* out, void* h, int B, int H2, int W2, int C4, int CO4,
                                int has_skip, int is_bf16, void* stream) {
  if (B < 1 || H2 < 1 || W2 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* p[8] = {x, te4, w1, w2, b1, bsk, bsh, b2};
  if (is_bf16) {
    if (C4 == 64 && CO4 == 128 && has_skip) return launch_block_tc<0>(p, h, out, B, H2, W2, s);
    if (C4 == 128 && CO4 == 256 && !has_skip) return launch_block_tc<1>(p, h, out, B, H2, W2, s);
    return (int)cudaErrorInvalidValue;
  }
  if (C4 % 8 != 0 || CO4 % 128 != 0 || CO4 > 256) return (int)cudaErrorInvalidValue;
  return launch_fma(p, out, B, H2, W2, C4, CO4, has_skip, s);
}
