// Fused s2d ResConvBlock-0 for Hopper (sm_90a): the CUDA counterpart of the
// TPU kernel diffusionremotesensing_tpu/ops/tap_block.py:tap_block
// (_tap_block_kernel, :76). For one batch item and one tile of s2d output
// pixels (16 wide, 16 rows at level 0, 8 at level 1) it computes
//
//   X1  = im2col4x4(x)                               (16*Ci columns)
//   Y   = X1 @ W1,  W1 = [W_conv1' | W_skip | W_short']  (16Ci x 3*CO4)
//   h   = relu(Y_c1 + b1') + Y_sk + b_sk + te4       (zero outside the image:
//                                                      conv2's SAME padding)
//   out = relu(im2col4x4(h) @ W2 + b2' + Y_sh + b_sh')
//
// with the BatchNorms folded into W1/W2 by ops/tap_block.py:build_block_weights.
// Level 1's block (tap44='l1': Ci=32, Co=64) has no skip conv: W1 is
// [W_conv1' | W_short'] (16Ci x 2*CO4) and h = relu(Y_c1 + b1') + b_sk + te4
// (SKIP = false; b_sk is zero there). The tile rows and SKIP are template
// parameters, so neither level's instantiation branches on the other's
// shape at run time.
// Every product is accumulated in float32, and h is rounded to the input
// type before conv2, as the TPU kernel does.
//
// What bounds it. At the main path's shape (B=48, 128x128 pixels = 64x64
// s2d pixels, Ci=16, Co=32) the block's own work is conv1 and skip (3x3,
// 16->32), conv2 (3x3, 32->32) and the shortcut (1x1, 16->32):
// 2*48*128*128*(2*9*16*32 + 9*32*32 + 16*32) = 29.8 GFLOP, and the bytes are
// 75.5 MB (x and out in bf16, weights once): 30 us at the H100's
// 989 TFLOP/s bf16 tensor rate against 22.5 us at 3.35 TB/s, so the function
// is bound by operations. The tap formulation below issues more than that:
// its products 2*48*64*64*(256*384 + 512*128) = 64.4 GFLOP carry structural
// zeros (a 3x3 conv as a 4x4 tap im2col, the 1x1 shortcut spread over a
// 256x128 block of W1). Level 1 (B=48, 32x32 s2d pixels, Ci=32, Co=64, no
// skip conv): 22.5 GFLOP against 38.8 MB, 23 us against 12 us, so bound by
// operations too.
//
// Design. The TPU kernel's (B, 2) grid ran in order on one core over whole
// 32-row halves held in VMEM. Here blocks run in parallel over output
// tiles, and the intermediate h of the tile plus its one-pixel halo (18x18x
// CO4 at level 0) lives in shared memory, so it never reaches device memory.
// Phase A computes h over the slab (the halo is recomputed by the
// neighbouring tiles, 27% extra conv1 work at level 0); phase B runs conv2
// on h from shared memory and, as extra K rows of the same product, the
// shortcut columns of W1 on x. Both phases are one GEMM over passes of 64
// pixels x 128 columns (phase A with the skip: 64 conv1 | 64 skip columns;
// without it: 128 conv1 columns).
//
// Level 1 (CO4 = 256) doubles the slab's channels: an 18x18 h slab would be
// 166 KB in bfloat16 beside the 135 KB of staging. Its tile is 16 wide and
// 8 rows (TH, a template parameter), so the slab is 10x18 pixels: 229,376
// bytes in all at bfloat16, 209,024 at float32. A pass still covers 64
// pixels; the halo costs 41% extra conv1 work (3 passes for 180 slab
// pixels, against 2 for the 128 tile pixels).
//
// * bfloat16 (the served path): tensor cores through WMMA 16x16x16 tiles,
//   float32 accumulators. A pass stages up to 256 K rows of the im2col (from
//   x in device memory, or from h in shared memory) and of the weights in
//   shared memory with 16-byte copies; 8 warps each own 16 pixels x 64
//   columns. One block per SM (215 KB of shared memory at level 0, 224 KB
//   at level 1), no copy/compute overlap yet: wgmma with TMA staging and a
//   pipeline is the later step.
// * float32: the same passes as FMA on the CUDA cores, K staged 32 rows at
//   a time as float32, each of 256 threads owning 4 pixels x 8 columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TW = 16;              // output tile width, s2d pixels
constexpr int SW = TW + 2;          // h slab width: tile + one-pixel halo
constexpr int NTHREADS = 256;
constexpr int MP = 64;              // pixels per GEMM pass
constexpr int NP = 128;             // columns per GEMM pass

// im2col piece table, in the order of ops/tap_conv.py:_ORDER: piece k reads
// the s2d input shifted by (row - 1, col - 1) pixels, tap block k % 4.
__constant__ int kPieceRow[16] = {1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 1, 1, 2, 2, 1, 1};
__constant__ int kPieceCol[16] = {1, 0, 1, 0, 2, 1, 2, 1, 1, 0, 1, 0, 2, 1, 2, 1};

// Output tile rows for 4Co channels: 16 at level 0, 8 at level 1 (its h
// slab would not fit beside the staging otherwise).
__host__ __device__ constexpr int tile_rows(int CO4) { return CO4 <= 128 ? 16 : 8; }

// s2d image coordinates of pixel p of a pass: phase A walks the (TH+2)x18
// slab (origin one pixel up and left of the tile), phase B the THx16 tile.
struct PixelMap {
  int y0, x0, edge, count;
  __device__ __forceinline__ bool valid(int p) const { return p < count; }
  __device__ __forceinline__ int y(int p) const { return y0 + p / edge; }
  __device__ __forceinline__ int x(int p) const { return x0 + p % edge; }
};

// ------------------------------------------------------------ float32 (FMA)

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

// ---------------------------------------------------- bfloat16 (tensor cores)

constexpr int KCH = 256;            // K rows staged per pass
constexpr int LDA = KCH + 8;        // row strides in elements; the pads move
constexpr int LDB = NP + 8;         // consecutive rows to other banks and keep
constexpr int LDC = NP + 4;         // every WMMA tile 32-byte aligned

// Stage K rows [k0, k0 + kn) of the x im2col for the pass's 64 pixels into
// As, 8 channels (16 bytes) per copy; zero outside the image and past the
// pass's last pixel. Requires Ci % 8 == 0.
__device__ __forceinline__ void stage_x(bf16* As, const bf16* __restrict__ xb, PixelMap pm,
                                       int p0, int k0, int kn, int Ci, int H2, int W2, int C4) {
  const int units = kn / 8;
  for (int e = threadIdx.x; e < MP * units; e += NTHREADS) {
    const int pp = e / units, u = e % units, p = p0 + pp, k = k0 + 8 * u;
    const int piece = k / Ci, c = k - piece * Ci;
    uint4 v = {0u, 0u, 0u, 0u};
    if (pm.valid(p)) {
      const int yy = pm.y(p) + kPieceRow[piece] - 1;
      const int xx = pm.x(p) + kPieceCol[piece] - 1;
      if (yy >= 0 && yy < H2 && xx >= 0 && xx < W2)
        v = *reinterpret_cast<const uint4*>(xb + ((size_t)yy * W2 + xx) * C4 + (piece & 3) * Ci + c);
    }
    *reinterpret_cast<uint4*>(As + pp * LDA + 8 * u) = v;
  }
}

// Stage K rows [k0, k0 + kn) of the h im2col for tile pixels p0.. from the
// slab. Requires Cm % 8 == 0.
__device__ __forceinline__ void stage_h(bf16* As, const bf16* hs, int p0, int k0, int kn, int Cm,
                                       int CO4) {
  const int units = kn / 8;
  for (int e = threadIdx.x; e < MP * units; e += NTHREADS) {
    const int pp = e / units, u = e % units, p = p0 + pp, k = k0 + 8 * u;
    const int piece = k / Cm, c = k - piece * Cm;
    const int s = (p / TW + kPieceRow[piece]) * SW + p % TW + kPieceCol[piece];
    *reinterpret_cast<uint4*>(As + pp * LDA + 8 * u) =
        *reinterpret_cast<const uint4*>(hs + s * CO4 + (piece & 3) * Cm + c);
  }
}

// Stage rows [k0, k0 + kn) of a row-major weight matrix (row length ld):
// Bs columns [0, 64) from columns [c_lo, c_lo + 64), [64, 128) from
// [c_hi, c_hi + 64).
__device__ __forceinline__ void stage_w(bf16* Bs, const bf16* __restrict__ w, int ld, int k0,
                                       int kn, int c_lo, int c_hi) {
  for (int e = threadIdx.x; e < kn * (NP / 8); e += NTHREADS) {
    const int r = e / (NP / 8), u = e % (NP / 8);
    const int col = u < 8 ? c_lo + 8 * u : c_hi + 8 * (u - 8);
    *reinterpret_cast<uint4*>(Bs + r * LDB + 8 * u) =
        *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ld + col);
  }
}

using namespace nvcuda;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// acc[j] += As[16 wm .. +16][0 .. kn) @ Bs[0 .. kn)[64 wn + 16 j .. +16]
__device__ __forceinline__ void mma_pass(const bf16* As, const bf16* Bs, AccFrag acc[4], int kn,
                                         int wm, int wn) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
  for (int kk = 0; kk < kn; kk += 16) {
    wmma::load_matrix_sync(af, As + 16 * wm * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::load_matrix_sync(bfr, Bs + kk * LDB + 64 * wn + 16 * j, LDB);
      wmma::mma_sync(acc[j], af, bfr, acc[j]);
    }
  }
}

__device__ __forceinline__ void store_acc(float* Cs, AccFrag acc[4], int wm, int wn) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Cs + 16 * wm * LDC + 64 * wn + 16 * j, acc[j], LDC,
                            wmma::mem_row_major);
}

// Grid (ceil(W2/16), ceil(H2/TH), B), NTHREADS threads, dynamic shared
// memory tc_smem_bytes(CO4). Requires C4 % 32 == 0, CO4 % 128 == 0.
template <int TH, bool SKIP>
__global__ void __launch_bounds__(NTHREADS, 1)
tap_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ te4,
                    const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b1, const bf16* __restrict__ bsk,
                    const bf16* __restrict__ bsh, const bf16* __restrict__ b2,
                    bf16* __restrict__ out, int H2, int W2, int C4, int CO4) {
  constexpr int SH = TH + 2;                          // h slab rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Cs = reinterpret_cast<float*>(smem_raw);     // [MP][LDC]   accumulators out
  bf16* As = reinterpret_cast<bf16*>(Cs + MP * LDC);  // [MP][LDA]   im2col rows
  bf16* Bs = As + MP * LDA;                           // [KCH][LDB]  weight rows
  bf16* hs = Bs + KCH * LDB;                          // [SH*SW][CO4]

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int Ci = C4 / 4;
  const int Cm = CO4 / 4;
  const int K1 = 16 * Ci;
  const int K2 = 16 * Cm;
  const int N1 = (SKIP ? 3 : 2) * CO4;
  const bf16* xb = x + (size_t)b * H2 * W2 * C4;
  const PixelMap slab = {y0 - 1, x0 - 1, SW, SH * SW};
  const PixelMap tile = {y0, x0, TW, TH * TW};
  AccFrag acc[4];

  // ---- phase A: h on the slab; a pass is 64 slab pixels x (64 conv1
  // columns [n0, n0+64) | 64 skip columns [CO4+n0, CO4+n0+64)), or without
  // the skip 128 conv1 columns [n0, n0+128)
  constexpr int nh = SKIP ? 64 : 128;  // h channels a pass
  for (int n0 = 0; n0 < CO4; n0 += nh) {
    for (int p0 = 0; p0 < SH * SW; p0 += MP) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int k0 = 0; k0 < K1; k0 += KCH) {
        const int kn = min(KCH, K1 - k0);
        stage_x(As, xb, slab, p0, k0, kn, Ci, H2, W2, C4);
        stage_w(Bs, w1, N1, k0, kn, n0, (SKIP ? CO4 : 64) + n0);
        __syncthreads();
        mma_pass(As, Bs, acc, kn, wm, wn);
        __syncthreads();
      }
      store_acc(Cs, acc, wm, wn);
      __syncthreads();
      for (int e = threadIdx.x; e < MP * nh; e += NTHREADS) {
        const int pp = e / nh, c = e % nh, p = p0 + pp, n = n0 + c;
        if (!slab.valid(p)) continue;
        const int hy = slab.y(p), hx = slab.x(p);
        float v = 0.f;
        if (hy >= 0 && hy < H2 && hx >= 0 && hx < W2)
          v = fmaxf(Cs[pp * LDC + c] + __bfloat162float(b1[n]), 0.f) +
              (SKIP ? Cs[pp * LDC + 64 + c] : 0.f) + __bfloat162float(bsk[n]) +
              __bfloat162float(te4[(size_t)b * CO4 + n]);
        hs[p * CO4 + n] = __float2bfloat16(v);
      }
      __syncthreads();
    }
  }

  // ---- phase B: conv2 on h (W2 rows [0, K2)) plus the shortcut (x im2col
  // against W1's columns [2*CO4, 3*CO4)), 64 tile pixels x 128 columns a pass
  for (int n0 = 0; n0 < CO4; n0 += NP) {
    for (int p0 = 0; p0 < TH * TW; p0 += MP) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int k0 = 0; k0 < K2 + K1; k0 += KCH) {
        int kn;
        if (k0 < K2) {
          kn = min(KCH, K2 - k0);
          stage_h(As, hs, p0, k0, kn, Cm, CO4);
          stage_w(Bs, w2, CO4, k0, kn, n0, n0 + 64);
        } else {
          kn = min(KCH, K2 + K1 - k0);
          stage_x(As, xb, tile, p0, k0 - K2, kn, Ci, H2, W2, C4);
          stage_w(Bs, w1, N1, k0 - K2, kn, N1 - CO4 + n0, N1 - CO4 + n0 + 64);
        }
        __syncthreads();
        mma_pass(As, Bs, acc, kn, wm, wn);
        __syncthreads();
      }
      store_acc(Cs, acc, wm, wn);
      __syncthreads();
      for (int e = threadIdx.x; e < MP * NP; e += NTHREADS) {
        const int pp = e / NP, c = e % NP, p = p0 + pp, n = n0 + c;
        const int gy = tile.y(p), gx = tile.x(p);
        if (gy >= H2 || gx >= W2) continue;
        const float v = Cs[pp * LDC + c] + __bfloat162float(b2[n]) + __bfloat162float(bsh[n]);
        out[(((size_t)b * H2 + gy) * W2 + gx) * CO4 + n] = __float2bfloat16(fmaxf(v, 0.f));
      }
      __syncthreads();
    }
  }
}

size_t tc_smem_bytes(int CO4) {
  return (size_t)MP * LDC * sizeof(float) + ((size_t)MP * LDA + (size_t)KCH * LDB) * sizeof(bf16) +
         (size_t)(tile_rows(CO4) + 2) * SW * CO4 * sizeof(bf16);
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*, const T*,
                        const T*, T*, int, int, int, int);

// The instantiation for th tile rows, with or without the skip conv.
Kernel<bf16> pick_tc(int th, bool skip) {
  return th == 16 ? (skip ? tap_block_tc_kernel<16, true> : tap_block_tc_kernel<16, false>)
                  : (skip ? tap_block_tc_kernel<8, true> : tap_block_tc_kernel<8, false>);
}
Kernel<float> pick_fma(int th, bool skip) {
  return th == 16 ? (skip ? tap_block_fma_kernel<16, true> : tap_block_fma_kernel<16, false>)
                  : (skip ? tap_block_fma_kernel<8, true> : tap_block_fma_kernel<8, false>);
}

// p: x, te4, w1, w2, b1, bsk, bsh, b2
template <typename T>
int launch(Kernel<T> kernel, int th, const void* const* p, void* out, int B, int H2, int W2,
           int C4, int CO4, size_t smem, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W2 + TW - 1) / TW, (H2 + th - 1) / th, B);
  auto a = [&](int i) { return static_cast<const T*>(p[i]); };
  kernel<<<grid, NTHREADS, smem, s>>>(a(0), a(1), a(2), a(3), a(4), a(5), a(6), a(7),
                                      static_cast<T*>(out), H2, W2, C4, CO4);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" size_t tap_block_smem(int CO4, int is_bf16) {
  return is_bf16 ? tc_smem_bytes(CO4) : fma_smem_bytes(CO4);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// Shapes: x (B,H2,W2,C4), te4 (B,CO4), w1 (4*C4, 3*CO4), or (4*C4, 2*CO4)
// with has_skip == 0, w2 (4*CO4, CO4), b1/bsk/bsh/b2 (CO4,), out
// (B,H2,W2,CO4); all contiguous, all of one type: bfloat16 (is_bf16 != 0;
// C4 % 32 == 0) or float32 (C4 % 8 == 0); CO4 % 128 == 0, CO4 <= 256.
extern "C" int tap_block_launch(const void* x, const void* te4, const void* w1, const void* w2,
                                const void* b1, const void* bsk, const void* bsh, const void* b2,
                                void* out, int B, int H2, int W2, int C4, int CO4, int has_skip,
                                int is_bf16, void* stream) {
  if (C4 % (is_bf16 ? 32 : 8) != 0 || CO4 % 128 != 0 || CO4 > 256 || B < 1 || H2 < 1 || W2 < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tap_block_smem(CO4, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* p[8] = {x, te4, w1, w2, b1, bsk, bsh, b2};
  const int th = tile_rows(CO4);
  return is_bf16 ? launch<bf16>(pick_tc(th, has_skip), th, p, out, B, H2, W2, C4, CO4, smem, s)
                 : launch<float>(pick_fma(th, has_skip), th, p, out, B, H2, W2, C4, CO4, smem, s);
}
