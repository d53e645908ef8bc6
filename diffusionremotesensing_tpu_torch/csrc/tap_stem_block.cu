// Fused stem + s2d ResConvBlock-0 for Hopper (sm_90a): the CUDA counterpart
// of the TPU kernel diffusionremotesensing_tpu/ops/tap_block.py:
// tap_stem_block (:367; _tap_stem_kernel :264). For one batch item and one
// tile of s2d output pixels it computes
//
//   base = round(b0 + cond)                           (the one rounding of
//                                                       build_cond_slabs)
//   h_s  = round(im2col4x4(x) @ W0 + base)            (conv0; zero outside
//                                                       the image: conv1's
//                                                       and skip's SAME padding)
//   Y    = im2col4x4(h_s) @ [W_conv1' | W_skip]
//   h    = round(relu(Y_c1 + b1') + Y_sk + b_sk + te4)   (zero outside the image)
//   out  = round(relu(im2col4x4(h) @ W2' + h_s @ W_short' + b2' + b_sh'))
//
// with the BatchNorms folded by ops/tap_block.py:build_block_weights (W1's
// three column blocks) and conv0 in the tap form (ops/tap_conv.py:
// tap_weight, K = 16 pieces x 3 channels = 48). Products accumulate in
// float32; h_s, h and out are rounded to the input type where the TPU
// kernel rounds them.
//
// What bounds it. At the main path's shape (B=48, 64x64 s2d pixels = 128x128
// pixels, x 3 channels, h_s 16, the block 32) the function's own work is
// conv0 (3x3, 3->16) plus the block's (conv1 and skip 3x3 16->32, conv2 3x3
// 32->32, shortcut 1x1 16->32): 2*48*128*128*(9*3*16 + 2*9*16*32 +
// 9*32*32 + 16*32) = 30.5 GFLOP, 31 us at 989 TFLOP/s bf16; its bytes are x,
// cond and out once, 81 MB, 24 us at 3.35 TB/s. So it is bound by
// operations. h_s never reaches device memory: that is what the kernel is
// for (the 'block' path writes it, 25 MB in bf16, and reads it back).
//
// Design. The TPU kernel ran a (B, NH) grid of row slabs in order, each
// slab recomputing conv0 on a 2-row halo from pre-sliced cond slabs. Here
// a block owns a TH x 14 tile (TH = 16 in bf16, 8 in float32) and keeps
// three things in shared memory: the h_s slab (tile + 2-pixel halo,
// (TH+4) x 18 x 64), the h slab (tile + 1-pixel halo, (TH+2) x 16 x 128)
// and one float32 epilogue buffer per warp. The tile is 14 wide so that a
// row of the h slab is 16 pixels, the 16 rows of one WMMA A operand: every
// im2col piece of phases A and B is then read in place from a slab (row
// stride one slab pixel), and only conv0's 48-column im2col is staged (in
// the warp's epilogue buffer). Phase 0 computes h_s over its slab 16
// pixels at a time; phase A computes h row by row (conv1 and skip in two
// warp tiles off the same A); phase B runs conv2 from the h slab and the
// shortcut from the h_s slab's centre in the same float32 accumulator, the
// 4 centre pieces of W1's shortcut columns only (12 of its 16 row blocks
// are zero). A phase-B row computes 16 pixels and writes 14; the two
// others read past the row and are dropped. Warp tiles are warp_tile.cuh's,
// 16 pixels x 64 columns: bf16 on the tensor cores (WMMA), float32 as FMA;
// weights are read through the caches from device memory. One block per
// SM; no copy/compute overlap yet.

#include "warp_tile.cuh"

namespace {

using wt::bf16;
using wt::from_f;
using wt::round_to;
using wt::to_f;

constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int TW = 14;          // output tile width
constexpr int HW = TW + 2;      // h slab width: 16, one WMMA A operand
constexpr int SW = TW + 4;      // h_s slab width
constexpr int NC = 64;          // columns of a warp tile
constexpr int LDC = 2 * NC + 4; // a warp's epilogue buffer: two warp tiles side by side
constexpr int CX4 = 12;         // s2d input channels (4 taps x 3)
constexpr int K0 = 48;          // conv0 im2col width (16 pieces x 3 channels)
constexpr int C14 = 64;         // h_s channels (4 taps x 16)
constexpr int CI = C14 / 4;
constexpr int CO4 = 128;        // block channels (4 taps x 32)
constexpr int CM = CO4 / 4;
constexpr int N1 = 3 * CO4;     // row length of W1

// im2col piece table, in the order of ops/tap_conv.py:_ORDER: piece k reads
// the s2d input shifted by (row - 1, col - 1) pixels, tap block k % 4. The
// centre pieces (shift 0, 0) carry the shortcut's rows of W1.
__constant__ int kPieceRow[16] = {1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 1, 1, 2, 2, 1, 1};
__constant__ int kPieceCol[16] = {1, 0, 1, 0, 2, 1, 2, 1, 1, 0, 1, 0, 2, 1, 2, 1};
__constant__ int kCentre[4] = {0, 5, 10, 15};

// Tile rows and slab pixel strides (elements). bf16 strides keep WMMA's
// 32-byte alignment; all pads move neighbouring pixels to other banks.
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int TH = 16, LDS = C14 + 16, LDH = CO4 + 16;
};
template <> struct Cfg<float> {
  static constexpr int TH = 8, LDS = C14 + 4, LDH = CO4 + 4;
};

template <typename T> struct Smem {
  using C = Cfg<T>;
  static constexpr int NS0 = (C::TH + 4) * SW;              // h_s slab pixels
  static constexpr int NH = (C::TH + 2) * HW + 2;           // h slab pixels (+2 read by the
                                                            //  dropped phase-B columns)
  static constexpr size_t hs = 0;                                            // [NS0][LDS]
  static constexpr size_t hh = wt::align128(hs + sizeof(T) * NS0 * C::LDS);  // [NH][LDH]
  static constexpr size_t cb = wt::align128(hh + sizeof(T) * NH * C::LDH);   // [NWARP][16][LDC]
  static constexpr size_t bytes = cb + sizeof(float) * NWARP * 16 * LDC;
};

// Grid (ceil(W2/TW), ceil(H2/TH), B), NTHREADS threads, dynamic shared
// memory Smem<T>::bytes. x (B,H2,W2,12), cond (B,H2,W2,64), te4 (B,128),
// w0 (48,64), b0 (64), w1 (256,384), w2 (512,128), b1/bsk/bsh/b2 (128),
// out (B,H2,W2,128).
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
tap_stem_kernel(const T* __restrict__ x, const T* __restrict__ cond, const T* __restrict__ te4,
                const T* __restrict__ w0, const T* __restrict__ b0, const T* __restrict__ w1,
                const T* __restrict__ w2, const T* __restrict__ b1, const T* __restrict__ bsk,
                const T* __restrict__ bsh, const T* __restrict__ b2, T* __restrict__ out, int H2,
                int W2) {
  using L = Smem<T>;
  constexpr int TH = Cfg<T>::TH, LDS = Cfg<T>::LDS, LDH = Cfg<T>::LDH;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw + L::hs);
  T* hh = reinterpret_cast<T*>(smem_raw + L::hh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* cb = reinterpret_cast<float*>(smem_raw + L::cb) + warp * 16 * LDC;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const T* xb = x + (size_t)b * H2 * W2 * CX4;
  const T* cbat = cond + (size_t)b * H2 * W2 * C14;

  // ---- phase 0: h_s on its slab (image origin (y0 - 2, x0 - 2)), 16 slab
  // pixels a warp tile; conv0's im2col is staged in the warp's buffer
  T* a0 = reinterpret_cast<T*>(cb);  // [16][K0]
  for (int q = warp; q * 16 < L::NS0; q += NWARP) {
    for (int e = lane; e < 16 * K0; e += 32) {
      const int r = e / K0, k = e % K0, piece = k / 3, p = q * 16 + r;
      const int yy = y0 - 2 + p / SW + kPieceRow[piece] - 1;
      const int xx = x0 - 2 + p % SW + kPieceCol[piece] - 1;
      const bool inside = p < L::NS0 && yy >= 0 && yy < H2 && xx >= 0 && xx < W2;
      a0[r * K0 + k] = inside ? xb[((size_t)yy * W2 + xx) * CX4 + (piece & 3) * 3 + k % 3]
                              : from_f<T>(0.f);
    }
    __syncwarp();
    wt::WarpTile<T, C14 / 16> acc;
    acc.zero();
    acc.mma(a0, K0, w0, C14, K0);
    __syncwarp();  // every lane is done with a0 before the buffer is overwritten
    acc.store(cb, LDC);
    __syncwarp();
    for (int e = lane; e < 16 * C14; e += 32) {
      const int r = e / C14, c = e % C14, p = q * 16 + r;
      if (p >= L::NS0) continue;
      const int hy = y0 - 2 + p / SW, hx = x0 - 2 + p % SW;
      float v = 0.f;
      if (hy >= 0 && hy < H2 && hx >= 0 && hx < W2)
        v = cb[r * LDC + c] +
            round_to<T>(to_f(b0[c]) + to_f(cbat[((size_t)hy * W2 + hx) * C14 + c]));
      hs[p * LDS + c] = from_f<T>(v);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase A: h on its slab (image origin (y0 - 1, x0 - 1)), one slab
  // row of 16 pixels a pass: conv1 and skip columns [n0, n0 + 64) in two
  // warp tiles off the same im2col pieces
  for (int r = warp; r < TH + 2; r += NWARP) {
    const int hy = y0 - 1 + r;
    for (int n0 = 0; n0 < CO4; n0 += NC) {
      wt::WarpTile<T, NC / 16> c1, sk;
      c1.zero();
      sk.zero();
      for (int k = 0; k < 16; ++k) {
        const T* A = hs + ((r + kPieceRow[k]) * SW + kPieceCol[k]) * LDS + (k & 3) * CI;
        const T* w = w1 + (size_t)k * CI * N1 + n0;
        c1.mma(A, LDS, w, N1, CI);
        sk.mma(A, LDS, w + CO4, N1, CI);
      }
      c1.store(cb, LDC);
      sk.store(cb + NC, LDC);
      __syncwarp();
      for (int e = lane; e < 16 * NC; e += 32) {
        const int px = e / NC, c = e % NC, n = n0 + c, hx = x0 - 1 + px;
        float v = 0.f;
        if (hy >= 0 && hy < H2 && hx >= 0 && hx < W2)
          v = fmaxf(cb[px * LDC + c] + to_f(b1[n]), 0.f) + cb[px * LDC + NC + c] + to_f(bsk[n]) +
              to_f(te4[(size_t)b * CO4 + n]);
        hh[(r * HW + px) * LDH + n] = from_f<T>(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- phase B: conv2 on the h slab plus the shortcut on the h_s slab's
  // centre, one output row of 16 pixels (14 written) a pass
  for (int r = warp; r < TH; r += NWARP) {
    const int gy = y0 + r;
    for (int n0 = 0; n0 < CO4; n0 += NC) {
      wt::WarpTile<T, NC / 16> acc;
      acc.zero();
      for (int k = 0; k < 16; ++k)
        acc.mma(hh + ((r + kPieceRow[k]) * HW + kPieceCol[k]) * LDH + (k & 3) * CM, LDH,
                w2 + (size_t)k * CM * CO4 + n0, CO4, CM);
      for (int j = 0; j < 4; ++j) {
        const int k = kCentre[j];
        acc.mma(hs + ((r + 2) * SW + 2) * LDS + (k & 3) * CI, LDS,
                w1 + (size_t)k * CI * N1 + 2 * CO4 + n0, N1, CI);
      }
      acc.store(cb, LDC);
      __syncwarp();
      for (int e = lane; e < 16 * NC; e += 32) {
        const int px = e / NC, c = e % NC, n = n0 + c, gx = x0 + px;
        if (px < TW && gy < H2 && gx < W2)
          out[(((size_t)b * H2 + gy) * W2 + gx) * CO4 + n] =
              from_f<T>(fmaxf(cb[px * LDC + c] + to_f(b2[n]) + to_f(bsh[n]), 0.f));
      }
      __syncwarp();
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T>
int launch(const void* const* p, void* out, int B, int H2, int W2, cudaStream_t s) {
  const size_t smem = Smem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(tap_stem_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* q[11];
  for (int i = 0; i < 11; ++i) q[i] = static_cast<const T*>(p[i]);
  const dim3 grid((W2 + TW - 1) / TW, (H2 + Cfg<T>::TH - 1) / Cfg<T>::TH, B);
  tap_stem_kernel<T><<<grid, NTHREADS, smem, s>>>(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7],
                                                   q[8], q[9], q[10], static_cast<T*>(out), H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" size_t tap_stem_block_smem(int is_bf16) {
  return is_bf16 ? Smem<bf16>::bytes : Smem<float>::bytes;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// p: x, cond, te4, w0, b0, w1, w2, b1, bsk, bsh, b2 (shapes above the
// kernel), all contiguous, all of one type: bfloat16 (is_bf16 != 0) or
// float32; out (B,H2,W2,128).
extern "C" int tap_stem_block_launch(const void* const* p, void* out, int B, int H2, int W2,
                                     int is_bf16, void* stream) {
  if (B < 1 || H2 < 1 || W2 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, out, B, H2, W2, s) : launch<float>(p, out, B, H2, W2, s);
}
