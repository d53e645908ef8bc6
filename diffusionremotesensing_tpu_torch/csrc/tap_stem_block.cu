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
// operations. The bfloat16 launches issue 56.0 GFLOP: conv0's
// 2*48*64*64*48*64 = 1.2 and level 0's block, 54.8 (tap_block.cu).
//
// The bfloat16 path is three launches: stem_conv0_kernel writes h_s, and
// tap_block_sm90.cuh's two launches of level 0's block run on it, with h as
// their seam (tap_block.cu says why). What reaches device memory is h_s and
// h, 25,165,824 and 50,331,648 bytes at B=48, each read back mostly from the
// 50 MB L2. h_s does because TMA cannot read x: its pixels are 24 bytes,
// and a tensor map's strides must be multiples of 16. Keeping h_s on chip
// would mean conv0 over phase A's 10 x 34 slab, x read through the caches
// inside the block's kernel, and conv0 again at the tile's pixels in phase B
// (the shortcut reads h_s there). As its own launch conv0 moves x (4.7 MB),
// cond and h_s once (55 MB, 16 us at 3.35 TB/s) and issues its 1.2 GFLOP
// from registers: a block is one warpgroup on a 4 x 32 tile; cond is read
// into registers first, then each thread builds its wgmma A fragments of
// the 48-column im2col from x through the caches, W0 (48 x 64) sits in
// shared memory in the 128-byte swizzle, and the epilogue adds
// round(b0 + cond), rounds and stores 16 bytes a lane. At 155 registers
// three blocks share an SM.
//
// The first design (one block per 16 x 14 tile holding h_s and h slabs in
// shared memory, WMMA warp tiles reading every weight fragment from device
// memory in every warp, no copy/compute overlap) took 2.47 ms at B=48.
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W), bf16, B=48: 0.176 ms (conv0 0.033, phase A 0.056, phase B
// 0.076), against 1.41 ms for conv0, the cond add and the cuDNN dense-s2d
// block; B=1 (device time) 0.029 ms.
//
// float32 (the golden and model phases' type, not the served one) keeps the
// first design as tap_stem_kernel<float>: a block owns an 8 x 14 tile and
// keeps the h_s slab (tile + 2-pixel halo), the h slab (tile + 1-pixel
// halo, 16 pixels a row) and one float32 epilogue buffer per warp in shared
// memory; every im2col piece is read in place from a slab, conv0's 48
// columns are staged; phase A computes h row by row, phase B runs conv2 and
// the shortcut's 4 centre pieces (piece 5 t of tap block t) into one
// accumulator, as warp_tile.cuh's FMA tiles with weights read through the
// caches. A phase-B row computes 16 pixels and writes 14.

#include "tap_block_sm90.cuh"
#include "warp_tile.cuh"

namespace {

using wt::from_f;
using wt::round_to;
using wt::to_f;

constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int TW = 14;          // output tile width
constexpr int HW = TW + 2;      // h slab width: 16, a warp tile's rows
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

// Tile rows and slab pixel strides (elements) of the FMA kernel (float32
// only); the pads move neighbouring pixels to other banks.
template <typename T> struct Cfg;
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
        const int k = 5 * j;  // the centre piece of tap block j
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


// ---------------------------------- bfloat16: conv0, the first of three launches

constexpr int S_THREADS = 128;             // one warpgroup: a tile of 4 x 32 pixels
constexpr int S_TH = 4;
constexpr int S_BYTES = 1024 + K0 * 128;   // W0 (48 rows x 64 columns) and its alignment

// Grid (ceil(W2/32), ceil(H2/4), B), S_THREADS threads, dynamic shared
// memory S_BYTES. h_s = round(im2col4x4(x) @ W0 + round(b0 + cond)) on the
// tile's pixels inside the image: x (B,H2,W2,12), cond and hs (B,H2,W2,64),
// w0 (48,64), b0 (64). Warp w owns, in M-tile m, tile row 2 m + w / 2,
// pixels 16 (w % 2) .. + 15, as a warpgroup of tap_tc_kernel does. Blocks
// of one warpgroup (155 registers a thread) let three share an SM, so that
// one block's loads overlap another's MMAs and stores.
__global__ void __launch_bounds__(S_THREADS)
stem_conv0_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cond,
                  const bf16* __restrict__ w0, const bf16* __restrict__ b0, bf16* __restrict__ hs,
                  int H2, int W2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* w0s = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int w = warp, g = lane / 4, q = lane % 4;
  const int row_w = w / 2, px_w = 16 * (w % 2);
  const int b = blockIdx.z, y0 = blockIdx.y * S_TH, x0 = blockIdx.x * TC_TW;

  // cond, the largest input, is read first: this lane's column pairs
  // 8 jj + 2 q (+1) of its four pixels (rows g and g + 8 of each M-tile),
  // zero outside the image, as packed bf16 pairs
  uint32_t cnd[2][2][C14 / 8];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + row_w + 2 * m, px = x0 + px_w + g + 8 * h;
      const bool inside = y < H2 && px < W2;
      const bf16* cp = cond + (((size_t)b * H2 + y) * W2 + px) * C14 + 2 * q;
#pragma unroll
      for (int jj = 0; jj < C14 / 8; ++jj)
        cnd[m][h][jj] = inside ? *reinterpret_cast<const uint32_t*>(cp + 8 * jj) : 0u;
    }

  // W0 in wgmma's MN-major B layout: row r's 16-byte chunk c at chunk c ^ r % 8
  for (int e = tid; e < K0 * 8; e += S_THREADS) {
    const int r = e / 8, c = e % 8;
    *reinterpret_cast<uint4*>(w0s + r * 128 + ((c ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(w0 + r * C14 + 8 * c);
  }
  sm90::fence_proxy_async();  // these stores, before the MMAs read W0 (the async proxy)
  __syncthreads();

  // A, the im2col of x, straight into wgmma's A fragments (rows g and g + 8
  // of the warp's 16 pixels, columns 2 q (+1) and 2 q + 8 (+1) of a k-step):
  // column k is channel k % 3 of tap block piece % 4 at piece k / 3's shift,
  // zero outside the image. x's 24-byte pixels are read through the caches.
  const bf16* xb = x + (size_t)b * H2 * W2 * CX4;
  auto x_bits = [&](int y, int px, int k) -> uint32_t {
    const int piece = k / 3;
    const int yy = y + kPieceRow[piece] - 1, xx = px + kPieceCol[piece] - 1;
    if (yy < 0 || yy >= H2 || xx < 0 || xx >= W2) return 0u;
    return *reinterpret_cast<const uint16_t*>(xb + ((size_t)yy * W2 + xx) * CX4 + (piece & 3) * 3 +
                                              k % 3);
  };
  uint32_t a[K0 / 16][2][4];
#pragma unroll
  for (int ks = 0; ks < K0 / 16; ++ks)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int y = y0 + row_w + 2 * m, px = x0 + px_w + g + 8 * (r & 1);
        const int k = 16 * ks + 2 * q + 8 * (r >> 1);
        a[ks][m][r] = x_bits(y, px, k) | x_bits(y, px, k + 1) << 16;
      }
  float acc[2][C14 / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < C14 / 2; ++i) acc[m][i] = 0.f;
  sm90::fence_operand(acc[0]);
  sm90::fence_operand(acc[1]);
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < K0 / 16; ++ks)
#pragma unroll
    for (int m = 0; m < 2; ++m)
      sm90::wgmma_m64n64k16(acc[m], a[ks][m], sm90::desc_sw128(w0s + ks * 2048, 0, 1024));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(acc[0]);
  sm90::fence_operand(acc[1]);

  // epilogue: columns 8 jj + 2 q (+1) of rows g and g + 8, per M-tile
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + row_w + 2 * m, px = x0 + px_w + g + 8 * h;
      const bool inside = y < H2 && px < W2;  // every lane takes part in the shuffles
      const size_t pix = ((size_t)b * H2 + y) * W2 + px;
#pragma unroll
      for (int jg = 0; jg < C14 / 32; ++jg) {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = 4 * jg + j;
          const uint32_t c = cnd[m][h][jj];
          const float cf[2] = {__uint_as_float(c << 16), __uint_as_float(c & 0xffff0000u)};
          float r[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            r[e] = acc[m][4 * jj + 2 * h + e] +
                   round_to<bf16>(load_f(b0 + 8 * jj + 2 * q + e) + cf[e]);
          v[j] = sm90::pack_bf16x2(r[0], r[1]);
        }
        sm90::quad_transpose(v);  // this lane: columns 32 jg + 8 q .. + 7
        if (inside)
          *reinterpret_cast<uint4*>(hs + pix * C14 + 32 * jg + 8 * q) =
              uint4{v[0], v[1], v[2], v[3]};
      }
    }
}
}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

int launch_f32(const void* const* p, void* out, int B, int H2, int W2, cudaStream_t s) {
  using T = float;
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

// conv0 into hs, then the block (tap_block_sm90.cuh) on hs with h as its seam
int launch_bf16(const void* const* p, void* out, void* hs, void* h, int B, int H2, int W2,
                cudaStream_t s) {
  auto a = [&](int i) { return static_cast<const bf16*>(p[i]); };
  const dim3 grid((W2 + TC_TW - 1) / TC_TW, (H2 + S_TH - 1) / S_TH, B);
  stem_conv0_kernel<<<grid, S_THREADS, S_BYTES, s>>>(a(0), a(1), a(3), a(4),
                                                     static_cast<bf16*>(hs), H2, W2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const void* q[8] = {hs, p[2], p[5], p[6], p[7], p[8], p[9], p[10]};  // x, te4, w1, w2, biases
  return launch_block_tc<0>(q, h, out, B, H2, W2, s);
}

}  // namespace

// Shared memory one block needs, in bytes (bfloat16: the block's kernel,
// the larger of its launches).
extern "C" size_t tap_stem_block_smem(int is_bf16) {
  return is_bf16 ? (size_t)TC_BYTES : Smem<float>::bytes;
}

// Launch on `stream`; returns the first cudaError_t (0 on success).
// p: x, cond, te4, w0, b0, w1, w2, b1, bsk, bsh, b2 (shapes above the
// kernels), all contiguous, all of one type: bfloat16 (is_bf16 != 0) or
// float32; out (B,H2,W2,128). bfloat16 also takes the scratch h_s
// (B,H2,W2,64) and h (B,H2,W2,128), its launches' seams (float32: unused).
extern "C" int tap_stem_block_launch(const void* const* p, void* out, void* hs, void* h, int B,
                                     int H2, int W2, int is_bf16, void* stream) {
  if (B < 1 || H2 < 1 || W2 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(p, out, hs, h, B, H2, W2, s) : launch_f32(p, out, B, H2, W2, s);
}
