// The composed head's two convolutions for Hopper (sm_90a): the CUDA
// counterpart of the TPU kernel diffusionremotesensing_tpu/ops/packed_head.py:
// packed_head (:133, pallas_call :147; _packed_head_kernel :117). For hh
// (B, H, W, C1), attn_s (B, H, W, C2) and HWIO kernels K4 (4, 4, C1, NO),
// K3 (3, 3, C2, NO)
//
//   out = conv(hh, K4, pad ((1,2),(1,2))) + conv(attn_s, K3, pad 1)
//
// both convolutions into one float32 accumulator, rounded once to the input
// type, as the TPU kernel does. On the s2d tail K4 is head_up4 (the head
// composed through UpConvBlock-2's ConvTranspose) and K3 head_at (the
// head's attention branch), NO = 12 (4 taps x 3 output channels).
//
// What bounds it. At the main path's shape (B=48, 64x64 s2d pixels, C1=64,
// C2=128, NO=12) the bytes are hh and attn_s read and out written once:
// 80.3 MB in bfloat16, 24 us at 3.35 TB/s; the operations, counted as the
// model's layers without the s2d forms' structural zeros, 3.25 GFLOP, 3.3 us
// at 989 TFLOP/s. So the function is bound by bytes.
//
// The bfloat16 kernel (head_tc_kernel). The first design (a block per 8 x
// 16 pixels, WMMA 16-row warp tiles, cp.async staging with no overlap)
// took 0.240 ms at B=48 on an H100, level with the two cuDNN convolutions.
// This one fuses csrc/dec_block.cu's HEAD mode and csrc/att_head_block.cu's
// att_head_kernel on the same accumulators:
//
// 1. A persistent grid of at most one block an SM walks the output tiles of
//    8 rows x 32 pixels (768 at B=48). A block is two consumer warpgroups
//    and a producer warp; each warpgroup owns two 64-pixel M-tiles of the
//    tile (tile rows 4 wg + 2 m and 4 wg + 2 m + 1).
// 2. The producer warp's lane 0 issues the slabs as TMA boxes completing on
//    mbarriers, 64-channel planes with the 128-byte swizzle in a ring of 3
//    slots of 50,176 bytes: per tile first hh's ceil(C1 / 64) planes of 11 x
//    35 pixels (the tile and the 4x4 window's halo, rows and columns -1 ..
//    +2; zero outside the image: the pad), then attn_s's ceil(C2 / 64)
//    planes of 10 x 34 (SAME). Channels past C1 or C2 land as zeros.
// 3. The weights stay resident: the 256 consumer threads stage K4's and
//    K3's pieces (one plane's 64 channel rows of one tap, NO columns
//    zero-padded to 16, 2,048 bytes, 32-byte swizzle) once per block from
//    the HWIO kernels as they are (NO = 12 makes rows of 24 bytes, which
//    TMA cannot read), while the producer's first planes land. At C1 = 64,
//    C2 = 128: 16 + 18 pieces, 69,632 bytes.
// 4. Warpgroup MMA, wgmma.m64n16k16: A (64 pixels x 16 channels of one tap's
//    shifted window) from registers by ldmatrix on the slab, in place; a
//    batch is one (plane, tap) piece, 4 k-steps x 2 M-tiles, one commit
//    group, two register sets for A. Per tile two compile-time phases
//    (head_phase<4>, head_phase<3>): 16 ceil(C1 / 64) batches of K4, then 9
//    ceil(C2 / 64) of K3, k-step kk into accumulator set kk % 4; the sets
//    are summed in float32 before the epilogue.
// 5. The epilogue stores the NO real columns from the accumulator registers
//    as 4-byte pairs (2-byte stores when NO is odd).
//
// What bounds this form. At N = 16 the MMAs issue (16 x 64 + 9 x 128) x 16
// = 34,816 MACs a pixel, 13.7 GFLOP at B=48, 4.2x the 3.25 the bound
// counts; dec_block.cu's loop probe put m64n16k16 at 249 TFLOP/s on an
// H100, so ~0.055 ms is this form's floor.
//
// Shared memory (bytes; 1024 for the alignment of the swizzle atoms): 1024
// + 3 planes x 50,176 (11 x 35 x 128, rounded to 1024) + 34 pieces x 2,048
// + 6 mbarriers x 8 = 221,232 at C1 = 64, C2 = 128 (tc_bytes); of the
// 232,448 a block may have, which leaves room for 39 pieces.
//
// The explicit dispatch by shape. bfloat16 widths whose pieces do not fit
// (16 ceil(C1 / 64) + 9 ceil(C2 / 64) > 39, e.g. C2 > 128 at C1 = 64) run
// the first design's WMMA kernel, packed_head_kernel<bf16>; the wrapper
// (ops/packed_head.py: wgmma_takes) chooses by shape alone and passes its
// choice, which the launcher refuses if the pieces do not fit. The served
// widths (64, 128) always take head_tc_kernel.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): head_tc_kernel 161 registers, no
// spills. Choices measured on an H100 80GB HBM3 at 700 W with throwaway
// probes (variants built side by side in one call, B=48, not kept):
// * The two convolutions as two compile-time phases (head_phase<4>, then
//   <3>): 0.0623 ms, against 0.1047 for one loop that decodes each batch's
//   (plane, tap, window) at run time.
// * Four accumulator sets (KSPLIT): 0.0624 against 0.0638 with one, in each
//   of four probes 1.5-2.4% faster.
// * Staging the weights costs ~0.005 ms of the block's start (0.0577 with
//   it skipped); 4 chunks in flight a thread beat 8 and 17 (0.0638 / 0.0648
//   / 0.0663). A third register set for A spilled 160 bytes (0.177).
// * The input-stationary form (each slab pixel's A against all taps at
//   once, N = 192 for K4 and 108 for K3, the shifted partial sums added into
//   a float32 tile by shared-memory atomics) ran 0.755 ms (one m64n192k16,
//   1,772 bytes spilled) and 0.837 (three m64n64k16, 692 spilled) against
//   0.062: a tile's 3,072 outputs take 110,640 partial sums (385 x 192 +
//   340 x 108), each added by its own atomic, and that scatter costs more
//   than the MMAs it saves, so the N = 16 form stays.
//
// float32 (not the served type) keeps the first design's kernel,
// packed_head_kernel<float>: warp_tile.cuh's FMA tiles, hh's then attn_s's
// slab and weights staged by cp.async in turn (179 KB of shared memory).

#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using wt::bf16;

// ------------------------------------------------ bfloat16: the wgmma kernel

constexpr int TH = 8, TW = 32;              // output tile: 8 rows x 32 pixels
constexpr int SH4 = TH + 3, SW4 = TW + 3;   // hh slab: the tile and the 4x4 window's halo
constexpr int SH3 = TH + 2, SW3 = TW + 2;   // attn_s slab: the tile and its one-pixel halo
constexpr int CONSUMERS = 256;              // two warpgroups, 128 pixels each
constexpr int TC_THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int SMEM_MAX = 232448;            // shared memory a block may have
constexpr int NPAD = 16;                    // output columns computed (NO zero-padded)

__host__ __device__ constexpr int round1024(int b) { return (b + 1023) / 1024 * 1024; }

constexpr int TX4 = SH4 * SW4 * 128;        // bytes an hh plane's box lands
constexpr int TX3 = SH3 * SW3 * 128;        // ... an attn_s plane's
constexpr int PLANE = round1024(TX4);       // a plane slot: 50,176
constexpr int NPL = 3;                      // plane slots
constexpr int PIECE = 64 * NPAD * 2;        // one (plane, tap): 64 rows of 16 columns
constexpr int TC_BARS = 2 * NPL;            // full and empty of each plane slot
constexpr int KSPLIT = 4;  // accumulator sets an M-tile (k-step kk: set kk % KSPLIT)

// the resident pieces and shared-memory bytes of head_tc_kernel at C1, C2
__host__ __device__ constexpr int tc_pieces(int C1, int C2) {
  return 16 * ((C1 + 63) / 64) + 9 * ((C2 + 63) / 64);
}
__host__ __device__ constexpr int tc_bytes(int C1, int C2) {
  return 1024 + NPL * PLANE + tc_pieces(C1, C2) * PIECE + 8 * TC_BARS;
}

// The resident weights, staged by the consumer threads: piece j in batch
// order (hh's planes p < np1, K4's 16 taps each, then attn_s's, K3's 9
// taps each) holds the tap's rows 64 p' .. 64 p' + 63 of K (zero past the
// channel count) and its NO columns (zero to 16), in the 32-byte swizzle:
// 16-byte chunk c of row r at chunk c ^ (r % 8) / 4.
__device__ __forceinline__ void stage_weights(unsigned char* wsm, const bf16* __restrict__ w4,
                                              const bf16* __restrict__ w3, int C1, int C2, int NO,
                                              int np1, int nb) {
  constexpr int U = 4;  // chunks a thread loads before it stores any: U x 8 loads in flight
  for (int e0 = threadIdx.x; e0 < nb * 128; e0 += U * CONSUMERS) {
    alignas(16) bf16 v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * CONSUMERS, j = e / 128, r = e % 128 / 2, c = e % 2;
      const bool k4 = j < 16 * np1;
      const int jj = k4 ? j : j - 16 * np1, taps = k4 ? 16 : 9;
      const int tap = jj % taps, ch = 64 * (jj / taps) + r, C = k4 ? C1 : C2;
      const bf16* src = (k4 ? w4 : w3) + ((size_t)tap * C + ch) * NO;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[u][i] = e < nb * 128 && ch < C && 8 * c + i < NO ? src[8 * c + i] : wt::from_f<bf16>(0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * CONSUMERS, j = e / 128, r = e % 128 / 2, c = e % 2;
      if (e < nb * 128)
        *reinterpret_cast<uint4*>(wsm + j * PIECE + r * 32 + ((c ^ (r % 8 / 4)) << 4)) =
            *reinterpret_cast<const uint4*>(v[u]);
    }
  }
}

// One convolution of a tile on the consumers' accumulators: the KW x KW
// window over `nplanes` planes (the block's planes k0 .., in slot k % NPL),
// against the resident pieces from `pieces` on (one per (plane, tap), in
// that order). A batch is one piece: 4 k-steps x 2 M-tiles of
// wgmma.m64n16k16, k-step kk into accumulator set kk % KSPLIT (shorter
// chains of dependent MMAs); A by ldmatrix at the tap's shift in the slab
// (lane l: pixel 16 (w % 2) + l % 16 at channel 8 (l / 16) of a k-step),
// two register sets, so that the next batch's ldmatrix runs under this
// batch's MMAs. A plane goes back to the producer after its last tap.
template <int KW>
__device__ __forceinline__ void head_phase(float (&acc)[KSPLIT][2][8], const unsigned char* base,
                                           const unsigned char* pieces, uint64_t* full,
                                           uint64_t* empty, int k0, int nplanes, int row_w,
                                           int px_w) {
  constexpr int TAPS = KW * KW, SW = TW + KW - 1;  // the slab: the tile and its halo
  const int nb = TAPS * nplanes, lane = threadIdx.x % 32;
  auto load_a = [&](uint32_t (&a)[4][2][4], int s) {
    const int k = k0 + s / TAPS, tap = s % TAPS;
    if (tap == 0) sm90::mbar_wait(&full[k % NPL], (k / NPL) & 1);
    const unsigned char* plane = base + (k % NPL) * PLANE;
    const int dy = tap / KW, dx = tap % KW;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int pix = (row_w + 2 * m + dy) * SW + px_w + lane % 16 + dx;
        const int chunk = (2 * kk + lane / 16) ^ (pix & 7);  // the 128-byte swizzle
        sm90::ldmatrix_x4(a[kk][m], plane + pix * 128 + chunk * 16);
      }
  };
  auto issue = [&](const uint32_t (&a)[4][2][4], int s) {
    const unsigned char* piece = pieces + s * PIECE;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        sm90::wgmma_m64n16k16(acc[kk % KSPLIT][m], a[kk][m],
                              sm90::desc_sw32(piece + kk * 512, 0, 256));
    sm90::wgmma_commit();
  };
  auto release = [&](int s) {
    if (s % TAPS == TAPS - 1) sm90::mbar_arrive(&empty[(k0 + s / TAPS) % NPL]);
  };
  uint32_t a0[4][2][4], a1[4][2][4];
  load_a(a0, 0);
  for (int s = 0; s < nb; s += 2) {
    issue(a0, s);
    sm90::wgmma_wait<1>();  // batch s - 1 is done: a1 is free
    if (s > 0) release(s - 1);
    if (s + 1 < nb) {
      load_a(a1, s + 1);
      issue(a1, s + 1);
      sm90::wgmma_wait<1>();  // batch s is done: a0 is free
      release(s);
      if (s + 2 < nb) load_a(a0, s + 2);
    }
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int k = 0; k < KSPLIT; ++k) {
    sm90::fence_operand(acc[k][0]);
    sm90::fence_operand(acc[k][1]);
  }
  release(nb - 1);
}

// Grid: min(#SMs, tiles) blocks of TC_THREADS threads, dynamic shared
// memory tc_bytes(C1, C2). hmap: hh as 4-D (C1, W, H, B) with boxes (64,
// SW4, SH4, 1); amap: attn_s as (C2, W, H, B) with boxes (64, SW3, SH3, 1);
// both 128-byte swizzle. w4 (4,4,C1,NO), w3 (3,3,C2,NO) HWIO; out (B,H,W,NO).
__global__ void __launch_bounds__(TC_THREADS, 1)
head_tc_kernel(const __grid_constant__ sm90::TensorMap hmap,
               const __grid_constant__ sm90::TensorMap amap, const bf16* __restrict__ w4,
               const bf16* __restrict__ w3, bf16* __restrict__ out, int B, int H, int W, int C1,
               int C2, int NO) {
  const int np1 = (C1 + 63) / 64, np = np1 + (C2 + 63) / 64;  // hh's planes, all planes a tile
  const int nb = tc_pieces(C1, C2);                          // batches a tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms want 1024-byte alignment of the shared address
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + NPL * PLANE;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + nb * PIECE);
  uint64_t* empty = full + NPL;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_x * tiles_y;
  const int mine = ntiles > (int)blockIdx.x ? (ntiles - blockIdx.x - 1) / gridDim.x + 1 : 0;
  auto tile_of = [&](int it, int& b, int& y0, int& x0) {
    const int t = blockIdx.x + it * gridDim.x, rr = t % (tiles_x * tiles_y);
    b = t / (tiles_x * tiles_y);
    y0 = rr / tiles_x * TH;
    x0 = rr % tiles_x * TW;
  };
  // plane k is the block's k-th (tile k / np, plane k % np: hh's, then
  // attn_s's), in slot k % NPL; the producer's lane 0 issues it
  const int nplanes = mine * np;
  auto load_plane = [&](int k) {
    const int s = k % NPL, p = k % np;
    int b, y0, x0;
    tile_of(k / np, b, y0, x0);
    if (k >= NPL) sm90::mbar_wait(&empty[s], (k / NPL - 1) & 1);
    if (p < np1) {
      sm90::mbar_arrive_expect_tx(&full[s], TX4);
      sm90::tma_load_4d(base + s * PLANE, &hmap, 64 * p, x0 - 1, y0 - 1, b, &full[s]);
    } else {
      sm90::mbar_arrive_expect_tx(&full[s], TX3);
      sm90::tma_load_4d(base + s * PLANE, &amap, 64 * (p - np1), x0 - 1, y0 - 1, b, &full[s]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < NPL; ++s) {
      sm90::mbar_init(&full[s], 1);  // lane 0's arrival, and the box's bytes
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();  // the mbarriers are initialised
  const bool producer = warp == CONSUMERS / 32;
  if (producer) {
    // the first planes land while the consumers stage the weights
    if (lane == 0)
      for (int k = 0; k < NPL && k < nplanes; ++k) load_plane(k);
  } else {
    stage_weights(wsm, w4, w3, C1, C2, NO, np1, nb);
    sm90::fence_proxy_async();  // the staged weights, before wgmma reads them
  }
  __syncthreads();  // the weights are staged
  if (producer) {
    if (lane == 0)
      for (int k = NPL; k < nplanes; ++k) load_plane(k);
    return;
  }

  // ---- the consumers. Warp w of warpgroup wg computes, in M-tile m, tile
  // row 4 wg + 2 m + w / 2, pixels 16 (w % 2) .. + 15.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int row_w = 4 * wg + w / 2, px_w = 16 * (w % 2);

  for (int it = 0; it < mine; ++it) {
    int b, y0, x0;
    tile_of(it, b, y0, x0);
    float acc[KSPLIT][2][8];
#pragma unroll
    for (int k = 0; k < KSPLIT; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[k][m][i] = 0.f;
        sm90::fence_operand(acc[k][m]);
      }
    // K4 on hh's planes (the block's planes it np ..), then K3 on attn_s's
    head_phase<4>(acc, base, wsm, full, empty, it * np, np1, row_w, px_w);
    head_phase<3>(acc, base, wsm + 16 * np1 * PIECE, full, empty, it * np + np1, np - np1, row_w,
                  px_w);
#pragma unroll
    for (int k = 1; k < KSPLIT; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[0][m][i] += acc[k][m][i];

    // ---- epilogue: rows g and g + 8 of the warp's 16 pixels, per M-tile;
    // columns 8 j + 2 q + e, the NO real ones
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = y0 + row_w + 2 * m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + px_w + g + 8 * h;
        if (y >= H || x >= W) continue;
        bf16* o = out + (((size_t)b * H + y) * W + x) * NO;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * j + 2 * q;
          const float lo = acc[0][m][4 * j + 2 * h], hi = acc[0][m][4 * j + 2 * h + 1];
          if (col >= NO) continue;
          if (NO % 2 == 0) {
            *reinterpret_cast<uint32_t*>(o + col) = sm90::pack_bf16x2(lo, hi);
          } else {
            o[col] = wt::from_f<bf16>(lo);
            if (col + 1 < NO) o[col + 1] = wt::from_f<bf16>(hi);
          }
        }
      }
    }
  }
}

// ------------------------------------- the first design: WMMA and FMA tiles

constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int FTW = 16;           // tile width: one warp's 16 A rows
constexpr int FTH = NWARP;        // tile rows: one per warp
constexpr int LDC = NPAD + 4;     // row stride of a warp's float32 epilogue buffer

// Slab pixel stride (elements): bfloat16 keeps WMMA's 32-byte alignment
// (C % 16 == 0); both pads move neighbouring pixels to other banks.
template <typename T> __host__ __device__ constexpr int slab_ld(int C);
template <> __host__ __device__ constexpr int slab_ld<bf16>(int C) { return C + 16; }
template <> __host__ __device__ constexpr int slab_ld<float>(int C) { return C + 4; }

// Bytes of the slab buffer (the larger of the two phases' slabs) and of
// the weight buffer (the larger of K4 and K3, 16 columns), each rounded up
// to 128; then the warps' float32 epilogue buffers.
template <typename T> __host__ __device__ constexpr size_t slab_bytes(int C1, int C2) {
  return wt::align128(sizeof(T) * ((FTH + 3) * (FTW + 3) * slab_ld<T>(C1) >
                                           (FTH + 2) * (FTW + 2) * slab_ld<T>(C2)
                                       ? (FTH + 3) * (FTW + 3) * slab_ld<T>(C1)
                                       : (FTH + 2) * (FTW + 2) * slab_ld<T>(C2)));
}
template <typename T> __host__ __device__ constexpr size_t w_bytes(int C1, int C2) {
  return wt::align128(sizeof(T) * NPAD * (16 * C1 > 9 * C2 ? 16 * C1 : 9 * C2));
}
template <typename T> size_t smem_bytes(int C1, int C2) {
  return slab_bytes<T>(C1, C2) + w_bytes<T>(C1, C2) + sizeof(float) * NWARP * 16 * LDC;
}

// Stage one convolution's operands: the slab of src (rows y0-1 .., columns
// x0-1 .., sh x sw pixels of C channels, zero outside the image) with
// cp.async, and the kh*kw*C x NO weight matrix w as kh*kw*C x 16, the
// padding columns zero. The caller waits and synchronises.
template <typename T>
__device__ __forceinline__ void stage(T* slab, T* ws, const T* __restrict__ src,
                                      const T* __restrict__ w, int y0, int x0, int sh, int sw,
                                      int H, int W, int C, int taps, int NO) {
  constexpr int V = wt::Vec<T>::N;
  const int ld = slab_ld<T>(C), units = C / V;
  for (int e = threadIdx.x; e < sh * sw * units; e += NTHREADS) {
    const int p = e / units, u = e % units;
    const int yy = y0 - 1 + p / sw, xx = x0 - 1 + p % sw;
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    wt::cp_async16(slab + p * ld + u * V, inside ? src + ((size_t)yy * W + xx) * C + u * V : src,
                   inside);
  }
  wt::cp_async_commit();
  for (int e = threadIdx.x; e < taps * C * NPAD; e += NTHREADS) {
    const int r = e / NPAD, o = e % NPAD;
    ws[e] = o < NO ? w[(size_t)r * NO + o] : wt::from_f<T>(0.f);
  }
}

// Grid (ceil(W/FTW), ceil(H/FTH), B), NTHREADS threads, dynamic shared
// memory smem_bytes<T>(C1, C2). Requires NO <= 16 and C1, C2 multiples of
// 16 (bfloat16) or 4 (float32). Warp w computes output row w of the 8 x 16
// tile: hh's 16 window positions against K4, then attn_s's 9 against K3, in
// the same buffers, on one accumulator (WMMA 16x16x16 in bfloat16, FMA in
// float32).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
packed_head_kernel(const T* __restrict__ hh, const T* __restrict__ at, const T* __restrict__ w4,
                   const T* __restrict__ w3, T* __restrict__ out, int H, int W, int C1, int C2,
                   int NO) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t sb = slab_bytes<T>(C1, C2), wb = w_bytes<T>(C1, C2);
  T* slab = reinterpret_cast<T*>(smem_raw);
  T* ws = reinterpret_cast<T*>(smem_raw + sb);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* cbuf = reinterpret_cast<float*>(smem_raw + sb + wb) + warp * 16 * LDC;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * FTH, x0 = blockIdx.x * FTW;
  wt::WarpTile<T, 1> acc;
  acc.zero();

  // phase 1: hh's 4x4 window (slab (FTH+3) x (FTW+3)) against K4
  stage(slab, ws, hh + (size_t)b * H * W * C1, w4, y0, x0, FTH + 3, FTW + 3, H, W, C1, 16, NO);
  wt::cp_async_wait<0>();
  __syncthreads();
  {
    const int ld = slab_ld<T>(C1);
    for (int k = 0; k < 16; ++k)
      acc.mma(slab + ((warp + k / 4) * (FTW + 3) + k % 4) * ld, ld, ws + (size_t)k * C1 * NPAD,
              NPAD, C1);
  }
  __syncthreads();

  // phase 2: attn_s's 3x3 window (slab (FTH+2) x (FTW+2)) against K3
  stage(slab, ws, at + (size_t)b * H * W * C2, w3, y0, x0, FTH + 2, FTW + 2, H, W, C2, 9, NO);
  wt::cp_async_wait<0>();
  __syncthreads();
  {
    const int ld = slab_ld<T>(C2);
    for (int k = 0; k < 9; ++k)
      acc.mma(slab + ((warp + k / 3) * (FTW + 2) + k % 3) * ld, ld, ws + (size_t)k * C2 * NPAD,
              NPAD, C2);
  }

  // epilogue: warp w writes output row y0 + w (a row past the image
  // computed on zeros and writes nothing)
  acc.store(cbuf, LDC);
  __syncwarp();
  const int oy = y0 + warp;
  for (int e = lane; e < FTW * NO; e += 32) {
    const int px = e / NO, o = e % NO, gx = x0 + px;
    if (oy < H && gx < W)
      out[(((size_t)b * H + oy) * W + gx) * NO + o] = wt::from_f<T>(cbuf[px * LDC + o]);
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

#include "tma_host.cuh"

namespace {

int launch_tc(const void* hh, const void* at, const void* w4, const void* w3, void* out, int B,
              int H, int W, int C1, int C2, int NO, cudaStream_t s) {
  const int smem = tc_bytes(C1, C2);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cuuint64_t h_dims[4] = {(cuuint64_t)C1, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t a_dims[4] = {(cuuint64_t)C2, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t h_box[4] = {64, SW4, SH4, 1}, a_box[4] = {64, SW3, SH3, 1};
  CUtensorMap hm, am;
  if (!sm90::encode_map(&hm, hh, 4, h_dims, h_box) || !sm90::encode_map(&am, at, 4, a_dims, a_box))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(head_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  head_tc_kernel<<<(int)(tiles < sms ? tiles : sms), TC_THREADS, smem, s>>>(
      hm, am, static_cast<const bf16*>(w4), static_cast<const bf16*>(w3), static_cast<bf16*>(out),
      B, H, W, C1, C2, NO);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* hh, const void* at, const void* w4, const void* w3, void* out, int B,
           int H, int W, int C1, int C2, int NO, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(C1, C2);
  cudaError_t err = cudaFuncSetAttribute(packed_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + FTW - 1) / FTW, (H + FTH - 1) / FTH, B);
  packed_head_kernel<T><<<grid, NTHREADS, smem, s>>>(
      static_cast<const T*>(hh), static_cast<const T*>(at), static_cast<const T*>(w4),
      static_cast<const T*>(w3), static_cast<T*>(out), H, W, C1, C2, NO);
  return (int)cudaGetLastError();
}

}  // namespace

// out = conv(hh, w4, pad ((1,2),(1,2))) + conv(at, w3, pad 1) on `stream`;
// returns the cudaError_t of the launch (0 on success). hh (B,H,W,C1), at
// (B,H,W,C2), w4 (4,4,C1,NO), w3 (3,3,C2,NO), out (B,H,W,NO), contiguous,
// one type: bfloat16 (is_bf16 != 0; C1, C2 % 16 == 0) or float32 (% 4).
// tc != 0 (bfloat16 only) runs head_tc_kernel, which needs tc_bytes(C1, C2)
// <= 232,448 and hh, at 16-byte aligned (TMA reads them); tc == 0 the first
// design's kernel.
extern "C" int packed_head_launch(const void* hh, const void* at, const void* w4, const void* w3,
                                  void* out, int B, int H, int W, int C1, int C2, int NO,
                                  int is_bf16, int tc, void* stream) {
  const int unit = is_bf16 ? 16 : 4;
  if (B < 1 || H < 1 || W < 1 || NO < 1 || NO > NPAD || C1 < unit || C2 < unit || C1 % unit ||
      C2 % unit || (tc && !is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) return launch_tc(hh, at, w4, w3, out, B, H, W, C1, C2, NO, s);
  return is_bf16 ? launch<bf16>(hh, at, w4, w3, out, B, H, W, C1, C2, NO, s)
                 : launch<float>(hh, at, w4, w3, out, B, H, W, C1, C2, NO, s);
}
