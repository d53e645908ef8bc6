// Fused decoder tail for Hopper (sm_90a): the CUDA counterpart of the TPU
// kernel diffusionremotesensing_tpu/ops/dec_block.py:dec_block (:178,
// pallas_call :194; _dec_kernel :132). On level 1 (s2d level 0's grid) it
// computes, with the UpConvBlock-2 BatchNorm folded into its conv by
// ops/dec_block.py:build_dec_weights,
//
//   h   = conv3x3(concat(xa, xb)) + ba          (stage-1 concat conv, 192 -> 64)
//   hh  = relu(conv3x3(round(h + te)) + bb)     (UpConvBlock-2 body, 64 -> 64;
//                                                zero padding of round(h + te))
//   out = conv4x4(hh, head_up4, pad (1,2))      (composed head, 64 -> out4 = 12)
//
// and writes h (the gating branch reads it), hh's row 0 and column 0 (the
// head's boundary strips, applied outside as in the reference) and out. The
// TPU kernel packed 8 head rows into the lanes of the 12-channel output (a
// TPU lane device not carried over): out is written unpacked, (B, H, W,
// out4). Products accumulate in float32; h, h + te, hh and out are rounded
// to the compute type where the reference kernel rounds them.
//
// What bounds it. At the main path's shape (B=48, 64x64) the three convs
// are 59.9 GFLOP (the composed head_up4 counted at the 25 of its 64
// sub-pixel taps that are not structural zeros): 0.0605 ms at the 989
// TFLOP/s bf16 tensor rate, against 105 MB read and written once (xa, xb,
// h, out in bf16), 31 us at 3.35 TB/s: bound by operations. The products
// the kernels issue are 64.4 GFLOP: the concat conv 43.5, the body 14.5 and
// the head 6.4 (16 taps x 16 columns, 12 of them real).
//
// The bfloat16 kernels (the served type). The first design (a block per
// 128 pixels copying all nine taps' weight rows by cp.async, WMMA 16-row warp
// tiles through a float32 buffer; the tail reading every weight fragment
// from device memory in every warp, staging synchronously) took about 1.7
// ms at B=48. This one is three launches of one warp-specialised kernel,
// dec_tc_kernel<MODE>, with h and hh as the seams (hh is the wrapper's
// scratch tensor):
//
//   CONCAT  h = conv3x3(xa | xb) + ba    3 planes of 64 channels, W streamed
//   BODY    hh = relu(conv3x3(round(h + te)) + bb) and its two strips
//   HEAD    out = conv4x4(hh, head_up4)  16 taps, N = 16
//
// 1. A persistent grid of at most one block an SM walks the output tiles of
//    8 rows x 32 pixels (768 at B=48, 16 at B=1). A block is two consumer
//    warpgroups and a producer warp. Each warpgroup owns 128 pixels of the
//    tile, two 64-pixel M-tiles (tile rows 4 wg + 2 m and 4 wg + 2 m + 1),
//    so each weight byte staged serves 256 output pixels.
// 2. The producer warp's lane 0 issues every copy as TMA boxes completing
//    on mbarriers: the tile's input slab (the tile and its halo, (8 + k - 1)
//    x (32 + k - 1) pixels for a k x k window) one 64-channel plane a box,
//    whose rows and columns outside the image land as zeros (the convs'
//    zero padding); and the weights, one tap's 64 input rows x N columns a
//    piece. Planes go through a ring of slots ("full" on landing, "empty"
//    when the 256 consumer threads are done with them), one plane ahead of
//    its weight pieces.
// 3. The weights. W_a (9 x 192 x 64 bf16, 221,184 bytes) does not fit beside
//    a slab, so CONCAT streams it from L2 through a ring of 6 piece slots of
//    8 KB, in the order the MMAs use them (plane-major: plane p's 9 taps,
//    then plane p + 1's); 221 KB per 256-pixel tile, 170 MB of L2 reads at
//    B=48. W_b (73,728 bytes) and the head's k4k (32,768) are staged whole
//    once per block.
// 4. BODY's input is round(h + te), zero outside the image. The producer
//    warp adds te to the landed h slab in shared memory where the pixel lies
//    inside the image (the box's zeros outside stay zero, which is the
//    padding of h + te and not te), then arrives on the slot's "ready"
//    barrier, which the consumers wait on instead of "full".
// 5. Warpgroup MMA: A (64 pixels x 16 channels of one tap's shifted window)
//    from registers by ldmatrix on the 128-byte-swizzled slab, in place (no
//    im2col), B the staged weight piece through a descriptor:
//    wgmma.m64n64k16 (CONCAT, BODY: W rows of 128 bytes, 128-byte swizzle)
//    or m64n16k16 (HEAD: k4k rows of 32 bytes, 32-byte swizzle). A batch is
//    one piece: 4 k-steps x 2 M-tiles = 8 MMAs, one commit group; two
//    register sets for A let the next batch's ldmatrix run under this
//    batch's MMAs, and a piece (and, after its last tap, a plane) is
//    released once the batch after it has been issued and its own MMAs are
//    done (wgmma_wait<1>).
// 6. The epilogues write from the accumulator registers: bias (and relu),
//    rounding to bf16, a quad transpose (sm90::quad_transpose) so that each
//    lane stores 16 bytes of one pixel; BODY writes the strips from the same
//    registers as hh, so they are exactly the values the head reads. HEAD
//    stores the 12 real columns as 4-byte pairs.
//
// Two choices were measured on an H100 80GB HBM3 at 700 W with throwaway
// probes (not kept):
// * The MMA form. (a), the form above, issued 707 TFLOP/s in a loop of
//   ldmatrix and m64n64k16 from registers (two warpgroups, two M-tiles
//   each, no copies), and 249 TFLOP/s at m64n16k16. (b), the transposed
//   product h^T = W^T X^T with the 64 output channels on M, W^T's pieces
//   as A and the pixels as a non-swizzled K-major B from shared memory
//   (m64n256k16, each tap's shift a descriptor offset, no ldmatrix),
//   issued 976 TFLOP/s. (a) was kept: (b) needs its 256 pixels
//   contiguous in the slab (N spanning slab rows and their halo columns),
//   24 TMA boxes of 16-byte rows a slab, and an epilogue that transposes
//   channels-by-pixels accumulators for the pixel-major h; (a) reuses
//   tap_conv.cu's slab layout and epilogue, and its loop rate alone puts
//   the concat conv near 0.06 ms, far under the 0.51 ms of the cuDNN ops.
// * The tail. A fused body and head, hh kept in shared memory, recomputes
//   the head's halo: an 8 x 32 tile needs hh on 11 x 35 pixels, 1.50x.
//   The body kernel over 1.5x the pixels (B=48, 96 x 64) took 0.0935 ms
//   against 0.0644 over 64 x 64: the recompute costs ~0.029 ms, about
//   twice what writing and reading hh's 25,165,824 bytes can cost (15 us
//   at 3.35 TB/s; hh fits the 50 MB L2). So hh goes to device memory
//   and the head is the third launch (0.0339 ms).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): CONCAT 168 registers, BODY 164,
// HEAD 108, no spills. 168 is where ptxas capped CONCAT at 288 threads;
// with the bias held in 16 registers a lane it spilled 20/28 bytes, so
// the epilogues read the bias from memory.
//
// Shared memory (bytes; 1024 for the alignment of the swizzle atoms):
//   CONCAT 1024 + 4 planes x 44,032 (10 x 34 x 128, rounded to 1024)
//          + 6 pieces x 8,192 + 24 mbarriers x 8 = 226,496
//   BODY   1024 + 3 x 44,032 + 9 x 8,192 + 10 x 8 = 206,928
//   HEAD   1024 + 3 x 50,176 (11 x 35 x 128) + 16 x 2,048 + 10 x 8 = 184,400
// of the 232,448 a block may have (Tc<MODE>::BYTES).
//
// float32 (the golden and model phases' type, not the served one) keeps
// the first design, two FMA kernels with h as the seam: dec_concat_f32 (128
// consecutive pixels a block, each tap's shifted rows and weight rows
// staged by cp.async) and dec_tail_f32 (a 16 x 16 tile a block: hh on the
// tile and the head's halo, (16 + 3)^2 pixels, in shared memory, then the
// head from it), products as warp_tile.cuh's FMA tiles.

#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using wt::bf16;
using wt::from_f;
using wt::to_f;

constexpr int CA = 128;       // xa channels (the up branch)
constexpr int CB = 64;        // xb channels (attention 1)
constexpr int CK = CA + CB;   // concat channels
constexpr int CM = 64;        // h and hh channels
constexpr int OUT4 = 12;      // head channels written
constexpr int NPAD = 16;      // head columns computed (the weight is zero-padded to 16)

// ------------------------------------------------ bfloat16: wgmma kernels

enum Mode { CONCAT = 0, BODY = 1, HEAD = 2 };

constexpr int TH = 8, TW = 32;              // output tile: 8 rows x 32 pixels
constexpr int CONSUMERS = 256;              // two warpgroups, 128 pixels each
constexpr int TC_THREADS = CONSUMERS + 32;  // and the producer warp

__host__ __device__ constexpr int round1024(int b) { return (b + 1023) / 1024 * 1024; }

template <int MODE> struct Tc {
  static constexpr int KW = MODE == HEAD ? 4 : 3;          // window edge
  static constexpr int TAPS = KW * KW;
  static constexpr int NPLANE = MODE == CONCAT ? 3 : 1;    // 64-channel planes of the input
  static constexpr int NPLANE_A = MODE == CONCAT ? 2 : 1;  // ... of the first map (xa)
  static constexpr int N = MODE == HEAD ? NPAD : CM;       // output columns
  static constexpr int NB = NPLANE * TAPS;                 // batches (weight pieces) a tile
  static constexpr bool RESIDENT = MODE != CONCAT;         // W staged whole, else streamed
  static constexpr int NPL = MODE == CONCAT ? 4 : 3;       // plane slots
  static constexpr int NWS = RESIDENT ? NB : 6;            // weight piece slots
  static constexpr int SW = TW + KW - 1, SH = TH + KW - 1; // slab: the tile and its halo
  static constexpr int PLANE_TX = SH * SW * 128;           // bytes a plane's box lands
  static constexpr int PLANE = round1024(PLANE_TX);
  static constexpr int ROW = 2 * N;                        // bytes of a weight row: 128 or 32
  static constexpr int PIECE = 64 * ROW;                   // one tap's 64 input rows
  // full, ready and empty of each plane slot; full and empty of each piece
  // slot, or one full for the resident weights
  static constexpr int BARS = 3 * NPL + (RESIDENT ? 1 : 2 * NWS);
  static constexpr int BYTES = 1024 + NPL * PLANE + NWS * PIECE + 8 * BARS;
};

// round(h + te) in a landed h plane (BODY's producer warp): pixel p of the
// slab (image origin (y0 - 1, x0 - 1)) gets te where it lies inside the
// image; outside, the box's zeros stay. Lane l owns 16-byte chunk l % 8
// (channels 8 (l % 8) .. + 7, at chunk (l % 8) ^ p % 8 of the swizzled row)
// of every fourth pixel.
__device__ __forceinline__ void add_te(unsigned char* plane, const bf16* __restrict__ te_b,
                                       int x0, int y0, int H, int W) {
  using C = Tc<BODY>;
  const int lane = threadIdx.x % 32, c = lane % 8;
  float tv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) tv[i] = to_f(te_b[8 * c + i]);
  for (int p = lane / 8; p < C::SH * C::SW; p += 4) {
    const int y = y0 - 1 + p / C::SW, x = x0 - 1 + p % C::SW;
    if (y < 0 || y >= H || x < 0 || x >= W) continue;
    uint4* q = reinterpret_cast<uint4*>(plane + p * 128 + ((c ^ (p & 7)) << 4));
    uint4 v = *q;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = from_f<bf16>(to_f(e[i]) + tv[i]);
    *q = v;
  }
}

template <int MODE>
__device__ __forceinline__ void tc_mma(float (&acc)[2][Tc<MODE>::N / 2],
                                       const uint32_t (&a)[4][2][4], const unsigned char* piece) {
  using C = Tc<MODE>;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned char* st = piece + kk * 16 * C::ROW;  // 16 rows of W a k-step
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if constexpr (C::N == 16)
        sm90::wgmma_m64n16k16(acc[m], a[kk][m], sm90::desc_sw32(st, 0, 8 * C::ROW));
      else
        sm90::wgmma_m64n64k16(acc[m], a[kk][m], sm90::desc_sw128(st, 0, 8 * C::ROW));
    }
  }
  sm90::wgmma_commit();
}

// Grid: min(#SMs, tiles) blocks of TC_THREADS threads, dynamic shared
// memory Tc<MODE>::BYTES. amap, bmap: the input planes' tensors as 4-D
// (C, W, H, B) with boxes (64, SW, SH, 1) (CONCAT: xa, xb; BODY: h; HEAD:
// hh); wmap: the weight matrix (rows tap * 64 NPLANE + channel, N columns)
// with boxes (N, 64): W_a, W_b or k4k. bias: ba or bb (none for HEAD); te:
// (B, 64), BODY's; out (B, H, W, N or 12), and BODY's strips r0 (B, 1, W,
// 64) and c0 (B, H, 1, 64).
template <int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1)
dec_tc_kernel(const __grid_constant__ sm90::TensorMap amap,
              const __grid_constant__ sm90::TensorMap bmap,
              const __grid_constant__ sm90::TensorMap wmap, const bf16* __restrict__ bias,
              const bf16* __restrict__ te, bf16* __restrict__ out, bf16* __restrict__ r0,
              bf16* __restrict__ c0, int B, int H, int W) {
  using C = Tc<MODE>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms want 1024-byte alignment of the shared address
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + C::NPL * C::PLANE;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + C::NWS * C::PIECE);
  uint64_t* ready = full + C::NPL;
  uint64_t* empty = ready + C::NPL;
  uint64_t* wfull = empty + C::NPL;   // [NWS] (streamed) or [1] (resident)
  uint64_t* wempty = wfull + C::NWS;  // streamed only
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_x * tiles_y;
  const int mine = ntiles > (int)blockIdx.x ? (ntiles - blockIdx.x - 1) / gridDim.x + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < C::NPL; ++s) {
      sm90::mbar_init(&full[s], 1);  // lane 0's arrival, and the box's bytes
      sm90::mbar_init(&ready[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    if constexpr (C::RESIDENT) {
      sm90::mbar_init(wfull, 1);
    } else {
      for (int s = 0; s < C::NWS; ++s) {
        sm90::mbar_init(&wfull[s], 1);
        sm90::mbar_init(&wempty[s], CONSUMERS);
      }
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();  // the mbarriers are initialised

  if (warp == CONSUMERS / 32) {
    // ---- the producer warp. Plane k is the block's k-th (tile k / NPLANE,
    // plane k % NPLANE), in slot k % NPL.
    auto tile_of = [&](int k, int& b, int& y0, int& x0) {
      const int t = blockIdx.x + (k / C::NPLANE) * gridDim.x;
      const int r = t % (tiles_x * tiles_y);
      b = t / (tiles_x * tiles_y);
      y0 = r / tiles_x * TH;
      x0 = r % tiles_x * TW;
    };
    auto load_plane = [&](int k) {
      const int s = k % C::NPL, p = k % C::NPLANE;
      int b, y0, x0;
      tile_of(k, b, y0, x0);
      if (k >= C::NPL) sm90::mbar_wait(&empty[s], (k / C::NPL - 1) & 1);
      if (lane == 0) {
        unsigned char* dst = base + s * C::PLANE;
        sm90::mbar_arrive_expect_tx(&full[s], C::PLANE_TX);
        if (p < C::NPLANE_A)
          sm90::tma_load_4d(dst, &amap, 64 * p, x0 - 1, y0 - 1, b, &full[s]);
        else
          sm90::tma_load_4d(dst, &bmap, 64 * (p - C::NPLANE_A), x0 - 1, y0 - 1, b, &full[s]);
      }
    };
    if constexpr (C::RESIDENT) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(wfull, C::NWS * C::PIECE);
        for (int j = 0; j < C::NWS; ++j)
          sm90::tma_load_2d(wsm + j * C::PIECE, &wmap, 0, 64 * j, wfull);
      }
    }
    const int nplanes = mine * C::NPLANE;
    if (nplanes > 0) load_plane(0);
    for (int k = 0; k < nplanes; ++k) {
      if (k + 1 < nplanes) load_plane(k + 1);  // one plane ahead of plane k's weights
      if constexpr (MODE == BODY) {
        const int s = k % C::NPL;
        int b, y0, x0;
        tile_of(k, b, y0, x0);
        sm90::mbar_wait(&full[s], (k / C::NPL) & 1);
        add_te(base + s * C::PLANE, te + b * CM, x0, y0, H, W);
        sm90::fence_proxy_async();  // before TMA writes the slot again
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&ready[s]);
      }
      if constexpr (!C::RESIDENT) {
        const int p = k % C::NPLANE;
        for (int tap = 0; tap < C::TAPS; ++tap) {
          const int j = k * C::TAPS + tap, s = j % C::NWS;  // the block's j-th piece
          if (j >= C::NWS) sm90::mbar_wait(&wempty[s], (j / C::NWS - 1) & 1);
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&wfull[s], C::PIECE);
            sm90::tma_load_2d(wsm + s * C::PIECE, &wmap, 0, tap * 64 * C::NPLANE + 64 * p,
                              &wfull[s]);
          }
        }
      }
    }
    return;
  }

  // ---- the consumers. Warp w of warpgroup wg computes, in M-tile m, tile
  // row 4 wg + 2 m + w / 2, pixels 16 (w % 2) .. + 15; ldmatrix lane l
  // addresses pixel 16 (w % 2) + l % 16 at channel 8 (l / 16) of a k-step.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int row_w = 4 * wg + w / 2, px_w = 16 * (w % 2);
  uint64_t* plane_bar = MODE == BODY ? ready : full;
  if constexpr (C::RESIDENT) sm90::mbar_wait(wfull, 0);

  for (int it = 0; it < mine; ++it) {
    const int t = blockIdx.x + it * gridDim.x, r = t % (tiles_x * tiles_y);
    const int b = t / (tiles_x * tiles_y), y0 = r / tiles_x * TH, x0 = r % tiles_x * TW;

    // batch s: plane p = s / TAPS (the block's plane it NPLANE + p), tap s % TAPS
    auto load_a = [&](uint32_t (&a)[4][2][4], int s) {
      const int k = it * C::NPLANE + s / C::TAPS, tap = s % C::TAPS;
      if (tap == 0) sm90::mbar_wait(&plane_bar[k % C::NPL], (k / C::NPL) & 1);
      const unsigned char* plane = base + (k % C::NPL) * C::PLANE;
      const int dy = tap / C::KW, dx = tap % C::KW;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int p = (row_w + 2 * m + dy) * C::SW + px_w + lane % 16 + dx;
          const int chunk = (2 * kk + lane / 16) ^ (p & 7);  // the 128-byte swizzle
          sm90::ldmatrix_x4(a[kk][m], plane + p * 128 + chunk * 16);
        }
    };
    float acc[2][C::N / 2];
    auto issue = [&](const uint32_t (&a)[4][2][4], int s) {
      int slot = s;
      if constexpr (!C::RESIDENT) {
        const int j = it * C::NB + s;
        slot = j % C::NWS;
        sm90::mbar_wait(&wfull[slot], (j / C::NWS) & 1);
      }
      tc_mma<MODE>(acc, a, wsm + slot * C::PIECE);
    };
    // batch s's MMAs are done: its piece, and after a plane's last tap the
    // plane, go back to the producer
    auto release = [&](int s) {
      if constexpr (!C::RESIDENT) sm90::mbar_arrive(&wempty[(it * C::NB + s) % C::NWS]);
      if (s % C::TAPS == C::TAPS - 1)
        sm90::mbar_arrive(&empty[(it * C::NPLANE + s / C::TAPS) % C::NPL]);
    };

#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < C::N / 2; ++i) acc[m][i] = 0.f;
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
    uint32_t a0[4][2][4], a1[4][2][4];
    load_a(a0, 0);
    for (int s = 0; s < C::NB; s += 2) {
      issue(a0, s);
      sm90::wgmma_wait<1>();  // batch s - 1 is done: a1 is free
      if (s > 0) release(s - 1);
      if (s + 1 < C::NB) {
        load_a(a1, s + 1);
        issue(a1, s + 1);
        sm90::wgmma_wait<1>();  // batch s is done: a0 is free
        release(s);
        if (s + 2 < C::NB) load_a(a0, s + 2);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
    release(C::NB - 1);

    // ---- epilogue: rows g and g + 8 of the warp's 16 pixels, per M-tile
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = y0 + row_w + 2 * m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + px_w + g + 8 * h;
        const bool inside = y < H && x < W;  // every lane takes part in the shuffles
        const size_t pix = ((size_t)b * H + y) * W + x;
        if constexpr (MODE == HEAD) {
          // columns 8 j + 2 q + e; the 12 real ones as 4-byte pairs
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (inside && 8 * j + 2 * q < OUT4)
              *reinterpret_cast<uint32_t*>(out + pix * OUT4 + 8 * j + 2 * q) =
                  sm90::pack_bf16x2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
        } else {
#pragma unroll
          for (int jg = 0; jg < C::N / 32; ++jg) {
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int jj = 4 * jg + j;  // 8-column group: columns 8 jj + 2 q, + 1
              float lo = acc[m][4 * jj + 2 * h] + to_f(bias[8 * jj + 2 * q]);
              float hi = acc[m][4 * jj + 2 * h + 1] + to_f(bias[8 * jj + 2 * q + 1]);
              if constexpr (MODE == BODY) {
                lo = fmaxf(lo, 0.f);
                hi = fmaxf(hi, 0.f);
              }
              v[j] = sm90::pack_bf16x2(lo, hi);
            }
            sm90::quad_transpose(v);  // this lane: columns 32 jg + 8 q .. + 7
            const uint4 o = uint4{v[0], v[1], v[2], v[3]};
            const int col = 32 * jg + 8 * q;
            if (!inside) continue;
            *reinterpret_cast<uint4*>(out + pix * CM + col) = o;
            if constexpr (MODE == BODY) {
              if (y == 0) *reinterpret_cast<uint4*>(r0 + ((size_t)b * W + x) * CM + col) = o;
              if (x == 0) *reinterpret_cast<uint4*>(c0 + ((size_t)b * H + y) * CM + col) = o;
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------ float32: FMA kernels

constexpr int NTHREADS = 256;
constexpr int MP = 128;       // pixels per pass: 8 warps x 16 rows
constexpr int TILE = 16;      // tail output tile edge
constexpr int SHH = TILE + 3; // hh slab edge
constexpr int NSH = SHH * SHH;
constexpr int LDK = CK + 8;   // shared-memory row strides (elements)
constexpr int LDM = CM + 8;
constexpr int LDC = CM + 4;   // float32 accumulator rows

struct ConcatSmem {
  static constexpr size_t a_bytes = sizeof(float) * MP * LDK;
  static constexpr size_t as = 0;                            // [MP][LDK], then [MP][LDC]
  static constexpr size_t bs = wt::align128(as + a_bytes);   // [CK][LDM]
  static constexpr size_t cs = 0;  // the accumulators, over A after the last tap
  static constexpr size_t bytes = wt::align128(bs + sizeof(float) * CK * LDM);
  static_assert(sizeof(float) * MP * LDC <= a_bytes, "the accumulators must fit the A buffer");
};

struct TailSmem {
  static constexpr size_t hhs = 0;                                              // [NSH][LDM]
  static constexpr size_t as = wt::align128(hhs + sizeof(float) * NSH * LDM);   // [MP][LDM]
  static constexpr size_t cs = wt::align128(as + sizeof(float) * MP * LDM);     // [MP][LDC]
  static constexpr size_t bytes = wt::align128(cs + sizeof(float) * MP * LDC);
};

// Copy tap `tap`'s operands: the shifted xa|xb rows of the block's pixels
// (zero outside the image) and the tap's weight rows.
__device__ __forceinline__ void concat_stage(float* A, float* Bt, const float* __restrict__ xa,
                                             const float* __restrict__ xb,
                                             const float* __restrict__ wa, long long p0, int tap,
                                             int B, int H, int W) {
  constexpr int V = wt::Vec<float>::N;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const long long total = (long long)B * H * W;
  for (int e = threadIdx.x; e < MP * (CK / V); e += NTHREADS) {
    const int r = e / (CK / V), u = e % (CK / V);
    const long long P = p0 + r;
    const float* src = xa;
    bool valid = false;
    if (P < total) {
      const int x = (int)(P % W) + dx, y = (int)(P / W % H) + dy;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const size_t pix = ((size_t)(P / ((long long)H * W)) * H + y) * W + x;
        src = u < CA / V ? xa + pix * CA + u * V : xb + pix * CB + (u - CA / V) * V;
        valid = true;
      }
    }
    wt::cp_async16(A + r * LDK + u * V, src, valid);
  }
  const float* w = wa + (size_t)tap * CK * CM;
  for (int e = threadIdx.x; e < CK * (CM / V); e += NTHREADS) {
    const int r = e / (CM / V), u = e % (CM / V);
    wt::cp_async16(Bt + r * LDM + u * V, w + (size_t)r * CM + u * V, true);
  }
  wt::cp_async_commit();
}

// Grid ceil(B*H*W / MP), NTHREADS threads, dynamic shared memory
// ConcatSmem::bytes. wa: (9*CK, CM), rows (dy, dx, channel of xa|xb).
__global__ void __launch_bounds__(NTHREADS)
dec_concat_f32_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                      const float* __restrict__ wa, const float* __restrict__ ba,
                      float* __restrict__ h, int B, int H, int W) {
  using L = ConcatSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw + L::as);
  float* bs = reinterpret_cast<float*>(smem_raw + L::bs);
  float* cs = reinterpret_cast<float*>(smem_raw + L::cs);
  const long long total = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * MP;
  const int wrow = 16 * (threadIdx.x / 32);

  wt::WarpTile<float, 4> t;
  t.zero();
  for (int tap = 0; tap < 9; ++tap) {
    concat_stage(as, bs, xa, xb, wa, p0, tap, B, H, W);
    wt::cp_async_wait<0>();
    __syncthreads();
    t.mma(as + wrow * LDK, LDK, bs, LDM, CK);
    __syncthreads();
  }
  t.store(cs + wrow * LDC, LDC);
  __syncthreads();
  for (int e = threadIdx.x; e < MP * CM; e += NTHREADS) {
    const int r = e / CM, c = e % CM;
    const long long P = p0 + r;
    if (P < total) h[P * CM + c] = cs[r * LDC + c] + ba[c];
  }
}

// Grid (ceil(W/TILE), ceil(H/TILE), B), NTHREADS threads, dynamic shared
// memory TailSmem::bytes. wb: (9*CM, CM) BN folded; k4k: (16*CM, NPAD).
__global__ void __launch_bounds__(NTHREADS)
dec_tail_f32_kernel(const float* __restrict__ h, const float* __restrict__ te,
                    const float* __restrict__ wb, const float* __restrict__ bb,
                    const float* __restrict__ k4k, float* __restrict__ hr0,
                    float* __restrict__ hc0, float* __restrict__ out, int H, int W) {
  using L = TailSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* hhs = reinterpret_cast<float*>(smem_raw + L::hhs);
  float* as = reinterpret_cast<float*>(smem_raw + L::as);
  float* cs = reinterpret_cast<float*>(smem_raw + L::cs);
  constexpr int V = wt::Vec<float>::N;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int wrow = 16 * (threadIdx.x / 32);
  const float* hb = h + (size_t)b * H * W * CM;

  // ---- phase A: hh on the slab (image origin (y0 - 1, x0 - 1))
  for (int p0 = 0; p0 < NSH; p0 += MP) {
    wt::WarpTile<float, 4> t;
    t.zero();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      for (int e = threadIdx.x; e < MP * (CM / V); e += NTHREADS) {
        const int r = e / (CM / V), u = e % (CM / V), q = p0 + r;
        const int y = y0 - 1 + q / SHH + dy, x = x0 - 1 + q % SHH + dx;
        alignas(16) float v[V];  // the conv's SAME padding of h + te: zero outside the image
        if (q < NSH && y >= 0 && y < H && x >= 0 && x < W) {
          const float4 raw =
              *reinterpret_cast<const float4*>(hb + ((size_t)y * W + x) * CM + u * V);
          const float* hv = reinterpret_cast<const float*>(&raw);
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = hv[i] + te[b * CM + u * V + i];
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = 0.f;
        }
        *reinterpret_cast<float4*>(as + r * LDM + u * V) = *reinterpret_cast<const float4*>(v);
      }
      __syncthreads();
      t.mma(as + wrow * LDM, LDM, wb + (size_t)tap * CM * CM, CM, CM);
      __syncthreads();
    }
    t.store(cs + wrow * LDC, LDC);
    __syncthreads();
    for (int e = threadIdx.x; e < MP * CM; e += NTHREADS) {
      const int r = e / CM, c = e % CM, q = p0 + r;
      if (q >= NSH) continue;
      const int y = y0 - 1 + q / SHH, x = x0 - 1 + q % SHH;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const float v = inside ? fmaxf(cs[r * LDC + c] + bb[c], 0.f) : 0.f;
      hhs[q * LDM + c] = v;
      if (inside && y == 0 && x >= x0 && x < x0 + TILE) hr0[((size_t)b * W + x) * CM + c] = v;
      if (inside && x == 0 && y >= y0 && y < y0 + TILE) hc0[((size_t)b * H + y) * CM + c] = v;
    }
    __syncthreads();
  }

  // ---- phase B: out = conv4x4(hh, head_up4) on the tile, one tap at a time
  for (int p0 = 0; p0 < TILE * TILE; p0 += MP) {
    wt::WarpTile<float, 1> t;
    t.zero();
    for (int tap = 0; tap < 16; ++tap) {
      const int dy = tap / 4, dx = tap % 4;
      for (int e = threadIdx.x; e < MP * (CM / V); e += NTHREADS) {
        const int r = e / (CM / V), u = e % (CM / V), q = p0 + r;
        *reinterpret_cast<float4*>(as + r * LDM + u * V) = *reinterpret_cast<const float4*>(
            hhs + ((q / TILE + dy) * SHH + q % TILE + dx) * LDM + u * V);
      }
      __syncthreads();
      t.mma(as + wrow * LDM, LDM, k4k + (size_t)tap * CM * NPAD, NPAD, CM);
      __syncthreads();
    }
    t.store(cs + wrow * LDC, LDC);
    __syncthreads();
    for (int e = threadIdx.x; e < MP * OUT4; e += NTHREADS) {
      const int r = e / OUT4, c = e % OUT4, q = p0 + r;
      const int y = y0 + q / TILE, x = x0 + q % TILE;
      if (y < H && x < W) out[(((size_t)b * H + y) * W + x) * OUT4 + c] = cs[r * LDC + c];
    }
    __syncthreads();
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

#include "tma_host.cuh"

namespace {

template <int MODE>
int launch_mode(const CUtensorMap& amap, const CUtensorMap& bmap, const CUtensorMap& wmap,
                const void* bias, const void* te, void* out, void* r0, void* c0, int B, int H,
                int W, int grid, cudaStream_t s) {
  constexpr int smem = Tc<MODE>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dec_tc_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dec_tc_kernel<MODE><<<grid, TC_THREADS, smem, s>>>(
      amap, bmap, wmap, static_cast<const bf16*>(bias), static_cast<const bf16*>(te),
      static_cast<bf16*>(out), static_cast<bf16*>(r0), static_cast<bf16*>(c0), B, H, W);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* const* p, void* const* o, int B, int H, int W, cudaStream_t s) {
  const cuuint64_t b = B, h = H, w = W;
  const cuuint64_t xa_dims[4] = {CA, w, h, b}, xb_dims[4] = {CB, w, h, b};
  const cuuint64_t m_dims[4] = {CM, w, h, b};
  const cuuint64_t wa_dims[2] = {CM, 9 * CK}, wb_dims[2] = {CM, 9 * CM};
  const cuuint64_t k4_dims[2] = {NPAD, 16 * CM};
  using C3 = Tc<CONCAT>;
  using C4 = Tc<HEAD>;
  const cuuint32_t box3[4] = {64, C3::SW, C3::SH, 1}, box4[4] = {64, C4::SW, C4::SH, 1};
  const cuuint32_t wbox[2] = {CM, 64}, kbox[2] = {NPAD, 64};
  CUtensorMap xa, xb, wa, hm, wb, hhm, k4;
  if (!sm90::encode_map(&xa, p[0], 4, xa_dims, box3) ||
      !sm90::encode_map(&xb, p[1], 4, xb_dims, box3) ||
      !sm90::encode_map(&wa, p[2], 2, wa_dims, wbox) ||
      !sm90::encode_map(&hm, o[0], 4, m_dims, box3) ||
      !sm90::encode_map(&wb, p[5], 2, wb_dims, wbox) ||
      !sm90::encode_map(&hhm, o[4], 4, m_dims, box4) ||
      !sm90::encode_map(&k4, p[7], 2, k4_dims, kbox, CU_TENSOR_MAP_SWIZZLE_32B))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  // h, then hh and its strips, then out
  int err = launch_mode<CONCAT>(xa, xb, wa, p[3], nullptr, o[0], nullptr, nullptr, B, H, W,
                                grid, s);
  if (err == 0)
    err = launch_mode<BODY>(hm, hm, wb, p[6], p[4], o[4], o[1], o[2], B, H, W, grid, s);
  if (err == 0)
    err = launch_mode<HEAD>(hhm, hhm, k4, nullptr, nullptr, o[3], nullptr, nullptr, B, H, W,
                            grid, s);
  return err;
}

int launch_f32(const void* const* p, void* const* o, int B, int H, int W, cudaStream_t s) {
  auto a = [&](int i) { return static_cast<const float*>(p[i]); };
  auto w = [&](int i) { return static_cast<float*>(o[i]); };
  cudaError_t err = cudaFuncSetAttribute(dec_concat_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)ConcatSmem::bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dec_tail_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TailSmem::bytes);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * H * W;
  dec_concat_f32_kernel<<<(unsigned)((total + MP - 1) / MP), NTHREADS, ConcatSmem::bytes, s>>>(
      a(0), a(1), a(2), a(3), w(0), B, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  dec_tail_f32_kernel<<<grid, NTHREADS, TailSmem::bytes, s>>>(w(0), a(4), a(5), a(6), a(7), w(1),
                                                              w(2), w(3), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the kernels on `stream`; returns the first cudaError_t (0 on
// success). ins, contiguous and of one type (bfloat16 if is_bf16, else
// float32): xa (B,H,W,128), xb (B,H,W,64), wa (9*192, 64), ba (64),
// te (B,64), wb (9*64, 64), bb (64), k4k (16*64, 16) the head_up4 kernel
// with its 12 columns zero-padded to 16. outs: h (B,H,W,64),
// hh row 0 (B,1,W,64), hh column 0 (B,H,1,64), out (B,H,W,12), and the
// scratch hh (B,H,W,64) that bfloat16's head reads (unused in float32).
extern "C" int dec_block_launch(const void* const* ins, void* const* outs, int B, int H, int W,
                                int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(ins, outs, B, H, W, s) : launch_f32(ins, outs, B, H, W, s);
}
