// A direct 3x3 SAME convolution with bias for Hopper (sm_90a): the CUDA
// counterpart of the TPU kernel diffusionremotesensing_tpu/ops/packed_conv.py:
// packed_conv (:90, pallas_call :111; _packed_conv_kernel :53). For x
// (B, H, W, Ci), an HWIO kernel K (3, 3, Ci, Co), Co <= 64, and an optional
// bias (Co,)
//
//   out = conv(x, K, SAME) + bias
//
// products accumulated in float32, the bias (in the input type) added to
// the accumulator, the sum rounded once to the input type, as the TPU
// kernel does. The JAX model never calls the TPU kernel (its module:
// "not wired into the model", ops/packed_conv.py:24-29), so neither does
// the port: this is the op alone.
//
// What bounds it. At the level-1 shapes of the TPU kernel's docstring
// (B=48, 64x64 pixels, Co=64), 64->64 is 14.5 GFLOP and 50.4 MB in
// bfloat16 (x read, out written, K once): 15 us at 3.35 TB/s against 15 us
// at 989 TFLOP/s, bound by bytes by a hair; 192->64 is 43.5 GFLOP and 100.9
// MB, 44 us against 30 us, bound by operations.
//
// The bfloat16 kernel (conv_tc_kernel<N, RESIDENT>). The first design (a
// block per 8 x 16 pixels, WMMA warp tiles, K read through the caches, no
// copy/compute overlap) took 0.311 ms at 64->64 and 0.916 at 192->64 on an
// H100, 4-6x cuDNN. This one is csrc/dec_block.cu's BODY (64->64, W
// resident) and CONCAT (192->64, W streamed) modes without te and relu,
// one template over the column count N and the weights' residence:
//
// 1. A persistent grid of at most one block an SM walks the output tiles of
//    8 rows x 32 pixels (768 at B=48, 64x64). A block is two consumer
//    warpgroups and a producer warp; each warpgroup owns two 64-pixel
//    M-tiles of the tile (tile rows 4 wg + 2 m and 4 wg + 2 m + 1).
// 2. The producer warp's lane 0 issues every copy as TMA boxes completing
//    on mbarriers: the x slab (the tile and its halo, 10 x 34 pixels, zero
//    outside the image: the SAME padding) as ceil(Ci / 64) planes of 64
//    channels, 128-byte swizzle, box channel offset 64 p (channels past Ci
//    land as zeros), through a ring of plane slots ("full" on landing,
//    "empty" when the 256 consumer threads are done), one plane ahead of
//    its weight pieces.
// 3. The weights, K read as it is, a (9 Ci) x Co matrix: a piece is one
//    (plane, tap), rows 64 p .. 64 p + 63 of the tap (rows past Ci belong to
//    the next tap or lie outside and meet x's zero channels), in MMA order
//    (plane-major). RESIDENT when all 9 ceil(Ci / 64) pieces fit beside a
//    3-slot ring: staged once per block (64->64: 73,728 bytes). Else they
//    stream from L2 through 6 piece slots beside a 4-slot ring (192->64: 27
//    pieces, 221,184 bytes a tile).
// 4. Warpgroup MMA: A (64 pixels x 16 channels of one tap's shifted window)
//    from registers by ldmatrix on the swizzled slab, in place (no im2col);
//    B the staged piece through a descriptor. N = 64: wgmma.m64n64k16, rows
//    of 128 bytes in one atom, 128-byte swizzle. N = 16, 32:
//    wgmma.m64n{16,32}k16, N / 16 atoms of 16 columns (32-byte rows, 32-byte
//    swizzle, one TMA box each) 2,048 bytes apart. A batch is one piece: 4
//    k-steps x 2 M-tiles, one commit group; two register sets for A let the
//    next batch's ldmatrix run under this batch's MMAs; a piece (and after
//    its last tap a plane) is released once its MMAs are done.
// 5. The epilogue writes from the accumulator registers: bias read from
//    memory (held in registers it made dec_block spill), rounding to bf16,
//    sm90::quad_transpose so that each lane stores 16 bytes of one pixel
//    (N = 16: 4-byte pairs).
//
// Co = 48 runs at N = 64: the weight box of 64 columns over the 48-column
// K lands columns 48-63 as zeros (TMA's out-of-bounds fill), and the
// epilogue stores only the 48 real ones. No wgmma m64n48k16 was added: the
// padded form needs no new instruction, host meaning or test, and Co = 48 is
// on no path (the flagship's Co is 64), so its 4/3 of issued products costs
// nothing served.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): conv_tc_kernel<64, resident> 166
// registers, <64, streamed> 168 (where ptxas caps 288 threads), <32, *>
// 134-136, <16, *> 118-122; no spills. Two choices were measured on an H100
// 80GB HBM3 at 700 W with throwaway probes (variants built side by side in
// one call, not kept): a third register set for A (loading two batches
// ahead) spilled 192-204 bytes at N = 64 and ran 0.0651 / 0.1572 ms at
// 64->64 / 192->64 (B=48) against 0.0396 / 0.0978 with two sets; and a
// plane count fixed at compile time ran 0.0443 / 0.1008 against the run-time
// count's 0.0401 / 0.0996, so the count stays a run-time value. The MMA
// form, the ring depths and the bias read from memory are dec_block.cu's.
//
// Shared memory (bytes; 1024 for the alignment of the swizzle atoms):
//   64->64  1024 + 3 planes x 44,032 (10 x 34 x 128, rounded to 1024)
//           + 9 pieces x 8,192 + 7 mbarriers x 8 = 206,904
//   192->64 1024 + 4 x 44,032 + 6 x 8,192 + 20 x 8 = 226,464
// of the 232,448 a block may have (Tc<N, RESIDENT>::bytes).
//
// float32 (not the served type) keeps the first design's FMA kernel,
// conv_f32_kernel: a block per 8 x 16 tile, the x slab by cp.async, warp w
// computing output row w as warp_tile.cuh's FMA tiles, K read through the
// caches.

#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using wt::bf16;
using wt::to_f;

// ------------------------------------------------ bfloat16: the wgmma kernel

constexpr int TH = 8, TW = 32;              // output tile: 8 rows x 32 pixels
constexpr int SH = TH + 2, SW = TW + 2;     // x slab: the tile and its one-pixel halo
constexpr int CONSUMERS = 256;              // two warpgroups, 128 pixels each
constexpr int TC_THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int SMEM_MAX = 232448;            // shared memory a block may have

__host__ __device__ constexpr int round1024(int b) { return (b + 1023) / 1024 * 1024; }

constexpr int PLANE_TX = SH * SW * 128;     // bytes a 64-channel plane's box lands
constexpr int PLANE = round1024(PLANE_TX);  // 44,032

// N output columns computed (Co, or 64 for Co = 48); the weights resident
// (staged once per block) or streamed through NWS piece slots
template <int N, bool RESIDENT> struct Tc {
  static constexpr int PIECE = 64 * 2 * N;      // one (plane, tap): 64 rows of N columns
  static constexpr int NPL = RESIDENT ? 3 : 4;  // plane slots
  static constexpr int NWS = 6;                 // piece slots when streamed
  // piece slots, mbarriers and shared-memory bytes for nb pieces a tile
  __host__ __device__ static constexpr int slots(int nb) { return RESIDENT ? nb : NWS; }
  __host__ __device__ static constexpr int bars() { return 2 * NPL + (RESIDENT ? 1 : 2 * NWS); }
  __host__ __device__ static constexpr int bytes(int nb) {
    return 1024 + NPL * PLANE + slots(nb) * PIECE + 8 * bars();
  }
};

// whether the 9 ceil(Ci / 64) pieces of K fit resident beside the plane ring
template <int N> __host__ __device__ constexpr bool resident(int Ci) {
  return Tc<N, true>::bytes(9 * ((Ci + 63) / 64)) <= SMEM_MAX;
}

template <int N>
__device__ __forceinline__ void tc_mma(float (&acc)[2][N / 2], const uint32_t (&a)[4][2][4],
                                       const unsigned char* piece) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if constexpr (N == 64)  // 16 rows of 128 bytes a k-step
        sm90::wgmma_m64n64k16(acc[m], a[kk][m], sm90::desc_sw128(piece + kk * 2048, 0, 1024));
      else if constexpr (N == 32)  // 16 rows of 32 bytes a k-step, atoms 2,048 apart
        sm90::wgmma_m64n32k16(acc[m], a[kk][m], sm90::desc_sw32(piece + kk * 512, 2048, 256));
      else
        sm90::wgmma_m64n16k16(acc[m], a[kk][m], sm90::desc_sw32(piece + kk * 512, 0, 256));
    }
  }
  sm90::wgmma_commit();
}

// Grid: min(#SMs, tiles) blocks of TC_THREADS threads, dynamic shared
// memory Tc<N, RESIDENT>::bytes(9 ceil(Ci / 64)). xmap: x as 4-D (Ci, W, H,
// B) with boxes (64, SW, SH, 1), 128-byte swizzle; wmap: K as (Co, 9 Ci)
// with boxes (64, 64), 128-byte swizzle (N = 64) or (16, 64), 32-byte
// swizzle (N = 16, 32). bias (Co,) or null; out (B, H, W, Co).
template <int N, bool RESIDENT>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_tc_kernel(const __grid_constant__ sm90::TensorMap xmap,
               const __grid_constant__ sm90::TensorMap wmap, const bf16* __restrict__ bias,
               bf16* __restrict__ out, int B, int H, int W, int Ci, int Co) {
  using C = Tc<N, RESIDENT>;
  const int np = (Ci + 63) / 64, nb = 9 * np;  // planes and batches (pieces) a tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms want 1024-byte alignment of the shared address
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + C::NPL * PLANE;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + C::slots(nb) * C::PIECE);
  uint64_t* empty = full + C::NPL;
  uint64_t* wfull = empty + C::NPL;   // [NWS] (streamed) or [1] (resident)
  uint64_t* wempty = wfull + C::NWS;  // streamed only
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_x * tiles_y;
  const int mine = ntiles > (int)blockIdx.x ? (ntiles - blockIdx.x - 1) / gridDim.x + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < C::NPL; ++s) {
      sm90::mbar_init(&full[s], 1);  // lane 0's arrival, and the box's bytes
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    if constexpr (RESIDENT) {
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
    // ---- the producer warp. Plane k is the block's k-th (tile k / np,
    // plane k % np), in slot k % NPL.
    auto load_plane = [&](int k) {
      const int s = k % C::NPL, p = k % np;
      const int t = blockIdx.x + (k / np) * gridDim.x, r = t % (tiles_x * tiles_y);
      const int b = t / (tiles_x * tiles_y), y0 = r / tiles_x * TH, x0 = r % tiles_x * TW;
      if (k >= C::NPL) sm90::mbar_wait(&empty[s], (k / C::NPL - 1) & 1);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], PLANE_TX);
        sm90::tma_load_4d(base + s * PLANE, &xmap, 64 * p, x0 - 1, y0 - 1, b, &full[s]);
      }
    };
    // piece (plane p, tap) to dst: one box of 64 columns or N / 16 of 16
    auto load_piece = [&](unsigned char* dst, int p, int tap, uint64_t* bar) {
      const int row = tap * Ci + 64 * p;
      if constexpr (N == 64) {
        sm90::tma_load_2d(dst, &wmap, 0, row, bar);
      } else {
        for (int a = 0; a < N / 16; ++a) sm90::tma_load_2d(dst + a * 2048, &wmap, 16 * a, row, bar);
      }
    };
    if constexpr (RESIDENT) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(wfull, nb * C::PIECE);
        for (int j = 0; j < nb; ++j) load_piece(wsm + j * C::PIECE, j / 9, j % 9, wfull);
      }
    }
    const int nplanes = mine * np;
    if (nplanes > 0) load_plane(0);
    for (int k = 0; k < nplanes; ++k) {
      if (k + 1 < nplanes) load_plane(k + 1);  // one plane ahead of plane k's weights
      if constexpr (!RESIDENT) {
        for (int tap = 0; tap < 9; ++tap) {
          const int j = k * 9 + tap, s = j % C::NWS;  // the block's j-th piece
          if (j >= C::NWS) sm90::mbar_wait(&wempty[s], (j / C::NWS - 1) & 1);
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&wfull[s], C::PIECE);
            load_piece(wsm + s * C::PIECE, k % np, tap, &wfull[s]);
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
  if constexpr (RESIDENT) sm90::mbar_wait(wfull, 0);

  for (int it = 0; it < mine; ++it) {
    const int t = blockIdx.x + it * gridDim.x, r = t % (tiles_x * tiles_y);
    const int b = t / (tiles_x * tiles_y), y0 = r / tiles_x * TH, x0 = r % tiles_x * TW;

    // batch s: plane s / 9 (the block's plane it np + s / 9), tap s % 9
    auto load_a = [&](uint32_t (&a)[4][2][4], int s) {
      const int k = it * np + s / 9, tap = s % 9;
      if (tap == 0) sm90::mbar_wait(&full[k % C::NPL], (k / C::NPL) & 1);
      const unsigned char* plane = base + (k % C::NPL) * PLANE;
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int p = (row_w + 2 * m + dy) * SW + px_w + lane % 16 + dx;
          const int chunk = (2 * kk + lane / 16) ^ (p & 7);  // the 128-byte swizzle
          sm90::ldmatrix_x4(a[kk][m], plane + p * 128 + chunk * 16);
        }
    };
    float acc[2][N / 2];
    auto issue = [&](const uint32_t (&a)[4][2][4], int s) {
      int slot = s;
      if constexpr (!RESIDENT) {
        const int j = it * nb + s;
        slot = j % C::NWS;
        sm90::mbar_wait(&wfull[slot], (j / C::NWS) & 1);
      }
      tc_mma<N>(acc, a, wsm + slot * C::PIECE);
    };
    // batch s's MMAs are done: its piece, and after a plane's last tap the
    // plane, go back to the producer
    auto release = [&](int s) {
      if constexpr (!RESIDENT) sm90::mbar_arrive(&wempty[(it * nb + s) % C::NWS]);
      if (s % 9 == 8) sm90::mbar_arrive(&empty[(it * np + s / 9) % C::NPL]);
    };

#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
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
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
    release(nb - 1);

    // ---- epilogue: rows g and g + 8 of the warp's 16 pixels, per M-tile;
    // columns past Co (Co = 48 at N = 64) are neither biased nor stored
    auto bias_at = [&](int c) { return bias != nullptr && c < Co ? to_f(bias[c]) : 0.f; };
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = y0 + row_w + 2 * m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + px_w + g + 8 * h;
        const bool inside = y < H && x < W;  // every lane takes part in the shuffles
        bf16* o = out + (((size_t)b * H + y) * W + x) * Co;
        if constexpr (N == 16) {
          // columns 8 j + 2 q + e, as 4-byte pairs
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = 8 * j + 2 * q;
            if (inside)
              *reinterpret_cast<uint32_t*>(o + col) =
                  sm90::pack_bf16x2(acc[m][4 * j + 2 * h] + bias_at(col),
                                    acc[m][4 * j + 2 * h + 1] + bias_at(col + 1));
          }
        } else {
#pragma unroll
          for (int jg = 0; jg < N / 32; ++jg) {
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int jj = 4 * jg + j;  // 8-column group: columns 8 jj + 2 q, + 1
              v[j] = sm90::pack_bf16x2(acc[m][4 * jj + 2 * h] + bias_at(8 * jj + 2 * q),
                                       acc[m][4 * jj + 2 * h + 1] + bias_at(8 * jj + 2 * q + 1));
            }
            sm90::quad_transpose(v);  // this lane: columns 32 jg + 8 q .. + 7
            const int col = 32 * jg + 8 * q;
            if (inside && col < Co)
              *reinterpret_cast<uint4*>(o + col) = uint4{v[0], v[1], v[2], v[3]};
          }
        }
      }
    }
  }
}

// ------------------------------------------------ float32: the FMA kernel

constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int FTW = 16;           // tile width: one warp's 16 A rows
constexpr int FTH = NWARP;        // tile rows: one per warp
constexpr int FSW = FTW + 2;      // x slab width (one-pixel halo)
constexpr int FSH = FTH + 2;      // x slab rows
constexpr int NCMAX = 64;         // output columns at most
constexpr int LDC = NCMAX + 4;    // row stride of a warp's float32 epilogue buffer

// slab pixel stride (elements): the pad moves neighbouring pixels to other banks
__host__ __device__ constexpr int slab_ld(int Ci) { return Ci + 4; }

inline size_t f32_smem_bytes(int Ci) {
  return wt::align128(sizeof(float) * FSH * FSW * slab_ld(Ci)) + sizeof(float) * NWARP * 16 * LDC;
}

// Grid (ceil(W/FTW), ceil(H/FTH), B), NTHREADS threads, dynamic shared
// memory f32_smem_bytes(Ci). NF = Co / 16 column tiles. bias may be null.
// Requires Ci % 4 == 0.
template <int NF>
__global__ void __launch_bounds__(NTHREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, int H, int W, int Ci) {
  constexpr int Co = 16 * NF;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = slab_ld(Ci);
  float* slab = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* cbuf = reinterpret_cast<float*>(smem_raw + wt::align128(sizeof(float) * FSH * FSW * ld)) +
                warp * 16 * LDC;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * FTH, x0 = blockIdx.x * FTW;
  const float* xb = x + (size_t)b * H * W * Ci;

  // the slab: x rows y0-1 .. y0+FTH, columns x0-1 .. x0+FTW, zero outside
  constexpr int V = wt::Vec<float>::N;
  const int units = Ci / V;
  for (int e = threadIdx.x; e < FSH * FSW * units; e += NTHREADS) {
    const int p = e / units, u = e % units;
    const int yy = y0 - 1 + p / FSW, xx = x0 - 1 + p % FSW;
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    wt::cp_async16(slab + p * ld + u * V, inside ? xb + ((size_t)yy * W + xx) * Ci + u * V : xb,
                   inside);
  }
  wt::cp_async_commit();
  wt::cp_async_wait<0>();
  __syncthreads();

  // warp w: output row y0 + w, pixels x0 .. x0 + 15 (a row past the image
  // computes on zeros and writes nothing)
  wt::WarpTile<float, NF> acc;
  acc.zero();
  for (int k = 0; k < 9; ++k)
    acc.mma(slab + ((warp + k / 3) * FSW + k % 3) * ld, ld, w + (size_t)k * Ci * Co, Co, Ci);
  acc.store(cbuf, LDC);
  __syncwarp();
  const int oy = y0 + warp;
  for (int e = lane; e < FTW * Co; e += 32) {
    const int px = e / Co, c = e % Co, gx = x0 + px;
    if (oy < H && gx < W)
      out[(((size_t)b * H + oy) * W + gx) * Co + c] = cbuf[px * LDC + c] + (bias ? bias[c] : 0.f);
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

#include "tma_host.cuh"

namespace {

template <int N, bool RESIDENT>
int launch_tc(const CUtensorMap& xm, const CUtensorMap& wm, const void* bias, void* out, int B,
              int H, int W, int Ci, int Co, cudaStream_t s) {
  const int smem = Tc<N, RESIDENT>::bytes(9 * ((Ci + 63) / 64));
  cudaError_t err = cudaFuncSetAttribute(conv_tc_kernel<N, RESIDENT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  conv_tc_kernel<N, RESIDENT><<<(int)(tiles < sms ? tiles : sms), TC_THREADS, smem, s>>>(
      xm, wm, static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, H, W, Ci, Co);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
             int Ci, int Co, cudaStream_t s) {
  const cuuint64_t x_dims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t w_dims[2] = {(cuuint64_t)Co, (cuuint64_t)(9 * Ci)};
  const cuuint32_t x_box[4] = {64, SW, SH, 1};
  const cuuint32_t w_box[2] = {N == 64 ? 64u : 16u, 64};
  CUtensorMap xm, wm;
  if (!sm90::encode_map(&xm, x, 4, x_dims, x_box) ||
      !sm90::encode_map(&wm, w, 2, w_dims, w_box,
                        N == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B))
    return (int)cudaErrorInvalidValue;
  if (resident<N>(Ci)) return launch_tc<N, true>(xm, wm, bias, out, B, H, W, Ci, Co, s);
  return launch_tc<N, false>(xm, wm, bias, out, B, H, W, Ci, Co, s);
}

template <int NF>
int launch_f32(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
               int Ci, cudaStream_t s) {
  const size_t smem = f32_smem_bytes(Ci);
  cudaError_t err = cudaFuncSetAttribute(conv_f32_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + FTW - 1) / FTW, (H + FTH - 1) / FTH, B);
  conv_f32_kernel<NF><<<grid, NTHREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), H, W, Ci);
  return (int)cudaGetLastError();
}

}  // namespace

// out = conv(x, w, SAME) + bias on `stream`; returns the cudaError_t of the
// launch (0 on success). x (B,H,W,Ci), w (3,3,Ci,Co), bias (Co,) or null, out
// (B,H,W,Co), contiguous, one type: bfloat16 (is_bf16 != 0; Ci % 16 == 0;
// x and w 16-byte aligned, which TMA reads) or float32 (Ci % 4 == 0); Co one
// of 16, 32, 48, 64.
extern "C" int packed_conv_launch(const void* x, const void* w, const void* bias, void* out, int B,
                                  int H, int W, int Ci, int Co, int is_bf16, void* stream) {
  const int unit = is_bf16 ? 16 : 4;
  if (B < 1 || H < 1 || W < 1 || Ci < unit || Ci % unit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (Co) {
      case 16: return launch_n<16>(x, w, bias, out, B, H, W, Ci, Co, s);
      case 32: return launch_n<32>(x, w, bias, out, B, H, W, Ci, Co, s);
      case 48:
      case 64: return launch_n<64>(x, w, bias, out, B, H, W, Ci, Co, s);
    }
  } else {
    switch (Co) {
      case 16: return launch_f32<1>(x, w, bias, out, B, H, W, Ci, s);
      case 32: return launch_f32<2>(x, w, bias, out, B, H, W, Ci, s);
      case 48: return launch_f32<3>(x, w, bias, out, B, H, W, Ci, s);
      case 64: return launch_f32<4>(x, w, bias, out, B, H, W, Ci, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
