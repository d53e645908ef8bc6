// Fused stage-2 attention gate and head_at conv for Hopper (sm_90a): the
// CUDA counterpart of the TPU kernel diffusionremotesensing_tpu/ops/
// att_block.py:att_head_block (:155, pallas_call :171; _att_head_kernel
// :107). Per s2d pixel of the level-0 skip x (4C = 128 channels) and the
// stage-1 output h (Ch = 64 channels) it computes, with the BatchNorms
// folded into the weights by ops/att_block.py:build_att_weights,
//
//   g      = relu(h @ gw + gb)                     (gating signal 2, 64 -> 32)
//   a      = relu(g @ wg + bg + x @ wx + bx)       (w_g and w_x, -> 32)
//   psi    = sigmoid(a @ wpsi + bpsi)              (one channel)
//   gated  = x * psi
//   attn_s = gated @ rc + brc                      (block-diagonal result conv)
//   out    = conv3x3_SAME(attn_s, head_at)         (-> out4 channels)
//
// out4 = 4 out_dim is a template parameter, OUT4: 12 for the x2 and
// class-conditional models (3 output channels), 4 for SAR->NDVI (1). The
// head computes NPAD = 16 columns either way (the weight is zero-padded);
// only the columns written change.
//
// Products accumulate in float32; g, a, psi, gated, attn_s and out are
// rounded to the compute type where the reference kernel rounds them. The
// TPU kernel held one batch item in VMEM and packed 8 output rows into the
// lanes of the 12-channel head (a TPU lane device not carried over: the
// head's contribution is written unpacked, (B, H, W, out4)).
//
// What bounds it. At the main path's shape (B=48, 64x64 s2d pixels) the
// function reads x and h and writes out once: 80.2 MB in bfloat16, 24 us at
// 3.35 TB/s; its products, the model's layers at their own resolution
// (the s2d forms' structural zeros not counted), are 5.8 GFLOP, 6 us at
// the 989 TFLOP/s bf16 tensor rate. So in bf16 it is bound by bytes.
//
// The bfloat16 kernels (the served type). The first design (a block per
// 16 x 16 tile computing attn_s on the tile and its halo in 128-pixel
// passes of WMMA warp tiles through a float32 staging buffer, eleven block
// barriers a pass, every B fragment read from device memory, rc multiplied
// as a dense 128 x 128) took 0.687 ms at B=48 on an H100 80GB HBM3 at
// 700 W, 1.16x cuDNN's unfused ops. This one is two launches of persistent,
// warp-specialised wgmma kernels with attn_s as the seam (the wrapper's
// scratch tensor, (B, H, W, 128)):
//
//   att_gate_kernel  attn_s over 64-pixel M-tiles of the flattened pixels
//   att_head_kernel  out = conv3x3(attn_s, head_at) over 8 x 32 tiles, N = 16
//
// 1. att_gate_kernel. A grid of at most one block an SM walks the M-tiles
//    (3,072 at B=48). A block is two consumer warpgroups, each taking every
//    other M-tile of the block, and a producer warp whose lane 0 issues
//    every copy by TMA behind mbarriers: the weights once (gw, wg, wx and
//    rc's four diagonal 32 x 32 blocks, 22,528 bytes, resident for the
//    block's life), then each M-tile's x (two boxes of 64 pixels x 64
//    channels) and h (one box) into a ring of 6 slots, 3 a warpgroup, each
//    with a "full" and an "empty" barrier. Pixels past B*H*W land as zeros
//    and are not written.
// 2. The products are wgmma.m64n32k16 (N = 32, B in the 32-byte swizzle as
//    two 16-column atoms). g = h @ gw takes A from the h box by ldmatrix;
//    g's accumulators, after bias, relu and rounding, are packed to bf16 in
//    place as the register-A fragments of g @ wg (a 64 x 32 accumulator
//    of the wgmma D layout is, two columns a register, the A layout of two
//    k-steps: the FlashAttention-3 trick for P.V); x's eight k-steps come by
//    ldmatrix and stay in registers. The slot goes back to the producer once
//    the MMA that reads x's registers is done.
// 3. psi from the registers: a's accumulators (rounded to bf16) dotted with
//    wpsi, a partial sum a lane over its 8 columns of each of its two rows,
//    then two shfl_xor within the quad. gated = round(x * round(psi)) is
//    formed in x's A fragments, and rc is multiplied as its four diagonal
//    32 x 32 blocks (k-steps 2t, 2t + 1 against block t): 4,096 MACs a pixel
//    where the dense 128 x 128 issued 16,384. attn_s leaves by 16-byte
//    stores after bias, rounding and sm90::quad_transpose.
// 4. att_head_kernel is dec_block.cu's HEAD mode at 3 x 3: a grid of at most
//    one block an SM walks 8 x 32 output tiles; the producer warp lands each
//    tile's attn_s slab (the tile and its one-pixel halo, 10 x 34 pixels,
//    zero outside the image: the SAME padding) as two 64-channel planes in a
//    ring of 3 slots, and head_at (atk, 9 x 128 x 16, 36,864 bytes, 32-byte
//    swizzle) once. Each of the two consumer warpgroups owns two 64-pixel
//    M-tiles of the tile; a batch is one (plane, tap): 4 k-steps of A read by
//    ldmatrix at the tap's shift in the 128-byte-swizzled slab, times 2
//    M-tiles, wgmma.m64n16k16, two register sets for A. The 12 real columns
//    are stored as 4-byte pairs.
//
// The seam. A fused kernel that keeps attn_s in shared memory must compute
// it on each tile's halo as well: (16 + 2)^2 / 16^2 = 1.27x the gate's
// products at a 16 x 16 tile, in a slab of 83 KB beside the weights. Through
// device memory attn_s costs 50,331,648 bytes written and read, 30 us at
// 3.35 TB/s, and the gate kernel needs no halo. chip_smoke.py's seam probe
// times att_gate_kernel at B=61 (1.27x the pixels) beside B=48: 0.0583
// against 0.0465 ms on an H100 80GB HBM3 at 700 W, so the halo would cost
// ~0.012 ms where attn_s's bytes cost at most 0.030. A fused kernel could
// save up to ~0.02 ms of the ~0.096 the two launches take (0.047 + 0.044);
// the two launches are kept here for their simplicity (the fused kernel is
// the next step for this function, in PERF.md).
//
// Issued products at B=48: the gate kernel 11,264 MACs a pixel (h @ gw
// 2,048, g @ wg 1,024, x @ wx 4,096, rc's four blocks 4,096), 4.43 GFLOP;
// the head 9 x 128 x 16 = 18,432 (16 columns for 12), 7.25 GFLOP.
//
// Shared memory (bytes; 1024 for the alignment of the swizzle atoms):
//   gate 1024 + 6 slots x 24,576 + 22,528 weights + 13 mbarriers x 8 = 171,112
//   head 1024 + 3 planes x 44,032 (10 x 34 x 128 rounded to 1024)
//        + 36,864 head_at + 7 mbarriers x 8 = 170,040
// of the 232,448 a block may have (GATE_BYTES, HEAD_BYTES).
//
// float32 (the golden and model phases' type, not the served one) keeps
// the first design: att_f32_kernel, a block per 8 x 8 tile computing
// attn_s on the tile and its halo ((8 + 2)^2 pixels, 56% more gate work)
// in 128-pixel passes of warp_tile.cuh's FMA tiles, then the head from the
// slab.

#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using wt::bf16;
using wt::to_f;

constexpr int C4 = 128;     // x channels (4 taps x 32)
constexpr int C = 32;       // gate width
constexpr int CH = 64;      // h channels
constexpr int NPAD = 16;    // head columns computed (the weight is zero-padded to 16)

__host__ __device__ constexpr int round1024(int b) { return (b + 1023) / 1024 * 1024; }

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

// ------------------------------------------------ bfloat16: wgmma kernels

// ---- att_gate_kernel: attn_s on 64-pixel M-tiles
constexpr int MT = 64;                          // pixels an item
constexpr int GATE_CONSUMERS = 256;             // two warpgroups, an item each
constexpr int GATE_THREADS = GATE_CONSUMERS + 32;  // and the producer warp
constexpr int GATE_NS = 6;                      // input slots, 3 a warpgroup (even)
constexpr int BOX = MT * 128;                   // 64 pixels x 64 channels: 8,192
constexpr int SLOT = 3 * BOX;                   // x (two boxes), then h
// the resident weights, 32-byte swizzle, two 16-column atoms each; rc as its
// four diagonal 32 x 32 blocks
constexpr int W_GW = 0;                         // 64 rows: atoms 2,048 apart
constexpr int W_WG = W_GW + 2 * 64 * 32;        // 32 rows: 1,024 apart
constexpr int W_WX = W_WG + 2 * 32 * 32;        // 128 rows: 4,096 apart
constexpr int W_RC = W_WX + 2 * 128 * 32;       // block t at 2,048 t, atoms 1,024 apart
constexpr int W_BYTES = W_RC + 4 * 2 * 32 * 32;  // 22,528
constexpr int GATE_BARS = 2 * GATE_NS + 1;
constexpr int GATE_BYTES = 1024 + GATE_NS * SLOT + W_BYTES + 8 * GATE_BARS;
static_assert(GATE_NS % 2 == 0, "slot s belongs to warpgroup s % 2");

// Grid: min(#SMs, M-tiles) blocks of GATE_THREADS threads, dynamic shared
// memory GATE_BYTES. xmap, hmap: x (npix, 128) and h (npix, 64) as 2-D
// tensors with boxes (64, 64); gwmap, wgmap, wxmap: gw (64, 32), wg (32, 32),
// wx (128, 32) with boxes (16, rows), 32-byte swizzle; rcmap: rc (128, 128)
// with boxes (16, 32), 32-byte swizzle. Biases bf16; attn (npix, 128).
__global__ void __launch_bounds__(GATE_THREADS, 1)
att_gate_kernel(const __grid_constant__ sm90::TensorMap xmap,
                const __grid_constant__ sm90::TensorMap hmap,
                const __grid_constant__ sm90::TensorMap gwmap,
                const __grid_constant__ sm90::TensorMap wgmap,
                const __grid_constant__ sm90::TensorMap wxmap,
                const __grid_constant__ sm90::TensorMap rcmap, const bf16* __restrict__ gb,
                const bf16* __restrict__ bg, const bf16* __restrict__ bx,
                const bf16* __restrict__ wpsi, const bf16* __restrict__ bpsi,
                const bf16* __restrict__ brc, bf16* __restrict__ attn, int npix) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + GATE_NS * SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + W_BYTES);
  uint64_t* empty = full + GATE_NS;
  uint64_t* wfull = empty + GATE_NS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nitems = (npix + MT - 1) / MT;
  const int mine = nitems > (int)blockIdx.x ? (nitems - blockIdx.x - 1) / gridDim.x + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < GATE_NS; ++s) {
      sm90::mbar_init(&full[s], 1);  // the producer's arrival, and the boxes' bytes
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_init(wfull, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();  // the mbarriers are initialised

  if (warp == GATE_CONSUMERS / 32) {
    // ---- the producer: lane 0 issues the weights, then the block's k-th
    // M-tile into slot k % GATE_NS
    if (lane != 0) return;
    sm90::mbar_arrive_expect_tx(wfull, W_BYTES);
    for (int a = 0; a < 2; ++a) {
      sm90::tma_load_2d(wsm + W_GW + a * 2048, &gwmap, 16 * a, 0, wfull);
      sm90::tma_load_2d(wsm + W_WG + a * 1024, &wgmap, 16 * a, 0, wfull);
      sm90::tma_load_2d(wsm + W_WX + a * 4096, &wxmap, 16 * a, 0, wfull);
      for (int t = 0; t < 4; ++t)
        sm90::tma_load_2d(wsm + W_RC + t * 2048 + a * 1024, &rcmap, 32 * t + 16 * a, 32 * t,
                          wfull);
    }
    for (int k = 0; k < mine; ++k) {
      const int s = k % GATE_NS, p0 = (blockIdx.x + k * gridDim.x) * MT;
      if (k >= GATE_NS) sm90::mbar_wait(&empty[s], (k / GATE_NS - 1) & 1);
      unsigned char* slot = base + s * SLOT;
      sm90::mbar_arrive_expect_tx(&full[s], SLOT);
      sm90::tma_load_2d(slot, &xmap, 0, p0, &full[s]);
      sm90::tma_load_2d(slot + BOX, &xmap, 64, p0, &full[s]);
      sm90::tma_load_2d(slot + 2 * BOX, &hmap, 0, p0, &full[s]);
    }
    return;
  }

  // ---- the consumers: warpgroup wg takes the block's M-tiles wg, wg + 2,
  // ...; warp w holds rows 16 w .. 16 w + 15 of the M-tile, and ldmatrix lane
  // l addresses row r = 16 w + l % 16 at channel 8 (l / 16) of a k-step
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int r = 16 * w + lane % 16;
  // A of k-step kk (16 channels) of a 64-channel box: row r's 16-byte chunk
  // 2 (kk % 4) + l / 16, at its place in the 128-byte swizzle
  auto lda = [&](uint32_t (&a)[4], const unsigned char* box, int kk) {
    sm90::ldmatrix_x4(a, box + r * 128 + (((2 * (kk % 4) + lane / 16) ^ (r & 7)) << 4));
  };
  // the B descriptor of k-step kk of a 32-column weight at `w0` whose two
  // atoms lie `lbo` bytes apart (16 rows of 32 bytes a k-step)
  auto wdesc = [&](int w0, int kk, int lbo) {
    return sm90::desc_sw32(wsm + w0 + kk * 512, lbo, 256);
  };
  sm90::mbar_wait(wfull, 0);

  for (int k = wg; k < mine; k += 2) {
    const int s = k % GATE_NS, p0 = (blockIdx.x + k * gridDim.x) * MT;
    sm90::mbar_wait(&full[s], (k / GATE_NS) & 1);
    const unsigned char* xs = base + s * SLOT;
    const unsigned char* hs = xs + 2 * BOX;

    // g = relu(h @ gw + gb), rounded, as the A fragments of g @ wg
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    sm90::fence_operand(acc);
    {
      uint32_t ha[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) lda(ha[kk], hs, kk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_m64n32k16(acc, ha[kk], wdesc(W_GW, kk, 2048));
      sm90::wgmma_commit();
    }
    // x's eight k-steps, loaded while g @ gw runs
    uint32_t xa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) lda(xa[kk], xs + (kk / 4) * BOX, kk);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    // accumulator columns 8 j + 2 q + e of rows g (h = 0) and g + 8 (h = 1):
    // register a[h + 2 jj] of k-step kk holds columns 16 kk + 8 jj + 2 q, + 1
    uint32_t ga[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * q;
      const float b0 = to_f(gb[col]), b1 = to_f(gb[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ga[j / 2][h + 2 * (j % 2)] = sm90::pack_bf16x2(fmaxf(acc[4 * j + 2 * h] + b0, 0.f),
                                                       fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f));
    }

    // a = relu(g @ wg + x @ wx + bg + bx)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    sm90::fence_operand(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) sm90::wgmma_m64n32k16(acc, ga[kk], wdesc(W_WG, kk, 1024));
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) sm90::wgmma_m64n32k16(acc, xa[kk], wdesc(W_WX, kk, 4096));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    // the slot goes back only now, once an MMA has consumed the registers
    // its ldmatrix reads filled: released right after those reads were
    // issued, the producer's next TMA write into the slot could land before
    // a read had returned, and a rare call computed a pixel of attn_s from
    // the next item's x or h
    sm90::mbar_arrive(&empty[s]);

    // psi = round(sigmoid(round(a) @ wpsi + bpsi)) for rows g and g + 8: a
    // lane's 8 columns, then the quad's sum
    float psi[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * q + e;
        const float bias = to_f(bg[col]) + to_f(bx[col]), wp = to_f(wpsi[col]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          psi[h] = fmaf(round_bf16(fmaxf(acc[4 * j + 2 * h + e] + bias, 0.f)), wp, psi[h]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psi[h] += sm90::shfl_xor(psi[h], 1);
      psi[h] += sm90::shfl_xor(psi[h], 2);
      psi[h] = round_bf16(1.f / (1.f + expf(-(psi[h] + to_f(bpsi[0])))));
    }

    // gated = round(x * psi) in x's fragments (registers 0, 2: row g; 1, 3:
    // row g + 8); attn_s = gated @ rc + brc, block t from k-steps 2t, 2t + 1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t v = xa[kk][i];  // two bf16, the lower column in the low half
        xa[kk][i] = sm90::pack_bf16x2(__uint_as_float(v << 16) * psi[i % 2],
                                      __uint_as_float(v & 0xffff0000u) * psi[i % 2]);
      }
    float att[4][16];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int i = 0; i < 16; ++i) att[t][i] = 0.f;
      sm90::fence_operand(att[t]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
        sm90::wgmma_m64n32k16(att[t], xa[2 * t + kb], wdesc(W_RC + t * 2048, kb, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 4; ++t) sm90::fence_operand(att[t]);

    // ---- epilogue: columns 32 t + 8 j + 2 q (+ 1), rounded; after the quad
    // transpose this lane stores columns 32 t + 8 q .. + 7 of its two rows
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * t + 8 * j + 2 * q;
          v[j] = sm90::pack_bf16x2(att[t][4 * j + 2 * h] + to_f(brc[col]),
                                   att[t][4 * j + 2 * h + 1] + to_f(brc[col + 1]));
        }
        sm90::quad_transpose(v);
        const int p = p0 + 16 * w + g + 8 * h;
        if (p < npix)  // every lane took part in the shuffles
          *reinterpret_cast<uint4*>(attn + (size_t)p * C4 + 32 * t + 8 * q) =
              uint4{v[0], v[1], v[2], v[3]};
      }
  }
}

// ---- att_head_kernel: out = conv3x3(attn_s, head_at)
constexpr int TH = 8, TW = 32;                     // output tile
constexpr int SH = TH + 2, SW = TW + 2;            // slab: the tile and its halo
constexpr int HEAD_CONSUMERS = 256;                // two warpgroups, 128 pixels each
constexpr int HEAD_THREADS = HEAD_CONSUMERS + 32;  // and the producer warp
constexpr int PLANE_TX = SH * SW * 128;            // bytes a plane's box lands
constexpr int PLANE = round1024(PLANE_TX);
constexpr int NPL = 3;                             // plane slots
constexpr int NB = 2 * 9;                          // batches a tile: (plane, tap)
constexpr int PIECE = 64 * NPAD * 2;               // 64 rows of atk: 2,048
constexpr int HEAD_BARS = 2 * NPL + 1;
constexpr int HEAD_BYTES = 1024 + NPL * PLANE + NB * PIECE + 8 * HEAD_BARS;

// Grid: min(#SMs, tiles) blocks of HEAD_THREADS threads, dynamic shared
// memory HEAD_BYTES. amap: attn_s (B, H, W, 128) as 4-D (128, W, H, B) with
// boxes (64, SW, SH, 1); kmap: atk (9 * 128 rows, 16) with boxes (16, 64),
// 32-byte swizzle. out (B, H, W, OUT4): OUT4 of the 16 columns, as 4-byte
// pairs (at OUT4 = 4 a pixel's row is 8 bytes).
template <int OUT4 = 12>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
att_head_kernel(const __grid_constant__ sm90::TensorMap amap,
                const __grid_constant__ sm90::TensorMap kmap, bf16* __restrict__ out, int B,
                int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + NPL * PLANE;  // piece j: atk rows 64 j .. (tap j / 2, plane j % 2)
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + NB * PIECE);
  uint64_t* empty = full + NPL;
  uint64_t* wfull = empty + NPL;
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

  if (tid == 0) {
    for (int s = 0; s < NPL; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], HEAD_CONSUMERS);
    }
    sm90::mbar_init(wfull, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == HEAD_CONSUMERS / 32) {
    // ---- the producer: atk once, then plane k (tile k / 2, plane k % 2)
    // into slot k % NPL
    if (lane != 0) return;
    sm90::mbar_arrive_expect_tx(wfull, NB * PIECE);
    for (int j = 0; j < NB; ++j) sm90::tma_load_2d(wsm + j * PIECE, &kmap, 0, 64 * j, wfull);
    for (int k = 0; k < 2 * mine; ++k) {
      const int s = k % NPL;
      int b, y0, x0;
      tile_of(k / 2, b, y0, x0);
      if (k >= NPL) sm90::mbar_wait(&empty[s], (k / NPL - 1) & 1);
      sm90::mbar_arrive_expect_tx(&full[s], PLANE_TX);
      sm90::tma_load_4d(base + s * PLANE, &amap, 64 * (k % 2), x0 - 1, y0 - 1, b, &full[s]);
    }
    return;
  }

  // ---- the consumers. Warp w of warpgroup wg computes, in M-tile m, tile
  // row 4 wg + 2 m + w / 2, pixels 16 (w % 2) .. + 15; ldmatrix lane l
  // addresses pixel 16 (w % 2) + l % 16 at channel 8 (l / 16) of a k-step.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int row_w = 4 * wg + w / 2, px_w = 16 * (w % 2);
  sm90::mbar_wait(wfull, 0);

  for (int it = 0; it < mine; ++it) {
    int b, y0, x0;
    tile_of(it, b, y0, x0);
    // batch s: plane s / 9 (the block's plane 2 it + s / 9), tap s % 9
    auto load_a = [&](uint32_t (&a)[4][2][4], int s) {
      const int k = 2 * it + s / 9, tap = s % 9;
      if (tap == 0) sm90::mbar_wait(&full[k % NPL], (k / NPL) & 1);
      const unsigned char* plane = base + (k % NPL) * PLANE;
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
    float acc[2][8];
    auto issue = [&](const uint32_t (&a)[4][2][4], int s) {
      const unsigned char* piece = wsm + (2 * (s % 9) + s / 9) * PIECE;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          sm90::wgmma_m64n16k16(acc[m], a[kk][m], sm90::desc_sw32(piece + kk * 512, 0, 256));
      sm90::wgmma_commit();
    };
    // batch s's MMAs are done: after a plane's last tap the plane goes back
    auto release = [&](int s) {
      if (s % 9 == 8) sm90::mbar_arrive(&empty[(2 * it + s / 9) % NPL]);
    };

#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[m][i] = 0.f;
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
    uint32_t a0[4][2][4], a1[4][2][4];
    load_a(a0, 0);
    for (int s = 0; s < NB; s += 2) {  // NB is even
      issue(a0, s);
      sm90::wgmma_wait<1>();  // batch s - 1 is done: a1 is free
      if (s > 0) release(s - 1);
      load_a(a1, s + 1);
      issue(a1, s + 1);
      sm90::wgmma_wait<1>();  // batch s is done: a0 is free
      release(s);
      if (s + 2 < NB) load_a(a0, s + 2);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
    release(NB - 1);

    // ---- epilogue: rows g and g + 8 of the warp's 16 pixels, per M-tile;
    // columns 8 j + 2 q + e, the OUT4 real ones as 4-byte pairs
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = y0 + row_w + 2 * m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + px_w + g + 8 * h;
        if (y >= H || x >= W) continue;
        const size_t pix = ((size_t)b * H + y) * W + x;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (8 * j + 2 * q < OUT4)
            *reinterpret_cast<uint32_t*>(out + pix * OUT4 + 8 * j + 2 * q) =
                sm90::pack_bf16x2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------ float32: FMA kernel

constexpr int NTHREADS = 256;
constexpr int MP = 128;     // pixels per pass: 8 warps x 16 rows
constexpr int TILE = 8;     // output tile edge
// row strides (elements) of the shared-memory buffers
constexpr int LDX = C4 + 8;
constexpr int LDH = CH + 8;
constexpr int LDG = C + 8;
constexpr int LDC = 64 + 4;  // accumulator rows: up to 64 columns a product

struct Smem {
  static constexpr int S = TILE + 2;        // attn_s slab edge
  static constexpr int NS = S * S;
  static constexpr size_t ats = 0;                                            // [NS][LDX]  attn_s
  static constexpr size_t xs = wt::align128(ats + sizeof(float) * NS * LDX);  // [MP][LDX]  x, gated, head im2col
  static constexpr size_t hs = wt::align128(xs + sizeof(float) * MP * LDX);   // [MP][LDH]  h
  static constexpr size_t gs = wt::align128(hs + sizeof(float) * MP * LDH);   // [MP][LDG]  g, then a
  static constexpr size_t cs = wt::align128(gs + sizeof(float) * MP * LDG);   // [MP][LDC]  accumulators
  static constexpr size_t ps = wt::align128(cs + sizeof(float) * MP * LDC);   // [MP] psi
  static constexpr size_t bytes = wt::align128(ps + sizeof(float) * MP);
};

// Copy `cols` channels of pixel (b, y, x) of a (B, H, W, cols) tensor to
// row r of dst, in 16-byte pieces; zero when the pixel is outside the image
// or past the slab. Piece e of the row is handled by thread e mod NTHREADS.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ src,
                                           int cols, int b, int H, int W, int p0, int np, int S,
                                           int oy, int ox) {
  constexpr int V = wt::Vec<float>::N;
  const int units = cols / V;
  for (int e = threadIdx.x; e < MP * units; e += NTHREADS) {
    const int r = e / units, u = e % units, q = p0 + r;
    const int y = oy + q / S, x = ox + q % S;
    uint4 v = {0u, 0u, 0u, 0u};
    if (q < np && y >= 0 && y < H && x >= 0 && x < W)
      v = *reinterpret_cast<const uint4*>(src + (((size_t)b * H + y) * W + x) * cols + u * V);
    *reinterpret_cast<uint4*>(dst + r * ld + u * V) = v;
  }
}

// Grid (ceil(W/TILE), ceil(H/TILE), B), NTHREADS threads, dynamic shared
// memory Smem::bytes. out (B, H, W, OUT4).
template <int OUT4 = 12>
__global__ void __launch_bounds__(NTHREADS, 1)
att_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
               const float* __restrict__ gw, const float* __restrict__ gb,
               const float* __restrict__ wg, const float* __restrict__ bg,
               const float* __restrict__ wx, const float* __restrict__ bx,
               const float* __restrict__ wpsi, const float* __restrict__ bpsi,
               const float* __restrict__ rc, const float* __restrict__ brc,
               const float* __restrict__ atk, float* __restrict__ out, int H, int W) {
  using L = Smem;
  constexpr int S = L::S, NS = L::NS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ats = reinterpret_cast<float*>(smem_raw + L::ats);
  float* xs = reinterpret_cast<float*>(smem_raw + L::xs);
  float* hs = reinterpret_cast<float*>(smem_raw + L::hs);
  float* gs = reinterpret_cast<float*>(smem_raw + L::gs);
  float* cs = reinterpret_cast<float*>(smem_raw + L::cs);
  float* ps = reinterpret_cast<float*>(smem_raw + L::ps);

  const int warp = threadIdx.x / 32;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int wrow = 16 * warp;  // the warp's first row of a pass

  // ---- phase A: attn_s on the slab (image origin (y0 - 1, x0 - 1))
  for (int p0 = 0; p0 < NS; p0 += MP) {
    stage_rows(xs, LDX, x, C4, b, H, W, p0, NS, S, y0 - 1, x0 - 1);
    stage_rows(hs, LDH, h, CH, b, H, W, p0, NS, S, y0 - 1, x0 - 1);
    __syncthreads();
    {  // g = relu(h @ gw + gb)
      wt::WarpTile<float, 2> t;
      t.zero();
      t.mma(hs + wrow * LDH, LDH, gw, C, CH);
      t.store(cs + wrow * LDC, LDC);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MP * C; e += NTHREADS) {
      const int r = e / C, c = e % C;
      gs[r * LDG + c] = fmaxf(cs[r * LDC + c] + gb[c], 0.f);
    }
    __syncthreads();
    {  // a = relu(g @ wg + x @ wx + bg + bx)
      wt::WarpTile<float, 2> t;
      t.zero();
      t.mma(gs + wrow * LDG, LDG, wg, C, C);
      t.mma(xs + wrow * LDX, LDX, wx, C, C4);
      t.store(cs + wrow * LDC, LDC);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MP * C; e += NTHREADS) {
      const int r = e / C, c = e % C;
      gs[r * LDG + c] = fmaxf(cs[r * LDC + c] + bg[c] + bx[c], 0.f);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < MP; r += NTHREADS) {  // psi = sigmoid(a @ wpsi + bpsi)
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < C; ++c) s = fmaf(gs[r * LDG + c], wpsi[c], s);
      ps[r] = 1.f / (1.f + expf(-(s + bpsi[0])));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MP * C4; e += NTHREADS) {  // gated = x * psi, in place
      const int r = e / C4, c = e % C4;
      xs[r * LDX + c] *= ps[r];
    }
    __syncthreads();
    for (int n0 = 0; n0 < C4; n0 += 64) {  // attn_s = gated @ rc + brc, 64 columns at a time
      {
        wt::WarpTile<float, 4> t;
        t.zero();
        t.mma(xs + wrow * LDX, LDX, rc + n0, C4, C4);
        t.store(cs + wrow * LDC, LDC);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < MP * 64; e += NTHREADS) {
        const int r = e / 64, c = e % 64, q = p0 + r;
        if (q >= NS) continue;
        const int y = y0 - 1 + q / S, xx = x0 - 1 + q % S;
        const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
        ats[q * LDX + n0 + c] = inside ? cs[r * LDC + c] + brc[n0 + c] : 0.f;
      }
      __syncthreads();
    }
  }

  // ---- phase B: out = conv3x3(attn_s, head_at) on the tile, one tap at a
  // time: the tap's shifted attn_s rows are staged into xs
  constexpr int V = wt::Vec<float>::N;
  for (int p0 = 0; p0 < TILE * TILE; p0 += MP) {
    wt::WarpTile<float, 1> t;
    t.zero();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int e = threadIdx.x; e < MP * (C4 / V); e += NTHREADS) {
        const int r = e / (C4 / V), u = e % (C4 / V), q = p0 + r;
        uint4 v = {0u, 0u, 0u, 0u};
        if (q < TILE * TILE)
          v = *reinterpret_cast<const uint4*>(
              ats + ((q / TILE + dy) * S + q % TILE + dx) * LDX + u * V);
        *reinterpret_cast<uint4*>(xs + r * LDX + u * V) = v;
      }
      __syncthreads();
      t.mma(xs + wrow * LDX, LDX, atk + (size_t)tap * C4 * NPAD, NPAD, C4);
      __syncthreads();
    }
    t.store(cs + wrow * LDC, LDC);
    __syncthreads();
    for (int e = threadIdx.x; e < MP * OUT4; e += NTHREADS) {
      const int r = e / OUT4, c = e % OUT4, q = p0 + r;
      const int y = y0 + q / TILE, xx = x0 + q % TILE;
      if (q < TILE * TILE && y < H && xx < W)
        out[(((size_t)b * H + y) * W + xx) * OUT4 + c] = cs[r * LDC + c];
    }
    __syncthreads();
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

#include "tma_host.cuh"

namespace {

template <int OUT4>
int launch_bf16(const void* const* p, void* out, void* attn, int B, int H, int W,
                cudaStream_t s) {
  const cuuint64_t npix = (cuuint64_t)B * H * W;
  const cuuint64_t x_dims[2] = {C4, npix}, h_dims[2] = {CH, npix};
  const cuuint64_t gw_dims[2] = {C, CH}, wg_dims[2] = {C, C}, wx_dims[2] = {C, C4};
  const cuuint64_t rc_dims[2] = {C4, C4}, at_dims[4] = {C4, (cuuint64_t)W, (cuuint64_t)H,
                                                        (cuuint64_t)B};
  const cuuint64_t k_dims[2] = {NPAD, 9 * C4};
  const cuuint32_t pbox[2] = {64, MT}, gwbox[2] = {16, CH}, wgbox[2] = {16, C};
  const cuuint32_t wxbox[2] = {16, C4}, rcbox[2] = {16, 32}, abox[4] = {64, SW, SH, 1};
  const cuuint32_t kbox[2] = {NPAD, 64};
  constexpr CUtensorMapSwizzle sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap xm, hm, gwm, wgm, wxm, rcm, am, km;
  if (!sm90::encode_map(&xm, p[0], 2, x_dims, pbox) ||
      !sm90::encode_map(&hm, p[1], 2, h_dims, pbox) ||
      !sm90::encode_map(&gwm, p[2], 2, gw_dims, gwbox, sw32) ||
      !sm90::encode_map(&wgm, p[4], 2, wg_dims, wgbox, sw32) ||
      !sm90::encode_map(&wxm, p[6], 2, wx_dims, wxbox, sw32) ||
      !sm90::encode_map(&rcm, p[10], 2, rc_dims, rcbox, sw32) ||
      !sm90::encode_map(&am, attn, 4, at_dims, abox) ||
      !sm90::encode_map(&km, p[12], 2, k_dims, kbox, sw32))
    return (int)cudaErrorInvalidValue;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long items = (long)((npix + MT - 1) / MT);
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  auto a = [&](int i) { return static_cast<const bf16*>(p[i]); };
  cudaError_t err = cudaFuncSetAttribute(att_gate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GATE_BYTES);
  if (err != cudaSuccess) return (int)err;
  att_gate_kernel<<<(int)(items < sms ? items : sms), GATE_THREADS, GATE_BYTES, s>>>(
      xm, hm, gwm, wgm, wxm, rcm, a(3), a(5), a(7), a(8), a(9), a(11), static_cast<bf16*>(attn),
      (int)npix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(att_head_kernel<OUT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             HEAD_BYTES);
  if (err != cudaSuccess) return (int)err;
  att_head_kernel<OUT4><<<(int)(tiles < sms ? tiles : sms), HEAD_THREADS, HEAD_BYTES, s>>>(
      am, km, static_cast<bf16*>(out), B, H, W);
  return (int)cudaGetLastError();
}

template <int OUT4>
int launch_f32(const void* const* p, void* out, int B, int H, int W, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(att_f32_kernel<OUT4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  auto a = [&](int i) { return static_cast<const float*>(p[i]); };
  att_f32_kernel<OUT4><<<grid, NTHREADS, Smem::bytes, s>>>(
      a(0), a(1), a(2), a(3), a(4), a(5), a(6), a(7), a(8), a(9), a(10), a(11), a(12),
      static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the first cudaError_t (0 on success). ptrs,
// all contiguous and of one type (bfloat16 if is_bf16, else float32; in
// bfloat16 each 16-byte aligned for TMA): x (B,H,W,128), h (B,H,W,64),
// gw (64,32), gb (32), wg (32,32), bg (32), wx (128,32), bx (32), wpsi (32),
// bpsi (1), rc (128,128) block-diagonal (bfloat16 reads its four diagonal
// 32 x 32 blocks), brc (128), atk (9*128, 16) the head_at kernel with its
// out4 columns zero-padded to 16. out: (B,H,W,out4), out4 12 or 4; attn:
// the scratch attn_s (B,H,W,128) that bfloat16's two launches pass between
// them (unused in float32).
extern "C" int att_head_block_launch(const void* const* ptrs, void* out, void* attn, int B, int H,
                                     int W, int out4, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out4 == 12)
    return is_bf16 ? launch_bf16<12>(ptrs, out, attn, B, H, W, s)
                   : launch_f32<12>(ptrs, out, B, H, W, s);
  if (out4 == 4)
    return is_bf16 ? launch_bf16<4>(ptrs, out, attn, B, H, W, s)
                   : launch_f32<4>(ptrs, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
