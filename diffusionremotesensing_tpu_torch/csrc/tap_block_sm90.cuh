// The bfloat16 s2d ResConvBlock for Hopper (sm_90a), shared by tap_block.cu
// (levels 0 and 1) and tap_stem_block.cu (level 0 behind the stem's conv0):
// one warp-specialised wgmma kernel, tap_tc_kernel<PHASE, LEVEL>, launched
// twice a block with h as the seam,
//
//   PHASE_A  h   = round(relu(X1 @ W_c1 + b1) [+ X1 @ W_sk] + b_sk + te4)
//   PHASE_B  out = round(relu(im2col4x4(h) @ W2 + x_c @ W_sh + b2 + b_sh))
//
// X1 = im2col4x4(x) (16 pieces of ops/tap_conv.py:_ORDER, each the s2d input
// shifted by (row - 1, col - 1) pixels and restricted to one tap block), x_c
// the unshifted x at the output pixel and W_sh the 4Ci x 4Co block-diagonal
// shortcut: the centre rows of W1's shortcut columns (ops/tap_block.py:
// build_block_weights; its other 12 row blocks are zero and never read).
// LEVEL 0 is the block with its skip conv (Ci = 16, Co = 32), LEVEL 1 the one
// without (Ci = 32, Co = 64). The source notes of tap_block.cu and
// tap_stem_block.cu give the design's reasons and numbers; this header holds
// its mechanics:
//
// * A persistent grid of at most one block an SM walks the items: an output
//   tile of TC_TH x TC_TW = 8 x 32 pixels and one N-block of its columns
//   (below). A block is two consumer warpgroups and a producer warpgroup, of
//   which one warp issues the copies; warp w of consumer warpgroup wg
//   computes, in M-tile m, tile row 4 wg + 2 m + w / 2, pixels 16 (w % 2)
//   .. + 15. The producer warpgroup drops to 40 registers
//   a thread and the consumers rise to 232 (setmaxnreg): at 168, the most a
//   block of 288 or 384 threads gets at launch, the 128 accumulators, two
//   A register sets and the addressing spilled 112-140 bytes a thread.
// * The input is read in planes of 64 channels: the TMA box of the tile and
//   its one-pixel halo (10 x 34 pixels, 128-byte rows, 128-byte swizzle),
//   whose pixels outside the image land as zeros (the convolutions' SAME
//   padding). A plane holds 16 k-steps of the product: the k-step i of a
//   piece reads channels 16 i .. 16 i + 15 of the plane at the piece's
//   shift, by ldmatrix into the A registers (no im2col exists).
// * An N-block is 128 output columns (acc: 2 M-tiles x 64 floats a
//   thread). Its k-steps go plane by plane ("visits"): phase A the x planes
//   (level 0: x's one plane for conv1's 16 k-steps, then, after bias and
//   relu on the accumulators, the skip's 16); phase B the h planes (conv2),
//   then the x planes for the shortcut (4 k-steps each). Level 1 has two
//   N-blocks, each its own item that visits every plane: 384 items at
//   B=48 instead of 192 tiles, 2.9 rounds of 132 blocks instead of 1.45.
// * The weights stream from L2 in pieces of 4 k-steps x 128 columns (16 KB,
//   two 64-column atoms of 64 rows), each k-step's 16 rows one TMA box per
//   atom, in the MMAs' order. Planes go through a ring of TC_NPL slots and
//   pieces through a ring of TC_NWS, each slot with a "full" mbarrier (the
//   producer's arrival and the boxes' bytes) and an "empty" one (the 256
//   consumer threads, once their MMAs are done with it).
// * A batch is two k-steps x two M-tiles = 4 wgmma.m64n128k16, one commit
//   group; two register sets for A let the next batch's ldmatrix run under
//   this batch's MMAs.
// * The epilogue works on the accumulator registers: bias, relu, te4 (phase
//   A), rounding to bf16, sm90::quad_transpose, and one 16-byte store a lane
//   of 8 columns; pixels outside the image are not written.
//
// Shared memory (bytes): 1024 (alignment of the swizzle atoms) + 3 planes x
// 44,032 (10 x 34 x 128 rounded up to 1024) + 6 pieces x 16,384 + 18
// mbarriers x 8 = 231,568 (TC_BYTES), of the 232,448 a block may have.
#pragma once

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// im2col piece table, in the order of ops/tap_conv.py:_ORDER: piece k reads
// the s2d input shifted by (row - 1, col - 1) pixels, tap block k % 4. The
// centre piece of tap block t (shift 0, 0) is piece 5 t.
__constant__ int kPieceRow[16] = {1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 1, 1, 2, 2, 1, 1};
__constant__ int kPieceCol[16] = {1, 0, 1, 0, 2, 1, 2, 1, 1, 0, 1, 0, 2, 1, 2, 1};

enum Phase { PHASE_A = 0, PHASE_B = 1 };

constexpr int TC_TH = 8, TC_TW = 32;                  // output tile
constexpr int TC_SH = TC_TH + 2, TC_SW = TC_TW + 2;   // slab: the tile and its halo
constexpr int TC_CONSUMERS = 256;                     // two warpgroups, 128 pixels each
constexpr int TC_THREADS = TC_CONSUMERS + 128;        // and the producer warpgroup
constexpr int TC_REGS_PRODUCER = 40, TC_REGS_CONSUMER = 232;  // setmaxnreg: 64,512 in all
constexpr int TC_PLANE_TX = TC_SH * TC_SW * 128;      // bytes a plane's box lands
constexpr int TC_PLANE = (TC_PLANE_TX + 1023) / 1024 * 1024;
constexpr int TC_PIECE = 64 * 128 * 2;                // 64 weight rows x 128 columns
constexpr int TC_ATOM = TC_PIECE / 2;                 // its 64 columns of one atom
constexpr int TC_NPL = 3, TC_NWS = 6;                 // plane and piece slots
// A plane goes back to the producer once the next visit's first batch is
// issued, and the producer loads plane k + 1 before plane k's pieces: with
// 2 plane slots the two wait for each other.
static_assert(TC_NPL >= 3 && TC_NWS >= 2, "the rings need 3 plane and 2 piece slots");
constexpr int TC_BARS = 2 * TC_NPL + 2 * TC_NWS;
constexpr int TC_BYTES = 1024 + TC_NPL * TC_PLANE + TC_NWS * TC_PIECE + 8 * TC_BARS;

template <int PHASE, int LEVEL> struct Tc {
  static constexpr int CI = 16 << LEVEL;           // x channels a tap block
  static constexpr int CM = 2 * CI;                // h and out channels a tap block
  static constexpr int C4 = 4 * CI, CO4 = 4 * CM;
  static constexpr bool SKIP = LEVEL == 0;         // W1 = [conv1 | skip | shortcut]
  static constexpr int N1 = (SKIP ? 3 : 2) * CO4;  // W1's columns
  static constexpr int NBLK = CO4 / 128;           // N-blocks a tile
  static constexpr int NPX = C4 / 64, NPH = CO4 / 64;  // planes of x and of h
  static constexpr int VISITS = PHASE == PHASE_A ? NPX : NPH + NPX;  // planes an N-block
  static constexpr int PER_X = PHASE == PHASE_A ? (SKIP ? 8 : 4) : 1;  // pieces an x visit
  static constexpr int PIECES = PHASE == PHASE_A ? NPX * PER_X : 4 * NPH + NPX;
  static constexpr int BATCHES = 2 * PIECES;       // of two k-steps
  // the batch before which conv1's sums take b1 and relu (the skip's follow)
  static constexpr int RELU_AT = PHASE == PHASE_A && SKIP ? 8 : -1;
};

// whether plane visit v reads h (else x), and its weight pieces
template <int PHASE, int LEVEL> __device__ __forceinline__ bool visit_h(int v) {
  return PHASE == PHASE_B && v < Tc<PHASE, LEVEL>::NPH;
}
template <int PHASE, int LEVEL> __device__ __forceinline__ int visit_pieces(int v) {
  return visit_h<PHASE, LEVEL>(v) ? 4 : Tc<PHASE, LEVEL>::PER_X;
}
// the 64-channel plane of its tensor that visit v reads
template <int PHASE, int LEVEL> __device__ __forceinline__ int visit_plane(int v) {
  using C = Tc<PHASE, LEVEL>;
  return PHASE == PHASE_B && v >= C::NPH ? v - C::NPH : v;
}

// piece jp of an N-block: its visit v and its index j within the visit
template <int PHASE, int LEVEL> __device__ __forceinline__ void piece_of(int jp, int& v, int& j) {
  using C = Tc<PHASE, LEVEL>;
  if (PHASE == PHASE_B && jp < 4 * C::NPH) {
    v = jp / 4;
    j = jp % 4;
  } else {
    const int x = PHASE == PHASE_B ? jp - 4 * C::NPH : jp;
    v = (PHASE == PHASE_B ? C::NPH : 0) + x / C::PER_X;
    j = x % C::PER_X;
  }
}

// k-step i (0..3) of piece j of visit v: the im2col piece it reads (its
// shift) and the weight row of its first column. It reads channels
// 16 i .. 16 i + 15 of the visit's plane: global channel gc = 64 pl + 16 i,
// tap block gc / c, k-step gc % c / 16 of the piece (c channels a tap
// block). A plane's 16 k-steps are its tap blocks' 16 pieces in W's row
// order (piece 4 (j % 4) + t); the shortcut's 4 are the centre pieces 5 t.
template <int PHASE, int LEVEL>
__device__ __forceinline__ void kstep_of(int v, int j, int i, int& piece, int& row) {
  using C = Tc<PHASE, LEVEL>;
  const bool from_h = visit_h<PHASE, LEVEL>(v);
  const bool shortcut = PHASE == PHASE_B && !from_h;
  const int c = from_h ? C::CM : C::CI;
  const int gc = 64 * visit_plane<PHASE, LEVEL>(v) + 16 * i;
  const int t = gc / c;
  piece = shortcut ? 5 * t : 4 * (j % 4) + t;
  row = piece * c + gc % c;
}

// the weight matrix (W2 if w2, else W1) and first column of piece j of
// visit v in N-block nb
template <int PHASE, int LEVEL>
__device__ __forceinline__ void weight_of(int v, int j, int nb, bool& w2, int& col) {
  using C = Tc<PHASE, LEVEL>;
  w2 = visit_h<PHASE, LEVEL>(v);
  if (PHASE == PHASE_A) col = 128 * nb + (j >= 4 ? C::CO4 : 0);  // conv1, then skip
  else col = 128 * nb + (w2 ? 0 : C::N1 - C::CO4);             // conv2, or shortcut
}

__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }

// Grid: min(#SMs, items) blocks of TC_THREADS threads, dynamic shared memory
// TC_BYTES. xmap: x (B, H, W, C4) as a 4-D tensor with boxes (64, TC_SW,
// TC_SH, 1); hmap: h (B, H, W, CO4), the same boxes (phase B); w1map, w2map:
// W1 (4 C4 rows, N1 columns) and W2 (4 CO4, CO4) with boxes (64, 16). te4
// (B, CO4), b1, bsk, b2, bsh (CO4); out: h (phase A) or the block's output
// (phase B), (B, H, W, CO4).
template <int PHASE, int LEVEL>
__global__ void __launch_bounds__(TC_THREADS, 1)
tap_tc_kernel(const __grid_constant__ sm90::TensorMap xmap,
              const __grid_constant__ sm90::TensorMap hmap,
              const __grid_constant__ sm90::TensorMap w1map,
              const __grid_constant__ sm90::TensorMap w2map, const bf16* __restrict__ te4,
              const bf16* __restrict__ b1, const bf16* __restrict__ bsk,
              const bf16* __restrict__ b2, const bf16* __restrict__ bsh, bf16* __restrict__ out,
              int B, int H, int W) {
  using C = Tc<PHASE, LEVEL>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms want 1024-byte alignment of the shared address
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + TC_NPL * TC_PLANE;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + TC_NWS * TC_PIECE);
  uint64_t* empty = full + TC_NPL;
  uint64_t* wfull = empty + TC_NPL;
  uint64_t* wempty = wfull + TC_NWS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (W + TC_TW - 1) / TC_TW, tiles_y = (H + TC_TH - 1) / TC_TH;
  const int nitems = B * tiles_x * tiles_y * C::NBLK;  // (tile, N-block) pairs
  const int mine = nitems > (int)blockIdx.x ? (nitems - blockIdx.x - 1) / gridDim.x + 1 : 0;
  // the block's it-th item: N-block nb of the tile at (y0, x0) of batch item b
  auto item_of = [&](int it, int& b, int& y0, int& x0, int& nb) {
    const int t = blockIdx.x + it * gridDim.x, tile = t / C::NBLK, r = tile % (tiles_x * tiles_y);
    nb = t % C::NBLK;
    b = tile / (tiles_x * tiles_y);
    y0 = r / tiles_x * TC_TH;
    x0 = r % tiles_x * TC_TW;
  };

  if (tid == 0) {
    for (int s = 0; s < TC_NPL; ++s) {
      sm90::mbar_init(&full[s], 1);  // lane 0's arrival, and the box's bytes
      sm90::mbar_init(&empty[s], TC_CONSUMERS);
    }
    for (int s = 0; s < TC_NWS; ++s) {
      sm90::mbar_init(&wfull[s], 1);
      sm90::mbar_init(&wempty[s], TC_CONSUMERS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();  // the mbarriers are initialised

  if (warp >= TC_CONSUMERS / 32) {
    // ---- the producer warpgroup hands its registers to the consumers; its
    // first warp issues the copies in the consumers' order: the block's k-th
    // plane visit (item k / VISITS, visit k % VISITS) one visit ahead of the
    // k-th visit's weight pieces
    sm90::setmaxnreg_dec<TC_REGS_PRODUCER>();
    if (warp != TC_CONSUMERS / 32) return;
    auto load_plane = [&](int k) {
      const int s = k % TC_NPL, v = k % C::VISITS;
      int b, y0, x0, nb;
      item_of(k / C::VISITS, b, y0, x0, nb);
      if (k >= TC_NPL) sm90::mbar_wait(&empty[s], (k / TC_NPL - 1) & 1);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], TC_PLANE_TX);
        sm90::tma_load_4d(base + s * TC_PLANE, visit_h<PHASE, LEVEL>(v) ? &hmap : &xmap,
                          64 * visit_plane<PHASE, LEVEL>(v), x0 - 1, y0 - 1, b, &full[s]);
      }
    };
    auto load_piece = [&](int k) {  // the block's k-th weight piece
      const int s = k % TC_NWS, nb = (blockIdx.x + k / C::PIECES * gridDim.x) % C::NBLK;
      int v, j;
      piece_of<PHASE, LEVEL>(k % C::PIECES, v, j);
      if (k >= TC_NWS) sm90::mbar_wait(&wempty[s], (k / TC_NWS - 1) & 1);
      if (lane == 0) {
        bool w2;
        int col;
        weight_of<PHASE, LEVEL>(v, j, nb, w2, col);
        sm90::mbar_arrive_expect_tx(&wfull[s], TC_PIECE);
        for (int i = 0; i < 4; ++i) {
          int piece, row;
          kstep_of<PHASE, LEVEL>(v, j, i, piece, row);
          for (int a = 0; a < 2; ++a)
            sm90::tma_load_2d(wsm + s * TC_PIECE + a * TC_ATOM + i * 2048, w2 ? &w2map : &w1map,
                              col + 64 * a, row, &wfull[s]);
        }
      }
    };
    const int nvisits = mine * C::VISITS;
    if (nvisits > 0) load_plane(0);
    int kp = 0;
    for (int k = 0; k < nvisits; ++k) {
      if (k + 1 < nvisits) load_plane(k + 1);
      const int n = visit_pieces<PHASE, LEVEL>(k % C::VISITS);
      for (int j = 0; j < n; ++j) load_piece(kp++);
    }
    return;
  }

  // ---- the consumers; ldmatrix lane l addresses pixel 16 (w % 2) + l % 16
  // of the warp's tile row, channels 8 (l / 16) .. + 7 of a k-step
  sm90::setmaxnreg_inc<TC_REGS_CONSUMER>();
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int row_w = 4 * wg + w / 2, px_w = 16 * (w % 2);

  for (int it = 0; it < mine; ++it) {
    int b, y0, x0, nb;
    item_of(it, b, y0, x0, nb);

    // batch s: k-steps 2 (s % 2) and 2 (s % 2) + 1 of piece s / 2
    auto load_a = [&](uint32_t (&a)[2][2][4], int s) {
      int v, j;
      piece_of<PHASE, LEVEL>(s / 2, v, j);
      const int kv = it * C::VISITS + v;
      if (j == 0 && s % 2 == 0) sm90::mbar_wait(&full[kv % TC_NPL], (kv / TC_NPL) & 1);
      const unsigned char* plane = base + (kv % TC_NPL) * TC_PLANE;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int i = 2 * (s % 2) + ii;
        int piece, row;
        kstep_of<PHASE, LEVEL>(v, j, i, piece, row);
        const int dy = kPieceRow[piece], dx = kPieceCol[piece];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int p = (row_w + 2 * m + dy) * TC_SW + px_w + lane % 16 + dx;
          const int chunk = (2 * i + lane / 16) ^ (p & 7);  // the 128-byte swizzle
          sm90::ldmatrix_x4(a[ii][m], plane + p * 128 + chunk * 16);
        }
      }
    };
    float acc[2][64];
    auto issue = [&](const uint32_t (&a)[2][2][4], int s) {
      const int k = it * C::PIECES + s / 2, slot = k % TC_NWS;
      if (s % 2 == 0) sm90::mbar_wait(&wfull[slot], (k / TC_NWS) & 1);
      const unsigned char* piece = wsm + slot * TC_PIECE;
      sm90::wgmma_fence();
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        // k-step i's 16 rows of both atoms: the next atom TC_ATOM bytes on
        const uint64_t desc = sm90::desc_sw128(piece + (2 * (s % 2) + ii) * 2048, TC_ATOM, 1024);
#pragma unroll
        for (int m = 0; m < 2; ++m) sm90::wgmma_m64n128k16(acc[m], a[ii][m], desc);
      }
      sm90::wgmma_commit();
    };
    // batch s's MMAs are done: after a piece's second batch the piece, and
    // after a visit's last piece the plane, go back to the producer
    auto release = [&](int s) {
      if (s % 2 == 0) return;
      int v, j;
      piece_of<PHASE, LEVEL>(s / 2, v, j);
      sm90::mbar_arrive(&wempty[(it * C::PIECES + s / 2) % TC_NWS]);
      if (j == visit_pieces<PHASE, LEVEL>(v) - 1)
        sm90::mbar_arrive(&empty[(it * C::VISITS + v) % TC_NPL]);
    };

#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
    uint32_t a0[2][2][4], a1[2][2][4];
    load_a(a0, 0);
    for (int s = 0; s < C::BATCHES; s += 2) {
      if (s == C::RELU_AT) {
        // conv1 is complete: relu(conv1 + b1), to which the skip's sums add
        sm90::wgmma_wait<0>();
        sm90::fence_operand(acc[0]);
        sm90::fence_operand(acc[1]);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bias = load_f(b1 + 128 * nb + 8 * jj + 2 * q + e);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                acc[m][4 * jj + 2 * h + e] = fmaxf(acc[m][4 * jj + 2 * h + e] + bias, 0.f);
          }
        sm90::fence_operand(acc[0]);
        sm90::fence_operand(acc[1]);
      }
      issue(a0, s);
      sm90::wgmma_wait<1>();  // batch s - 1 is done: a1 is free
      if (s > 0) release(s - 1);
      load_a(a1, s + 1);      // BATCHES is even
      issue(a1, s + 1);
      sm90::wgmma_wait<1>();  // batch s is done: a0 is free
      release(s);
      if (s + 2 < C::BATCHES) load_a(a0, s + 2);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc[0]);
    sm90::fence_operand(acc[1]);
    release(C::BATCHES - 1);

    // ---- epilogue: rows g and g + 8 of the warp's 16 pixels, per M-tile;
    // columns 128 nb + 32 jg + 8 j + 2 q (+ 1), each column's biases read
    // once for the four rows this lane holds
#pragma unroll
    for (int jg = 0; jg < 4; ++jg) {
      uint32_t v[2][2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float r[2][2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 128 * nb + 32 * jg + 8 * j + 2 * q + e;
          const float add = PHASE == PHASE_A
                                ? load_f(bsk + n) + load_f(te4 + (size_t)b * C::CO4 + n)
                                : load_f(b2 + n) + load_f(bsh + n);
          const float bias1 = PHASE == PHASE_A && !C::SKIP ? load_f(b1 + n) : 0.f;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float a = acc[m][4 * (4 * jg + j) + 2 * h + e];
              if constexpr (PHASE == PHASE_B) r[m][h][e] = fmaxf(a + add, 0.f);
              else if constexpr (C::SKIP) r[m][h][e] = a + add;  // relu'd at RELU_AT
              else r[m][h][e] = fmaxf(a + bias1, 0.f) + add;
            }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) v[m][h][j] = sm90::pack_bf16x2(r[m][h][0], r[m][h][1]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sm90::quad_transpose(v[m][h]);  // this lane: columns 32 jg + 8 q .. + 7
          const int y = y0 + row_w + 2 * m, x = x0 + px_w + g + 8 * h;
          if (y < H && x < W)  // every lane took part in the shuffles
            *reinterpret_cast<uint4*>(out + (((size_t)b * H + y) * W + x) * C::CO4 + 128 * nb +
                                      32 * jg + 8 * q) =
                uint4{v[m][h][0], v[m][h][1], v[m][h][2], v[m][h][3]};
        }
    }
  }
}

}  // namespace

#if defined(__CUDACC__)
// ---- the host side both launchers share (the CPU emulation, which has no
// __CUDACC__, never compiles it)
#include "tma_host.cuh"

namespace {

// h = phase A of x, then out = phase B of h and x, on `s`; p: x, te4, w1,
// w2, b1, bsk, bsh, b2, all bfloat16 and contiguous (shapes as
// tap_tc_kernel says). Returns the first cudaError_t (0 on success).
template <int LEVEL>
int launch_block_tc(const void* const* p, void* h, void* out, int B, int H, int W,
                    cudaStream_t s) {
  using C = Tc<PHASE_A, LEVEL>;
  const cuuint64_t xdims[4] = {C::C4, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t hdims[4] = {C::CO4, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t w1dims[2] = {C::N1, 4 * C::C4}, w2dims[2] = {C::CO4, 4 * C::CO4};
  const cuuint32_t sbox[4] = {64, TC_SW, TC_SH, 1}, wbox[2] = {64, 16};
  CUtensorMap xmap, hmap, w1map, w2map;
  if (!sm90::encode_map(&xmap, p[0], 4, xdims, sbox) ||
      !sm90::encode_map(&hmap, h, 4, hdims, sbox) ||
      !sm90::encode_map(&w1map, p[2], 2, w1dims, wbox) ||
      !sm90::encode_map(&w2map, p[3], 2, w2dims, wbox))
    return (int)cudaErrorInvalidValue;
  const long items = (long)B * ((H + TC_TH - 1) / TC_TH) * ((W + TC_TW - 1) / TC_TW) * C::NBLK;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(items < sms ? items : sms);
  auto a = [&](int i) { return static_cast<const bf16*>(p[i]); };
  // p order: x, te4, w1, w2, b1, bsk, bsh, b2
  for (int phase = 0; phase < 2; ++phase) {
    auto kernel = phase == 0 ? tap_tc_kernel<PHASE_A, LEVEL> : tap_tc_kernel<PHASE_B, LEVEL>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, TC_THREADS, TC_BYTES, s>>>(xmap, hmap, w1map, w2map, a(1), a(4), a(5), a(7),
                                              a(6), static_cast<bf16*>(phase == 0 ? h : out), B,
                                              H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
#endif
