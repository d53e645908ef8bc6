// Fused additive attention gate for Hopper (sm_90a): the CUDA counterpart
// of the TPU kernel diffusionremotesensing_tpu/ops/pallas_kernels.py:
// fused_attention_gate (:94, pallas_call :144; _gate_kernel :50). Per
// gating pixel (i, j) of g (B, H/2, W/2, C) and the 2x2 taps x_t = x[2i+di,
// 2j+dj] (t = 2 di + dj) of x (B, H, W, C):
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
// (8 us) and 3.6 GFLOP. Both are bound by bytes.
//
// The bfloat16 kernel (the served type: x, g and out in bf16, float32
// inside). The first design (32 gating pixels a block, float32 FMA on the
// CUDA cores, every thread reading float4 weight rows from device memory for
// every k, x's taps gathered by scalar loads) took 0.585 ms for gates 0 + 1
// at B=48 on an H100 80GB HBM3 at 700 W, 1.08x cuDNN's layer-by-layer gate.
// This one, gate_tc_kernel<C>, runs the products on the tensor cores and
// keeps float32 fidelity:
//
// 1. float32 weights in bf16 pieces. x and g are exact in bf16, so only the
//    weights need more bits: ops/attention_gate.py:build_gate_weights splits
//    [Wg; Wx; Wr] (6C x C, float32) once into hi = bf16(w) and lo =
//    bf16(w - hi) ("wt", (2, 6C, C)); every product is x @ hi + x @ lo with
//    float32 accumulation, which leaves ~2^-18 of each weight out. By the
//    linearity (x_t * psi) @ Wr = psi * (x_t @ Wr), every A is exact bf16 and
//    x_t @ Wr is issued beside x_t @ Wx, before psi is known; psi and the BN
//    affine are applied to the float32 accumulators in the epilogue.
// 2. An item is 64 gating pixels, a tile of 4 gating rows x 16 (one M-tile),
//    computed by the block's two consumer warpgroups together, each on half
//    the columns (N = C/2: wgmma.m64n64k16, m64n32k16 or m64n16k16 at C =
//    128, 64, 32). A persistent grid of at most one block an SM walks the
//    items; a producer warpgroup (setmaxnreg down to 40 registers, the
//    consumers up to 232) issues the copies by TMA behind full/empty
//    mbarriers, one thread each for the inputs, the streamed weights (4.)
//    and the stores (7.), so that none waits on another's ring.
// 3. The taps without a layout copy: x is read as (B, H, W/2, 2C), each pair
//    of x pixels one row of 2C channels, so one 4-D box of 16 pairs x 8 x rows
//    (128-byte swizzle, 64 channels a plane) holds the tile's 2x2 taps; tap
//    (di, dj) of gating pixel (i', j') is row j' + 16 (2 i' + di), channels
//    dj C .., read by ldmatrix row addresses. g comes as 64-channel planes
//    (C = 32: two 16-channel boxes, 32-byte swizzle). Rows past the image
//    land as zeros and are not written.
// 4. The weights. At C = 32 and 64 they stay in shared memory for the
//    block's life (24,576 and 98,304 bytes, 32-byte swizzle), landed once
//    in boxes of one 16-column atom x 192 rows, hi and lo (2 and 8 boxes).
//    At C = 128 (393,216 bytes) they stream from L2 through a ring of 8
//    slots in pieces of one k-step (16 rows, hi and lo, 8,192 bytes: a box
//    a 64-column atom) in the MMAs' order: Wg's 8, then for each k-step kk
//    Wr's and the four taps' of Wx, Wr's held over the four taps (48 pieces,
//    96 boxes an item).
// 5. psi from the registers: a = relu(acc + bg + bx) dotted with wpsi over
//    a lane's columns, two shfl_xor within the quad, then the two
//    warpgroups' halves added through shared memory behind an mbarrier.
// 6. A batch is one commit group of 4 or 8 MMAs: two k-steps of g, or one
//    k-step of two taps. Its A loads by ldmatrix into the register set that
//    the batch two back used; after a batch's issue the one before it is
//    waited for and its pieces retired.
// 7. The epilogue: out_t = BN(psi * acc_t + br), rounded to bf16, written
//    into the item's slot in x's place (out has x's shape, so its tile has
//    the x box's layout), then stored by TMA from a thread of the producer
//    warpgroup's second warp, which hands the slot back once the store has
//    read it; the box drops what lies outside the image. The consumers do
//    no global stores, and the store leaves in boxes of whole rows.
//
// Issued products at B=48: 2 x 36 C^2 MACs a gating pixel (a: 5C x C, r: 4
// x C x C, each twice for hi and lo): 7.25 GFLOP for each of gates 0 and 1.
// Gate 0 has 192 items at B=48: 1.45 rounds of 132 blocks. Splitting an
// item by columns or taps across blocks was not taken: psi needs all of a,
// so each part would recompute a's 20 C^2 of the 36 C^2, which costs more
// than the idle second round.
//
// Shared memory (bytes; 1024 for the alignment of the swizzle atoms, 1,024
// for psi's partial sums, then the mbarriers):
//   C = 128  1024 + 2 slots x 81,920 + 8 pieces x 8,192 + 1,024 + 23 x 8 = 231,608
//   C = 64   1024 + 3 x 40,960 + 98,304 + 1,024 + 11 x 8 = 223,320
//   C = 32   1024 + 4 x 20,480 + 24,576 + 1,024 + 14 x 8 = 108,656
// of the 232,448 a block may have (Gt<C>::BYTES).
//
// float32 (the golden and model phases' type) keeps the first design,
// attention_gate_f32_kernel<C>: 32 gating pixels a block, FMA on the CUDA
// cores.

#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using wt::bf16;

// The gate's float32 weights, each contiguous: wg (C, C) and wx (4C, C) as
// [in][out] (wx's rows tap-major: t*C + c), wr (C, C), the rest (C,);
// bpsi (1,).
struct GateWeights {
  const float *wg, *bg, *wx, *bx, *wpsi, *bpsi, *wr, *br, *scale, *bias, *mean, *var;
};

// ------------------------------------------------ bfloat16: the wgmma kernel

constexpr int GT_TW = 16, GT_TH = 4;                 // an item: 4 gating rows x 16
constexpr int GT_CONSUMERS = 256;                    // two warpgroups, half the columns each
constexpr int GT_THREADS = GT_CONSUMERS + 128;       // and the producer warpgroup
constexpr int GT_REGS_PRODUCER = 40, GT_REGS_CONSUMER = 232;  // setmaxnreg
constexpr int XPLANE = GT_TW * 2 * GT_TH * 128;      // 16 pairs x 8 x rows x 128 bytes

template <int C> struct Gt {
  static constexpr int KS = C / 16;                  // k-steps of C rows
  static constexpr int NH = C / 2;                   // columns of a consumer warpgroup
  static constexpr bool SW128 = C == 128;            // the weights' swizzle: 128 or 32 bytes
  static constexpr int ATOM = SW128 ? 64 : 16;       // columns of a weight atom
  static constexpr int AROW = 2 * ATOM;              // its row's bytes
  static constexpr int ABYTES = 16 * AROW;           // a k-step's 16 rows of one atom
  static constexpr int PIECE = 2 * (C / ATOM) * ABYTES;  // a k-step's hi and lo: 64 C
  static constexpr int NPIECE = 6 * KS;              // Wg, Wx (4 taps), Wr
  static constexpr bool RESIDENT = C <= 64;
  // resident: one box an atom's 192 rows of hi and lo, [hl][row][32 bytes]
  static constexpr int RROWS = 192, RBOX = 2 * RROWS * AROW, NRH = 6 * C / RROWS;
  static constexpr int NWS = RESIDENT ? NPIECE : 8;  // piece slots
  static constexpr int XPLANES = 2 * C / 64;
  static constexpr int GPLANE = C == 32 ? 64 * 32 : 64 * 128;  // a g box
  static constexpr int SLOT = XPLANES * XPLANE + 64 * C * 2;   // x, then g
  static constexpr int NS = C == 128 ? 2 : C == 64 ? 3 : 4;     // input slots
  static constexpr int BARS = 3 * NS + (RESIDENT ? 1 : 2 * NWS) + 1;  // + psi's
  static constexpr int PSUM = 2 * 2 * 64 * 4;        // [item parity][warpgroup][row] floats
  static constexpr int WBYTES = RESIDENT ? C / ATOM * NRH * RBOX : NWS * PIECE;  // the weights
  static constexpr int BYTES = 1024 + NS * SLOT + WBYTES + PSUM + 8 * BARS;
};

// the matrix row block (16 rows of wt: Wg 0 .., Wx_t KS + t KS .., Wr 5 KS ..)
// of the seq-th piece an item streams: Wg's, then for each k-step kk Wr's
// and the four taps' Wx
template <int C> __device__ __forceinline__ int piece_row(int seq) {
  constexpr int KS = Gt<C>::KS;
  if (seq < KS) return seq;
  const int x = seq - KS, kk = x / 5, r = x % 5;
  return r == 0 ? 5 * KS + kk : KS + (r - 1) * KS + kk;
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 64) sm90::wgmma_m64n64k16(d, a, desc);
  else if constexpr (N == 32) sm90::wgmma_m64n32k16(d, a, desc);
  else sm90::wgmma_m64n16k16(d, a, desc);
}

// Grid: min(#SMs, items) blocks of GT_THREADS threads, dynamic shared memory
// Gt<C>::BYTES. xmap: x (B, 2Hg, 2Wg, C) as 4-D (2C, Wg, 2Hg, B) with boxes
// (64, 16, 8, 1), omap the output (like x) the same; gmap: g (B, Hg, Wg, C)
// as (C, Wg, Hg, B) with boxes (64, 16, 4, 1) (C = 32: (16, 16, 4, 1),
// 32-byte swizzle); wmap: wt (2, 6C, C) as (C, 6C, 2, 1) with boxes (ATOM,
// 192, 2, 1) (resident) or (ATOM, 16, 2, 1) (streamed).
template <int C>
__global__ void __launch_bounds__(GT_THREADS, 1)
gate_tc_kernel(const __grid_constant__ sm90::TensorMap xmap,
               const __grid_constant__ sm90::TensorMap gmap,
               const __grid_constant__ sm90::TensorMap wmap,
               const __grid_constant__ sm90::TensorMap omap, GateWeights wts, int B, int Hg,
               int Wg) {
  using G = Gt<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + G::NS * G::SLOT;
  float* psum = reinterpret_cast<float*>(wsm + G::WBYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + G::WBYTES + G::PSUM);
  uint64_t* empty = full + G::NS;
  uint64_t* outbar = empty + G::NS;
  uint64_t* psibar = outbar + G::NS;
  uint64_t* wfull = psibar + 1;                    // [NWS] (streamed) or [1] (resident)
  uint64_t* wempty = wfull + G::NWS;               // streamed only
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (Wg + GT_TW - 1) / GT_TW, tiles_y = (Hg + GT_TH - 1) / GT_TH;
  const int nitems = B * tiles_x * tiles_y;
  const int mine = nitems > (int)blockIdx.x ? (nitems - blockIdx.x - 1) / gridDim.x + 1 : 0;
  auto tile_of = [&](int it, int& b, int& i0, int& j0) {
    const int t = blockIdx.x + it * gridDim.x, r = t % (tiles_x * tiles_y);
    b = t / (tiles_x * tiles_y);
    i0 = r / tiles_x * GT_TH;
    j0 = r % tiles_x * GT_TW;
  };

  if (tid == 0) {
    for (int s = 0; s < G::NS; ++s) {
      sm90::mbar_init(&full[s], 1);  // the producer's arrival, and the boxes' bytes
      sm90::mbar_init(&empty[s], 1);  // the storer's, once its store has read the slot
      sm90::mbar_init(&outbar[s], GT_CONSUMERS);
    }
    sm90::mbar_init(psibar, GT_CONSUMERS);
    if constexpr (G::RESIDENT) {
      sm90::mbar_init(wfull, 1);
    } else {
      for (int s = 0; s < G::NWS; ++s) {
        sm90::mbar_init(&wfull[s], 1);
        sm90::mbar_init(&wempty[s], GT_CONSUMERS);
      }
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();  // the mbarriers are initialised

  if (warp >= GT_CONSUMERS / 32) {
    // ---- the producer warpgroup hands its registers to the consumers. A
    // thread of its first warp loads the inputs (and the resident weights), one
    // of its second stores each item's output from its slot, and one of its
    // third streams the weight pieces (C = 128), so that none waits for
    // another's ring.
    sm90::setmaxnreg_dec<GT_REGS_PRODUCER>();
    if (tid == GT_CONSUMERS + 32) {
      for (int it = 0; it < mine; ++it) {
        const int s = it % G::NS;
        int b, i0, j0;
        tile_of(it, b, i0, j0);
        sm90::mbar_wait(&outbar[s], (it / G::NS) & 1);
        for (int p = 0; p < G::XPLANES; ++p)
          sm90::tma_store_4d(&omap, base + s * G::SLOT + p * XPLANE, 64 * p, j0, 2 * i0, b);
        sm90::bulk_commit();
        sm90::bulk_wait_read<0>();
        sm90::mbar_arrive(&empty[s]);
      }
      return;
    }
    if constexpr (!G::RESIDENT) {
      if (tid == GT_CONSUMERS + 64) {
        // the block's j-th piece into slot j % NWS: one box an atom of its
        // 16 rows, hi and lo
        for (int j = 0; j < mine * G::NPIECE; ++j) {
          const int s = j % G::NWS, rb = piece_row<C>(j % G::NPIECE);
          if (j >= G::NWS) sm90::mbar_wait(&wempty[s], (j / G::NWS - 1) & 1);
          sm90::mbar_arrive_expect_tx(&wfull[s], G::PIECE);
          for (int a = 0; a < C / G::ATOM; ++a)
            sm90::tma_load_4d(wsm + s * G::PIECE + a * 2 * G::ABYTES, &wmap, a * G::ATOM, 16 * rb,
                              0, 0, &wfull[s]);
        }
        return;
      }
    }
    if (tid != GT_CONSUMERS) return;
    if constexpr (G::RESIDENT) {  // box (atom a, rows 192 rh ..) at (a NRH + rh) RBOX
      sm90::mbar_arrive_expect_tx(wfull, G::NPIECE * G::PIECE);
      for (int a = 0; a < C / G::ATOM; ++a)
        for (int rh = 0; rh < G::NRH; ++rh)
          sm90::tma_load_4d(wsm + (a * G::NRH + rh) * G::RBOX, &wmap, a * G::ATOM, G::RROWS * rh,
                            0, 0, wfull);
    }
    for (int it = 0; it < mine; ++it) {  // item it's x and g into slot it % NS
      const int s = it % G::NS;
      int b, i0, j0;
      tile_of(it, b, i0, j0);
      if (it >= G::NS) sm90::mbar_wait(&empty[s], (it / G::NS - 1) & 1);
      unsigned char* slot = base + s * G::SLOT;
      sm90::mbar_arrive_expect_tx(&full[s], G::SLOT);
      for (int p = 0; p < G::XPLANES; ++p)
        sm90::tma_load_4d(slot + p * XPLANE, &xmap, 64 * p, j0, 2 * i0, b, &full[s]);
      unsigned char* gs = slot + G::XPLANES * XPLANE;
      for (int p = 0; p < (C == 32 ? 2 : C / 64); ++p)
        sm90::tma_load_4d(gs + p * G::GPLANE, &gmap, (C == 32 ? 16 : 64) * p, j0, i0, b, &full[s]);
    }
    return;
  }

  // ---- the consumers. Warpgroup wg computes columns NH wg .. + NH - 1 of
  // the item's 64 gating pixels; warp w holds gating row i0 + w, pixels
  // j0 .. j0 + 15 as rows 16 w .. + 15; ldmatrix lane l addresses pixel
  // j0 + l % 16 at channel 8 (l / 16) of a k-step.
  sm90::setmaxnreg_inc<GT_REGS_CONSUMER>();
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int jl = lane % 16, half = lane / 16;
  if constexpr (G::RESIDENT) sm90::mbar_wait(wfull, 0);

  for (int it = 0; it < mine; ++it) {
    int b, i0, j0;
    tile_of(it, b, i0, j0);
    const int s = it % G::NS;
    sm90::mbar_wait(&full[s], (it / G::NS) & 1);
    const unsigned char* xs = base + s * G::SLOT;
    const unsigned char* gs = xs + G::XPLANES * XPLANE;

    auto lda_g = [&](uint32_t (&a)[4], int kk) {
      const int row = 16 * w + jl;
      if constexpr (C == 32)  // 32-byte rows: chunk c of row r at c ^ (r / 4) % 2
        sm90::ldmatrix_x4(a, gs + kk * G::GPLANE + row * 32 + ((half ^ ((row >> 2) & 1)) << 4));
      else
        sm90::ldmatrix_x4(a, gs + (kk / 4) * G::GPLANE + row * 128 +
                                 (((2 * (kk % 4) + half) ^ (row & 7)) << 4));
    };
    // tap t = 2 di + dj, k-step kk: channel dj C + 16 kk + 8 half of the pair
    // row j' + 16 (2 w + di)
    auto lda_x = [&](uint32_t (&a)[4], int t, int kk) {
      const int m = (t & 1) * C + 16 * kk + 8 * half, row = jl + 16 * (2 * w + (t >> 1));
      sm90::ldmatrix_x4(a, xs + (m / 64) * XPLANE + row * 128 + ((((m % 64) / 8) ^ (row & 7)) << 4));
    };
    // the streamed piece of the item's seq-th (it waits for it to land)
    auto piece = [&](int seq) -> const unsigned char* {
      if constexpr (G::RESIDENT) {
        return nullptr;
      } else {
        const int j = it * G::NPIECE + seq;
        sm90::mbar_wait(&wfull[j % G::NWS], (j / G::NWS) & 1);
        return wsm + (j % G::NWS) * G::PIECE;
      }
    };
    // this warpgroup's columns of row block rb's hi (hl = 0) or lo (hl = 1):
    // resident, its first atom's box and row; streamed, the piece at pb
    auto desc = [&](const unsigned char* pb, int rb, int hl) -> uint64_t {
      if constexpr (G::RESIDENT) {
        const int a0 = G::NH / G::ATOM * wg;
        const unsigned char* st = wsm + (a0 * G::NRH + rb / (G::RROWS / 16)) * G::RBOX +
                                  hl * G::RROWS * G::AROW + rb % (G::RROWS / 16) * G::ABYTES;
        return sm90::desc_sw32(st, G::NRH * G::RBOX, 8 * G::AROW);
      } else {
        return sm90::desc_sw128(pb + wg * 2 * G::ABYTES + hl * G::ABYTES, 2 * G::ABYTES,
                                8 * G::AROW);
      }
    };
    // The batches, each one commit group: NG of g (two k-steps each), then
    // (kk, h) for each k-step kk, taps 2h and 2h + 1 (8 MMAs). A batch's A
    // loads into the register set that the batch two back used; after its
    // issue the batch before it is waited for (wgmma_wait<1>) and retired,
    // its streamed pieces going back (Wr's after the second half).
    constexpr int G4 = 2, NG = G::KS / G4;
    auto retire = [&](int bid) {
      if constexpr (!G::RESIDENT) {
        auto give = [&](int seq) { sm90::mbar_arrive(&wempty[(it * G::NPIECE + seq) % G::NWS]); };
        if (bid < NG) {
          for (int k = 0; k < G4; ++k) give(G4 * bid + k);
        } else {
          const int kk = (bid - NG) / 2, h = (bid - NG) % 2, seq = G::KS + 5 * kk;
          give(seq + 1 + 2 * h);
          give(seq + 2 + 2 * h);
          if (h) give(seq);
        }
      }
    };
    uint32_t a0[2][4], a1[2][4];
    int pending = -1;  // the batch in flight before the newest
    auto issued = [&](int bid) {
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pending >= 0) retire(pending);
      pending = bid;
    };

    float acc_a[G::NH / 2], acc_r[4][G::NH / 2];
#pragma unroll
    for (int i = 0; i < G::NH / 2; ++i) {
      acc_a[i] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) acc_r[t][i] = 0.f;
    }
    sm90::fence_operand(acc_a);
#pragma unroll
    for (int t = 0; t < 4; ++t) sm90::fence_operand(acc_r[t]);

    // g @ Wg; the last g batch takes a1, so that x's first takes a0
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      uint32_t (&a)[2][4] = (NG - 1 - i) % 2 ? a0 : a1;
      const unsigned char* pb[G4];
#pragma unroll
      for (int k = 0; k < G4; ++k) {
        lda_g(a[k], G4 * i + k);
        pb[k] = piece(G4 * i + k);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < G4; ++k) {
        mma<G::NH>(acc_a, a[k], desc(pb[k], G4 * i + k, 0));
        mma<G::NH>(acc_a, a[k], desc(pb[k], G4 * i + k, 1));
      }
      issued(i);
    }
    // x_t @ Wx_t into a and x_t @ Wr into r_t, two taps a batch (Wr's row
    // block held over both)
#pragma unroll 1
    for (int kk = 0; kk < G::KS; ++kk) {
      const int seq = G::KS + 5 * kk, rr = 5 * G::KS + kk;
      const unsigned char* wr = piece(seq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t (&a)[2][4] = h ? a1 : a0;
        const unsigned char* wx[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          lda_x(a[u], 2 * h + u, kk);
          wx[u] = piece(seq + 1 + 2 * h + u);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int rx = G::KS + (2 * h + u) * G::KS + kk;
          mma<G::NH>(acc_a, a[u], desc(wx[u], rx, 0));
          mma<G::NH>(acc_r[2 * h + u], a[u], desc(wr, rr, 0));
          mma<G::NH>(acc_a, a[u], desc(wx[u], rx, 1));
          mma<G::NH>(acc_r[2 * h + u], a[u], desc(wr, rr, 1));
        }
        issued(NG + 2 * kk + h);
      }
    }
    sm90::wgmma_wait<0>();
    retire(pending);
    sm90::fence_operand(acc_a);
#pragma unroll
    for (int t = 0; t < 4; ++t) sm90::fence_operand(acc_r[t]);

    // psi: a = relu(acc + bg + bx) dotted with wpsi over this lane's columns
    // 8 j + 2 q + e of rows g (h = 0) and g + 8, the quad's sum, then both
    // warpgroups' halves
    float psi[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < G::NH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = G::NH * wg + 8 * j + 2 * q + e;
        const float bias = wts.bg[col] + wts.bx[col], wp = wts.wpsi[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) psi[h] = fmaf(fmaxf(acc_a[4 * j + 2 * h + e] + bias, 0.f), wp, psi[h]);
      }
    float* ps = psum + (it & 1) * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psi[h] += sm90::shfl_xor(psi[h], 1);
      psi[h] += sm90::shfl_xor(psi[h], 2);
      if (q == 0) ps[64 * wg + 16 * w + g + 8 * h] = psi[h];
    }
    sm90::mbar_arrive(psibar);
    sm90::mbar_wait(psibar, it & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + g + 8 * h;
      psi[h] = 1.f / (1.f + expf(-(ps[row] + ps[64 + row] + wts.bpsi[0])));
    }

    // ---- epilogue: out_t = BN(psi * acc_t + br), rounded, written into the
    // slot in x's place (tap t of gating pixel (w, j') is pair row j' + 16
    // (2 w + di), channel dj C + column), then stored by TMA. Every consumer
    // has passed psi's barrier, so none still reads x.
    unsigned char* xo = base + s * G::SLOT;
#pragma unroll
    for (int j = 0; j < G::NH / 8; ++j) {
      const int col = G::NH * wg + 8 * j + 2 * q;  // and col + 1
      float br[2], mean[2], k[2], bias[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        br[e] = wts.br[col + e];
        mean[e] = wts.mean[col + e];
        k[e] = rsqrtf(wts.var[col + e] + 1e-5f) * wts.scale[col + e];
        bias[e] = wts.bias[col + e];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int m = (t & 1) * C + col;
        unsigned char* plane = xo + m / 64 * XPLANE + m % 8 * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = g + 8 * h + 16 * (2 * w + (t >> 1));
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[e] = (psi[h] * acc_r[t][4 * j + 2 * h + e] + br[e] - mean[e]) * k[e] + bias[e];
          *reinterpret_cast<uint32_t*>(plane + row * 128 + (((m % 64 / 8) ^ (row & 7)) << 4)) =
              sm90::pack_bf16x2(o[0], o[1]);
        }
      }
    }
    sm90::fence_proxy_async();  // the writes, before the TMA store reads them
    sm90::mbar_arrive(&outbar[s]);
  }
}

// ------------------------------------------------ float32: the FMA kernel

constexpr int NTHREADS = 256;
constexpr int P = 32;  // gating pixels a block

template <int C> struct Smem {
  static constexpr int LDX = 4 * C + 4;  // x taps of a pixel
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
template <int C>
__global__ void __launch_bounds__(NTHREADS)
attention_gate_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          GateWeights w, float* __restrict__ out, int N, int Hg, int Wg) {
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

  // ---- phase 1: the block's x taps and g (zero past N)
  for (int e = threadIdx.x; e < P * 4 * C; e += NTHREADS) {
    const int p = e / (4 * C), k = e % (4 * C), t = k / C, c = k % C, n = n0 + p;
    float v = 0.f;
    if (n < N) {
      const int b = n / (Hg * Wg), ij = n % (Hg * Wg), i = ij / Wg, j = ij % Wg;
      v = x[(((size_t)b * 2 * Hg + 2 * i + (t >> 1)) * W + 2 * j + (t & 1)) * C + c];
    }
    xs[p * L::LDX + k] = v;
  }
  for (int e = threadIdx.x; e < P * C; e += NTHREADS) {
    const int p = e / C, c = e % C, n = n0 + p;
    gs[p * L::LDG + c] = n < N ? g[(size_t)n * C + c] : 0.f;
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
      float* o = out + (((size_t)b * 2 * Hg + 2 * gi + (t >> 1)) * W + 2 * gj + (t & 1)) * C;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * tc + q;
        const float r = acc[i][q] + w.br[c];
        o[c] = (r - w.mean[c]) * rsqrtf(w.var[c] + 1e-5f) * w.scale[c] + w.bias[c];
      }
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

#include "tma_host.cuh"

namespace {

template <int C>
int launch_tc(const void* x, const void* g, const GateWeights& w, const void* wt, void* out, int B,
              int Hg, int Wg, cudaStream_t s) {
  using G = Gt<C>;
  const cuuint64_t b = B, hg = Hg, wg = Wg;
  const cuuint64_t xdims[4] = {2 * C, wg, 2 * hg, b}, gdims[4] = {C, wg, hg, b};
  const cuuint64_t wdims[4] = {C, 6 * C, 2, 1};
  const cuuint32_t xbox[4] = {64, GT_TW, 2 * GT_TH, 1};
  const cuuint32_t gbox[4] = {C == 32 ? 16 : 64, GT_TW, GT_TH, 1};
  const cuuint32_t wbox[4] = {G::ATOM, G::RESIDENT ? G::RROWS : 16, 2, 1};
  constexpr CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B, sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap xm, gm, wm, om;
  if (!sm90::encode_map(&xm, x, 4, xdims, xbox) || !sm90::encode_map(&om, out, 4, xdims, xbox) ||
      !sm90::encode_map(&gm, g, 4, gdims, gbox, C == 32 ? sw32 : sw128) ||
      !sm90::encode_map(&wm, wt, 4, wdims, wbox, G::SW128 ? sw128 : sw32))
    return (int)cudaErrorInvalidValue;
  const long items = (long)B * ((Hg + GT_TH - 1) / GT_TH) * ((Wg + GT_TW - 1) / GT_TW);
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaFuncSetAttribute(gate_tc_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  gate_tc_kernel<C><<<(int)(items < sms ? items : sms), GT_THREADS, G::BYTES, s>>>(
      xm, gm, wm, om, w, B, Hg, Wg);
  return (int)cudaGetLastError();
}

template <int C>
int launch_f32(const void* x, const void* g, const GateWeights& w, void* out, int B, int Hg, int Wg,
               cudaStream_t s) {
  const size_t smem = Smem<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_gate_f32_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int N = B * Hg * Wg;
  attention_gate_f32_kernel<C><<<(N + P - 1) / P, NTHREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), w, static_cast<float*>(out), N,
      Hg, Wg);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const void* x, const void* g, const GateWeights& w, const void* wt, void* out, int B,
             int Hg, int Wg, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_tc<C>(x, g, w, wt, out, B, Hg, Wg, s)
                 : launch_f32<C>(x, g, w, out, B, Hg, Wg, s);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// x (B, 2Hg, 2Wg, C) and g (B, Hg, Wg, C) in one type, bfloat16 (is_bf16
// != 0) or float32; wp: the 12 float32 weights in GateWeights' order, then
// wt, bfloat16 (2, 6C, C), the hi and lo parts of [Wg; Wx; Wr] that the
// bfloat16 kernel multiplies (unused in float32); in bfloat16 x, g and wt
// 16-byte aligned for TMA. out like x. C is 32, 64 or 128.
extern "C" int attention_gate_launch(const void* x, const void* g, const void* const* wp,
                                     void* out, int B, int Hg, int Wg, int C, int is_bf16,
                                     void* stream) {
  if (B < 1 || Hg < 1 || Wg < 1) return (int)cudaErrorInvalidValue;
  const float* f[12];
  for (int i = 0; i < 12; ++i) f[i] = static_cast<const float*>(wp[i]);
  const GateWeights w = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch_c<32>(x, g, w, wp[12], out, B, Hg, Wg, is_bf16, s);
    case 64: return launch_c<64>(x, g, w, wp[12], out, B, Hg, Wg, is_bf16, s);
    case 128: return launch_c<128>(x, g, w, wp[12], out, B, Hg, Wg, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
