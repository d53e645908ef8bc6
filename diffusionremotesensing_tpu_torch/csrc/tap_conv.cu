// Tap-structured s2d 3x3 convolutions for Hopper (sm_90a): the CUDA
// counterparts of the TPU kernels diffusionremotesensing_tpu/ops/tap_conv.py:
// tap_conv (:126, pallas_call :140; _tap_conv_kernel :107) and tap_conv_pair
// (:156, pallas_call :169; _tap_conv_pair_kernel :114). Per s2d output pixel
// of x (B, H2, W2, 4C)
//
//   out = im2col4x4(x) @ W        (16C columns, W (16C, 4Co); the pair: Wa, Wb)
//
// where im2col4x4 concatenates the 16 pieces of ops/tap_conv.py:_ORDER, each
// the s2d input shifted by (row - 1, col - 1) pixels restricted to one tap
// block, zero outside the image (the 3x3 conv's SAME padding on the
// original grid). Products accumulate in float32; each output is rounded
// once to the input type, as the TPU kernel does. W may be any matrix: no
// structural zero is skipped.
//
// What bounds it. At the main path's shapes (B=48, 64x64 s2d pixels) the
// convolutions' own work, counted at full resolution (128x128 pixels,
// 3x3 taps), is conv2 32->32: 2*48*128*128*9*32*32 = 14.5 GFLOP, and the
// pair (conv1 and skip, 16->32 each) the same; the bytes are x read and the
// outputs written once: 100.7 MB (conv2) and 125.8 MB (the pair) in
// bfloat16. At 3.35 TB/s against 989 TFLOP/s bf16 both are bound by bytes
// (30 and 38 us). The tap form issues 1.78x the conv's products (the 4x4
// window's structural zeros): 25.8 GFLOP, 26 us at the tensor cores' peak,
// still under the byte time.
//
// The bfloat16 kernel (tap_conv_tc_kernel). The first design (a block per
// 8 x 16 tile, a warp per 16-pixel row, WMMA with every B fragment read
// from device memory through the caches) read the whole W once per warp
// row: 128 KB x 12,288 warp rows = 1.6 GB of cache traffic per call at
// B=48, for 100-126 MB of real bytes, and took 0.59 ms. This one:
//
// 1. The weights stay in shared memory. A persistent grid of at most one
//    block per SM (capped by the tile count) stages the whole W (the pair:
//    Wa and Wb) into shared memory once, with TMA boxes of 64 columns x 256
//    rows completing on an mbarrier, and then walks its share of the
//    B x ceil(H2/8) x ceil(W2/16) output tiles (1,536 at B=48, 32 at B=1):
//    weight traffic is 132 x 128 KB = 17 MB. The boxes land with the
//    128-byte swizzle, which is wgmma's MN-major B layout (sm90.cuh), so the
//    MMA's reads of W meet no bank conflict and need no padding.
// 2. The input slabs are double-buffered. Thread 0 issues tile i+1's slab
//    (the 8 x 16 tile plus its one-pixel halo, 10 x 18 pixels x 4C) as TMA
//    boxes of 64 channels while the block computes tile i; the box's
//    coordinates outside the image land as zeros, which is the SAME padding.
//    Each slab has a "full" mbarrier (thread 0's arrival and the boxes'
//    bytes) and an "empty" one (every thread's arrival once its MMAs are
//    done with it). Each im2col piece is a 16-pixel window of the slab read
//    in place: no im2col exists. The slab is swizzled too (pixel p's chunk
//    c at c ^ p % 8), so ldmatrix's eight 16-byte rows, eight consecutive
//    pixels, fall in distinct banks. One thread issuing boxes keeps up with
//    the MMAs; a warp issuing 16-byte cp.async copies did not.
// 3. Warpgroup MMA. Two warpgroups each own 64 pixels (4 tile rows of 16):
//    wgmma.m64nNk16 with A (the piece's 64 x 16 slice) from registers,
//    loaded with ldmatrix (the shifted pieces do not have the layout wgmma
//    wants for A in shared memory), B through a descriptor into the staged
//    W. conv2 runs N = 128 (all of Wa) in batches of 8 MMAs; the pair runs
//    N = 256, Wa and Wb side by side, so each A fragment serves both
//    matrices, in batches of 4. Two register sets for A let the next
//    batch's ldmatrix run under the current batch's MMAs. Each B element
//    read serves 64 pixels (16 under WMMA).
// 4. The epilogue writes from the accumulator registers: no float32 buffer.
//    The four lanes of a quad exchange column pairs (sm90::quad_transpose),
//    so that each lane stores 8 consecutive bf16 of one pixel, a 16-byte
//    store; pixels past the image edge are masked.
//
// Shared memory (bytes) = 1024 (alignment of the swizzle atoms) + W
// (2 * 4C * 4Co per matrix) + 2 slabs (4C / 64 planes of 10 * 18 * 128
// bytes, each rounded up to 23,552) + 5 mbarriers (40): conv2 (4C=128,
// 4Co=128) 1024 + 131,072 + 94,208 + 40 = 226,344 and the pair (4C=64, two
// 256 x 128 matrices) 1024 + 131,072 + 47,104 + 40 = 179,240, of the
// 232,448 a block may have. A shape whose W does not fit is refused
// (ops/tap_conv.py:_check, and the launcher). Requires 4C % 64 == 0 and
// 4Co % 128 == 0.
//
// float32 (the golden and model phases' type, not the served one) keeps the
// first design as tap_conv_f32_kernel: a float32 W of 256 KB does not fit
// in shared memory beside a slab. A block owns an 8 x 16 tile, warp w its
// row w; warp_tile.cuh's FMA tile (16 pixels x 64 columns) reads W through
// the caches, through a float32 epilogue buffer.

#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using wt::bf16;

constexpr int TW = 16;            // tile width: 16 pixels, one warp's A rows
constexpr int TH = 8;             // tile rows
constexpr int SW = TW + 2;        // x slab width (one-pixel halo)
constexpr int SH = TH + 2;        // x slab rows
constexpr int SMEM_LIMIT = 232448;

// im2col piece table, in the order of ops/tap_conv.py:_ORDER: piece k reads
// the s2d input shifted by (row - 1, col - 1) pixels, tap block k % 4.
__constant__ int kPieceRow[16] = {1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 1, 1, 2, 2, 1, 1};
__constant__ int kPieceCol[16] = {1, 0, 1, 0, 2, 1, 2, 1, 1, 0, 1, 0, 2, 1, 2, 1};

// ------------------------------------------------ bfloat16: wgmma kernel

constexpr int TC_THREADS = 256;  // two warpgroups; thread 0 also issues the copies

// An x slab is C4 / 64 planes, each the TMA box (64 channels, SW pixels,
// SH rows) with the 128-byte swizzle: pixel p's 64 channels are 128-byte
// row p, 16-byte chunk c at chunk c ^ p % 8. A plane starts 1024-aligned.
constexpr int TC_PLANE = (SH * SW * 128 + 1023) / 1024 * 1024;
constexpr int TC_WBOX = 256;  // rows of W a TMA box copies
__host__ __device__ constexpr size_t tc_slab_bytes(int C4) { return (size_t)(C4 / 64) * TC_PLANE; }
__host__ __device__ constexpr size_t tc_w_bytes(int C4, int CO4) {
  return sizeof(bf16) * 4 * C4 * CO4;
}
// W (NW matrices), two slabs, 5 mbarriers, and 1024 bytes to align the atoms
__host__ __device__ constexpr size_t tc_smem_bytes(int C4, int CO4, int NW) {
  return 1024 + NW * tc_w_bytes(C4, CO4) + 2 * tc_slab_bytes(C4) + 5 * sizeof(uint64_t);
}

// One pass: acc (64 pixels x N columns) = the warpgroup's pixels' im2col
// times N columns of the staged W. slab: the tile's x slab; p0: this lane's
// ldmatrix row (the slab pixel of lane % 16 of the warp's tile row,
// unshifted), chalf: its channel offset (0 or 8); desc: B at k-step 0, which
// advances 2048 bytes (16 rows of W) a k-step. The k-steps go in batches of
// BATCH MMAs, one commit group each, the A of two batches in two register
// sets: the next batch's ldmatrix runs while the current batch's MMAs do.
template <int BATCH>
__device__ __forceinline__ void tc_load_a(uint32_t (&a)[BATCH][4], const unsigned char* slab,
                                          int p0, int chalf, int C, int spp, int s0) {
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const int s = s0 + j, k = s / spp, kk = s - k * spp;
    const int p = p0 + kPieceRow[k] * SW + kPieceCol[k], ch = (k & 3) * C + kk * 16 + chalf;
    const int chunk = ((ch >> 3) & 7) ^ (p & 7);  // the 128-byte swizzle
    sm90::ldmatrix_x4(a[j], slab + (ch >> 6) * TC_PLANE + p * 128 + chunk * 16);
  }
}

template <int N, int BATCH>
__device__ __forceinline__ void tc_mma(float (&acc)[N / 2], const uint32_t (&a)[BATCH][4],
                                       uint64_t desc, int s0) {
  sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const uint64_t d = desc + (uint64_t)(s0 + j) * (2048 >> 4);
    if constexpr (N == 256) sm90::wgmma_m64n256k16(acc, a[j], d);
    else sm90::wgmma_m64n128k16(acc, a[j], d);
  }
  sm90::wgmma_commit();
}

template <int N, int BATCH>
__device__ __forceinline__ void tc_pass(float (&acc)[N / 2], const unsigned char* slab, int p0,
                                        int chalf, int C, uint64_t desc) {
  const int spp = C / 16;   // k-steps per piece
  const int ks = 16 * spp;  // a multiple of 2 BATCH (16 pieces)
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  sm90::fence_operand(acc);
  uint32_t a0[BATCH][4], a1[BATCH][4];
  tc_load_a(a0, slab, p0, chalf, C, spp, 0);
  for (int s = 0; s < ks; s += 2 * BATCH) {
    tc_mma<N>(acc, a0, desc, s);
    sm90::wgmma_wait<1>();  // the batch before is done: a1 is free
    tc_load_a(a1, slab, p0, chalf, C, spp, s + BATCH);
    tc_mma<N>(acc, a1, desc, s + BATCH);
    sm90::wgmma_wait<1>();  // batch s is done: a0 is free
    if (s + 2 * BATCH < ks) tc_load_a(a0, slab, p0, chalf, C, spp, s + 2 * BATCH);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operand(acc);
}

// Stores the warp's 16 pixels x N columns of acc (wgmma's D layout):
// columns n0 .. n0 + N - 1 of [oa | ob] (CO4 each), pixels (pix + g) and
// (pix + g + 8) of the output's row, g = lane / 4, those at or past x_end
// (the image's edge) or in a row past the image (row_ok false) masked. Each
// quad's column pairs of groups 4 jg .. 4 jg + 3 go through
// sm90::quad_transpose, so that lane q then holds the 8 consecutive columns
// 32 jg + 8 q: one 16-byte store.
template <int N>
__device__ __forceinline__ void tc_store(const float (&acc)[N / 2], bf16* oa, bf16* ob, int CO4,
                                         int n0, size_t pix, int px, int x_end, bool row_ok) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool inside = row_ok && px + g + 8 * h < x_end;
    const size_t row = (pix + g + 8 * h) * CO4 + 8 * q;
#pragma unroll
    for (int jg = 0; jg < N / 32; ++jg) {
      const float* a = acc + 16 * jg + 2 * h;  // group 4 jg + j at a[4 j], a[4 j + 1]
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = sm90::pack_bf16x2(a[4 * j], a[4 * j + 1]);
      sm90::quad_transpose(v);
      const int c = n0 + 32 * jg;  // 32 columns never straddle oa and ob (CO4 % 128 == 0)
      bf16* o = c < CO4 ? oa + c : ob + (c - CO4);
      if (inside) *reinterpret_cast<uint4*>(o + row) = uint4{v[0], v[1], v[2], v[3]};
    }
  }
}

// Grid: min(#SMs, tiles) blocks of TC_THREADS threads, dynamic shared
// memory tc_smem_bytes(C4, CO4, NW). xmap: x (B, H2, W2, C4) as a 4-D
// tensor, box (64, SW, SH, 1); wamap, wbmap: the NW weight matrices
// (4 C4, CO4), box (64, TC_WBOX); each with its output (B, H2, W2, CO4).
// W is staged as [n atom][k row] (atom a: columns 64a .. 64a + 63 of
// [Wa | Wb], K rows of 128 bytes, swizzled): B's LBO (the next 64 columns)
// is K * 128 bytes, its SBO (the next 8 rows) 1024. The pair's passes are
// 256 columns wide (Wa and Wb together: A is loaded once for both), the
// single conv's 128.
template <int NW>
__global__ void __launch_bounds__(TC_THREADS, 1)
tap_conv_tc_kernel(const __grid_constant__ sm90::TensorMap xmap,
                   const __grid_constant__ sm90::TensorMap wamap,
                   const __grid_constant__ sm90::TensorMap wbmap, bf16* __restrict__ oa,
                   bf16* __restrict__ ob, int B, int H2, int W2, int C4, int CO4) {
  constexpr int N = 128 * NW, BATCH = NW == 2 ? 4 : 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms want 1024-byte alignment of the shared address
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const int C = C4 / 4, K = 4 * C4, NB = CO4 / 64;
  const size_t wbytes = tc_w_bytes(C4, CO4), sbytes = tc_slab_bytes(C4);
  unsigned char* wsm = base;
  unsigned char* slabs[2] = {base + NW * wbytes, base + NW * wbytes + sbytes};
  uint64_t* full = reinterpret_cast<uint64_t*>(base + NW * wbytes + 2 * sbytes);
  uint64_t* empty = full + 2;
  uint64_t* wfull = full + 4;
  const int tid = threadIdx.x, lane = tid % 32, trow = tid / 32;
  const int tiles_x = (W2 + TW - 1) / TW, tiles_y = (H2 + TH - 1) / TH;
  const int ntiles = B * tiles_x * tiles_y;
  const uint32_t slab_tx = (uint32_t)(C4 / 64) * SH * SW * 128;  // bytes a slab's boxes land

  // tile i of this block's share (t = blockIdx.x + i gridDim.x) into slab
  // buffer i % 2, one box a plane of 64 channels; the box's rows and
  // columns outside the image land as zeros
  auto load_slab = [&](int t, int s) {
    const int b = t / (tiles_x * tiles_y), r = t - b * tiles_x * tiles_y;
    sm90::mbar_arrive_expect_tx(&full[s], slab_tx);
    for (int pl = 0; pl < C4 / 64; ++pl)
      sm90::tma_load_4d(slabs[s] + pl * TC_PLANE, &xmap, 64 * pl, (r % tiles_x) * TW - 1,
                        (r / tiles_x) * TH - 1, b, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&full[s], 1);            // thread 0's arrival, and the boxes' bytes
      sm90::mbar_init(&empty[s], TC_THREADS);  // every thread, done with the slab
    }
    sm90::mbar_init(wfull, 1);
    sm90::fence_mbar_init();
    // W (and Wb) once, as boxes of 64 columns x TC_WBOX rows
    sm90::mbar_arrive_expect_tx(wfull, (uint32_t)(NW * wbytes));
    for (int m = 0; m < NW; ++m)
      for (int na = 0; na < NB; ++na)
        for (int k0 = 0; k0 < K; k0 += TC_WBOX)
          sm90::tma_load_2d(wsm + ((size_t)(m * NB + na) * K + k0) * 128, m ? &wbmap : &wamap,
                            64 * na, k0, wfull);
    if (blockIdx.x < ntiles) load_slab(blockIdx.x, 0);
  }
  __syncthreads();  // the mbarriers are initialised
  sm90::mbar_wait(wfull, 0);

  // warp w of warpgroup wg computes tile row 4 wg + w = trow
  int i = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int s = i & 1;
    if (tid == 0 && t + (int)gridDim.x < ntiles) {
      // the next tile into the other buffer, once tile i - 1 is done with it
      if (i >= 1) sm90::mbar_wait(&empty[s ^ 1], ((i - 1) >> 1) & 1);
      load_slab(t + gridDim.x, s ^ 1);
    }
    __syncwarp();
    sm90::mbar_wait(&full[s], (i >> 1) & 1);
    const int b = t / (tiles_x * tiles_y), r = t - b * tiles_x * tiles_y;
    const int oy = (r / tiles_x) * TH + trow, ox = (r % tiles_x) * TW;
    const size_t pix = ((size_t)b * H2 + oy) * W2 + ox;
    for (int n0 = 0; n0 < NW * CO4; n0 += N) {
      float acc[N / 2];
      tc_pass<N, BATCH>(acc, slabs[s], trow * SW + lane % 16, (lane / 16) * 8, C,
                        sm90::desc_sw128(wsm + (size_t)(n0 / 64) * K * 128, K * 128, 1024));
      if (n0 + N == NW * CO4) sm90::mbar_arrive(&empty[s]);  // done reading the slab
      tc_store<N>(acc, oa, ob, CO4, n0, pix, ox, W2, oy < H2);
    }
  }
}

// ------------------------------------------------ float32: FMA kernel

constexpr int F32_THREADS = 256;
constexpr int F32_NWARP = F32_THREADS / 32;  // one warp per tile row
constexpr int F32_NC = 64;                   // output columns per warp tile
constexpr int F32_LDC = F32_NC + 4;          // row stride of a warp's epilogue buffer

__host__ __device__ constexpr int f32_ld(int C4) { return C4 + 4; }
size_t f32_smem_bytes(int C4) {
  return wt::align128(sizeof(float) * SH * SW * f32_ld(C4)) +
         sizeof(float) * F32_NWARP * 16 * F32_LDC;
}

// Grid (ceil(W2/TW), ceil(H2/TH), B), F32_THREADS threads, dynamic shared
// memory f32_smem_bytes(C4). Requires CO4 % 64 == 0, C4 % 4 == 0.
template <int NW>
__global__ void __launch_bounds__(F32_THREADS)
tap_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                    const float* __restrict__ wb, float* __restrict__ oa, float* __restrict__ ob,
                    int H2, int W2, int C4, int CO4) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = f32_ld(C4);
  float* slab = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* cbuf = reinterpret_cast<float*>(smem_raw + wt::align128(sizeof(float) * SH * SW * ldx)) +
                warp * 16 * F32_LDC;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int C = C4 / 4;
  const float* xb = x + (size_t)b * H2 * W2 * C4;

  // the slab: x rows y0-1 .. y0+TH, columns x0-1 .. x0+TW, zero outside
  const int units = C4 / 4;
  for (int e = threadIdx.x; e < SH * SW * units; e += F32_THREADS) {
    const int p = e / units, u = e % units;
    const int yy = y0 - 1 + p / SW, xx = x0 - 1 + p % SW;
    const bool inside = yy >= 0 && yy < H2 && xx >= 0 && xx < W2;
    wt::cp_async16(slab + p * ldx + u * 4, inside ? xb + ((size_t)yy * W2 + xx) * C4 + u * 4 : xb,
                   inside);
  }
  wt::cp_async_commit();
  wt::cp_async_wait<0>();
  __syncthreads();

  // warp w: output row y0 + w, pixels x0 .. x0 + 15 (a row past the image
  // computes on zeros and writes nothing)
  const int oy = y0 + warp;
  for (int m = 0; m < NW; ++m) {
    const float* w = m ? wb : wa;
    float* o = m ? ob : oa;
    for (int n0 = 0; n0 < CO4; n0 += F32_NC) {
      wt::WarpTile<float, F32_NC / 16> acc;
      acc.zero();
      for (int k = 0; k < 16; ++k) {
        const float* A = slab + ((warp + kPieceRow[k]) * SW + kPieceCol[k]) * ldx + (k & 3) * C;
        acc.mma(A, ldx, w + (size_t)k * C * CO4 + n0, CO4, C);
      }
      acc.store(cbuf, F32_LDC);
      __syncwarp();
      for (int e = lane; e < 16 * F32_NC; e += 32) {
        const int px = e / F32_NC, c = e % F32_NC, gx = x0 + px;
        if (oy < H2 && gx < W2)
          o[(((size_t)b * H2 + oy) * W2 + gx) * CO4 + n0 + c] = cbuf[px * F32_LDC + c];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

#include "tma_host.cuh"

namespace {

using sm90::encode_map;
using sm90::sm_count;

template <int NW>
int launch_tc(const void* x, const void* wa, const void* wb, void* oa, void* ob, int B, int H2,
              int W2, int C4, int CO4, cudaStream_t s) {
  CUtensorMap xmap, wamap, wbmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)C4, (cuuint64_t)W2, (cuuint64_t)H2, (cuuint64_t)B};
  const cuuint64_t wdims[2] = {(cuuint64_t)CO4, (cuuint64_t)4 * C4};
  const cuuint32_t xbox[4] = {64, SW, SH, 1}, wbox[2] = {64, TC_WBOX};
  if (!encode_map(&xmap, x, 4, xdims, xbox) || !encode_map(&wamap, wa, 2, wdims, wbox) ||
      !encode_map(&wbmap, wb, 2, wdims, wbox))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(C4, CO4, NW);
  cudaError_t err = cudaFuncSetAttribute(tap_conv_tc_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)B * ((H2 + TH - 1) / TH) * ((W2 + TW - 1) / TW);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  tap_conv_tc_kernel<NW><<<grid, TC_THREADS, smem, s>>>(
      xmap, wamap, wbmap, static_cast<bf16*>(oa), static_cast<bf16*>(ob), B, H2, W2, C4, CO4);
  return (int)cudaGetLastError();
}

template <int NW>
int launch_f32(const void* x, const void* wa, const void* wb, void* oa, void* ob, int B, int H2,
               int W2, int C4, int CO4, cudaStream_t s) {
  const size_t smem = f32_smem_bytes(C4);
  cudaError_t err = cudaFuncSetAttribute(tap_conv_f32_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W2 + TW - 1) / TW, (H2 + TH - 1) / TH, B);
  tap_conv_f32_kernel<NW><<<grid, F32_THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wa), static_cast<const float*>(wb),
      static_cast<float*>(oa), static_cast<float*>(ob), H2, W2, C4, CO4);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int H2, int W2, int C4, int CO4, int is_bf16, int NW) {
  if (B < 1 || H2 < 1 || W2 < 1 || C4 <= 0 || CO4 <= 0) return false;
  if (is_bf16)
    return C4 % 64 == 0 && CO4 % 128 == 0 && tc_smem_bytes(C4, CO4, NW) <= SMEM_LIMIT;
  return C4 % 4 == 0 && CO4 % F32_NC == 0 && f32_smem_bytes(C4) <= SMEM_LIMIT;
}

}  // namespace

// out = tap conv of x with w, on `stream`; returns the cudaError_t of the
// launch (0 on success). x (B,H2,W2,C4), w (4*C4, CO4), out (B,H2,W2,CO4),
// contiguous, 16-byte aligned, one type: bfloat16 (is_bf16 != 0) or float32.
extern "C" int tap_conv_launch(const void* x, const void* w, void* out, int B, int H2, int W2,
                               int C4, int CO4, int is_bf16, void* stream) {
  if (!shapes_ok(B, H2, W2, C4, CO4, is_bf16, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tc<1>(x, w, w, out, out, B, H2, W2, C4, CO4, s)
                 : launch_f32<1>(x, w, w, out, out, B, H2, W2, C4, CO4, s);
}

// (oa, ob) = the tap convs of x with wa and wb, off one staged slab.
extern "C" int tap_conv_pair_launch(const void* x, const void* wa, const void* wb, void* oa,
                                    void* ob, int B, int H2, int W2, int C4, int CO4, int is_bf16,
                                    void* stream) {
  if (!shapes_ok(B, H2, W2, C4, CO4, is_bf16, 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tc<2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4, s)
                 : launch_f32<2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4, s);
}
