// Fused stage-2 attention gate and head_at conv for Hopper (sm_90a): the
// CUDA counterpart of the TPU kernel diffusionremotesensing_tpu/ops/
// att_block.py:att_head_block (:155; _att_head_kernel :107). Per s2d pixel
// of the level-0 skip x (4C = 128 channels) and the stage-1 output h
// (Ch = 64 channels) it computes, with the BatchNorms folded into the
// weights by ops/att_block.py:build_att_weights,
//
//   g      = relu(h @ gw + gb)                     (gating signal 2, 64 -> 32)
//   a      = relu(g @ wg + bg + x @ wx + bx)       (w_g and w_x, -> 32)
//   psi    = sigmoid(a @ wpsi + bpsi)              (one channel)
//   gated  = x * psi
//   attn_s = gated @ rc + brc                      (block-diagonal result conv)
//   out    = conv3x3_SAME(attn_s, head_at)         (-> out4 = 12 channels)
//
// Products accumulate in float32; g, a, psi, gated, attn_s and out are
// rounded to the compute type where the reference kernel rounds them.
//
// What bounds it. At the main path's shape (B=48, 64x64 s2d pixels) the
// function reads x and h and writes out once: 80.2 MB in bfloat16, 24 us at
// 3.35 TB/s; its products, the model's layers at their own resolution
// (the s2d forms' structural zeros not counted), are 5.8 GFLOP, 6 us at
// the 989 TFLOP/s bf16 tensor rate (87 us at the 67 TFLOP/s float32
// rate). So in bf16 it is bound by bytes, and the design's aim is that
// attn_s, which the unfused chain writes and reads back (50 MB in bf16),
// never reaches device memory.
//
// Design. The TPU kernel held one whole batch item in VMEM and packed 8
// output rows into the lanes of the 12-channel head (a TPU lane device not
// carried over: here the head's contribution is written unpacked,
// (B, H, W, out4)). Here a block owns a TILE x TILE output tile and first
// computes attn_s on the tile plus its one-pixel halo (the head's SAME
// padding), in passes of 128 pixels through shared memory, keeping the
// (TILE + 2)^2 x 128 attn_s slab there; attn_s outside the image is zero.
// Then it runs the 3x3 head from the slab, one tap at a time. Every product
// is a warp tile of warp_tile.cuh: 8 warps x 16 pixels, bf16 on the tensor
// cores (WMMA), float32 as FMA. The halo costs (TILE+2)^2 / TILE^2 of the
// gate's work: 27% at TILE 16 (bf16), 56% at TILE 8 (float32, whose slab
// would not fit shared memory at 16). One block per SM; no copy/compute
// overlap yet.

#include "warp_tile.cuh"

namespace {

using wt::bf16;
using wt::from_f;
using wt::round_to;
using wt::to_f;

constexpr int C4 = 128;     // x channels (4 taps x 32)
constexpr int C = 32;       // gate width
constexpr int CH = 64;      // h channels
constexpr int OUT4 = 12;    // head channels written
constexpr int NPAD = 16;    // head columns computed (the weight is zero-padded to 16)
constexpr int NTHREADS = 256;
constexpr int MP = 128;     // pixels per pass: 8 warps x 16 rows
// row strides (elements) of the shared-memory buffers: multiples of 8 that
// move consecutive rows to other banks
constexpr int LDX = C4 + 8;
constexpr int LDH = CH + 8;
constexpr int LDG = C + 8;
constexpr int LDC = 64 + 4;  // float32 accumulator rows: up to 64 columns a product

template <typename T, int TILE>
struct Smem {
  static constexpr int S = TILE + 2;        // attn_s slab edge
  static constexpr int NS = S * S;
  static constexpr size_t ats = 0;                                        // [NS][LDX]  attn_s
  static constexpr size_t xs = wt::align128(ats + sizeof(T) * NS * LDX);  // [MP][LDX]  x, gated, head im2col
  static constexpr size_t hs = wt::align128(xs + sizeof(T) * MP * LDX);   // [MP][LDH]  h
  static constexpr size_t gs = wt::align128(hs + sizeof(T) * MP * LDH);   // [MP][LDG]  g, then a
  static constexpr size_t cs = wt::align128(gs + sizeof(T) * MP * LDG);   // [MP][LDC]  float32
  static constexpr size_t ps = wt::align128(cs + sizeof(float) * MP * LDC);  // [MP] psi
  static constexpr size_t bytes = wt::align128(ps + sizeof(float) * MP);
};

// Copy `cols` channels of pixel (b, y, x) of a (B, H, W, cols) tensor to
// row r of dst, in 16-byte pieces; zero when the pixel is outside the image
// or `valid` is false. Piece e of the row is handled by thread e mod NTHREADS.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int cols,
                                           int b, int H, int W, int p0, int np, int S, int oy,
                                           int ox) {
  constexpr int V = wt::Vec<T>::N;
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
// memory Smem<T, TILE>::bytes.
template <typename T, int TILE>
__global__ void __launch_bounds__(NTHREADS, 1)
att_head_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ gw,
                const T* __restrict__ gb, const T* __restrict__ wg, const T* __restrict__ bg,
                const T* __restrict__ wx, const T* __restrict__ bx, const T* __restrict__ wpsi,
                const T* __restrict__ bpsi, const T* __restrict__ rc, const T* __restrict__ brc,
                const T* __restrict__ atk, T* __restrict__ out, int H, int W) {
  using L = Smem<T, TILE>;
  constexpr int S = L::S, NS = L::NS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ats = reinterpret_cast<T*>(smem_raw + L::ats);
  T* xs = reinterpret_cast<T*>(smem_raw + L::xs);
  T* hs = reinterpret_cast<T*>(smem_raw + L::hs);
  T* gs = reinterpret_cast<T*>(smem_raw + L::gs);
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
      wt::WarpTile<T, 2> t;
      t.zero();
      t.mma(hs + wrow * LDH, LDH, gw, C, CH);
      t.store(cs + wrow * LDC, LDC);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MP * C; e += NTHREADS) {
      const int r = e / C, c = e % C;
      gs[r * LDG + c] = from_f<T>(fmaxf(cs[r * LDC + c] + to_f(gb[c]), 0.f));
    }
    __syncthreads();
    {  // a = relu(g @ wg + x @ wx + bg + bx)
      wt::WarpTile<T, 2> t;
      t.zero();
      t.mma(gs + wrow * LDG, LDG, wg, C, C);
      t.mma(xs + wrow * LDX, LDX, wx, C, C4);
      t.store(cs + wrow * LDC, LDC);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MP * C; e += NTHREADS) {
      const int r = e / C, c = e % C;
      gs[r * LDG + c] = from_f<T>(fmaxf(cs[r * LDC + c] + to_f(bg[c]) + to_f(bx[c]), 0.f));
    }
    __syncthreads();
    for (int r = threadIdx.x; r < MP; r += NTHREADS) {  // psi = sigmoid(a @ wpsi + bpsi)
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < C; ++c) s = fmaf(to_f(gs[r * LDG + c]), to_f(wpsi[c]), s);
      s += to_f(bpsi[0]);
      ps[r] = round_to<T>(1.f / (1.f + expf(-s)));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MP * C4; e += NTHREADS) {  // gated = x * psi, in place
      const int r = e / C4, c = e % C4;
      xs[r * LDX + c] = from_f<T>(to_f(xs[r * LDX + c]) * ps[r]);
    }
    __syncthreads();
    for (int n0 = 0; n0 < C4; n0 += 64) {  // attn_s = gated @ rc + brc, 64 columns at a time
      {
        wt::WarpTile<T, 4> t;
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
        ats[q * LDX + n0 + c] =
            inside ? from_f<T>(cs[r * LDC + c] + to_f(brc[n0 + c])) : from_f<T>(0.f);
      }
      __syncthreads();
    }
  }

  // ---- phase B: out = conv3x3(attn_s, head_at) on the tile, one tap at a
  // time: the tap's shifted attn_s rows are staged into xs
  constexpr int V = wt::Vec<T>::N;
  for (int p0 = 0; p0 < TILE * TILE; p0 += MP) {
    wt::WarpTile<T, 1> t;
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
        out[(((size_t)b * H + y) * W + xx) * OUT4 + c] = from_f<T>(cs[r * LDC + c]);
    }
    __syncthreads();
  }
}

// the tile edge of each type: the float32 slab at 16 would not fit
template <typename T> struct Tile { static constexpr int value = 16; };
template <> struct Tile<float> { static constexpr int value = 8; };

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T>
int launch(const void* const* p, void* out, int B, int H, int W, cudaStream_t s) {
  constexpr int TILE = Tile<T>::value;
  const size_t smem = Smem<T, TILE>::bytes;
  cudaError_t err = cudaFuncSetAttribute(att_head_kernel<T, TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  auto a = [&](int i) { return static_cast<const T*>(p[i]); };
  att_head_kernel<T, TILE><<<grid, NTHREADS, smem, s>>>(
      a(0), a(1), a(2), a(3), a(4), a(5), a(6), a(7), a(8), a(9), a(10), a(11), a(12),
      static_cast<T*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// ptrs, all contiguous and of one type (bfloat16 if is_bf16, else float32):
// x (B,H,W,128), h (B,H,W,64), gw (64,32), gb (32), wg (32,32), bg (32),
// wx (128,32), bx (32), wpsi (32), bpsi (1), rc (128,128), brc (128),
// atk (9*128, 16) the head_at kernel with its 12 columns zero-padded to 16.
// out: (B,H,W,12).
extern "C" int att_head_block_launch(const void* const* ptrs, void* out, int B, int H, int W,
                                     int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(ptrs, out, B, H, W, s) : launch<float>(ptrs, out, B, H, W, s);
}
