// Fused decoder tail for Hopper (sm_90a): the CUDA counterpart of the TPU
// kernel diffusionremotesensing_tpu/ops/dec_block.py:dec_block (:178;
// _dec_kernel :132). On level 1 (s2d level 0's grid) it computes, with the
// UpConvBlock-2 BatchNorm folded into its conv by
// ops/dec_block.py:build_dec_weights,
//
//   h   = conv3x3(concat(xa, xb)) + ba          (stage-1 concat conv, 192 -> 64)
//   hh  = relu(conv3x3(h + te) + bb)            (UpConvBlock-2 body, 64 -> 64)
//   out = conv4x4(hh, head_up4, pad (1,2))      (composed head, 64 -> out4 = 12)
//
// and writes h (the gating branch reads it), hh's row 0 and column 0 (the
// head's boundary strips, applied outside as in the reference) and out.
// Products accumulate in float32; h, h + te, hh and out are rounded to the
// compute type where the reference kernel rounds them.
//
// What bounds it. At the main path's shape (B=48, 64x64) the three convs
// are 59.9 GFLOP (the composed head_up4 counted at the 25 of its 64
// sub-pixel taps that are not structural zeros), 61 us at the 989 TFLOP/s
// bf16 tensor rate, against 105 MB read and written once (xa, xb, h, out
// in bf16), 31 us at 3.35 TB/s: bound by operations.
//
// Design. The TPU kernel held a whole batch item in VMEM and packed 8 head
// rows into the lanes of the 12-channel output (a TPU lane device not
// carried over: out is written unpacked, (B, H, W, out4)). h must reach
// device memory anyway, so here it is the seam between two launches:
// * dec_concat_kernel: 128 consecutive output pixels a block; for each of
//   the 9 taps the shifted xa|xb rows (192 channels) and the tap's weight
//   rows are copied to shared memory with cp.async, the next tap's copies
//   in flight while the tensor cores work on this one (two buffers in
//   bf16; float32 has room for one);
// * dec_tail_kernel: a TILE x TILE output tile a block; it computes hh on
//   the tile plus the halo the 4x4 head reads (one row/column before, two
//   after: (TILE + 3)^2 pixels, zero outside the image) into shared memory,
//   staging round(h + te) tap by tap in 16-byte pieces, then runs the
//   head from that slab.
//   The halo costs 41% extra conv work at TILE 16; hh never reaches device
//   memory beyond its two strips.
// Every product is a warp tile of warp_tile.cuh: 8 warps x 16 pixels, bf16
// on the tensor cores (WMMA), float32 as FMA.

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
constexpr int NTHREADS = 256;
constexpr int MP = 128;       // pixels per pass: 8 warps x 16 rows
constexpr int TILE = 16;      // tail output tile edge
constexpr int SH = TILE + 3;  // hh slab edge
constexpr int NSH = SH * SH;
constexpr int LDK = CK + 8;   // shared-memory row strides (elements)
constexpr int LDM = CM + 8;
constexpr int LDC = CM + 4;   // float32 accumulator rows

template <typename T>
struct ConcatSmem {
  static constexpr int NSTAGE = sizeof(T) == 2 ? 2 : 1;  // buffers of each operand
  static constexpr size_t a_bytes = sizeof(T) * MP * LDK;
  static constexpr size_t b_bytes = sizeof(T) * CK * LDM;
  static constexpr size_t as = 0;                                        // [NSTAGE][MP][LDK]
  static constexpr size_t bs = wt::align128(as + NSTAGE * a_bytes);      // [NSTAGE][CK][LDM]
  static constexpr size_t cs = 0;  // [MP][LDC] float32, over the first A buffer after the last tap
  static constexpr size_t bytes = wt::align128(bs + NSTAGE * b_bytes);
  static_assert(sizeof(float) * MP * LDC <= a_bytes, "the accumulators must fit an A buffer");
};

template <typename T>
struct TailSmem {
  static constexpr size_t hhs = 0;                                          // [NSH][LDM]
  static constexpr size_t as = wt::align128(hhs + sizeof(T) * NSH * LDM);   // [MP][LDM]
  static constexpr size_t cs = wt::align128(as + sizeof(T) * MP * LDM);     // [MP][LDC]
  static constexpr size_t bytes = wt::align128(cs + sizeof(float) * MP * LDC);
};

// Copy tap `tap`'s operands into one buffer of each: the shifted xa|xb rows
// of the block's pixels (zero outside the image) and the tap's weight rows.
template <typename T>
__device__ __forceinline__ void concat_stage(T* A, T* Bt, const T* __restrict__ xa,
                                             const T* __restrict__ xb, const T* __restrict__ wa,
                                             long long p0, int tap, int B, int H, int W) {
  constexpr int V = wt::Vec<T>::N;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const long long total = (long long)B * H * W;
  for (int e = threadIdx.x; e < MP * (CK / V); e += NTHREADS) {
    const int r = e / (CK / V), u = e % (CK / V);
    const long long P = p0 + r;
    const T* src = xa;
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
  const T* w = wa + (size_t)tap * CK * CM;
  for (int e = threadIdx.x; e < CK * (CM / V); e += NTHREADS) {
    const int r = e / (CM / V), u = e % (CM / V);
    wt::cp_async16(Bt + r * LDM + u * V, w + (size_t)r * CM + u * V, true);
  }
  wt::cp_async_commit();
}

// Grid ceil(B*H*W / MP), NTHREADS threads, dynamic shared memory
// ConcatSmem<T>::bytes. wa: (9*CK, CM), rows (dy, dx, channel of xa|xb).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dec_concat_kernel(const T* __restrict__ xa, const T* __restrict__ xb, const T* __restrict__ wa,
                  const T* __restrict__ ba, T* __restrict__ h, int B, int H, int W) {
  using L = ConcatSmem<T>;
  constexpr int NS = L::NSTAGE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw + L::as);
  T* bs = reinterpret_cast<T*>(smem_raw + L::bs);
  float* cs = reinterpret_cast<float*>(smem_raw + L::cs);
  const long long total = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * MP;
  const int wrow = 16 * (threadIdx.x / 32);

  wt::WarpTile<T, 4> t;
  t.zero();
  concat_stage(as, bs, xa, xb, wa, p0, 0, B, H, W);
  for (int tap = 0; tap < 9; ++tap) {
    const int cur = tap % NS;
    if (NS == 2 && tap + 1 < 9) {  // the next tap's copies go out before this tap's products
      const int nxt = (tap + 1) % NS;
      concat_stage(as + nxt * MP * LDK, bs + nxt * CK * LDM, xa, xb, wa, p0, tap + 1, B, H, W);
      wt::cp_async_wait<1>();
    } else {
      wt::cp_async_wait<0>();
    }
    __syncthreads();
    t.mma(as + cur * MP * LDK + wrow * LDK, LDK, bs + cur * CK * LDM, LDM, CK);
    __syncthreads();
    if (NS == 1 && tap + 1 < 9) concat_stage(as, bs, xa, xb, wa, p0, tap + 1, B, H, W);
  }
  t.store(cs + wrow * LDC, LDC);
  __syncthreads();
  for (int e = threadIdx.x; e < MP * CM; e += NTHREADS) {
    const int r = e / CM, c = e % CM;
    const long long P = p0 + r;
    if (P < total) h[P * CM + c] = from_f<T>(cs[r * LDC + c] + to_f(ba[c]));
  }
}

// Grid (ceil(W/TILE), ceil(H/TILE), B), NTHREADS threads, dynamic shared
// memory TailSmem<T>::bytes. wb: (9*CM, CM) BN folded; k4k: (16*CM, NPAD).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dec_tail_kernel(const T* __restrict__ h, const T* __restrict__ te, const T* __restrict__ wb,
                const T* __restrict__ bb, const T* __restrict__ k4k, T* __restrict__ hr0,
                T* __restrict__ hc0, T* __restrict__ out, int H, int W) {
  using L = TailSmem<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hhs = reinterpret_cast<T*>(smem_raw + L::hhs);
  T* as = reinterpret_cast<T*>(smem_raw + L::as);
  float* cs = reinterpret_cast<float*>(smem_raw + L::cs);
  constexpr int V = wt::Vec<T>::N;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int wrow = 16 * (threadIdx.x / 32);
  const T* hb = h + (size_t)b * H * W * CM;

  // ---- phase A: hh on the slab (image origin (y0 - 1, x0 - 1))
  for (int p0 = 0; p0 < NSH; p0 += MP) {
    wt::WarpTile<T, 4> t;
    t.zero();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      for (int e = threadIdx.x; e < MP * (CM / V); e += NTHREADS) {
        const int r = e / (CM / V), u = e % (CM / V), q = p0 + r;
        const int y = y0 - 1 + q / SH + dy, x = x0 - 1 + q % SH + dx;
        alignas(16) T v[V];  // the conv's SAME padding of h + te: zero outside the image
        if (q < NSH && y >= 0 && y < H && x >= 0 && x < W) {
          const uint4 raw = *reinterpret_cast<const uint4*>(hb + ((size_t)y * W + x) * CM + u * V);
          const T* hv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = from_f<T>(to_f(hv[i]) + to_f(te[b * CM + u * V + i]));
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = from_f<T>(0.f);
        }
        *reinterpret_cast<uint4*>(as + r * LDM + u * V) = *reinterpret_cast<const uint4*>(v);
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
      const int y = y0 - 1 + q / SH, x = x0 - 1 + q % SH;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const T v = inside ? from_f<T>(fmaxf(cs[r * LDC + c] + to_f(bb[c]), 0.f)) : from_f<T>(0.f);
      hhs[q * LDM + c] = v;
      if (inside && y == 0 && x >= x0 && x < x0 + TILE) hr0[((size_t)b * W + x) * CM + c] = v;
      if (inside && x == 0 && y >= y0 && y < y0 + TILE) hc0[((size_t)b * H + y) * CM + c] = v;
    }
    __syncthreads();
  }

  // ---- phase B: out = conv4x4(hh, head_up4) on the tile, one tap at a time
  for (int p0 = 0; p0 < TILE * TILE; p0 += MP) {
    wt::WarpTile<T, 1> t;
    t.zero();
    for (int tap = 0; tap < 16; ++tap) {
      const int dy = tap / 4, dx = tap % 4;
      for (int e = threadIdx.x; e < MP * (CM / V); e += NTHREADS) {
        const int r = e / (CM / V), u = e % (CM / V), q = p0 + r;
        *reinterpret_cast<uint4*>(as + r * LDM + u * V) = *reinterpret_cast<const uint4*>(
            hhs + ((q / TILE + dy) * SH + q % TILE + dx) * LDM + u * V);
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
      if (y < H && x < W) out[(((size_t)b * H + y) * W + x) * OUT4 + c] = from_f<T>(cs[r * LDC + c]);
    }
    __syncthreads();
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T>
int launch(const void* const* p, void* const* o, int B, int H, int W, cudaStream_t s) {
  auto a = [&](int i) { return static_cast<const T*>(p[i]); };
  auto w = [&](int i) { return static_cast<T*>(o[i]); };
  const size_t s1 = ConcatSmem<T>::bytes, s2 = TailSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(dec_concat_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dec_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * H * W;
  dec_concat_kernel<T><<<(unsigned)((total + MP - 1) / MP), NTHREADS, s1, s>>>(
      a(0), a(1), a(2), a(3), w(0), B, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  dec_tail_kernel<T><<<grid, NTHREADS, s2, s>>>(w(0), a(4), a(5), a(6), a(7), w(1), w(2), w(3),
                                                H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch both kernels on `stream`; returns the first cudaError_t (0 on
// success). ins, contiguous and of one type (bfloat16 if is_bf16, else
// float32): xa (B,H,W,128), xb (B,H,W,64), wa (9*192, 64), ba (64),
// te (B,64), wb (9*64, 64), bb (64), k4k (16*64, 16) the head_up4 kernel
// with its 12 columns zero-padded to 16. outs: h (B,H,W,64),
// hh row 0 (B,1,W,64), hh column 0 (B,H,1,64), out (B,H,W,12).
extern "C" int dec_block_launch(const void* const* ins, void* const* outs, int B, int H, int W,
                                int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(ins, outs, B, H, W, s) : launch<float>(ins, outs, B, H, W, s);
}
