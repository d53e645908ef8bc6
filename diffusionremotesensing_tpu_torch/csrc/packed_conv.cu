// A direct 3x3 SAME convolution with bias for Hopper (sm_90a): the CUDA
// counterpart of the TPU kernel diffusionremotesensing_tpu/ops/packed_conv.py:
// packed_conv (:90; _packed_conv_kernel :53). For x (B, H, W, Ci), an HWIO
// kernel K (3, 3, Ci, Co), Co <= 64, and an optional bias (Co,)
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
// Design. The TPU kernel packed V vertically adjacent output rows into its
// lanes (Co = 64 fills half a lane row), a device of the TPU's layout that
// is not carried over. Here a block owns an 8 x 16 tile of output pixels and
// copies the x slab it reads (the tile plus a one-pixel halo, 10 x 18 pixels
// x Ci channels, zero outside the image) into shared memory once, with
// cp.async. Warp w computes output row w: its 16 pixels are the 16 rows of
// its A operand, and each of the 9 window positions is a 16 x Ci block of
// the slab read in place (row stride one slab pixel), so no im2col exists.
// The products are warp_tile.cuh's warp tiles, 16 pixels x Co columns:
// bfloat16 on the tensor cores (WMMA), float32 as FMA; K is read through the
// caches from device memory (221 KB at 192->64 in bfloat16, shared by every
// block). No copy/compute overlap yet, as in csrc/tap_conv.cu.

#include "warp_tile.cuh"

namespace {

using wt::bf16;

constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int TW = 16;            // tile width: one warp's 16 A rows
constexpr int TH = NWARP;         // tile rows: one per warp
constexpr int SW = TW + 2;        // x slab width (one-pixel halo)
constexpr int SH = TH + 2;        // x slab rows
constexpr int NCMAX = 64;         // output columns at most
constexpr int LDC = NCMAX + 4;    // row stride of a warp's float32 epilogue buffer

// Slab pixel stride (elements): bfloat16 keeps WMMA's 32-byte alignment
// (Ci % 16 == 0); both pads move neighbouring pixels to other banks.
template <typename T> __host__ __device__ constexpr int slab_ld(int C);
template <> __host__ __device__ constexpr int slab_ld<bf16>(int C) { return C + 16; }
template <> __host__ __device__ constexpr int slab_ld<float>(int C) { return C + 4; }

template <typename T> size_t smem_bytes(int Ci) {
  return wt::align128(sizeof(T) * SH * SW * slab_ld<T>(Ci)) + sizeof(float) * NWARP * 16 * LDC;
}

// Grid (ceil(W/TW), ceil(H/TH), B), NTHREADS threads, dynamic shared memory
// smem_bytes<T>(Ci). NF = Co / 16 column tiles. bias may be null. Requires
// Ci % 16 == 0 (bfloat16) or Ci % 4 == 0 (float32).
template <typename T, int NF>
__global__ void __launch_bounds__(NTHREADS)
packed_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int H, int W, int Ci) {
  constexpr int Co = 16 * NF;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = slab_ld<T>(Ci);
  T* slab = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* cbuf = reinterpret_cast<float*>(smem_raw + wt::align128(sizeof(T) * SH * SW * ld)) +
                warp * 16 * LDC;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const T* xb = x + (size_t)b * H * W * Ci;

  // the slab: x rows y0-1 .. y0+TH, columns x0-1 .. x0+TW, zero outside
  constexpr int V = wt::Vec<T>::N;
  const int units = Ci / V;
  for (int e = threadIdx.x; e < SH * SW * units; e += NTHREADS) {
    const int p = e / units, u = e % units;
    const int yy = y0 - 1 + p / SW, xx = x0 - 1 + p % SW;
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    wt::cp_async16(slab + p * ld + u * V, inside ? xb + ((size_t)yy * W + xx) * Ci + u * V : xb,
                   inside);
  }
  wt::cp_async_commit();
  wt::cp_async_wait<0>();
  __syncthreads();

  // warp w: output row y0 + w, pixels x0 .. x0 + 15 (a row past the image
  // computes on zeros and writes nothing)
  wt::WarpTile<T, NF> acc;
  acc.zero();
  for (int k = 0; k < 9; ++k)
    acc.mma(slab + ((warp + k / 3) * SW + k % 3) * ld, ld, w + (size_t)k * Ci * Co, Co, Ci);
  acc.store(cbuf, LDC);
  __syncwarp();
  const int oy = y0 + warp;
  for (int e = lane; e < TW * Co; e += 32) {
    const int px = e / Co, c = e % Co, gx = x0 + px;
    if (oy < H && gx < W) {
      const float v = cbuf[px * LDC + c] + (bias ? wt::to_f(bias[c]) : 0.f);
      out[(((size_t)b * H + oy) * W + gx) * Co + c] = wt::from_f<T>(v);
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T, int NF>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W, int Ci,
           cudaStream_t s) {
  const size_t smem = smem_bytes<T>(Ci);
  cudaError_t err = cudaFuncSetAttribute(packed_conv_kernel<T, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  packed_conv_kernel<T, NF><<<grid, NTHREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), H, W, Ci);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_co(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
              int Ci, int Co, cudaStream_t s) {
  switch (Co) {
    case 16: return launch<T, 1>(x, w, bias, out, B, H, W, Ci, s);
    case 32: return launch<T, 2>(x, w, bias, out, B, H, W, Ci, s);
    case 48: return launch<T, 3>(x, w, bias, out, B, H, W, Ci, s);
    case 64: return launch<T, 4>(x, w, bias, out, B, H, W, Ci, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out = conv(x, w, SAME) + bias on `stream`; returns the cudaError_t of the
// launch (0 on success). x (B,H,W,Ci), w (3,3,Ci,Co), bias (Co,) or null, out
// (B,H,W,Co), contiguous, one type: bfloat16 (is_bf16 != 0; Ci % 16 == 0) or
// float32 (Ci % 4 == 0); Co one of 16, 32, 48, 64.
extern "C" int packed_conv_launch(const void* x, const void* w, const void* bias, void* out, int B,
                                  int H, int W, int Ci, int Co, int is_bf16, void* stream) {
  const int unit = is_bf16 ? 16 : 4;
  if (B < 1 || H < 1 || W < 1 || Ci < unit || Ci % unit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_co<bf16>(x, w, bias, out, B, H, W, Ci, Co, s)
                 : launch_co<float>(x, w, bias, out, B, H, W, Ci, Co, s);
}
