// The composed head's two convolutions for Hopper (sm_90a): the CUDA
// counterpart of the TPU kernel diffusionremotesensing_tpu/ops/packed_head.py:
// packed_head (:133; _packed_head_kernel :117). For hh (B, H, W, C1), attn_s
// (B, H, W, C2) and HWIO kernels K4 (4, 4, C1, NO), K3 (3, 3, C2, NO)
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
// Design. The TPU kernel packed 8 vertically adjacent output pixels into
// its 128 lanes (12 output channels fill 9% of a lane row), a layout
// device of the TPU that is not carried over. Here a block owns an 8 x 16
// tile of output pixels; warp w computes output row w, its 16 pixels the 16
// rows of a WMMA A operand. Phase 1 copies the hh slab the tile reads (rows
// -1 .. +9, columns -1 .. +17, zero outside the image) into shared memory
// with cp.async, and K4 beside it with its NO columns padded to 16; each of
// the 16 window positions is a 16 x C1 block of the slab read in place (row
// stride one slab pixel) times a C1 x 16 block of K4. Phase 2 does the same
// for attn_s (rows -1 .. +8) and K3's 9 positions in the same buffers, on
// the same accumulator. bfloat16 runs on the tensor cores (WMMA 16x16x16),
// float32 as FMA on the CUDA cores (warp_tile.cuh). Shared memory: 99 KB in
// bfloat16 (two blocks an SM), 179 KB in float32.

#include "warp_tile.cuh"

namespace {

using wt::bf16;

constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int TW = 16;            // tile width: one warp's 16 A rows
constexpr int TH = NWARP;         // tile rows: one per warp
constexpr int NP = 16;            // output columns, NO padded to one WMMA tile
constexpr int LDC = NP + 4;       // row stride of a warp's float32 epilogue buffer

// Slab pixel stride (elements): bfloat16 keeps WMMA's 32-byte alignment
// (C % 16 == 0); both pads move neighbouring pixels to other banks.
template <typename T> __host__ __device__ constexpr int slab_ld(int C);
template <> __host__ __device__ constexpr int slab_ld<bf16>(int C) { return C + 16; }
template <> __host__ __device__ constexpr int slab_ld<float>(int C) { return C + 4; }

// Bytes of the slab buffer (the larger of the two phases' slabs) and of
// the weight buffer (the larger of K4 and K3, 16 columns), each rounded up
// to 128; then the warps' float32 epilogue buffers.
template <typename T> __host__ __device__ constexpr size_t slab_bytes(int C1, int C2) {
  return wt::align128(sizeof(T) * ((TH + 3) * (TW + 3) * slab_ld<T>(C1) >
                                           (TH + 2) * (TW + 2) * slab_ld<T>(C2)
                                       ? (TH + 3) * (TW + 3) * slab_ld<T>(C1)
                                       : (TH + 2) * (TW + 2) * slab_ld<T>(C2)));
}
template <typename T> __host__ __device__ constexpr size_t w_bytes(int C1, int C2) {
  return wt::align128(sizeof(T) * NP * (16 * C1 > 9 * C2 ? 16 * C1 : 9 * C2));
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
  for (int e = threadIdx.x; e < taps * C * NP; e += NTHREADS) {
    const int r = e / NP, o = e % NP;
    ws[e] = o < NO ? w[(size_t)r * NO + o] : wt::from_f<T>(0.f);
  }
}

// Grid (ceil(W/TW), ceil(H/TH), B), NTHREADS threads, dynamic shared memory
// smem_bytes<T>(C1, C2). Requires NO <= 16 and C1, C2 multiples of 16
// (bfloat16) or 4 (float32).
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
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  wt::WarpTile<T, 1> acc;
  acc.zero();

  // phase 1: hh's 4x4 window (slab (TH+3) x (TW+3)) against K4
  stage(slab, ws, hh + (size_t)b * H * W * C1, w4, y0, x0, TH + 3, TW + 3, H, W, C1, 16, NO);
  wt::cp_async_wait<0>();
  __syncthreads();
  {
    const int ld = slab_ld<T>(C1);
    for (int k = 0; k < 16; ++k)
      acc.mma(slab + ((warp + k / 4) * (TW + 3) + k % 4) * ld, ld, ws + (size_t)k * C1 * NP, NP,
              C1);
  }
  __syncthreads();

  // phase 2: attn_s's 3x3 window (slab (TH+2) x (TW+2)) against K3
  stage(slab, ws, at + (size_t)b * H * W * C2, w3, y0, x0, TH + 2, TW + 2, H, W, C2, 9, NO);
  wt::cp_async_wait<0>();
  __syncthreads();
  {
    const int ld = slab_ld<T>(C2);
    for (int k = 0; k < 9; ++k)
      acc.mma(slab + ((warp + k / 3) * (TW + 2) + k % 3) * ld, ld, ws + (size_t)k * C2 * NP, NP,
              C2);
  }

  // epilogue: warp w writes output row y0 + w (a row past the image
  // computed on zeros and writes nothing)
  acc.store(cbuf, LDC);
  __syncwarp();
  const int oy = y0 + warp;
  for (int e = lane; e < TW * NO; e += 32) {
    const int px = e / NO, o = e % NO, gx = x0 + px;
    if (oy < H && gx < W)
      out[(((size_t)b * H + oy) * W + gx) * NO + o] = wt::from_f<T>(cbuf[px * LDC + o]);
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T>
int launch(const void* hh, const void* at, const void* w4, const void* w3, void* out, int B,
           int H, int W, int C1, int C2, int NO, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(C1, C2);
  cudaError_t err = cudaFuncSetAttribute(packed_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
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
extern "C" int packed_head_launch(const void* hh, const void* at, const void* w4, const void* w3,
                                  void* out, int B, int H, int W, int C1, int C2, int NO,
                                  int is_bf16, void* stream) {
  const int unit = is_bf16 ? 16 : 4;
  if (B < 1 || H < 1 || W < 1 || NO < 1 || NO > NP || C1 < unit || C2 < unit || C1 % unit ||
      C2 % unit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(hh, at, w4, w3, out, B, H, W, C1, C2, NO, s)
                 : launch<float>(hh, at, w4, w3, out, B, H, W, C1, C2, NO, s);
}
