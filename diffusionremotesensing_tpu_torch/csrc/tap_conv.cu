// Tap-structured s2d 3x3 convolutions for Hopper (sm_90a): the CUDA
// counterparts of the TPU kernels diffusionremotesensing_tpu/ops/tap_conv.py:
// tap_conv (:126; _tap_conv_kernel :107) and tap_conv_pair (:156;
// _tap_conv_pair_kernel :114). Per s2d output pixel of x (B, H2, W2, 4C)
//
//   out = im2col4x4(x) @ W        (16C columns, W (16C, 4Co); the pair: Wa, Wb)
//
// where im2col4x4 concatenates the 16 pieces of ops/tap_conv.py:_ORDER, each
// the s2d input shifted by (row - 1, col - 1) pixels restricted to one tap
// block, zero outside the image (the 3x3 conv's SAME padding on the
// original grid). Products accumulate in float32; each output is rounded
// once to the input type, as the TPU kernel does.
//
// What bounds it. At the main path's shapes (B=48, 64x64 s2d pixels) the
// convolutions' own work, counted at full resolution (128x128 pixels,
// 3x3 taps), is conv2 32->32: 2*48*128*128*9*32*32 = 14.5 GFLOP, and the
// pair (conv1 and skip, 16->32 each) the same; the bytes are x read and the
// outputs written once: 100.7 MB (conv2) and 125.8 MB (the pair) in
// bfloat16. At 3.35 TB/s against 989 TFLOP/s bf16 both are bound by bytes
// (30 and 38 us). The tap formulation issues 1.78x the conv's products
// (structural zeros of the 4x4 window), still under the byte time.
//
// Design. The TPU kernel built the (H2*W2, 16C) im2col of one batch item in
// VMEM with 16 slice copies. Here no im2col exists at all: a block owns an
// 8 x 16 tile of output pixels and copies the x slab it reads (the tile
// plus a one-pixel halo, 10 x 18 pixels x 4C channels, zero outside the
// image) into shared memory once, with cp.async. Warp w computes output row
// w: the 16 pixels of the row are the 16 rows of its A operand, and each
// im2col piece is a 16 x C block of the slab read in place (row stride: one
// slab pixel), so a piece costs no copy. The pair runs both weight matrices
// over the same slab. Products are warp_tile.cuh's warp tiles, 16 pixels x
// 64 columns: bfloat16 on the tensor cores (WMMA), float32 as FMA; the
// weights are read through the caches from device memory (a W is 128 KB
// at the main path's widths, shared by every block). No copy/compute
// overlap yet.

#include "warp_tile.cuh"

namespace {

using wt::bf16;

constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int TW = 16;            // tile width: one warp's 16 A rows
constexpr int TH = NWARP;         // tile rows: one per warp
constexpr int SW = TW + 2;        // x slab width (one-pixel halo)
constexpr int SH = TH + 2;        // x slab rows
constexpr int NC = 64;            // output columns per warp tile
constexpr int LDC = NC + 4;       // row stride of a warp's float32 epilogue buffer

// im2col piece table, in the order of ops/tap_conv.py:_ORDER: piece k reads
// the s2d input shifted by (row - 1, col - 1) pixels, tap block k % 4.
__constant__ int kPieceRow[16] = {1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 1, 1, 2, 2, 1, 1};
__constant__ int kPieceCol[16] = {1, 0, 1, 0, 2, 1, 2, 1, 1, 0, 1, 0, 2, 1, 2, 1};

// Slab pixel stride (elements): bfloat16 keeps WMMA's 32-byte alignment
// (C4 % 64 == 0, so C4 + 16 is a multiple of 16); both pads move
// neighbouring pixels to other banks.
template <typename T> __host__ __device__ constexpr int slab_ld(int C4);
template <> __host__ __device__ constexpr int slab_ld<bf16>(int C4) { return C4 + 16; }
template <> __host__ __device__ constexpr int slab_ld<float>(int C4) { return C4 + 4; }

template <typename T> size_t smem_bytes(int C4) {
  return wt::align128(sizeof(T) * SH * SW * slab_ld<T>(C4)) + sizeof(float) * NWARP * 16 * LDC;
}

// Grid (ceil(W2/TW), ceil(H2/TH), B), NTHREADS threads, dynamic shared
// memory smem_bytes<T>(C4). NW weight matrices (1 or 2), each (16C, CO4),
// each with its output (B, H2, W2, CO4). Requires CO4 % 64 == 0 and, for
// bfloat16, C4 % 64 == 0 (float32: C4 % 4 == 0).
template <typename T, int NW>
__global__ void __launch_bounds__(NTHREADS)
tap_conv_kernel(const T* __restrict__ x, const T* __restrict__ wa, const T* __restrict__ wb,
                T* __restrict__ oa, T* __restrict__ ob, int H2, int W2, int C4, int CO4) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = slab_ld<T>(C4);
  T* slab = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* cbuf = reinterpret_cast<float*>(smem_raw + wt::align128(sizeof(T) * SH * SW * ldx)) +
                warp * 16 * LDC;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int C = C4 / 4;
  const T* xb = x + (size_t)b * H2 * W2 * C4;

  // the slab: x rows y0-1 .. y0+TH, columns x0-1 .. x0+TW, zero outside
  constexpr int V = wt::Vec<T>::N;
  const int units = C4 / V;
  for (int e = threadIdx.x; e < SH * SW * units; e += NTHREADS) {
    const int p = e / units, u = e % units;
    const int yy = y0 - 1 + p / SW, xx = x0 - 1 + p % SW;
    const bool inside = yy >= 0 && yy < H2 && xx >= 0 && xx < W2;
    wt::cp_async16(slab + p * ldx + u * V, inside ? xb + ((size_t)yy * W2 + xx) * C4 + u * V : xb,
                   inside);
  }
  wt::cp_async_commit();
  wt::cp_async_wait<0>();
  __syncthreads();

  // warp w: output row y0 + w, pixels x0 .. x0 + 15 (a row past the image
  // computes on zeros and writes nothing)
  const int oy = y0 + warp;
  for (int m = 0; m < NW; ++m) {
    const T* w = m ? wb : wa;
    T* o = m ? ob : oa;
    for (int n0 = 0; n0 < CO4; n0 += NC) {
      wt::WarpTile<T, NC / 16> acc;
      acc.zero();
      for (int k = 0; k < 16; ++k) {
        const T* A = slab + ((warp + kPieceRow[k]) * SW + kPieceCol[k]) * ldx + (k & 3) * C;
        acc.mma(A, ldx, w + (size_t)k * C * CO4 + n0, CO4, C);
      }
      acc.store(cbuf, LDC);
      __syncwarp();
      for (int e = lane; e < 16 * NC; e += 32) {
        const int px = e / NC, c = e % NC, gx = x0 + px;
        if (oy < H2 && gx < W2)
          o[(((size_t)b * H2 + oy) * W2 + gx) * CO4 + n0 + c] = wt::from_f<T>(cbuf[px * LDC + c]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes)

namespace {

template <typename T, int NW>
int launch(const void* x, const void* wa, const void* wb, void* oa, void* ob, int B, int H2,
           int W2, int C4, int CO4, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(C4);
  cudaError_t err = cudaFuncSetAttribute(tap_conv_kernel<T, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W2 + TW - 1) / TW, (H2 + TH - 1) / TH, B);
  tap_conv_kernel<T, NW><<<grid, NTHREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wa), static_cast<const T*>(wb),
      static_cast<T*>(oa), static_cast<T*>(ob), H2, W2, C4, CO4);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int H2, int W2, int C4, int CO4, int is_bf16) {
  return B >= 1 && H2 >= 1 && W2 >= 1 && CO4 % NC == 0 && C4 % (is_bf16 ? 64 : 4) == 0 &&
         C4 > 0 && CO4 > 0;
}

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" size_t tap_conv_smem(int C4, int is_bf16) {
  return is_bf16 ? smem_bytes<bf16>(C4) : smem_bytes<float>(C4);
}

// out = tap conv of x with w, on `stream`; returns the cudaError_t of the
// launch (0 on success). x (B,H2,W2,C4), w (4*C4, CO4), out (B,H2,W2,CO4),
// contiguous, one type: bfloat16 (is_bf16 != 0) or float32.
extern "C" int tap_conv_launch(const void* x, const void* w, void* out, int B, int H2, int W2,
                               int C4, int CO4, int is_bf16, void* stream) {
  if (!shapes_ok(B, H2, W2, C4, CO4, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16, 1>(x, w, w, out, out, B, H2, W2, C4, CO4, s)
                 : launch<float, 1>(x, w, w, out, out, B, H2, W2, C4, CO4, s);
}

// (oa, ob) = the tap convs of x with wa and wb, off one staged slab.
extern "C" int tap_conv_pair_launch(const void* x, const void* wa, const void* wb, void* oa,
                                    void* ob, int B, int H2, int W2, int C4, int CO4, int is_bf16,
                                    void* stream) {
  if (!shapes_ok(B, H2, W2, C4, CO4, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16, 2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4, s)
                 : launch<float, 2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4, s);
}
