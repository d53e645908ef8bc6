// Pieces shared by the port's kernels for the s2d decoder tail
// (att_head_block.cu, dec_block.cu): conversions between the compute type
// and float32, and the warp-level tile product both kernels are built from.
//
// WarpTile<T, NF>: one warp owns a 16 x (16 NF) float32 accumulator and adds
// A (16 rows x kn, row-major in shared memory, leading dimension lda) times
// B (kn x 16 NF, row-major, leading dimension ldb; a weight matrix in shared
// memory, or read through the caches from device memory). bfloat16 runs on the tensor cores
// through WMMA 16x16x16 tiles; float32 runs as FMA on the CUDA cores over
// the same operands, so one kernel source serves both types. store() writes
// the accumulator to a row-major float32 buffer (leading dimension ldc) for
// the block's elementwise epilogue.
//
// WMMA needs 32-byte aligned tile pointers and leading dimensions that are
// multiples of 8 elements (16 bytes): callers keep lda/ldb multiples of 8,
// ldc a multiple of 4, k offsets multiples of 16 and buffers 128-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace wt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded to T and read back: the points where the reference rounds to
// the compute type
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 16-byte copies of rows of T (16 / sizeof(T) elements each)
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T, int NF> struct WarpTile;

template <int NF> struct WarpTile<bf16, NF> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[NF];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NF; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.f);
  }

  __device__ __forceinline__ void mma(const bf16* A, int lda, const bf16* B, int ldb, int kn) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    for (int k = 0; k < kn; k += 16) {
      wmma::load_matrix_sync(a, A + k, lda);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::load_matrix_sync(b, B + (size_t)k * ldb + 16 * j, ldb);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      nvcuda::wmma::store_matrix_sync(C + 16 * j, acc[j], ldc, nvcuda::wmma::mem_row_major);
  }
};

// float32: lane (rg, cg) = (lane / 8, lane % 8) owns rows 4 rg .. 4 rg + 3
// and columns 2 NF cg .. 2 NF cg + 2 NF - 1 of the warp's tile
template <int NF> struct WarpTile<float, NF> {
  float acc[4][2 * NF];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NF; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb, int kn) {
    const int lane = threadIdx.x % 32;
    const int r0 = 4 * (lane / 8), c0 = 2 * NF * (lane % 8);
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      float a[4], b[2 * NF];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 2 * NF; ++j) b[j] = B[(size_t)k * ldb + c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NF; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) {
    const int lane = threadIdx.x % 32;
    const int r0 = 4 * (lane / 8), c0 = 2 * NF * (lane % 8);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NF; ++j) C[(r0 + i) * ldc + c0 + j] = acc[i][j];
  }
};

// cp.async (sm_80 and later): 16-byte copies from device memory to shared
// memory that run on while the block computes; a copy whose source is not
// valid writes 16 zero bytes. commit() closes a group of copies, wait<N>()
// waits until at most N groups are still in flight (then a __syncthreads
// makes the data visible to the whole block). Read by a host compiler (the
// tests' CPU emulation), they are plain synchronous copies.
#if defined(__CUDACC__)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#else
inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
#endif

// Offset of the next shared-memory buffer: `bytes` rounded up to 128.
__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace wt
