// Host helpers for the launchers of the port's Hopper kernels (tap_conv.cu,
// dec_block.cu): the card's SM count, which sizes a persistent grid, and TMA
// tensor maps of bfloat16 tensors. Included below a source's host launcher
// line, so the CPU emulation never compiles it.
#pragma once

#include <cudaTypedefs.h>

namespace sm90 {

inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a contiguous bfloat16 tensor of `rank` dimensions (innermost first) read
// in boxes with the given swizzle, zero outside
inline bool encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  auto encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
