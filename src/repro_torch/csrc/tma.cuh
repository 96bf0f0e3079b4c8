// Host side of TMA, shared by the port's kernels: tensor maps
// (CUtensorMap) of bf16 tensors, made with cuTensorMapEncodeTiled, a
// driver API function reached through the runtime's entry-point query (the
// libraries link the runtime only).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                       cudaEnableDefault, &found) !=
      cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                              cudaEnableDefault, &found) != cudaSuccess)
    return nullptr;
#endif
  return found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(fn)
             : nullptr;
}

// the swizzle mode whose atom rows are `row_bytes` long (128, 64 or 32),
// the layout tc::Swz reads
inline CUtensorMapSwizzle swizzle(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// a bf16 tensor of `rank` dims (dims[0] innermost and contiguous, strides
// in bytes of dims 1 .. rank-1) read in swizzled boxes of `box`; boxes
// past the extent read zeros. False when the driver refuses the map.
inline bool bf16_map(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box, int row_bytes) {
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank),
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(row_bytes),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
