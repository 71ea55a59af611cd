// Shared helpers of the port's CUDA kernels: dtype codes (kept in step with
// DTYPE_CODES in kernels/_build.py), float conversions and the LOA combine.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I32 = 3 };

// The reference's masking sentinel: finite, so exp() stays defined on rows
// whose every score is masked.
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as XLA's and PyTorch's f32 -> bf16 conversion
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Lower-part-OR fold of two int32 words, the reference's _loa_combine
// (src/repro/kernels/loa_add.py:32-41): OR of the low l bits, AND of bit
// l-1 as carry-in, exact add of the high parts; l == 0 is the exact add.
// The right shifts stay on int (arithmetic, as jnp's >> on int32); the left
// shift and the adds run on unsigned words, so they wrap modulo 2**32 as
// XLA's int32 does, with no undefined behaviour. 0 <= l <= 31.
__device__ __forceinline__ int loa_fold(int x, int y, int l) {
  if (l == 0) return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
  const unsigned mask = (1u << l) - 1u;
  const unsigned low = (static_cast<unsigned>(x) & mask) | (static_cast<unsigned>(y) & mask);
  const int cin = ((x >> (l - 1)) & (y >> (l - 1))) & 1;
  const unsigned high = static_cast<unsigned>(x >> l) + static_cast<unsigned>(y >> l) +
                        static_cast<unsigned>(cin);
  return static_cast<int>((high << l) | low);
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
