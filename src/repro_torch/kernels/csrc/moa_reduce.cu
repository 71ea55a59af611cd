// moa_reduce: the blocked multi-operand adder (n, f) -> (f,), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/moa_reduce.py: moa_reduce_pallas
// (body _moa_reduce_kernel): each block_n-row cluster is tree-summed and the
// cluster sums are accumulated in cluster order -- f32 for f32 / bf16
// operands, int32 (wrapping) for int8 / int32 operands. A ragged last
// cluster is summed as it stands (the Pallas wrapper zero-pads, which adds
// exact zeros).
//
// Design and bound: cluster_reduce.cuh (two passes: segment sums in
// parallel, then one ordered fold per column). Bound by reading x once.
// Launch counting is done by the Python wrapper (kernels/moa_reduce.py).

#include "cluster_reduce.cuh"

namespace {

struct Add {
  template <typename Acc>
  __device__ static __forceinline__ Acc apply(Acc acc, Acc part, int) {
    return cluster::add<Acc>(acc, part);
  }
};

}  // namespace

// C entry point. x (n, f) contiguous row-major; scratch holds
// ceil(n / block_n) * ceil(block_n / 64) * f accumulator values (f32 or
// int32); out (f,) f32 for float operands, int32 for integer ones.
extern "C" int repro_moa_reduce(const void* x, void* scratch, void* out, long long n, int f,
                                int block_n, int in_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f <= 0 || block_n <= 0) return cudaErrorInvalidValue;
  switch (in_dtype) {
    case DT_F32: return cluster::reduce<float, float, Add>(x, scratch, out, n, f, block_n, 0, st);
    case DT_BF16:
      return cluster::reduce<__nv_bfloat16, float, Add>(x, scratch, out, n, f, block_n, 0, st);
    case DT_I8: return cluster::reduce<int8_t, int, Add>(x, scratch, out, n, f, block_n, 0, st);
    case DT_I32: return cluster::reduce<int, int, Add>(x, scratch, out, n, f, block_n, 0, st);
    default: return cudaErrorInvalidValue;
  }
}
