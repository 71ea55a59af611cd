// moa_reduce: the blocked multi-operand adder (n, f) -> (f,), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/moa_reduce.py: moa_reduce_pallas
// (body _moa_reduce_kernel): each block_n-row cluster is tree-summed and the
// cluster sums are accumulated in cluster order -- f32 for f32 / bf16
// operands, int32 (wrapping) for int8 / int32 operands. A ragged last
// cluster is summed as it stands (the Pallas wrapper zero-pads, which adds
// exact zeros).
//
// Bound on the H100: reading x once (bytes / 3.35 TB/s); on the ordered
// route (f32 accumulation over several clusters) also the fold chain of
// n / block_n dependent f32 adds a column. Integer sums take the assoc
// route: a wrapping int32 sum has the same bits in any order, so the rows
// split freely over the card. Design: cluster_reduce.cuh (one launch, 16-byte
// loads, the last block of a column tile folds the partials in order).
// Launch counting is done by the Python wrapper (kernels/moa_reduce.py).

#include "cluster_reduce.cuh"

namespace {

struct Add {
  template <typename Acc>
  __device__ static __forceinline__ Acc apply(Acc acc, Acc part, int) {
    return cluster::add<Acc>(acc, part);
  }
};

template <typename T, typename Acc, int VEC>
__global__ void __launch_bounds__(cluster::kThreads, cluster::kMinBlocks)
moa_reduce_kernel(const cluster::Params p) {
  cluster::reduce<T, Acc, Add, VEC>(p);
}

template <typename T, typename Acc>
cudaError_t launch(const cluster::Launch& l, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (l.vec == kVec) return cluster::run(moa_reduce_kernel<T, Acc, kVec>, l, stream);
  if (l.vec == 1) return cluster::run(moa_reduce_kernel<T, Acc, 1>, l, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point. x (n, f) contiguous row-major; ws and tickets: the plan's
// workspace (null where it has one split) and its tickets, all 0; out (f,)
// f32 for float operands, int32 for integer ones; plan: cluster::kArgs
// values (kernels/moa_reduce.py:Plan.c_args).
extern "C" int repro_moa_reduce(const void* x, void* ws, void* tickets, void* out,
                                const long long* plan, int in_dtype, void* stream) {
  const cluster::Launch l = cluster::launch_of(x, ws, tickets, out, plan);
  if (!cluster::valid(l) || l.p.approx_bits != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case DT_F32: return launch<float, float>(l, st);
    case DT_BF16: return launch<__nv_bfloat16, float>(l, st);
    case DT_I8: return launch<int8_t, int>(l, st);
    case DT_I32: return launch<int, int>(l, st);
    default: return cudaErrorInvalidValue;
  }
}
