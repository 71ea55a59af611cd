// The Lower-part-OR adder kernels (paper §3.2, Fig. 3), for sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/loa_add.py:
//
//  * loa_add_pallas (body _loa_add_kernel): element-wise LOA of two int32
//    arrays. Here a grid-stride pass in which each thread takes four
//    neighbouring words with one 16-byte load per operand (int4) when all
//    three pointers are 16-byte aligned, and masks the ragged tail word by
//    word. Bound by the bytes: two int32 reads and one write per element.
//  * loa_reduce_pallas (body _loa_reduce_kernel): the approximate serialized
//    MOA (n, f) -> (f,) int32 -- each block_n-row cluster summed exactly
//    (wrapping), the cluster sums folded in cluster order through the LOA
//    combine. n is a multiple of block_n (checked by the wrapper, as the
//    Pallas wrapper does). One launch: cluster_reduce.cuh. Bound by reading
//    x once, and for l > 0 by the fold chain of n / block_n dependent LOA
//    folds a column; at l = 0 the fold is the exact add, and the rows split
//    freely (the assoc route).
//
// Both use loa_fold (common.cuh), the dot_moa kernel's fold too. Launch
// counting is done by the Python wrapper (kernels/loa_add.py).

#include <algorithm>

#include "cluster_reduce.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int4 loa4(int4 a, int4 b, int l) {
  return make_int4(loa_fold(a.x, b.x, l), loa_fold(a.y, b.y, l), loa_fold(a.z, b.z, l),
                   loa_fold(a.w, b.w, l));
}

__global__ void __launch_bounds__(kThreads)
loa_add_kernel(const int* __restrict__ x, const int* __restrict__ y, int* __restrict__ out,
               long long n, int l, bool aligned) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; 4 * t < n;
       t += stride) {
    const long long i = 4 * t;
    if (aligned && i + 4 <= n) {
      reinterpret_cast<int4*>(out)[t] =
          loa4(reinterpret_cast<const int4*>(x)[t], reinterpret_cast<const int4*>(y)[t], l);
    } else {
      for (long long k = i; k < min(i + 4, n); ++k) out[k] = loa_fold(x[k], y[k], l);
    }
  }
}

struct LOA {
  __device__ static __forceinline__ int apply(int acc, int part, int l) {
    return loa_fold(acc, part, l);
  }
};

template <int VEC>
__global__ void __launch_bounds__(cluster::kThreads, cluster::kMinBlocks)
loa_reduce_kernel(const cluster::Params p) {
  cluster::reduce<int, int, LOA, VEC>(p);
}

}  // namespace

// x, y, out: n contiguous int32 words. 0 <= approx_bits <= 31.
extern "C" int repro_loa_add(const void* x, const void* y, void* out, long long n,
                             int approx_bits, void* stream) {
  if (n <= 0 || approx_bits < 0 || approx_bits > 31) return cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long words4 = (n + 3) / 4;
  const long long blocks = std::min((words4 + kThreads - 1) / kThreads, 132LL * 16);
  loa_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(y), static_cast<int*>(out), n,
      approx_bits, aligned);
  return cudaGetLastError();
}

// x (n, f) int32 contiguous, n % block_n == 0; ws, tickets and plan as
// repro_moa_reduce's (moa_reduce.cu), approx_bits in the plan; out (f,) int32.
extern "C" int repro_loa_reduce(const void* x, void* ws, void* tickets, void* out,
                                const long long* plan, void* stream) {
  const cluster::Launch l = cluster::launch_of(x, ws, tickets, out, plan);
  if (!cluster::valid(l)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l.vec == 4) return cluster::run(loa_reduce_kernel<4>, l, st);
  if (l.vec == 1) return cluster::run(loa_reduce_kernel<1>, l, st);
  return cudaErrorInvalidValue;
}
