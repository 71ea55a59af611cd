// Cluster-serial column reduction (n, f) -> (f,), shared by moa_reduce.cu and
// loa_add.cu (loa_reduce).
//
// The TPU kernels (moa_reduce_pallas, loa_reduce_pallas) walk the operand
// axis in block_n-row clusters on the sequential trailing grid axis: each
// cluster is tree-summed, and the cluster sums are folded in cluster order
// into one accumulator held in VMEM (by +, or by the LOA combine). CUDA
// blocks run in no order, so the same schedule takes two passes:
//
//   pass 1, segment_sums: one block per (32 columns, segment), where a
//     segment is kSegRows rows inside one cluster (segments never cross a
//     cluster boundary; a ragged last cluster has short or empty segments,
//     which add exact zeros). 8 row lanes per column sum every 8th row, then
//     a shared-memory tree joins the 8 lanes. Enough blocks to cover the
//     card at the paper's shapes (4096 x 256 f32: 512 blocks).
//   pass 2, fold_clusters: one block per 32 columns walks the clusters in
//     order; the 8 lanes tree-sum the cluster's segment sums, and lane 0
//     folds that cluster sum into its accumulator register. For the LOA
//     fold this order is the contract (LOA is not associative).
//
// Bound on the H100: reading x once (bytes / 3.35 TB/s); the scratch of
// segment sums is n/kSegRows rows of f, 1/64 of x in f32.

#pragma once

#include <algorithm>

#include "common.cuh"

namespace cluster {

// rows per segment; kernels/moa_reduce.py keeps the same value (SEG_ROWS)
constexpr int kSegRows = 64;
constexpr int kLanes = 8;    // row lanes per column
constexpr int kCols = 32;    // columns per block (one warp wide)

template <typename Acc> __device__ __forceinline__ Acc add(Acc a, Acc b);
template <> __device__ __forceinline__ float add<float>(float a, float b) { return a + b; }
// int32 sums wrap modulo 2**32 (unsigned arithmetic: no undefined behaviour)
template <> __device__ __forceinline__ int add<int>(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <typename T, typename Acc> __device__ __forceinline__ Acc to_acc(T x);
template <> __device__ __forceinline__ float to_acc<float, float>(float x) { return x; }
template <> __device__ __forceinline__ float to_acc<__nv_bfloat16, float>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ int to_acc<int8_t, int>(int8_t x) { return x; }
template <> __device__ __forceinline__ int to_acc<int, int>(int x) { return x; }

// tree over the kLanes row lanes of red[][tx]; the result is in red[0][tx]
template <typename Acc>
__device__ __forceinline__ void lane_tree(Acc (*red)[kCols + 1], int tx, int ty) {
#pragma unroll
  for (int w = kLanes / 2; w > 0; w >>= 1) {
    if (ty < w) red[ty][tx] = add<Acc>(red[ty][tx], red[ty + w][tx]);
    __syncthreads();
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kCols * kLanes)
segment_sums(const T* __restrict__ x, Acc* __restrict__ seg, long long n, int f, int block_n,
             int segs_per_cluster, long long n_segs) {
  __shared__ Acc red[kLanes][kCols + 1];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + tx;
  for (long long s = blockIdx.y; s < n_segs; s += gridDim.y) {
    const long long c = s / segs_per_cluster, j = s % segs_per_cluster;
    const long long c0 = c * block_n;
    const long long r0 = c0 + j * kSegRows;
    const long long r1 = min(min(r0 + kSegRows, c0 + block_n), n);
    Acc v = Acc(0);
    if (col < f) {
#pragma unroll 4
      for (long long r = r0 + ty; r < r1; r += kLanes) v = add<Acc>(v, to_acc<T, Acc>(x[r * f + col]));
    }
    red[ty][tx] = v;
    __syncthreads();
    lane_tree<Acc>(red, tx, ty);
    if (ty == 0 && col < f) seg[s * f + col] = red[0][tx];
    __syncthreads();   // red is rewritten by the next segment
  }
}

// Fold::apply(acc, cluster_sum, approx_bits): + or the LOA combine
template <typename Acc, typename Fold>
__global__ void __launch_bounds__(kCols * kLanes)
fold_clusters(const Acc* __restrict__ seg, Acc* __restrict__ out, int f, long long n_clusters,
              int segs_per_cluster, int approx_bits) {
  __shared__ Acc red[kLanes][kCols + 1];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + tx;
  Acc acc = Acc(0);
  for (long long c = 0; c < n_clusters; ++c) {
    Acc v = Acc(0);
    if (col < f) {
      for (int j = ty; j < segs_per_cluster; j += kLanes)
        v = add<Acc>(v, seg[(c * segs_per_cluster + j) * f + col]);
    }
    red[ty][tx] = v;
    __syncthreads();
    lane_tree<Acc>(red, tx, ty);
    if (ty == 0) acc = (c == 0) ? red[0][tx] : Fold::apply(acc, red[0][tx], approx_bits);
    __syncthreads();
  }
  if (ty == 0 && col < f) out[col] = acc;
}

// Both passes on `stream`. scratch holds n_clusters * segs_per_cluster * f
// Acc values. Returns cudaGetLastError() after the second launch.
template <typename T, typename Acc, typename Fold>
cudaError_t reduce(const void* x, void* scratch, void* out, long long n, int f, int block_n,
                   int approx_bits, cudaStream_t stream) {
  const int segs_per_cluster = (block_n + kSegRows - 1) / kSegRows;
  const long long n_clusters = (n + block_n - 1) / block_n;
  const long long n_segs = n_clusters * segs_per_cluster;
  const unsigned col_blocks = (f + kCols - 1) / kCols;
  dim3 grid1(col_blocks, static_cast<unsigned>(std::min(n_segs, 65535LL)));
  segment_sums<T, Acc><<<grid1, kCols * kLanes, 0, stream>>>(
      static_cast<const T*>(x), static_cast<Acc*>(scratch), n, f, block_n, segs_per_cluster,
      n_segs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_clusters<Acc, Fold><<<col_blocks, kCols * kLanes, 0, stream>>>(
      static_cast<const Acc*>(scratch), static_cast<Acc*>(out), f, n_clusters, segs_per_cluster,
      approx_bits);
  return cudaGetLastError();
}

}  // namespace cluster
