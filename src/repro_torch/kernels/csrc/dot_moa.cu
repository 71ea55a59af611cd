// dot_moa: (m, k) @ (k, n) with a serialized-MOA contraction, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/dot_moa.py: dot_moa_pallas
// (body _dot_moa_kernel). There the trailing grid axis walks K in block_k
// slices and each slice's partial is folded into an accumulator held in
// VMEM. Here one CUDA block owns one BM x 64 output tile and walks K itself:
// every block_k slice is summed into a fresh register partial, and the
// partial is then folded into the accumulator -- by + (floats, ints) or by
// the LOA combine (approx_bits > 0, ints). That is the paper's serialized
// MOA with n_c = block_k; it is never one running sum.
//
// Instances: f32 -> f32 and bf16 -> bf16 (f32 accumulator), int8 -> int32
// and int32 -> int32 (int32 accumulator, exact or LOA fold; products and
// sums wrap modulo 2**32 as XLA's int32 dot). block_k may be any K, ragged
// ones included (the LOA route folds a whole ragged K as one cluster).
// The output is converted once, at the end. Ragged m, n and k are masked
// here (the Pallas wrapper zero-pads instead, which adds exact zeros).
//
// Bound on the H100: at the decode shapes (m = slots, k = 4096..14336) the
// weight matrix dominates the bytes and the kernel is bound by reading it
// once (3.35 TB/s). This first version computes on the CUDA cores in f32
// FMA from shared-memory tiles (64 x 32 of B per step), with BM = 16 rows
// per block for small m so few lanes idle; prefill-sized m runs BM = 64.
// Tensor cores (wgmma) and TMA are later work.
//
// Launch counting is done by the Python wrapper (kernels/dot_moa.py).

#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;   // 16 x 16 threads; each owns (BM/16) x 4 outputs

template <typename Acc> struct Fold;

template <> struct Fold<float> {
  __device__ static __forceinline__ float apply(float acc, float part, int) {
    return acc + part;
  }
};

// int32 fold: exact add or the Lower-part-OR adder (loa_fold, common.cuh).
template <> struct Fold<int> {
  __device__ static __forceinline__ int apply(int x, int y, int l) { return loa_fold(x, y, l); }
};

template <typename T, typename Acc> __device__ __forceinline__ Acc load_as(const T& x);
template <> __device__ __forceinline__ float load_as<float, float>(const float& x) { return x; }
template <> __device__ __forceinline__ float load_as<__nv_bfloat16, float>(const __nv_bfloat16& x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ int load_as<int8_t, int>(const int8_t& x) { return x; }
template <> __device__ __forceinline__ int load_as<int, int>(const int& x) { return x; }

template <typename Acc> __device__ __forceinline__ Acc mac(Acc a, Acc b, Acc c);
template <> __device__ __forceinline__ float mac<float>(float a, float b, float c) {
  return fmaf(a, b, c);
}
template <> __device__ __forceinline__ int mac<int>(int a, int b, int c) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b) +
                          static_cast<unsigned>(c));
}

template <typename OutT, typename Acc> __device__ __forceinline__ OutT store_as(Acc x);
template <> __device__ __forceinline__ float store_as<float, float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ int store_as<int, int>(int x) { return x; }

template <typename T, typename Acc, typename OutT, int BM>
__global__ void __launch_bounds__(THREADS)
dot_moa_kernel(const T* __restrict__ A, const T* __restrict__ B, OutT* __restrict__ C,
               int M, int N, int K, int block_k, int approx_bits) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ Acc As[BK][BM + 1];   // A tile, transposed (padded: no bank conflicts)
  __shared__ Acc Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;     // output columns tx + 16 j
  const int ty = tid / 16;     // output rows ty + 16 i
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  Acc acc[TM][TN] = {};
  for (int s0 = 0; s0 < K; s0 += block_k) {
    const int s1 = min(s0 + block_k, K);
    Acc part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = Acc(0);

    for (int k0 = s0; k0 < s1; k0 += BK) {
      // A tile: BM rows x BK columns, consecutive threads on consecutive k
#pragma unroll
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int gr = m0 + r, gk = k0 + c;
        As[c][r] = (gr < M && gk < s1) ? load_as<T, Acc>(A[(size_t)gr * K + gk]) : Acc(0);
      }
      // B tile: BK rows x BN columns, consecutive threads on consecutive n
#pragma unroll
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        const int gk = k0 + r, gc = n0 + c;
        Bs[r][c] = (gk < s1 && gc < N) ? load_as<T, Acc>(B[(size_t)gk * N + gc]) : Acc(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        Acc a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = mac<Acc>(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = (s0 == 0) ? part[i][j] : Fold<Acc>::apply(acc[i][j], part[i][j], approx_bits);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) C[(size_t)r * N + c] = store_as<OutT, Acc>(acc[i][j]);
    }
  }
}

template <typename T, typename Acc, typename OutT>
void launch(const void* a, const void* b, void* out, int M, int N, int K, int block_k,
            int approx_bits, cudaStream_t stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  OutT* C = static_cast<OutT*>(out);
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    dot_moa_kernel<T, Acc, OutT, 16><<<grid, THREADS, 0, stream>>>(A, B, C, M, N, K, block_k,
                                                                    approx_bits);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    dot_moa_kernel<T, Acc, OutT, 64><<<grid, THREADS, 0, stream>>>(A, B, C, M, N, K, block_k,
                                                                    approx_bits);
  }
}

}  // namespace

// C entry point. a (M, K), b (K, N), out (M, N): contiguous, row-major, on the
// current device. Returns cudaGetLastError() after the launch.
extern "C" int repro_dot_moa(const void* a, const void* b, void* out, int M, int N, int K,
                             int block_k, int approx_bits, int in_dtype, int out_dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || block_k <= 0) return cudaErrorInvalidValue;
  if (in_dtype == DT_F32 && out_dtype == DT_F32) {
    launch<float, float, float>(a, b, out, M, N, K, block_k, 0, st);
  } else if (in_dtype == DT_BF16 && out_dtype == DT_BF16) {
    launch<__nv_bfloat16, float, __nv_bfloat16>(a, b, out, M, N, K, block_k, 0, st);
  } else if (in_dtype == DT_I8 && out_dtype == DT_I32) {
    launch<int8_t, int, int>(a, b, out, M, N, K, block_k, approx_bits, st);
  } else if (in_dtype == DT_I32 && out_dtype == DT_I32) {
    launch<int, int, int>(a, b, out, M, N, K, block_k, approx_bits, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
