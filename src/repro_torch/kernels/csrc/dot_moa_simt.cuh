// dot_moa body for larger m, f32 and int32 operands: a tiled CUDA-core body.
//
// TF32 would break the f32 contract, and there is no int32 tensor-core
// product, so these run FMA / IMAD on the CUDA cores. Block: a BM x BN
// output tile (128 x 96, 128 x 64, or 64 x 128 for m <= 64),
// 256 threads as 16 x 16, each owning BM / 16 rows (ty + 16 i) x BN / 16
// columns (4 consecutive every 64, or for BN = 96, 2 every 32). A 3-stage
// cp.async ring holds BM x 32 of A (rows padded to 36 words: the two rows a
// warp reads sit in other banks) and 32 x BN of B; A is read as float4 /
// int4 along K, B as float4 / int4 (float2 / int2) along N. 16-byte copies
// where the rows are 16-byte aligned, else 4-byte copies, both zero-filled
// past a slice's end and the edges. Slices fold in registers as in the
// tensor-core body. ONE: the block's range is one slice (split mode, or K
// is one slice), so no accumulator beside the partial; the 32-accumulator
// tiles of it then fit 128 registers, two blocks an SM.
#pragma once

#include "dot_moa_common.cuh"

namespace dm {

constexpr int SIMT_BK = 32, SIMT_STAGES = 3, SIMT_AROW = SIMT_BK + 4;

template <int BM, int BN> __host__ __device__ constexpr size_t simt_smem() {
  return size_t(SIMT_STAGES) * (BM * SIMT_AROW + SIMT_BK * BN) * 4;
}

template <typename T, int W> struct VecT;
template <> struct VecT<float, 4> { using type = float4; };
template <> struct VecT<int, 4> { using type = int4; };
template <> struct VecT<float, 2> { using type = float2; };
template <> struct VecT<int, 2> { using type = int2; };

// W consecutive values through one W-wide shared or global access
template <typename T, int W>
__device__ __forceinline__ void vload(const T* p, T* o) {
  const typename VecT<T, W>::type v = *reinterpret_cast<const typename VecT<T, W>::type*>(p);
  o[0] = v.x; o[1] = v.y;
  if constexpr (W == 4) { o[2] = v.z; o[3] = v.w; }
}
template <typename T, int W>
__device__ __forceinline__ void vstore(T* p, const T* o) {
  typename VecT<T, W>::type v;
  v.x = o[0]; v.y = o[1];
  if constexpr (W == 4) { v.z = o[2]; v.w = o[3]; }
  *reinterpret_cast<typename VecT<T, W>::type*>(p) = v;
}

template <typename T> __device__ __forceinline__ T comp(const typename VecT<T, 4>::type& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T, int BM, int BN, bool ONE, bool BATCHED>
__global__ void __launch_bounds__(THREADS, ONE && BM * BN <= 64 * 128 ? 2 : 1)
dot_moa_simt(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
             T* __restrict__ ws, int M, int N, int K, int bk, int sub, int splits, int a_aligned,
             int b_aligned, int approx_bits, Batch bt) {
  using V = typename VecT<T, 4>::type;
  constexpr int TM = BM / 16;                  // rows a thread owns
  constexpr int TN = BN / 16;                  // columns a thread owns
  constexpr int CW = BN % 64 == 0 ? 4 : 2;     // in groups of CW consecutive ones
  constexpr int JN = TN / CW;                  // at tx * CW + 16 * CW * j
  constexpr int STAGE = BM * SIMT_AROW + SIMT_BK * BN;   // words
  constexpr int B_CHUNKS = (SIMT_BK * BN / 4 + THREADS - 1) / THREADS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int bx = blockIdx.x;
  if constexpr (BATCHED) {
    const int e = batch_member(bt, bx);
    A += e * bt.sa;
    B += e * bt.sb;
    C = member_ptr(C, e, bt.sc);
    ws = member_ptr(ws, e, bt.sw);
  }
  const int m0 = blockIdx.y * BM, n0 = bx * BN;

  int k0 = 0, k1 = K;
  if (ws != nullptr) {
    split_range(blockIdx.z, K, bk, sub, splits, k0, k1);
    if (k0 >= k1) return;
  }

  auto load_stage = [&](int k, int end, int slot) {
    T* As = smem + slot * STAGE;
    T* Bs = As + BM * SIMT_AROW;
    if (a_aligned) {
#pragma unroll
      for (int i = 0; i < BM * SIMT_BK / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e / (SIMT_BK / 4), ch = e % (SIMT_BK / 4);
        const int gk = k + ch * 4;
        const int valid = (m0 + r < M) ? max(0, min(4, end - gk)) : 0;
        cp_async16(As + r * SIMT_AROW + ch * 4, valid ? A + (size_t)(m0 + r) * K + gk : A,
                   valid * 4);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM * SIMT_BK / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e / SIMT_BK, c = e % SIMT_BK;
        const bool ok = m0 + r < M && k + c < end;
        cp_async4(As + r * SIMT_AROW + c, ok ? A + (size_t)(m0 + r) * K + k + c : A, ok ? 4 : 0);
      }
    }
    if (b_aligned) {
#pragma unroll
      for (int i = 0; i < B_CHUNKS; ++i) {
        const int e = tid + i * THREADS, r = e / (BN / 4), ch = e % (BN / 4);
        if (e >= SIMT_BK * BN / 4) break;
        const int gk = k + r, gc = n0 + ch * 4;
        const bool ok = gk < end && gc < N;
        cp_async16(Bs + r * BN + ch * 4, ok ? B + (size_t)gk * N + gc : B, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < SIMT_BK * BN / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e / BN, c = e % BN;
        const int gk = k + r, gc = n0 + c;
        const bool ok = gk < end && gc < N;
        cp_async4(Bs + r * BN + c, ok ? B + (size_t)gk * N + gc : B, ok ? 4 : 0);
      }
    }
  };

  T part[TM][TN], acc[ONE ? 1 : TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = T(0);

  KCursor prod(k0, k1, bk), cons(k0, k1, bk);
#pragma unroll
  for (int s = 0; s < SIMT_STAGES - 1; ++s) {
    if (prod.valid()) {
      load_stage(prod.k, prod.end, s);
      prod.advance(SIMT_BK);
    }
    cp_async_commit();
  }
  [[maybe_unused]] bool first = true;
  int slot = 0, pslot = SIMT_STAGES - 1;
  while (cons.valid()) {
    cp_async_wait<SIMT_STAGES - 2>();
    __syncthreads();
    if (prod.valid()) {
      load_stage(prod.k, prod.end, pslot);
      prod.advance(SIMT_BK);
    }
    cp_async_commit();
    pslot = (pslot + 1) % SIMT_STAGES;

    const T* As = smem + slot * STAGE;
    const T* Bs = As + BM * SIMT_AROW;
#pragma unroll
    for (int kq = 0; kq < SIMT_BK / 4; ++kq) {
      V a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const V*>(As + (ty + 16 * i) * SIMT_AROW + kq * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        T b[TN];
#pragma unroll
        for (int j = 0; j < JN; ++j)
          vload<T, CW>(Bs + (kq * 4 + kk) * BN + tx * CW + 16 * CW * j, b + CW * j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const T a = comp<T>(a4[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = mac(a, b[j], part[i][j]);
        }
      }
    }
    if constexpr (!ONE) {
      if (cons.slice_done(SIMT_BK)) {   // the slice's partial is complete: fold it
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = first ? part[i][j] : fold(acc[i][j], part[i][j], approx_bits);
            part[i][j] = T(0);
          }
        first = false;
      }
    }
    cons.advance(SIMT_BK);
    slot = (slot + 1) % SIMT_STAGES;
  }
  cp_async_wait<0>();

  T* out = ws != nullptr ? ws + (size_t)blockIdx.z * M * N : C;
  auto store = [&](const T(&res)[TM][TN]) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty + 16 * i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int c = n0 + tx * CW + 16 * CW * j;
        T* dst = out + (size_t)r * N + c;
        if (b_aligned && c + CW - 1 < N) {   // N % 4 == 0: the row and the columns are aligned
          vstore<T, CW>(dst, res[i] + CW * j);
        } else {
#pragma unroll
          for (int q = 0; q < CW; ++q)
            if (c + q < N) dst[q] = res[i][CW * j + q];
        }
      }
    }
  };
  if constexpr (ONE)
    store(part);
  else
    store(acc);
}

}  // namespace dm
