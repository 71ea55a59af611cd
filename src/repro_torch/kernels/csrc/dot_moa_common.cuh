// Pieces shared by the dot_moa bodies (dot_moa_{stream,tc,simt,wgmma}.cuh):
// the accumulator arithmetic and the cursor that walks K stage by stage
// without ever letting a stage cross a block_k boundary (cp.async and the
// wgmma helpers are in sm90.cuh).
#pragma once

#include "sm90.cuh"

namespace dm {

constexpr int THREADS = 256;   // every dot_moa body runs 8 warps per block

// ---- accumulator arithmetic ---------------------------------------------
// Floats accumulate in f32; ints in int32, where products and sums wrap
// modulo 2**32 as XLA's int32 dot: they run on unsigned words.

__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b) +
                          static_cast<unsigned>(c));
}

__device__ __forceinline__ float add(float x, float y) { return x + y; }
__device__ __forceinline__ int add(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}

// Fold of a whole slice's partial into the accumulator: + for floats, the
// Lower-part-OR combine for ints (loa_fold, l == 0 is the exact add).
__device__ __forceinline__ float fold(float acc, float part, int) { return acc + part; }
__device__ __forceinline__ int fold(int acc, int part, int l) { return loa_fold(acc, part, l); }

template <typename OutT> __device__ __forceinline__ OutT store_as(float x);
template <> __device__ __forceinline__ float store_as<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename OutT> __device__ __forceinline__ OutT store_as(int x);
template <> __device__ __forceinline__ int store_as<int>(int x) { return x; }

__device__ __forceinline__ float load_as(float x, float) { return x; }
__device__ __forceinline__ float load_as(__nv_bfloat16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ int load_as(int8_t x, int) { return x; }
__device__ __forceinline__ int load_as(int x, int) { return x; }

// 16 bytes of operands -> 16 / sizeof(T) accumulator values.
template <typename T, typename Acc> struct Unpack16;
template <> struct Unpack16<float, float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void run(uint4 v, float* o) {
    o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
  }
};
template <> struct Unpack16<int, int> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void run(uint4 v, int* o) {
    o[0] = static_cast<int>(v.x); o[1] = static_cast<int>(v.y);
    o[2] = static_cast<int>(v.z); o[3] = static_cast<int>(v.w);
  }
};
template <> struct Unpack16<__nv_bfloat16, float> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void run(uint4 v, float* o) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is the high half of the word
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Unpack16<int8_t, int> {
  static constexpr int N = 16;
  __device__ static __forceinline__ void run(uint4 v, int* o) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] = static_cast<int>(w[i] << (24 - 8 * j)) >> 24;   // sign-extend byte j
  }
};

// ---- the K walk -----------------------------------------------------------
// A block walks [k0, stop) in stages of ``step`` rows of K. A stage never
// crosses a block_k boundary: at a slice's end it is cut short (the loaders
// zero-fill the rest), and the next stage starts the next slice. So the
// consumer knows, stage by stage, where each slice's partial is complete.
struct KCursor {
  int k, end, stop, bk;
  __device__ __forceinline__ KCursor(int k0, int stop_, int bk_)
      : k(k0), end(min((k0 / bk_ + 1) * bk_, stop_)), stop(stop_), bk(bk_) {}
  __device__ __forceinline__ bool valid() const { return k < stop; }
  __device__ __forceinline__ bool slice_done(int step) const { return k + step >= end; }
  __device__ __forceinline__ void advance(int step) {
    k += step;
    if (k >= end) {
      k = end;
      end = min(end + bk, stop);
    }
  }
};

// ---- the batch ------------------------------------------------------------
// A batched call is E independent (M, K) @ (K, N) products in one launch,
// the counterpart of vmap's leading batch grid axis on the Pallas kernel.
// grid.x holds E x nx blocks: member e = blockIdx.x / nx runs exactly the
// blocks of the unbatched call under the same plan, with bx =
// blockIdx.x - e * nx in place of blockIdx.x, on A, B, C and the split
// workspace offset by e times their member strides (elements). An
// unbatched call is E = 1, nx = gridDim.x.
struct Batch {
  int nx;
  long long sa, sb, sc, sw;
};

__device__ __forceinline__ int batch_member(const Batch& bt, int& bx) {
  const int e = blockIdx.x / bt.nx;
  bx = blockIdx.x - e * bt.nx;
  return e;
}

template <typename P>
__device__ __forceinline__ P* member_ptr(P* p, int e, long long stride) {
  return p != nullptr ? p + e * stride : p;
}

// Every body, and the fold, has a one-member instance (BATCHED false) that
// leaves A, B, C and the workspace alone: they stay kernel parameters and
// take no registers. With the offsets they did not need, the simt and tc
// bodies ran 14-15 % slower.

// The K range of block z in split mode: sub-range j of slice s, cut at the
// slice's end (empty where a ragged last slice has fewer sub-ranges).
__device__ __forceinline__ void split_range(int z, int K, int bk, int sub, int splits, int& k0,
                                            int& k1) {
  const int s = z / splits, j = z % splits;
  const int slice_end = min((s + 1) * bk, K);
  k0 = min(s * bk + j * sub, slice_end);
  k1 = min(k0 + sub, slice_end);
}

}  // namespace dm
