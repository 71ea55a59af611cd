// dot_moa: (m, k) @ (k, n) with a serialized-MOA contraction, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/dot_moa.py: dot_moa_pallas
// (body _dot_moa_kernel). There the trailing grid axis walks K in block_k
// slices and each slice's partial is folded into an accumulator held in
// VMEM. The contract kept here: every block_k slice of K is summed into a
// fresh partial in the accumulator type (f32 for floats, int32 for ints);
// the partials are folded into the accumulator in slice order, by + or by
// the LOA combine (approx_bits > 0, ints); the result is converted once.
// Inside a slice the order of the sum is free (the Pallas body's jnp.dot
// fixes none); across slices it is not: the fold is a separate, ordered
// step, never one running sum -- the paper's serialized MOA with
// n_c = block_k. Integer products and sums wrap modulo 2**32.
//
// Instances: f32 -> f32, bf16 -> bf16 and bf16 -> f32 (f32 accumulator;
// f32 output for the MoE router's logits), int8 -> int32 and int32 -> int32
// (int32 accumulator, exact or LOA fold). Ragged m, n, k and a ragged last
// slice are masked or zero-filled here (the Pallas wrapper zero-pads, which
// adds exact zeros); LOA needs k % block_k == 0.
//
// Batch: one launch computes E members (E, m, k) @ (E, k, n), the
// counterpart of the batch grid axis vmap adds to dot_moa_pallas (the MoE's
// per-expert contractions). The batch is folded into grid.x (Batch in
// dot_moa_common.cuh): grid.y and grid.z keep the row tiles and the split's
// sub-ranges under their 65535 limit, and each member runs exactly the
// blocks and the fold of the unbatched call under the same plan, so a
// member's bits equal that call's.
//
// Split-K, the one mechanism for every body. The grid is output tiles x K
// sub-ranges. In direct mode (one sub-range: all of K) a block walks every
// slice, summing each into a register partial and folding it into a
// register accumulator. In split mode each sub-range lies inside one
// slice (sub-range j of slice s is [s*bk + j*sub, ...) cut at the slice's
// end); its block writes its partial to an f32/int32 workspace, and
// dot_moa_fold sums each slice's sub-partials in sub-range order (exact for
// ints, the same order every run for floats), folds the slices in slice
// order by + or loa_fold, and converts. The LOA fold only ever sees whole
// slices.
//
// Dispatch (kernels/dot_moa.py: plan, which also picks the split):
//   bf16              dot_moa_wgmma: wgmma tensor cores, 64 x 128 tiles,
//                     at every m: a row's K split and in-slice order are
//                     then the same at every m up to 64, so a decode row
//                     (m = n_slots) and a speculative verify row (m =
//                     n_slots * (k + 1)) give the same bits. At m = 4 it
//                     reads B once, as the stream body did; on the H100
//                     (700 W) the 4x4096 @ 4096x14336 decode row took
//                     0.0485 ms of device time against the stream body's
//                     0.0466 (4% slower; chip_smoke.py kernels rows).
//   small m           dot_moa_stream (f32, int32, int8): bound by reading B
//                     once; split mode always, as much K a block as keeps
//                     the grid within one wave of 2 blocks per SM, the
//                     sub-range sized for the dtype's largest row group
//                     (so the split does not depend on m). CUDA-core FMA:
//                     at m <= 16 a weight byte feeds at most 16 flops, far
//                     under the tensor cores' ridge.
//   else, int8        dot_moa_tc: mma.sync tensor cores, 64 x 128 tiles
//                     (wgmma takes 8-bit operands K-major only).
//   else, f32/int32   dot_moa_simt: register-blocked CUDA cores, 128 x 96
//                     or 128 x 64 tiles (the one that pads n least),
//                     64 x 128 at m <= 64 (no TF32: the f32 contract; no
//                     int32 tensor-core product).
// Small m is what one row group holds: a stream thread keeps at most 64
// accumulators (m <= 16 rows of f32/int32, 4 of int8). More
// rows would take more groups, each reading B again, while one 64-row
// tile of the other bodies reads it once for up to 64 rows. A split is
// used where the tiles alone are fewer than 2 x 132 (wgmma: 132 / 2,
// measured: each further sub-range costs workspace traffic and a tail
// more than its blocks gain) and the workspace stays under max(5 % of the
// operand bytes, 16 MiB); else direct mode (stream: always split).
//
// Launch counting is done by the Python wrapper (kernels/dot_moa.py).

#include <type_traits>

#include "dot_moa_simt.cuh"
#include "dot_moa_stream.cuh"
#include "dot_moa_tc.cuh"
#include "dot_moa_wgmma.cuh"

namespace dm {

enum Body : int { BODY_STREAM = 0, BODY_TC = 1, BODY_SIMT = 2, BODY_WGMMA = 3 };

// Sum each slice's sub-partials in sub-range order, fold the slices in
// slice order, convert once. ws: [batch][slices * splits][M][N], C:
// [batch][M][N]; grid.y is the member, a thread owns one of its outputs
// (BATCHED false, one member: the pointers stay as given, as in the bodies).
template <typename Acc, typename OutT, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
dot_moa_fold(const Acc* __restrict__ ws, OutT* __restrict__ C, long long MN, int K, int bk,
             int sub, int splits, int approx_bits) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= MN) return;
  const int slices = (K + bk - 1) / bk;
  if constexpr (BATCHED) {
    ws += blockIdx.y * (slices * splits * MN);
    C += blockIdx.y * MN;
  }
  Acc acc = Acc(0);
  for (int s = 0; s < slices; ++s) {
    const int len = min(bk, K - s * bk);
    const int cnt = (len + sub - 1) / sub;
    const Acc* p = ws + (size_t)s * splits * MN + idx;
    Acc part = p[0];
    for (int j = 1; j < cnt; ++j) part = add(part, p[(size_t)j * MN]);
    acc = s == 0 ? part : fold(acc, part, approx_bits);
  }
  C[idx] = store_as<OutT>(acc);
}

// Dynamic shared memory above 48 KB, opted into once per kernel and device
// (``done``: a bit per device, a static of the kernel's own launcher; the
// launchers are ``static``, so two builds of this library in one process
// keep a flag each instead of sharing one as a unique symbol).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  const cudaError_t rc = allow_smem(kernel, bytes);
  if (rc == cudaSuccess && dev < 32) done |= 1u << dev;
  return rc;
}

struct Args {
  const void *a, *b;
  void *out, *ws;
  int M, N, K, bk, l, tile_m, tile_n, sub, splits, a_aligned, b_aligned, one_slice, batch;
  long long sa, sb, sc;   // member strides of a, b and out (elements)
  cudaStream_t st;
  // one member's grid: column tiles, row tiles, K sub-ranges
  dim3 grid(int bm, int bn) const {
    return dim3((N + bn - 1) / bn, (M + bm - 1) / bm, ws ? ((K + bk - 1) / bk) * splits : 1);
  }
  // the member strides; nx: a member's blocks along grid.x
  Batch members(int nx) const {
    const long long sw = ws ? (long long)((K + bk - 1) / bk) * splits * M * N : 0;
    return Batch{nx, sa, sb, sc, sw};
  }
  // a member's grid with the batch folded into grid.x
  dim3 batched(dim3 g) const { return dim3(g.x * batch, g.y, g.z); }
};

template <typename T, typename Acc, int MR, bool BATCHED>
static cudaError_t launch_stream_body(const Args& g) {
  auto kern = dot_moa_stream<T, Acc, MR, BATCHED>;
  static unsigned done = 0;
  const cudaError_t rc = prepare(kern, STREAM_SMEM, done);
  if (rc != cudaSuccess) return rc;
  const dim3 grid = g.grid(MR, 32 * Unpack16<T, Acc>::N);
  kern<<<g.batched(grid), THREADS, STREAM_SMEM, g.st>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), static_cast<Acc*>(g.ws), g.M, g.N,
      g.K, g.bk, g.sub, g.splits, g.b_aligned, g.members(grid.x));
  return cudaGetLastError();
}

template <typename T, typename Acc, int MR>
cudaError_t launch_stream_mr(const Args& g) {
  if (g.ws == nullptr || g.sub > stream_submax<MR>()) return cudaErrorInvalidValue;
  return g.batch > 1 ? launch_stream_body<T, Acc, MR, true>(g)
                     : launch_stream_body<T, Acc, MR, false>(g);
}

template <typename T, typename Acc>
cudaError_t launch_stream(const Args& g) {
  constexpr int VEC = Unpack16<T, Acc>::N;
  switch (g.tile_m) {   // MR: rows of A a block holds, MR * VEC <= 64
    case 4: return launch_stream_mr<T, Acc, 4>(g);
    case 8: if constexpr (8 * VEC <= 64) return launch_stream_mr<T, Acc, 8>(g); break;
    case 16: if constexpr (16 * VEC <= 64) return launch_stream_mr<T, Acc, 16>(g); break;
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool BATCHED>
static cudaError_t launch_tc_body(const Args& g) {
  using Acc = typename TcTraits<T>::Acc;
  using Out = typename TcTraits<T>::Out;
  auto kern = dot_moa_tc<T, BATCHED>;
  if (g.tile_m != TC_BM || g.tile_n != TC_BN) return cudaErrorInvalidValue;
  static unsigned done = 0;
  const cudaError_t rc = prepare(kern, tc_smem<T>(), done);
  if (rc != cudaSuccess) return rc;
  const dim3 grid = g.grid(TC_BM, TC_BN);
  kern<<<g.batched(grid), THREADS, tc_smem<T>(), g.st>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), static_cast<Out*>(g.out),
      static_cast<Acc*>(g.ws), g.M, g.N, g.K, g.bk, g.sub, g.splits, g.a_aligned, g.b_aligned,
      g.l, g.members(grid.x));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const Args& g) {
  return g.batch > 1 ? launch_tc_body<T, true>(g) : launch_tc_body<T, false>(g);
}

template <bool ONE, typename OutT, bool BATCHED>
static cudaError_t launch_wgmma_body(const Args& g) {
  auto kern = dot_moa_wgmma<ONE, OutT, BATCHED>;
  static unsigned done = 0;
  constexpr size_t smem = wg_smem<ONE>();
  const cudaError_t rc = prepare(kern, smem, done);
  if (rc != cudaSuccess) return rc;
  const dim3 grid = g.grid(WG_BM, WG_BN);
  // row tiles fastest: the blocks that read one column strip of B run together
  const dim3 rows_first(grid.y, grid.x, grid.z);
  kern<<<g.batched(rows_first), THREADS, smem, g.st>>>(
      static_cast<const __nv_bfloat16*>(g.a), static_cast<const __nv_bfloat16*>(g.b),
      static_cast<OutT*>(g.out), static_cast<float*>(g.ws), g.M, g.N, g.K, g.bk, g.sub,
      g.splits, g.a_aligned, g.b_aligned, g.members(rows_first.x));
  return cudaGetLastError();
}

template <bool ONE, typename OutT>
cudaError_t launch_wgmma_one(const Args& g) {
  return g.batch > 1 ? launch_wgmma_body<ONE, OutT, true>(g)
                     : launch_wgmma_body<ONE, OutT, false>(g);
}

// OutT: bf16, or f32 (a bf16 product with f32 output, as the MoE router's)
template <typename OutT>
cudaError_t launch_wgmma(const Args& g) {
  if (g.tile_m != WG_BM || g.tile_n != WG_BN) return cudaErrorInvalidValue;
  if (g.one_slice) {   // the wrapper's word that every block's range is one slice
    if (g.ws == nullptr && g.K > g.bk) return cudaErrorInvalidValue;
    return launch_wgmma_one<true, OutT>(g);
  }
  return launch_wgmma_one<false, OutT>(g);
}

template <typename T, int BM, int BN, bool ONE, bool BATCHED>
static cudaError_t launch_simt_body(const Args& g) {
  auto kern = dot_moa_simt<T, BM, BN, ONE, BATCHED>;
  static unsigned done = 0;
  const cudaError_t rc = prepare(kern, simt_smem<BM, BN>(), done);
  if (rc != cudaSuccess) return rc;
  const dim3 grid = g.grid(BM, BN);
  kern<<<g.batched(grid), THREADS, simt_smem<BM, BN>(), g.st>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), static_cast<T*>(g.out),
      static_cast<T*>(g.ws), g.M, g.N, g.K, g.bk, g.sub, g.splits, g.a_aligned, g.b_aligned, g.l,
      g.members(grid.x));
  return cudaGetLastError();
}

template <typename T, int BM, int BN, bool ONE>
cudaError_t launch_simt_tile(const Args& g) {
  return g.batch > 1 ? launch_simt_body<T, BM, BN, ONE, true>(g)
                     : launch_simt_body<T, BM, BN, ONE, false>(g);
}

template <typename T, bool ONE>
cudaError_t launch_simt_one(const Args& g) {
  if (g.tile_m == 128 && g.tile_n == 64) return launch_simt_tile<T, 128, 64, ONE>(g);
  if (g.tile_m == 128 && g.tile_n == 96) return launch_simt_tile<T, 128, 96, ONE>(g);
  if (g.tile_m == 64 && g.tile_n == 128) return launch_simt_tile<T, 64, 128, ONE>(g);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_simt(const Args& g) {
  // one_slice: the wrapper's word that every block's range is one slice
  if (g.one_slice) {
    if (g.ws == nullptr && g.K > g.bk) return cudaErrorInvalidValue;
    return launch_simt_one<T, true>(g);
  }
  return launch_simt_one<T, false>(g);
}

template <typename Acc, typename OutT>
cudaError_t launch_fold(const Args& g) {
  const long long mn = (long long)g.M * g.N;
  const dim3 grid((unsigned)((mn + THREADS - 1) / THREADS), g.batch);
  auto kern = g.batch > 1 ? dot_moa_fold<Acc, OutT, true> : dot_moa_fold<Acc, OutT, false>;
  kern<<<grid, THREADS, 0, g.st>>>(static_cast<const Acc*>(g.ws), static_cast<OutT*>(g.out), mn,
                                   g.K, g.bk, g.sub, g.splits, g.l);
  return cudaGetLastError();
}

// One operand type: the body, then (split mode) the fold.
template <typename T, typename Acc, typename OutT>
cudaError_t run(int body, const Args& g) {
  cudaError_t rc = cudaErrorInvalidValue;
  if (body == BODY_STREAM) {
    // bf16 never streams: every m runs wgmma, one per-row arithmetic
    if constexpr (!std::is_same<T, __nv_bfloat16>::value) rc = launch_stream<T, Acc>(g);
  } else if (body == BODY_TC) {
    if constexpr (std::is_same<T, int8_t>::value) rc = launch_tc<T>(g);
  } else if (body == BODY_WGMMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) rc = launch_wgmma<OutT>(g);
  } else if (body == BODY_SIMT) {
    if constexpr (std::is_same<T, float>::value || std::is_same<T, int>::value)
      rc = launch_simt<T>(g);
  }
  if (rc != cudaSuccess || g.ws == nullptr) return rc;
  return launch_fold<Acc, OutT>(g);
}

// Each operand type's kernels, one part of the library each. The library
// builds in parts, one nvcc each, all at once (kernels/_build.py): part k
// in 0..4 (-DDOT_MOA_PART=k) instantiates operand type k's kernels, part 5
// holds the C entry point; without DOT_MOA_PART one file holds it all.
cudaError_t run_f32(int body, const Args& g);
cudaError_t run_bf16(int body, const Args& g);
cudaError_t run_bf16_f32(int body, const Args& g);
cudaError_t run_i8(int body, const Args& g);
cudaError_t run_i32(int body, const Args& g);

#ifdef DOT_MOA_PART
#define DM_PART(k) (DOT_MOA_PART == (k))
#else
#define DM_PART(k) 1
#endif

#if DM_PART(0)
cudaError_t run_f32(int body, const Args& g) { return run<float, float, float>(body, g); }
#endif
#if DM_PART(1)
cudaError_t run_bf16(int body, const Args& g) {
  return run<__nv_bfloat16, float, __nv_bfloat16>(body, g);
}
#endif
#if DM_PART(2)
cudaError_t run_bf16_f32(int body, const Args& g) {
  return run<__nv_bfloat16, float, float>(body, g);
}
#endif
#if DM_PART(3)
cudaError_t run_i8(int body, const Args& g) { return run<int8_t, int, int>(body, g); }
#endif
#if DM_PART(4)
cudaError_t run_i32(int body, const Args& g) { return run<int, int, int>(body, g); }
#endif

}  // namespace dm

#if DM_PART(5)

// C entry point. a (batch, M, K), b (batch, K, N), out (batch, M, N): each
// member row-major and contiguous, on the current device, members s[0],
// s[1] and s[2] elements apart (an unbatched call: batch 1). ws: the
// split-mode workspace, batch * (K / block_k slices rounded up) * splits *
// M * N accumulators, or null for direct mode (the stream body always
// needs it). p: 16 ints from the wrapper's plan -- M, N, K, block_k,
// approx_bits, operand and output dtype codes, body, tile_m, tile_n, sub,
// splits, a_aligned, b_aligned (each member's rows of A / B, block_k and sub
// allow 16-byte copies), one_slice (every block's K range is one slice),
// batch. Every member runs as the unbatched call runs under the same plan.
// Returns cudaGetLastError() after the last launch, or
// cudaErrorInvalidValue for a combination no body takes.
extern "C" int repro_dot_moa(const void* a, const void* b, void* out, void* ws, const int* p,
                             const long long* s, void* stream) {
  using namespace dm;
  const int M = p[0], N = p[1], K = p[2], block_k = p[3], in_dtype = p[5], out_dtype = p[6],
            body = p[7], batch = p[15];
  if (M <= 0 || N <= 0 || K <= 0 || block_k <= 0 || batch <= 0 || batch > 65535)
    return cudaErrorInvalidValue;
  if (s[0] < (long long)M * K || s[1] < (long long)K * N || s[2] < (long long)M * N)
    return cudaErrorInvalidValue;
  const Args g{a,     b,     out,   ws,    M,     N,     K,     block_k, p[4], p[8],
               p[9],  p[10], p[11], p[12], p[13], p[14], batch, s[0],    s[1], s[2],
               static_cast<cudaStream_t>(stream)};
  if (ws != nullptr && (g.sub <= 0 || g.splits <= 0)) return cudaErrorInvalidValue;
  if (in_dtype == DT_F32 && out_dtype == DT_F32) return run_f32(body, g);
  if (in_dtype == DT_BF16 && out_dtype == DT_BF16) return run_bf16(body, g);
  if (in_dtype == DT_BF16 && out_dtype == DT_F32) return run_bf16_f32(body, g);
  if (in_dtype == DT_I8 && out_dtype == DT_I32) return run_i8(body, g);
  if (in_dtype == DT_I32 && out_dtype == DT_I32) return run_i32(body, g);
  return cudaErrorInvalidValue;
}
#endif
