// paged_attention: causal attention of T queries per slot over a block-table
// KV pool, with fused int8 dequantization, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention_pallas (body _paged_kernel; wrappers paged_flash_decode and
// paged_flash_prefill). There the trailing grid axis walks the logical pages
// and scalar-prefetched index maps turn page j into tables[b, j], redirecting
// dead pages to the trash page. Here one CUDA block owns one (slot b, KV head
// h) with its T * G query rows (G = H / Hk, rows ordered (t, g)) and walks the
// pages itself:
//
//   for j < min(n_blocks, (start[b] + T - 1) / bs + 1): page = tables[b, j]
//     (pages past the deepest query are neither read nor computed)
//   k, v of the page -> f32; an int8 pool is dequantized in registers as
//     (x * scale) rounded through dequant_dtype, then f32 -- exactly the value
//     the gather path materializes (paged_attention.py:86-89)
//   s = (q * D**-0.5) k^T; kv_pos <= q_pos, else -1e30; online softmax in f32
//   out = acc / max(l, 1e-30), converted to q's type.
//
// n_blocks is the width of the table as the caller sliced it (the engine's
// live-block bucket), so the walk also stops at the table's edge.
//
// Bound on the H100: decode reads each live page once per KV head and does
// 4 * kv_len * D operations per query row, so it is bound by the bytes of the
// live pages (3.35 TB/s). This first version stages one page of K and V in
// shared memory per step and spreads scores, row statistics and p v over the
// block's threads; pipelining several pages in flight is later work.
//
// Launch counting is done by the Python wrapper (kernels/paged_attention.py).

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename TQ, typename TP>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
             const TP* __restrict__ v_pool, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ tables,
             const int* __restrict__ start, TQ* __restrict__ out, int T, int H, int Hk,
             int D, int bs, int n_blocks, float sm_scale, int dequant_dtype) {
  extern __shared__ float smem[];
  const int G = H / Hk;
  const int R = T * G;                 // query rows of this block
  const int ld = D + 1;                // padded rows: no bank conflicts
  float* Qs = smem;                    // [R][D + 1], scaled
  float* Ks = Qs + R * ld;             // [bs][D + 1]
  float* Vs = Ks + bs * ld;            // [bs][D]
  float* Ps = Vs + bs * D;             // [R][bs + 1]
  float* Acc = Ps + R * (bs + 1);      // [R][D]
  float* Mrow = Acc + R * D;           // [R] running max
  float* Lrow = Mrow + R;              // [R] running denominator
  float* Crow = Lrow + R;              // [R] this page's correction

  const int tid = threadIdx.x;
  const int b = blockIdx.x, h = blockIdx.y;
  const int s0 = start[b];
  const bool quantized = k_scale != nullptr;

  for (int e = tid; e < R * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int t = r / G, g = r % G;
    Qs[r * ld + d] = to_f32(q[(((size_t)b * T + t) * H + h * G + g) * D + d]) * sm_scale;
    Acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    Mrow[r] = REPRO_NEG_INF;
    Lrow[r] = 0.f;
  }

  const int n_live = min(n_blocks, (s0 + T - 1) / bs + 1);
  for (int j = 0; j < n_live; ++j) {
    const int page = tables[(size_t)b * n_blocks + j];
    __syncthreads();                   // the previous page is consumed
    for (int e = tid; e < bs * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const size_t row = (size_t)page * bs + r;
      const size_t off = (row * Hk + h) * D + d;
      float kx = to_f32(k_pool[off]), vx = to_f32(v_pool[off]);
      if (quantized) {
        kx = round_through(kx * k_scale[row * Hk + h], dequant_dtype);
        vx = round_through(vx * v_scale[row * Hk + h], dequant_dtype);
      }
      Ks[r * ld + d] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    for (int e = tid; e < R * bs; e += THREADS) {
      const int r = e / bs, c = e % bs;
      const float* qr = Qs + r * ld;
      const float* kr = Ks + c * ld;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int q_pos = s0 + r / G;
      const int kv_pos = j * bs + c;
      Ps[r * (bs + 1) + c] = kv_pos <= q_pos ? s : REPRO_NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < R; r += THREADS) {
      float* pr = Ps + r * (bs + 1);
      float mx = REPRO_NEG_INF;
      for (int c = 0; c < bs; ++c) mx = fmaxf(mx, pr[c]);
      const float m_new = fmaxf(Mrow[r], mx);
      float sum = 0.f;
      for (int c = 0; c < bs; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      const float corr = expf(Mrow[r] - m_new);
      Lrow[r] = Lrow[r] * corr + sum;
      Mrow[r] = m_new;
      Crow[r] = corr;
    }
    __syncthreads();

    for (int e = tid; e < R * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const float* pr = Ps + r * (bs + 1);
      float pv = 0.f;
      for (int c = 0; c < bs; ++c) pv = fmaf(pr[c], Vs[c * D + d], pv);
      Acc[e] = Acc[e] * Crow[r] + pv;
    }
  }
  __syncthreads();

  for (int e = tid; e < R * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int t = r / G, g = r % G;
    out[(((size_t)b * T + t) * H + h * G + g) * D + d] =
        from_f32<TQ>(Acc[e] / fmaxf(Lrow[r], 1e-30f));
  }
}

size_t smem_bytes(int T, int H, int Hk, int D, int bs) {
  const size_t R = (size_t)T * (H / Hk);
  return sizeof(float) * (R * (D + 1) + (size_t)bs * (D + 1) + (size_t)bs * D +
                          R * (bs + 1) + R * D + 3 * R);
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
                   const float* v_scale, const int* tables, const int* start, void* out, int B,
                   int T, int H, int Hk, int D, int bs, int n_blocks, float sm_scale,
                   int dequant_dtype, cudaStream_t stream) {
  const size_t smem = smem_bytes(T, H, Hk, D, bs);
  cudaError_t err = allow_smem(paged_kernel<TQ, TP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hk);
  paged_kernel<TQ, TP><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), k_scale, v_scale, tables, start, static_cast<TQ*>(out),
      T, H, Hk, D, bs, n_blocks, sm_scale, dequant_dtype);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_pool(int pool_dtype, const void* q, const void* k_pool, const void* v_pool,
                          const float* k_scale, const float* v_scale, const int* tables,
                          const int* start, void* out, int B, int T, int H, int Hk, int D,
                          int bs, int n_blocks, float sm_scale, int dequant_dtype,
                          cudaStream_t st) {
  if (pool_dtype == DT_F32)
    return launch<TQ, float>(q, k_pool, v_pool, k_scale, v_scale, tables, start, out, B, T, H,
                             Hk, D, bs, n_blocks, sm_scale, dequant_dtype, st);
  if (pool_dtype == DT_BF16)
    return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tables, start, out, B,
                                     T, H, Hk, D, bs, n_blocks, sm_scale, dequant_dtype, st);
  if (pool_dtype == DT_I8)
    return launch<TQ, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, start, out, B, T, H,
                              Hk, D, bs, n_blocks, sm_scale, dequant_dtype, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory one launch needs (the wrapper refuses shapes above
// the card's 227 KB per block).
extern "C" long long repro_paged_attention_smem(int T, int H, int Hk, int D, int bs) {
  return static_cast<long long>(smem_bytes(T, H, Hk, D, bs));
}

// C entry point: contiguous q (B, T, H, D) of q_dtype (f32/bf16), pools
// (n_phys, bs, Hk, D) of pool_dtype (f32/bf16/int8), scales (n_phys, bs, Hk)
// f32 or null, tables (B, n_blocks) int32, start (B,) int32, out like q.
extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale,
                                     const void* tables, const void* start, void* out, int B,
                                     int T, int H, int Hk, int D, int bs, int n_blocks,
                                     float sm_scale, int q_dtype, int pool_dtype,
                                     int dequant_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || bs <= 0 || n_blocks <= 0 || H % Hk) return cudaErrorInvalidValue;
  if ((pool_dtype == DT_I8) != (k_scale != nullptr)) return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start);
  if (q_dtype == DT_F32)
    return dispatch_pool<float>(pool_dtype, q, k_pool, v_pool, ks, vs, tb, sp, out, B, T, H, Hk,
                                D, bs, n_blocks, sm_scale, dequant_dtype, st);
  if (q_dtype == DT_BF16)
    return dispatch_pool<__nv_bfloat16>(pool_dtype, q, k_pool, v_pool, ks, vs, tb, sp, out, B,
                                        T, H, Hk, D, bs, n_blocks, sm_scale, dequant_dtype, st);
  return cudaErrorInvalidValue;
}
