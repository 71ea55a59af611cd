// flash_attention: causal (or full) softmax(q k^T / sqrt(D)) v forward, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (body _flash_kernel). There the trailing grid axis
// walks KV blocks and carries the running (m, l, acc) triple in the output
// refs. Here one CUDA block owns one (batch, head, 32-query tile) and walks
// the KV tiles itself, keeping (m, l, acc) in f32 registers:
//
//   q is scaled by sm_scale = D**-0.5 in f32 on load; scores past kv_len (the
//   padding mask) and, causally, with kv_pos > q_pos are set to -1e30; per
//   tile m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new),
//   l = l * corr + sum(p), acc = acc * corr + p v; KV tiles strictly above
//   the causal diagonal are skipped, not masked (an exact zero either way);
//   the output is acc / max(l, 1e-30), converted once to the input type.
//
// Layouts are the port's public ones: q (B, Sq, H, D), k/v (B, Skv, Hk, D),
// out (B, Sq, H, D). GQA is indexed (kv head = h / G), never materialized.
//
// Bound on the H100: prefill at S <= a few thousand tokens is bound by the
// score and p v operations (4 * S^2/2 * D per head), which the tensor cores
// would do at 989 TFLOP/s; this first version runs them as f32 FMA on the
// CUDA cores from shared-memory tiles (Q 32 x D, K and V 32 x D). mma/wgmma
// is later work. Each of the 4 threads of a query row holds 8 scores and
// D/4 accumulator columns; row statistics reduce over the 4 lanes by shuffle.
//
// Launch counting is done by the Python wrapper (kernels/flash_attention.py).

#include "common.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BKV = 32;
constexpr int THREADS = 128;   // 4 threads per query row
constexpr int MAX_D = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Skv, int H, int Hk, int D, float sm_scale,
             int causal) {
  extern __shared__ float smem[];
  const int ldq = D + 1;               // padded rows: no bank conflicts
  float* Qs = smem;                    // [BQ][D + 1], scaled
  float* Ks = Qs + BQ * ldq;           // [BKV][D + 1]
  float* Vs = Ks + BKV * ldq;          // [BKV][D]
  float* Ps = Vs + BKV * D;            // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;            // query row within the tile
  const int quad = tid & 3;            // lane within the row's group of 4
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * BQ;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int s = q0 + r;
    Qs[r * ldq + d] = s < Sq ? to_f32(q[(((size_t)b * Sq + s) * H + h) * D + d]) * sm_scale : 0.f;
  }

  const int ncol = D / 4;              // accumulator columns of this thread: quad + 4 j
  float acc[MAX_D / 4];
#pragma unroll
  for (int j = 0; j < MAX_D / 4; ++j) acc[j] = 0.f;
  float m = REPRO_NEG_INF, l = 0.f;
  const int q_pos = q0 + row;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    if (causal && kv0 > q0 + BQ - 1) break;   // the rest lies above the diagonal
    __syncthreads();                   // the previous tile is consumed
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int s = kv0 + r;
      const size_t off = (((size_t)b * Skv + s) * Hk + hk) * D + d;
      Ks[r * ldq + d] = s < Skv ? to_f32(k[off]) : 0.f;
      Vs[r * D + d] = s < Skv ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[BKV / 4];
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const int c = quad + 4 * i;
      const float* qr = Qs + row * ldq;
      const float* kr = Ks + c * ldq;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int kv_pos = kv0 + c;
      const bool valid = kv_pos < Skv && (!causal || kv_pos <= q_pos);
      sc[i] = valid ? s : REPRO_NEG_INF;
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const float p = expf(sc[i] - m_new);
      Ps[row * (BKV + 1) + quad + 4 * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();                      // the row's p values are in Ps

    const float* pr = Ps + row * (BKV + 1);
#pragma unroll
    for (int j = 0; j < MAX_D / 4; ++j) {   // constant trip: acc stays in registers
      if (j < ncol) {
        const int d = quad + 4 * j;
        float pv = 0.f;
#pragma unroll 8
        for (int c = 0; c < BKV; ++c) pv = fmaf(pr[c], Vs[c * D + d], pv);
        acc[j] = acc[j] * corr + pv;
      }
    }
  }

  if (q_pos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * Sq + q_pos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < MAX_D / 4; ++j)
      if (j < ncol) o[quad + 4 * j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int H, int Hk, int D, float sm_scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + BKV * D + BQ * (BKV + 1));
  cudaError_t err = allow_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, Hk, D, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// C entry point: contiguous q (B, Sq, H, D), k/v (B, Skv, Hk, D), out like q,
// all of dtype ``dtype`` (f32 or bf16); D % 4 == 0, D <= 128, H % Hk == 0.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Sq, int Skv, int H, int Hk, int D,
                                     float sm_scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 || D > MAX_D || H % Hk) return cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  if (dtype == DT_F32) return launch<float>(q, k, v, out, B, Sq, Skv, H, Hk, D, sm_scale, causal, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Hk, D, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}
