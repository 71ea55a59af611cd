// flash_attention: causal (or full) softmax(q k^T / sqrt(D)) v forward, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (body _flash_kernel). There the trailing grid axis
// walks KV blocks and carries the running (m, l, acc) triple in the output
// refs. Here one CUDA block owns one (batch, head, query tile) and walks the
// KV tiles itself, in ascending order, keeping (m, l, acc) in f32 registers:
// scores past kv_len (the padding mask) and, causally, with kv_pos > q_pos
// (q_pos counted from 0) are set to -1e30; per tile m_new = max(m, rowmax),
// p = exp(s - m_new), corr = exp(m - m_new), l = l * corr + sum(p),
// acc = acc * corr + p v; KV tiles strictly above the causal diagonal are
// skipped, not masked (an exact zero either way); the output is
// acc / max(l, 1e-30), converted once to the input type.
//
// Layouts are the port's public ones: q (B, Sq, H, D), k/v (B, Skv, Hk, D),
// out (B, Sq, H, D). GQA is indexed (kv head = h / G), never materialized.
//
// Bound on the H100: prefill at a few hundred to a few thousand tokens does
// 4 * S^2/2 * D operations per head on 4 * S * D bytes, far above the card's
// ~295 bf16 operations a byte, so the two products belong on the tensor
// cores (989 TFLOP/s); at the served prompts (16-96 tokens) the grid is a few
// dozen blocks and the time is launch and one tile's latency.
//
// flash_wgmma (bf16, D % 16 == 0, D <= 128): one warpgroup owns a 64-row Q
// tile. S = Q K^T is a chain of wgmma m64n64k16 over D with Q and K in shared
// memory, both K-major (D contiguous, the natural layout: no transpose); S is
// scaled by sm_scale * log2(e) in f32 after the product (the Pallas kernel
// scales q before it: one f32 rounding apart) and exponentiated by the
// MUFU.EX2 instruction (ex2.approx, exp2f's fast-math form).
// Row max and sum reduce over the four lanes that share a row. P is rounded
// to bf16 in registers and fed to O += P V as wgmma's register A operand: the
// m64n64 f32 fragment of S is, pair by pair, the A fragment of m64nNk16 (k16
// slice t: register r packs S[8 t + 2 r], S[8 t + 2 r + 1]); l sums the f32 p.
// V is the B operand MN-major (a row of the tile is one kv position),
// read transposed, which 16-bit types allow; O is 64 x 64 f32 per 64-column
// atom of D (D <= 64: one, else two; a partial atom's extra columns are
// computed from whatever its shared memory holds and never stored). K and V
// stream through a two-stage cp.async ring in the 128-byte swizzled layout,
// one tile ahead of the products; rows past Skv (and Q rows past Sq) are
// zero-filled by the copy. Two blocks share an SM (82 KB of shared memory
// each); causal grids issue the longest Q tiles first.
// Rounding P to bf16 is the one precision change against the Pallas kernel.
//
// Tried on the H100 and dropped: issuing S_{t+1} = Q K^T and O += P_t V
// together with the softmax in between (no gain, and in a second form ptxas
// serialized the wgmmas and it ran slower); 128-row blocks of two
// warpgroups sharing a four-stage K/V ring, one block an SM (slower at every
// length). What bounds this body is one warpgroup's chain per tile: the S
// product, its wait, the softmax, the P V product and its wait.
//
// flash_simt (f32, D % 4 == 0, D <= 128): the CUDA-core body; TF32 would not
// hold the 1e-5 the f32 rows are checked to. q is scaled by sm_scale on load;
// 32 x 32 tiles, 4 threads per query row, each holding 8 scores and D/4
// accumulator columns; row statistics reduce over the 4 lanes by shuffle.
//
// Launch counting is done by the Python wrapper (kernels/flash_attention.py),
// whose ``plan`` mirrors the tiles, instance and block order chosen here.

#include "sm90.cuh"

namespace {

// ---- bf16: wgmma ------------------------------------------------------------

constexpr int WG_BQ = 64;
constexpr int WG_BKV = 64;
constexpr int WG_THREADS = 128;   // one warpgroup
constexpr int ATOM = 64 * 128;    // bytes of a 64-row x 64-column bf16 swizzle atom

__host__ __device__ constexpr int wg_atoms(int D) { return (D + 63) / 64; }
// Q tile + two stages of K and V tiles, + 1024 to align the atoms
__host__ __device__ constexpr size_t wg_smem(int D) {
  return size_t(wg_atoms(D)) * ATOM * 5 + 1024;
}

// 2**x by the MUFU.EX2 instruction (exp2f's fast-math form; relative error
// about 2**-22, results below 2**-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of element column c (a multiple of 8) of row r in a 64-row tile
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c / 64) * ATOM + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq,
            int Skv, int H, int Hk, float sm_scale, int causal) {
  using T = __nv_bfloat16;
  constexpr int NA = wg_atoms(D), CPR = D / 8, KS = D / 16, TILE = NA * ATOM;
  static_assert(D % 16 == 0 && D <= 128, "bf16 head_dim: a multiple of 16, at most 128");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  unsigned char* Qs = fa_smem + ((1024 - (smem_u32(fa_smem) & 1023)) & 1023);
  auto Ks = [&](int slot) { return Qs + TILE * (1 + 2 * slot); };
  auto Vs = [&](int slot) { return Qs + TILE * (2 + 2 * slot); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hk);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;   // longest first
  const int q0 = qt * WG_BQ;
  const int kv_end = causal ? min(Skv, q0 + WG_BQ) : Skv;   // skip above the diagonal
  const int n_kv = (kv_end + WG_BKV - 1) / WG_BKV;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hk * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * Hk + hk) * D;
  const T* vb = v + ((size_t)b * Skv * Hk + hk) * D;

  // A tile is 64 rows from row r0 of a (rows, D) view; rows at or past
  // ``rows`` are zero-filled. Eight consecutive threads copy 128 contiguous
  // bytes of one row: this thread's chunk i is row lr[i], column lc[i], at
  // byte so[i] of the tile (the same for every tile).
  constexpr int CH = WG_BQ * CPR / WG_THREADS;
  int lr[CH], lc[CH], so[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int e = tid + i * WG_THREADS;
    lr[i] = e / CPR;
    lc[i] = (e % CPR) * 8;
    so[i] = tile_off(lr[i], lc[i]);
  }
  auto load_tile = [&](unsigned char* dst, const T* base, size_t stride, int r0, int rows) {
    const T* tb = base + (size_t)r0 * stride;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool ok = r0 + lr[i] < rows;
      cp_async16(dst + so[i], ok ? tb + (size_t)lr[i] * stride + lc[i] : base, ok ? 16 : 0);
    }
  };

  load_tile(Qs, qb, q_stride, q0, Sq);
  load_tile(Ks(0), kb, kv_stride, 0, Skv);
  load_tile(Vs(0), vb, kv_stride, 0, Skv);
  cp_async_commit();
  // descriptors of the tiles; a k16 slice or an atom adds its offset / 16
  const uint64_t dq = wg_desc(Qs, 16, 1024);
  const uint64_t dk0 = wg_desc(Ks(0), 16, 1024), dk1 = wg_desc(Ks(1), 16, 1024);
  const uint64_t dv0 = wg_desc(Vs(0), ATOM, 1024), dv1 = wg_desc(Vs(1), ATOM, 1024);

  // this thread's rows of the tile: g and g + 8 of the warp's 16
  const int g = lane / 4, quad = lane % 4;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float sl2 = sm_scale * 1.4426950408889634f;   // exp(x) = exp2(x log2(e))
  float acc[NA][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a][i] = 0.f;
  }
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this lane's part

  for (int t = 0; t < n_kv; ++t) {
    const int slot = t & 1, kv0 = t * WG_BKV;
    cp_async_wait<0>();   // tile t (and, at t = 0, Q) has landed
    fence_async_smem();
    __syncthreads();      // ... for every thread, and tile t - 1 is consumed
    if (t + 1 < n_kv) {
      load_tile(Ks(slot ^ 1), kb, kv_stride, kv0 + WG_BKV, Skv);
      load_tile(Vs(slot ^ 1), vb, kv_stride, kv0 + WG_BKV, Skv);
    }
    cp_async_commit();

    // S = Q K^T: k16 slice ks of D is 32 bytes into atom ks / 4 of both tiles
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = ((ks / 4) * ATOM + (ks % 4) * 32) >> 4;
      wgmma_64x64_ss<0>(s, dq + off, (slot ? dk1 : dk0) + off, ks > 0);
    }
    wg_commit();
    wg_wait_all();

    // online softmax on the fragment, in the log2 domain
    const bool edge = kv0 + WG_BKV > Skv || (causal && kv0 + WG_BKV - 1 > q0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * sl2;
        if (edge) {
          const int col = kv0 + 8 * j + 2 * quad + (e & 1), row = e < 2 ? row0 : row1;
          if (col >= Skv || (causal && col > row)) x = REPRO_NEG_INF;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
    unsigned p[4][4];   // P in bf16: the A fragment of k16 slice t
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float mrow = (i % 2 == 0) ? m0 : m1;   // pair i = s[2 i], s[2 i + 1]: one row
      const float lo = ex2(s[2 * i] - mrow), hi = ex2(s[2 * i + 1] - mrow);
      if (i % 2 == 0) sum0 += lo + hi; else sum1 += lo + hi;
      const __nv_bfloat162 pk = __floats2bfloat162_rn(lo, hi);
      p[i / 4][i % 4] = *reinterpret_cast<const unsigned*>(&pk);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= (i % 4 < 2) ? c0 : c1;

    // O += P V: k16 slice t4 is rows 16 t4.. of V, 2048 bytes into each atom
    wg_fence();   // acc and p were written by this thread since the last wgmma
#pragma unroll
    for (int t4 = 0; t4 < 4; ++t4)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma_64x64_rs(acc[a], p[t4], (slot ? dv1 : dv0) + ((a * ATOM + t4 * 2048) >> 4));
    wg_commit();
    wg_wait_all();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* o0 = out + (((size_t)b * Sq + row0) * H + h) * D;
  T* o1 = o0 + (size_t)8 * H * D;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = a * 64 + 8 * j + 2 * quad;
      if (col >= D) continue;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(acc[a][4 * j] / d0, acc[a][4 * j + 1] / d0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(acc[a][4 * j + 2] / d1, acc[a][4 * j + 3] / d1);
    }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                         int Skv, int H, int Hk, float sm_scale, int causal,
                         cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t smem = wg_smem(D);
  cudaError_t err = allow_smem(flash_wgmma<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + WG_BQ - 1) / WG_BQ);   // heads fastest: a tile length a wave
  flash_wgmma<D><<<grid, WG_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, Hk, sm_scale, causal);
  return cudaGetLastError();
}

// ---- f32: CUDA cores ----------------------------------------------------------

constexpr int BQ = 32;
constexpr int BKV = 32;
constexpr int THREADS = 128;   // 4 threads per query row
constexpr int MAX_D = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Skv, int H, int Hk, int D, float sm_scale, int causal,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + BKV * D + BQ * (BKV + 1));
  cudaError_t err = allow_smem(flash_simt<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_simt<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, Hk, D, sm_scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Skv, int H, int Hk, int D, float sm_scale, int causal,
                        cudaStream_t st) {
  switch (D) {
#define REPRO_FLASH_D(d) \
  case d: return launch_wgmma<d>(q, k, v, out, B, Sq, Skv, H, Hk, sm_scale, causal, st);
    REPRO_FLASH_D(16) REPRO_FLASH_D(32) REPRO_FLASH_D(48) REPRO_FLASH_D(64)
    REPRO_FLASH_D(80) REPRO_FLASH_D(96) REPRO_FLASH_D(112) REPRO_FLASH_D(128)
#undef REPRO_FLASH_D
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point: contiguous q (B, Sq, H, D), k/v (B, Skv, Hk, D), out like q,
// all of dtype ``dtype``: f32 (D % 4 == 0) or bf16 (D % 16 == 0); D <= 128,
// H % Hk == 0.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Sq, int Skv, int H, int Hk, int D,
                                     float sm_scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 || D > MAX_D || H % Hk) return cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return launch_simt<float>(q, k, v, out, B, Sq, Skv, H, Hk, D, sm_scale, causal, st);
  if (dtype == DT_BF16)
    return launch_bf16(q, k, v, out, B, Sq, Skv, H, Hk, D, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}
