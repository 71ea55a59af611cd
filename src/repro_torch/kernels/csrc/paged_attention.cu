// paged_attention: causal attention of T queries per slot over a block-table
// KV pool, with fused int8 dequantization, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention_pallas (body _paged_kernel; wrappers paged_flash_decode and
// paged_flash_prefill). There the trailing grid axis walks the logical pages
// of one (slot b, KV head h) in order and scalar-prefetched index maps turn
// page j into tables[b, j]. What it computes, and what this kernel computes:
//
//   n_live = min(n_blocks, (start[b] + T - 1) / bs + 1): pages past the
//     deepest query, and past the table's width, are neither read nor computed
//   k, v of page tables[b, j] -> f32; an int8 page is dequantized in registers
//     as (x * scale) rounded through dequant_dtype, then f32 -- the value the
//     gather path materializes
//   s = (q * D**-0.5) k^T in f32; -1e30 where kv_pos > q_pos (rows (t, g),
//     q_pos = start[b] + t); online softmax in f32; out = acc / max(l, 1e-30),
//     rounded once to q's type.
//
// Bound on the H100: decode reads each live page once per KV head and does
// 4 * kv_len * D operations per query row (R = T * G rows share a KV head),
// so it is bound by the live pages' bytes at 3.35 TB/s: B4 H32/8 D128 bf16 at
// depths 1023..4095 moves 41.9 MB, 12.5 us.
//
// The design, against what held the first version (grid (B, Hk), one block
// walking a slot's whole table alone, scalar loads, four __syncthreads a
// page, half the threads idle and a serial softmax per row):
//
// * Split walk. Block (s, h * n_rt + rt, b) takes pages [s * P, (s + 1) * P)
//   of slot b, head h, query-row tile rt (RT = 4 rows; R > 4 rows take several
//   tiles). S and P come from kernels/paged_attention.py:plan, from shapes
//   alone; each block finds n_live on the device, and a split with no live
//   page returns before it reads anything.
// * Warps walk interleaved pages (warp w: s * P + w, + W, ...), each with its
//   own ring of `stages` page slots fed by 16-byte cp.async copies of the
//   pool's raw bytes (4-byte copies where a row is not 16-byte aligned), so
//   stages - 1 pages are in flight while one is computed. A stage costs one
//   cp.async.wait_group and one __syncwarp; there is no block barrier in the
//   walk. Conversion and the int8 dequant happen in registers after the copy.
// * All lanes busy. The block's RT = 4 scaled q rows are staged once and held
//   in registers, 4 of the D <= 128 head dims a lane. For a chunk of NC = 16
//   page positions a lane forms 64 partial dot products from vector reads of
//   shared memory, and a transposing butterfly over the warp (62 shuffles)
//   leaves it two full scores. Row max and sum reduce over the
//   NC / 2 lanes of a row; p and the rows' corrections go through a per-group
//   buffer (the rescale is skipped when no row's max moved), and p.V
//   accumulates in registers. The online update runs once per chunk. An int8
//   page becomes f32 by integer and FMA-pipe operations, not the conversion
//   unit, and bf16 rounding runs two values an instruction.
// * Occupancy over ring depth: a two-page ring a warp (three for int8's
//   smaller pages) leaves room for three blocks an SM, which beat deeper
//   rings at two blocks an SM on the H100.
// * One row layout. A query row's arithmetic (its lanes' dims, the
//   butterfly, the 16-position update, the warp and split folds) is the
//   same whatever its place in the tile, and the tile is always 4 rows:
//   R = T * G rows take ceil(R / 4) row tiles, each reading the pages again
//   (from L2 where the tiles run together). So row t of a T-query call
//   gives the bits of a one-query call at start + t: a speculative verify
//   (T = k + 1) scores a token as the plain decode step does. Tiles of 8
//   and 16 rows, which laid a row's dims and update width out by T, were
//   dropped for this.
// * Ordered combine in the launch. Each block folds its warps' (m, l, acc) in
//   warp order; m = max m_w, l = sum l_w e^(m_w - m), acc = sum acc_w
//   e^(m_w - m). With one live split that block writes acc / max(l, 1e-30).
//   Otherwise it writes its partial to an f32 workspace, fences and takes a
//   ticket; the block that draws the last one folds the live splits' partials
//   in split order s = 0, 1, ... the same way, writes the output and resets
//   the ticket to 0. The order is fixed by s, so a call gives the same bits
//   on every run. The wrapper keeps workspace and tickets per (device,
//   stream); a call allocates, fills and synchronizes nothing.
//
// Launch counting is done by the Python wrapper (kernels/paged_attention.py).

#include "sm90.cuh"

namespace {

constexpr int D_MAX = 128;    // head dims a warp row group covers
constexpr int PBUF = 64 + 16;  // p of a chunk (<= 64), then <= 16 row corrections
constexpr int MAX_SPLITS = 64;    // kept in step with plan's S_MAX
constexpr int FOLD_PARTS = MAX_SPLITS;  // >= the warps of a block
constexpr unsigned FULL = 0xffffffffu;

// A warp's 32 lanes form one row group holding the tile's 4 rows (4 head
// dims a lane); a lane reduces 64 scores (rows x page positions) at once.
constexpr int RT = 4;
__host__ __device__ constexpr int row_groups(int) { return 1; }
__host__ __device__ constexpr int npart(int) { return 64; }

struct Params {
  const void* q;
  const unsigned char* k_pool;
  const unsigned char* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* start;
  void* out;
  float* ws;
  unsigned* tickets;
  int B, T, H, Hk, D, bs, n_blocks, R, n_rt;
  int hk_pool, kv0;  // the pool's KV heads (its head stride), the first read
  int splits, pages, warps, stages, cp_bytes, q_bf16, dequant;
  float sm_scale;
  int slot_bytes, off_q, off_p, off_w;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared memory of a block (mirrored by plan in kernels/paged_attention.py):
// the warps' rings (aliased after the walk by the warps' partials), the q
// rows, the p buffers (two per warp row group), the fold statistics.
struct Layout {
  int slot, off_q, off_p, off_w, total;
};
__host__ Layout layout(int item, bool quant, int bs, int D, int RT, int W, int NST) {
  Layout L;
  L.slot = align16(2 * bs * D * item + (quant ? 8 * bs : 0));
  const int ring = W * NST * L.slot;
  const int comb = W * (RT * D + 2 * RT) * 4;
  L.off_q = align16(ring > comb ? ring : comb);
  L.off_p = L.off_q + RT * D * 4;
  L.off_w = L.off_p + W * 2 * row_groups(RT) * PBUF * 4;
  L.total = L.off_w + (2 * FOLD_PARTS * RT + 2 * RT) * 4;
  return L;
}

// Head dims 4 c .. 4 c + 3 of row `row` of a page tile, as f32: one 16-, 8-
// or 4-byte read. A bf16 is the top half of its f32; an int8 becomes f32
// without the conversion unit: byte b ^ 0x80 = b + 128 under the exponent of
// 2**23 is the float 2**23 + b + 128, exact; subtract 2**23 + 128.
template <typename TP>
__device__ __forceinline__ void load4(const unsigned char* tile, int row, int D, int c,
                                      float (&x)[4]);
template <>
__device__ __forceinline__ void load4<float>(const unsigned char* tile, int row, int D, int c,
                                             float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(tile + (size_t)row * D * 4 + c * 16);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const unsigned char* tile, int row, int D,
                                                     int c, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(tile + (size_t)row * D * 2 + c * 8);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}
template <>
__device__ __forceinline__ void load4<int8_t>(const unsigned char* tile, int row, int D, int c,
                                              float (&x)[4]) {
  const unsigned u =
      *reinterpret_cast<const unsigned*>(tile + (size_t)row * D + c * 4) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) - 8388736.f;
}

// K or V dims l * DP .. of page position `row` (DP 4 or 8); zeros for a
// lane past D. An int8 pool's value is x * scale rounded through
// dequant_dtype (bf16 when DQ_BF16) and back to f32: the int8 pool's
// dequantization contract, the value the gather path materializes.
template <typename TP, bool DQ_BF16, int DP>
__device__ __forceinline__ void page_dims(const unsigned char* tile, const float* scale, int row,
                                          int D, int l, float (&x)[DP]) {
  if (l * DP >= D) {
#pragma unroll
    for (int i = 0; i < DP; ++i) x[i] = 0.f;
    return;
  }
  if constexpr (DP == 4) {
    load4<TP>(tile, row, D, l, x);
  } else {
    float lo[4], hi[4];
    load4<TP>(tile, row, D, 2 * l, lo);
    load4<TP>(tile, row, D, 2 * l + 1, hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = lo[i];
      x[4 + i] = hi[i];
    }
  }
  if constexpr (sizeof(TP) == 1) {
    const float sc = scale[row];
#pragma unroll
    for (int i = 0; i < DP; ++i) x[i] *= sc;
    if constexpr (DQ_BF16) {  // two values an instruction
#pragma unroll
      for (int i = 0; i < DP; i += 2) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(x[i], x[i + 1]);
        const unsigned u = *reinterpret_cast<const unsigned*>(&v);
        x[i] = __uint_as_float(u << 16);
        x[i + 1] = __uint_as_float(u & 0xffff0000u);
      }
    }
  }
}

template <int DP>
__device__ __forceinline__ float dot(const float (&a)[DP], const float (&b)[DP]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < DP; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// One step of the transposing butterfly over the lane's first 2 * HALF
// values: at lane offset O a lane keeps the half picked by that bit of its
// index and adds the partner's copy of it. log2(LG) steps (O = LG / 2 .. 1)
// leave lane l of a group of LG lanes with the group's sums of values
// N / LG * l .. + N / LG - 1.
template <int HALF, int O, int N>
__device__ __forceinline__ void butterfly(float (&v)[N], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? v[k] : v[k + HALF];
    const float keep = up ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

__device__ __forceinline__ float4 fma4(float4 x, float w, float4 a) {
  return make_float4(fmaf(x.x, w, a.x), fmaf(x.y, w, a.y), fmaf(x.z, w, a.z),
                     fmaf(x.w, w, a.w));
}

// Fold statistics of n partials of row r (m[v * RT + r], l[v * RT + r], in
// order v = 0 .. n - 1): folded m and l to fm[r], fm[RT + r], and each
// partial's weight e^(m_v - m) to wt[v * RT + r] (wt may be m_in).
__device__ __forceinline__ void fold_stats(const float* m_in, const float* l_in, int n, int RT,
                                           int r, float* wt, float* fm) {
  float m = REPRO_NEG_INF;
  for (int v = 0; v < n; ++v) m = fmaxf(m, m_in[v * RT + r]);
  float l = 0.f;
  for (int v = 0; v < n; ++v) {
    const float e = expf(m_in[v * RT + r] - m);
    wt[v * RT + r] = e;
    l = fmaf(l_in[v * RT + r], e, l);
  }
  fm[r] = m;
  fm[RT + r] = l;
}

__device__ __forceinline__ void wait_ring(int stages) {
  // cp.async.wait_group needs an immediate: stages - 2 groups may stay pending
  if (stages == 2) cp_async_wait<0>();
  else if (stages == 3) cp_async_wait<1>();
  else cp_async_wait<2>();
}

// Three blocks an SM (ptxas holds them to 168 registers).
template <typename TP, bool DQ_BF16>
__global__ void __launch_bounds__(128, 3) paged_split(const Params p) {
  constexpr int RG = row_groups(RT);
  constexpr int RR = RT / RG;      // query rows of a row group
  constexpr int LG = 32 / RG;      // lanes of a row group
  constexpr int DP = D_MAX / LG;   // head dims a lane holds
  constexpr int NPART = npart(RT);
  constexpr int NC = NPART / RR;   // page positions per chunk (>= 4)
  constexpr int LPR = NC / 2;      // lanes sharing a row after the reduce
  static_assert(NPART == 2 * LG, "the reduce leaves two scores a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, W = p.warps;
  const int s = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int h = y / p.n_rt, rt = y - h * p.n_rt;
  const int G = p.H / p.Hk, D = p.D, bs = p.bs;
  const int s0 = p.start[b];
  const int deepest = s0 + p.T - 1;
  const int n_live = deepest < 0 ? 0 : min(p.n_blocks, deepest / bs + 1);
  const int s_live = max(1, (n_live + p.pages - 1) / p.pages);
  if (s >= s_live) return;  // an empty split reads and writes nothing

  const int j0 = s * p.pages, j_end = min(j0 + p.pages, n_live);
  const int n_mine = j_end - j0 > w ? (j_end - j0 - w + W - 1) / W : 0;
  const int row_bytes = D * (int)sizeof(TP);
  const int kv_bytes = bs * row_bytes;
  unsigned char* ring = smem + (size_t)w * p.stages * p.slot_bytes;

  // copies of the lane's chunks: chunk e = lane + 32 i is row e / cpr,
  // column e % cpr. Where cpr divides 32 (every served shape) the lane
  // keeps one column and steps 32 / cpr rows; else (r, c) advance by
  // (32 / cpr, 32 % cpr) with a carry.
  const int cpb = p.cp_bytes, cpr = row_bytes / cpb, n_chunks = bs * cpr;
  const int dr = 32 / cpr, dc = 32 % cpr;
  const size_t pool_row = (size_t)p.hk_pool * row_bytes;
  const int r_lane = lane / cpr, c_lane = lane - r_lane * cpr;
  const size_t src_lane = r_lane * pool_row + c_lane * cpb;
  const int dst_lane = r_lane * row_bytes + c_lane * cpb;
  auto fetch = [&](int i, int slot) {
    const int page = p.tables[(size_t)b * p.n_blocks + j0 + w + i * W];
    unsigned char* dst = ring + slot * p.slot_bytes;
    const size_t base = ((size_t)page * bs * p.hk_pool + p.kv0 + h) * row_bytes;
    const unsigned char* ks = p.k_pool + base;
    const unsigned char* vs = p.v_pool + base;
    if (dc == 0 && cpb == 16) {
      for (int r = r_lane, d = dst_lane; r < bs; r += dr, d += dr * row_bytes) {
        const size_t so = src_lane + (size_t)(r - r_lane) * pool_row;
        cp_async16(dst + d, ks + so, 16);
        cp_async16(dst + kv_bytes + d, vs + so, 16);
      }
    } else {
      int r = r_lane, c = c_lane;
      for (int e = lane; e < n_chunks; e += 32) {
        const size_t so = r * pool_row + c * cpb;
        const int d = r * row_bytes + c * cpb;
        if (cpb == 16) {
          cp_async16(dst + d, ks + so, 16);
          cp_async16(dst + kv_bytes + d, vs + so, 16);
        } else {
          cp_async4(dst + d, ks + so, 4);
          cp_async4(dst + kv_bytes + d, vs + so, 4);
        }
        r += dr;
        c += dc;
        if (c >= cpr) { c -= cpr; ++r; }
      }
    }
    if constexpr (sizeof(TP) == 1) {
      float* sc = reinterpret_cast<float*>(dst + 2 * kv_bytes);
      for (int e = lane; e < bs; e += 32) {
        const size_t so = ((size_t)page * bs + e) * p.hk_pool + p.kv0 + h;
        cp_async4(sc + e, p.k_scale + so, 4);
        cp_async4(sc + bs + e, p.v_scale + so, 4);
      }
    }
  };

  // the ring's first pages are in flight while q is staged
  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < n_mine) fetch(i, i);
    cp_async_commit();
  }

  float* Qs = reinterpret_cast<float*>(smem + p.off_q);
  for (int e = tid; e < RT * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D, row = rt * RT + r;
    float x = 0.f;
    if (row < p.R) {
      const int t = row / G, g = row - t * G;
      const size_t off = (((size_t)b * p.T + t) * p.H + h * G + g) * D + d;
      x = (p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[off])
                    : static_cast<const float*>(p.q)[off]) * p.sm_scale;
    }
    Qs[e] = x;
  }
  __syncthreads();

  // lane = g * LG + l: row group g holds rows g * RR .. of the tile, lane l
  // of it head dims l * DP ..
  const int g = RG == 1 ? 0 : lane / LG, l = RG == 1 ? lane : lane - g * LG;
  const bool has_dims = l * DP < D;
  float qreg[RR][DP];
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int i = 0; i < DP; ++i) qreg[r][i] = has_dims ? Qs[(g * RR + r) * D + l * DP + i] : 0.f;

  // after the reduce, lane l holds the scores of its group's row l / LPR at
  // positions 2 (l % LPR) and 2 (l % LPR) + 1 of the chunk
  const int g_row = l / LPR, my_col = 2 * (l - g_row * LPR);
  const int my_row = g * RR + g_row;
  const int q_pos = s0 + (rt * RT + my_row) / G;
  float m_row = REPRO_NEG_INF, l_row = 0.f;
  float acc[RR][DP];
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[r][i] = 0.f;
  float* Pw = reinterpret_cast<float*>(smem + p.off_p) + (w * 2 * RG + g) * PBUF;
  int buf = 0;

  for (int i = 0; i < n_mine; ++i) {
    wait_ring(p.stages);
    __syncwarp();  // page i landed for every lane; slot (i - 1) is free
    if (i + p.stages - 1 < n_mine) fetch(i + p.stages - 1, (i + p.stages - 1) % p.stages);
    cp_async_commit();

    const unsigned char* Kt = ring + (i % p.stages) * p.slot_bytes;
    const unsigned char* Vt = Kt + kv_bytes;
    const float* ksc = reinterpret_cast<const float*>(Kt + 2 * kv_bytes);
    const float* vsc = ksc + bs;
    const int kv0 = (j0 + w + i * W) * bs;

    for (int c0 = 0; c0 < bs; c0 += NC) {
      float part[NPART];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kx[DP];
        if (c0 + c < bs) {
          page_dims<TP, DQ_BF16, DP>(Kt, ksc, c0 + c, D, l, kx);
        } else {
#pragma unroll
          for (int k = 0; k < DP; ++k) kx[k] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < RR; ++r) part[r * NC + c] = dot<DP>(qreg[r], kx);
      }

      butterfly<NPART / 2, LG / 2>(part, lane);
      butterfly<NPART / 4, LG / 4>(part, lane);
      butterfly<NPART / 8, LG / 8>(part, lane);
      butterfly<NPART / 16, LG / 16>(part, lane);
      if constexpr (LG == 32) butterfly<NPART / 32, 1>(part, lane);

      float sc[2], pr[2];
      bool valid[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int col = c0 + my_col + k;
        valid[k] = col < bs && kv0 + col <= q_pos;
        sc[k] = valid[k] ? part[k] : REPRO_NEG_INF;
      }
      float mx = fmaxf(sc[0], sc[1]);
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m_row, mx);
      const float corr = m_new == m_row ? 1.f : expf(m_row - m_new);
#pragma unroll
      for (int k = 0; k < 2; ++k) pr[k] = valid[k] ? expf(sc[k] - m_new) : 0.f;
      float ps = pr[0] + pr[1];
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) ps += __shfl_xor_sync(FULL, ps, o);
      l_row = l_row * corr + ps;
      m_row = m_new;

      float* P = Pw + buf * RG * PBUF;
      *reinterpret_cast<float2*>(P + 2 * l) = make_float2(pr[0], pr[1]);
      if (l == g_row * LPR) P[NPART + g_row] = corr;
      __syncwarp();

      if (__any_sync(FULL, corr != 1.f)) {  // else every row's factor is 1
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const float cr = P[NPART + r];
#pragma unroll
          for (int k = 0; k < DP; ++k) acc[r][k] *= cr;
        }
      }
#pragma unroll
      for (int c4 = 0; c4 < NC; c4 += 4) {
        float vx[4][DP];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c0 + c4 + c < bs) {
            page_dims<TP, DQ_BF16, DP>(Vt, vsc, c0 + c4 + c, D, l, vx[c]);
          } else {
#pragma unroll
            for (int k = 0; k < DP; ++k) vx[c][k] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const float4 pv = *reinterpret_cast<const float4*>(P + r * NC + c4);
#pragma unroll
          for (int k = 0; k < DP; ++k) {
            acc[r][k] = fmaf(pv.x, vx[0][k], acc[r][k]);
            acc[r][k] = fmaf(pv.y, vx[1][k], acc[r][k]);
            acc[r][k] = fmaf(pv.z, vx[2][k], acc[r][k]);
            acc[r][k] = fmaf(pv.w, vx[3][k], acc[r][k]);
          }
        }
      }
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's walk is done: its ring becomes its partial

  // ---- fold the warps, in warp order --------------------------------------
  float* Wacc = reinterpret_cast<float*>(smem);      // [W][RT][D]
  float* Wm = Wacc + W * RT * D;                     // [W][RT]
  float* Wl = Wm + W * RT;                           // [W][RT]
  float* Fw = reinterpret_cast<float*>(smem + p.off_w);  // [parts][RT] m, then weights
  float* Fl = Fw + FOLD_PARTS * RT;                  // [parts][RT] l
  float* Fm = Fl + FOLD_PARTS * RT;                  // [RT] folded m, then [RT] l
  if (l == g_row * LPR) {
    Wm[w * RT + my_row] = m_row;
    Wl[w * RT + my_row] = l_row;
  }
  if (has_dims) {
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int k = 0; k < DP; k += 4)
        *reinterpret_cast<float4*>(Wacc + (w * RT + g * RR + r) * D + l * DP + k) =
            make_float4(acc[r][k], acc[r][k + 1], acc[r][k + 2], acc[r][k + 3]);
  }
  __syncthreads();
  if (tid < RT) fold_stats(Wm, Wl, W, RT, tid, Fw, Fm);
  __syncthreads();

  const int ps = RT * D + 2 * RT;  // floats of one split's partial (16-byte multiple)
  float4* part_ws = s_live == 1 ? nullptr
                                : reinterpret_cast<float4*>(
                                      p.ws + ((size_t)b * gridDim.y + y) * p.splits * ps);
  // the folded row r of the block (or of the slot) over 4 dims, to out
  auto store = [&](int e4, float4 a) {
    const int r = 4 * e4 / D, d = 4 * e4 - r * D, row = rt * RT + r;
    if (row >= p.R) return;
    const int t = row / G, g = row - t * G;
    const size_t off = (((size_t)b * p.T + t) * p.H + h * G + g) * D + d;
    const float l = fmaxf(Fm[RT + r], 1e-30f);
    const float o[4] = {a.x / l, a.y / l, a.z / l, a.w / l};
    if (p.q_bf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
      uint2 u;
      u.x = *reinterpret_cast<unsigned*>(&lo);
      u.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + off) = u;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + off) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  };
  const int n4 = RT * D / 4, ps4 = ps / 4;
  for (int e4 = tid; e4 < n4; e4 += blockDim.x) {
    const int r = 4 * e4 / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = 0; v < W; ++v)
      a = fma4(reinterpret_cast<const float4*>(Wacc + v * RT * D)[e4], Fw[v * RT + r], a);
    if (s_live == 1) store(e4, a);
    else part_ws[(size_t)s * ps4 + e4] = a;
  }
  if (s_live == 1) return;

  // ---- ordered combine of the live splits, by the last block to finish ----
  float* stats = reinterpret_cast<float*>(part_ws + (size_t)s * ps4) + RT * D;
  if (tid < RT) {
    stats[tid] = Fm[tid];
    stats[RT + tid] = Fm[RT + tid];
  }
  __threadfence();
  __syncthreads();
  unsigned* ticket = p.tickets + (size_t)b * gridDim.y + y;
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == (unsigned)(s_live - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < s_live * RT; i += blockDim.x) {  // every split's m, l at once
    const float* sv = reinterpret_cast<const float*>(part_ws + (size_t)(i / RT) * ps4) + RT * D;
    Fw[i] = __ldcg(sv + i % RT);
    Fl[i] = __ldcg(sv + RT + i % RT);
  }
  __syncthreads();
  if (tid < RT) fold_stats(Fw, Fl, s_live, RT, tid, Fw, Fm);
  __syncthreads();
  for (int e4 = tid; e4 < n4; e4 += blockDim.x) {
    const int r = 4 * e4 / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int v = 0; v < s_live; ++v)
      a = fma4(__ldcg(part_ws + (size_t)v * ps4 + e4), Fw[v * RT + r], a);
    store(e4, a);
  }
  if (tid == 0) *ticket = 0u;  // the next call on this stream starts from 0
}

template <typename TP, bool DQ_BF16>
cudaError_t launch(const Params& p, int smem, cudaStream_t st) {
  auto kernel = paged_split<TP, DQ_BF16>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.splits, p.Hk * p.n_rt, p.B);
  kernel<<<grid, 32 * p.warps, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename TP, bool DQ_BF16 = false>
cudaError_t dispatch_rows(int rows, const Params& p, int smem, cudaStream_t st) {
  if (rows == RT) return launch<TP, DQ_BF16>(p, smem, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point. q (B, T, H, D) f32/bf16, pools (n_phys, bs, Hk, D) of
// pool_dtype (f32/bf16/int8), scales (n_phys, bs, Hk) f32 or null, tables
// (B, n_blocks) int32, start (B,) int32, out like q; all contiguous. ws (f32
// partials) and tickets (zeroed) are the wrapper's, null when splits == 1.
// ints: B, T, H, Hk, D, bs, n_blocks, q_dtype, pool_dtype, dequant_dtype,
// splits, pages, warps, stages, rows (4), cp_bytes, smem -- the plan's; the
// shared memory is recomputed here and a mismatch refuses the call -- then
// hk_pool, kv0: the pools hold hk_pool heads a position (their stride), of
// which the Hk from kv0 on are read.
extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale,
                                     const void* tables, const void* start, void* out, void* ws,
                                     void* tickets, const int* n, float sm_scale, void* stream) {
  Params p;
  p.q = q;
  p.k_pool = static_cast<const unsigned char*>(k_pool);
  p.v_pool = static_cast<const unsigned char*>(v_pool);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.start = static_cast<const int*>(start);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<unsigned*>(tickets);
  p.B = n[0]; p.T = n[1]; p.H = n[2]; p.Hk = n[3]; p.D = n[4]; p.bs = n[5];
  p.n_blocks = n[6];
  const int q_dtype = n[7], pool_dtype = n[8];
  p.dequant = n[9];
  p.splits = n[10]; p.pages = n[11]; p.warps = n[12]; p.stages = n[13];
  const int rows = n[14];
  p.cp_bytes = n[15];
  const int smem = n[16];
  p.hk_pool = n[17];
  p.kv0 = n[18];
  p.sm_scale = sm_scale;
  if (p.B <= 0 || p.T <= 0 || p.bs <= 0 || p.n_blocks <= 0 || p.Hk <= 0 || p.H % p.Hk ||
      p.D <= 0 || p.D % 4 || p.D > D_MAX || rows != RT || p.splits <= 0 ||
      p.pages <= 0 ||
      p.splits > MAX_SPLITS || p.warps < 1 || p.warps > 4 || p.stages < 2 || p.stages > 4 ||
      (p.cp_bytes != 16 && p.cp_bytes != 4) || p.kv0 < 0 || p.kv0 + p.Hk > p.hk_pool)
    return cudaErrorInvalidValue;
  if ((pool_dtype == DT_I8) != (k_scale != nullptr)) return cudaErrorInvalidValue;
  if (p.splits > 1 && (ws == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  if (q_dtype != DT_F32 && q_dtype != DT_BF16) return cudaErrorInvalidValue;
  p.q_bf16 = q_dtype == DT_BF16;
  p.R = p.T * (p.H / p.Hk);
  p.n_rt = (p.R + RT - 1) / RT;
  const int item = pool_dtype == DT_F32 ? 4 : pool_dtype == DT_BF16 ? 2 : 1;
  if ((p.D * item) % p.cp_bytes) return cudaErrorInvalidValue;
  const Layout L = layout(item, pool_dtype == DT_I8, p.bs, p.D, RT, p.warps, p.stages);
  if (L.total != smem) return cudaErrorInvalidValue;
  p.slot_bytes = L.slot;
  p.off_q = L.off_q;
  p.off_p = L.off_p;
  p.off_w = L.off_w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == DT_F32) return dispatch_rows<float>(rows, p, smem, st);
  if (pool_dtype == DT_BF16) return dispatch_rows<__nv_bfloat16>(rows, p, smem, st);
  if (pool_dtype == DT_I8)
    return p.dequant == DT_BF16 ? dispatch_rows<int8_t, true>(rows, p, smem, st)
                                : dispatch_rows<int8_t, false>(rows, p, smem, st);
  return cudaErrorInvalidValue;
}
