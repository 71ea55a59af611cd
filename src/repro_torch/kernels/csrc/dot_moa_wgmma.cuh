// dot_moa body for larger m, bf16 operands: Hopper's wgmma tensor cores.
//
// Block: a 64 x 128 output tile, 2 warpgroups, each issuing
// wgmma.mma_async m64n64k16 (bf16 -> f32) on its 64 columns. A cp.async
// ring (wg_stages) holds 64 x 64 of A and 64 x 128 of B per stage (24 KB),
// both in wgmma's 128-byte swizzled layout: rows of 128 bytes, 16-byte
// chunk c of row r stored at chunk c ^ (r % 8). A is K-major (a row of A
// is 64 values of K); B is N-major, as two 64-column halves (wgmma reads
// it transposed, which bf16 allows). Eight consecutive
// threads copy one 128-byte row, so the copies are coalesced and hit
// distinct banks. A stage never crosses a block_k boundary (KCursor) and is
// zero-filled past a slice's end and the matrix edges, which adds exact
// zeros. The first wgmma of each slice starts from zero (scale-d = 0) into
// the partial; after the slice's last stage the partial is folded into the
// accumulator in registers (ONE: the block's range is one slice, no
// accumulator); in split mode the one sub-range partial goes to the
// workspace. The grid walks row tiles fastest, so the blocks that share a
// column strip of B run together and read it once from memory.
//
// Tried on the H100 and dropped: wgmma's no-swizzle layout (8 x 16-byte
// core matrices), slower than mma.sync at the m = 64 served shapes; and
// keeping one wgmma group in flight across stages (two stages of copies
// ahead, or one block an SM with eight), slower than waiting for each
// stage's wgmma with three stages of copies in flight.
//
// cp.async and not TMA: a TMA box zero-fills only outside the tensor, so a
// stage cut at a block_k boundary that is not a multiple of the box
// (block_k 75, 363, ragged 1000) would need its tail cleared by hand, while
// a cp.async copy zero-fills to the byte.
//
// int8 stays on mma.sync (dot_moa_tc.cuh): wgmma takes 8-bit operands
// K-major only, and B is N-major (a row of the weight is a row of K).
#pragma once

#include "dot_moa_common.cuh"

namespace dm {

constexpr int WG_BM = 64, WG_BN = 128, WG_BK = 64;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2, WG_B_BYTES = WG_BK * WG_BN * 2;
constexpr int WG_STAGE = WG_A_BYTES + WG_B_BYTES;
// Ring depth and blocks an SM: a one-slice block (no accumulator beside the
// partial) fits 128 registers, two blocks of 4 stages an SM; a block that
// folds slices keeps 64 accumulators a thread and runs alone on its SM,
// with 8 stages (at 128 registers it spilled, and ran slower).
template <bool ONE> __host__ __device__ constexpr int wg_stages() { return ONE ? 4 : 8; }
// + 1024: the swizzle atoms (8 rows of 128 bytes) start on 1024 bytes
template <bool ONE> __host__ __device__ constexpr size_t wg_smem() {
  return size_t(wg_stages<ONE>()) * WG_STAGE + 1024;
}

template <bool ONE, typename OutT, bool BATCHED>
__global__ void __launch_bounds__(THREADS, ONE ? 2 : 1)
dot_moa_wgmma(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
              OutT* __restrict__ C, float* __restrict__ ws, int M, int N, int K, int bk,
              int sub, int splits, int a_aligned, int b_aligned, Batch bt) {
  using T = __nv_bfloat16;
  constexpr int STAGES = wg_stages<ONE>();
  static_assert(THREADS == 256, "two warpgroups");
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  int bx = blockIdx.x;
  if constexpr (BATCHED) {
    const int e = batch_member(bt, bx);
    A += e * bt.sa;
    B += e * bt.sb;
    C = member_ptr(C, e, bt.sc);
    ws = member_ptr(ws, e, bt.sw);
  }
  const int m0 = bx * WG_BM, n0 = blockIdx.y * WG_BN;

  int k0 = 0, k1 = K;
  if (ws != nullptr) {
    split_range(blockIdx.z, K, bk, sub, splits, k0, k1);
    if (k0 >= k1) return;
  }

  // byte offset of A(r, c) (c < 64) and of B(r, c) (c < 128) in a stage
  auto a_off = [](int r, int c) { return r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2; };
  auto b_off = [](int r, int c) {
    return (c / 64) * (WG_BK * 128) + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
  };

  auto load_stage = [&](int k, int end, int slot) {
    unsigned char* As = smem + slot * WG_STAGE;
    unsigned char* Bs = As + WG_A_BYTES;
    if (a_aligned) {
#pragma unroll
      for (int i = 0; i < WG_A_BYTES / 16 / THREADS; ++i) {   // chunk e: row e / 8
        const int e = tid + i * THREADS, r = e / 8, c = (e % 8) * 8, gk = k + c;
        const int valid = (m0 + r < M) ? max(0, min(8, end - gk)) : 0;
        cp_async16(As + a_off(r, c), valid ? A + (size_t)(m0 + r) * K + gk : A, valid * 2);
      }
    } else {
      for (int e = tid; e < WG_BM * WG_BK; e += THREADS) {
        const int r = e / WG_BK, c = e % WG_BK, gk = k + c;
        *reinterpret_cast<T*>(As + a_off(r, c)) =
            (m0 + r < M && gk < end) ? A[(size_t)(m0 + r) * K + gk] : T{};
      }
    }
    if (b_aligned) {
#pragma unroll
      for (int i = 0; i < WG_B_BYTES / 16 / THREADS; ++i) {   // chunk e: half e / 512
        const int e = tid + i * THREADS, r = (e / 8) % WG_BK;
        const int c = (e / (8 * WG_BK)) * 64 + (e % 8) * 8, gk = k + r, gc = n0 + c;
        const bool ok = gk < end && gc < N;
        cp_async16(Bs + b_off(r, c), ok ? B + (size_t)gk * N + gc : B, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < WG_BK * WG_BN; e += THREADS) {
        const int r = e / WG_BN, c = e % WG_BN, gk = k + r, gc = n0 + c;
        *reinterpret_cast<T*>(Bs + b_off(r, c)) =
            (gk < end && gc < N) ? B[(size_t)gk * N + gc] : T{};
      }
    }
  };

  float part[32], acc[ONE ? 1 : 32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;

  KCursor prod(k0, k1, bk), cons(k0, k1, bk);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (prod.valid()) {
      load_stage(prod.k, prod.end, s);
      prod.advance(WG_BK);
    }
    cp_async_commit();
  }
  [[maybe_unused]] bool first = true;
  bool fresh = true;
  int slot = 0, pslot = STAGES - 1;
  while (cons.valid()) {
    cp_async_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();   // the last stage's wgmma is done: its slot may be refilled
    if (prod.valid()) {
      load_stage(prod.k, prod.end, pslot);
      prod.advance(WG_BK);
    }
    cp_async_commit();
    pslot = (pslot + 1) % STAGES;

    const unsigned char* As = smem + slot * WG_STAGE;
    const unsigned char* Bs = As + WG_A_BYTES + wg * (WG_BK * 128);   // this warpgroup's half
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks)   // 16 values of K: 32 bytes along A's rows,
      wgmma_64x64_ss<1>(part, wg_desc(As + ks * 32, 16, 1024),   // 16 rows of B
                        wg_desc(Bs + ks * 2048, WG_BK * 128, 1024), fresh && ks == 0 ? 0 : 1);
    wg_commit();
    wg_wait_all();
    fresh = false;
    if constexpr (!ONE) {
      if (cons.slice_done(WG_BK)) {   // the slice's partial is complete: fold it
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = first ? part[i] : acc[i] + part[i];
        first = false;
        fresh = true;
      }
    }
    cons.advance(WG_BK);
    slot = (slot + 1) % STAGES;
  }
  cp_async_wait<0>();

  const float* res = ONE ? part : acc;
  // d[4 j + q] at row 16 warp + lane / 4 + 8 (q / 2), column 8 j + 2 (lane % 4) + q % 2
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = m0 + warp * 16 + lane / 4 + (q / 2) * 8;
      const int c = n0 + wg * 64 + j * 8 + 2 * (lane % 4) + q % 2;
      if (r >= M || c >= N) continue;
      if (ws != nullptr)
        ws[(size_t)blockIdx.z * M * N + (size_t)r * N + c] = res[4 * j + q];
      else
        C[(size_t)r * N + c] = store_as<OutT>(res[4 * j + q]);
    }
}

}  // namespace dm
