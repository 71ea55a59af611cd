// dot_moa body for small m (decode): stream B once, CUDA-core FMA.
//
// Block: MR rows of A x NB = 32 * VEC columns of B over one K sub-range
// [k0, k1) that lies inside one block_k slice (split mode only; the fold
// kernel sums the sub-partials and folds the slices). VEC = 16 / sizeof(T):
// a warp reads one 512-byte row of B, 16 bytes a lane, consecutive lanes on
// consecutive columns. B goes through a STAGES-deep cp.async ring of SROWS
// rows; warp w multiplies rows w, w + 8, ... of each stage, so the 8 warps
// hold 8 partials of the same MR x NB tile, summed in warp order at the end
// (through shared memory, reusing the ring). A's MR x (k1 - k0) values sit
// in shared memory in the accumulator type, read as broadcasts.
//
// At m <= 16 the product is 2*m flops per 2-byte weight: far under the
// tensor cores' ridge (~295 flops/byte), so the bound is reading B and the
// CUDA cores keep up (m = 4: 0.24 G multiply-adds for the gate projection,
// ~7 us at the f32 rate, against 35 us of bytes).
#pragma once

#include "dot_moa_common.cuh"

namespace dm {

constexpr int STREAM_STAGES = 4;
constexpr int STREAM_SROWS = 32;                 // rows of B per stage
constexpr int STREAM_A_BYTES = 32 * 1024;        // A's shared-memory budget

template <int MR> __host__ __device__ constexpr int stream_submax() { return STREAM_A_BYTES / (4 * MR); }

constexpr size_t STREAM_SMEM = size_t(STREAM_STAGES) * STREAM_SROWS * 512 + STREAM_A_BYTES;

template <typename T, typename Acc, int MR, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 2)
dot_moa_stream(const T* __restrict__ A, const T* __restrict__ B, Acc* __restrict__ ws, int M,
               int N, int K, int bk, int sub, int splits, int b_aligned, Batch bt) {
  using U = Unpack16<T, Acc>;
  constexpr int VEC = U::N;
  constexpr int NB = 32 * VEC;
  constexpr int SUBMAX = stream_submax<MR>();
  constexpr int CHUNKS = STREAM_SROWS * 32 / THREADS;   // 16-byte copies per thread per stage
  static_assert(MR * VEC <= 64, "stream body: at most 64 accumulators a thread");
  static_assert(MR * NB * 8 * 4 <= STREAM_STAGES * STREAM_SROWS * 512, "reduction buffer");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                        // [STAGES][SROWS][512 B]
  Acc* As = reinterpret_cast<Acc*>(smem + STREAM_STAGES * STREAM_SROWS * 512);   // [MR][SUBMAX]

  int k0, k1;
  split_range(blockIdx.z, K, bk, sub, splits, k0, k1);
  if (k0 >= k1) return;
  int bx = blockIdx.x;
  if constexpr (BATCHED) {
    const int e = batch_member(bt, bx);
    A += e * bt.sa;
    B += e * bt.sb;
    ws += e * bt.sw;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = bx * NB, r0 = blockIdx.y * MR;

  auto load_stage = [&](int k, int end, int slot) {
    unsigned char* dst = ring + slot * STREAM_SROWS * 512;
    if (b_aligned) {
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int e = tid + i * THREADS, r = e / 32, ch = e % 32;
        const int gk = k + r, gc = c0 + ch * VEC;
        const bool ok = gk < end && gc < N;
        const T* src = ok ? B + (size_t)gk * N + gc : B;
        cp_async16(dst + r * 512 + ch * 16, src, ok ? 16 : 0);
      }
    } else {   // rows of B not 16-byte aligned: element by element, zero past the edges
      T* d = reinterpret_cast<T*>(dst);
      for (int e = tid; e < STREAM_SROWS * NB; e += THREADS) {
        const int r = e / NB, c = e % NB;
        const int gk = k + r, gc = c0 + c;
        d[e] = (gk < end && gc < N) ? B[(size_t)gk * N + gc] : T{};
      }
    }
  };

  KCursor prod(k0, k1, bk), cons(k0, k1, bk);
#pragma unroll
  for (int s = 0; s < STREAM_STAGES - 1; ++s) {
    if (prod.valid()) {
      load_stage(prod.k, prod.end, s);
      prod.advance(STREAM_SROWS);
    }
    cp_async_commit();
  }
  // A's rows for this sub-range, zero past k1 up to a whole stage
  const int len = k1 - k0;
  const int lenr = (len + STREAM_SROWS - 1) / STREAM_SROWS * STREAM_SROWS;
  for (int e = tid; e < MR * lenr; e += THREADS) {
    const int r = e / lenr, kk = e % lenr;
    As[r * SUBMAX + kk] = (r0 + r < M && kk < len)
                              ? load_as(A[(size_t)(r0 + r) * K + k0 + kk], Acc(0))
                              : Acc(0);
  }

  Acc part[MR][VEC];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) part[r][v] = Acc(0);

  int slot = 0, pslot = STREAM_STAGES - 1;
  while (cons.valid()) {
    cp_async_wait<STREAM_STAGES - 2>();
    __syncthreads();
    if (prod.valid()) {
      load_stage(prod.k, prod.end, pslot);
      prod.advance(STREAM_SROWS);
    }
    cp_async_commit();
    pslot = (pslot + 1) % STREAM_STAGES;

    const unsigned char* st = ring + slot * STREAM_SROWS * 512;
    const int kl0 = cons.k - k0;
#pragma unroll
    for (int i = 0; i < STREAM_SROWS / 8; ++i) {
      const int rr = warp + 8 * i;
      Acc b[VEC];
      U::run(*reinterpret_cast<const uint4*>(st + rr * 512 + lane * 16), b);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const Acc a = As[r * SUBMAX + kl0 + rr];
#pragma unroll
        for (int v = 0; v < VEC; ++v) part[r][v] = mac(a, b[v], part[r][v]);
      }
    }
    cons.advance(STREAM_SROWS);
    slot = (slot + 1) % STREAM_STAGES;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 8 warps' partials of the tile, summed in warp order
  Acc* red = reinterpret_cast<Acc*>(ring);   // [8][MR][NB]
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[(warp * MR + r) * NB + lane * VEC + v] = part[r][v];
  __syncthreads();
  Acc* out = ws + (size_t)blockIdx.z * M * N;
  for (int e = tid; e < MR * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    Acc s = red[e];
#pragma unroll
    for (int w = 1; w < 8; ++w) s = add(s, red[w * MR * NB + e]);
    if (r0 + r < M && c0 + c < N) out[(size_t)(r0 + r) * N + c0 + c] = s;
  }
}

}  // namespace dm
