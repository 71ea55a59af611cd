// dot_moa body for larger m, int8 operands: mma.sync tensor cores.
//
// Block: a 64 x 128 output tile, 8 warps of 32 x 32 (2 x 4), each issuing
// mma.sync m16n8k32 (s8 -> s32, wrapping). A STAGES-deep cp.async ring
// holds 64 x 64 of A and 64 x 128 of B per stage (64 bytes of K), rows
// padded by 16 bytes so ldmatrix reads hit distinct banks. A stage never
// crosses a block_k boundary (KCursor) and is zero-filled past a slice's
// end and the matrix edges, which adds exact zeros. Each slice is summed
// into a fresh register partial, then folded into the accumulator (+ or
// loa_fold) in registers; in split mode the block's one sub-range partial
// goes to the workspace.
//
// A reaches its fragments by ldmatrix; B has no transposing ldmatrix at
// byte width, so its fragments are gathered from shared memory a byte at
// a time.
//
// mma.sync and not wgmma (which carries bf16, dot_moa_wgmma.cuh): wgmma
// takes 8-bit operands K-major only, and B is N-major (a row of the weight
// is a row of K), so it would need B transposed on its way into shared
// memory.
#pragma once

#include "dot_moa_common.cuh"

namespace dm {

constexpr int TC_BM = 64, TC_BN = 128, TC_STAGES = 4;
constexpr int TC_KBYTES = 64;                      // bytes of K per stage
constexpr int TC_AROW = TC_KBYTES + 16;            // padded row of the A tile, bytes

template <typename T> struct TcTraits;
template <> struct TcTraits<int8_t> {
  using Acc = int;
  using Out = int;
  static constexpr int BK = 64, KSTEP = 32;
};

template <typename T> __host__ __device__ constexpr int tc_brow() { return TC_BN * int(sizeof(T)) + 16; }
template <typename T> __host__ __device__ constexpr size_t tc_stage_bytes() {
  return size_t(TC_BM) * TC_AROW + size_t(TcTraits<T>::BK) * tc_brow<T>();
}
template <typename T> __host__ __device__ constexpr size_t tc_smem() { return TC_STAGES * tc_stage_bytes<T>(); }

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of the 4 n8 tiles of a warp for one k step: b0 holds
// B[kb + 4 (lane % 4) + 0..3][n], b1 the same 16 rows on, n = lane / 4
__device__ __forceinline__ void b_frags(unsigned (&b)[4][2], const unsigned char* Bs, int kb,
                                        int n0, int lane) {
  constexpr int BROW = tc_brow<int8_t>();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* p = Bs + (kb + 16 * h + 4 * (lane % 4)) * BROW + n0 + nt * 8 + lane / 4;
      b[nt][h] = unsigned(p[0]) | (unsigned(p[BROW]) << 8) | (unsigned(p[2 * BROW]) << 16) |
                 (unsigned(p[3 * BROW]) << 24);
    }
  }
}

template <typename T, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 2)
dot_moa_tc(const T* __restrict__ A, const T* __restrict__ B,
           typename TcTraits<T>::Out* __restrict__ C, typename TcTraits<T>::Acc* __restrict__ ws,
           int M, int N, int K, int bk, int sub, int splits, int a_aligned, int b_aligned,
           int approx_bits, Batch bt) {
  using Acc = typename TcTraits<T>::Acc;
  using Out = typename TcTraits<T>::Out;
  constexpr int BK = TcTraits<T>::BK, KSTEP = TcTraits<T>::KSTEP;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int BROW = tc_brow<T>();
  constexpr size_t STAGE = tc_stage_bytes<T>();
  constexpr int B_CHUNKS = BK * (TC_BN / VEC) / THREADS;   // 16-byte copies of B per thread
  static_assert(TC_BM * (BK / VEC) == THREADS, "one 16-byte copy of A per thread");

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  int bx = blockIdx.x;
  if constexpr (BATCHED) {
    const int e = batch_member(bt, bx);
    A += e * bt.sa;
    B += e * bt.sb;
    C = member_ptr(C, e, bt.sc);
    ws = member_ptr(ws, e, bt.sw);
  }
  const int m0 = blockIdx.y * TC_BM, n0 = bx * TC_BN;

  int k0 = 0, k1 = K;
  if (ws != nullptr) {
    split_range(blockIdx.z, K, bk, sub, splits, k0, k1);
    if (k0 >= k1) return;
  }

  auto load_stage = [&](int k, int end, int slot) {
    unsigned char* As = smem + slot * STAGE;
    unsigned char* Bs = As + TC_BM * TC_AROW;
    if (a_aligned) {
      const int r = tid / (BK / VEC), ch = tid % (BK / VEC);
      const int gk = k + ch * VEC;
      const int valid = (m0 + r < M) ? max(0, min(VEC, end - gk)) : 0;
      const T* src = valid ? A + (size_t)(m0 + r) * K + gk : A;
      cp_async16(As + r * TC_AROW + ch * 16, src, valid * int(sizeof(T)));
    } else {
      for (int e = tid; e < TC_BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int gk = k + c;
        reinterpret_cast<T*>(As + r * TC_AROW)[c] =
            (m0 + r < M && gk < end) ? A[(size_t)(m0 + r) * K + gk] : T{};
      }
    }
    if (b_aligned) {
#pragma unroll
      for (int i = 0; i < B_CHUNKS; ++i) {
        const int e = tid + i * THREADS, r = e / (TC_BN / VEC), ch = e % (TC_BN / VEC);
        const int gk = k + r, gc = n0 + ch * VEC;
        const bool ok = gk < end && gc < N;
        cp_async16(Bs + r * BROW + ch * 16, ok ? B + (size_t)gk * N + gc : B, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BK * TC_BN; e += THREADS) {
        const int r = e / TC_BN, c = e % TC_BN;
        const int gk = k + r, gc = n0 + c;
        reinterpret_cast<T*>(Bs + r * BROW)[c] =
            (gk < end && gc < N) ? B[(size_t)gk * N + gc] : T{};
      }
    }
  };

  Acc part[2][4][4], acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][j][q] = acc[i][j][q] = Acc(0);

  KCursor prod(k0, k1, bk), cons(k0, k1, bk);
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (prod.valid()) {
      load_stage(prod.k, prod.end, s);
      prod.advance(BK);
    }
    cp_async_commit();
  }
  bool first = true;
  int slot = 0, pslot = TC_STAGES - 1;
  while (cons.valid()) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (prod.valid()) {
      load_stage(prod.k, prod.end, pslot);
      prod.advance(BK);
    }
    cp_async_commit();
    pslot = (pslot + 1) % TC_STAGES;

    const unsigned char* As = smem + slot * STAGE;
    const unsigned char* Bs = As + TC_BM * TC_AROW;
#pragma unroll
    for (int ks = 0; ks < BK / KSTEP; ++ks) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt], As + (wm * 32 + mt * 16 + lane % 16) * TC_AROW + ks * 32 + (lane / 16) * 16);
      b_frags(b, Bs, ks * KSTEP, wn * 32, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(part[mt][nt], a[mt], b[nt]);
    }
    if (cons.slice_done(BK)) {   // the slice's partial is complete: fold it
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][j][q] = first ? part[i][j][q] : fold(acc[i][j][q], part[i][j][q], approx_bits);
            part[i][j][q] = Acc(0);
          }
      first = false;
    }
    cons.advance(BK);
    slot = (slot + 1) % TC_STAGES;
  }
  cp_async_wait<0>();

  // c0, c1 at (lane / 4, 2 (lane % 4) + 0..1); c2, c3 eight rows down
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + wm * 32 + mt * 16 + lane / 4 + (q / 2) * 8;
        const int c = n0 + wn * 32 + nt * 8 + 2 * (lane % 4) + q % 2;
        if (r >= M || c >= N) continue;
        if (ws != nullptr)
          ws[(size_t)blockIdx.z * M * N + (size_t)r * N + c] = acc[mt][nt][q];
        else
          C[(size_t)r * N + c] = store_as<Out>(acc[mt][nt][q]);
      }
}

}  // namespace dm
