// Column reduction (n, f) -> (f,) in one launch, shared by moa_reduce.cu and
// loa_add.cu (loa_reduce).
//
// The TPU kernels (moa_reduce_pallas, loa_reduce_pallas) walk the operand
// axis in block_n-row clusters on the sequential trailing grid axis: each
// cluster is tree-summed, and the cluster sums are folded in cluster order
// into one accumulator held in VMEM (by +, or by the LOA combine). CUDA
// blocks run in no order, so kernels/moa_reduce.py:plan picks, from the
// shapes alone, one of two routes for a grid of 256-thread blocks:
//
//   assoc    integer operands folded by + (a wrapping int32 sum has the same
//            bits in any order), and any sum of a single cluster: the rows
//            are split evenly over enough blocks to fill the card.
//   ordered  f32 accumulation (f32 and bf16 operands) and LOA folds with
//            l > 0, over more than one cluster: a block's rows never cross
//            a cluster boundary (a cluster longer than a block is cut into
//            segments), and the cluster sums are folded in cluster order.
//
// A block reads its rows with 16-byte loads along the columns (4 f32 or
// int32 words, 8 bf16, 16 int8; one word where the base pointer or the row
// pitch is not a 16-byte multiple), eight rows in flight a thread, and joins
// its row lanes by shuffles and shared memory into one partial a column.
// With one split that partial is the result. Else the block writes it to
// the workspace, and the block that draws the last ticket of its column
// tile (its release-acquire ticket, atom.acq_rel.gpu) finishes the tile,
// then sets the ticket back to 0 (so the workspace needs no fill, and one
// launch does it all). On the assoc route it sums the partials with all
// its lanes. On the ordered route, in passes of clusters, all its threads
// sum each cluster's segments in split order from L2, and one thread a 4
// columns folds the cluster sums in cluster order by Fold::apply (+, or
// loa_fold). Where a cluster is one row of at most 16 bytes
// (DIRECT_ROW_BYTES in kernels/moa_reduce.py), one block folds x itself,
// since the partials would be a copy of x, one split block a row: it stages
// x through a ring of kStages chunks in shared memory with cp.async, and a
// column's fold loads its next rows while it folds the current ones, so a
// step waits on the add, not on a load.
//
// Bound on the H100: reading x once (bytes / 3.35 TB/s) on both routes; on
// the ordered route also the fold chain, n / block_n dependent steps of
// Fold::apply a column, which no split can shorten (it is the contract).
// Two calls give the same bits: every sum's order is fixed by the lane, the
// split and the cluster index, never by which block ends first.

#pragma once

#include "sm90.cuh"

namespace cluster {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident blocks an SM, at the least (registers <= 64)
constexpr int kStages = 4;     // chunks in the fold's ring (STAGES in kernels/moa_reduce.py)

// The ticket: an atomic add with release and acquire semantics at gpu scope.
// After a __syncthreads, the release orders the block's partials before the
// ticket (it is cumulative); the block that draws the last ticket acquires
// every other block's.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

template <typename Acc> __device__ __forceinline__ Acc add(Acc a, Acc b);
template <> __device__ __forceinline__ float add<float>(float a, float b) { return a + b; }
// int32 sums wrap modulo 2**32 (unsigned arithmetic: no undefined behaviour)
template <> __device__ __forceinline__ int add<int>(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <typename T, typename Acc> __device__ __forceinline__ Acc to_acc(T x);
template <> __device__ __forceinline__ float to_acc<float, float>(float x) { return x; }
template <> __device__ __forceinline__ float to_acc<__nv_bfloat16, float>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ int to_acc<int8_t, int>(int8_t x) { return x; }
template <> __device__ __forceinline__ int to_acc<int, int>(int x) { return x; }

// word k of T in the 16 bytes w (little-endian: element 0 in the low bits)
template <typename T, typename Acc>
__device__ __forceinline__ Acc unpack(const unsigned (&w)[4], int k);
template <> __device__ __forceinline__ float unpack<float, float>(const unsigned (&w)[4], int k) {
  return __uint_as_float(w[k]);
}
template <> __device__ __forceinline__ int unpack<int, int>(const unsigned (&w)[4], int k) {
  return static_cast<int>(w[k]);
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16, float>(const unsigned (&w)[4], int k) {
  return __uint_as_float(k & 1 ? w[k >> 1] & 0xffff0000u : w[k >> 1] << 16);
}
template <> __device__ __forceinline__ int unpack<int8_t, int>(const unsigned (&w)[4], int k) {
  return static_cast<int8_t>(w[k >> 2] >> (8 * (k & 3)));
}

// One call's plan (kernels/moa_reduce.py:Plan.c_args gives it in this order).
struct Params {
  const void* x;
  void* ws;             // partials: col_tiles x splits rows of wp accumulators
  unsigned* tickets;    // one a column tile, always left at 0
  void* out;
  long long n;          // rows of x
  long long cluster_rows;  // rows of a cluster (n on the assoc route)
  long long seg_rows;   // rows of a split block
  long long splits;     // split blocks of a column tile; 0: fold straight from x
  int f;                // columns
  int group;            // rows of the fold's source a cluster: spc, or 1 from x
  int tile_v;           // 16-byte vectors (or words) of a column tile
  int lanes;            // row lanes of a block: tile_v * lanes == kThreads
  int wp;               // row pitch of the partials, a multiple of 4
  int chunk;            // rows a ring stage (fold of x), or clusters a pass (of partials)
  int approx_bits;
};

struct Launch {
  Params p;
  int vec;
  long long blocks;
  int smem;
};

// a: Plan.c_args -- n, cluster_rows, seg_rows, splits, f, group, tile_v,
// lanes, wp, chunk, approx_bits, vec, blocks, smem
inline Launch launch_of(const void* x, void* ws, void* tickets, void* out, const long long* a) {
  Launch l;
  l.p = Params{x, ws, static_cast<unsigned*>(tickets), out, a[0], a[1], a[2], a[3],
               static_cast<int>(a[4]), static_cast<int>(a[5]), static_cast<int>(a[6]),
               static_cast<int>(a[7]), static_cast<int>(a[8]), static_cast<int>(a[9]),
               static_cast<int>(a[10])};
  l.vec = static_cast<int>(a[11]);
  l.blocks = a[12];
  l.smem = static_cast<int>(a[13]);
  return l;
}

// Shared memory of join_lanes over tv threads of vec accumulators a row lane
// (kernels/moa_reduce.py:join_bytes).
inline long long join_bytes(int tv, int vec) {
  const int groups = tv < 32 ? kThreads / 32 : kThreads / tv;
  return 4LL * groups * tv * vec;
}

inline bool valid(const Launch& l) {
  const Params& p = l.p;
  const int last_tv = p.tile_v * l.vec / 4 > 1 ? p.tile_v * l.vec / 4 : 1;
  return p.n > 0 && p.f > 0 && p.tile_v > 0 && p.tile_v * p.lanes == kThreads && p.group > 0 &&
         p.chunk > 0 && p.wp % 4 == 0 && l.blocks > 0 && l.blocks < (1LL << 31) &&
         p.approx_bits >= 0 && p.approx_bits <= 31 &&
         (p.splits != 0 || p.group == 1) &&  // fold_x: one row a cluster
         (p.splits <= 1 || (p.ws != nullptr && p.tickets != nullptr)) &&
         // shared memory: the block's join, and the last block's join or fold
         (p.splits == 0 || l.smem >= join_bytes(p.tile_v, l.vec)) &&
         (p.splits <= 1 || l.smem >= (p.group == p.splits ? join_bytes(last_tv, 4)
                                                          : 4LL * p.chunk * p.wp));
}

template <typename T, int VEC> struct Raw { using type = uint4; };
template <typename T> struct Raw<T, 1> { using type = T; };

// COHERENT: a load through L2 only (ld.global.cg), for partials that other
// blocks of this launch wrote; else the read-only path (x is never written).
template <typename T, int VEC, bool COHERENT>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  if constexpr (VEC == 1) {
    if constexpr (COHERENT) return __ldcg(p);
    else return *p;
  } else {
    if constexpr (COHERENT) return __ldcg(reinterpret_cast<const uint4*>(p));
    else return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, typename Acc, int VEC>
__device__ __forceinline__ void add_raw(Acc (&a)[VEC], const typename Raw<T, VEC>::type& r) {
  if constexpr (VEC == 1) {
    a[0] = add<Acc>(a[0], to_acc<T, Acc>(r));
  } else {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = add<Acc>(a[k], unpack<T, Acc>(w, k));
  }
}

// This thread's sums of rows [r0, r1) of a row-major matrix (`pitch` words
// a row, `ncols` columns): its VEC columns start at col0 + (threadIdx.x %
// tv) * VEC, and row lane threadIdx.x / tv takes every lanes-th row, D
// loads in flight (8 16-byte loads, 4 where a load unpacks into 16 words).
template <typename T, typename Acc, int VEC, bool COHERENT = false>
__device__ __forceinline__ void row_sums(Acc (&a)[VEC], const T* __restrict__ x, long long pitch,
                                         long long ncols, long long col0, int tv, int lanes,
                                         long long r0, long long r1) {
  constexpr int D = VEC >= 16 ? 4 : 8;
#pragma unroll
  for (int k = 0; k < VEC; ++k) a[k] = Acc(0);
  const long long col = col0 + (threadIdx.x % tv) * VEC;
  if (col >= ncols) return;
  const long long step = lanes;
  const T* q = x + col;
  long long r = r0 + threadIdx.x / tv;
  for (; r + (D - 1) * step < r1; r += D * step) {
    typename Raw<T, VEC>::type u[D];
#pragma unroll
    for (int d = 0; d < D; ++d) u[d] = load_raw<T, VEC, COHERENT>(q + (r + d * step) * pitch);
#pragma unroll
    for (int d = 0; d < D; ++d) add_raw<T, Acc, VEC>(a, u[d]);
  }
  for (; r < r1; r += step) add_raw<T, Acc, VEC>(a, load_raw<T, VEC, COHERENT>(q + r * pitch));
}

// Join the row lanes of row_sums: a butterfly over the lanes that share a
// warp, then the warps' (or lanes') sums in order through red; store(e,
// sum) for element e of the tv * VEC columns.
template <typename Acc, int VEC, typename Store>
__device__ __forceinline__ void join_lanes(Acc (&a)[VEC], Acc* red, int tv, int lanes,
                                           Store store) {
  const int width = tv * VEC;
  if (tv < 32) {
    for (int o = tv; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = add<Acc>(a[k], __shfl_xor_sync(0xffffffffu, a[k], o));
    }
  }
  const int groups = tv < 32 ? kThreads / 32 : lanes;
  const int g = threadIdx.x / (tv < 32 ? 32 : tv), v = threadIdx.x % tv;
  if (tv >= 32 || threadIdx.x % 32 < tv) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[g * width + v * VEC + k] = a[k];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < width; e += kThreads) {
    Acc s = red[e];
    for (int h = 1; h < groups; ++h) s = add<Acc>(s, red[h * width + e]);
    store(e, s);
  }
}

// C adjacent words, read from shared memory in one load.
template <typename ST, int C> struct __align__(sizeof(ST) * C) Pack { ST v[C]; };

// acc[k] <- Fold(acc[k], word k of row i) for rows i < count of v, `stride`
// words apart (a multiple of C), in order; the first row of the whole fold
// starts it. Two batches of rows ping-pong through registers: one loads
// while the other folds, so a step waits on the fold, not on shared memory.
template <typename Acc, typename Fold, typename ST, int C>
__device__ __forceinline__ void chain(Acc (&acc)[C], bool& first, const ST* v, int stride,
                                      int count, int l) {
  using P = Pack<ST, C>;
  constexpr int B = C == 1 ? 8 : 1;  // rows a batch (C words a row)
  const P* pv = reinterpret_cast<const P*>(v);
  const int ps = stride / C;
  auto step = [&](const P& r) {
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = Fold::apply(acc[k], to_acc<ST, Acc>(r.v[k]), l);
  };
  int i = 0;
  if (count > 0 && first) {
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = to_acc<ST, Acc>(pv[0].v[k]);
    first = false;
    i = 1;
  }
  if (i + 2 * B <= count) {
    P a[B], b[B];
#pragma unroll
    for (int k = 0; k < B; ++k) a[k] = pv[(i + k) * ps];
#pragma unroll
    for (int k = 0; k < B; ++k) b[k] = pv[(i + B + k) * ps];
    for (; i + 4 * B <= count; i += 2 * B) {
#pragma unroll
      for (int k = 0; k < B; ++k) step(a[k]);
#pragma unroll
      for (int k = 0; k < B; ++k) a[k] = pv[(i + 2 * B + k) * ps];
#pragma unroll
      for (int k = 0; k < B; ++k) step(b[k]);
#pragma unroll
      for (int k = 0; k < B; ++k) b[k] = pv[(i + 3 * B + k) * ps];
    }
#pragma unroll
    for (int k = 0; k < B; ++k) step(a[k]);
#pragma unroll
    for (int k = 0; k < B; ++k) step(b[k]);
    i += 2 * B;
  }
  for (; i < count; ++i) step(pv[i * ps]);
}

// Fold x itself for one column tile, in order: n rows at pitch f, one row a
// cluster, the tile's first column at src[0]. All threads stage chunks of
// p.chunk rows of the tile (at pitch sp in shared memory) through the ring
// with cp.async, 16 bytes a copy where VEC16, else a word; thread t < cols
// folds column t's rows.
template <typename Acc, typename Fold, typename T, bool VEC16>
__device__ __forceinline__ void fold_x(const Params& p, const T* __restrict__ src, int cols, int sp,
                                       Acc* __restrict__ out, unsigned char* smem) {
  T* ring = reinterpret_cast<T*>(smem);
  const int chunk = p.chunk, t = threadIdx.x;
  const long long rows = p.n, pitch = p.f;
  const long long n_chunks = (rows + chunk - 1) / chunk;
  auto issue = [&](long long q) {
    if (q < n_chunks) {
      const long long row0 = q * chunk;
      const int nr = static_cast<int>(min(static_cast<long long>(chunk), rows - row0));
      T* dst = ring + static_cast<int>(q % kStages) * chunk * sp;
      const T* from = src + row0 * pitch;
      if constexpr (VEC16) {
        const int per = cols * static_cast<int>(sizeof(T)) / 16;
        for (int u = t; u < nr * per; u += kThreads) {
          const int r = u / per, c = u - r * per;
          cp_async16(reinterpret_cast<unsigned char*>(dst + r * sp) + 16 * c,
                     reinterpret_cast<const unsigned char*>(from + r * pitch) + 16 * c, 16);
        }
      } else {
        static_assert(sizeof(T) == 4, "word copies take 4-byte words");
        for (int u = t; u < nr * cols; u += kThreads) {
          const int r = u / cols, c = u - r * cols;
          cp_async4(dst + r * sp + c, from + r * pitch + c, 4);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait count
  };
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  Acc acc[1] = {Acc(0)};
  bool first = true;
  for (long long q = 0; q < n_chunks; ++q) {
    issue(q + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* st = ring + static_cast<int>(q % kStages) * chunk * sp;
    const int nr = static_cast<int>(min(static_cast<long long>(chunk), rows - q * chunk));
    if (t < cols) chain<Acc, Fold, T, 1>(acc, first, st + t, sp, nr, p.approx_bits);
    __syncthreads();  // the slot is refilled by the next iteration's issue
  }
  if (t < cols) out[t] = acc[0];
}

// 4 accumulator words of the partials, through L2 (other blocks wrote them).
template <typename Acc>
__device__ __forceinline__ Pack<Acc, 4> load_partial(const Acc* v) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(v));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  Pack<Acc, 4> r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.v[k] = unpack<Acc, Acc>(w, k);
  return r;
}

// The ordered fold of a column tile's partials (p.splits rows at pitch wp,
// p.group = spc to a cluster): in passes of p.chunk clusters, all threads
// sum each (cluster, 4 columns)'s partials in split order, two loads in
// flight (four spill at 64 registers), into shared memory; then thread
// t < quads folds its 4 columns' cluster sums in cluster order.
template <typename Acc, typename Fold>
__device__ __forceinline__ void fold_partials(const Params& p, const Acc* ws, int cols,
                                              Acc* __restrict__ out, Acc* sums) {
  using PA = Pack<Acc, 4>;
  const int quads = (cols + 3) / 4, sw = 4 * quads, t = threadIdx.x, l = p.approx_bits;
  const int spc = p.group;
  const long long n_clusters = p.splits / spc, pitch = p.wp;
  auto plus = [](PA& a, const PA& b) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.v[k] = add<Acc>(a.v[k], b.v[k]);
  };
  Acc acc[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
  bool first = true;
  for (long long c0 = 0; c0 < n_clusters; c0 += p.chunk) {
    const int ncl = static_cast<int>(min(static_cast<long long>(p.chunk), n_clusters - c0));
    for (int u = t; u < ncl * quads; u += kThreads) {
      const int c = u / quads, qc = u - c * quads;
      const Acc* v = ws + (c0 + c) * spc * pitch + 4 * qc;
      PA sum = load_partial(v);
      int j = 1;
      for (; j + 1 < spc; j += 2) {
        const PA r0 = load_partial(v + j * pitch), r1 = load_partial(v + (j + 1) * pitch);
        plus(sum, r0);
        plus(sum, r1);
      }
      if (j < spc) plus(sum, load_partial(v + j * pitch));
      reinterpret_cast<PA*>(sums + c * sw)[qc] = sum;
    }
    __syncthreads();
    if (t < quads) chain<Acc, Fold, Acc, 4>(acc, first, sums + 4 * t, sw, ncl, l);
    __syncthreads();  // sums is rewritten by the next pass
  }
  if (t < quads) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * t + k < cols) out[4 * t + k] = acc[k];
  }
}

// The whole call: block blockIdx.x of the plan's 1-D grid.
template <typename T, typename Acc, typename Fold, int VEC>
__device__ __forceinline__ void reduce(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int width = p.tile_v * VEC;
  const T* x = static_cast<const T*>(p.x);
  if (p.splits == 0) {  // one block a column tile folds x itself
    if constexpr (VEC > 1 || sizeof(T) == 4) {
      const long long c0 = static_cast<long long>(blockIdx.x) * width;
      const int cols = static_cast<int>(min(static_cast<long long>(width), p.f - c0));
      fold_x<Acc, Fold, T, (VEC > 1)>(p, x + c0, cols, width, static_cast<Acc*>(p.out) + c0,
                                      smem);
    }
    return;
  }
  // split-major: the blocks that run together read whole rows of x
  const long long col_tiles = (p.f + width - 1) / width;
  const long long tile = blockIdx.x % col_tiles, s = blockIdx.x / col_tiles;
  const long long c = s / p.group, j = s % p.group;
  const long long cstart = c * p.cluster_rows;
  const long long r0 = cstart + j * p.seg_rows;
  const long long r1 = min(min(r0 + p.seg_rows, cstart + p.cluster_rows), p.n);
  Acc a[VEC];
  row_sums<T, Acc, VEC>(a, x, p.f, p.f, tile * width, p.tile_v, p.lanes, r0, r1);
  Acc* red = reinterpret_cast<Acc*>(smem);
  Acc* out = static_cast<Acc*>(p.out) + tile * width;
  const int cols = static_cast<int>(min(static_cast<long long>(width), p.f - tile * width));
  if (p.splits == 1) {
    join_lanes<Acc, VEC>(a, red, p.tile_v, p.lanes, [&](int e, Acc v) {
      if (e < cols) out[e] = v;
    });
    return;
  }
  Acc* ws = static_cast<Acc*>(p.ws) + tile * p.splits * p.wp;
  join_lanes<Acc, VEC>(a, red, p.tile_v, p.lanes, [&](int e, Acc v) { ws[s * p.wp + e] = v; });
  __syncthreads();
  unsigned* ticket = p.tickets + tile;
  if (threadIdx.x == 0) s_last = take_ticket(ticket) == static_cast<unsigned>(p.splits - 1);
  __syncthreads();
  if (!s_last) return;
  if (p.group == p.splits) {  // one cluster: no order to keep, all lanes sum the partials
    const int tv = max(1, width / 4), lanes = kThreads / tv;
    Acc b[4];
    row_sums<Acc, Acc, 4, true>(b, ws, p.wp, p.wp, 0, tv, lanes, 0, p.splits);
    join_lanes<Acc, 4>(b, red, tv, lanes, [&](int e, Acc v) {
      if (e < cols) out[e] = v;
    });
  } else {
    fold_partials<Acc, Fold>(p, ws, cols, out, red);
  }
  if (threadIdx.x == 0) *ticket = 0u;  // the next call on this stream starts from 0
}

template <typename Kernel>
cudaError_t run(Kernel kernel, const Launch& l, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(l.smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(l.blocks), kThreads, l.smem, stream>>>(l.p);
  return cudaGetLastError();
}

}  // namespace cluster
