"""Wrapper of the hand-written paged-attention CUDA kernel
(``csrc/paged_attention.cu``).

Replaces the TPU kernel
``src/repro/kernels/paged_attention.py:paged_attention_pallas`` (and its
``paged_flash_decode`` / ``paged_flash_prefill`` instances): for each slot,
``T`` queries at ``start[b] .. start[b]+T-1`` attend causally over the pages
named by ``block_tables[b]``, with int8 pools dequantized in registers
through ``dequant_dtype``. :func:`plan` splits each slot's page walk over
several blocks from the shapes alone; the blocks' partials are folded in
split order inside the launch. ``paged_attention_cuda.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["Plan", "plan", "live_pages", "paged_attention_cuda"]

#: streaming multiprocessors of the H100
SMS = 132
#: shared memory of one SM, and the most one block may take (sm_90)
SMEM_SM = 228 * 1024
MAX_SMEM = 227 * 1024
#: the warps' page rings of a block stay under this, so that three blocks
#: share an SM where pages are small (measured on the H100: more resident
#: warps beat deeper rings)
RING_BUDGET = 64 * 1024
#: query rows of a block (``RT`` in the source): always 4, so that a
#: query row's lane layout and online-update width are the same whatever
#: T and the GQA group G (a T = k + 1 verify row rounds as its T = 1
#: decode row); R = T * G rows take ``ceil(R / 4)`` row tiles
ROWS = 4
#: resident blocks an SM holds by registers (``__launch_bounds__``)
REG_BLOCKS = 3
#: most splits of one slot (the combine's statistics live in shared
#: memory; ``MAX_SPLITS`` in the source)
S_MAX = 64
#: head dims a warp row group covers (``D_MAX``), and a row group's p
#: buffer (``PBUF``)
_D_MAX = 128
_PBUF = 64 + 16


#: page positions of one online update: 64 scores a lane over the 4 rows
COLS = 64 // ROWS


def _align16(x: int) -> int:
    return (x + 15) & ~15


def live_pages(start: int, T: int, bs: int, n_blocks: int) -> int:
    """Pages a slot's walk reads: those up to its deepest query
    ``start + T - 1``, within the table's ``n_blocks``."""
    deepest = start + T - 1
    return 0 if deepest < 0 else min(n_blocks, deepest // bs + 1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. Block ``(s, h * row_tiles + rt, b)`` of ``grid``
    walks pages ``[s * pages, (s + 1) * pages)`` of slot ``b``, KV head
    ``h``, for query rows ``rt * rows ..`` (rows ordered ``(t, g)``); its
    ``warps`` warps take the pages in turn, each through a ring of
    ``stages`` page slots, and the online update runs every ``cols`` page
    positions. A split past a slot's live pages returns at once."""

    splits: int
    pages: int
    warps: int
    stages: int
    rows: int
    row_tiles: int
    cols: int
    smem: int            # dynamic shared memory of a block, bytes
    workspace: int       # f32 partials, bytes (0 with one split)
    tickets: int         # int32 tickets (0 with one split)
    grid: Tuple[int, int, int]
    blocks_per_sm: int   # resident blocks an SM (shared memory, registers)

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def wave(self) -> int:
        """Blocks the card holds at once."""
        return SMS * self.blocks_per_sm

    def live_splits(self, n_live: int) -> int:
        """Splits that walk a page of a slot with ``n_live`` live pages (at
        least one: a slot with none writes zeros)."""
        return max(1, -(-n_live // self.pages))

    def split_pages(self, s: int, n_live: int) -> range:
        return range(s * self.pages, min((s + 1) * self.pages, n_live))

    def warp_pages(self, s: int, w: int, n_live: int) -> range:
        r = self.split_pages(s, n_live)
        return range(r.start + w, r.stop, self.warps)


def _layout(item: int, quant: bool, bs: int, D: int, rows: int, warps: int,
            stages: int) -> int:
    """Shared memory of a block (``layout`` in the source)."""
    slot = _align16(2 * bs * D * item + (8 * bs if quant else 0))
    ring = warps * stages * slot
    comb = warps * (rows * D + 2 * rows) * 4
    off_p = _align16(max(ring, comb)) + rows * D * 4
    off_w = off_p + warps * 2 * _PBUF * 4
    return off_w + (2 * S_MAX * rows + 2 * rows) * 4


@functools.lru_cache(maxsize=1024)
def plan(B: int, T: int, H: int, Hk: int, D: int, bs: int, n_blocks: int,
         pool_dtype: torch.dtype) -> Plan:
    """The split walk of ``q (B, T, H, D)`` over pools ``(n_phys, bs, Hk,
    D)`` of ``pool_dtype`` and a table ``n_blocks`` wide. It reads no
    ``start`` and no table (nothing is synchronised): the live pages are
    found on the device.

    * ``rows``: the query rows of a block, always ``ROWS`` (4); ``R = T
      * H / Hk`` rows take ``ceil(R / 4)`` row tiles; ``cols``: page
      positions per online update, 16.
    * ``warps`` 4 (2 or 1 where two page slots a warp do not fit), and the
      ring depth ``stages``: the most of 4, 3 whose rings stay within
      ``RING_BUDGET``, else 2.
    * ``pages``: the least power of two from one page a warp whose grid
      stays within two resident waves (``2 * SMS * blocks_per_sm``
      blocks, counting every split of a full-depth table, one row tile a
      KV head), raised where ``n_blocks`` would need more than ``S_MAX``
      splits.

    Row invariance: a query row's lane layout, update width, warps and
    split (``rows``, ``cols``, ``warps``, ``pages``) depend on ``(B, H,
    Hk, D, bs, n_blocks, pool_dtype)``, never on T; and the kernel's
    arithmetic for a row does not depend on its place in the tile. So row
    ``t`` of a T-query call gives the bits of a one-query call at
    ``start + t`` over the same table.

    Raises ``ValueError`` for a shape the kernel does not take: ``D`` a
    multiple of 4 up to 128, or a block over 227 KB of shared memory."""
    if min(B, T, H, Hk, D, bs, n_blocks) < 1 or H % Hk:
        raise ValueError(f"paged_attention: no plan for B={B} T={T} H={H} "
                         f"Hk={Hk} D={D} bs={bs} n_blocks={n_blocks}")
    if D % 4 or D > _D_MAX:
        raise ValueError(f"paged_attention: head_dim {D} must be a multiple "
                         f"of 4 and at most {_D_MAX}")
    if pool_dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"paged_attention: no kernel for pool {pool_dtype}")
    R = T * (H // Hk)
    rows = ROWS
    row_tiles = -(-R // rows)
    item = pool_dtype.itemsize
    quant = pool_dtype == torch.int8
    slot = _align16(2 * bs * D * item + (8 * bs if quant else 0))
    for warps in (4, 2, 1):
        stages = next((n for n in (4, 3) if warps * n * slot <= RING_BUDGET),
                      2)
        smem = _layout(item, quant, bs, D, rows, warps, stages)
        if smem <= MAX_SMEM:
            break
    else:
        raise ValueError(f"paged_attention: T={T}, G={H // Hk}, D={D}, "
                         f"bs={bs} needs {smem} B of shared memory per block "
                         f"(at most {MAX_SMEM})")
    per_sm = min(SMEM_SM // (smem + 1024), 2048 // (32 * warps),
                 REG_BLOCKS)
    heads = B * Hk * row_tiles
    pages = warps
    while B * Hk * -(-n_blocks // pages) > 2 * SMS * per_sm:
        pages *= 2
    pages = max(pages, -(-n_blocks // S_MAX))
    splits = -(-n_blocks // pages)
    grid = (splits, Hk * row_tiles, B)
    ws = heads * splits * (rows * D + 2 * rows) * 4 if splits > 1 else 0
    return Plan(splits=splits, pages=pages, warps=warps, stages=stages,
                rows=rows, row_tiles=row_tiles, cols=COLS,
                smem=smem, workspace=ws,
                tickets=heads if splits > 1 else 0, grid=grid,
                blocks_per_sm=per_sm)


@functools.lru_cache(maxsize=None)
def _fn():
    p = ctypes.c_void_p
    return _build.load_function(
        "paged_attention", "repro_paged_attention",
        [p] * 11 + [ctypes.c_float, p])


@functools.lru_cache(maxsize=1024)
def _launch(B, T, H, Hk, D, bs, n_blocks, q_dtype, pool_dtype, dequant_dtype,
            aligned16, hk_pool, kv_start):
    """The plan of a call and the C entry's ints for it (built once per
    signature). ``aligned16``: both pools' data pointers are 16-byte
    aligned, so rows of a multiple of 16 bytes are copied 16 bytes at a
    time (else 4). ``Hk`` KV heads are read from ``kv_start`` on, of the
    pool's ``hk_pool`` (its head stride)."""
    p = plan(B, T, H, Hk, D, bs, n_blocks, pool_dtype)
    cp = 16 if aligned16 and D * pool_dtype.itemsize % 16 == 0 else 4
    codes = _build.DTYPE_CODES
    ints = (B, T, H, Hk, D, bs, n_blocks, codes[q_dtype], codes[pool_dtype],
            codes[dequant_dtype], p.splits, p.pages, p.warps, p.stages,
            p.rows, cp, p.smem, hk_pool, kv_start)
    return p, (ctypes.c_int * len(ints))(*ints)


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         start: torch.Tensor, *,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         dequant_dtype: torch.dtype = torch.bfloat16,
                         kv_start: int = 0, kv_count: Optional[int] = None
                         ) -> torch.Tensor:
    """``q (B, T, H, D)``; pools ``(n_phys, bs, Hk_pool, D)``
    (f32/bf16/int8); scales ``(n_phys, bs, Hk_pool)`` f32 for an int8
    pool; tables ``(B, n_blocks)`` int32; ``start (B,)`` int32 → ``(B, T,
    H, D)``. The kernel reads KV heads ``kv_start .. kv_start + Hk - 1``
    of the pools in place (``Hk = kv_count``, default every head from
    ``kv_start`` on; ``H`` a multiple of it): a rank whose q heads attend
    a few of a replicated pool's heads reads those alone, without a
    copy."""
    _build.check_device(q, "paged_attention")
    B, T, H, D = q.shape
    n_phys, bs, hk_pool, Dp = k_pool.shape
    Hk = hk_pool - kv_start if kv_count is None else kv_count
    if v_pool.shape != k_pool.shape or Dp != D or Hk < 1 or kv_start < 0 \
            or kv_start + Hk > hk_pool or H % Hk:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not match "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"read at KV heads [{kv_start}, {kv_start + Hk})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(start.shape) != (B,):
        raise ValueError("paged_attention: tables must be (B, n_blocks) and "
                         f"start (B,), got {tuple(block_tables.shape)} and "
                         f"{tuple(start.shape)}")
    if block_tables.dtype != torch.int32 or start.dtype != torch.int32:
        raise TypeError("paged_attention: tables and start must be int32")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_pool.dtype not in (
            torch.float32, torch.bfloat16, torch.int8) \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: no kernel for q {q.dtype}, pools "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("paged_attention: an int8 pool needs k_scale and "
                         "v_scale, and only an int8 pool takes them")
    if quantized and (k_scale.shape != k_pool.shape[:3]
                      or v_scale.shape != k_pool.shape[:3]
                      or k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError("paged_attention: scales must be f32 "
                         f"{tuple(k_pool.shape[:3])}")
    if dequant_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention: dequant_dtype {dequant_dtype} "
                        "must be float32 or bfloat16")
    tensors = [q, k_pool, v_pool, block_tables, start] + (
        [k_scale, v_scale] if quantized else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    n_blocks = block_tables.shape[1]
    if B == 0 or T == 0 or n_blocks == 0:
        return out
    k_ptr, v_ptr = k_pool.data_ptr(), v_pool.data_ptr()
    p, ints = _launch(B, T, H, Hk, D, bs, n_blocks, q.dtype, k_pool.dtype,
                      dequant_dtype, k_ptr % 16 == 0 and v_ptr % 16 == 0,
                      hk_pool, kv_start)
    index = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    ws = tickets = None
    if p.splits > 1:
        w, t = _build.workspace(index, stream, p.workspace, p.tickets)
        ws, tickets = w.data_ptr(), t.data_ptr()
    args = (q.data_ptr(), k_ptr, v_ptr,
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), start.data_ptr(), out.data_ptr(), ws,
            tickets, ints, float(D ** -0.5), stream)
    if index == torch.cuda.current_device():
        rc = _fn()(*args)
    else:
        with torch.cuda.device(index):
            rc = _fn()(*args)
    _build.raise_on_error(rc, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
