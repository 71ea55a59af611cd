"""Wrapper of the hand-written ``dot_moa`` CUDA kernels (``csrc/dot_moa.cu``).

Replaces the TPU kernel ``src/repro/kernels/dot_moa.py:dot_moa_pallas``:
``(m, k) @ (k, n)`` with the K axis folded ``block_k`` operands at a time
into an f32 (floats) or int32 (ints) accumulator, by ``+`` or by the LOA
combine (``approx_bits > 0``). :func:`plan` picks the body and the split-K
grid from the shape alone; ``dot_moa_cuda.launches`` counts launches.

A 3-D call ``(E, m, k) @ (E, k, n) -> (E, m, n)`` is one launch over the E
members (the counterpart of the batch grid axis ``jax.vmap`` adds to
``dot_moa_pallas``, as the MoE's expert contractions do): each member runs
as the 2-D call runs under the same :class:`Plan`, which names the batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.device import as_dtype, is_integer
from repro_torch.kernels import _build

__all__ = ["Plan", "plan", "dot_moa_cuda"]

# (operand dtype, output dtype) pairs the kernels are instantiated for
_SUPPORTED = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.int8, torch.int32),
              (torch.int32, torch.int32)}

#: body codes of the C entry point (``enum Body`` in csrc/dot_moa.cu)
_BODY_CODES = {"stream": 0, "tc": 1, "simt": 2, "wgmma": 3}
#: streaming multiprocessors of the H100; a plan aims at as many blocks on
#: each as fit (2, or 1 for a ``simt`` tile that takes an SM's registers)
SMS = 132
MIN_BLOCKS = 2 * SMS
#: ``simt`` tiles of at most this many outputs run 2 blocks an SM where the
#: block's range is one slice (``__launch_bounds__`` in dot_moa_simt.cuh)
_SIMT_PAIR_TILE = 64 * 128
#: the split-mode workspace stays under max(5 % of the operand bytes, this)
WORKSPACE_FLOOR = 16 << 20
#: the largest grid.z (sub-ranges of a split) and grid.y (row tiles, and
#: the fold's members); grid.x (column tiles, or row tiles for ``wgmma``,
#: times the batch) may hold up to 2**31 - 1
_GRID_YZ = 65535
_GRID_X = 2 ** 31 - 1
#: accumulators a thread of the streaming (decode) body holds: it runs
#: where m rows of them fit one row group (m <= 16 f32 / int32, 4 int8);
#: more rows would read B once per group. bf16 never streams: every m runs
#: ``wgmma``, whose 64-row tile gives a row the same K split and in-slice
#: order at every m up to 64, so a decode row (m = n_slots) and a verify
#: row (m = n_slots * (k + 1)) round alike
STREAM_ACC = 64
#: stream body: shared-memory bytes for A's rows of one sub-range
_STREAM_A_BYTES = 32 * 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one ``dot_moa`` call runs: the body, its output tile, and the K
    split. ``splits == 0`` is direct mode (each block walks all of K, the
    slices folded in registers); else slice ``s`` is cut into sub-ranges
    ``[s*block_k + j*sub, ...)`` (``j < splits``, cut at the slice's end),
    each summed by its own blocks into the workspace. ``batch`` members
    each run these blocks on their own operands."""

    body: str                 # "stream" | "wgmma" | "tc" | "simt"
    tile_m: int
    tile_n: int
    k_step: int               # rows of K per pipeline stage
    vec: int                  # operands per 16-byte copy
    m: int
    n: int
    k: int
    block_k: int
    sub: int
    splits: int
    batch: int = 1

    @property
    def slices(self) -> int:
        return -(-self.k // self.block_k)

    @property
    def tiles(self) -> int:
        """Output tiles of one member."""
        return -(-self.m // self.tile_m) * -(-self.n // self.tile_n)

    @property
    def blocks(self) -> int:
        """Tiles times grid.z (the split's sub-ranges, 1 in direct mode)
        times the batch."""
        return self.tiles * (self.slices * self.splits if self.splits
                             else 1) * self.batch

    @property
    def workspace(self) -> int:
        """Accumulators of the split-mode workspace, every member's (0 in
        direct mode)."""
        return (self.batch * self.slices * self.splits * self.m * self.n
                if self.splits else 0)

    def ranges(self) -> List[Tuple[int, int]]:
        """The K range of each non-empty grid.z index, in z order (the
        kernels' ``split_range``); direct mode: the slices one block walks."""
        bk, k = self.block_k, self.k
        if not self.splits:
            return [(s, min(s + bk, k)) for s in range(0, k, bk)]
        out = []
        for z in range(self.slices * self.splits):
            s, j = divmod(z, self.splits)
            end = min((s + 1) * bk, k)
            k0 = min(s * bk + j * self.sub, end)
            if k0 < min(k0 + self.sub, end):
                out.append((k0, min(k0 + self.sub, end)))
        return out

    @property
    def one_slice(self) -> bool:
        """Every block's K range lies in one slice: no accumulator beside
        the slice's partial."""
        return bool(self.splits) or self.slices == 1


def _simt_width(m: int, n: int) -> int:
    """Output tile width of the 128-row ``simt`` tiles: the one that pads
    ``n`` least; of two that pad alike the wider where it still gives a
    tile to every SM, else the narrower (the more tiles)."""
    pad = {bn: -(-n // bn) * bn - n for bn in (96, 64)}
    least = [bn for bn in (96, 64) if pad[bn] == min(pad.values())]
    full = [bn for bn in least if -(-m // 128) * -(-n // bn) >= SMS]
    return full[0] if full else least[-1]


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, block_k: int, dtype: torch.dtype,
         batch: int = 1) -> Plan:
    """The body and grid of ``(m, k) @ (k, n)`` with ``block_k`` slices of
    ``dtype`` operands, for each of ``batch`` members (deterministic in its
    arguments; the thresholds and their reasons are in the note atop
    ``csrc/dot_moa.cu``). The body and tile depend on the member's shape
    alone; the split counts every member's blocks and workspace, so at
    ``batch`` 1 this is the unbatched plan.

    * bf16: ``wgmma`` (64 x 128 tiles) at every m.
    * else ``m * 16 / itemsize <= STREAM_ACC`` (m <= 16 f32 / int32, 4
      int8): ``stream`` (B read once, CUDA-core FMA), always split: a
      sub-range's A rows must fit 32 KB of shared memory, sized for the
      most rows the dtype streams.
    * else ``tc`` (int8: mma.sync, 64 x 128 tiles) or ``simt`` (f32,
      int32: 64 x 128 tiles at m <= 64, else 128 rows by
      :func:`_simt_width`).

    Row invariance: a row's K split and in-slice order depend on
    ``(n, k, block_k, dtype, batch)`` and the body, never on the other
    rows: the split counts row tiles (one for every m a tile holds) and
    sizes the workspace for whole tiles (the stream body: its largest),
    and no body's order for a row depends on its tile's other rows. So
    every m up to 16 (up to 64 in bf16) gives a row the same bits.

    Sub-ranges are added, smallest count first, until the grid has
    ``MIN_BLOCKS`` blocks (``wgmma``: ``SMS // 2``; ``simt``: ``SMS`` where
    its tile takes an SM alone), counting a ragged last slice's by their
    share of K (``stream``, bound by bytes: while the grid stays within one
    wave of ``MIN_BLOCKS``), while the workspace stays under
    ``max(5 % of the operand bytes, WORKSPACE_FLOOR)`` and a sub-range
    keeps at least 4 stages; the other bodies stay in direct mode where the
    tiles alone reach that count or no split fits. Raises where no body
    takes the shape."""
    if min(m, n, k, block_k, batch) < 1:
        raise ValueError(f"dot_moa: empty plan for {batch} x {m}x{k}x{n}, "
                         f"block_k={block_k}")
    block_k = min(block_k, k)
    item = dtype.itemsize
    vec = 16 // item
    if dtype == torch.bfloat16:
        body, tile_m, tile_n, k_step, submax = "wgmma", 64, 128, 64, None
    elif m * vec <= STREAM_ACC:
        body, k_step = "stream", 32
        tile_m = next(r for r in (4, 8, 16) if r >= m)
        tile_n = 32 * vec
        submax = _STREAM_A_BYTES // (4 * (STREAM_ACC // vec))
    elif dtype == torch.int8:
        body, tile_m, tile_n, k_step, submax = "tc", 64, 128, 64, None
    elif dtype in (torch.float32, torch.int32):
        body, k_step, submax = "simt", 32, None
        tile_m = 64 if m <= 64 else 128
        tile_n = 128 if tile_m == 64 else _simt_width(m, n)
    else:
        raise TypeError(f"dot_moa: no body for {dtype}")
    rows, cols = -(-m // tile_m), -(-n // tile_n)
    if body == "wgmma":   # row tiles on grid.x
        rows, cols = cols, rows
    if max(rows, batch) > _GRID_YZ or cols * batch > _GRID_X:
        raise ValueError(f"dot_moa: {batch} x {m}x{n} needs more than "
                         f"{_GRID_YZ} tiles or members on grid.y or "
                         f"{_GRID_X} on grid.x ({tile_m}x{tile_n} tiles)")
    base = dict(body=body, tile_m=tile_m, tile_n=tile_n, k_step=k_step,
                vec=vec, m=m, n=n, k=k, block_k=block_k, batch=batch)
    slices = -(-k // block_k)
    tiles = rows * cols * batch          # every member's
    target = MIN_BLOCKS
    if body == "wgmma":   # measured: the fewest sub-ranges that busy half
        target = SMS // 2  # the SMs; each more costs workspace and a tail
    if body == "simt":   # blocks an SM: 2 only for small one-slice tiles
        pair = tile_m * tile_n <= _SIMT_PAIR_TILE
        target = SMS * (2 if pair and slices == 1 else 1)
    # whole row tiles (the stream body: its largest), so that the split
    # is the same for every m a tile holds
    m_tiles = STREAM_ACC // vec if body == "stream" else \
        -(-m // tile_m) * tile_m
    cap = max(0.05 * batch * (m_tiles * k + k * n) * item, WORKSPACE_FLOOR)

    def fits(splits: int) -> bool:
        return (slices * splits <= _GRID_YZ
                and batch * slices * splits * m_tiles * n * 4 <= cap)

    lo = 1 if submax is None else -(-block_k // submax)
    hi = max(lo, -(-block_k // (4 * k_step)))
    if body != "stream" and (tiles >= target or slices * hi == 1
                             or not fits(1)):
        return Plan(sub=0, splits=0, **base)
    if body == "simt":   # split blocks hold one slice each
        target = SMS * (2 if pair else 1)
    def blocks(splits: int) -> float:
        """Blocks of full length: a ragged last slice's short sub-ranges
        count by their share of K."""
        return tiles * k / _sub(block_k, splits, k_step)

    def more(splits: int) -> bool:
        if body == "stream":   # bound by bytes: one wave, as much K a block
            return tiles * slices * (splits + 1) <= MIN_BLOCKS
        return blocks(splits) < target

    splits = lo
    while splits < hi and fits(splits + 1) and more(splits):
        splits += 1
    if body == "stream" and slices * splits > _GRID_YZ:
        raise ValueError(f"dot_moa: {slices} slices of block_k={block_k} "
                         f"need more than {_GRID_YZ} sub-ranges")
    sub = _sub(block_k, splits, k_step)
    return Plan(sub=sub, splits=-(-block_k // sub), **base)


def _sub(block_k: int, splits: int, k_step: int) -> int:
    """Sub-range length of ``splits`` per slice, in whole stages."""
    return -(-(-(-block_k // splits)) // k_step) * k_step


@functools.lru_cache(maxsize=None)
def _fn():
    p = ctypes.c_void_p
    return _build.load_function("dot_moa", "repro_dot_moa", [p] * 7)


@functools.lru_cache(maxsize=4096)
def _launch(m: int, n: int, k: int, block_k: int, approx_bits: int,
            dtype: torch.dtype, out_dtype: torch.dtype, a_rows16: bool,
            b_rows16: bool, batch: int, plan_batch: int):
    """The plan of a call, the C entry's 16 ints and its 3 member strides
    (built once per signature: the host path passes one pointer for
    each). ``a_rows16`` / ``b_rows16``: the operand's data pointer is
    16-byte aligned; members are contiguous, so each member's pointer is
    where its rows are (k and n multiples of the 16-byte vector). The
    split is planned for ``plan_batch`` members and launched for
    ``batch``."""
    p = dataclasses.replace(plan(m, n, k, block_k, dtype, plan_batch),
                            batch=batch)
    v = p.vec
    # 16-byte copies need aligned rows, and stages that start on 16 bytes
    a_aligned = a_rows16 and k % v == 0 and block_k % v == 0 \
        and p.sub % v == 0
    b_aligned = b_rows16 and n % v == 0
    ints = (m, n, k, block_k, approx_bits, _build.DTYPE_CODES[dtype],
            _build.DTYPE_CODES[out_dtype], _BODY_CODES[p.body], p.tile_m,
            p.tile_n, p.sub, p.splits, int(a_aligned), int(b_aligned),
            int(p.one_slice), batch)
    strides = (ctypes.c_longlong * 3)(m * k, k * n, m * n)
    return p, (ctypes.c_int * len(ints))(*ints), strides


def dot_moa_cuda(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
                 approx_bits: int = 0,
                 out_dtype: Optional[torch.dtype] = None,
                 plan_batch: Optional[int] = None) -> torch.Tensor:
    """Launch the kernels on ``torch.cuda.current_stream()``; same contract
    as :func:`repro_torch.kernels.ref.dot_moa_ref`, or, for 3-D operands
    ``(E, m, k) @ (E, k, n)``, as :func:`repro_torch.kernels.ref.
    dot_moa_batched_ref`: one launch for every member. ``plan_batch``
    (default: the call's own batch) plans the split as for that many
    members, so a 2-D call can run one member exactly as a batched call
    runs it (the member-by-member check)."""
    _build.check_device(a, "dot_moa")
    batched = a.dim() == 3
    if a.dim() not in (2, 3) or b.dim() != a.dim() \
            or a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"dot_moa: contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError("dot_moa: operands must share device and dtype, got "
                         f"{a.dtype}@{a.device} and {b.dtype}@{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("dot_moa: operands must be contiguous")
    (m, k), n = a.shape[-2:], b.shape[-1]
    batch = a.shape[0] if batched else 1
    is_int = is_integer(a.dtype)
    if approx_bits and not is_int:
        raise TypeError("LOA accumulation requires integer operands")
    block_k = min(int(block_k), k)
    if block_k < 1:
        raise ValueError("dot_moa: block_k must be >= 1")
    if approx_bits and k % block_k:
        raise ValueError(f"k={k} must be a multiple of block_k={block_k} "
                         "for LOA")
    out_dtype = as_dtype(out_dtype) if out_dtype is not None \
        else (torch.int32 if is_int else a.dtype)
    if (a.dtype, out_dtype) not in _SUPPORTED:
        raise TypeError(f"dot_moa: no kernel for {a.dtype} -> {out_dtype}")
    out = torch.empty(tuple(a.shape[:-1]) + (n,), dtype=out_dtype,
                      device=a.device)
    if m == 0 or n == 0 or batch == 0:
        return out
    a_ptr, b_ptr = a.data_ptr(), b.data_ptr()
    p, ints, strides = _launch(m, n, k, block_k, int(approx_bits), a.dtype,
                               out_dtype, a_ptr % 16 == 0, b_ptr % 16 == 0,
                               batch, plan_batch or batch)
    index = a.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    ws = _build.workspace(index, stream, 4 * p.workspace,
                          owner="dot_moa")[0].data_ptr() if p.splits else None
    if index == torch.cuda.current_device():
        rc = _fn()(a_ptr, b_ptr, out.data_ptr(), ws, ints, strides, stream)
    else:
        with torch.cuda.device(index):
            rc = _fn()(a_ptr, b_ptr, out.data_ptr(), ws, ints, strides,
                       stream)
    _build.raise_on_error(rc, "dot_moa")
    dot_moa_cuda.launches += 1
    return out


dot_moa_cuda.launches = 0
