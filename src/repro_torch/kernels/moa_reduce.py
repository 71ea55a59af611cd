"""Wrapper of the hand-written ``moa_reduce`` CUDA kernel
(``csrc/moa_reduce.cu``), and the plan it shares with ``loa_reduce``
(``csrc/cluster_reduce.cuh``).

Replaces the TPU kernel ``src/repro/kernels/moa_reduce.py:moa_reduce_pallas``:
``(n, f) → (f,)``, each ``block_n``-row cluster tree-summed and the cluster
sums folded in order into an f32 (float operands) or int32 (integer
operands, wrapping) accumulator. :func:`plan` picks the route, the column
tiles and the row splits from the shapes alone; a call is one launch, and
``moa_reduce_cuda.launches`` counts them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.device import is_integer
from repro_torch.kernels import _build

__all__ = ["Plan", "plan", "join_bytes", "moa_reduce_cuda", "run_reduce"]

#: streaming multiprocessors of the H100
SMS = 132
#: threads of a block (``kThreads`` in the source)
THREADS = 256
#: split blocks a call aims at, at most: four 256-thread blocks an SM
#: (measured on the H100: fewer blocks of more rows beat a full wave, since
#: each column tile's last block folds fewer partials)
TARGET_BLOCKS = SMS * 4
#: rows a thread sums at the least (one batch of loads in flight: eight,
#: four where a load unpacks into 16 int8 words)
ROWS_PER_THREAD = 8
#: 16-byte vectors (or words) of a column tile, at most, before the rows a
#: block sums are few
TILE_V_MAX = 32
#: ordered clusters of one row of at most this many bytes (four 4-byte
#: words, or one 16-byte vector) are folded straight from x by one block:
#: their partials would be a copy of x, one split block a row. Measured on
#: the H100 (chip_smoke.py's direct rows beside the partials route): 5.2x
#: faster at f32 (70000, 4, block_n 1); slower at every wider cluster tried
#: (240 bytes to 8 KB a cluster)
DIRECT_ROW_BYTES = 16
#: chunks of the ring through which one block folds x (``kStages`` in the
#: source), and the ring's bytes
STAGES = 4
RING_BYTES = 64 * 1024
#: cluster sums a pass of the partials' fold keeps in shared memory, bytes
SUMS_BYTES = 16 * 1024
#: most blocks of a 1-D grid, and shared memory one block may take
MAX_BLOCKS = 2 ** 31 - 1
MAX_SMEM = 227 * 1024

_SUPPORTED = (torch.float32, torch.bfloat16, torch.int8, torch.int32)


def _pow2_ceil(x: int) -> int:
    return 1 << (x - 1).bit_length()


def join_bytes(tile_v: int, vec: int) -> int:
    """Shared memory of ``join_lanes`` (``csrc/cluster_reduce.cuh``) over
    ``tile_v`` threads of ``vec`` accumulators a row lane: one row of the
    tile's columns for each warp (or, at 32 threads a row lane or more, for
    each row lane)."""
    groups = THREADS // 32 if tile_v < 32 else THREADS // tile_v
    return groups * tile_v * vec * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. The columns are cut into ``col_tiles`` tiles of
    ``tile_v`` vectors of ``vec`` words (16 bytes; one word off the 16-byte
    path); a block's ``THREADS`` threads are ``lanes`` row lanes of
    ``tile_v`` threads. Block ``s * col_tiles + tile`` of ``grid`` sums the
    rows :meth:`rows` gives for split ``s`` into one partial a column;
    ``s // spc`` is its cluster. The last block of a column tile folds the
    tile's ``splits`` partials: each cluster's ``spc`` partials summed in
    split order, the cluster sums folded in cluster order, ``chunk``
    clusters a pass (one cluster: all its lanes sum the partials).
    ``direct``: clusters of one row, no split blocks; block ``tile`` folds
    x's rows itself, in order, through a ring of ``STAGES`` chunks of
    ``chunk`` rows."""

    route: str           # "assoc" or "ordered"
    direct: bool
    n: int
    f: int
    vec: int
    tile_v: int
    lanes: int
    col_tiles: int
    cluster_rows: int    # rows of a cluster (n on the assoc route)
    n_clusters: int      # steps of the fold chain (1 on the assoc route)
    seg_rows: int        # rows of a split block (0 when direct)
    spc: int             # splits of a cluster (0 when direct)
    splits: int          # split blocks of a column tile (0 when direct)
    chunk: int           # rows a ring stage (direct) or clusters a pass
    wp: int              # row pitch of the partials, accumulator words
    smem: int            # dynamic shared memory of a block, bytes
    workspace: int       # partials, bytes (0 with one split or direct)
    tickets: int         # int32 tickets (0 with one split or direct)
    grid: Tuple[int]
    approx_bits: int

    @property
    def cols(self) -> int:
        """Columns of a tile."""
        return self.tile_v * self.vec

    @property
    def blocks(self) -> int:
        return self.grid[0]

    @property
    def group(self) -> int:
        """Rows of the fold's source a cluster: partials, or x's one row."""
        return 1 if self.direct else self.spc

    def rows(self, s: int) -> range:
        """The rows of x that split ``s`` sums (in every column tile)."""
        c, j = divmod(s, self.spc)
        start = c * self.cluster_rows
        r0 = start + j * self.seg_rows
        return range(r0, max(r0, min(r0 + self.seg_rows,
                                     start + self.cluster_rows, self.n)))

    def c_args(self) -> Tuple[int, ...]:
        """The C entry's plan array (``cluster::launch_of``)."""
        return (self.n, self.cluster_rows, self.seg_rows, self.splits,
                self.f, self.group, self.tile_v, self.lanes, self.wp,
                self.chunk, self.approx_bits, self.vec, self.blocks,
                self.smem)


@functools.lru_cache(maxsize=1024)
def plan(n: int, f: int, block_n: int, dtype: torch.dtype,
         approx_bits: int = 0, aligned: bool = True) -> Plan:
    """The schedule of a ``(n, f)`` reduction of ``dtype`` operands in
    ``block_n``-row clusters, folded by ``+`` or, with ``approx_bits > 0``,
    by the LOA combine (int32 only; ``n`` a multiple of ``block_n``).
    ``aligned``: the operand's base is 16 bytes aligned (else every load is
    one word). Reads no operand value.

    * route ``assoc`` for integer sums folded by ``+`` and for any sum of
      one cluster: rows split evenly into ``splits`` blocks a column tile,
      at least ``lanes * ROWS_PER_THREAD`` rows each, about
      ``TARGET_BLOCKS`` in all; ``ordered`` otherwise: each cluster cut
      into ``spc`` segments of the same size, or, at one row a cluster of
      at most ``DIRECT_ROW_BYTES``, folded from x (``direct``).
    * ``vec``: 16 bytes of words where ``f * itemsize`` is a multiple of 16
      and ``aligned``, else 1. ``tile_v``: up to ``TILE_V_MAX`` vectors,
      widened (with fewer lanes) where the rows a block sums are few.

    Raises ``TypeError``/``ValueError`` for what the kernel does not take."""
    if dtype not in _SUPPORTED:
        raise TypeError(f"cluster reduce: no kernel for {dtype}")
    if n < 1 or f < 1 or block_n < 1:
        raise ValueError(f"cluster reduce: no plan for n={n} f={f} "
                         f"block_n={block_n}")
    if not 0 <= approx_bits <= 31:
        raise ValueError(f"approx_bits={approx_bits} outside [0, 31]")
    if approx_bits and dtype != torch.int32:
        raise TypeError("LOA folds take int32 operands only")
    block_n = min(block_n, n)
    if approx_bits and n % block_n:
        raise ValueError(f"n={n} not a multiple of block_n={block_n}")
    item = dtype.itemsize
    n_clusters = -(-n // block_n)
    ordered = n_clusters > 1 and (approx_bits > 0 or not is_integer(dtype))
    vec = 16 // item if aligned and f * item % 16 == 0 else 1
    direct = (ordered and block_n == 1 and f * item <= DIRECT_ROW_BYTES
              and (vec > 1 or item == 4))
    vpr = -(-f // vec)
    tile_v = min(TILE_V_MAX, _pow2_ceil(vpr))
    span = block_n if ordered else n
    while (tile_v < min(THREADS, _pow2_ceil(vpr))
           and THREADS // tile_v * ROWS_PER_THREAD > span):
        tile_v *= 2
    while True:
        lanes = THREADS // tile_v
        cols = tile_v * vec
        col_tiles = -(-f // cols)
        wp = -(-cols // 4) * 4
        seg_rows = spc = splits = 0
        if not direct:
            want = max(lanes * ROWS_PER_THREAD,
                       -(-n * col_tiles // TARGET_BLOCKS))
            if ordered:
                spc = max(1, block_n // want)
                seg_rows = -(-block_n // spc)
                splits = n_clusters * spc
            else:
                block_n, n_clusters = n, 1
                splits = spc = max(1, n // want)
                seg_rows = -(-n // splits)
        # the fold of the partials gives each thread four columns
        if cols <= 4 * THREADS or splits <= 1:
            break
        tile_v = 4 * THREADS // vec
    blocks = col_tiles * max(splits, 1)
    red = 0 if direct else join_bytes(tile_v, vec)
    if splits > 1 and not ordered:  # the last block joins 4 columns a thread
        red = max(red, join_bytes(max(1, cols // 4), 4))
    fold, chunk = 0, 1
    if direct:                      # chunk: rows a stage of the ring
        chunk = RING_BYTES // STAGES // (cols * item)
        fold = STAGES * chunk * cols * item
    elif ordered:                   # chunk: clusters a pass
        chunk = max(1, min(n_clusters, SUMS_BYTES // (wp * 4)))
        fold = chunk * wp * 4
    smem = max(red, fold)
    if blocks > MAX_BLOCKS or smem > MAX_SMEM:
        raise ValueError(f"cluster reduce: n={n} f={f} block_n={block_n} "
                         f"needs {blocks} blocks of {smem} B")
    multi = splits > 1
    return Plan(route="ordered" if ordered else "assoc", direct=direct, n=n,
                f=f, vec=vec, tile_v=tile_v, lanes=lanes, col_tiles=col_tiles,
                cluster_rows=block_n, n_clusters=n_clusters,
                seg_rows=seg_rows, spc=spc, splits=splits, chunk=chunk,
                wp=wp, smem=smem,
                workspace=col_tiles * splits * wp * 4 if multi else 0,
                tickets=col_tiles if multi else 0, grid=(blocks,),
                approx_bits=approx_bits)


def check_reduce_operand(x: torch.Tensor, what: str) -> None:
    _build.check_device(x, what)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (n, f), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the operand must be contiguous")


@functools.lru_cache(maxsize=None)
def _fn(symbol: str):
    p = ctypes.c_void_p
    library, argtypes = {
        "repro_moa_reduce": ("moa_reduce", [p, p, p, p, p, ctypes.c_int, p]),
        "repro_loa_reduce": ("loa_add", [p, p, p, p, p, p])}[symbol]
    return _build.load_function(library, symbol, argtypes)


@functools.lru_cache(maxsize=1024)
def _launch(n, f, block_n, dtype, approx_bits, aligned):
    """The plan of a call and its C plan array (built once per signature)."""
    p = plan(n, f, block_n, dtype, approx_bits, aligned)
    args = p.c_args()
    return p, (ctypes.c_longlong * len(args))(*args)


def run_reduce(symbol: str, x: torch.Tensor, out: torch.Tensor, block_n: int,
               approx_bits: int, *extra) -> Plan:
    """Launch ``symbol`` (``repro_moa_reduce`` or ``repro_loa_reduce``) on
    the current stream: ``x (n, f)`` into ``out (f,)``, with ``extra`` C
    arguments before the stream. Returns the plan."""
    n, f = x.shape
    ptr = x.data_ptr()
    p, args = _launch(n, f, block_n, x.dtype, approx_bits, ptr % 16 == 0)
    index = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    ws = tickets = None
    if p.tickets:
        w, t = _build.workspace(index, stream, p.workspace, p.tickets)
        ws, tickets = w.data_ptr(), t.data_ptr()
    call = (ptr, ws, tickets, out.data_ptr(), args, *extra, stream)
    if index == torch.cuda.current_device():
        rc = _fn(symbol)(*call)
    else:
        with torch.cuda.device(index):
            rc = _fn(symbol)(*call)
    _build.raise_on_error(rc, symbol[len("repro_"):])
    return p


def moa_reduce_cuda(x: torch.Tensor, *, block_n: int = 512) -> torch.Tensor:
    """Launch the kernel on ``torch.cuda.current_stream()``; same contract
    as :func:`repro_torch.kernels.ref.moa_reduce_ref`."""
    check_reduce_operand(x, "moa_reduce")
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"moa_reduce: no kernel for {x.dtype}")
    n, f = x.shape
    accum = torch.int32 if is_integer(x.dtype) else torch.float32
    if n == 0 or f == 0:
        return torch.zeros((f,), dtype=accum, device=x.device)
    block_n = min(int(block_n), n)
    if block_n < 1:
        raise ValueError("moa_reduce: block_n must be >= 1")
    out = torch.empty((f,), dtype=accum, device=x.device)
    run_reduce("repro_moa_reduce", x, out, block_n, 0,
               _build.DTYPE_CODES[x.dtype])
    moa_reduce_cuda.launches += 1
    return out


moa_reduce_cuda.launches = 0
