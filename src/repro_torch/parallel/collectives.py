"""The collectives of a model that runs on one rank's shards.

The reference pins layouts inside the model with ``constrain`` and lets
GSPMD insert the communication. The port runs each rank's local shards and
communicates where a split contraction needs it, Megatron-style, in
conjugate pairs that autograd sees (so a train step's backward makes the
transposed collective of each forward one):

* **column-parallel** projections (``wq``/``wk``/``wv``, ``w_gate``/
  ``w_up``, the unembedding) take a replicated input through
  :func:`column_input`: the identity forward, and in the backward the sum
  over ``model`` of the ranks' partial input gradients;
* **row-parallel** projections (``wo``, ``w_down``) produce f32 partial
  products that :func:`reduce_partial` sums over ``model`` before the one
  cast to the compute type (:func:`repro_torch.layers.linear.
  project_rows`); its backward is the identity;
* the **vocab-parallel** embedding looks up its own rows and sums them
  (:func:`repro_torch.layers.embedding.embed`); the unembedding's logits
  stay local: :func:`vocab_argmax` picks the global argmax with the
  single-device tie break (the lowest index), :func:`vocab_gather`
  assembles whole rows, and the loss reduces them where they lie
  (:mod:`repro_torch.models.losses`);
* **expert parallelism** runs each rank's ``E / M`` experts and sums the
  partial top-k combine (:mod:`repro_torch.layers.moe`);
* **FSDP** (ZeRO-3) keeps a parameter split over ``data`` and gathers it
  where it is used (:func:`fsdp_params`, :func:`fsdp_layer`): the gather
  forward, and in the backward the sum over ``data`` of the ranks'
  gradients, of which each keeps its own slice (:func:`reduce_scatter`);
* the **data-parallel** gradient sum (:func:`grad_sum`) for the leaves
  that ``data`` does not split.

Every device collective is a sum all-reduce, a broadcast or an
all-to-all (:func:`all_gather` broadcasts each rank's piece from it, a
maximum is taken locally over gathered values): the collectives a gloo
group carries for CUDA tensors, so two ranks can share one card, where
NCCL refuses. A broadcast and an all-to-all copy bits, so the composed
gather and :func:`grad_sum`'s ordered sum are exact. Outside an active
context (:func:`repro_torch.parallel.sharding.activate`) every function
here is the identity or the plain single-device operation.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Mapping, Optional, Tuple

import torch

from repro_torch.interop import tree_map_with_keys
from repro_torch.parallel.sharding import active_shard, mesh_axis_sizes

__all__ = ["DataShard", "RankShard", "split", "reduce_partial", "column_input",
           "all_gather", "all_reduce", "broadcast", "axis_max",
           "fsdp_gather", "fsdp_params", "fsdp_layer", "gather_model",
           "gather_whole", "grad_sum", "reduce_scatter", "vocab_argmax",
           "vocab_gather",
           "counts", "reset_counts", "observing", "CENSUS_KIND"]


@dataclasses.dataclass(frozen=True)
class DataShard:
    """A training rank's place on the ``data`` axis: the group its batch
    statistics and gradients sum over, its size and this rank's index (its
    rows of the batch), and ``fsdp``: ``{parameter path: dim}`` of the
    leaves split over ``data``."""

    group: object = None
    size: int = 1
    rank: int = 0
    fsdp: Optional[Mapping[str, int]] = None


@dataclasses.dataclass(frozen=True)
class RankShard:
    """One rank's piece of a model on a mesh: which contractions are split
    over the ``model`` axis and the process group they reduce over.

    ``heads``: the attention's q heads are this rank's; ``kv_heads``: so
    are its K/V heads (else they replicate beside split q heads, and
    ``kv_slice`` is the ``[lo, hi)`` of them that this rank's q heads
    attend); ``ff``:
    the MLP's ``ff`` columns are; ``experts`` / ``vocab``: this rank's
    ``[lo, hi)`` of the experts and of the vocabulary (``None``: all of
    them); ``data``: a training rank's :class:`DataShard` (``None``
    serving, where each rank's slots are its own)."""

    group: object = None
    size: int = 1
    rank: int = 0
    heads: bool = False
    kv_heads: bool = False
    kv_slice: Optional[Tuple[int, int]] = None
    ff: bool = False
    experts: Optional[Tuple[int, int]] = None
    vocab: Optional[Tuple[int, int]] = None
    data: Optional[DataShard] = None


#: calls since :func:`reset_counts`: ``all_reduce``, ``broadcast`` and
#: ``all_to_all`` are the device collectives; the others count the operations built on them,
#: by kind (``row_sum``: the forward sums of :func:`reduce_partial`;
#: ``column_grad``: the backward sums of :func:`column_input`;
#: ``fsdp_gather`` / ``fsdp_scatter``: FSDP's gathers and the reduce-
#: scatters of their backward; ``grad_sum``: data-parallel gradient sums;
#: ``gather``: whole-row gathers; ``max``: maxima over ranks)
_COUNTS = {"all_reduce": 0, "broadcast": 0, "all_to_all": 0, "row_sum": 0,
           "column_grad": 0, "fsdp_gather": 0, "fsdp_scatter": 0,
           "grad_sum": 0, "gather": 0, "max": 0}


#: the collective each observed kind is, by the reference's census names
#: (``repro/launch/dryrun.py``'s ``collective_census``)
CENSUS_KIND = {"row_sum": "all-reduce", "column_grad": "all-reduce",
               "grad_sum": "all-reduce", "fsdp_gather": "all-gather",
               "gather": "all-gather", "max": "all-gather",
               "argmax": "all-gather",
               "fsdp_scatter": "reduce-scatter"}

#: called ``(kind, axis, nbytes)`` at each collective the model runs,
#: while one observes (:func:`observing`); ``None`` off
_OBSERVER: Optional[Callable[[str, str, float], None]] = None


def _count(kind: str, axis: str, nbytes: float) -> None:
    _COUNTS[kind] += 1
    _observe(kind, axis, nbytes)


def _observe(kind: str, axis: str, nbytes: float) -> None:
    if _OBSERVER is not None:
        _OBSERVER(kind, axis, float(nbytes))


def _bytes(x: torch.Tensor, itemsize: Optional[int] = None) -> float:
    return float(x.numel() * (itemsize or x.element_size()))


@contextlib.contextmanager
def observing(observer: Callable[[str, str, float], None]):
    """Call ``observer(kind, axis, nbytes)`` at each collective run while
    the block runs (``kind`` a :func:`counts` key or ``"argmax"``, its
    collective :data:`CENSUS_KIND`; ``axis`` the mesh axis it reduces or
    gathers over; ``nbytes`` its buffer: the summed tensor of a sum, the
    gathered whole of a gather, the operand of a reduce-scatter)."""
    global _OBSERVER
    saved, _OBSERVER = _OBSERVER, observer
    try:
        yield
    finally:
        _OBSERVER = saved


def counts() -> dict:
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def split(site: str):
    """The active shard's split of ``site`` (``"heads"``, ``"kv_heads"``,
    ``"ff"``: bool; ``"experts"``, ``"vocab"``, ``"kv_slice"``: ``(lo,
    hi)`` or ``None``),
    or a falsy value outside a context or on a one-rank model axis."""
    shard = active_shard()
    if shard is None or shard.size == 1:
        return None
    return getattr(shard, site)


def _axis(axis: str):
    """``(group, size, rank)`` of the active shard's ``"model"`` or
    ``"data"`` axis; ``(None, 1, 0)`` outside a context."""
    shard = active_shard()
    if shard is None:
        return None, 1, 0
    if axis == "model":
        return shard.group, shard.size, shard.rank
    if axis == "data":
        d = shard.data
        return (None, 1, 0) if d is None else (d.group, d.size, d.rank)
    raise ValueError(f"unknown axis {axis!r}")


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` (default: every rank) in place, counted."""
    import torch.distributed as dist

    _COUNTS["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Row ``r`` of ``x`` (one row a rank of ``group``) sent to rank
    ``r``: row ``r`` of the result is what rank ``r`` sent this rank,
    counted."""
    import torch.distributed as dist

    _COUNTS["all_to_all"] += 1
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``x`` into every rank's ``x`` in place, counted."""
    import torch.distributed as dist

    _COUNTS["broadcast"] += 1
    dist.broadcast(x, src=src, group=group)
    return x


def _f32_sum(g: torch.Tensor, group) -> torch.Tensor:
    """The f32 sum of ``g`` over ``group``, on a new tensor."""
    g32 = g.float()
    g32 = g32.clone() if g32 is g else g32.contiguous()
    return all_reduce(g32, group)


class _RowSum(torch.autograd.Function):
    """Forward: the sum over the group's ranks. Backward: the identity
    (every rank's cotangent is already the whole sum's)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ColumnInput(torch.autograd.Function):
    """Forward: the identity. Backward: the f32 sum over the group of the
    ranks' partial cotangents, cast back once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count("column_grad", "model", _bytes(g, 4))
        return _f32_sum(g, ctx.group).to(g.dtype), None


def reduce_partial(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Sum the ranks' partial results ``x`` over ``axis`` (``"model"``:
    the row-parallel sum; ``"data"``: a batch statistic's). Under autograd
    its backward is the identity; otherwise the sum is taken in place."""
    group, size, _ = _axis(axis)
    if size == 1:
        return x
    _count("row_sum", axis, _bytes(x))
    if torch.is_grad_enabled() and x.requires_grad:
        return _RowSum.apply(x, group)
    return all_reduce(x, group)


def column_input(x: torch.Tensor, site: str) -> torch.Tensor:
    """A replicated ``x`` entering computation split over ``model`` at
    ``site`` (:func:`split`): the identity forward, and a backward that
    sums the ranks' partial cotangents. ``x`` itself elsewhere."""
    if not split(site) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ColumnInput.apply(x, active_shard().group)


def all_gather(x: torch.Tensor, dim: int, group, size: int,
               rank: int) -> torch.Tensor:
    """``size`` ranks' ``x`` (equal shapes) concatenated along ``dim`` in
    rank order: each rank's piece broadcast from it into its row of one
    buffer (a copy of its bits; each rank sends only its own piece, half
    the bytes a sum all-reduce of the zero-padded buffer moves at two
    ranks)."""
    import torch.distributed as dist

    buf = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[rank] = x
    for r in range(size):
        src = r if group is None else dist.get_global_rank(group, r)
        broadcast(buf[r], src=src, group=group)
    return torch.cat(buf.unbind(0), dim=dim)


def reduce_scatter(g: torch.Tensor, dim: int, group, size: int,
                   rank: int) -> torch.Tensor:
    """This rank's piece (along ``dim``, ``size`` equal pieces in rank
    order) of the f32 sum of ``g`` over the group, cast back to ``g``'s
    dtype. At two ranks each sends the other the other's piece (half the
    bytes of a sum all-reduce; a sum of two is the same in either order);
    else the sum all-reduce, then the slice."""
    import torch.distributed as dist

    n = g.shape[dim] // size
    if size != 2:
        return _f32_sum(g, group).to(g.dtype).narrow(
            dim, rank * n, n).contiguous()
    g32 = g.float()
    mine = g32.narrow(dim, rank * n, n).contiguous()
    theirs = g32.narrow(dim, (1 - rank) * n, n).contiguous()
    got = torch.empty_like(mine)
    for r in range(2):
        src = r if group is None else dist.get_global_rank(group, r)
        broadcast(theirs if r == rank else got, src=src, group=group)
    return (mine + got).to(g.dtype)


def axis_max(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axis``'s ranks (no
    gradient): the ranks' values gathered, the maximum taken locally."""
    group, size, rank = _axis(axis)
    x = x.detach()
    if size == 1:
        return x
    _count("max", axis, _bytes(x) * size)
    return all_gather(x[None], 0, group, size, rank).amax(dim=0)


class _Gather(torch.autograd.Function):
    """Forward: :func:`all_gather` along ``dim``. Backward: this rank's
    slice of the cotangent, summed over the group first where the
    consumers of the whole tensor are split among the ranks (FSDP: each
    data rank's gradient covers its own rows of the batch)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank, summed):
        ctx.dim, ctx.group, ctx.size, ctx.rank = dim, group, size, rank
        ctx.axis = "data" if summed else "model"
        ctx.summed, ctx.n = summed, x.shape[dim]
        return all_gather(x, dim, group, size, rank)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            _count("fsdp_scatter", ctx.axis, _bytes(g, 4))
            return (reduce_scatter(g, ctx.dim, ctx.group, ctx.size,
                                   ctx.rank), None, None, None, None, None)
        piece = g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous()
        return piece, None, None, None, None, None


def gather_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` split over ``model`` along ``dim``, whole on every rank; the
    backward keeps this rank's slice (what follows the gather runs
    replicated, so its cotangent is already whole)."""
    group, size, rank = _axis("model")
    if size == 1:
        return x
    _count("gather", "model", _bytes(x) * size)
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, dim, group, size, rank, False)
    return all_gather(x, dim, group, size, rank)


def fsdp_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A parameter split over ``data`` along ``dim``, whole over ``data``:
    FSDP's gather, whose backward sums the data ranks' gradients and keeps
    this rank's slice (a reduce-scatter)."""
    group, size, rank = _axis("data")
    if size == 1:
        return t
    _count("fsdp_gather", "data", _bytes(t) * size)
    if torch.is_grad_enabled() and t.requires_grad:
        return _Gather.apply(t, dim, group, size, rank, True)
    return all_gather(t, dim, group, size, rank)


def _fsdp_dims():
    shard = active_shard()
    if shard is None or shard.data is None or shard.data.size == 1:
        return None
    return shard.data.fsdp or None


def fsdp_params(params):
    """The parameter tree a model's forward reads under FSDP: every leaf
    split over ``data`` gathered whole, but the stacked layers' (under
    ``"layers"``) split along a dim other than the layer axis, which each
    layer gathers as it runs (:func:`fsdp_layer`), so only one layer's
    weights are whole at a time. ``params`` itself off a data axis."""
    dims = _fsdp_dims()
    if dims is None:
        return params

    def one(path, t):
        dim = dims.get(path)
        if dim is None or (path.startswith("layers.") and dim > 0):
            return t
        return fsdp_gather(t, dim)

    return tree_map_with_keys(lambda keys, t: one(".".join(keys), t), params)


def fsdp_layer(lyr, prefix: str = "layers"):
    """One layer's views of the stacked ``prefix`` leaves (a tree of
    :func:`repro_torch.models.transformer.layers`), whole: each leaf that
    FSDP splits along a dim other than the layer axis gathered."""
    dims = _fsdp_dims()
    if dims is None:
        return lyr

    def one(path, t):
        dim = dims.get(path)
        return t if dim is None or dim == 0 else fsdp_gather(t, dim - 1)

    return tree_map_with_keys(
        lambda keys, t: one(".".join((prefix,) + keys), t), lyr)


def grad_sum(grads: list) -> list:
    """The data-parallel gradient sum: each of ``grads`` summed over the
    ``data`` ranks in f32, as one buffer of their concatenation; the sums
    are f32. ``grads`` itself off a data axis. An ordered reduce-scatter
    then a gather: the buffer in ``size`` chunks, chunk ``r`` of every
    rank sent to rank ``r`` (:func:`all_to_all`), which adds them in rank
    order, the order in which one device accumulates the same rows as
    microbatches, so that plain data parallelism over any number of ranks
    is that step bit for bit (a ring's sum would associate the terms
    otherwise); then every rank's summed chunk gathered. It moves and
    holds what a sum all-reduce does."""
    group, size, rank = _axis("data")
    if size == 1 or not grads:
        return grads
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    _COUNTS["grad_sum"] += 1
    _observe("grad_sum", "data", _bytes(flat))
    n = flat.numel()
    chunk = -(-n // size)
    chunks = torch.nn.functional.pad(flat, (0, chunk * size - n))
    got = all_to_all(chunks.view(size, chunk), group)
    mine = got[0].clone()
    for r in range(1, size):
        mine += got[r]
    flat = all_gather(mine, 0, group, size, rank)[:n]
    return [piece.view(g.shape) for piece, g in zip(
        flat.split([g.numel() for g in grads]), grads)]


def gather_whole(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole of a leaf of which ``t`` is this rank's piece under
    ``spec`` on ``mesh`` (a ``DeviceMesh``), on every rank of the mesh:
    gathered along each split dim over its axis's group (a dim split over
    several axes, the first major, over their flattened group)."""
    sizes = mesh_axis_sizes(mesh)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        size, idx = 1, 0
        for a in axes if entry is not None else ():
            size, idx = size * sizes[a], idx * sizes[a] + coords[a]
        if size == 1:
            continue
        group = mesh.get_group(axes[0]) if len(axes) == 1 \
            else mesh[axes]._flatten().get_group()
        _count("gather", axes[0] if len(axes) == 1 else "data",
               _bytes(t) * size)
        t = all_gather(t, dim, group, size, idx)
    return t


def vocab_gather(logits: torch.Tensor) -> torch.Tensor:
    """Whole-vocabulary logits from this rank's vocab-parallel slice (the
    identity where the vocabulary is not split)."""
    if not split("vocab"):
        return logits
    return gather_model(logits, -1)


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last axis of the whole vocabulary (first index on
    ties, as ``torch.argmax`` and ``jnp.argmax``): each rank's local
    maximum and its global index, gathered, and the largest value's lowest
    index among the ranks that hold it."""
    shard = active_shard()
    rng = split("vocab")
    if not rng:
        return torch.argmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    _observe("argmax", "model", 16.0 * idx.numel() * shard.size)
    val = logits.float().gather(-1, idx[..., None])[..., 0]
    both = torch.stack([val.double(), (idx + rng[0]).double()])
    both = all_gather(both[None], 0, shard.group, shard.size, shard.rank)
    vals, idxs = both[:, 0], both[:, 1]              # (M, ...)
    best = vals.max(dim=0).values
    cand = torch.where(vals == best, idxs, torch.full_like(idxs, 2.0 ** 53))
    return cand.min(dim=0).values.long()
