"""The collectives of a model that runs on one rank's shards.

The reference pins layouts inside the model with ``constrain`` and lets
GSPMD insert the communication. The port runs each rank's local shards and
communicates where a split contraction needs it, Megatron-style:

* **column-parallel** projections (``wq``/``wk``/``wv``, ``w_gate``/
  ``w_up``) need nothing: each rank computes its own heads or ``ff``
  columns;
* **row-parallel** projections (``wo``, ``w_down``) produce f32 partial
  products that :func:`reduce_partial` all-reduces over ``model`` before
  the one cast to the compute type (:func:`repro_torch.layers.linear.
  project_rows`);
* the **vocab-parallel** embedding looks up its own rows and all-reduces
  (:func:`repro_torch.layers.embedding.embed`); the unembedding's logits
  stay local: :func:`vocab_argmax` picks the global argmax with the
  single-device tie break (the lowest index), :func:`vocab_gather`
  assembles whole rows where a temperature row samples;
* **expert parallelism** runs each rank's ``E / M`` experts and
  all-reduces the partial top-k combine (:mod:`repro_torch.layers.moe`).

Every device collective is a sum all-reduce (:func:`all_gather` is a sum of
zero-padded pieces): the one collective a gloo group carries for CUDA
tensors besides broadcast, so two ranks can share one card, where NCCL
refuses. Adding exact zeros leaves every value as it was, so the composed
gather is exact. Outside an active context (:func:`repro_torch.parallel.
sharding.activate`) every function here is the identity or the plain
single-device operation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.parallel.sharding import active_shard

__all__ = ["RankShard", "split", "reduce_partial", "all_gather",
           "all_reduce", "broadcast", "vocab_argmax", "vocab_gather",
           "counts", "reset_counts"]


@dataclasses.dataclass(frozen=True)
class RankShard:
    """One rank's piece of a model on a mesh: which contractions are split
    over the ``model`` axis and the process group they reduce over.

    ``heads``: the attention's q heads (and K/V heads where they divide)
    are this rank's; ``ff``: the dense MLP's ``ff`` columns are;
    ``experts`` / ``vocab``: this rank's ``[lo, hi)`` of the experts and
    of the vocabulary (``None``: all of them)."""

    group: object = None
    size: int = 1
    rank: int = 0
    heads: bool = False
    ff: bool = False
    experts: Optional[Tuple[int, int]] = None
    vocab: Optional[Tuple[int, int]] = None


#: collective calls by kind since :func:`reset_counts`
_COUNTS = {"all_reduce": 0, "broadcast": 0}


def counts() -> dict:
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def split(site: str):
    """The active shard's split of ``site`` (``"heads"``, ``"ff"``:
    bool; ``"experts"``, ``"vocab"``: ``(lo, hi)`` or ``None``), or a
    falsy value outside a context or on a one-rank model axis."""
    shard = active_shard()
    if shard is None or shard.size == 1:
        return None
    return getattr(shard, site)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` (default: every rank) in place, counted."""
    import torch.distributed as dist

    _COUNTS["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``x`` into every rank's ``x`` in place, counted."""
    import torch.distributed as dist

    _COUNTS["broadcast"] += 1
    dist.broadcast(x, src=src, group=group)
    return x


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """Sum the ``model`` ranks' partial results ``x`` (f32) in place."""
    shard = active_shard()
    if shard is None or shard.size == 1:
        return x
    return all_reduce(x, shard.group)


def all_gather(x: torch.Tensor, dim: int, group, size: int,
               rank: int) -> torch.Tensor:
    """``size`` ranks' ``x`` (equal shapes) concatenated along ``dim`` in
    rank order: each rank fills its piece of a zero buffer, and one sum
    all-reduce assembles them."""
    buf = torch.zeros((size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[rank] = x
    all_reduce(buf, group)
    return torch.cat(buf.unbind(0), dim=dim)


def vocab_gather(logits: torch.Tensor) -> torch.Tensor:
    """Whole-vocabulary logits from this rank's vocab-parallel slice (the
    identity where the vocabulary is not split)."""
    shard = active_shard()
    if not split("vocab"):
        return logits
    return all_gather(logits, -1, shard.group, shard.size, shard.rank)


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
    val = logits.float().gather(-1, idx[..., None])[..., 0]
    both = torch.stack([val.double(), (idx + rng[0]).double()])
    both = all_gather(both[None], 0, shard.group, shard.size, shard.rank)
    vals, idxs = both[:, 0], both[:, 1]              # (M, ...)
    best = vals.max(dim=0).values
    cand = torch.where(vals == best, idxs, torch.full_like(idxs, 2.0 ** 53))
    return cand.min(dim=0).values.long()
