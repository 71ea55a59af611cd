"""One rank's share of a serve engine on a device mesh — the port of the
mesh half of ``repro/serve/engine.py`` (its ``NamedSharding`` placement
of parameters and cache).

:class:`MeshPlacement` is a :class:`~repro_torch.parallel.placement.
Placement` (the parameters' specs under the rules, default
:func:`serve_rules_for` the family; the local model; the rank's
:class:`~repro_torch.parallel.collectives.RankShard`) with the cache's
specs (:func:`repro_torch.parallel.serve_cache_shardings`) and the slots.
Slots (the cache's ``batch`` axis) go over the data axes where they
divide; this rank then holds rows ``rows[0]:rows[1]`` of every per-slot
leaf. The paged pool's pages replicate over ``data``: a prefill writes
its pages on every rank, a slot's own decode writes only where the slot
lives, and only that rank reads them.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.interop import tree_get, tree_leaves
from repro_torch.parallel.placement import Placement
from repro_torch.parallel.sharding import (ShardingRules, local_shape,
                                           serve_cache_shardings,
                                           serve_rules_for)

__all__ = ["MeshPlacement"]


class MeshPlacement(Placement):
    """The placement of a served ``model`` on ``mesh`` under ``rules``
    (default: :func:`serve_rules_for` the family), for ``n_slots`` slots.
    Raises ``ValueError`` for a layout the port's layers cannot run."""

    def __init__(self, mesh, model, rules: Optional[ShardingRules], *,
                 n_slots: int):
        cfg = model.cfg
        super().__init__(mesh, model, rules if rules is not None
                         else serve_rules_for(cfg.family))
        # slots: the cache's batch axis over the data axes, where it divides
        batch = self.rules.lookup("batch")
        axes = tuple(a for a in ((batch,) if isinstance(batch, str)
                                 else (batch or ())) if a in self.sizes)
        ways, idx = 1, 0
        for a in axes:
            ways *= self.sizes[a]
            idx = idx * self.sizes[a] + self.coords[a]
        if n_slots % ways:
            ways, idx = 1, 0
        self.slot_ways, self.slot_index = ways, idx
        per = n_slots // ways
        self.rows: Tuple[int, int] = (idx * per, (idx + 1) * per)
        #: this rank's rows are the ones every rank adopts: coordinate 0
        #: on every mesh axis its slots do not split over
        split_axes = axes if ways > 1 else ()
        self.lead = all(c == 0 for a, c in self.coords.items()
                        if a not in split_axes)
        if cfg.family == "moe" and ways > 1 \
                and not model.supports_padded_prefill:
            raise ValueError(
                "a capacity-limited MoE cannot split its slots over the "
                "data axis: each rank would route only its own slots' "
                "tokens against the expert capacity, which drops other "
                "choices than one device does (ROADMAP Queue 1 item 19)")

    def cache_specs(self, full_cache, *, paged: bool):
        """The cache's specs (from a full-size tree, e.g. on ``meta``)."""
        return serve_cache_shardings(full_cache, self.mesh, self.rules,
                                     paged=paged)

    def check_local(self, full_cache, local_cache, *, paged: bool) -> dict:
        """The cache specs, after checking that every leaf of this rank's
        ``local_cache`` has the shape its spec gives the full leaf."""
        specs = self.cache_specs(full_cache, paged=paged)
        for (path, full), (_, mine) in zip(tree_leaves(full_cache),
                                           tree_leaves(local_cache)):
            spec = tree_get(specs, path.split("."))
            want = local_shape(tuple(full.shape), spec, self.mesh,
                               self.coords)
            if tuple(mine.shape) != want:
                raise AssertionError(f"cache leaf {path}: local shape "
                                     f"{tuple(mine.shape)}, its spec {spec} "
                                     f"gives {want}")
        return specs
