"""One rank's share of a serve engine on a device mesh — the port of the
mesh half of ``repro/serve/engine.py`` (its ``NamedSharding`` placement
of parameters and cache).

:class:`MeshPlacement` reads the rules table once: the parameters' specs
(:func:`repro_torch.launch.steps.build_shardings` of
:func:`~repro_torch.launch.steps.infer_param_axes`), the cache's
(:func:`repro_torch.parallel.serve_cache_shardings`), and from them the
model this rank runs: its configuration with the local head and ``ff``
counts, and the :class:`~repro_torch.parallel.collectives.RankShard` its
layers reduce over. Two adjustments make GSPMD's layout runnable as
local shards, each only where it changes nothing for the divisible case:

* the K/V projections replicate where the cache's KV heads do (GQA kv
  heads fewer than the model axis: the flattened ``wk`` divides, its
  heads do not), so every rank computes the one KV head its q heads
  share; an uneven split of more than one KV head is refused;
* the router replicates, so every rank routes every token alike.

Slots (the cache's ``batch`` axis) go over the data axes where they
divide; this rank then holds rows ``rows[0]:rows[1]`` of every per-slot
leaf. The paged pool's pages replicate over ``data``: a prefill writes
its pages on every rank, a slot's own decode writes only where the slot
lives, and only that rank reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.interop import (tree_get, tree_leaves, tree_map,
                                 tree_map_with_keys)
from repro_torch.launch.steps import build_shardings, infer_param_axes
from repro_torch.parallel.collectives import RankShard
from repro_torch.parallel.sharding import (ShardingRules, local_shape,
                                           local_shard, mesh_axis_sizes,
                                           replicate_uneven_kv_heads,
                                           serve_cache_shardings,
                                           serve_rules_for)

__all__ = ["MeshPlacement"]

#: weights whose split over ``model`` the port's layers run: the
#: attention's heads, the dense MLP's ``ff``, the experts, the vocabulary
_SPLIT_OK = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
             "w_down", "table", "unembed"}


def _has(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec)


class MeshPlacement:
    """Specs, local model and rank layout of a served ``model`` on
    ``mesh`` (a ``DeviceMesh`` with the reference's axis names) under
    ``rules`` (default: :func:`serve_rules_for` the family), for
    ``n_slots`` slots. Raises ``ValueError`` for a layout the port's
    layers cannot run."""

    def __init__(self, mesh, model, rules: Optional[ShardingRules], *,
                 n_slots: int):
        from repro_torch.models.api import build_model

        cfg = model.cfg
        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.coords: Dict[str, int] = dict(zip(mesh.mesh_dim_names,
                                               mesh.get_coordinate()))
        base = rules if rules is not None else serve_rules_for(cfg.family)
        self.rules = replicate_uneven_kv_heads(base, cfg.n_kv_heads, mesh)
        meta = model.abstract_params()
        self.full_shapes = tree_map_with_keys(lambda _, t: tuple(t.shape), meta)
        self.rule_specs = build_shardings(meta, infer_param_axes(meta), mesh,
                                          self.rules)
        self.param_specs = self._runnable(cfg)
        M = self.sizes.get("model", 1)
        shard = dict(group=mesh.get_group("model") if M > 1 else None,
                     size=M, rank=self.coords.get("model", 0))
        local = {}
        specs = self.param_specs

        def split(spec) -> bool:        # a one-rank axis splits nothing
            return M > 1 and _has(spec, "model")

        if cfg.family in ("dense", "moe"):
            attn = specs["layers"]["attn"]
            shard["heads"] = split(attn["wq"])
            if shard["heads"]:
                local["n_heads"] = cfg.n_heads // M
                if split(attn["wk"]):
                    local["n_kv_heads"] = cfg.n_kv_heads // M
            if "mlp" in specs["layers"] \
                    and split(specs["layers"]["mlp"]["w_gate"]):
                shard["ff"] = True
                local["d_ff"] = cfg.d_ff // M
            if cfg.family == "moe" \
                    and split(specs["layers"]["moe"]["w_gate"]):
                n = cfg.n_experts // M
                shard["experts"] = (shard["rank"] * n, (shard["rank"] + 1) * n)
        if split(specs["embed"]["table"]):
            n = cfg.vocab // M
            shard["vocab"] = (shard["rank"] * n, (shard["rank"] + 1) * n)
        self.shard = RankShard(**shard)
        self.local_model = build_model(dataclasses.replace(cfg, **local))
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

    def _runnable(self, cfg):
        """The rules' parameter specs with the two adjustments of the
        module docstring; refuses what the layers cannot run."""
        specs = tree_map(lambda spec: spec, self.rule_specs)   # a copy
        M = self.sizes.get("model", 1)
        for path, spec in tree_leaves(specs):
            keys = path.split(".")
            for e in spec:
                axes = e if isinstance(e, tuple) else (e,)
                if e is not None and axes != ("model",):
                    raise ValueError(
                        f"parameter {path} splits over {e}: serving shards "
                        "parameters over the model axis only")
            if M == 1 or not _has(spec, "model"):
                continue
            if cfg.family in ("ssm", "hybrid"):
                raise ValueError(
                    f"rules split {path} of the {cfg.family} family over "
                    "model: the port serves the recurrent families "
                    "data-parallel only (serve_rules_for); tensor "
                    "parallelism of the SSD layer is ROADMAP Queue 1 "
                    "item 19")
            if keys[-1] == "router":
                tree_get(specs, keys[:-1])[keys[-1]] = (None,) * len(spec)
            elif keys[-1] not in _SPLIT_OK:
                raise ValueError(f"parameter {path} cannot split over model")
        if cfg.family not in ("dense", "moe") or M == 1:
            return specs
        attn = specs["layers"]["attn"]
        heads = _has(attn["wq"], "model")
        kv_cache = self.rules.lookup("kv_heads_cache")
        kv_split = kv_cache is not None and "model" in (
            kv_cache if isinstance(kv_cache, tuple) else (kv_cache,)) \
            and cfg.n_kv_heads % M == 0
        if heads and cfg.n_heads % M:
            raise ValueError(f"{cfg.n_heads} heads do not split over a "
                             f"model axis of {M}")
        if heads and not kv_split:
            if cfg.n_kv_heads != 1:
                raise ValueError(
                    f"{cfg.n_kv_heads} KV heads replicate over a model axis "
                    f"of {M} while the q heads split: each rank would need "
                    "a different slice of the KV heads; serve with a model "
                    "axis that divides the KV heads (ROADMAP Queue 1 item "
                    "19)")
            for name in ("wk", "wv", "bk", "bv"):
                if name in attn:
                    attn[name] = (None,) * len(attn[name])
        if not heads and (kv_split or _has(attn["wo"], "model")):
            raise ValueError("rules split the KV heads or wo over model but "
                             "not the q heads")
        return specs

    # ---- parameters and cache --------------------------------------------
    def local_params(self, params, device):
        """This rank's pieces of ``params`` on ``device``: each leaf of the
        full shape is cut (:func:`repro_torch.parallel.sharding.
        local_shard`), and one that already has its piece's shape (a tree
        an engine on this mesh holds) is kept as it is."""
        def one(keys, leaf):
            spec = tree_get(self.param_specs, keys)
            full = tree_get(self.full_shapes, keys)
            mine = local_shape(full, spec, self.mesh, self.coords)
            if tuple(leaf.shape) == full:
                leaf = local_shard(leaf, spec, self.mesh, self.coords)
            elif tuple(leaf.shape) != mine:
                raise ValueError(f"parameter {'.'.join(keys)}: shape "
                                 f"{tuple(leaf.shape)} is neither the full "
                                 f"{full} nor this rank's piece {mine}")
            return leaf.to(device)

        return tree_map_with_keys(one, params)

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
