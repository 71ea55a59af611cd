"""One rank's shards of a model on a device mesh: the parameters' specs
under the sharding rules, and the model this rank runs on them.

:func:`infer_param_axes` maps every parameter leaf to logical axis names
by path and rank (the tables below); :func:`build_shardings` turns them
into specs (:mod:`repro_torch.parallel.sharding`) under the given rules,
**dropping any axis that does not divide the dimension** (GQA kv=8 on a
model=16 axis replicates rather than erroring) and optionally upgrading
unsharded major dims to FSDP over the data axes (ZeRO-3). Both are the
reference's ``repro/launch/steps.py`` functions (re-exported by
:mod:`repro_torch.launch.steps` under their names there).

:class:`Placement` reads the rules table once: the parameters' specs, and
from them the model this rank runs (its configuration with the local head
and ``ff`` counts) and the
:class:`~repro_torch.parallel.collectives.RankShard` its layers reduce
over. Three adjustments make GSPMD's layout runnable as local shards,
each only where it changes nothing for the divisible case:

* the K/V projections replicate where the cache's KV heads do (GQA kv
  heads fewer than the model axis, or a count it does not divide: the
  flattened ``wk`` divides, its heads do not), so every rank computes
  every KV head and its q heads attend those of their groups (the
  shard's ``kv_slice``; refused where a rank's q heads would straddle
  groups unevenly: neither of the rank's q-head count and the group size
  divides the other);
* the attention replicates where the model axis does not divide the q
  heads (40 or 56 heads on 16: GSPMD splits the flattened projection
  mid-head, which has no local-shard form); the MLP, the experts and the
  vocabulary still split;
* the router replicates, so every rank routes every token alike.

A training rank's parameters may also split over the data axes (FSDP):
``data``, or ``(pod, data)`` as one flattened axis, ``pod`` major.

Serving places its slots on top of it
(:class:`repro_torch.serve.mesh.MeshPlacement`); the meshed trainer adds a
training rank's :class:`~repro_torch.parallel.collectives.DataShard`, its
rows of the batch and the FSDP-split leaves
(:func:`repro_torch.launch.steps.train_placement`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.interop import (tree_get, tree_leaves, tree_map,
                                 tree_map_with_keys)
from repro_torch.models.api import build_model
from repro_torch.parallel.collectives import RankShard
from repro_torch.parallel.sharding import (ShardingRules, local_shape,
                                           local_shard, logical_to_spec,
                                           mesh_axis_sizes,
                                           replicate_uneven_kv_heads)

__all__ = ["Placement", "infer_param_axes", "build_shardings"]


# ---------------------------------------------------------------------------
# Logical axes by parameter path
# ---------------------------------------------------------------------------

_NAME_TABLE = {
    # attention
    "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
    "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",),
    # dense mlp
    "w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    "w_in": ("embed", "ff"), "b_in": ("ff",),
    "w_out": ("ff", "embed"), "b_out": ("embed",),
    # embedding
    "table": ("vocab", "embed"), "unembed": ("vocab", "embed"),
    "pos_embed": (None, "embed"), "mask_embed": ("embed",),
    # moe
    "router": ("embed", "experts"),
    # mamba2
    "in_proj": ("embed", "ssm_inner"), "out_proj": ("ssm_inner", "embed"),
    "conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",),
    "a_log": ("ssm_heads",), "dt_bias": ("ssm_heads",),
    "d_skip": ("ssm_heads",),
    # norms / misc
    "scale": ("norm",), "bias": ("norm",), "w": ("embed", "embed_out"),
    "b": ("embed_out",),
}

_MOE_TABLE = {
    "w_gate": ("experts", "embed", "ff"), "w_up": ("experts", "embed", "ff"),
    "w_down": ("experts", "ff", "embed"),
}

_STACKED_KEYS = ("layers", "app_norms")


def infer_param_axes(params):
    """Tree of logical-axis tuples matching ``params``' structure."""
    def one(keys, leaf):
        name = keys[-1]
        table = _MOE_TABLE if ("moe" in keys and name in _MOE_TABLE) \
            else _NAME_TABLE
        ndim = len(leaf.shape)
        axes = table.get(name)
        if axes is None:
            axes = (None,) * ndim
        if any(k in _STACKED_KEYS for k in keys):
            axes = (None,) + tuple(axes)
        axes = tuple(axes)[:ndim]
        return axes + (None,) * (ndim - len(axes))

    return tree_map_with_keys(one, params)


def _dedupe_spec(spec) -> tuple:
    """A mesh axis may shard at most one dim: first occurrence wins (e.g.
    MoE expert weights map both 'experts' and 'ff' to 'model' — EP takes
    priority, the ff dim replicates)."""
    seen = set()
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a in seen for a in axes):
            out.append(None)
            continue
        seen.update(axes)
        out.append(entry)
    return tuple(out)


def _divisible_spec(shape, spec, mesh) -> tuple:
    """Drop axes that don't evenly divide their dim (replicate instead)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes[a]
        out.append(entry if dim % total == 0 else None)
    return tuple(out)


def build_shardings(tree, axes_tree, mesh, rules: ShardingRules, *,
                    fsdp: bool = False):
    """Logical axes + rules → spec tree (divisibility-safe).

    FSDP shards over ALL data-parallel mesh axes (the rules' ``fsdp``
    entry, default ``(pod, data)`` — absent axes dropped), so optimizer
    state halves again on the multi-pod mesh.
    """
    sizes = mesh_axis_sizes(mesh)
    fsdp_entry = rules.lookup("fsdp")
    if fsdp_entry is None:
        fsdp_axes: tuple = ()
    elif isinstance(fsdp_entry, str):
        fsdp_axes = (fsdp_entry,)
    else:
        fsdp_axes = tuple(fsdp_entry)
    fsdp_axes = tuple(a for a in fsdp_axes if a in sizes)
    fsdp_size = 1
    for a in fsdp_axes:
        fsdp_size *= sizes[a]
    fsdp_spec_entry = (fsdp_axes[0] if len(fsdp_axes) == 1 else fsdp_axes) \
        if fsdp_axes else None

    def one(leaf, axes):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec = _dedupe_spec(logical_to_spec(axes, rules, mesh))
        spec = _divisible_spec(shape, spec, mesh)
        if fsdp and ndim >= 2 and fsdp_axes:
            entries = list(tuple(spec) + (None,) * (ndim - len(spec)))
            flat_axes = [a for e in entries if e is not None
                         for a in (e if isinstance(e, tuple) else (e,))]
            if any(a in flat_axes for a in fsdp_axes):
                return tuple(entries)
            # never FSDP the scan (stacked-layer) axis: dim 0 of stacked
            # leaves (axes was prepended with None and rank is >= 3)
            start = 1 if (len(axes) and axes[0] is None and ndim >= 3) else 0
            for i in range(start, ndim):
                if entries[i] is None and shape[i] % fsdp_size == 0 \
                        and shape[i] >= fsdp_size:
                    entries[i] = fsdp_spec_entry
                    break
            spec = tuple(entries)
        return spec

    return tree_map_with_keys(
        lambda keys, leaf: one(leaf, tree_get(axes_tree, keys)), tree)


# ---------------------------------------------------------------------------
# One rank's placement
# ---------------------------------------------------------------------------

#: weights whose split over ``model`` the port's layers run: the
#: attention's heads, the MLP's ``ff`` (SwiGLU and the encoder's GELU),
#: the experts, the vocabulary
_SPLIT_OK = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
             "w_down", "w_in", "b_in", "w_out", "table", "unembed"}

#: the families whose attention and MLP can split over ``model``
_TP_FAMILIES = ("dense", "moe", "encoder", "vlm")

#: the attention's weights
_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")

#: the data axes, in mesh order (FSDP and the batch split over them)
DATA_AXES = ("pod", "data")


def _has(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec)


def _unsplit(spec, axis: str) -> tuple:
    """``spec`` with ``axis`` replicated (its other axes kept)."""
    return tuple(None if e == axis else e for e in spec)


def kv_slice(n_heads: int, n_kv_heads: int, ways: int,
             rank: int) -> tuple:
    """``[lo, hi)`` of the KV heads that q heads ``[rank·H/ways, (rank+1)·
    H/ways)`` attend (GQA group ``G = H / Hk``: q head ``h`` attends KV
    head ``h // G``)."""
    per, group = n_heads // ways, n_heads // n_kv_heads
    return (rank * per // group, ((rank + 1) * per - 1) // group + 1)


def _data_entry(entry) -> bool:
    """Whether a spec entry splits over data axes alone, in mesh order
    (``"data"``, ``"pod"`` or ``("pod", "data")``)."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    return axes == tuple(a for a in DATA_AXES if a in axes)


class Placement:
    """Specs, local model and rank layout of ``model`` on ``mesh`` (a
    ``DeviceMesh`` with the reference's axis names) under ``rules``;
    ``fsdp``: the parameters also split over ``data`` (ZeRO-3, as
    :func:`build_shardings` gives them). Raises ``ValueError`` for a
    layout the port's layers cannot run."""

    def __init__(self, mesh, model, rules: ShardingRules, *,
                 fsdp: bool = False):
        cfg = model.cfg
        self.mesh = mesh
        self.fsdp = fsdp
        self.sizes = mesh_axis_sizes(mesh)
        self.coords: Dict[str, int] = dict(zip(mesh.mesh_dim_names,
                                               mesh.get_coordinate()))
        self.rules = replicate_uneven_kv_heads(rules, cfg.n_kv_heads, mesh)
        meta = model.abstract_params()
        self.full_shapes = tree_map_with_keys(lambda _, t: tuple(t.shape), meta)
        self.rule_specs = build_shardings(meta, infer_param_axes(meta), mesh,
                                          self.rules, fsdp=fsdp)
        #: the attention replicates over ``model`` (the q heads do not
        #: divide), a layout of the port's, not the rules'
        self.attention_replicated = False
        self.param_specs = self._runnable(cfg)
        M = self.sizes.get("model", 1)
        shard = dict(group=mesh.get_group("model") if M > 1 else None,
                     size=M, rank=self.coords.get("model", 0))
        local = {}
        specs = self.param_specs

        def split(spec) -> bool:        # a one-rank axis splits nothing
            return M > 1 and _has(spec, "model")

        if cfg.family in _TP_FAMILIES:
            attn = specs["layers"]["attn"]
            shard["heads"] = split(attn["wq"])
            if shard["heads"]:
                local["n_heads"] = cfg.n_heads // M
                if split(attn["wk"]):
                    shard["kv_heads"] = True
                    local["n_kv_heads"] = cfg.n_kv_heads // M
                else:
                    shard["kv_slice"] = kv_slice(cfg.n_heads, cfg.n_kv_heads,
                                                 M, shard["rank"])
            mlp = specs["layers"].get("mlp", {})
            first = mlp.get("w_gate", mlp.get("w_in"))
            if first is not None and split(first):
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
        #: the rank that writes what every rank holds alike: coordinate 0
        #: on every mesh axis
        self.lead = all(c == 0 for c in self.coords.values())

    def _runnable(self, cfg):
        """The rules' parameter specs with the two adjustments of the
        module docstring; refuses what the layers cannot run."""
        specs = tree_map(lambda spec: spec, self.rule_specs)   # a copy
        M = self.sizes.get("model", 1)
        allowed = "model and the data axes" if self.fsdp else "model"
        for path, spec in tree_leaves(specs):
            keys = path.split(".")
            for e in spec:
                if e is not None and e != "model" and not (
                        self.fsdp and _data_entry(e)):
                    raise ValueError(
                        f"parameter {path} splits over {e}: the port shards "
                        f"parameters over {allowed} alone")
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
                tree_get(specs, keys[:-1])[keys[-1]] = _unsplit(spec, "model")
            elif keys[-1] not in _SPLIT_OK:
                raise ValueError(f"parameter {path} cannot split over model")
        if cfg.family not in _TP_FAMILIES or M == 1:
            return specs
        attn = specs["layers"]["attn"]
        heads = _has(attn["wq"], "model")
        kv_cache = self.rules.lookup("kv_heads_cache")
        kv_split = kv_cache is not None and "model" in (
            kv_cache if isinstance(kv_cache, tuple) else (kv_cache,)) \
            and cfg.n_kv_heads % M == 0
        if heads and cfg.n_heads % M:
            for name in _ATTN:
                if name in attn:
                    attn[name] = _unsplit(attn[name], "model")
            heads, self.attention_replicated = False, True
        if heads and not kv_split:
            per, group = cfg.n_heads // M, cfg.n_heads // cfg.n_kv_heads
            if per % group and group % per:
                raise ValueError(
                    f"{cfg.n_kv_heads} KV heads replicate over a model axis "
                    f"of {M} while the q heads split {per} a rank, in "
                    f"groups of {group}: a rank's q heads would straddle "
                    "KV-head groups unevenly")
            for name in ("wk", "wv", "bk", "bv"):
                if name in attn:
                    attn[name] = _unsplit(attn[name], "model")
        if not heads and (kv_split or _has(attn["wo"], "model")):
            raise ValueError("rules split the KV heads or wo over model but "
                             "not the q heads")
        return specs

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
