"""Logical-axis sharding rules → per-dimension mesh axes (DP / FSDP / TP /
EP / SP) — the port of ``repro/parallel/sharding.py``.

Parameters and caches carry *logical* axis names (``("embed",
"heads")``); a :class:`ShardingRules` table maps logical names to mesh
axes. A **spec** is what the reference's ``PartitionSpec`` holds: a tuple
with one entry a tensor dimension, each ``None`` (replicated), a mesh axis
name, or a tuple of names (the dimension split over their product, the
first axis major). :func:`placements` turns a spec into
``torch.distributed.tensor`` placements on a ``DeviceMesh``, and
:func:`local_shard` cuts a full tensor down to this rank's piece.

Where the reference pins a layout inside the model with ``constrain``
(``with_sharding_constraint``) and lets GSPMD insert the collectives, the
port's model runs on each rank's local shards and makes the collectives
itself (:mod:`repro_torch.parallel.collectives`): the rules' ``constrain``
points become Megatron-style column- and row-parallel projections, a
vocab-parallel embedding and an expert-parallel MoE. :func:`activate`
binds a mesh, its rules and this rank's layout for them.

Default mapping (a ``(data, model)`` mesh; a leading ``pod`` axis is an
outer data axis):

  batch   → (pod, data)     DP
  vocab   → model           TP (embedding + logits)
  heads   → model           TP attention (q heads)
  kv_heads→ model            (replicated when the model axis does not
                              divide them)
  ff      → model           TP MLP
  experts → model           EP
  fsdp    → (pod, data)     parameter / optimizer-state sharding (ZeRO-3)
  seq     → None             (SP variants map seq → data for long context)

A mesh here is anything with named axes and a shape: a ``DeviceMesh``
(``mesh_dim_names``, ``mesh.shape``) or an object with ``axis_names`` and
``devices.shape`` (the reference's ``Mesh``, or a stand-in of its shape).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.interop import tree_map, tree_map_with_keys

__all__ = ["ShardingRules", "DEFAULT_RULES", "activate", "active_context",
           "constraint_spec", "logical_to_spec", "param_shardings",
           "replicate_uneven_kv_heads", "serve_rules_for",
           "train_rules_for", "serve_cache_shardings", "mesh_axis_sizes",
           "placements", "local_shard", "local_shape", "local_slices"]

def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mesh-shaped
    object with ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name → mesh axis (or tuple of axes, or None)."""

    rules: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]

    @staticmethod
    def make(mapping: Dict[str, Optional[Tuple[str, ...] | str]]
             ) -> "ShardingRules":
        norm = []
        for k, v in mapping.items():
            if v is None:
                norm.append((k, None))
            elif isinstance(v, str):
                norm.append((k, (v,)))
            else:
                norm.append((k, tuple(v)))
        return ShardingRules(tuple(norm))

    def lookup(self, name: Optional[str]):
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                if v is None:
                    return None
                return v[0] if len(v) == 1 else v
        return None  # unknown logical names replicate

    def with_overrides(self, **overrides) -> "ShardingRules":
        d = {k: v for k, v in self.rules}
        for k, v in overrides.items():
            d[k] = (v,) if isinstance(v, str) else v
        return ShardingRules(tuple(d.items()))


DEFAULT_RULES = ShardingRules.make({
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "expert_capacity": None,
    "fsdp": ("pod", "data"),
    "embed": None,
    "seq": None,
    "seq_cp": "model",   # context-parallel attention (Ulysses-style layout)
    "kv_seq": None,
    "kv_heads_cache": "model",  # cache head axis (≠ the weights' kv_heads)
    "scale_seq": None,   # int8 KV scales' seq dim (kv_dim_shard → "model")
    "head_dim": None,    # kv_dim_shard variant maps this to "model"
    "state": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
})


class _Ctx(threading.local):
    mesh = None
    rules: Optional[ShardingRules] = None
    shard = None


_CTX = _Ctx()


@contextlib.contextmanager
def activate(mesh, rules: ShardingRules = DEFAULT_RULES, shard=None):
    """Run the model on this rank's shards inside this context: ``shard``
    (a :class:`repro_torch.parallel.collectives.RankShard`) says which of
    its contractions are split and over which process group they reduce.
    Outside a context every collective is the identity, so the model runs
    unchanged on one device."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.shard)
    _CTX.mesh, _CTX.rules, _CTX.shard = mesh, rules, shard
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.shard = prev


def active_context():
    return _CTX.mesh, _CTX.rules


def active_shard():
    """The active context's rank layout (``None`` outside one)."""
    return _CTX.shard


def logical_to_spec(names, rules: Optional[ShardingRules] = None,
                    mesh=None) -> tuple:
    """Logical names tuple → spec, dropping axes absent from mesh."""
    rules = rules or _CTX.rules or DEFAULT_RULES
    mesh = mesh if mesh is not None else _CTX.mesh
    mesh_axes = set(mesh_axis_sizes(mesh)) if mesh is not None else None
    out = []
    for n in names:
        ax = rules.lookup(n)
        if ax is not None and mesh_axes is not None:
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax if a in mesh_axes) or None
                if ax is not None and len(ax) == 1:
                    ax = ax[0]
            elif ax not in mesh_axes:
                ax = None
        out.append(ax)
    return tuple(out)


def _dedupe(spec) -> tuple:
    """A mesh axis may shard at most one dim — first occurrence wins (e.g.
    under SP the residual's seq→model takes priority; a later vocab→model
    on the same tensor replicates instead of erroring)."""
    seen = set()
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = _axes(entry)
        if any(a in seen for a in axes):
            out.append(None)
            continue
        seen.update(axes)
        out.append(entry)
    return tuple(out)


def constraint_spec(names, rules: Optional[ShardingRules] = None,
                    mesh=None) -> tuple:
    """The spec the reference's ``constrain`` pins for ``names``: logical
    lookup + one-dim-per-mesh-axis dedupe."""
    return _dedupe(logical_to_spec(names, rules, mesh))


def param_shardings(logical_tree, mesh=None,
                    rules: Optional[ShardingRules] = None):
    """Map a tree of logical-name tuples to specs."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules or DEFAULT_RULES
    if mesh is None:
        raise ValueError("param_shardings requires an active or explicit mesh")
    return tree_map(lambda names: logical_to_spec(names, rules, mesh),
                    logical_tree)


# ---------------------------------------------------------------------------
# Serving (docs/sharded-serving.md)
# ---------------------------------------------------------------------------


def serve_rules_for(family: str,
                    base: ShardingRules = DEFAULT_RULES) -> ShardingRules:
    """Serving rules for a model family.

    * **dense / moe** keep the full TP/EP table;
    * **ssm / hybrid** replicate every model-axis parameter: a split
      contraction's rounding noise feeds the *recurrent* state and
      compounds step over step, so these families serve data-parallel
      (slots over ``data``) with the model axis idle.
    """
    if family in ("ssm", "hybrid"):
        return base.with_overrides(
            heads=None, kv_heads=None, kv_heads_cache=None, ff=None,
            experts=None, vocab=None, ssm_inner=None, ssm_heads=None)
    return base


def train_rules_for(cfg, mesh,
                    base: ShardingRules = DEFAULT_RULES) -> ShardingRules:
    """Training rules for ``cfg`` on ``mesh``: ``base`` (the reference's
    train step places its state by ``DEFAULT_RULES``), the cache head axis
    replicated where the model axis does not divide the KV heads.

    A ``pod`` axis is an outer data axis: ``batch`` and ``fsdp`` go over
    ``(pod, data)`` (``DEFAULT_RULES``), which the trainer reduces over as
    one flattened group. Refused, each with its reason: a mesh with axes
    other than ``pod``, ``data`` and ``model``, and a split ``model`` axis
    for the recurrent families, whose SSD layer the rules would split over
    ``ssm_heads`` / ``ssm_inner``: the port trains them data-parallel
    (FSDP over the data axes) only."""
    sizes = mesh_axis_sizes(mesh)
    extra = sorted(set(sizes) - {"pod", "data", "model"})
    if extra:
        raise ValueError(f"the port trains on (pod, data, model) meshes; "
                         f"this one also has {extra}")
    M = sizes.get("model", 1)
    if cfg.family in ("ssm", "hybrid") and M > 1:
        raise ValueError(
            f"a model axis of {M} would split the {cfg.family} family's SSD "
            "layer (ssm_heads, ssm_inner): the port trains the recurrent "
            "families data-parallel only, FSDP over data; tensor "
            "parallelism of the SSD layer in training is ROADMAP Queue 1 "
            "item 21")
    return replicate_uneven_kv_heads(base, cfg.n_kv_heads, mesh)


def replicate_uneven_kv_heads(rules: ShardingRules, n_kv_heads: int,
                              mesh) -> ShardingRules:
    """Replicate ``kv_heads_cache`` when its mesh axes do not divide
    ``n_kv_heads`` (GQA kv heads fewer than the model axis)."""
    entry = rules.lookup("kv_heads_cache")
    if entry is None or not n_kv_heads:
        return rules
    sizes = mesh_axis_sizes(mesh)
    ways = 1
    for a in _axes(entry):
        ways *= sizes.get(a, 1)
    if n_kv_heads % ways:
        return rules.with_overrides(kv_heads_cache=None)
    return rules


#: serve-engine batched-cache leaves → logical axes (dense-slot layout).
#: Leaves under a stack key ("layers" / "kv" / "ssm") get a leading None
#: for the layer / application-point axis.
_SERVE_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads_cache", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads_cache", "head_dim"),
    "k_scale": ("batch", "scale_seq", "kv_heads_cache"),
    "v_scale": ("batch", "scale_seq", "kv_heads_cache"),
    "h": ("batch", "ssm_heads", None, "state"),
    "conv": ("batch", None, "ssm_inner"),
    "pos": ("batch",),
    "block_tables": ("batch", None),
}

#: paged-pool KV leaves: the physical block axis is shared across slots
#: (block tables are logical, host-side), so only the head dimension
#: shards — pages replicate over ``data`` and split over ``model``.
_SERVE_POOL_AXES = {
    "k": (None, None, "kv_heads_cache", "head_dim"),
    "v": (None, None, "kv_heads_cache", "head_dim"),
    "k_scale": (None, None, "kv_heads_cache"),
    "v_scale": (None, None, "kv_heads_cache"),
}

_STACK_KEYS = ("layers", "kv", "ssm")
_POOL_LEAVES = ("k", "v", "k_scale", "v_scale")


def _drop_indivisible(shape, spec, mesh) -> tuple:
    """Replicate any dim its mesh axes do not evenly divide (GQA kv heads
    smaller than the model axis, odd slot counts, ...)."""
    sizes = mesh_axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        ways = 1
        for a in _axes(entry):
            ways *= sizes[a]
        out.append(entry if dim % ways == 0 else None)
    return tuple(out)


def serve_cache_shardings(cache, mesh, rules: ShardingRules = DEFAULT_RULES,
                          *, paged: bool = False):
    """Specs for a serve-engine batched cache (a tree of tensors, e.g. on
    the ``meta`` device).

    KV leaves are stacked ``(stack, n_slots, max_len, Hk, D)`` in
    dense-slot mode or pooled ``(stack, n_phys_blocks, block_size, Hk,
    D)`` in paged mode, beside per-slot ``pos`` / ``block_tables`` / SSM
    state. Slots shard over the data axis, KV head dims over the model
    axis (per ``rules``); indivisible dims replicate instead of erroring.
    """
    def one(keys, leaf):
        name = keys[-1]
        pooled = paged and name in _POOL_LEAVES \
            and not any(k == "ssm" for k in keys)
        axes = _SERVE_POOL_AXES[name] if pooled \
            else _SERVE_CACHE_AXES.get(name, ())
        if any(k in _STACK_KEYS for k in keys):
            axes = (None,) + tuple(axes)
        axes = tuple(axes)[: leaf.dim()]
        axes = axes + (None,) * (leaf.dim() - len(axes))
        spec = _dedupe(logical_to_spec(axes, rules, mesh))
        return _drop_indivisible(tuple(leaf.shape), spec, mesh)

    return tree_map_with_keys(one, cache)


# ---------------------------------------------------------------------------
# Specs → placements and local shards
# ---------------------------------------------------------------------------


def placements(spec, mesh) -> tuple:
    """A spec as ``torch.distributed.tensor`` placements on the
    ``DeviceMesh`` ``mesh``: one a mesh dimension, ``Shard(d)`` where
    tensor dim ``d`` splits over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in _axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _slices(shape, spec, mesh, coords: Dict[str, int]):
    """This rank's ``slice`` of each dim: a dim split over axes ``(a, b)``
    takes piece ``coord(a) * size(b) + coord(b)`` of ``size(a) *
    size(b)`` (the first axis major, as a ``PartitionSpec`` tuple)."""
    sizes = mesh_axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(slice(None))
            continue
        ways, idx = 1, 0
        for a in _axes(entry):
            ways *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if dim % ways:
            raise ValueError(f"dim {dim} does not split {ways} ways "
                             f"(spec {spec})")
        n = dim // ways
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


#: this rank's ``slice`` of each dim of a ``shape`` tensor under ``spec``
local_slices = _slices


def local_shape(shape, spec, mesh, coords: Dict[str, int]) -> tuple:
    """The shape of this rank's piece of a ``shape`` tensor under
    ``spec``; ``coords`` is this rank's index along each mesh axis."""
    return tuple(len(range(*s.indices(d)))
                 for s, d in zip(_slices(shape, spec, mesh, coords), shape))


def local_shard(t: torch.Tensor, spec, mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``spec``: a
    contiguous copy (so the full tensor can be freed), or ``t`` itself
    where ``spec`` splits nothing (its axes replicated or of size 1)."""
    shape = tuple(t.shape)
    slices = _slices(shape, spec, mesh, coords)
    if all(s.indices(d) == (0, d, 1) for s, d in zip(slices, shape)):
        return t
    return t[slices].clone(memory_format=torch.contiguous_format)
