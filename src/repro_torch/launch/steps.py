"""Train, prefill and decode steps, with sharding inference — the port of
``repro/launch/steps.py``.

``infer_param_axes`` and ``build_shardings`` (logical axis names by
parameter path, and the specs the rules give them, FSDP over the data
axes optionally) live in :mod:`repro_torch.parallel.placement` and keep
their names here; ``batch_specs`` and ``cache_specs`` are this module's.
The serve engine places its parameters by them on a mesh; meshed training
and the meshed prefill and decode steps build on the same tables.

The train state is the reference's pytree: ``{"params", "opt": {"m", "v",
"count"}, "step"[, "err"]}``, every leaf a tensor on one device; the
parameters are plain leaves that require grad. A train step computes the
gradients with ``torch.autograd.grad`` and updates the state **in place**
(:func:`repro_torch.optim.adamw_update`), the PyTorch form of the
reference's ``donate_argnums=(0,)``: the state handed in is the state
returned, one step on.

**On a mesh** (``build_train_step(..., mesh=)``, inside one rank of
:func:`repro_torch.launch.mesh.run_ranks`) the state is this rank's shards,
placed as the reference's dry run places it (``build_shardings(state,
state_axes(state), mesh, rules, fsdp=True)``, ``dryrun.py:211``) through a
:class:`~repro_torch.parallel.placement.Placement` (its adjustments: KV
heads the model axis does not divide, the attention where it does not
divide the q heads, and the router replicate over ``model``) and the
rank's :class:`~repro_torch.parallel.collectives.DataShard`; the batch is
this rank's rows (``batch_specs``: ``batch`` over ``data``, or over
``(pod, data)`` as one flattened axis, ``pod`` major, where the mesh has a
pod axis); ``heads``, ``ff``,
``vocab`` and ``experts`` split over ``model`` (``DEFAULT_RULES``), the
recurrent families refused a split ``model`` axis
(:func:`~repro_torch.parallel.sharding.train_rules_for`). The step runs
the rank's local model on its shards: FSDP gathers each parameter where it
is read and reduce-scatters its gradient, the column and row ops make the
tensor- and expert-parallel collectives under autograd
(:mod:`repro_torch.parallel.collectives`), the leaves ``data`` does not
split have their gradients summed over ``data``, and AdamW updates the
local shards (the gradient norm over the ranks that hold different
pieces). Each rank's loss is its share of the global batch's, so the sums
are the global batch's gradients.

**Prefill and decode on a mesh** (``build_prefill_step(..., mesh=)``,
``build_decode_step(mesh=)``) place the parameters as the reference's dry
run does (``build_shardings(params, infer_param_axes(params), mesh, rules,
fsdp=False)``, ``dryrun.py:217-243``) through a :class:`~repro_torch.
parallel.placement.Placement`, the batch and the cache by ``batch_specs``
/ ``cache_specs`` under the same rules (the dry run's ``rules_for(cfg,
shape, mesh, DEFAULT_RULES)``), and run the rank's local model on its
shards inside the mesh's context.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.data.pipeline import host_shard
from repro_torch.interop import tree_leaves, tree_map, tree_map_with_keys
from repro_torch.models.api import Model, build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compressed_gradients, cosine_schedule,
                               init_error_feedback)
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import DataShard
from repro_torch.parallel.placement import (
    DATA_AXES, Placement, _data_entry, _dedupe_spec, _divisible_spec,
    build_shardings, infer_param_axes)
from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           activate, logical_to_spec,
                                           mesh_axis_sizes,
                                           replicate_uneven_kv_heads,
                                           train_rules_for)

__all__ = ["TrainHyper", "init_train_state", "loss_and_grads",
           "apply_gradients", "build_train_step", "build_prefill_step",
           "build_decode_step", "trainable", "infer_param_axes",
           "build_shardings", "batch_specs", "cache_specs", "rules_for",
           "state_axes", "train_placement", "state_specs", "local_batch",
           "split_axes", "data_layout"]


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

_BATCH_TABLE = {
    "tokens": ("batch", "seq"), "labels": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "frames": ("batch", "seq", "embed"), "mask": ("batch", "seq"),
    "targets": ("batch", "seq"), "patches": ("batch", "seq", "embed"),
}

_CACHE_TABLE = {
    # 'kv_heads_cache' is distinct from the weights' 'kv_heads' so the
    # kv_dim_shard variant can re-layout the cache without un-sharding the
    # (flattened, divisible) K/V projection weights
    "k": (None, "batch", "kv_seq", "kv_heads_cache", "head_dim"),
    "v": (None, "batch", "kv_seq", "kv_heads_cache", "head_dim"),
    # scales have no head_dim — shard their seq dim instead (scale_seq),
    # orthogonal to the cache's head_dim sharding (kv_dim_shard variant)
    "k_scale": (None, "batch", "scale_seq", "kv_heads"),
    "v_scale": (None, "batch", "scale_seq", "kv_heads"),
    "h": (None, "batch", "ssm_heads", None, "state"),
    "conv": (None, "batch", None, "ssm_inner"),
    "pos": (),
}


def batch_specs(specs_tree, mesh, rules: ShardingRules):
    """Batch tree (tensors, e.g. on the ``meta`` device) → spec tree."""
    def one(keys, leaf):
        name = keys[-1]
        ndim = len(leaf.shape)
        if "cache" in keys and name in _CACHE_TABLE:
            axes = _CACHE_TABLE[name]
        elif name in _CACHE_TABLE and name in ("k", "v", "h", "conv", "pos"):
            axes = _CACHE_TABLE[name]
        else:
            axes = _BATCH_TABLE.get(name, (None,) * ndim)
        axes = tuple(axes)[:ndim]
        axes = axes + (None,) * (ndim - len(axes))
        spec = _dedupe_spec(logical_to_spec(axes, rules, mesh))
        return _divisible_spec(tuple(leaf.shape), spec, mesh)

    return tree_map_with_keys(one, specs_tree)


cache_specs = batch_specs  # same table handles cache entries


def rules_for(cfg, shape, mesh, base: ShardingRules) -> ShardingRules:
    """Per-(arch, shape) rule adjustments; ``shape`` has the reference
    ``ShapeSpec``'s ``phase`` and ``global_batch``.

    long-context decode with batch 1 cannot shard the batch axis — shard
    the KV cache / sequence dimension over ``data`` instead (SP / split-K
    decode).
    """
    rules = base
    axis_sizes = mesh_axis_sizes(mesh)
    batch_ways = 1
    for a in ("pod", "data"):
        batch_ways *= axis_sizes.get(a, 1)
    if shape.phase == "decode" and shape.global_batch < batch_ways:
        rules = rules.with_overrides(batch=None, kv_seq="data", seq=None)
    # the decode path's cache head axis replicates where the model axis
    # does not divide the kv heads (the input-side cache table is
    # divisibility-dropped too)
    return replicate_uneven_kv_heads(rules, cfg.n_kv_heads, mesh)


def state_axes(state: dict) -> dict:
    """Logical axes for the full train state (opt moments mirror params)."""
    p_axes = infer_param_axes(state["params"])
    out = {
        "params": p_axes,
        "opt": {"m": p_axes, "v": p_axes, "count": ()},
        "step": (),
    }
    if "err" in state:
        out["err"] = p_axes
    return out


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    adamw: AdamWConfig = AdamWConfig()
    compress_grads: bool = False
    # gradient accumulation: the global batch is split into this many
    # microbatches processed in turn — divides the live activation
    # footprint by the same factor at identical math (loss/grads averaged)
    microbatches: int = 1


def trainable(t: torch.Tensor) -> torch.Tensor:
    """A parameter leaf that requires grad, sharing ``t``'s storage."""
    return t.detach().requires_grad_(True)


def init_train_state(model: Model, generator: Optional[torch.Generator]
                     = None, *, hyper: TrainHyper, seed: int = 0,
                     device="cuda", params=None, placement=None) -> dict:
    """A fresh train state: the parameters drawn by :meth:`Model.init`
    (from ``generator``, else a new one seeded with ``seed``, on
    ``device``), or ``params`` as given (e.g. the JAX package's through
    :func:`repro_torch.interop.from_numpy`); zero f32 moments, step 0.
    The parameter leaves require grad; drawn by ``Model.init`` they share
    storage with the model's registered (serving) tree. ``placement``
    (:func:`train_placement`): this rank's shards of that state, the
    whole parameters drawn by every rank alike from the seed (into a
    model of their own, so that no whole tree outlives the call) and cut
    by the specs."""
    if placement is not None:
        if params is None:
            params = build_model(model.cfg).init(generator, seed=seed,
                                                 device=device)
        params = placement.local_params(params, device)
    elif params is None:
        params = model.init(generator, seed=seed, device=device)
    params = tree_map(trainable, params)
    device = tree_leaves(params)[0][1].device
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if hyper.compress_grads:
        state["err"] = init_error_feedback(params)
    return state


def train_placement(model: Model, mesh, rules: Optional[ShardingRules]
                    = None, *, fsdp: bool = True) -> Placement:
    """The placement of ``model``'s train state on ``mesh`` (a
    ``DeviceMesh`` of this rank) under ``rules`` (default
    ``DEFAULT_RULES``, checked by :func:`train_rules_for`): the parameter
    specs (FSDP over ``data`` with ``fsdp``), the rank's local model and
    its :class:`~repro_torch.parallel.collectives.RankShard`, which on a
    data axis of more than one rank carries the rank's
    :class:`~repro_torch.parallel.collectives.DataShard` (its rows of the
    batch, the group its gradients sum over, the FSDP-split leaves)."""
    rules = train_rules_for(model.cfg, mesh, rules or DEFAULT_RULES)
    placement = Placement(mesh, model, rules, fsdp=fsdp)
    axes, D, idx = data_layout(placement)
    if D > 1:
        group = mesh.get_group(axes[0]) if len(axes) == 1 \
            else mesh[axes]._flatten().get_group()
        fsdp_dims = {}
        for path, spec in tree_leaves(placement.param_specs):
            dims = [i for i, e in enumerate(spec)
                    if e is not None and _data_entry(e)]
            if dims:
                fsdp_dims[path] = dims[0]
        placement.shard = dataclasses.replace(placement.shard, data=DataShard(
            group=group, size=D, rank=idx, fsdp=fsdp_dims))
    return placement


def data_layout(placement) -> Tuple[tuple, int, int]:
    """``(axes, size, index)``: the data axes of the placement's mesh
    (``pod``, ``data``, those it has), the number of ranks along them, and
    this rank's index among those (``pod`` major): the group a training
    rank's batch splits over and its gradients sum over."""
    axes = tuple(a for a in DATA_AXES if a in placement.sizes)
    size, idx = 1, 0
    for a in axes:
        size *= placement.sizes[a]
        idx = idx * placement.sizes[a] + placement.coords[a]
    return axes, size, idx


def state_specs(state: dict, placement) -> dict:
    """The train state's specs on the placement's mesh: the moments (and
    the error feedback) mirror the parameters, the counters replicate."""
    p = placement.param_specs
    out = {"params": p, "opt": {"m": p, "v": p, "count": ()}, "step": ()}
    if "err" in state:
        out["err"] = p
    return out


def local_batch(batch: dict, placement) -> dict:
    """This rank's rows of the global ``batch`` (every rank builds the
    same from ``(seed, step)``): ``batch_specs`` split dim 0 over the data
    axes (:func:`data_layout`), each rank its contiguous rows
    (:func:`repro_torch.data.pipeline.host_shard`). A batch whose rows do
    not split over the data axes is refused."""
    axes, D, idx = data_layout(placement)
    if D == 1:
        return batch
    want = axes[0] if len(axes) == 1 else axes
    rows = {int(v.shape[0]) for v in batch.values()}
    specs = batch_specs(batch, placement.mesh, placement.rules)
    if len(rows) != 1 or any(not spec or spec[0] != want
                             for spec in specs.values()):
        raise ValueError(f"a global batch of {sorted(rows)} rows does not "
                         f"split over a data axis of {D}: each data rank "
                         "takes an equal share of the rows")
    return host_shard(batch, idx, D)


def _value_and_grad(model: Model, params, batch: dict):
    """``(grads, metrics)`` of ``model.loss`` at ``params``, the gradients
    in the order of ``tree_leaves(params)`` (an unused parameter's are
    zeros, as JAX gives them)."""
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, [t for _, t in tree_leaves(params)],
                                allow_unused=True, materialize_grads=True)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def _accumulate_grads(model: Model, params, batch: dict, n_micro: int):
    """Microbatches in turn: the f32 sum of their gradients over
    ``n_micro``, and the last microbatch's metrics."""
    for k, v in batch.items():
        if v.shape[0] % n_micro:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split into {n_micro} microbatches")
    micro = {k: v.chunk(n_micro, dim=0) for k, v in batch.items()}
    gsum = None
    for i in range(n_micro):
        grads, metrics = _value_and_grad(
            model, params, {k: v[i] for k, v in micro.items()})
        g32 = [g.float() for g in grads]
        gsum = g32 if gsum is None else [a + g for a, g in zip(gsum, g32)]
    return [a / n_micro for a in gsum], metrics


def loss_and_grads(model: Model, params, batch: dict, *,
                   microbatches: int = 1, placement=None):
    """The gradients of ``model.loss`` at ``params`` over ``batch`` (in
    ``microbatches`` accumulated in f32 when above 1) and the metrics.
    ``placement``: ``params`` and ``batch`` are a mesh rank's shards and
    rows, and ``model`` its local model; the gradients are the global
    batch's, this rank's shards of them (inside the mesh's context)."""
    if microbatches > 1:
        grads, metrics = _accumulate_grads(model, params, batch,
                                           microbatches)
    else:
        grads, metrics = _value_and_grad(model, params, batch)
    if placement is not None and data_layout(placement)[1] > 1:
        # the data-parallel sum of the leaves FSDP does not split (theirs
        # was summed by the gathers' backward)
        specs = dict(tree_leaves(placement.param_specs))
        idx = [i for i, (path, _) in enumerate(tree_leaves(params))
               if not any(e is not None and _data_entry(e)
                          for e in specs[path])]
        for i, g in zip(idx, collectives.grad_sum([grads[i] for i in idx])):
            grads[i] = g
    it = iter(grads)
    return tree_map(lambda _: next(it), params), metrics


def split_axes(placement) -> dict:
    """``{path: axes}``: the axes (of more than one rank) over which each
    parameter's pieces differ: ``"model"``, and ``"data"`` for the data
    axes (``data``, or ``(pod, data)`` flattened)."""
    sizes = placement.sizes

    def ways(e) -> int:
        n = 1
        for a in (e if isinstance(e, tuple) else (e,)):
            n *= sizes[a]
        return n

    return {path: tuple("data" if _data_entry(e) else e for e in spec
                        if e is not None and ways(e) > 1)
            for path, spec in tree_leaves(placement.param_specs)}


def apply_gradients(state: dict, grads, metrics: dict, *,
                    hyper: TrainHyper, splits=None) -> Tuple[dict, dict]:
    """The optimizer half of a train step, in place: int8 compression with
    error feedback (``hyper.compress_grads``), the cosine schedule's lr
    and AdamW → ``(state one step on, metrics with grad_norm and lr)``.
    ``splits``: on a mesh, the axes each leaf's shards differ over (the
    gradient norm's sums; inside the mesh's context)."""
    new_err = None
    if hyper.compress_grads:
        grads, new_err = compressed_gradients(grads, state["err"])
    lr = cosine_schedule(state["step"], peak_lr=hyper.peak_lr,
                         warmup_steps=hyper.warmup_steps,
                         total_steps=hyper.total_steps)
    new_params, new_opt, opt_metrics = adamw_update(
        grads, state["opt"], state["params"], lr=lr, config=hyper.adamw,
        splits=splits)
    new_state = {"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}
    if new_err is not None:
        new_state["err"] = new_err
    return new_state, {**metrics, **opt_metrics}


def build_train_step(model: Model, *, hyper: TrainHyper, mesh=None,
                     rules: Optional[ShardingRules] = None,
                     fsdp: bool = True, return_grads: bool = False) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place (module docstring). The batch's tensors must be on
    the state's device.

    ``mesh``: a ``DeviceMesh`` of this rank (:func:`repro_torch.launch.
    mesh.make_mesh`): the state is this rank's shards (:func:`init_train_
    state` with the step's ``placement``), the batch its rows
    (:func:`local_batch`), and the metrics the global batch's on every
    rank. ``fsdp=False`` keeps the parameters whole over ``data`` (their
    gradients summed over it). The step carries its placement as
    ``train_step.placement`` (``None`` off a mesh). ``return_grads``: the
    step returns ``(state, metrics, grads)``, ``grads`` the gradients it
    applied (the global batch's; on a mesh this rank's shards of them),
    for holding one step against another."""
    placement = None if mesh is None else train_placement(
        model, mesh, rules, fsdp=fsdp)

    def train_step(state: dict, batch: dict):
        if placement is None:
            grads, metrics = loss_and_grads(model, state["params"], batch,
                                            microbatches=hyper.microbatches)
            state, metrics = apply_gradients(state, grads, metrics,
                                             hyper=hyper)
        else:
            with activate(mesh, placement.rules, placement.shard):
                grads, metrics = loss_and_grads(
                    placement.local_model, state["params"], batch,
                    microbatches=hyper.microbatches, placement=placement)
                state, metrics = apply_gradients(
                    state, grads, metrics, hyper=hyper,
                    splits=split_axes(placement))
        return (state, metrics, grads) if return_grads else (state, metrics)

    train_step.placement = placement
    return train_step


def build_prefill_step(model: Model, *, max_len: int, mesh=None,
                       rules: Optional[ShardingRules] = None) -> Callable:
    """``prefill_step(params, batch) -> (logits, cache)``: ``model.prefill``
    at ``max_len``. ``mesh``: the parameters are this rank's shards (a
    :class:`~repro_torch.parallel.placement.Placement` under ``rules``,
    default ``DEFAULT_RULES``; ``placement.local_params`` cuts them), the
    batch its rows (``batch_specs`` under the placement's rules), and the
    step runs the rank's local model in the mesh's context: the logits
    are this rank's rows (its vocabulary slice where the vocabulary
    splits), the cache its rows and KV heads. The step carries its
    placement as ``prefill_step.placement`` (``None`` off a mesh)."""
    placement = None if mesh is None else Placement(
        mesh, model, rules or DEFAULT_RULES)

    def prefill_step(params, batch):
        if placement is None:
            return model.prefill(params, batch, max_len=max_len)
        with activate(mesh, placement.rules, placement.shard):
            return placement.local_model.prefill(params, batch,
                                                 max_len=max_len)

    prefill_step.placement = placement
    return prefill_step


def build_decode_step(model: Model, *, mesh=None,
                      rules: Optional[ShardingRules] = None) -> Callable:
    """``decode_step(params, cache, tokens) -> (logits, cache)``:
    ``model.decode_step``, the cache updated in place. ``mesh``: as
    :func:`build_prefill_step`, the cache this rank's rows and KV heads
    (``cache_specs`` under the placement's rules)."""
    placement = None if mesh is None else Placement(
        mesh, model, rules or DEFAULT_RULES)

    def decode_step(params, cache, tokens):
        if placement is None:
            return model.decode_step(params, cache, tokens)
        with activate(mesh, placement.rules, placement.shard):
            return placement.local_model.decode_step(params, cache, tokens)

    decode_step.placement = placement
    return decode_step
