"""Train, prefill and decode steps, with sharding inference — the port of
``repro/launch/steps.py``.

``infer_param_axes`` maps every parameter leaf to logical axis names by
path + rank (the tables below); ``build_shardings`` turns logical names
into specs (:mod:`repro_torch.parallel.sharding`) under the given rules,
**dropping any axis that does not divide the dimension** (GQA kv=8 on a
model=16 axis replicates rather than erroring) and optionally upgrading
unsharded major dims to FSDP over the data axes (ZeRO-3). The serve
engine places its parameters by them on a mesh; meshed training builds on
the same tables.

The train state is the reference's pytree: ``{"params", "opt": {"m", "v",
"count"}, "step"[, "err"]}``, every leaf a tensor on one device; the
parameters are plain leaves that require grad. A train step computes the
gradients with ``torch.autograd.grad`` and updates the state **in place**
(:func:`repro_torch.optim.adamw_update`), the PyTorch form of the
reference's ``donate_argnums=(0,)``: the state handed in is the state
returned, one step on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.interop import (tree_get, tree_leaves, tree_map,
                                 tree_map_with_keys)
from repro_torch.models.api import Model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compressed_gradients, cosine_schedule,
                               init_error_feedback)
from repro_torch.parallel.sharding import (ShardingRules, logical_to_spec,
                                           mesh_axis_sizes,
                                           replicate_uneven_kv_heads)

__all__ = ["TrainHyper", "init_train_state", "loss_and_grads",
           "apply_gradients", "build_train_step", "build_prefill_step",
           "build_decode_step", "trainable", "infer_param_axes",
           "build_shardings", "batch_specs", "cache_specs", "rules_for",
           "state_axes"]


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
                     device="cuda", params=None) -> dict:
    """A fresh train state: the parameters drawn by :meth:`Model.init`
    (from ``generator``, else a new one seeded with ``seed``, on
    ``device``), or ``params`` as given (e.g. the JAX package's through
    :func:`repro_torch.interop.from_numpy`); zero f32 moments, step 0.
    The parameter leaves require grad; drawn by ``Model.init`` they share
    storage with the model's registered (serving) tree."""
    if params is None:
        params = model.init(generator, seed=seed, device=device)
    params = tree_map(trainable, params)
    device = tree_leaves(params)[0][1].device
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if hyper.compress_grads:
        state["err"] = init_error_feedback(params)
    return state


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
                   microbatches: int = 1):
    """The gradients of ``model.loss`` at ``params`` over ``batch`` (in
    ``microbatches`` accumulated in f32 when above 1) and the metrics."""
    if microbatches > 1:
        grads, metrics = _accumulate_grads(model, params, batch,
                                           microbatches)
    else:
        grads, metrics = _value_and_grad(model, params, batch)
    it = iter(grads)
    return tree_map(lambda _: next(it), params), metrics


def apply_gradients(state: dict, grads, metrics: dict, *,
                    hyper: TrainHyper) -> Tuple[dict, dict]:
    """The optimizer half of a train step, in place: int8 compression with
    error feedback (``hyper.compress_grads``), the cosine schedule's lr
    and AdamW → ``(state one step on, metrics with grad_norm and lr)``."""
    new_err = None
    if hyper.compress_grads:
        grads, new_err = compressed_gradients(grads, state["err"])
    lr = cosine_schedule(state["step"], peak_lr=hyper.peak_lr,
                         warmup_steps=hyper.warmup_steps,
                         total_steps=hyper.total_steps)
    new_params, new_opt, opt_metrics = adamw_update(
        grads, state["opt"], state["params"], lr=lr, config=hyper.adamw)
    new_state = {"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}
    if new_err is not None:
        new_state["err"] = new_err
    return new_state, {**metrics, **opt_metrics}


def build_train_step(model: Model, *, hyper: TrainHyper) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place (module docstring). The batch's tensors must be on
    the state's device."""

    def train_step(state: dict, batch: dict) -> Tuple[dict, dict]:
        grads, metrics = loss_and_grads(model, state["params"], batch,
                                        microbatches=hyper.microbatches)
        return apply_gradients(state, grads, metrics, hyper=hyper)

    return train_step


def build_prefill_step(model: Model, *, max_len: int) -> Callable:
    """``model.prefill`` at ``max_len``: an alias kept under the
    reference's name (which jits it); the port's engine calls the model."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=max_len)

    return prefill_step


def build_decode_step(model: Model) -> Callable:
    """``model.decode_step``: an alias kept under the reference's name."""
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step
