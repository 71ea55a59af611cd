"""Train, prefill and decode steps — the port of the step half of
``repro/launch/steps.py`` (its sharding half, ``infer_param_axes`` …
``rules_for`` and ``state_axes``, lands with ROADMAP Queue 1 item 13).

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

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models.api import Model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compressed_gradients, cosine_schedule,
                               init_error_feedback)

__all__ = ["TrainHyper", "init_train_state", "loss_and_grads",
           "apply_gradients", "build_train_step", "build_prefill_step",
           "build_decode_step", "trainable"]


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
