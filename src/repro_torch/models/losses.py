"""Cross-entropy losses — the port of ``repro/models/losses.py``.

The reference keeps the logits sharded over the vocab through the
reduction (``impl="vocab_parallel"``) or replicates them first
(``impl="gather"``); on one device both constraints are no-ops, so both
values compute the same thing. The max is detached, as the reference's
``stop_gradient``.

On a mesh (:func:`repro_torch.parallel.sharding.activate`) that splits the
vocabulary over ``model``, ``"vocab_parallel"`` reduces the logits where
they lie: the detached maximum over the ``model`` ranks, the sum of
exponentials summed over them, the target's logit from the rank that holds
it (the others add exact zeros); ``"gather"`` assembles whole rows first.
Over ``data`` each rank holds its rows of the batch: the token count is
summed over the data ranks, so each rank's loss is its share of the global
batch's mean (their gradients add up to the global batch's), and the
metrics are the global batch's on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.parallel.collectives import (axis_max, gather_model,
                                              reduce_partial, split,
                                              vocab_argmax)

__all__ = ["softmax_cross_entropy", "masked_lm_loss", "LOSS_IMPLS"]

#: ``cfg.loss_impl`` values
LOSS_IMPLS = ("vocab_parallel", "gather")


def softmax_cross_entropy(logits, labels, *, mask=None,
                          impl: str = "vocab_parallel"
                          ) -> Tuple[torch.Tensor, dict]:
    """Mean CE of ``logits (B, S, V)`` against ``labels (B, S)`` over the
    tokens ``mask`` keeps (all by default) → ``(loss, {"loss", "tokens",
    "accuracy"})``, each a 0-d f32 tensor. On a data axis ``loss`` is this
    rank's share of the global mean and the metrics the global batch's
    (module docstring)."""
    if impl not in LOSS_IMPLS:
        raise ValueError(f"unknown loss impl {impl!r}; expected one of "
                         f"{LOSS_IMPLS}")
    logits = logits.float()
    labels = labels.long()
    rows = split("vocab")
    if rows and impl == "gather":
        logits, rows = gather_model(logits, -1), None
    if rows:
        lo, hi = rows
        m = axis_max(torch.amax(logits, dim=-1, keepdim=True), "model")
        sumexp = reduce_partial(torch.sum(torch.exp(logits - m), dim=-1))
        lse = torch.log(sumexp) + m[..., 0]
        local = labels - lo
        mine = (local >= 0) & (local < hi - lo)
        picked = torch.gather(logits, -1,
                              torch.where(mine, local, 0)[..., None])[..., 0]
        label_logit = reduce_partial(torch.where(mine, picked, 0.0))
        preds = vocab_argmax(logits.detach())
    else:
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
        label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
        preds = torch.argmax(logits, dim=-1)
    nll = lse - label_logit

    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(reduce_partial(torch.sum(mask), "data"), min=1.0)
    loss = torch.sum(nll * mask) / denom
    hits = torch.sum((preds == labels).float() * mask)
    metrics = {"loss": reduce_partial(loss.detach(), "data"),
               "tokens": denom,
               "accuracy": reduce_partial(hits, "data") / denom}
    return loss, metrics


def masked_lm_loss(logits, targets, mask_positions, *,
                   impl: str = "vocab_parallel"):
    """HuBERT-style masked-prediction loss: CE only at masked frames."""
    return softmax_cross_entropy(logits, targets, mask=mask_positions,
                                 impl=impl)
