"""Cross-entropy losses — the port of ``repro/models/losses.py``.

The reference keeps the logits sharded over the vocab through the
reduction (``impl="vocab_parallel"``) or replicates them first
(``impl="gather"``); on one device both constraints are no-ops, so both
values compute the same thing here. The max is detached, as the
reference's ``stop_gradient``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["softmax_cross_entropy", "masked_lm_loss", "LOSS_IMPLS"]

#: ``cfg.loss_impl`` values
LOSS_IMPLS = ("vocab_parallel", "gather")


def softmax_cross_entropy(logits, labels, *, mask=None,
                          impl: str = "vocab_parallel"
                          ) -> Tuple[torch.Tensor, dict]:
    """Mean CE of ``logits (B, S, V)`` against ``labels (B, S)`` over the
    tokens ``mask`` keeps (all by default) → ``(loss, {"loss", "tokens",
    "accuracy"})``, each a 0-d f32 tensor."""
    if impl not in LOSS_IMPLS:
        raise ValueError(f"unknown loss impl {impl!r}; expected one of "
                         f"{LOSS_IMPLS}")
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    labels = labels.long()
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - label_logit

    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    hits = (torch.argmax(logits, dim=-1) == labels).float()
    metrics = {"loss": loss, "tokens": denom,
               "accuracy": torch.sum(hits * mask) / denom}
    return loss, metrics


def masked_lm_loss(logits, targets, mask_positions, *,
                   impl: str = "vocab_parallel"):
    """HuBERT-style masked-prediction loss: CE only at masked frames."""
    return softmax_cross_entropy(logits, targets, mask=mask_positions,
                                 impl=impl)
