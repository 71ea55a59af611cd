"""AdamW with decoupled weight decay, global-norm clipping and f32 moments
— the port of ``repro/optim/adamw.py``.

Functional over the reference's pytree (nested dicts of tensors), with one
difference of form: :func:`adamw_update` writes the new parameters and
moments into the given tensors, under ``torch.no_grad()``, and returns
those trees. That is the PyTorch form of the reference's
``donate_argnums=(0,)``: at full width the state is 16 bytes a parameter,
and a second copy of it would not fit beside the first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.interop import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # decay is skipped for 1-D params (norm scales, biases) per convention
    decay_min_ndim: int = 2


def adamw_init(params) -> dict:
    """Zero f32 moments shaped like ``params`` and a 0-d int32 count, on
    the parameters' device."""
    zeros = lambda p: tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32,
                              device=a.device), p)
    device = tree_leaves(params)[0][1].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ‖g‖²) in f32."""
    leaves = [torch.sum(torch.square(g.float())) for _, g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, *, lr,
                 config: AdamWConfig = AdamWConfig()) -> Tuple[Any, dict,
                                                               dict]:
    """One AdamW step → ``(params, opt_state, metrics)``: the parameters
    and the moments are updated in place (see the module docstring); the
    count is a new 0-d tensor."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = None
    if config.clip_norm is not None:
        scale = torch.clamp(config.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    b1, b2 = config.b1, config.b2
    bc1 = 1.0 - torch.pow(b1, count.float())
    bc2 = 1.0 - torch.pow(b2, count.float())
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)

    m_leaves = dict(tree_leaves(opt_state["m"]))
    v_leaves = dict(tree_leaves(opt_state["v"]))
    p_leaves = dict(tree_leaves(params))
    for path, g in tree_leaves(grads):
        m, v, p = m_leaves[path], v_leaves[path], p_leaves[path]
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        step = (m / bc1) / (torch.sqrt(v / bc2) + config.eps)
        if p.dim() >= config.decay_min_ndim:
            step = step + config.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, metrics
