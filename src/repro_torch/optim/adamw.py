"""AdamW with decoupled weight decay, global-norm clipping and f32 moments
— the port of ``repro/optim/adamw.py``.

Functional over the reference's pytree (nested dicts of tensors), with one
difference of form: :func:`adamw_update` writes the new parameters and
moments into the given tensors, under ``torch.no_grad()``, and returns
those trees. That is the PyTorch form of the reference's
``donate_argnums=(0,)``: at full width the state is 16 bytes a parameter,
and a second copy of it would not fit beside the first.

On a mesh every leaf is this rank's shard: the update is elementwise, so it
runs on the shards as they are; only the gradient norm sums over the ranks
that hold different pieces of a leaf (``splits``), and the clip then scales
every shard alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.parallel.collectives import reduce_partial

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


def global_norm(tree, splits=None) -> torch.Tensor:
    """sqrt(Σ‖g‖²) in f32. ``splits``: ``{path: axes}`` of the leaves
    that are this rank's pieces, ``axes`` the mesh axes (``"data"``,
    ``"model"``) their pieces differ over: each leaf's sum of squares is
    summed over those axes' ranks and only those, so a replicated leaf
    counts once (inside the mesh's context,
    :func:`repro_torch.parallel.sharding.activate`)."""
    squares = [(path, torch.sum(torch.square(g.float())))
               for path, g in tree_leaves(tree)]
    if not splits or not any(splits.values()):
        return torch.sqrt(torch.sum(torch.stack([s for _, s in squares])))
    by = {(): [], ("data",): [], ("model",): [], ("data", "model"): []}
    for path, sq in squares:
        axes = splits.get(path, ())
        by[tuple(a for a in ("data", "model") if a in axes)].append(sq)
    zero = squares[0][1].new_zeros(())
    part = {k: torch.sum(torch.stack(v)) if v else zero
            for k, v in by.items()}
    data = reduce_partial(torch.stack([part[("data",)],
                                       part[("data", "model")]]), "data")
    model = reduce_partial(torch.stack([part[("model",)], data[1]]), "model")
    return torch.sqrt(part[()] + data[0] + model[0] + model[1])


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, *, lr,
                 config: AdamWConfig = AdamWConfig(),
                 splits=None) -> Tuple[Any, dict, dict]:
    """One AdamW step → ``(params, opt_state, metrics)``: the parameters
    and the moments are updated in place (see the module docstring); the
    count is a new 0-d tensor. ``splits``: a mesh's shards
    (:func:`global_norm`)."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads, splits)
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
