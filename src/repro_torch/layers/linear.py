"""MOA-strategy-aware linear layer (``repro/layers/linear.py``).

Every dense contraction goes through :func:`project`, which schedules its K
reduction per a :mod:`repro_torch.moa` strategy; on a CUDA tensor the
default ``auto`` backend runs the ``dot_moa`` kernel. On a mesh a
column-parallel projection (``site`` split over ``model``) takes its
replicated input through :func:`~repro_torch.parallel.collectives.
column_input` (its backward sums the ranks' partial input gradients), and
a row-parallel one (:func:`project_rows`) sums the ranks' f32 partial
products before its one cast (the sum's backward is the identity).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import matmul_accum
from repro_torch.layers.common import Params
from repro_torch.moa import active_strategy
from repro_torch.parallel.collectives import (column_input,
                                              reduce_partial, split)

__all__ = ["project", "project_rows"]


def project(params: Params, x: torch.Tensor, *, strategy=None,
            compute_dtype=torch.bfloat16, site: str = None) -> torch.Tensor:
    """``x @ w (+ b)`` with the contraction scheduled per ``strategy``.

    ``x: (..., d_in)``; weights are cast to ``compute_dtype`` at use (a
    no-op when they are stored in it); accumulation is f32.
    ``strategy=None`` (and no active scope) is the plain one-shot matmul.
    ``site`` (``"heads"``, ``"kv_heads"``, ``"ff"``): where the active mesh
    splits it over ``model``, ``w`` holds this rank's columns and ``x``
    enters through the column op.
    """
    w = params["w"].to(compute_dtype)
    x = x.to(compute_dtype)
    if site is not None:
        x = column_input(x, site)
    strat = active_strategy(strategy)
    if strat is None:
        y = matmul_accum(x, w, torch.float32).to(compute_dtype)
    else:
        y = strat.dot(x, w, out_dtype=compute_dtype)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y


def project_rows(params: Params, x: torch.Tensor, *, site: str,
                 strategy=None, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`project` of a row-parallel weight: where the active mesh
    splits ``site`` (``"heads"`` for ``wo``, ``"ff"`` for ``w_down``) over
    ``model``, ``x`` and ``w`` hold this rank's slice of the contraction,
    the product comes out of ``dot_moa`` in f32 (its bf16 → f32 instance
    on the card), the ranks' partials are summed in f32, and the sum is
    cast once, then the bias added. Elsewhere it is :func:`project`."""
    if not split(site):
        return project(params, x, strategy=strategy,
                       compute_dtype=compute_dtype)
    w = params["w"].to(compute_dtype)
    x = x.to(compute_dtype)
    strat = active_strategy(strategy)
    if strat is None:
        y = matmul_accum(x, w, torch.float32)
    else:
        y = strat.dot(x, w, out_dtype=torch.float32)
    y = reduce_partial(y).to(compute_dtype)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y
