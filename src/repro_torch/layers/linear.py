"""MOA-strategy-aware linear layer (``repro/layers/linear.py``).

Every dense contraction goes through :func:`project`, which schedules its K
reduction per a :mod:`repro_torch.moa` strategy; on a CUDA tensor the
default ``auto`` backend runs the ``dot_moa`` kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import matmul_accum
from repro_torch.layers.common import Params
from repro_torch.moa import active_strategy

__all__ = ["project"]


def project(params: Params, x: torch.Tensor, *, strategy=None,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` with the contraction scheduled per ``strategy``.

    ``x: (..., d_in)``; weights are cast to ``compute_dtype`` at use (a
    no-op when they are stored in it); accumulation is f32.
    ``strategy=None`` (and no active scope) is the plain one-shot matmul.
    """
    w = params["w"].to(compute_dtype)
    x = x.to(compute_dtype)
    strat = active_strategy(strategy)
    if strat is None:
        y = matmul_accum(x, w, torch.float32).to(compute_dtype)
    else:
        y = strat.dot(x, w, out_dtype=compute_dtype)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y
