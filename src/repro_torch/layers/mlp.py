"""Feed-forward block: SwiGLU (llama family) — ``repro/layers/mlp.py``.

The d_ff contraction of ``w_down`` is the widest MOA of a dense arch; it
routes through the model's strategy (``cfg.moa_for("mlp")``).
"""

from __future__ import annotations

import torch

from repro_torch.layers.common import Params
from repro_torch.layers.linear import project
from repro_torch.layers.numerics import silu_f32

__all__ = ["swiglu"]


def swiglu(params: Params, x: torch.Tensor, *, strategy=None,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    g = project({"w": params["w_gate"]}, x, strategy=strategy,
                compute_dtype=compute_dtype)
    u = project({"w": params["w_up"]}, x, strategy=strategy,
                compute_dtype=compute_dtype)
    h = silu_f32(g, out_dtype=compute_dtype) * u
    return project({"w": params["w_down"]}, h, strategy=strategy,
                   compute_dtype=compute_dtype)
