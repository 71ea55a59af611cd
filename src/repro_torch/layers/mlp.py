"""Feed-forward blocks: SwiGLU (llama family) and GELU (encoder family) —
``repro/layers/mlp.py``.

The d_ff contraction of ``w_down`` is the widest MOA of a dense arch; it
routes through the model's strategy (``cfg.moa_for("mlp")``).
"""

from __future__ import annotations

import torch

from repro_torch.layers.common import Params, dense_init
from repro_torch.layers.linear import project, project_rows
from repro_torch.layers.numerics import silu_f32

__all__ = ["swiglu", "init_gelu_mlp", "gelu_mlp"]


def swiglu(params: Params, x: torch.Tensor, *, strategy=None,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; on a mesh that splits
    ``ff`` over ``model``, ``w_gate`` / ``w_up`` are column-parallel (this
    rank's ``ff`` columns) and ``w_down`` row-parallel."""
    g = project({"w": params["w_gate"]}, x, strategy=strategy,
                compute_dtype=compute_dtype, site="ff")
    u = project({"w": params["w_up"]}, x, strategy=strategy,
                compute_dtype=compute_dtype, site="ff")
    h = silu_f32(g, out_dtype=compute_dtype) * u
    return project_rows({"w": params["w_down"]}, h, site="ff",
                        strategy=strategy, compute_dtype=compute_dtype)


def init_gelu_mlp(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32, *, lead=(), device=None) -> Params:
    """The GELU MLP's weights (stddev ``1/sqrt(fan_in)``) and zero biases,
    each with the leading axes ``lead`` (a stack of layers: ``(L,)``)."""
    lead = tuple(lead)
    return {
        "w_in": dense_init(generator, lead + (d_model, d_ff), dtype,
                           fan_in=d_model, device=device),
        "b_in": torch.zeros(lead + (d_ff,), dtype=dtype, device=device),
        "w_out": dense_init(generator, lead + (d_ff, d_model), dtype,
                            fan_in=d_ff, device=device),
        "b_out": torch.zeros(lead + (d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params: Params, x: torch.Tensor, *, strategy=None,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``gelu(x @ w_in + b_in) @ w_out + b_out``: the GELU in f32 with the
    tanh approximation (``jax.nn.gelu``'s default); on a mesh that splits
    ``ff`` over ``model``, ``w_in`` / ``b_in`` are column-parallel and
    ``w_out`` row-parallel, ``b_out`` added once after the sum."""
    h = project({"w": params["w_in"], "b": params["b_in"]}, x,
                strategy=strategy, compute_dtype=compute_dtype, site="ff")
    h = torch.nn.functional.gelu(h.float(), approximate="tanh") \
        .to(compute_dtype)
    return project_rows({"w": params["w_out"], "b": params["b_out"]}, h,
                        site="ff", strategy=strategy,
                        compute_dtype=compute_dtype)
