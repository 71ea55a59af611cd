"""Shared layer primitives: RMSNorm and initializers (``repro/layers/common.py``).

Parameters are nested dicts of tensors with the reference pytree's keys;
layers are plain functions on tensors. Every random draw takes a
``torch.Generator`` on the device the tensor is made on.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.layers.numerics import f32_upcast

Params = Dict[str, Any]

__all__ = ["Params", "rms_norm", "dense_init",
           "truncated_normal_init"]


#: elements of one f32 draw: a larger tensor is drawn this many elements
#: at a time, in the order of its flat index, so that the f32 temporary of a
#: bf16 stack stays small (llava-next-34b's 60 layers of ``w_gate`` are
#: 8.8 G elements: 35 GB in f32 beside 69 GB of bf16 weights)
DRAW_ELEMS = 1 << 28


def truncated_normal_init(generator: torch.Generator, shape, stddev: float,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """``stddev`` × a standard normal truncated to [-2, 2], drawn in f32 and
    cast to ``dtype`` (the reference's ``truncated_normal_init``), in
    flat chunks of at most ``DRAW_ELEMS`` elements."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), DRAW_ELEMS):
        t = torch.empty(min(DRAW_ELEMS, flat.numel() - s),
                        dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
        flat[s:s + t.numel()] = t * stddev
    return out


def dense_init(generator: torch.Generator, shape, dtype=torch.float32, *,
               fan_in=None, device=None) -> torch.Tensor:
    """Scaled initializer: stddev = 1/sqrt(fan_in)."""
    fan_in = fan_in or shape[0]
    return truncated_normal_init(generator, shape, fan_in ** -0.5, dtype,
                                 device)


def rms_norm(params: Params, x: torch.Tensor, *, eps: float = 1e-6):
    """RMSNorm in f32 (the 1/sqrt(mean(x²)) reduction is itself an MOA —
    always exact f32); result in ``x.dtype``."""
    xf = f32_upcast(x)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * f32_upcast(params["scale"])).to(x.dtype)
