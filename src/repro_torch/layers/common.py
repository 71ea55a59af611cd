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


def truncated_normal_init(generator: torch.Generator, shape, stddev: float,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """``stddev`` × a standard normal truncated to [-2, 2], drawn in f32 and
    cast to ``dtype`` (the reference's ``truncated_normal_init``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (t * stddev).to(dtype)


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
