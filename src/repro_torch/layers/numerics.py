"""Numerics helpers — the repo's f32 upcast sites (``repro/layers/numerics.py``)."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "f32_upcast", "accum_upcast", "silu_f32",
           "softplus_f32", "sum_f32", "kv_scale_zeros"]

#: finite masking sentinel: keeps exp() well-defined on all-masked rows
NEG_INF = -1e30


def f32_upcast(x: torch.Tensor) -> torch.Tensor:
    """Upcast to f32 ahead of an accumulation / normalization / softmax."""
    return x.float()


def accum_upcast(x: torch.Tensor, accum_dtype) -> torch.Tensor:
    """Upcast an MOA operand to its accumulator dtype (usually f32)."""
    return x.to(accum_dtype)


def silu_f32(x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """SiLU evaluated in f32 (exp underflows in bf16 for moderate |x|)."""
    y = torch.nn.functional.silu(x.float())
    return y if out_dtype is None else y.to(out_dtype)


def softplus_f32(x: torch.Tensor, *, bias=None) -> torch.Tensor:
    """Softplus evaluated in f32 (the SSM dt parameterization), as
    ``jax.nn.softplus``: ``logaddexp(x, 0)``; ``bias`` (e.g. ``dt_bias``)
    is added after the upcast."""
    xf = x.float()
    if bias is not None:
        xf = xf + bias.float()
    return torch.logaddexp(xf, torch.zeros_like(xf))


def sum_f32(x: torch.Tensor, *, dim=None, out_dtype=None) -> torch.Tensor:
    """Sum-reduce with an explicit f32 accumulator, stored back in
    ``out_dtype`` (default: ``x.dtype``)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float()
    y = xf.sum() if dim is None else xf.sum(dim=dim)
    return y.to(out_dtype)


def kv_scale_zeros(shape, device) -> torch.Tensor:
    """Zero-initialized per-(pos, head) f32 scales for an int8 KV cache."""
    return torch.zeros(shape, dtype=torch.float32, device=device)
