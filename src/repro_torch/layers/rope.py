"""Rotary position embeddings (RoPE) — ``repro/layers/rope.py``."""

from __future__ import annotations

import torch

from repro_torch.layers.numerics import f32_upcast

__all__ = ["rope_frequencies", "apply_rope"]


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for even ``head_dim``: shape ``(head_dim // 2,)``."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(theta, exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x: (..., seq, heads, head_dim)`` by ``positions: (..., seq)``
    in f32; result in ``x.dtype``."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta=theta, device=x.device)
    angles = positions[..., :, None].float() * inv_freq     # (..., S, D/2)
    sin = torch.sin(angles)[..., :, None, :]               # over heads
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = torch.chunk(f32_upcast(x), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
