"""Token embedding + (optionally tied) output projection
(``repro/layers/embedding.py``)."""

from __future__ import annotations

import torch

from repro_torch.layers.common import Params, truncated_normal_init

__all__ = ["init_embedding", "embed", "unembed"]


def init_embedding(generator: torch.Generator, vocab: int, d_model: int, *,
                   tie: bool = True, dtype=torch.float32,
                   device=None) -> Params:
    p = {"table": truncated_normal_init(generator, (vocab, d_model), 0.02,
                                        dtype, device)}
    if not tie:
        p["unembed"] = truncated_normal_init(generator, (vocab, d_model),
                                             d_model ** -0.5, dtype, device)
    return p


def embed(params: Params, token_ids: torch.Tensor, *,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Lookup ``(B, S) int -> (B, S, d)`` in ``compute_dtype`` (gather, then
    cast: the same values as the reference's cast-then-gather)."""
    return params["table"][token_ids.long()].to(compute_dtype)


def unembed(params: Params, x: torch.Tensor, *,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits ``(B, S, d) -> (B, S, V)`` in f32 from ``compute_dtype``
    operands — the reference's einsum with ``preferred_element_type=f32``,
    outside any kernel there too, so it stays a plain ``torch.matmul``."""
    table = params.get("unembed", params["table"])
    return torch.matmul(x.to(compute_dtype).float(),
                        table.to(compute_dtype).float().t())
