"""Token embedding + (optionally tied) output projection
(``repro/layers/embedding.py``).

On a mesh that splits ``vocab`` over ``model`` each rank holds rows ``[lo,
hi)`` of the table: the lookup is masked to them and summed over the
ranks (whose backward, the identity, scatters each rank's rows' gradient
into its own rows), and the unembedding produces this rank's slice of the
logits from its input through the column op
(:func:`repro_torch.parallel.collectives.vocab_argmax`, ``vocab_gather``
and the vocab-parallel loss read them)."""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import on_card
from repro_torch.layers.common import Params, truncated_normal_init
from repro_torch.parallel.collectives import (column_input,
                                              reduce_partial, split)

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
    cast: the same values as the reference's cast-then-gather). Vocab-split
    over ``model``: each rank looks up the ids in its rows (zeros for the
    rest) and the f32 sum over the ranks is the one row that is not zero,
    exactly."""
    rows = split("vocab")
    if not rows:
        return params["table"][token_ids.long()].to(compute_dtype)
    local = token_ids.long() - rows[0]
    mine = (local >= 0) & (local < rows[1] - rows[0])
    out = params["table"][torch.where(mine, local, 0)].float()
    out = torch.where(mine[..., None], out, 0.0)
    return reduce_partial(out).to(compute_dtype)


class _Unembed(torch.autograd.Function):
    """``x (m, d) bf16 @ table (V, d)ᵀ bf16`` with f32 logits: one bf16
    product with f32 output (``aten::mm.dtype``, which has no derivative).
    Backward: the reference's rule for ``preferred_element_type=f32``, the
    f32 products of the cotangent with the same bf16 operands, each
    rounded to its operand's type."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        return torch.mm(x, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        dx = torch.mm(g, table.float()).to(x.dtype)
        dtable = torch.mm(g.t(), x.float()).to(table.dtype)
        return dx, dtable


def unembed(params: Params, x: torch.Tensor, *,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits ``(B, S, d) -> (B, S, V)`` in f32 from ``compute_dtype``
    operands — the reference's einsum with ``preferred_element_type=f32``,
    outside any kernel there too, so it stays a library product. On CUDA a
    bf16 contraction is one bf16 product with f32 output (``aten::mm.dtype``:
    the table is read once in bf16, never copied to f32; differentiable
    through :class:`_Unembed`); CPU tensors, which have no kernel for that
    overload, and f32 compute take the f32 product of the same operands
    (a ``meta`` tensor, the card's stand-in, takes the CUDA product).
    Vocab-split over ``model``: this rank's rows of the vocabulary, ``x``
    through the column op."""
    table = params.get("unembed", params["table"]).to(compute_dtype)
    x = column_input(x.to(compute_dtype), "vocab")
    if on_card(x) and compute_dtype == torch.bfloat16:
        out = _Unembed.apply(x.reshape(-1, x.shape[-1]), table)
        return out.reshape(*x.shape[:-1], table.shape[0])
    return torch.matmul(x.float(), table.float().t())
