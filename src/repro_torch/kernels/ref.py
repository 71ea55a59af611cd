"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, in the same fold order
where the order is part of the contract (the ``dot_moa`` K clusters, the
``moa_reduce`` / ``loa_reduce`` operand clusters, the LOA combine). On a
CPU tensor the kernel wrappers in :mod:`ops` run these; on the card
``chip_smoke.py`` holds each kernel against them. They work on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import as_dtype, is_integer
from repro_torch.layers.numerics import NEG_INF

__all__ = ["matmul_accum", "loa_combine", "dot_moa_ref",
           "dot_moa_batched_ref", "moa_reduce_ref",
           "loa_add_ref", "loa_reduce_ref", "flash_attention_ref",
           "paged_attention_ref"]

#: K slice of the exact integer product: 2**20 products of magnitude below
#: 2**32 sum to below 2**52, so every float64 partial is an exact integer
_INT_K_SLICE = 1 << 20


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2**32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` modulo 2**32, as int64 in [0, 2**32)
    residues, on any device (PyTorch has no integer matmul on CUDA).

    Each int32 operand splits into a signed high and an unsigned low 16-bit
    half, ``x = hi·2**16 + lo``. Modulo 2**32 the product is
    ``lo·lo + 2**16·(hi·lo + lo·hi)`` (the ``hi·hi`` term is a multiple of
    2**32), three float64 matmuls whose every partial is an exact integer
    below 2**53 (see ``_INT_K_SLICE``)."""
    a, b = a.long(), b.long()
    a_hi, a_lo = (a >> 16).double(), (a & 0xFFFF).double()
    b_hi, b_lo = (b >> 16).double(), (b & 0xFFFF).double()
    acc = None
    for s in range(0, a.shape[-1], _INT_K_SLICE):
        k = slice(s, s + _INT_K_SLICE)
        lolo = torch.matmul(a_lo[..., k], b_lo[k]).long()
        mid = (torch.matmul(a_hi[..., k], b_lo[k]).long()
               + torch.matmul(a_lo[..., k], b_hi[k]).long())
        part = (lolo & 0xFFFFFFFF) + ((mid & 0xFFFF) << 16)
        acc = part if acc is None else acc + part
    return acc & 0xFFFFFFFF


def matmul_accum(a: torch.Tensor, b: torch.Tensor,
                 accum_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with the result in ``accum_dtype`` (the reference's
    ``preferred_element_type``). Floats: the operands upcast to f32, summed
    in f32, the result cast once. Integers: exact, and modulo 2**32 as
    XLA's int32 dot (products and sums wrap in two's complement)."""
    if is_integer(accum_dtype):
        return _wrap_int32(_int_matmul(a, b)).to(accum_dtype)
    return torch.matmul(a.float(), b.float()).to(accum_dtype)


def loa_combine(x: torch.Tensor, y: torch.Tensor,
                approx_bits: int) -> torch.Tensor:
    """Lower-part-OR fold of two int32 tensors: OR of the low ``l`` bits,
    AND of bit ``l-1`` as carry-in, exact add of the high parts (the
    reference's ``_loa_combine``; ``>>`` is arithmetic on int32)."""
    if approx_bits == 0:
        return x + y
    l = approx_bits
    mask = (1 << l) - 1
    low = (x & mask) | (y & mask)
    cin = ((x >> (l - 1)) & (y >> (l - 1))) & 1
    high = (x >> l) + (y >> l) + cin
    return (high << l) | low


def dot_moa_ref(a: torch.Tensor, b: torch.Tensor, *, block_k: int = 512,
                approx_bits: int = 0,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``(m, k) @ (k, n)`` with the K axis folded ``block_k`` operands at a
    time: each cluster's partial is formed in the accumulator type (f32 for
    floats, int32 for ints) and folded into the accumulator by ``+``, or by
    the LOA combine when ``approx_bits > 0`` (ints only, and then ``k``
    must be a multiple of ``block_k``). The output is cast once at the end
    (default: ``a.dtype`` for floats, int32 for ints)."""
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    is_int = is_integer(a.dtype)
    if approx_bits and not is_int:
        raise TypeError("LOA accumulation requires integer operands")
    block_k = min(block_k, k)
    if approx_bits and k % block_k:
        raise ValueError(f"k={k} must be a multiple of block_k={block_k} "
                         "for LOA")
    accum = torch.int32 if is_int else torch.float32
    out_dtype = as_dtype(out_dtype) if out_dtype is not None \
        else (torch.int32 if is_int else a.dtype)
    acc = None
    for s in range(0, k, block_k):
        part = matmul_accum(a[:, s:s + block_k], b[s:s + block_k], accum)
        acc = part if acc is None else loa_combine(acc, part, approx_bits)
    return acc.to(out_dtype)


def dot_moa_batched_ref(a: torch.Tensor, b: torch.Tensor, *,
                        block_k: int = 512, approx_bits: int = 0,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """``(E, m, k) @ (E, k, n) -> (E, m, n)``: :func:`dot_moa_ref` on each
    member, the plain version of ``jax.vmap`` over ``dot_moa_pallas``."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"batched contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return torch.stack([dot_moa_ref(x, w, block_k=block_k,
                                    approx_bits=approx_bits,
                                    out_dtype=out_dtype)
                        for x, w in zip(a, b)])


def _cluster_sums(x: torch.Tensor, block_n: int, accum: torch.dtype):
    """``(n, f)`` → the sums of its ``block_n``-row clusters in ``accum``
    (a ragged last cluster is summed as it stands: zero rows add exact
    zeros)."""
    return [torch.sum(x[s:s + block_n].to(accum), dim=0, dtype=accum)
            for s in range(0, x.shape[0], block_n)]


def moa_reduce_ref(x: torch.Tensor, *, block_n: int = 512) -> torch.Tensor:
    """``(n, f) → (f,)``: each ``block_n``-row cluster summed, the cluster
    sums folded in order into one accumulator — f32 for float operands,
    int32 (wrapping) for integer ones, whose sum modulo 2**32 no order
    changes (so it is one sum)."""
    if is_integer(x.dtype):
        return torch.sum(x, dim=0, dtype=torch.int32)
    accum = torch.float32
    acc = torch.zeros(x.shape[1:], dtype=accum, device=x.device)
    for part in _cluster_sums(x, max(min(block_n, x.shape[0]), 1), accum):
        acc = acc + part
    return acc


def loa_add_ref(x: torch.Tensor, y: torch.Tensor, *,
                approx_bits: int) -> torch.Tensor:
    """Element-wise Lower-part-OR addition on int32 (any shape)."""
    return loa_combine(x.to(torch.int32), y.to(torch.int32), approx_bits)


def loa_reduce_ref(x: torch.Tensor, *, approx_bits: int,
                   block_n: int = 256) -> torch.Tensor:
    """Approximate serialized MOA ``(n, f) → (f,)`` int32: each
    ``block_n``-row cluster summed exactly, the cluster sums folded in
    order through the LOA combine. ``n`` must be a multiple of
    ``block_n``: a zero-padded cluster would add one more LOA fold."""
    n = x.shape[0]
    block_n = min(block_n, n)
    if block_n < 1 or n % block_n:
        raise ValueError(f"n={n} not a multiple of block_n={block_n}")
    parts = _cluster_sums(x, block_n, torch.int32)
    acc = parts[0]
    for part in parts[1:]:
        acc = loa_combine(acc, part, approx_bits)
    return acc


def flash_attention_ref(q, k, v, *, causal: bool = True, q_chunk: int = 256,
                        kv_chunk: int = 512, kv_len=None):
    """Chunked-softmax attention, the port of the reference's jnp twin
    (``repro/layers/attention.py:120-179``).

    ``q (B, Sq, H, D)``, ``k``/``v`` ``(B, Skv, Hk, D)`` with GQA groups
    ``G = H // Hk``. KV chunks stream through a running (max, denominator,
    accumulator) triple in f32; padded KV positions (and, with ``kv_len``,
    positions past it) are masked. Output in ``q.dtype``.
    """
    B, Sq, H, D = q.shape
    _, Skv, Hk, _ = k.shape
    G = H // Hk
    scale = D ** -0.5
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    kv_valid = Skv if kv_len is None else kv_len
    dev = q.device
    qf = (q.float() * scale).reshape(B, Sq, Hk, G, D)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q_blk = qf[:, q0:q0 + q_chunk]
        qc = q_blk.shape[1]
        # positions of a zero-padded chunk, as the reference's
        q_pos = q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hk, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, Hk, G, q_chunk), device=dev)
        acc = torch.zeros((B, Hk, G, q_chunk, D), device=dev)
        if qc < q_chunk:
            q_blk = torch.nn.functional.pad(
                q_blk, (0, 0, 0, 0, 0, 0, 0, q_chunk - qc))
        for k0 in range(0, Skv, kv_chunk):
            k_blk = k[:, k0:k0 + kv_chunk].float()
            v_blk = v[:, k0:k0 + kv_chunk].float()
            kc = k_blk.shape[1]
            if kc < kv_chunk:
                pad = (0, 0, 0, 0, 0, kv_chunk - kc)
                k_blk = torch.nn.functional.pad(k_blk, pad)
                v_blk = torch.nn.functional.pad(v_blk, pad)
            kv_pos = k0 + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk)
            mask = (kv_pos[None, :] < kv_valid).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk)
            m = m_new
        o_blk = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o_blk.permute(0, 3, 1, 2, 4)[:, :qc])   # (B,qc,Hk,G,D)
    o = torch.cat(outs, dim=1).reshape(B, Sq, H, D)
    return o.to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_tables, start, *,
                        k_scale=None, v_scale=None,
                        dequant_dtype=torch.bfloat16, kv_start: int = 0,
                        kv_count: Optional[int] = None):
    """Paged attention as the gather path computes it:
    :func:`~repro_torch.layers.attention.gather_paged_kv` over the table
    (dequantizing an int8 pool to ``dequant_dtype``) followed by
    :func:`~repro_torch.layers.attention.full_attention` with slot ``b``'s
    ``T`` queries at positions ``start[b] .. start[b]+T-1``, causal; the
    pool's KV heads ``kv_start .. kv_start + kv_count - 1`` (default: all
    of them)."""
    from repro_torch.layers import attention   # layers import the kernels

    B, T = q.shape[:2]
    heads = slice(kv_start, None if kv_count is None
                  else kv_start + kv_count)
    pool = {"k": k_pool[:, :, heads], "v": v_pool[:, :, heads]}
    if k_scale is not None:
        pool["k_scale"] = k_scale[:, :, heads]
        pool["v_scale"] = v_scale[:, :, heads]
    k, v = attention.gather_paged_kv(pool, block_tables, dequant_dtype)
    pos_q = start.long()[:, None] + torch.arange(T, device=q.device)[None]
    return attention.full_attention(q, k, v, causal=True, positions_q=pos_q)
