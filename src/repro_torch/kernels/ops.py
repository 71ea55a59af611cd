"""Public entry points of the port's kernels — the counterpart of
``repro/kernels/ops.py``.

Dispatch follows the tensor, never a fallback: a CPU tensor runs the plain
PyTorch version (:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the
hand-written CUDA kernel or raises (the kernels are built for ``sm_90a``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dot_moa import dot_moa_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.loa_add import loa_add_cuda, loa_reduce_cuda
from repro_torch.kernels.moa_reduce import moa_reduce_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda

__all__ = ["dot_moa", "flash_attention", "paged_attention", "moa_reduce",
           "loa_add", "loa_reduce", "launch_counts", "reset_launch_counts",
           "add_launch_counts"]

_WRAPPERS = {"dot_moa": dot_moa_cuda, "flash_attention": flash_attention_cuda,
             "paged_attention": paged_attention_cuda,
             "moa_reduce": moa_reduce_cuda, "loa_add": loa_add_cuda,
             "loa_reduce": loa_reduce_cuda}


def _on_cpu(x: torch.Tensor, what: str, *operands) -> bool:
    """Whether ``x`` takes the plain version (a CPU tensor); a CUDA tensor
    takes the kernel, which has no backward: where autograd would record
    the call on ``x`` or ``operands``, raise rather than return an output
    that drops the gradient (the autograd paths wrap the kernels in their
    own ``autograd.Function``, inside which nothing is recorded)."""
    if x.device.type == "cpu":
        return True
    if not x.is_cuda:
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x,) + operands):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input "
            "requires grad; call it under torch.no_grad() or through the "
            "MOA backends' autograd path (the causal forward attends "
            "through the plain versions)")
    return False


def dot_moa(a, b, *, block_k: int = 512, approx_bits: int = 0,
            out_dtype: Optional[torch.dtype] = None):
    """K-blocked matmul with serialized-MOA contraction ``(m,k)@(k,n)``,
    or, for 3-D operands, ``(E,m,k)@(E,k,n)`` member by member (one launch
    on the card)."""
    if _on_cpu(a, "dot_moa", b):
        fn = ref.dot_moa_batched_ref if a.dim() == 3 else ref.dot_moa_ref
        return fn(a, b, block_k=block_k, approx_bits=approx_bits,
                  out_dtype=out_dtype)
    return dot_moa_cuda(a, b, block_k=block_k, approx_bits=approx_bits,
                        out_dtype=out_dtype)


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 256,
                    kv_chunk: int = 512):
    """Flash-attention forward, ``q (B, Sq, H, D)``, ``k``/``v``
    ``(B, Skv, Hk, D)``. ``q_chunk``/``kv_chunk`` are the plain version's
    chunk sizes (they shape only its float reassociation); the kernel's
    tiles are fixed in its source."""
    if _on_cpu(q, "flash_attention", k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
    return flash_attention_cuda(q, k, v, causal=causal)


def paged_attention(q, k_pool, v_pool, block_tables, start, *, k_scale=None,
                    v_scale=None, dequant_dtype=torch.bfloat16):
    """Paged flash attention ``(B, T, H, D)`` over a block-table KV pool
    (int8 pools dequantized through ``dequant_dtype``)."""
    if _on_cpu(q, "paged_attention", k_pool, v_pool, k_scale, v_scale):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, start,
                                       k_scale=k_scale, v_scale=v_scale,
                                       dequant_dtype=dequant_dtype)
    return paged_attention_cuda(q, k_pool, v_pool, block_tables, start,
                                k_scale=k_scale, v_scale=v_scale,
                                dequant_dtype=dequant_dtype)


def moa_reduce(x, *, block_n: int = 512):
    """Blocked MOA reduction ``(n, f) → (f,)``: f32 accumulation for float
    operands, int32 for integer ones."""
    if _on_cpu(x, "moa_reduce"):
        return ref.moa_reduce_ref(x, block_n=block_n)
    return moa_reduce_cuda(x.contiguous(), block_n=block_n)


def loa_add(x, y, *, approx_bits: int, width: int = 8):
    """Element-wise LOA addition on int32 containers (``width`` is carried
    by the operand values, as in the reference)."""
    del width
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if _on_cpu(x, "loa_add"):
        return ref.loa_add_ref(x, y, approx_bits=approx_bits)
    return loa_add_cuda(x.to(torch.int32).contiguous(),
                        y.to(torch.int32).contiguous(),
                        approx_bits=approx_bits)


def loa_reduce(x, *, approx_bits: int, width: int = 8, block_n: int = 256):
    """Approximate serialized MOA ``(n, f) → (f,)`` int32; ``n`` must be a
    multiple of ``block_n``."""
    del width
    if _on_cpu(x, "loa_reduce"):
        return ref.loa_reduce_ref(x, approx_bits=approx_bits, block_n=block_n)
    return loa_reduce_cuda(x.to(torch.int32).contiguous(),
                           approx_bits=approx_bits, block_n=block_n)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (``{wrapper name: launches}``) to the wrappers' counts.
    A CUDA graph's replay launches its kernels without calling the
    wrappers, so it adds here the launches its capture recorded."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n
