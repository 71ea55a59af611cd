"""Int8 gradient compression with error feedback — the port of
``repro/optim/compression.py``: symmetric per-tensor int8 quantization
(scale ``amax / 127``, 1 for an all-zero tensor; values rounded half to
even, as ``jnp.round``, and clipped to ±127) with the quantization residue
carried to the next step, so the compressed trajectory converges to the
uncompressed fixed point.

    comp, err = compressed_gradients(grads, err)   # quantize + feedback
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.interop import tree_map

__all__ = ["compress_int8", "decompress_int8", "init_error_feedback",
           "compressed_gradients"]


def compress_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization → ``(q, scale)``."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def init_error_feedback(params):
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), params)


def compressed_gradients(grads, error_feedback):
    """Quantize each gradient tensor with error feedback → ``(dequantized
    grads, new error feedback)``: the dequantized values are what a
    compressed all-reduce would deliver; the residue ``g - deq`` feeds
    forward."""
    if isinstance(grads, Mapping):
        pairs = {k: compressed_gradients(g, error_feedback[k])
                 for k, g in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    g32 = grads.float() + error_feedback
    deq = decompress_int8(*compress_int8(g32))
    return deq.to(grads.dtype), g32 - deq
