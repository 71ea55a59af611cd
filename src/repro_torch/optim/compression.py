"""Int8 gradient compression with error feedback — the port of
``repro/optim/compression.py``: symmetric per-tensor int8 quantization
(scale ``amax / 127``, 1 for an all-zero tensor; values rounded half to
even, as ``jnp.round``, and clipped to ±127) with the quantization residue
carried to the next step, so the compressed trajectory converges to the
uncompressed fixed point.

    comp, err = compressed_gradients(grads, err)   # quantize + feedback

On a mesh each leaf is this rank's shard of the global (summed) gradient:
its ``amax`` is the whole leaf's, the maximum over the ranks' shards
(:func:`repro_torch.parallel.collectives.axis_max`), so the int8 values
equal one device's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.interop import tree_leaves, tree_map, tree_map_with_keys
from repro_torch.parallel.collectives import axis_max

__all__ = ["compress_int8", "decompress_int8", "init_error_feedback",
           "compressed_gradients"]


def compress_int8(x, amax=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization → ``(q, scale)``; ``amax``:
    the whole tensor's ``max |x|`` where ``x`` is a shard of it."""
    x32 = x.float()
    if amax is None:
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
    forward. On a mesh (inside its context) each leaf's scale is the whole
    leaf's, from one gather of every leaf's ``amax`` a mesh axis (the
    maximum over identical replicas is their value)."""
    err = dict(tree_leaves(error_feedback))
    g32 = {path: g.float() + err[path] for path, g in tree_leaves(grads)}
    amax = torch.stack([torch.max(torch.abs(x)) for x in g32.values()])
    amax = axis_max(axis_max(amax, "data"), "model")
    deq = {path: decompress_int8(*compress_int8(x, a))
           for (path, x), a in zip(g32.items(), amax.unbind(0))}
    return (tree_map_with_keys(
                lambda keys, g: deq[".".join(keys)].to(g.dtype), grads),
            tree_map_with_keys(
                lambda keys, g: g32[".".join(keys)] - deq[".".join(keys)],
                grads))
