"""Wrapper of the hand-written flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention_pallas``: the
serialized softmax·V with an f32 ``(m, l, acc)`` carry, causal or not, KV
tiles above the diagonal skipped, final divide by ``max(l, 1e-30)``. The
port keeps the model's ``(B, S, H, D)`` layout and indexes GQA heads in the
kernel. ``flash_attention_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_cuda"]

_MAX_HEAD_DIM = 128


@functools.lru_cache(maxsize=None)
def _fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load_function("flash_attention", "repro_flash_attention",
                                [p, p, p, p, i, i, i, i, i, i, f, i, i, p])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """``q (B, Sq, H, D)``, ``k``/``v`` ``(B, Skv, Hk, D)`` → ``(B, Sq, H, D)``
    in ``q.dtype`` (f32 or bf16), launched on the current stream."""
    _build.check_device(q, "flash_attention")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, Hk, Dk = k.shape
    if Bk != B or Dk != D or H % Hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if D % 4 or D > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} must be a multiple "
                         f"of 4 and at most {_MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("flash_attention: q, k, v must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must share a device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Sq, Skv, H, Hk, D, float(D ** -0.5), int(causal),
                   _build.DTYPE_CODES[q.dtype],
                   torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(rc, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
