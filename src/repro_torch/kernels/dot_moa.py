"""Wrapper of the hand-written ``dot_moa`` CUDA kernel (``csrc/dot_moa.cu``).

Replaces the TPU kernel ``src/repro/kernels/dot_moa.py:dot_moa_pallas``:
``(m, k) @ (k, n)`` with the K axis folded ``block_k`` operands at a time
into an f32 (floats) or int32 (ints) accumulator, by ``+`` or by the LOA
combine (``approx_bits > 0``). ``dot_moa_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.device import as_dtype, is_integer
from repro_torch.kernels import _build

__all__ = ["dot_moa_cuda"]

# (operand dtype, output dtype) pairs the kernel is instantiated for
_SUPPORTED = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.int8, torch.int32), (torch.int32, torch.int32)}


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load_function("dot_moa", "repro_dot_moa",
                                [p, p, p, i, i, i, i, i, i, i, p])


def dot_moa_cuda(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
                 approx_bits: int = 0,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel on ``torch.cuda.current_stream()``; same contract
    as :func:`repro_torch.kernels.ref.dot_moa_ref`."""
    _build.check_device(a, "dot_moa")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dot_moa: contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError("dot_moa: operands must share device and dtype, got "
                         f"{a.dtype}@{a.device} and {b.dtype}@{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("dot_moa: operands must be contiguous")
    (m, k), n = a.shape, b.shape[1]
    is_int = is_integer(a.dtype)
    if approx_bits and not is_int:
        raise TypeError("LOA accumulation requires integer operands")
    block_k = min(int(block_k), k)
    if block_k < 1:
        raise ValueError("dot_moa: block_k must be >= 1")
    if approx_bits and k % block_k:
        raise ValueError(f"k={k} must be a multiple of block_k={block_k} "
                         "for LOA")
    out_dtype = as_dtype(out_dtype) if out_dtype is not None \
        else (torch.int32 if is_int else a.dtype)
    if (a.dtype, out_dtype) not in _SUPPORTED:
        raise TypeError(f"dot_moa: no kernel for {a.dtype} -> {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                   block_k, int(approx_bits), _build.DTYPE_CODES[a.dtype],
                   _build.DTYPE_CODES[out_dtype],
                   torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(rc, "dot_moa")
    dot_moa_cuda.launches += 1
    return out


dot_moa_cuda.launches = 0
