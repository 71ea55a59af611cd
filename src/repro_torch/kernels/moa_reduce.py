"""Wrapper of the hand-written ``moa_reduce`` CUDA kernel
(``csrc/moa_reduce.cu``).

Replaces the TPU kernel ``src/repro/kernels/moa_reduce.py:moa_reduce_pallas``:
``(n, f) → (f,)``, each ``block_n``-row cluster tree-summed and the cluster
sums folded in order into an f32 (float operands) or int32 (integer
operands, wrapping) accumulator. ``moa_reduce_cuda.launches`` counts
launches (one per call: the kernel's two passes are one launch of this
wrapper).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import is_integer
from repro_torch.kernels import _build

__all__ = ["moa_reduce_cuda", "SEG_ROWS", "scratch_rows"]

#: rows per segment of the first pass (``kSegRows`` in
#: ``csrc/cluster_reduce.cuh``; the two must agree)
SEG_ROWS = 64

_SUPPORTED = (torch.float32, torch.bfloat16, torch.int8, torch.int32)


def scratch_rows(n: int, block_n: int) -> int:
    """Rows of segment sums the two-pass reduction keeps between passes."""
    return -(-n // block_n) * -(-block_n // SEG_ROWS)


def check_reduce_operand(x: torch.Tensor, what: str) -> None:
    _build.check_device(x, what)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (n, f), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the operand must be contiguous")


@functools.lru_cache(maxsize=None)
def _fn():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load_function("moa_reduce", "repro_moa_reduce",
                                [p, p, p, ll, i, i, i, p])


def moa_reduce_cuda(x: torch.Tensor, *, block_n: int = 512) -> torch.Tensor:
    """Launch the kernel on ``torch.cuda.current_stream()``; same contract
    as :func:`repro_torch.kernels.ref.moa_reduce_ref`."""
    check_reduce_operand(x, "moa_reduce")
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"moa_reduce: no kernel for {x.dtype}")
    n, f = x.shape
    accum = torch.int32 if is_integer(x.dtype) else torch.float32
    if n == 0 or f == 0:
        return torch.zeros((f,), dtype=accum, device=x.device)
    block_n = min(int(block_n), n)
    if block_n < 1:
        raise ValueError("moa_reduce: block_n must be >= 1")
    out = torch.empty((f,), dtype=accum, device=x.device)
    scratch = torch.empty((scratch_rows(n, block_n), f), dtype=accum,
                          device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, f,
                   block_n, _build.DTYPE_CODES[x.dtype],
                   torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(rc, "moa_reduce")
    moa_reduce_cuda.launches += 1
    return out


moa_reduce_cuda.launches = 0
