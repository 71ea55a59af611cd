"""Wrappers of the hand-written Lower-part-OR CUDA kernels
(``csrc/loa_add.cu``).

Replace the TPU kernels of ``src/repro/kernels/loa_add.py``:

* ``loa_add_pallas`` → :func:`loa_add_cuda`: element-wise LOA of two int32
  tensors of any one shape;
* ``loa_reduce_pallas`` → :func:`loa_reduce_cuda`: ``(n, f) → (f,)`` int32,
  exact ``block_n``-row cluster sums folded in order through the LOA
  combine; ``n`` must be a multiple of ``block_n``. It runs on the plan
  and the workspace of :mod:`repro_torch.kernels.moa_reduce`.

``approx_bits`` is the paper's ``l`` (0 is the exact add). Each wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moa_reduce import check_reduce_operand, run_reduce

__all__ = ["loa_add_cuda", "loa_reduce_cuda", "check_approx_bits"]


def check_approx_bits(approx_bits: int) -> int:
    if not 0 <= int(approx_bits) <= 31:
        raise ValueError(f"approx_bits={approx_bits} outside [0, 31]")
    return int(approx_bits)


@functools.lru_cache(maxsize=None)
def _fn():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load_function("loa_add", "repro_loa_add",
                                [p, p, p, ll, i, p])


def loa_add_cuda(x: torch.Tensor, y: torch.Tensor, *,
                 approx_bits: int) -> torch.Tensor:
    """Element-wise LOA on the current stream; ``x`` and ``y`` int32, one
    shape, contiguous. Returns int32 of that shape."""
    _build.check_device(x, "loa_add")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"loa_add: shape/device mismatch {tuple(x.shape)}@"
                         f"{x.device} vs {tuple(y.shape)}@{y.device}")
    if x.dtype != torch.int32 or y.dtype != torch.int32:
        raise TypeError(f"loa_add: int32 operands only, got {x.dtype}, "
                        f"{y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("loa_add: operands must be contiguous")
    l = check_approx_bits(approx_bits)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), l,
                   torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(rc, "loa_add")
    loa_add_cuda.launches += 1
    return out


def loa_reduce_cuda(x: torch.Tensor, *, approx_bits: int,
                    block_n: int = 256) -> torch.Tensor:
    """Approximate serialized MOA on the current stream; same contract as
    :func:`repro_torch.kernels.ref.loa_reduce_ref` (``x`` int32)."""
    check_reduce_operand(x, "loa_reduce")
    if x.dtype != torch.int32:
        raise TypeError(f"loa_reduce: int32 operands only, got {x.dtype}")
    n, f = x.shape
    block_n = min(int(block_n), n)
    if block_n < 1 or n % block_n:
        raise ValueError(f"n={n} not a multiple of block_n={block_n}")
    l = check_approx_bits(approx_bits)
    out = torch.empty((f,), dtype=torch.int32, device=x.device)
    if f == 0:
        return out
    run_reduce("repro_loa_reduce", x, out, block_n, l)
    loa_reduce_cuda.launches += 1
    return out


loa_add_cuda.launches = 0
loa_reduce_cuda.launches = 0
