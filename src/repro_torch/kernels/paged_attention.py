"""Wrapper of the hand-written paged-attention CUDA kernel
(``csrc/paged_attention.cu``).

Replaces the TPU kernel
``src/repro/kernels/paged_attention.py:paged_attention_pallas`` (and its
``paged_flash_decode`` / ``paged_flash_prefill`` instances): for each slot,
``T`` queries at ``start[b] .. start[b]+T-1`` attend causally over the pages
named by ``block_tables[b]``, with int8 pools dequantized in registers
through ``dequant_dtype``. ``paged_attention_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["paged_attention_cuda"]

_MAX_SMEM = 227 * 1024       # dynamic shared memory a block may use on sm_90


@functools.lru_cache(maxsize=None)
def _fns():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    run = _build.load_function(
        "paged_attention", "repro_paged_attention",
        [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, i, p])
    smem = _build.load_function("paged_attention",
                                "repro_paged_attention_smem", [i] * 5)
    smem.restype = ctypes.c_longlong
    return run, smem


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         start: torch.Tensor, *,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         dequant_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """``q (B, T, H, D)``; pools ``(n_phys, bs, Hk, D)`` (f32/bf16/int8);
    scales ``(n_phys, bs, Hk)`` f32 for an int8 pool; tables
    ``(B, n_blocks)`` int32; ``start (B,)`` int32 → ``(B, T, H, D)``."""
    _build.check_device(q, "paged_attention")
    B, T, H, D = q.shape
    n_phys, bs, Hk, Dp = k_pool.shape
    if v_pool.shape != k_pool.shape or Dp != D or H % Hk:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not match "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(start.shape) != (B,):
        raise ValueError("paged_attention: tables must be (B, n_blocks) and "
                         f"start (B,), got {tuple(block_tables.shape)} and "
                         f"{tuple(start.shape)}")
    if block_tables.dtype != torch.int32 or start.dtype != torch.int32:
        raise TypeError("paged_attention: tables and start must be int32")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_pool.dtype not in (
            torch.float32, torch.bfloat16, torch.int8) \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: no kernel for q {q.dtype}, pools "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("paged_attention: an int8 pool needs k_scale and "
                         "v_scale, and only an int8 pool takes them")
    if quantized and (k_scale.shape != k_pool.shape[:3]
                      or v_scale.shape != k_pool.shape[:3]
                      or k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError("paged_attention: scales must be f32 "
                         f"{tuple(k_pool.shape[:3])}")
    if dequant_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention: dequant_dtype {dequant_dtype} "
                        "must be float32 or bfloat16")
    tensors = [q, k_pool, v_pool, block_tables, start] + (
        [k_scale, v_scale] if quantized else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    run, smem = _fns()
    need = smem(T, H, Hk, D, bs)
    if need > _MAX_SMEM:
        raise ValueError(f"paged_attention: T={T}, G={H // Hk}, D={D}, "
                         f"bs={bs} needs {need} B of shared memory per block "
                         f"(at most {_MAX_SMEM})")
    out = torch.empty_like(q)
    n_blocks = block_tables.shape[1]
    if B == 0 or n_blocks == 0:
        return out
    codes = _build.DTYPE_CODES
    with torch.cuda.device(q.device):
        rc = run(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
                 B, T, H, Hk, D, bs, n_blocks, float(D ** -0.5),
                 codes[q.dtype], codes[k_pool.dtype], codes[dequant_dtype],
                 torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(rc, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
