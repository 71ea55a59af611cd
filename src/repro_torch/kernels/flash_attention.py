"""Wrapper of the hand-written flash-attention CUDA kernels
(``csrc/flash_attention.cu``).

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention_pallas``: the
serialized softmax·V with an f32 ``(m, l, acc)`` carry, causal or not, KV
tiles above the diagonal skipped, final divide by ``max(l, 1e-30)``. The
port keeps the model's ``(B, S, H, D)`` layout and indexes GQA heads in the
kernel. :func:`plan` gives the body, tiles and block order the kernel takes
from the shape alone; ``flash_attention_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["Plan", "plan", "flash_attention_cuda"]

_MAX_HEAD_DIM = 128
#: bytes of one 64-row x 64-column bf16 swizzle atom (``ATOM`` in the source)
_ATOM = 64 * 128


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``body``: ``"wgmma"`` (bf16, tensor cores) or
    ``"simt"`` (f32, CUDA cores). Block ``(x, y)`` of ``grid`` owns query
    tile ``q_tiles[y]`` of head ``x % H``, batch ``x // H`` (``simt``:
    tile ``x``, head-batch ``y``), and walks ``kv_tiles[tile]`` KV tiles
    from position 0 up."""

    body: str
    block_q: int
    block_kv: int
    grid: Tuple[int, int]
    smem: int                     # dynamic shared memory of a block, bytes
    q_tiles: Tuple[int, ...]      # wgmma: the query tile of each grid.y
    kv_tiles: Tuple[int, ...]     # KV tiles walked, per query tile

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


@functools.lru_cache(maxsize=1024)
def plan(B: int, Sq: int, Skv: int, H: int, Hk: int, D: int,
         dtype: torch.dtype, causal: bool) -> Plan:
    """The kernel's choice for ``q (B, Sq, H, D)``, ``k``/``v``
    ``(B, Skv, Hk, D)`` of ``dtype``. Raises ``ValueError`` on a head_dim
    the body does not take: bf16 needs ``D % 16 == 0`` (wgmma's k16 steps),
    f32 ``D % 4 == 0``; both ``D <= 128``."""
    if dtype == torch.bfloat16:
        body, bq, bkv, step = "wgmma", 64, 64, 16
    elif dtype == torch.float32:
        body, bq, bkv, step = "simt", 32, 32, 4
    else:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    if D % step or not 0 < D <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: {str(dtype)[6:]} head_dim {D} "
                         f"must be a multiple of {step} and at most "
                         f"{_MAX_HEAD_DIM}")
    n_q = -(-Sq // bq)
    kv_all = -(-Skv // bkv)
    # causal: the tiles at or left of the diagonal (kv0 <= q0 + block_q - 1)
    kv_tiles = tuple(min(kv_all, t + 1) if causal else kv_all
                     for t in range(n_q))
    if body == "wgmma":
        # heads fastest, causal tiles longest first: the last wave is short
        q_tiles = tuple(range(n_q - 1, -1, -1) if causal else range(n_q))
        atoms = -(-D // 64)
        return Plan(body, bq, bkv, (B * H, n_q), atoms * _ATOM * 5 + 1024,
                    q_tiles, kv_tiles)
    smem = 4 * (2 * bq * (D + 1) + bkv * D + bq * (bkv + 1))
    return Plan(body, bq, bkv, (n_q, B * H), smem, tuple(range(n_q)),
                kv_tiles)


@functools.lru_cache(maxsize=None)
def _fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load_function("flash_attention", "repro_flash_attention",
                                [p, p, p, p, i, i, i, i, i, i, f, i, i, p])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """``q (B, Sq, H, D)``, ``k``/``v`` ``(B, Skv, Hk, D)`` → ``(B, Sq, H, D)``
    in ``q.dtype`` (f32 or bf16), launched on the current stream. Shapes,
    types and the head_dim are checked (:func:`plan`) before the device."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, Hk, Dk = k.shape
    if Bk != B or Dk != D or H % Hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("flash_attention: q, k, v must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    plan(B, Sq, Skv, H, Hk, D, q.dtype, bool(causal))
    _build.check_device(q, "flash_attention")
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
