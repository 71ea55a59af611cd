"""Concrete MOA strategies: tree (§2) and serial (§3.1).

The port of ``repro/moa/strategies.py`` for the served path; ``loa``
comes with the paper path (ROADMAP Queue 1, item 11). On the ``kernel``
route ``dot`` runs the ``dot_moa`` CUDA kernel with the reference's Pallas
block caps, so the card folds K exactly as a TPU does
(``block_k = min(chunk, 2048)``); ``sum`` on that route needs the
``moa_reduce`` kernel, which is still to be ported (ROADMAP Queue 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, Dict, Optional

import torch

from repro_torch.device import as_dtype
from repro_torch.kernels.ref import matmul_accum
from repro_torch.moa import backends
from repro_torch.moa.base import MOAStrategy
from repro_torch.moa.registry import register_strategy

__all__ = ["TreeStrategy", "SerialStrategy"]

# the reference's Pallas block cap on K (repro/moa/strategies.py:40): the
# kernel route keeps it so K folds in the same clusters on both chips
_KERNEL_MAX_BLOCK_K = 2048


def _kernel_block(requested: int, cap: int) -> int:
    return max(min(requested, cap), 1)


def _no_sum_kernel():
    return NotImplementedError(
        "strategy.sum on the kernel route needs the moa_reduce kernel "
        "(ROADMAP Queue 2, item 4); pass backend='torch'")


def _cost_dict(*, n: int, dtype, ops_per_add: float, sequential_steps: int,
               working_set_operands: int, exact: bool) -> Dict[str, Any]:
    adds = max(n - 1, 0)
    itemsize = as_dtype(dtype).itemsize
    return {
        "flops": n + adds * ops_per_add,       # per output: mults + adds
        "hbm_bytes": n * itemsize,             # operands streamed once
        "adds": adds,
        "ops_per_add": ops_per_add,
        "sequential_steps": sequential_steps,
        "working_set_operands": working_set_operands,
        "exact": exact,
    }


@register_strategy
@dataclasses.dataclass(frozen=True)
class TreeStrategy(MOAStrategy):
    """Spatial binary adder tree — the one-shot reduction (§2)."""

    accum: str = "float32"

    name: ClassVar[str] = "tree"

    def sum(self, x, *, axis: int = -1) -> torch.Tensor:
        if self.resolve_backend(x) == "kernel":
            raise _no_sum_kernel()
        x2, restore = self._flatten_sum(x, axis)
        return restore(backends.tree_sum(x2, self.accum_dtype_for(x.dtype)))

    def dot(self, a, b, *, out_dtype: Optional[Any] = None) -> torch.Tensor:
        out_dtype = self._default_out_dtype(a.dtype, out_dtype)
        if self.resolve_backend(a) == "kernel":
            a2, restore = self._flatten_dot(a)
            return restore(backends.kernel_dot(
                a2, b, block_k=_kernel_block(a2.shape[-1], _KERNEL_MAX_BLOCK_K),
                out_dtype=out_dtype))
        accum = self.accum_dtype_for(a.dtype)
        return matmul_accum(a, b, accum).to(out_dtype)

    def cost(self, n_operands: int, dtype: Any = "bfloat16") -> Dict[str, Any]:
        return dict(
            _cost_dict(n=n_operands, dtype=dtype, ops_per_add=1.0,
                       sequential_steps=1, working_set_operands=n_operands,
                       exact=True),
            depth=max(math.ceil(math.log2(max(n_operands, 1))), 1),
        )


@register_strategy
@dataclasses.dataclass(frozen=True)
class SerialStrategy(MOAStrategy):
    """§3.1 serialized MOA: clusters of ``chunk`` operands fold into one
    accumulator; ``chunk`` plays the paper's ``n_c``."""

    chunk: int = 512
    accum: str = "float32"

    name: ClassVar[str] = "serial"

    def __post_init__(self):
        super().__post_init__()
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")

    def sum(self, x, *, axis: int = -1) -> torch.Tensor:
        if self.resolve_backend(x) == "kernel":
            raise _no_sum_kernel()
        x2, restore = self._flatten_sum(x, axis)
        return restore(backends.serial_sum(x2, self.chunk,
                                           self.accum_dtype_for(x.dtype)))

    def dot(self, a, b, *, out_dtype: Optional[Any] = None) -> torch.Tensor:
        out_dtype = self._default_out_dtype(a.dtype, out_dtype)
        if self.resolve_backend(a) == "kernel":
            a2, restore = self._flatten_dot(a)
            return restore(backends.kernel_dot(
                a2, b, block_k=_kernel_block(self.chunk, _KERNEL_MAX_BLOCK_K),
                out_dtype=out_dtype))
        accum = self.accum_dtype_for(a.dtype)
        if a.shape[-1] <= self.chunk:
            return matmul_accum(a, b, accum).to(out_dtype)
        return backends.chunked_matmul(a, b, chunk=self.chunk,
                                       accum_dtype=accum, out_dtype=out_dtype)

    def cost(self, n_operands: int, dtype: Any = "bfloat16") -> Dict[str, Any]:
        steps = max(-(-n_operands // self.chunk), 1)
        return _cost_dict(
            n=n_operands, dtype=dtype, ops_per_add=1.0,
            sequential_steps=steps,
            working_set_operands=min(self.chunk, n_operands), exact=True)
