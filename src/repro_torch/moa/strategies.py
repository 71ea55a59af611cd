"""Concrete MOA strategies: tree (§2), serial (§3.1), LOA (§3.2).

The port of ``repro/moa/strategies.py``. On the ``kernel`` route the
strategies run the CUDA kernels with the reference's Pallas block caps, so
the card folds operands in the same clusters as a TPU: ``dot`` through
``dot_moa`` (``block_k = min(chunk, 2048)``), ``sum`` through
``moa_reduce`` (``block_n = min(n or chunk, 4096)``), and LOA through
``dot_moa`` with ``approx_bits`` and ``loa_reduce``.

The two LOA routes put the approximation in different places, as the
reference's two backends do: ``torch`` makes every adder of a binary tree an
LOA (:func:`repro_torch.core.loa.loa_sum`, the reference's jnp path);
``kernel`` sums ``chunk``-operand clusters exactly and folds each cluster
sum through one LOA (the reference's Pallas path). ``auto`` is ``kernel``
for CUDA tensors, so on the card ``auto`` computes what a TPU computes,
and on the CPU what the reference's jnp path computes. Both are exact at
``approx_bits=0``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, Dict, Optional

import torch

from repro_torch.core import cost_model
from repro_torch.core import loa as loa_lib
from repro_torch.device import as_dtype
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_accum
from repro_torch.moa import backends
from repro_torch.moa.base import MOAStrategy
from repro_torch.moa.registry import register_strategy

__all__ = ["TreeStrategy", "SerialStrategy", "LOAStrategy"]

# the reference's Pallas block caps (repro/moa/strategies.py:40-41): the
# kernel route keeps them so operands fold in the same clusters on both
# chips
_KERNEL_MAX_BLOCK_K = 2048
_KERNEL_MAX_BLOCK_N = 4096

#: int32 partial products the LOA tree (torch route) materializes per row
#: chunk of ``dot`` (each output row is independent, so chunking rows
#: changes nothing but the peak memory: 64 Mi products, 256 MiB)
_LOA_TREE_MAX_PARTIALS = 1 << 26


def _kernel_block(requested: int, cap: int) -> int:
    return max(min(requested, cap), 1)


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

    @classmethod
    def bench_specs(cls) -> tuple:
        return ("tree", "tree?backend=kernel")

    def sum(self, x, *, axis: int = -1) -> torch.Tensor:
        x2, restore = self._flatten_sum(x, axis)
        if self.resolve_backend(x) == "kernel":
            # the widest cluster the reference allows: one tree per cluster
            return restore(backends.kernel_sum(
                x2, block_n=_kernel_block(x2.shape[0], _KERNEL_MAX_BLOCK_N)))
        return restore(backends.tree_sum(x2, self.accum_dtype_for(x.dtype)))

    def _kernel_dot_options(self, k: int):
        return _kernel_block(k, _KERNEL_MAX_BLOCK_K), 0

    def dot(self, a, b, *, out_dtype: Optional[Any] = None) -> torch.Tensor:
        out_dtype = self._default_out_dtype(a.dtype, out_dtype)
        if self.resolve_backend(a) == "kernel":
            a2, restore = self._flatten_dot(a)
            block_k, _ = self._kernel_dot_options(a2.shape[-1])
            return restore(backends.kernel_dot(a2, b, block_k=block_k,
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

    @classmethod
    def bench_specs(cls) -> tuple:
        return ("serial?chunk=1024", "serial?chunk=256",
                "serial?backend=kernel&chunk=512")

    def __post_init__(self):
        super().__post_init__()
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")

    def sum(self, x, *, axis: int = -1) -> torch.Tensor:
        x2, restore = self._flatten_sum(x, axis)
        if self.resolve_backend(x) == "kernel":
            return restore(backends.kernel_sum(
                x2, block_n=_kernel_block(self.chunk, _KERNEL_MAX_BLOCK_N)))
        return restore(backends.serial_sum(x2, self.chunk,
                                           self.accum_dtype_for(x.dtype)))

    def _kernel_dot_options(self, k: int):
        return _kernel_block(self.chunk, _KERNEL_MAX_BLOCK_K), 0

    def dot(self, a, b, *, out_dtype: Optional[Any] = None) -> torch.Tensor:
        out_dtype = self._default_out_dtype(a.dtype, out_dtype)
        if self.resolve_backend(a) == "kernel":
            a2, restore = self._flatten_dot(a)
            block_k, _ = self._kernel_dot_options(a2.shape[-1])
            return restore(backends.kernel_dot(a2, b, block_k=block_k,
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


@register_strategy
@dataclasses.dataclass(frozen=True)
class LOAStrategy(MOAStrategy):
    """§3.2 approximate MOA: Lower-part-OR adders, integer operands only.

    ``approx_bits`` is the paper's ``l``, ``width`` the operand bit-width
    ``b``, ``chunk`` the exact cluster of the kernel route (module
    docstring: the two routes differ by where the LOAs sit).
    """

    approx_bits: int = 4
    width: int = 8
    chunk: int = 256

    name: ClassVar[str] = "loa"
    integer_only: ClassVar[bool] = True

    @classmethod
    def bench_specs(cls) -> tuple:
        return ("loa?approx_bits=0", "loa?approx_bits=4")

    def __post_init__(self):
        super().__post_init__()
        if not 0 <= self.approx_bits <= self.width:
            raise ValueError(f"approx_bits={self.approx_bits} outside "
                             f"[0, width={self.width}]")
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")

    def _fold_block(self, n: int) -> int:
        """Cluster size of the kernel route: LOA fold chains are not exact
        under zero padding, so a ragged operand count is one cluster (and
        then exact: no fold happens)."""
        return self.chunk if n % self.chunk == 0 else n

    def sum(self, x, *, axis: int = -1) -> torch.Tensor:
        self._check_operands(x.dtype)
        if self.resolve_backend(x) == "kernel":
            x2, restore = self._flatten_sum(x, axis)
            return restore(ops.loa_reduce(
                x2, approx_bits=self.approx_bits, width=self.width,
                block_n=self._fold_block(x2.shape[0])))
        return loa_lib.loa_sum(x, approx_bits=self.approx_bits,
                               width=self.width, axis=axis)

    def _kernel_dot_options(self, k: int):
        return self._fold_block(k), self.approx_bits

    def dot(self, a, b, *, out_dtype: Optional[Any] = None) -> torch.Tensor:
        self._check_operands(a.dtype)
        self._check_operands(b.dtype)
        out_dtype = self._default_out_dtype(a.dtype, out_dtype)
        a2, restore = self._flatten_dot(a)
        if self.resolve_backend(a) == "kernel":
            block_k, approx_bits = self._kernel_dot_options(a2.shape[-1])
            return restore(backends.kernel_dot(
                a2, b, block_k=block_k, approx_bits=approx_bits,
                out_dtype=out_dtype))
        # partial products (rows, K, N) reduced over K through the LOA tree
        b32 = b.to(torch.int32)
        rows = max(_LOA_TREE_MAX_PARTIALS // max(b32.numel(), 1), 1)
        out = [loa_lib.loa_sum(a2[r:r + rows, :, None].to(torch.int32) * b32,
                               approx_bits=self.approx_bits,
                               width=self.width, axis=-2)
               for r in range(0, a2.shape[0], rows)]
        y = torch.cat(out, dim=0) if out else torch.zeros(
            (0, b.shape[-1]), dtype=torch.int32, device=a.device)
        return restore(y.to(out_dtype))

    def cost(self, n_operands: int, dtype: Any = "int8") -> Dict[str, Any]:
        ops_per_add = (float(cost_model.vpu_ops_loa_add())
                       if self.approx_bits else 1.0)
        steps = max(-(-n_operands // self.chunk), 1)
        return dict(
            _cost_dict(n=n_operands, dtype=dtype, ops_per_add=ops_per_add,
                       sequential_steps=steps,
                       working_set_operands=min(self.chunk, n_operands),
                       exact=self.approx_bits == 0),
            # FPGA foil: the ALM count is flat in approx_bits (Fig. 5)
            alms=cost_model.alm_loa_adder(self.width, self.approx_bits),
            error_bound_per_add=loa_lib.loa_error_bound(self.approx_bits),
        )
