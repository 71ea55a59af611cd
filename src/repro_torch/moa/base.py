"""Abstract MOA strategy — the port of ``repro/moa/base.py``.

A strategy knows how to ``sum`` operands over an axis, how to ``dot`` two
matrices (scheduling the contraction dimension), and how to ``cost`` itself
analytically. Every strategy is a frozen dataclass with a canonical spec
string (``"serial?chunk=512"``) parsed back by :func:`repro_torch.moa.resolve`.

``backend`` selects the substrate per call:

* ``"torch"`` — the plain PyTorch schedules of :mod:`repro_torch.moa.backends`
  on any device (the reference; on the GPU the only way to run it);
* ``"kernel"`` — the hand-written CUDA kernels of :mod:`repro_torch.kernels`;
  a CPU tensor raises;
* ``"auto"`` — the kernel for a CUDA tensor (or a ``meta`` one, the
  card's stand-in in the dry run), the plain schedule for a CPU tensor.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar, Dict, Optional

import torch

from repro_torch.device import as_dtype, is_integer
from repro_torch.kernels import ops

__all__ = ["MOAStrategy", "BACKENDS", "resolved_backend"]

BACKENDS = ("auto", "torch", "kernel")


def resolved_backend(backend: str, x: torch.Tensor) -> str:
    """``"kernel"`` or ``"torch"`` for an operand on ``x.device``."""
    if backend == "auto":
        return "kernel" if ops.on_card(x) else "torch"
    if backend == "kernel" and not ops.on_card(x) \
            and not ops.interpreting():
        raise ValueError(
            "backend='kernel' needs CUDA tensors; a CPU tensor takes "
            "backend='auto' or 'torch'")
    return backend


@dataclasses.dataclass(frozen=True)
class MOAStrategy(abc.ABC):
    """How a large-fan-in reduction is scheduled, and on what substrate."""

    backend: str = "auto"

    #: registry key; set by each concrete subclass
    name: ClassVar[str] = ""
    #: True for strategies whose arithmetic is defined on integers only
    integer_only: ClassVar[bool] = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}")

    # ---- spec-string round trip -------------------------------------------
    @property
    def spec(self) -> str:
        """Canonical spec string: ``name`` + sorted non-default params."""
        params = sorted(
            f"{f.name}={getattr(self, f.name)}"
            for f in dataclasses.fields(self)
            if getattr(self, f.name) != f.default
        )
        return self.name + ("?" + "&".join(params) if params else "")

    def __str__(self) -> str:
        return self.spec

    # ---- backend / dtype plumbing -----------------------------------------
    def resolve_backend(self, x: torch.Tensor) -> str:
        return resolved_backend(self.backend, x)

    def accum_dtype_for(self, operand_dtype) -> torch.dtype:
        """Accumulator dtype: int32 for integer operands, else ``accum``."""
        if is_integer(as_dtype(operand_dtype)):
            return torch.int32
        return as_dtype(getattr(self, "accum", "float32"))

    def _check_operands(self, dtype) -> None:
        if self.integer_only and not is_integer(as_dtype(dtype)):
            raise TypeError(f"{self.name!r} strategy requires integer "
                            f"operands, got {dtype}")

    @classmethod
    def bench_specs(cls) -> tuple:
        """Representative spec strings for the registry-driven sweep
        (``repro_torch.paper.moa_strategies``). Default: the bare name."""
        return (cls.name,)

    # ---- the strategy interface -------------------------------------------
    @abc.abstractmethod
    def sum(self, x, *, axis: int = -1) -> torch.Tensor:
        """Reduce ``x`` over ``axis``; returns the accumulator dtype."""

    @abc.abstractmethod
    def dot(self, a, b, *, out_dtype: Optional[Any] = None) -> torch.Tensor:
        """``a @ b`` with the K contraction scheduled per this strategy.

        ``a: (..., M, K)``, ``b: (K, N)``; ``out_dtype`` defaults to
        ``a.dtype`` for floats and int32 for integer operands.
        """

    def batched_dot(self, a, b, *, out_dtype: Optional[Any] = None
                    ) -> torch.Tensor:
        """``jax.vmap(self.dot, in_axes=(1, 0), out_axes=1)``: ``a (G, E,
        ..., K)`` against one ``b (E, K, N)`` per member of axis 1 ->
        ``(G, E, ..., N)`` (the MoE's expert contractions).

        The ``torch`` route runs :meth:`dot` on each member, so each is
        held to the unbatched plain schedule; the ``kernel`` route is one
        batched ``dot_moa`` launch whose members each run as the
        unbatched kernel call runs (:meth:`_kernel_dot_options`)."""
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"batched dot: {a.shape[1]} members against "
                             f"{b.shape[0]} weights")
        members = torch.movedim(a, 1, 0)                # (E, G, ..., K)
        if self.resolve_backend(a) != "kernel":
            return torch.stack([self.dot(x, w, out_dtype=out_dtype)
                                for x, w in zip(members, b)], dim=1)
        from repro_torch.moa import backends

        self._check_operands(a.dtype)
        self._check_operands(b.dtype)
        out_dtype = self._default_out_dtype(a.dtype, out_dtype)
        E, K = b.shape[0], b.shape[1]
        a3 = members.reshape(E, -1, K)
        block_k, approx_bits = self._kernel_dot_options(K)
        y = backends.kernel_dot(a3, b, block_k=block_k,
                                approx_bits=approx_bits, out_dtype=out_dtype)
        return torch.movedim(y.reshape(tuple(members.shape[:-1])
                                       + (b.shape[-1],)), 0, 1)

    def _kernel_dot_options(self, k: int):
        """``(block_k, approx_bits)`` of this strategy's ``dot_moa`` launch
        for a ``k``-deep contraction on the kernel route."""
        raise NotImplementedError(
            f"{self.name!r} has no kernel route for dot")

    @abc.abstractmethod
    def cost(self, n_operands: int, dtype: Any = "bfloat16") -> Dict[str, Any]:
        """Analytic cost of one ``n_operands``-wide reduction (the keys of
        the reference's ``MOAStrategy.cost``)."""

    # ---- shared shape plumbing --------------------------------------------
    @staticmethod
    def _flatten_dot(a: torch.Tensor):
        """``(..., M, K) -> (rows, K)`` + a restorer for the output."""
        lead = a.shape[:-1]
        a2 = a.reshape(-1, a.shape[-1])
        return a2, (lambda y: y.reshape(tuple(lead) + (y.shape[-1],)))

    @staticmethod
    def _flatten_sum(x: torch.Tensor, axis: int):
        """``x`` with ``axis`` moved to front and trailing dims flattened to
        ``(n, f)``; returns the 2-D view + a restorer for the output."""
        x = torch.movedim(x, axis, 0)
        rest = tuple(x.shape[1:])
        x2 = x.reshape(x.shape[0], -1)
        return x2, (lambda y: y.reshape(rest))

    @staticmethod
    def _default_out_dtype(a_dtype, out_dtype) -> torch.dtype:
        if out_dtype is not None:
            return as_dtype(out_dtype)
        if is_integer(a_dtype):
            return torch.int32
        return a_dtype
