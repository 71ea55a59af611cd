"""Backend execution paths for MOA strategies: plain PyTorch and kernel.

* **torch** — the plain schedules of the reference's jnp path (explicit
  binary tree, serialized cluster sums, K-chunked matmul), on any device.
  They are the numerical oracles and the path the CPU tests compare.
* **kernel** — :func:`kernel_dot`, the ``dot_moa`` CUDA kernel behind a
  ``torch.autograd.Function`` whose backward is the plain f32 matmul
  transpose rule of ``repro/moa/backends.py:138-145``; :func:`kernel_sum`,
  the ``moa_reduce`` CUDA kernel behind one whose backward broadcasts the
  cotangent (``repro/moa/backends.py:165-188``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import is_integer
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_accum
from repro_torch.layers.numerics import accum_upcast

__all__ = ["tree_sum", "serial_sum", "chunked_matmul", "kernel_dot",
           "kernel_sum"]


# ---------------------------------------------------------------------------
# plain reference schedules
# ---------------------------------------------------------------------------


def tree_sum(x: torch.Tensor, accum_dtype) -> torch.Tensor:
    """Explicit balanced binary adder tree over axis 0 (odd leftovers pass
    through), fixing the float reassociation order to the tree's."""
    x = accum_upcast(x, accum_dtype)
    while x.shape[0] > 1:
        m = x.shape[0]
        half = m // 2
        paired = x[: 2 * half: 2] + x[1: 2 * half: 2]
        if m % 2:
            paired = torch.cat([paired, x[2 * half:]], dim=0)
        x = paired
    return x[0]


def serial_sum(x: torch.Tensor, chunk: int, accum_dtype) -> torch.Tensor:
    """§3.1 serialized MOA: clusters of ``chunk`` operands folded into one
    ``accum_dtype`` accumulator (ragged tail zero-padded, exact for +)."""
    n = x.shape[0]
    chunk = min(chunk, n)
    acc = torch.zeros(x.shape[1:], dtype=accum_dtype, device=x.device)
    for start in range(0, n, chunk):
        acc = acc + torch.sum(accum_upcast(x[start:start + chunk],
                                           accum_dtype), dim=0,
                              dtype=accum_dtype)
    return acc


def chunked_matmul(a: torch.Tensor, b: torch.Tensor, *, chunk: int,
                   accum_dtype=torch.float32,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K-blocked matmul ``a (..., M, K) @ b (K, N)``: the contraction runs
    ``chunk`` operands at a time into one accumulator — the reference's
    ``lax.scan`` over K chunks (a ragged last chunk equals a zero-padded
    one, since padding adds exact zeros)."""
    k = a.shape[-1]
    if b.shape[0] != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    chunk = min(chunk, k)
    acc = torch.zeros(tuple(a.shape[:-1]) + (b.shape[-1],),
                      dtype=accum_dtype, device=a.device)
    for start in range(0, k, chunk):
        acc = acc + matmul_accum(a[..., start:start + chunk],
                                 b[start:start + chunk], accum_dtype)
    return acc.to(out_dtype)


# ---------------------------------------------------------------------------
# kernel path
# ---------------------------------------------------------------------------


class _KernelDot(torch.autograd.Function):
    """Forward: the ``dot_moa`` kernel. Backward: the plain f32 transpose
    rule (the kernel's contraction is exact up to reassociation)."""

    @staticmethod
    def forward(ctx, a, b, block_k, approx_bits, out_dtype):
        ctx.save_for_backward(a, b)
        return ops.dot_moa(a, b, block_k=block_k, approx_bits=approx_bits,
                           out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        # batched (3-D) operands: the same rule member by member
        a, b = ctx.saved_tensors
        gf = g.float()
        da = torch.matmul(gf, b.float().transpose(-1, -2)).to(a.dtype)
        db = torch.matmul(a.float().transpose(-1, -2), gf).to(b.dtype)
        return da, db, None, None, None


def kernel_dot(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
               out_dtype: torch.dtype, approx_bits: int = 0) -> torch.Tensor:
    """``(m, k) @ (k, n)``, or ``(E, m, k) @ (E, k, n)`` in one batched
    launch, through the ``dot_moa`` kernel; ``block_k`` is the
    serialization cluster size ``n_c``. Float paths are differentiable (the
    ``autograd.Function`` is entered only where a gradient is wanted);
    integer paths are forward-only."""
    a, b = a.contiguous(), b.contiguous()
    if is_integer(a.dtype) or not (torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad)):
        return ops.dot_moa(a, b, block_k=int(block_k),
                           approx_bits=int(approx_bits), out_dtype=out_dtype)
    return _KernelDot.apply(a, b, int(block_k), int(approx_bits), out_dtype)


class _KernelSum(torch.autograd.Function):
    """Forward: the ``moa_reduce`` kernel. Backward: every operand's
    cotangent is the output's, broadcast and cast to the operand dtype."""

    @staticmethod
    def forward(ctx, x, block_n):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return ops.moa_reduce(x, block_n=block_n)

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape).to(ctx.dtype), None


def kernel_sum(x: torch.Tensor, *, block_n: int) -> torch.Tensor:
    """``(n, f) → (f,)`` through the ``moa_reduce`` kernel; ``block_n`` is
    the cluster size ``n_c``. Accumulates in f32 (floats) or int32 (ints);
    float paths are differentiable, integer paths forward-only."""
    x = x.contiguous()
    if is_integer(x.dtype):
        return ops.moa_reduce(x, block_n=int(block_n))
    return _KernelSum.apply(x, int(block_n))
