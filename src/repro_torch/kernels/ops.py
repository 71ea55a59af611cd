"""Public entry points of the port's kernels — the counterpart of
``repro/kernels/ops.py``.

Dispatch follows the tensor, never a fallback: a CPU tensor runs the plain
PyTorch version (:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the
hand-written CUDA kernel or raises (the kernels are built for ``sm_90a``).

A :class:`KernelRecorder`, off by default (:func:`recording`), prices each
entry point's calls by the kernel's contract: ``dot_moa`` ``2·m·k·n`` (times
E batched), ``flash_attention`` the full ``Sq × Skv`` rectangle (``4·B·Sq·
Skv·H·D``: masked blocks are computed, as the cost model counts them),
``paged_attention`` the whole block table's width (``4·B·T·n_blocks·bs·H·
D``), the reductions and ``loa_add`` none (no product); and each call's
operand bytes. A kernel is opaque to a trace of aten ops on the card, so
while a recorded call runs its plain version's own aten ops are marked
(``inside``) and a CPU trace counts what a card trace counts. Off, it
costs one global read a call.

A ``meta`` tensor stands for one on the card (the dry run,
:mod:`repro_torch.launch.dryrun`): an entry point given one is recorded
and priced as on the card, and returns an empty ``meta`` output of the
kernel's shape and dtype, running neither the kernel nor its plain
version.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.device import as_dtype, is_integer
from repro_torch.kernels import ref
from repro_torch.kernels.dot_moa import dot_moa_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.loa_add import loa_add_cuda, loa_reduce_cuda
from repro_torch.kernels.moa_reduce import moa_reduce_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda

__all__ = ["dot_moa", "flash_attention", "paged_attention", "moa_reduce",
           "loa_add", "loa_reduce", "launch_counts", "reset_launch_counts",
           "add_launch_counts", "KernelRecorder", "recording", "interpret",
           "interpreting", "on_card"]

_WRAPPERS = {"dot_moa": dot_moa_cuda, "flash_attention": flash_attention_cuda,
             "paged_attention": paged_attention_cuda,
             "moa_reduce": moa_reduce_cuda, "loa_add": loa_add_cuda,
             "loa_reduce": loa_reduce_cuda}


#: while set, the kernel routes resolve on CPU tensors too (:func:`interpret`)
_INTERPRET = False


@contextlib.contextmanager
def interpret():
    """The port's interpret mode, for audits and tests on the CPU: while
    the block runs, ``attn_backend="kernel"`` and an MOA strategy's
    ``backend="kernel"`` take CPU tensors too, and so reach these entry
    points, which run the kernels' plain versions there (as a Pallas
    kernel runs in interpret mode on the CPU)."""
    global _INTERPRET
    saved, _INTERPRET = _INTERPRET, True
    try:
        yield
    finally:
        _INTERPRET = saved


def interpreting() -> bool:
    """Whether :func:`interpret` is active."""
    return _INTERPRET


class KernelRecorder:
    """What the kernel entry points were asked for while installed:
    ``calls`` and ``flops`` per entry point, ``stream_bytes`` (every
    call's operand bytes), and ``inside`` (> 0 while a recorded call
    runs, so a trace of aten ops can leave its interior out)."""

    def __init__(self):
        self.calls = {name: 0 for name in _WRAPPERS}
        self.flops = {name: 0.0 for name in _WRAPPERS}
        self.stream_bytes = 0.0
        self.inside = 0

    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


#: the installed recorder (``None``: off)
_RECORDER: Optional[KernelRecorder] = None


@contextlib.contextmanager
def recording(recorder: Optional[KernelRecorder] = None):
    """Install ``recorder`` (a new one by default) while the block runs
    and yield it."""
    global _RECORDER
    rec = recorder if recorder is not None else KernelRecorder()
    saved, _RECORDER = _RECORDER, rec
    try:
        yield rec
    finally:
        _RECORDER = saved


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors
                     if t is not None))


def _recorded(name: str, flops: float, operands, fn, *args, **kwargs):
    """Record one call of entry point ``name``, then run it with the
    recorder lifted (its plain version's aten ops marked ``inside``)."""
    global _RECORDER
    rec = _RECORDER
    rec.calls[name] += 1
    rec.flops[name] += float(flops)
    rec.stream_bytes += _nbytes(*operands)
    _RECORDER = None
    rec.inside += 1
    try:
        return fn(*args, **kwargs)
    finally:
        rec.inside -= 1
        _RECORDER = rec


def _route(x: torch.Tensor, what: str, *operands) -> str:
    """``"cpu"`` (the plain version), ``"meta"`` (the shapes alone) or
    ``"cuda"`` (the kernel) for ``x``. The kernel has no backward: where
    autograd would record a CUDA or ``meta`` call on ``x`` or
    ``operands``, raise rather than return an output that drops the
    gradient (the autograd paths wrap the kernels in their own
    ``autograd.Function``, inside which nothing is recorded)."""
    kind = x.device.type
    if kind == "cpu":
        return kind
    if kind not in ("cuda", "meta"):
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x,) + operands):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input "
            "requires grad; call it under torch.no_grad() or through the "
            "MOA backends' autograd path (the causal forward attends "
            "through the plain versions)")
    return kind


def on_card(x) -> bool:
    """Whether a tensor (or a device) takes the kernel routes: CUDA, or
    ``meta`` standing for it."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type in ("cuda", "meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def dot_moa(a, b, *, block_k: int = 512, approx_bits: int = 0,
            out_dtype: Optional[torch.dtype] = None):
    """K-blocked matmul with serialized-MOA contraction ``(m,k)@(k,n)``,
    or, for 3-D operands, ``(E,m,k)@(E,k,n)`` member by member (one launch
    on the card)."""
    if _RECORDER is not None:
        *batch, m, k = a.shape
        e = batch[0] if batch else 1
        return _recorded("dot_moa", 2.0 * e * m * k * b.shape[-1], (a, b),
                         dot_moa, a, b, block_k=block_k,
                         approx_bits=approx_bits, out_dtype=out_dtype)
    route = _route(a, "dot_moa", b)
    if route == "cpu":
        fn = ref.dot_moa_batched_ref if a.dim() == 3 else ref.dot_moa_ref
        return fn(a, b, block_k=block_k, approx_bits=approx_bits,
                  out_dtype=out_dtype)
    if route == "meta":
        dtype = as_dtype(out_dtype) if out_dtype is not None else (
            torch.int32 if is_integer(a.dtype) else a.dtype)
        return _meta(tuple(a.shape[:-1]) + (b.shape[-1],), dtype)
    return dot_moa_cuda(a, b, block_k=block_k, approx_bits=approx_bits,
                        out_dtype=out_dtype)


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 256,
                    kv_chunk: int = 512):
    """Flash-attention forward, ``q (B, Sq, H, D)``, ``k``/``v``
    ``(B, Skv, Hk, D)``. ``q_chunk``/``kv_chunk`` are the plain version's
    chunk sizes (they shape only its float reassociation); the kernel's
    tiles are fixed in its source."""
    if _RECORDER is not None:
        B, Sq, H, D = q.shape
        return _recorded("flash_attention", 4.0 * B * Sq * k.shape[1] * H * D,
                         (q, k, v), flash_attention, q, k, v, causal=causal,
                         q_chunk=q_chunk, kv_chunk=kv_chunk)
    route = _route(q, "flash_attention", k, v)
    if route == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
    if route == "meta":
        return _meta(q.shape, q.dtype)
    return flash_attention_cuda(q, k, v, causal=causal)


def paged_attention(q, k_pool, v_pool, block_tables, start, *, k_scale=None,
                    v_scale=None, dequant_dtype=torch.bfloat16,
                    kv_start: int = 0, kv_count: Optional[int] = None):
    """Paged flash attention ``(B, T, H, D)`` over a block-table KV pool
    (int8 pools dequantized through ``dequant_dtype``), reading the pool's
    KV heads ``kv_start .. kv_start + kv_count - 1`` (default: all of
    them) in place: the H query heads attend those in groups of ``H /
    kv_count``."""
    if _RECORDER is not None:
        B, T, H, D = q.shape
        width = block_tables.shape[1] * k_pool.shape[1]
        return _recorded("paged_attention", 4.0 * B * T * width * H * D,
                         (q, k_pool, v_pool, block_tables, start, k_scale,
                          v_scale),
                         paged_attention, q, k_pool, v_pool, block_tables,
                         start, k_scale=k_scale, v_scale=v_scale,
                         dequant_dtype=dequant_dtype, kv_start=kv_start,
                         kv_count=kv_count)
    route = _route(q, "paged_attention", k_pool, v_pool, k_scale, v_scale)
    if route == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, start,
                                       k_scale=k_scale, v_scale=v_scale,
                                       dequant_dtype=dequant_dtype,
                                       kv_start=kv_start, kv_count=kv_count)
    if route == "meta":
        return _meta(q.shape, q.dtype)
    return paged_attention_cuda(q, k_pool, v_pool, block_tables, start,
                                k_scale=k_scale, v_scale=v_scale,
                                dequant_dtype=dequant_dtype,
                                kv_start=kv_start, kv_count=kv_count)


def moa_reduce(x, *, block_n: int = 512):
    """Blocked MOA reduction ``(n, f) → (f,)``: f32 accumulation for float
    operands, int32 for integer ones."""
    if _RECORDER is not None:
        return _recorded("moa_reduce", 0.0, (x,), moa_reduce, x,
                         block_n=block_n)
    route = _route(x, "moa_reduce")
    if route == "cpu":
        return ref.moa_reduce_ref(x, block_n=block_n)
    if route == "meta":
        return _meta(x.shape[1:], torch.int32 if is_integer(x.dtype)
                     else torch.float32)
    return moa_reduce_cuda(x.contiguous(), block_n=block_n)


def loa_add(x, y, *, approx_bits: int, width: int = 8):
    """Element-wise LOA addition on int32 containers (``width`` is carried
    by the operand values, as in the reference)."""
    if _RECORDER is not None:
        return _recorded("loa_add", 0.0, (x, y), loa_add, x, y,
                         approx_bits=approx_bits, width=width)
    del width
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    route = _route(x, "loa_add")
    if route == "cpu":
        return ref.loa_add_ref(x, y, approx_bits=approx_bits)
    if route == "meta":
        return _meta(x.shape, torch.int32)
    return loa_add_cuda(x.to(torch.int32).contiguous(),
                        y.to(torch.int32).contiguous(),
                        approx_bits=approx_bits)


def loa_reduce(x, *, approx_bits: int, width: int = 8, block_n: int = 256):
    """Approximate serialized MOA ``(n, f) → (f,)`` int32; ``n`` must be a
    multiple of ``block_n``."""
    if _RECORDER is not None:
        return _recorded("loa_reduce", 0.0, (x,), loa_reduce, x,
                         approx_bits=approx_bits, width=width,
                         block_n=block_n)
    del width
    route = _route(x, "loa_reduce")
    if route == "cpu":
        return ref.loa_reduce_ref(x, approx_bits=approx_bits, block_n=block_n)
    if route == "meta":
        return _meta(x.shape[1:], torch.int32)
    return loa_reduce_cuda(x.to(torch.int32).contiguous(),
                           approx_bits=approx_bits, block_n=block_n)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (``{wrapper name: launches}``) to the wrappers' counts.
    A CUDA graph's replay launches its kernels without calling the
    wrappers, so it adds here the launches its capture recorded."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n
