"""GQA attention — the port of the pieces of ``repro/layers/attention.py``
that prefill, dense-slot and paged decode, the speculative verify of both
layouts, and the training forward use (the last through the plain
versions only, :func:`flash_attention` or :func:`full_attention`, as the
reference's ``attention_forward``).

Layouts: q ``(B, Sq, H, D)``, k/v ``(B, Skv, Hk, D)``; GQA groups
``G = H // Hk`` stay a separate axis. Dense-slot caches are ``(B, max_len,
Hk, D)`` per layer; paged pools are ``(n_phys_blocks, block_size, Hk, D)``
with int32 ``(B, n_blocks)`` tables; physical block 0 is the engine's
write-trash page.

Unlike the reference, decode and verify write the new K/V into the cache
**in place** (the cache tensors are the engine's; returning a fresh copy
per layer per step would double the KV traffic). Where the reference's
scatter is dropped or its target repeats, the port pins what JAX does:

* a dense-slot write at a position ``>= max_len`` (an idle slot's cursor
  keeps advancing; a verify window near the end of a slot) is dropped, as
  JAX drops an out-of-range scatter;
* writes that repeat a target (idle slots on the paged trash page) all
  carry the last one's value, the sequential scatter's outcome, so no
  race between them can matter on the card.

Every layer of a step writes at the same places: the targets are found
once a step (:func:`paged_write_targets`, :func:`verify_write_targets`,
:func:`paged_verify_targets`) and handed to each layer.

On a mesh that splits the q heads over ``model`` but not the KV heads
(fewer KV heads than the axis, or a count it does not divide), every rank
computes and caches every KV head, and its q heads attend the KV heads of
their groups alone (:func:`rank_kv_heads`): the plain paths through a view,
the flash kernel through a contiguous copy of the fresh K/V, the paged
kernel by reading those heads of the cache in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.layers.common import Params
from repro_torch.layers.numerics import NEG_INF, kv_scale_zeros
from repro_torch.layers.rope import apply_rope

__all__ = [
    "ATTN_BACKENDS", "attention_decode", "attention_decode_paged",
    "attention_verify", "attention_verify_paged", "flash_attention",
    "full_attention", "init_kv_cache", "init_kv_pool", "gather_paged_kv",
    "last_of_equal", "paged_verify_targets", "paged_write_targets",
    "prefill_attention", "quantize_kv", "dequantize_kv",
    "resolve_attn_backend", "verify_write_targets", "dense_attention",
    "DENSE_PAGE", "rank_kv_heads", "rank_kv",
]

#: resolved ``attn_backend`` values: plain PyTorch or the CUDA kernels
ATTN_BACKENDS = ("torch", "kernel")

#: The plain chunked-softmax twin of the flash kernel (the reference's jnp
#: ``flash_attention``); its implementation is the kernel's plain version.
flash_attention = flash_attention_ref


def resolve_attn_backend(backend: str, device) -> str:
    """Resolve the attention backend knob for tensors on ``device``:
    ``"auto"`` is the kernel on CUDA (and on ``meta``, the card's stand-in
    in the dry run) and the plain version on the CPU;
    ``"kernel"`` on the CPU raises (there is no kernel to run there), but
    under :func:`repro_torch.kernels.ops.interpret`, where the kernel
    entry points run their plain versions."""
    card = ops.on_card(device)
    if backend == "auto":
        return "kernel" if card else "torch"
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attn backend {backend!r}; expected "
                         f"'auto' or one of {ATTN_BACKENDS}")
    if backend == "kernel" and not card and not ops.interpreting():
        raise ValueError("attn_backend='kernel' needs CUDA tensors; a CPU "
                         "tensor takes 'auto' or 'torch'")
    return backend


def rank_kv_heads() -> Optional[Tuple[int, int]]:
    """``(first, count)`` of the KV heads this rank's q heads attend, where
    the active mesh splits the q heads over ``model`` and replicates the
    KV heads (:class:`repro_torch.parallel.collectives.RankShard`'s
    ``kv_slice``); ``None`` elsewhere (every KV head)."""
    from repro_torch.parallel.collectives import split

    rng = split("kv_slice")
    return None if not rng else (rng[0], rng[1] - rng[0])


def rank_kv(t: torch.Tensor) -> torch.Tensor:
    """This rank's KV heads (:func:`rank_kv_heads`) of ``t``, whose dim 2
    is the KV heads (fresh K/V ``(B, S, Hk, D)``, a dense-slot cache
    ``(B, max_len, Hk, D)``, a pool ``(n, bs, Hk, D)``, their scales): a
    view, ``t`` itself where the rank attends every head."""
    heads = rank_kv_heads()
    if heads is None or (heads[0] == 0 and heads[1] == t.shape[2]):
        return t
    return t.narrow(2, heads[0], heads[1])


def prefill_attention(q, k, v, *, causal: bool = True, q_chunk: int = 256,
                      kv_chunk: int = 512, backend: str = "auto"):
    """The softmax·V of a prompt (every query at once): the flash-attention
    kernel on the ``kernel`` backend, else its plain chunked twin
    (:func:`flash_attention`, the reference's prefill path)."""
    if resolve_attn_backend(backend, q.device) == "kernel":
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal)
    return flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                           kv_chunk=kv_chunk)


def full_attention(q, k, v, *, causal: bool, positions_q=None,
                   positions_kv=None, kv_len=None):
    """One-shot attention: materializes the scores.

    ``kv_len`` (scalar or ``(B,)``) limits the attended cache positions;
    ``positions_q`` may be ``(Sq,)`` or per-sequence ``(B, Sq)``.
    """
    B, Sq, H, D = q.shape
    _, Skv, Hk, _ = k.shape
    G = H // Hk
    dev = q.device
    qg = q.reshape(B, Sq, Hk, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (D ** -0.5)
    if positions_q is None:
        positions_q = torch.arange(Sq, device=dev)
    if positions_kv is None:
        positions_kv = torch.arange(Skv, device=dev)
    pq = positions_q if positions_q.dim() == 2 else positions_q[None]
    mask = torch.ones((pq.shape[0], Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (positions_kv[None, None, :] <= pq[:, :, None])
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
        if kv_len.dim() == 0:
            mask = mask & (positions_kv[None, None, :] < kv_len)
        else:
            mask = mask & (positions_kv[None, None, :] < kv_len[:, None, None])
    mask = mask[:, None, None]                          # (B|1, 1, 1, Sq, Skv)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _moa_dot(x, w, *, strategy, compute_dtype, site=None):
    """Dense projection routed through the MOA engine (scope-aware)."""
    from repro_torch.layers.linear import project

    return project({"w": w}, x, strategy=strategy,
                   compute_dtype=compute_dtype, site=site)


def _out_proj(o, wo, *, strategy, compute_dtype):
    """``o @ wo``: row-parallel over ``model`` where the heads are split
    (:func:`repro_torch.layers.linear.project_rows`)."""
    from repro_torch.layers.linear import project_rows

    return project_rows({"w": wo}, o, site="heads", strategy=strategy,
                        compute_dtype=compute_dtype)


def _project_qkv(params: Params, x, *, n_heads, n_kv_heads, head_dim,
                 compute_dtype, strategy=None):
    """q, k, v of ``x`` (biases added where the arch has them). Where a
    mesh splits the heads over ``model``, ``wq`` (and ``bq``) hold this
    rank's q heads and ``x`` enters through the column op; K/V split with
    them, or replicate (KV heads the model axis does not divide: every
    rank computes all of them, and its q heads attend those of their
    groups, :func:`rank_kv_heads`), and then ``k`` and ``v`` enter the
    split attention through the column op."""
    from repro_torch.parallel.collectives import column_input, split

    B, S, _ = x.shape
    x = x.to(compute_dtype)

    def dot(w, site):
        return _moa_dot(x, w.to(compute_dtype), strategy=strategy,
                        compute_dtype=compute_dtype, site=site)

    q = dot(params["wq"], "heads")
    k = dot(params["wk"], "kv_heads")
    v = dot(params["wv"], "kv_heads")
    if "bq" in params:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    if split("heads") and not split("kv_heads"):
        k, v = column_input(k, "heads"), column_input(v, "heads")
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv_heads, head_dim)
    v = v.reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> Params:
    """Dense-slot KV cache ``(batch, max_len, Hk, D)``; ``dtype=int8`` adds
    per-(pos, head) f32 scales."""
    shape = (batch, max_len, n_kv_heads, head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_scale"] = kv_scale_zeros(shape[:3], device)
        cache["v_scale"] = kv_scale_zeros(shape[:3], device)
    return cache


def init_kv_pool(n_phys_blocks: int, block_size: int, n_kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16, device=None) -> Params:
    """Paged KV pool; ``dtype=int8`` adds per-(pos, head) f32 scales.
    Physical block 0 is the engine's write-trash page."""
    shape = (n_phys_blocks, block_size, n_kv_heads, head_dim)
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        pool["k_scale"] = kv_scale_zeros(shape[:3], device)
        pool["v_scale"] = kv_scale_zeros(shape[:3], device)
    return pool


def quantize_kv(x):
    """Per-(batch, pos, head) symmetric int8 quantization of K or V: scale
    ``amax / 127`` (1 for an all-zero row), values rounded half to even and
    clipped to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


def gather_paged_kv(pool: Params, block_tables, dtype=torch.bfloat16, *,
                    live_blocks: Optional[int] = None):
    """Materialize each sequence's logical KV view ``(B, n_blk·bs, Hk, D)``
    from the shared pool (dequantized to ``dtype`` for an int8 pool).
    ``live_blocks`` truncates the table to the batch's high-water block:
    pages past every cursor are fully masked, so dropping them is exact."""
    if live_blocks is not None:
        block_tables = block_tables[:, :live_blocks]
    idx = block_tables.long()

    def flat(name):
        x = pool[name][idx]                 # (B, n_blk, bs, ...)
        return x.reshape((x.shape[0], -1) + tuple(x.shape[3:]))

    k, v = flat("k"), flat("v")
    if "k_scale" in pool:
        k = dequantize_kv(k, flat("k_scale"), dtype)
        v = dequantize_kv(v, flat("v_scale"), dtype)
    return k, v


def last_of_equal(*keys: torch.Tensor) -> torch.Tensor:
    """For each row ``i`` of the 1-D ``keys``, the last row ``j`` whose keys
    all equal row ``i``'s. Indexing a scatter's values by it makes every
    write to a repeated target carry the last one's value: what a
    sequential scatter leaves, whatever order the writes land in."""
    n = keys[0].shape[0]
    same = torch.ones((n, n), dtype=torch.bool, device=keys[0].device)
    for key in keys:
        same &= key[:, None] == key[None, :]
    idx = torch.arange(n, device=keys[0].device)
    return torch.where(same, idx[None, :], -1).amax(dim=1)


def _scatter_per_batch(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Row ``b`` of ``new (B, 1, ...)`` into ``cache[b, pos[b]]``, in place;
    a cursor ``>= max_len`` writes nothing (JAX drops an out-of-range
    scatter): there the row's old value is written back."""
    B, max_len = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    cur = pos.long()
    at = torch.clamp(cur, max=max_len - 1)
    ok = (cur < max_len).reshape((B,) + (1,) * (cache.dim() - 2))
    cache[rows, at] = torch.where(ok, new[:, 0].to(cache.dtype),
                                  cache[rows, at])


def attention_decode(params: Params, x, cache: Params, pos, *, n_heads: int,
                     n_kv_heads: int, head_dim: int,
                     rope_theta: float = 10000.0, use_rope: bool = True,
                     compute_dtype=torch.bfloat16, strategy=None,
                     backend: str = "torch"
                     ) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``x (B, 1, d)`` against a dense-slot KV cache at
    ``pos``, a 0-d cursor for the whole batch or a ``(B,)`` one per slot.

    The new K/V is written in place (int8 caches quantized, with their
    scales), then the step attends over the cache with ``kv_len = pos + 1``
    through :func:`full_attention` (``backend="torch"``: plain PyTorch, as
    the reference's jnp ``full_attention`` is outside any Pallas kernel) or
    :func:`dense_attention` (``"kernel"``: the paged-attention kernel over
    the cache's pages). A 0-d cursor writes through
    ``dynamic_update_slice`` semantics (clamped into the cache); a vector
    one per slot, dropping a write past ``max_len``."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(
        params, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        compute_dtype=compute_dtype, strategy=strategy)
    scalar = pos.dim() == 0
    pos_arr = (pos.reshape(1, 1).expand(B, 1) if scalar else pos[:, None])
    if use_rope:
        q = apply_rope(q, pos_arr, theta=rope_theta)
        k_new = apply_rope(k_new, pos_arr, theta=rope_theta)

    def write(buf, new):
        if scalar:   # dynamic_update_slice clamps the start into range
            at = torch.clamp(pos.long(), max=buf.shape[1] - 1)
            buf.index_copy_(1, at.reshape(1), new.to(buf.dtype))
        else:
            _scatter_per_batch(buf, new, pos)

    if "k_scale" in cache:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        write(cache["k"], kq)
        write(cache["v"], vq)
        write(cache["k_scale"], ks)
        write(cache["v_scale"], vs)
    else:
        write(cache["k"], k_new)
        write(cache["v"], v_new)
    if resolve_attn_backend(backend, x.device) == "kernel":
        o = dense_attention(q, cache, pos, compute_dtype=compute_dtype)
    else:
        k_cache, v_cache = _dense_kv(cache, compute_dtype)
        o = full_attention(q, k_cache, v_cache, causal=False, kv_len=pos + 1)
    o = o.reshape(B, 1, n_heads * head_dim)
    y = _out_proj(o, params["wo"].to(compute_dtype), strategy=strategy,
                  compute_dtype=compute_dtype)
    return y, cache


def _dense_kv(cache: Params, compute_dtype):
    """This rank's KV heads of a dense-slot cache (:func:`rank_kv`),
    dequantized for an int8 cache."""
    if "k_scale" in cache:
        return (dequantize_kv(rank_kv(cache["k"]), rank_kv(cache["k_scale"]),
                              compute_dtype),
                dequantize_kv(rank_kv(cache["v"]), rank_kv(cache["v_scale"]),
                              compute_dtype))
    return rank_kv(cache["k"]), rank_kv(cache["v"])


def _rank_pool(pool: Params) -> Params:
    """The pool's leaves narrowed to this rank's KV heads (views)."""
    return {name: rank_kv(t) for name, t in pool.items()}


def _paged_attention_fused(q, pool: Params, block_tables, start, *,
                           compute_dtype=torch.bfloat16):
    """The paged score reduction through the paged-attention kernel: it
    walks the tables up to each slot's deepest query itself and
    dequantizes int8 pools in registers, rounding through
    ``compute_dtype`` — the dtype the gather path materializes — so both
    backends see bit-equal KV. The whole table goes in (no live-block
    cut): the split is planned for its width, so a row's arithmetic does
    not depend on the live-block bucket. The kernel reads this rank's KV
    heads (:func:`rank_kv_heads`) of the pool in place."""
    heads = rank_kv_heads() or (0, None)
    return ops.paged_attention(
        q, pool["k"], pool["v"], block_tables.contiguous(),
        start.to(torch.int32).contiguous(),
        k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
        dequant_dtype=compute_dtype, kv_start=heads[0], kv_count=heads[1])


#: tokens a page when the paged-attention kernel walks a dense-slot cache
#: (the served paged engines' block size): a slot's row ``(max_len, Hk,
#: D)`` is ``max_len / DENSE_PAGE`` contiguous pages of the pool's shape
DENSE_PAGE = 16


def _identity_tables(batch: int, pages: int, device) -> torch.Tensor:
    """Slot ``b``'s logical page ``j`` is page ``b * pages + j`` of the
    dense cache viewed as a pool (cached per shape and device)."""
    key = (batch, pages, str(device))
    t = _IDENTITY.get(key)
    if t is None:
        t = torch.arange(batch * pages, dtype=torch.int32,
                         device=device).reshape(batch, pages)
        _IDENTITY[key] = t
    return t


_IDENTITY: dict = {}


def dense_attention(q, cache: Params, start, *, compute_dtype=torch.bfloat16):
    """The dense-slot score reduction on CUDA: the T queries of slot ``b``
    at ``start[b] ..`` attend causally over its cache row through the
    paged-attention kernel, the row viewed as ``max_len / DENSE_PAGE``
    pages and walked through an identity block table. A dense-slot engine
    (and the oracle drafter's dense-slot cache) then shares one arithmetic
    with a paged engine of ``DENSE_PAGE``-token blocks, and a row's result
    does not depend on T (the kernel's row invariance). ``max_len`` must be
    a multiple of ``DENSE_PAGE``."""
    B, max_len, Hk, D = cache["k"].shape
    if max_len % DENSE_PAGE:
        raise ValueError(f"dense-slot attention on the kernel walks pages of "
                         f"{DENSE_PAGE} tokens: max_len {max_len} is not a "
                         "multiple")
    pages = max_len // DENSE_PAGE
    pool = {name: buf.reshape((B * pages, DENSE_PAGE) + tuple(buf.shape[2:]))
            for name, buf in cache.items()}
    start = start.reshape(1).expand(B) if start.dim() == 0 else start
    return _paged_attention_fused(
        q, pool, _identity_tables(B, pages, q.device), start,
        compute_dtype=compute_dtype)


def paged_write_targets(block_tables, pos, block_size: int):
    """Where a paged decode step writes each slot's new K/V: ``(blk, off,
    last)``, the physical page and offset of cursor ``pos (B,)``, and
    :func:`last_of_equal` of them. The same in every layer of a step.

    An idle slot's cursor keeps advancing and can pass the table width;
    JAX clamps such an out-of-range gather to the last column, which for a
    cleared (all-trash) row is the trash page. PyTorch would raise, so the
    column is clamped explicitly to keep the write on the trash page. Idle
    slots may then repeat a (trash page, offset) target; no live request
    reads the trash page, but idle slots do, and a capacity-limited MoE
    routes their rows beside live ones: every repeat carries the last
    write's value (``last``), as the reference's sequential scatter leaves
    it."""
    cur = pos.long()
    col = torch.clamp(cur // block_size, max=block_tables.shape[1] - 1)
    rows = torch.arange(cur.shape[0], device=cur.device)
    blk = block_tables[rows, col].long()
    off = cur % block_size
    return blk, off, last_of_equal(blk, off)


def attention_decode_paged(params: Params, x, pool: Params, block_tables,
                           pos, targets, *, n_heads: int, n_kv_heads: int,
                           head_dim: int, rope_theta: float = 10000.0,
                           use_rope: bool = True,
                           compute_dtype=torch.bfloat16,
                           strategy=None, backend: str = "torch",
                           live_blocks: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, Params]:
    """One decode step against a paged KV pool.

    The new token's K/V is written (in place) to physical page
    ``block_tables[b, pos // bs]`` at offset ``pos % bs`` (``targets``:
    :func:`paged_write_targets` of them, found once for every layer of the
    step); the score reduction then runs over the slot's pages — the
    gathered view and ``full_attention`` (``backend="torch"``) or the
    paged-attention kernel (``"kernel"``). ``pos`` is the ``(B,)`` cursor
    vector.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(
        params, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        compute_dtype=compute_dtype, strategy=strategy)
    pos = pos[:, None]
    if use_rope:
        q = apply_rope(q, pos, theta=rope_theta)
        k_new = apply_rope(k_new, pos, theta=rope_theta)

    cur = pos[:, 0].long()
    blk, off, last = targets
    if "k_scale" in pool:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        pool["k"][blk, off] = kq[last, 0]
        pool["v"][blk, off] = vq[last, 0]
        pool["k_scale"][blk, off] = ks[last, 0]
        pool["v_scale"][blk, off] = vs[last, 0]
    else:
        pool["k"][blk, off] = k_new[last, 0].to(pool["k"].dtype)
        pool["v"][blk, off] = v_new[last, 0].to(pool["v"].dtype)

    if resolve_attn_backend(backend, x.device) == "kernel":
        o = _paged_attention_fused(q, pool, block_tables, cur,
                                   compute_dtype=compute_dtype)
    else:
        k_cache, v_cache = gather_paged_kv(_rank_pool(pool), block_tables,
                                           compute_dtype,
                                           live_blocks=live_blocks)
        o = full_attention(q, k_cache, v_cache, causal=False, kv_len=cur + 1)
    o = o.reshape(B, 1, n_heads * head_dim)
    y = _out_proj(o, params["wo"].to(compute_dtype), strategy=strategy,
                  compute_dtype=compute_dtype)
    return y, pool


# ---------------------------------------------------------------------------
# speculative verify: T tokens a slot in one call
# ---------------------------------------------------------------------------


def _verify_positions(pos, batch: int, n_tokens: int):
    """Per-slot query positions ``(B, T)`` of a T-token verify window
    starting at each slot's cursor (a 0-d ``pos`` broadcasts)."""
    start = pos.reshape(1).expand(batch) if pos.dim() == 0 else pos
    return start.to(torch.int32)[:, None] + torch.arange(
        n_tokens, dtype=torch.int32, device=pos.device)[None, :]


def verify_write_targets(pos, batch: int, n_tokens: int, max_len: int):
    """Where a dense-slot verify of ``batch`` slots writes row ``t`` of slot
    ``b``: ``(pos_q, at, src, live)``. ``pos_q (B, T)`` are the window's
    positions (a 0-d ``pos`` broadcasts); a row at ``>= max_len`` is
    dropped, as JAX drops an out-of-range scatter. PyTorch would raise, so
    such a row is clamped onto ``max_len - 1`` and carries what that
    position gets anyway: the slot's last in-range row (``src``), or, where
    no row of the slot is in range (``live`` false), the cache's own value.
    Every write to a repeated target then carries one value."""
    pos_q = _verify_positions(pos, batch, n_tokens)
    at = torch.clamp(pos_q, max=max_len - 1).long()
    n_ok = torch.clamp(max_len - pos_q[:, 0], min=0, max=n_tokens)
    t = torch.arange(n_tokens, device=pos.device)
    src = torch.minimum(t[None, :], torch.clamp(n_ok - 1, min=0)[:, None])
    return pos_q, at, src, n_ok > 0


def _verify_write(buf: torch.Tensor, new: torch.Tensor, targets) -> None:
    """Rows ``new (B, T, ...)`` into ``buf (B, max_len, ...)`` at the
    :func:`verify_write_targets`, in place."""
    _, at, src, live = targets
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    val = new[rows, src].to(buf.dtype)
    live = live.reshape((-1,) + (1,) * (val.dim() - 1))
    buf[rows, at] = torch.where(live, val, buf[rows, at])


def _kv_rows(k_new, v_new, quantized: bool) -> dict:
    """The new K/V rows as the cache stores them (int8 with scales)."""
    if not quantized:
        return {"k": k_new, "v": v_new}
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def attention_verify(params: Params, x, cache: Params, pos, targets, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float = 10000.0, use_rope: bool = True,
                     compute_dtype=torch.bfloat16, strategy=None,
                     backend: str = "torch"
                     ) -> Tuple[torch.Tensor, Params]:
    """Speculative verify against a dense-slot cache: ``x (B, T, d)`` holds
    each slot's pending token and its draft window, at positions ``pos[b]
    .. pos[b] + T - 1``. All T K/V rows are written in place (tentatively:
    the engine's commit decides how many survive by the cursor), at
    ``targets`` (:func:`verify_write_targets`); each query attends causally
    at its own position through :func:`full_attention`, plain PyTorch as
    the reference's jnp is (``backend="kernel"``: :func:`dense_attention`,
    whose row ``t`` gives the bits of a decode step at ``pos + t``)."""
    B, T, _ = x.shape
    q, k_new, v_new = _project_qkv(
        params, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        compute_dtype=compute_dtype, strategy=strategy)
    pos_q = targets[0]
    if use_rope:
        q = apply_rope(q, pos_q, theta=rope_theta)
        k_new = apply_rope(k_new, pos_q, theta=rope_theta)
    quantized = "k_scale" in cache
    for name, new in _kv_rows(k_new, v_new, quantized).items():
        _verify_write(cache[name], new, targets)
    if resolve_attn_backend(backend, x.device) == "kernel":
        o = dense_attention(q, cache, pos_q[:, 0],
                            compute_dtype=compute_dtype)
    else:
        k_cache, v_cache = _dense_kv(cache, compute_dtype)
        o = full_attention(q, k_cache, v_cache, causal=True,
                           positions_q=pos_q)
    o = o.reshape(B, T, n_heads * head_dim)
    y = _out_proj(o, params["wo"].to(compute_dtype), strategy=strategy,
                  compute_dtype=compute_dtype)
    return y, cache


def paged_verify_targets(block_tables, pos, n_tokens: int, block_size: int):
    """Where a paged verify writes: ``(pos_q, blk, off, last)``, the
    window's positions ``(B, T)`` and, flattened over ``(b, t)``, the
    physical page and offset of each row and :func:`last_of_equal` of
    them. A position past the table (an idle slot's window) goes to the
    trash page 0, as the reference's. Idle slots' rows repeat targets on
    the trash page; every repeat carries the last write's value."""
    B = block_tables.shape[0]
    pos_q = _verify_positions(pos, B, n_tokens)
    logical = (pos_q // block_size).long()
    n_logical = block_tables.shape[1]
    rows = torch.arange(B, device=pos.device)[:, None]
    blk = block_tables[rows, torch.clamp(logical, max=n_logical - 1)].long()
    blk = torch.where(logical < n_logical, blk, 0).reshape(-1)
    off = (pos_q % block_size).long().reshape(-1)
    return pos_q, blk, off, last_of_equal(blk, off)


def attention_verify_paged(params: Params, x, pool: Params, block_tables,
                           pos, targets, *, n_heads: int, n_kv_heads: int,
                           head_dim: int, rope_theta: float = 10000.0,
                           use_rope: bool = True,
                           compute_dtype=torch.bfloat16, strategy=None,
                           backend: str = "torch",
                           live_blocks: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, Params]:
    """Paged twin of :func:`attention_verify`: the T tentative rows of a
    slot scatter, in place, through its block table (``targets``:
    :func:`paged_verify_targets`; the engine's admission reserves ``k``
    rows of private pages past every request's worst case). The score
    reduction is the paged-attention kernel at ``T`` queries a slot from
    ``start = pos`` on (``backend="kernel"``), or the gathered view and
    :func:`full_attention`. ``live_blocks`` must cover ``max(pos) + T``."""
    B, T, _ = x.shape
    q, k_new, v_new = _project_qkv(
        params, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        compute_dtype=compute_dtype, strategy=strategy)
    pos_q, blk, off, last = targets
    if use_rope:
        q = apply_rope(q, pos_q, theta=rope_theta)
        k_new = apply_rope(k_new, pos_q, theta=rope_theta)
    for name, new in _kv_rows(k_new, v_new, "k_scale" in pool).items():
        rows = new.reshape((B * T,) + tuple(new.shape[2:]))
        pool[name][blk, off] = rows[last].to(pool[name].dtype)
    if resolve_attn_backend(backend, x.device) == "kernel":
        o = _paged_attention_fused(q, pool, block_tables, pos_q[:, 0],
                                   compute_dtype=compute_dtype)
    else:
        k_cache, v_cache = gather_paged_kv(_rank_pool(pool), block_tables,
                                           compute_dtype,
                                           live_blocks=live_blocks)
        o = full_attention(q, k_cache, v_cache, causal=True,
                           positions_q=pos_q)
    o = o.reshape(B, T, n_heads * head_dim)
    y = _out_proj(o, params["wo"].to(compute_dtype), strategy=strategy,
                  compute_dtype=compute_dtype)
    return y, pool
