"""Continuous-batching engine — the port of ``repro/serve/engine.py`` in
its FIFO mode, over either of the reference's two cache layouts.

One engine tick = (admit arrived requests into free slots, each through a
prefill whose K/V lands in the slot's cache) + (one batched decode step
over all slots, idle ones fed token 0).

* **dense-slot** (``paged=False``, the reference's default): every slot
  owns a ``max_len`` region of the cache; an admission's prefill is copied
  into the slot's row (:func:`_write_slot`), and an idle slot's row and
  cursor stay as its last request left them, its cursor still advancing.
* **paged** (``paged=True``): KV lives in a shared pool of fixed-size
  physical pages mapped through per-slot block tables
  (:mod:`repro_torch.serve.kv_pool`): requests sharing a prompt prefix
  share physical pages (ref-counted, copy-on-write at the first divergent
  write), admission needs a free slot **and** enough free blocks, and on
  the dense family a prefix-cache hit skips the shared blocks' prefill
  compute (suffix prefill).

The families gate as the reference's do. Right-padded (bucketed) prefill
only where ``Model.supports_padded_prefill``: an MoE below the dropless
regime prefills each prompt at its exact length, since pad tokens would
compete for expert capacity. Suffix prefill is the dense family's; a
capacity-limited MoE also keeps its prompt pages out of the prefix trie.

The host logic is the reference's, line for line, and so is every device
write an idle slot makes: a capacity-limited MoE routes the idle rows
beside the live ones, so their cursors and caches must evolve as the
reference's do. The cache tensors are updated **in place**. The
reference's compile cache becomes CUDA graphs
(:mod:`repro_torch.serve.graphs`, on by default for a CUDA engine): the
paged decode is captured once per live-block bucket, the dense-slot decode
once, and the padded full-prompt prefill with its write into the cache
once per prompt bucket; each tick replays them. The prefix-hit (suffix)
prefill and the exact-length prefill run eagerly. ``cuda_graphs=False``
runs every tick eagerly, as the yardstick: the captured engine runs the
same kernels in the same order on the same buffers. On the GPU every
projection runs the ``dot_moa`` kernel (an MoE's expert projections one
batched launch each), the MoE's top-k combine ``moa_reduce``, prefill's
softmax·V the flash-attention kernel and paged decode's the
paged-attention kernel; ``attn_backend="torch"`` (with a ``backend=torch``
MOA spec) runs the plain PyTorch versions instead. Every finished request
is priced (``metrics.moa_flops``) by :func:`repro_torch.launch.costing.
request_decode_cost`, as the reference prices it.

Not ported yet, and refused with ``NotImplementedError``: speculative
decoding, chunked prefill, SLO scheduling, mesh serving and weight
reloads (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.interop import tree_leaves
from repro_torch.kernels import _build
from repro_torch.launch.costing import request_decode_cost
from repro_torch.layers.attention import (dequantize_kv, last_of_equal,
                                          resolve_attn_backend)
from repro_torch.models.api import Model, build_model
from repro_torch.serve import graphs
from repro_torch.serve.kv_pool import TRASH_BLOCK, BlockPool, blocks_needed
from repro_torch.serve.metrics import RequestMetrics, aggregate, paged_report
from repro_torch.serve.request import FinishReason, Request, RequestResult
from repro_torch.serve.sampling import sample_batch
from repro_torch.serve.scheduler import SlotScheduler

__all__ = ["ServeEngine"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item 8: engine "
        "features)")


@dataclasses.dataclass
class _Inflight:
    """Host-side state of one admitted request (device state lives in the
    engine's batched cache at ``slot``)."""

    request: Request
    slot: int
    generated: List[int]
    next_token: int
    metrics: RequestMetrics


@dataclasses.dataclass
class _SlotTable:
    """Host mirror of one slot's block table.

    ``shared`` marks logical blocks currently mapped to ref-shared pages
    (writes must not land there — admission redirects them to the trash
    page, and the reserved ``cow_spare`` absorbs the first divergent
    write).
    """

    blocks: List[int]
    shared: Set[int]
    cow_spare: Optional[int] = None
    tail_idx: Optional[int] = None


# ---- dense-slot device helpers (in place on the cache tensors) -------------


def _write_slot(cache, pre, slot) -> None:
    """Copy a batch-1 prefill cache into row ``slot`` of the batched cache
    (every KV leaf ``(L, n_slots, max_len, ...)``) and its cursor into
    ``pos[slot]``. ``slot`` is a Python int, or a CUDA graph's ``(1,)``
    device tensor (then the rows are installed by ``index_copy_``)."""
    if isinstance(slot, torch.Tensor):
        idx = slot.long()
        for name, leaf in cache["layers"].items():
            leaf.index_copy_(1, idx, pre["layers"][name].to(leaf.dtype))
        cache["pos"].index_copy_(
            0, idx, torch.as_tensor(pre["pos"]).reshape(1).to(
                cache["pos"].dtype))
    else:
        for name, leaf in cache["layers"].items():
            leaf[:, slot] = pre["layers"][name][:, 0].to(leaf.dtype)
        cache["pos"][slot] = pre["pos"]


def _read_slot(cache, slot: int):
    """Exact inverse of :func:`_write_slot`: row ``slot`` of the batched
    cache as a batch-1 prefill-shaped tree (copies, in the cache types)."""
    return {"layers": {name: leaf[:, slot:slot + 1].clone()
                       for name, leaf in cache["layers"].items()},
            "pos": cache["pos"][slot].clone()}


# ---- paged device helpers (in place on the cache tensors) ------------------


def _gather_prefix(pool, ids, *, cdtype):
    """Cached prefix pages → dense ``(L, 1, P, Hk, D)`` K/V (compute
    dtype; dequantized if the pool is int8)."""

    def flat(name):
        x = pool[name][:, ids]                   # (L, n, bs, ...)
        return x.reshape((x.shape[0], 1, -1) + tuple(x.shape[3:]))

    k, v = flat("k"), flat("v")
    if "k_scale" in pool:
        k = dequantize_kv(k, flat("k_scale"), cdtype)
        v = dequantize_kv(v, flat("v_scale"), cdtype)
    return {"k": k, "v": v}


def _paged_write(cache, pre_kv, write_ids, table_row, slot, pre_pos) -> None:
    """Scatter a prefill's K/V into the pool pages named by ``write_ids``
    (one per written logical block; shared and overhang blocks arrive
    redirected to the trash page, so the ids may repeat: every repeat
    carries the last one's block, as the reference's sequential scatter
    leaves the page, since idle slots read it), then install the slot's
    block-table row and cursor.

    ``slot`` and ``pre_pos`` are Python ints, or a CUDA graph's static
    inputs: a ``(1,)`` and a 0-d int32 device tensor, installed by
    ``index_copy_`` on the device."""
    nb = write_ids.shape[0]
    last = last_of_equal(write_ids)
    for name, leaf in cache["layers"].items():
        s = pre_kv[name][:, 0]                   # (L, S, ...)
        s = s.reshape((s.shape[0], nb, s.shape[1] // nb)
                      + tuple(s.shape[2:]))
        leaf[:, write_ids] = s[:, last].to(leaf.dtype)
    if isinstance(slot, torch.Tensor):
        slot = slot.long()
        cache["block_tables"].index_copy_(0, slot, table_row[None])
        cache["pos"].index_copy_(0, slot, pre_pos.reshape(1))
    else:
        cache["block_tables"][slot] = table_row
        cache["pos"][slot] = pre_pos


def _cow_copy(cache, src: int, dst: int, slot: int, logical_idx: int) -> None:
    """Copy-on-write: duplicate page ``src`` into the reserved spare
    ``dst`` and repoint this slot's table entry, so the imminent divergent
    write lands on a private page."""
    for leaf in cache["layers"].values():
        leaf[:, dst] = leaf[:, src]
    cache["block_tables"][slot, logical_idx] = dst


def _clear_slot(cache, slot: int) -> None:
    """Point a freed slot's table at the trash page and rewind its cursor:
    its (masked-out) decode writes can then never corrupt pages
    reallocated to live requests."""
    cache["block_tables"][slot] = TRASH_BLOCK
    cache["pos"][slot] = 0


class ServeEngine:
    """Continuous-batching server over a :class:`repro_torch.models.api.
    Model`, with a dense-slot cache or a paged KV pool.

    Parameters follow the reference's ``ServeEngine``:

    model, params:
        A built model and its parameter tree, on ``device``.
    n_slots, max_len, prompt_buckets:
        Decode batch width, per-slot context capacity (tokens) and the
        prefill shape set (default: powers of two up to ``max_len``;
        prompts are right-padded up to a bucket).
    paged, block_size, n_blocks:
        ``paged=False`` (the default): a dense-slot cache, ``max_len``
        tokens a slot. ``paged=True``: a KV pool of ``n_blocks`` pages
        (default: the dense equivalent ``n_slots * max_len /
        block_size``) of ``block_size`` tokens, which must divide
        ``max_len``.
    generator:
        ``torch.Generator`` on ``device`` for temperature-sampled requests
        (default: seeded with 0). All-greedy ticks draw nothing.
    clock:
        Monotonic time source in seconds (tests pass a frozen one; idle
        gaps before the next arrival are fast-forwarded).
    attn_backend:
        Overrides ``cfg.attn_backend``: ``"kernel"`` the CUDA kernels,
        ``"torch"`` the plain PyTorch versions, ``"auto"`` the kernels for
        CUDA tensors and the plain versions on the CPU. ``None`` keeps the
        config's.
    cuda_graphs:
        Capture the decode and the padded full-prompt prefill in CUDA
        graphs (:mod:`repro_torch.serve.graphs`) and replay them each
        tick.
        ``None``: on for a CUDA engine, off on the CPU; ``True`` on the CPU
        raises; ``False`` runs every tick eagerly.
    device:
        Where the engine runs: the GPU unless the caller asks for the CPU
        (no GPU raises). ``params`` must already be there.
    drafter, mesh, prefill_chunk_tokens, scheduling="slo":
        Refused: ROADMAP Queue 1, item 8.
    """

    def __init__(self, model: Model, params, *, n_slots: int, max_len: int,
                 prompt_buckets: Sequence[int] = (), paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 drafter=None, mesh=None,
                 clock: Callable[[], float] = time.monotonic,
                 prefill_chunk_tokens: Optional[int] = None,
                 scheduling: str = "fifo",
                 attn_backend: Optional[str] = None,
                 device="cuda", cuda_graphs: Optional[bool] = None):
        if drafter is not None:
            raise _not_ported("speculative decoding (drafter)")
        if mesh is not None:
            raise _not_ported("mesh serving")
        if prefill_chunk_tokens is not None:
            raise _not_ported("chunked prefill")
        if scheduling == "slo":
            raise _not_ported("scheduling='slo'")
        if scheduling != "fifo":
            raise ValueError(f"unknown scheduling {scheduling!r}; expected "
                             "'fifo' or 'slo'")
        self.device = resolve_device(device)
        for path, leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(
                    f"parameter {path} is on {leaf.device}, the engine runs "
                    f"on {self.device}")
        if attn_backend is not None:
            model = build_model(dataclasses.replace(
                model.cfg, attn_backend=attn_backend))
        # resolve now: a 'kernel' request on the CPU fails at construction
        resolve_attn_backend(model.cfg.attn_backend, self.device)
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.scheduling = scheduling
        self.scheduler = SlotScheduler(n_slots, max_len,
                                       [b for b in prompt_buckets
                                        if b <= max_len])
        self._clock = clock
        self._gen = generator if generator is not None \
            else torch.Generator(device=self.device).manual_seed(0)
        self._padded = model.supports_padded_prefill
        self.paged = paged
        if paged:
            self._init_paged(block_size, n_blocks)
        else:
            self.cache = model.init_cache(n_slots, max_len,
                                          device=self.device)
            self.cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                            device=self.device)
        self._graphs = self._init_graphs(cuda_graphs)

        self._inflight: Dict[int, _Inflight] = {}
        self._admissions = 0
        self._steps = 0
        self._occupancy_sum = 0.0
        self._fast_forward_s = 0.0
        self._t_start = self._clock()
        self._compile_s = 0.0
        self._log_start = 0

    # ---- paged setup -------------------------------------------------------
    def _init_paged(self, block_size: int, n_blocks: Optional[int]) -> None:
        if self.max_len % block_size:
            raise ValueError(
                f"block_size {block_size} must divide max_len "
                f"{self.max_len} so the gathered paged view matches the "
                "dense cache shape exactly")
        self.block_size = block_size
        self._max_blocks = self.max_len // block_size
        self.n_blocks = n_blocks if n_blocks is not None \
            else self.n_slots * self._max_blocks
        self._pool = BlockPool(self.n_blocks, block_size)
        self._tables: Dict[int, _SlotTable] = {}
        family = self.model.cfg.family
        # dense family: prefix hits skip prefill compute via suffix prefill;
        # partial-tail sharing is pointless there (the tail is recomputed),
        # so tail matching, and with it CoW, is the full-prefill MoE's
        self._suffix_capable = family == "dense"
        self._match_tail = not self._suffix_capable
        # prefix-content reuse is exact only where a prompt position's KV
        # does not depend on the rest of the prefill: a capacity-limited
        # MoE couples it to the prefill's length, so its prompt pages stay
        # out of the trie (it still pages memory)
        self._prefix_share = family != "moe" or self._padded
        if not self._prefix_share:
            self._match_tail = False
        self._spec = self.model.cache_spec()
        # physical pages: pool blocks 1..n plus the id-0 trash page
        self.cache = self.model.init_paged_cache(
            self.n_slots, self.n_blocks + 1, block_size, self._max_blocks,
            device=self.device)
        self._prefix_hits = 0
        self._shared_block_hits = 0
        self._cow_count = 0
        self._admissions = 0
        self._block_occ_sum = 0.0
        self._peak_blocks = 0
        # attention KV traffic, priced per tick from the same cursors
        # whichever backend ran: gathered = what the plain gather path
        # streams (n_slots × high-water bucket), fused = the live blocks the
        # paged kernel touches
        self._gathered_kv_bytes = 0
        self._fused_kv_bytes = 0
        self._kv_step_log: List[Tuple[int, int]] = []

    def _init_graphs(self, cuda_graphs: Optional[bool]
                     ) -> Optional[graphs.GraphCache]:
        if cuda_graphs is None:
            cuda_graphs = graphs.API.supports(self.device)
        elif cuda_graphs and not graphs.API.supports(self.device):
            raise ValueError(f"cuda_graphs=True needs a CUDA engine; this "
                             f"one runs on {self.device}")
        if not cuda_graphs:
            return None
        return graphs.GraphCache(
            self._decode_body, self._prefill_body, n_slots=self.n_slots,
            max_blocks=self._max_blocks if self.paged else 0,
            max_bucket=max(self.scheduler.buckets), device=self.device)

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # ---- live-block bucketing ----------------------------------------------
    def _hw_buckets(self) -> List[int]:
        """The block-count buckets decode runs against: powers of two up
        to the table width, plus the width itself."""
        buckets = []
        b = 1
        while b < self._max_blocks:
            buckets.append(b)
            b <<= 1
        buckets.append(self._max_blocks)
        return buckets

    def _live_blocks(self, window: int) -> int:
        """Bucketed high-water block count covering every in-flight slot's
        cursor plus ``window`` rows written this tick, rounded up to a
        power of two (capped at the table width)."""
        need = 1
        for inf in self._inflight.values():
            top = inf.metrics.prompt_tokens + len(inf.generated) + window - 1
            need = max(need, top // self.block_size + 1)
        b = 1
        while b < need:
            b <<= 1
        return min(b, self._max_blocks)

    def _kv_bytes_tick(self, hw: int, window: int) -> Tuple[int, int]:
        """(gathered, fused) attention KV bytes for one tick at bucket
        ``hw``: the gather path materializes ``n_slots × hw`` blocks
        whether live or not; the paged kernel touches only each slot's live
        blocks."""
        blk = self._spec.kv_block_bytes(self.block_size)
        gathered = self.n_slots * hw * blk
        fused = 0
        for inf in self._inflight.values():
            top = inf.metrics.prompt_tokens + len(inf.generated) + window - 1
            fused += (top // self.block_size + 1) * blk
        return gathered, fused

    # ---- time --------------------------------------------------------------
    def _now(self, t_start: float) -> float:
        """Engine clock in seconds: wall time plus fast-forwarded idle."""
        return (self._clock() - t_start) + self._fast_forward_s

    # ---- lifecycle ---------------------------------------------------------
    def _block_gate(self, req: Request) -> bool:
        """Admission needs enough free pool blocks for the request's
        worst-case lifetime (prefix hits count as free)."""
        return self._pool.can_admit(req.prompt, req.max_new_tokens,
                                    match_tail=self._match_tail)

    def _plan_tables(self, req: Request):
        """Reserve pool pages for one admission: share matched prefix
        pages, allocate the rest (plus the CoW spare for a matched tail),
        and build the slot's logical→physical table."""
        pool = self._pool
        plan = pool.plan(req.prompt, req.max_new_tokens,
                         match_tail=self._match_tail)
        # share before alloc: a matched evictable page must be revived
        # before allocation can consider evicting it
        for b in plan.full_matched:
            pool.share(b)
        if plan.tail_matched is not None:
            pool.share(plan.tail_matched)
        fresh = iter(pool.alloc(plan.new_needed))
        n_full = len(plan.full_matched)
        table = _SlotTable(blocks=list(plan.full_matched),
                           shared=set(range(n_full)))
        if plan.tail_matched is not None:
            table.tail_idx = n_full              # == prompt_len // bs
        for i in range(n_full, plan.n_logical):
            if i == table.tail_idx:
                table.blocks.append(plan.tail_matched)
                table.shared.add(i)
            else:
                table.blocks.append(next(fresh))
        if plan.tail_matched is not None:
            table.cow_spare = next(fresh)
        return plan, table

    def _register_prompt_blocks(self, req: Request, plan,
                                table: _SlotTable) -> None:
        """Publish this admission's privately-written prompt pages in the
        prefix trie (matched pages are already registered)."""
        if not self._prefix_share:
            return
        bs, p = self.block_size, req.prompt_len
        for i in range(len(plan.full_matched), p // bs):
            self._pool.register(table.blocks[i], req.prompt[: (i + 1) * bs])
        if self._match_tail and p % bs and plan.tail_matched is None:
            self._pool.register(table.blocks[p // bs], req.prompt)

    def _paged_prefill(self, slot: int, req: Request):
        """Prefill under the paged cache; returns ``(first-token logits,
        cached prompt tokens)``.

        Dense family with a prefix hit: gather the cached prefix pages and
        run the suffix-only prefill (the prefix's compute is skipped).
        Otherwise a full (bucketed, or exact-length) prefill; shared logical
        blocks write to the trash page so cached content is never
        clobbered.
        """
        bs, p = self.block_size, req.prompt_len
        plan, table = self._plan_tables(req)
        if plan.n_shared:
            self._prefix_hits += 1
            self._shared_block_hits += plan.n_shared
        prompt = req.prompt_array()
        row = np.full((self._max_blocks,), TRASH_BLOCK, np.int32)
        row[: len(table.blocks)] = table.blocks
        # recompute at least one position so the last-token logits exist
        # even when every prompt block matched
        n_pref = min(len(plan.full_matched), (p - 1) // bs) \
            if self._suffix_capable else 0
        if n_pref > 0:
            prefix = _gather_prefix(
                self.cache["layers"], self._dev(table.blocks[:n_pref]),
                cdtype=self.model.cfg.cdtype)
            suffix = prompt[0, n_pref * bs:]
            pad = -len(suffix) % bs
            toks = np.zeros((1, len(suffix) + pad), np.int32)
            toks[0, : len(suffix)] = suffix
            logits, pre = self.model.prefill_suffix(
                self.params, {"tokens": self._dev(toks)}, prefix=prefix,
                prompt_len=p)
            kv, _ = self.model.split_prefill_cache(pre)
            write_ids = self._write_ids(table, n_pref, kv["k"].shape[2] // bs)
            _paged_write(self.cache, kv, self._dev(write_ids),
                         self._dev(row), slot, pre["pos"])
        else:
            # the prefill writes every logical block of max_len
            logits = self._full_prefill(
                prompt, self._write_ids(table, 0, self._max_blocks), row,
                slot)
        self._register_prompt_blocks(req, plan, table)
        self._tables[slot] = table
        return logits, n_pref * bs

    @staticmethod
    def _write_ids(table: _SlotTable, first_logical: int,
                   n_written: int) -> List[int]:
        """The pool page of each of ``n_written`` logical blocks a prefill
        writes from ``first_logical`` on: shared and overhang blocks go to
        the trash page."""
        return [TRASH_BLOCK if i >= len(table.blocks) or i in table.shared
                else table.blocks[i]
                for i in range(first_logical, first_logical + n_written)]

    def _apply_cow(self, slot: int) -> None:
        """First divergent write is imminent (the request enters the decode
        loop): copy the shared tail page into the reserved spare."""
        table = self._tables[slot]
        if table.cow_spare is None:
            return
        src, dst = table.blocks[table.tail_idx], table.cow_spare
        _cow_copy(self.cache, src, dst, slot, table.tail_idx)
        self._pool.free(src)
        table.blocks[table.tail_idx] = dst
        table.shared.discard(table.tail_idx)
        table.cow_spare = None
        self._cow_count += 1

    def _release_paged(self, slot: int) -> None:
        table = self._tables.pop(slot)
        for b in table.blocks:
            self._pool.free(b)
        if table.cow_spare is not None:
            self._pool.free(table.cow_spare)
        _clear_slot(self.cache, slot)

    def _full_prefill(self, prompt: np.ndarray, write_ids, row, slot: int
                      ) -> torch.Tensor:
        """The whole prompt ``(1, p)`` prefilled into ``slot``: right-padded
        to its bucket where that is exact (a graph's replay, or the eager
        body), else at its exact length (eager). ``write_ids`` and ``row``
        are the paged layout's (empty for the dense one)."""
        p = prompt.shape[1]
        if self._padded:
            toks = np.zeros((1, self.scheduler.bucket_for(p)), np.int32)
            toks[0, :p] = prompt[0]
            return self._prefill(toks, write_ids, row, slot, p)
        return self._prefill_body(self._dev(prompt), self._dev(write_ids),
                                  self._dev(row), slot, None)

    def _admit(self, slot: int, req: Request, now_s: float,
               results: List[RequestResult]) -> None:
        """Bind ``req`` to ``slot``: prefill in one shot and seed its first
        token."""
        self._admissions += 1
        if self.paged:
            logits, cached_tokens = self._paged_prefill(slot, req)
        else:
            empty = np.zeros((0,), np.int32)
            logits = self._full_prefill(req.prompt_array(), empty, empty,
                                        slot)
            cached_tokens = 0
        self._seed(slot, req, logits, now_s, cached_tokens, results)

    def _seed(self, slot: int, req: Request, logits, admitted_s: float,
              cached_tokens: int, results: List[RequestResult]) -> None:
        """Sample the first token from prefill logits and move the request
        into the decode set (or finish it on the spot)."""
        first = int(req.sampler(
            logits[:, -1], None if req.sampler.greedy else self._gen)[0])
        t_first = self._now(self._t_start)
        metrics = RequestMetrics(arrival_s=req.arrival_s,
                                 admitted_s=admitted_s,
                                 first_token_s=t_first,
                                 prompt_tokens=req.prompt_len,
                                 cached_prompt_tokens=cached_tokens)
        inf = _Inflight(request=req, slot=slot, generated=[first],
                        next_token=first, metrics=metrics)
        if first == req.eos_id or req.max_new_tokens == 1:
            self._finish(inf, t_first, results)
        else:
            if self.paged:
                self._apply_cow(slot)
            self._inflight[slot] = inf

    def _finish(self, inf: _Inflight, now_s: float,
                results: List[RequestResult]) -> None:
        """Close out a request: metrics and slot release."""
        m = inf.metrics
        m.finished_s = now_s
        m.new_tokens = len(inf.generated)
        reason = (FinishReason.EOS
                  if inf.generated[-1] == inf.request.eos_id
                  else FinishReason.LENGTH)
        results.append(RequestResult(
            uid=inf.request.uid,
            tokens=np.asarray(inf.generated, np.int32),
            prompt_len=m.prompt_tokens, slot=inf.slot,
            finish_reason=reason, metrics=m))
        if self.paged:
            self._release_paged(inf.slot)
        self.scheduler.release(inf.slot)
        self._inflight.pop(inf.slot, None)

    def _sample(self, logits, temps, greedy):
        return sample_batch(logits, self._dev(temps), self._dev(greedy),
                            self._gen).cpu().numpy()

    def _decode_tick(self, results: List[RequestResult]) -> None:
        """One batched decode step over all slots; advance active requests."""
        toks = np.zeros((self.n_slots, 1), np.int32)
        temps = np.zeros((self.n_slots,), np.float32)
        greedy = np.ones((self.n_slots,), bool)
        for slot, inf in self._inflight.items():
            toks[slot, 0] = inf.next_token
            temps[slot] = max(inf.request.sampler.temperature, 0.0)
            greedy[slot] = inf.request.sampler.greedy
        hw = self._live_blocks(1) if self.paged else 0
        next_toks = self._sample(self._decode(hw, toks)[:, -1], temps,
                                 greedy)
        self._steps += 1
        self._occupancy_sum += len(self._inflight) / self.n_slots
        if self.paged:
            self._block_occ_sum += self._pool.in_use / self.n_blocks
            self._peak_blocks = max(self._peak_blocks, self._pool.in_use)
            g, f = self._kv_bytes_tick(hw, 1)
            self._gathered_kv_bytes += g
            self._fused_kv_bytes += f
            self._kv_step_log.append((g, f))
        now = self._now(self._t_start)
        for slot in sorted(self._inflight):
            inf = self._inflight[slot]
            tok = int(next_toks[slot])
            inf.generated.append(tok)
            inf.next_token = tok
            if tok == inf.request.eos_id \
                    or len(inf.generated) >= inf.request.max_new_tokens:
                self._finish(inf, now, results)

    # ---- tick bodies (eager, or captured by the graph cache) --------------
    def _decode_body(self, tokens: torch.Tensor, hw: int) -> torch.Tensor:
        """One decode step: paged over ``hw`` live blocks, or dense-slot
        (``hw`` 0)."""
        if not self.paged:
            return self.model.decode_step(self.params, self.cache, tokens)[0]
        logits, _ = self.model.paged_decode_step(
            self.params, self.cache, tokens, live_blocks=hw)
        return logits

    def _prefill_body(self, tokens, write_ids, row, slot, prompt_len
                      ) -> torch.Tensor:
        """The full-prompt prefill of ``tokens (1, S)`` and its write into
        the cache: the paged write (:func:`_paged_write`) or the slot's row
        (:func:`_write_slot`, which takes no ``write_ids`` or ``row``).
        ``slot`` and ``prompt_len`` are Python ints, or device tensors in a
        graph; ``prompt_len`` ``None``: every token is real (the
        exact-length prefill)."""
        logits, pre = self.model.prefill(
            self.params, {"tokens": tokens}, max_len=self.max_len,
            prompt_len=prompt_len)
        if not self.paged:
            _write_slot(self.cache, pre, slot)
            return logits
        kv, _ = self.model.split_prefill_cache(pre)
        _paged_write(self.cache, kv, write_ids, row, slot, pre["pos"])
        return logits

    def _decode(self, hw: int, toks: np.ndarray) -> torch.Tensor:
        """Logits ``(n_slots, 1, V)`` of one decode step (paged: over
        ``hw`` live blocks): a graph's replay, or the eager step."""
        if self._graphs is not None:
            return self._graphs.decode(hw, toks)
        return self._decode_body(self._dev(toks), hw)

    def _prefill(self, toks: np.ndarray, write_ids: Sequence[int],
                 row: np.ndarray, slot: int, p: int) -> torch.Tensor:
        """Logits ``(1, 1, V)`` of the padded full-prompt prefill of ``toks
        (1, bucket)`` after its K/V went to ``slot``'s cache (paged: the
        pool pages ``write_ids``, and ``slot``'s table row) and its cursor
        ``p`` was installed: a graph's replay, or the eager body."""
        if self._graphs is not None:
            return self._graphs.prefill(toks, write_ids, row, slot, p)
        return self._prefill_body(self._dev(toks), self._dev(write_ids),
                                  self._dev(row), slot, p)

    # ---- warmup ------------------------------------------------------------
    def _warmup_tick(self) -> None:
        """Run every tick-critical path once with throwaway inputs before
        the engine clock starts, making the reference's warmup writes: one
        prefill per prompt bucket (padded-prefill models), written to slot
        0 (dense) or the trash page (paged), the paged CoW / release
        helpers, and one decode per live-block bucket (dense: one). One-time
        costs (kernel builds, CUDA context, library handles, allocator
        growth, graph captures) then land in ``compile_s`` instead of
        ``wall_s`` / TTFT. The writes are harmless: a dense slot's row is
        overwritten at its next admission, paged writes land on the trash
        page, and idle cursors advance as the reference's do. With CUDA
        graphs each bucket's prefill (with its write) and decode is
        captured here. Not covered: the prefix-hit gather and suffix
        prefill, and the exact-length prefill; on the card every kernel
        library is built and loaded here all the same, so their first run
        builds nothing."""
        n = self.n_slots
        if self.device.type == "cuda":
            _build.load_all()
        trash = np.full((self._max_blocks if self.paged else 0,),
                        TRASH_BLOCK, np.int32)
        if self._padded:
            for bucket in self.scheduler.buckets:
                self._prefill(np.zeros((1, bucket), np.int32), trash, trash,
                              0, bucket)
        toks0 = np.zeros((n, 1), np.int32)
        if self.paged:
            # copying page 0 onto itself and re-clearing an empty slot are
            # no-ops by construction
            _cow_copy(self.cache, TRASH_BLOCK, TRASH_BLOCK, 0, 0)
            _clear_slot(self.cache, 0)
            for hw in self._hw_buckets():
                logits = self._decode(hw, toks0)
        else:
            logits = self._decode(0, toks0)
        self._sample(logits[:, -1], np.zeros((n,), np.float32),
                     np.ones((n,), bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- public API --------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Queue a request (admitted when arrived, a slot frees up, and,
        paged, the pool can cover its worst-case block need)."""
        need = blocks_needed(request.prompt_len, request.max_new_tokens,
                             self.block_size) if self.paged else 0
        if self.paged and need > self.n_blocks:
            raise ValueError(
                f"request {request.uid}: needs {need} blocks but the "
                f"pool only has {self.n_blocks} — it could never be "
                "admitted")
        self.scheduler.submit(request)

    def reload_params(self, params) -> None:
        raise _not_ported("reload_params")

    @torch.no_grad()
    def start_run(self, *, warmup: bool = False,
                  t_origin: Optional[float] = None) -> None:
        """Reset per-run counters and start the engine clock (optionally
        after an unmeasured warmup tick, whose time is ``compile_s``)."""
        self._compile_s = 0.0
        if warmup:
            t0 = self._clock()
            self._warmup_tick()
            self._compile_s = self._clock() - t0
        self._steps = 0
        self._occupancy_sum = 0.0
        self._fast_forward_s = 0.0
        self._prefix_hits = 0
        self._shared_block_hits = 0
        self._cow_count = 0
        self._admissions = 0
        self._block_occ_sum = 0.0
        self._peak_blocks = 0
        self._gathered_kv_bytes = 0
        self._fused_kv_bytes = 0
        self._kv_step_log = []
        self._log_start = len(self.scheduler.admission_log)
        self._t_start = self._clock() if t_origin is None else t_origin

    @torch.no_grad()
    def tick(self, results: List[RequestResult]) -> None:
        """One scheduling tick: admit what arrived, then one decode step.
        Appends newly finished requests to ``results``; a no-op when the
        scheduler has no work."""
        if self.scheduler.done:
            return
        now = self._now(self._t_start)
        if not self.scheduler.active and not self.scheduler.has_ready \
                and self.scheduler.next_arrival_s > now:
            # idle: fast-forward the engine clock to the next arrival
            self._fast_forward_s += self.scheduler.next_arrival_s - now
            now = self._now(self._t_start)
        gate = self._block_gate if self.paged else None
        while True:
            # one at a time so each admission's block allocation is
            # visible to the next gate evaluation
            admitted = self.scheduler.admit_ready(now, gate=gate, limit=1)
            if not admitted:
                break
            self._admit(admitted[0][0], admitted[0][1], now, results)
        if self._inflight:
            self._decode_tick(results)

    def run(self, requests: Sequence[Request] = (),
            max_steps: Optional[int] = None, *, warmup: bool = False
            ) -> Tuple[List[RequestResult], dict]:
        """Serve until every submitted request completes; returns
        ``(results sorted by uid, report)`` — the reference's aggregate
        plus ``slot_reuse``, the ``paged`` sub-report (paged layout) and
        the ``device`` the run used. ``max_steps`` is a runaway backstop
        (default 1e6 decode ticks)."""
        self.start_run(warmup=warmup)
        for r in requests:
            self.submit(r)
        results: List[RequestResult] = []
        limit = max_steps if max_steps is not None else 1_000_000
        while not self.scheduler.done:
            self.tick(results)
            if self._steps >= limit:
                raise RuntimeError(
                    f"serve engine exceeded {limit} decode steps with "
                    f"{len(self._inflight)} requests still in flight")
        return self.finish_run(results)

    def finish_run(self, results: List[RequestResult]
                   ) -> Tuple[List[RequestResult], dict]:
        """Price the completed requests and build the run report; the
        closing half of the tick-level API."""
        wall = self._now(self._t_start)
        for r in results:
            r.metrics.moa_flops = request_decode_cost(
                self.model.cfg, prompt_tokens=r.metrics.prompt_tokens,
                new_tokens=r.metrics.new_tokens)
        report = aggregate(results, n_slots=self.n_slots,
                           decode_steps=self._steps,
                           occupancy_sum=self._occupancy_sum, wall_s=wall,
                           compile_s=self._compile_s)
        report["slot_reuse"] = self.scheduler.slot_reuse_count(
            self._log_start)
        report["arch"] = self.model.cfg.name
        report["moa"] = self.model.cfg.moa_strategy.spec
        report["scheduling"] = self.scheduling
        report["device"] = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        report["cuda_graphs"] = self._graphs is not None
        report["graphs"] = (self._graphs.report()
                            if self._graphs is not None else None)
        if not self.paged:
            results.sort(key=lambda r: r.uid)
            return results, report
        report["paged"] = paged_report(
            spec=self._spec, n_slots=self.n_slots, max_len=self.max_len,
            block_size=self.block_size, n_blocks=self.n_blocks,
            admissions=self._admissions, prefix_hits=self._prefix_hits,
            shared_block_hits=self._shared_block_hits,
            cow_count=self._cow_count,
            block_occ_sum=self._block_occ_sum, decode_steps=self._steps,
            peak_blocks=self._peak_blocks,
            attn_backend=resolve_attn_backend(self.model.cfg.attn_backend,
                                              self.device),
            gathered_kv_bytes=self._gathered_kv_bytes,
            fused_kv_bytes=self._fused_kv_bytes)
        results.sort(key=lambda r: r.uid)
        return results, report
