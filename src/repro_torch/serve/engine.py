"""Continuous-batching engine — the port of ``repro/serve/engine.py``, over
either of the reference's two cache layouts, with its speculative
decoding, chunked prefill and SLO scheduling.

One engine tick = (admit arrived requests into free slots, each through a
prefill whose K/V lands in the slot's cache) + (one prefill chunk, when a
prompt is being prefilled in chunks) + (one batched decode step over all
slots, idle ones fed token 0, or one speculative verify).

* **dense-slot** (``paged=False``, the reference's default): every slot
  owns a ``max_len`` region of the cache; an admission's prefill is copied
  into the slot's row (:func:`_write_slot`), and an idle slot's row and
  cursor stay as its last request left them, its cursor still advancing
  in plain decode.
* **paged** (``paged=True``): KV lives in a shared pool of fixed-size
  physical pages mapped through per-slot block tables
  (:mod:`repro_torch.serve.kv_pool`): requests sharing a prompt prefix
  share physical pages (ref-counted, copy-on-write at the first divergent
  write), admission needs a free slot **and** enough free blocks, and on
  the dense family a prefix-cache hit skips the shared blocks' prefill
  compute (suffix prefill).
* **speculative** (``drafter=``, :mod:`repro_torch.serve.spec`): each tick
  drafts ``k`` tokens a slot, scores them in one ``(n_slots, k + 1)``
  verify (the paged layout's on the paged-attention kernel at ``T = k +
  1``), and commits each slot's accepted prefix by advancing its cursor;
  rejection is the cursor left behind.
* **chunked prefill** (``prefill_chunk_tokens=``): a longer prompt is
  prefilled one chunk a tick through ``prefill_suffix`` (chunk 0 behind an
  empty prefix), interleaved with decode ticks; the paged slot's table row
  stays all-trash until its last chunk.
* **SLO scheduling** (``scheduling="slo"``): admission by (priority,
  earliest deadline), and a running request whose deadline is later than
  a waiting one's is preempted: its state is spilled (dense-slot: its row,
  :func:`_read_slot`; paged: its cursor, the pages staying pinned) and
  revived bit for bit later.

The families gate as the reference's do. Right-padded (bucketed) prefill,
speculative verify and chunked prefill only where exact: a capacity-limited
MoE prefills each prompt at its exact length and refuses a drafter and
chunks, since pad tokens, draft windows and chunk boundaries would compete
for expert capacity. Suffix prefill is the dense family's; a
capacity-limited MoE also keeps its prompt pages out of the prefix trie.
The SSM (mamba2) and hybrid (zamba2) families prefill at the exact length
(a recurrent state would absorb pad tokens), chunk through
``Model.prefill_chunk`` with their recurrent state carried from chunk to
chunk (chunks multiples of ``ssd_chunk``), and verify as ``k + 1``
scanned decode steps whose per-step state snapshots the commit selects
from. Their recurrent state is dense per slot in both layouts (the cache's
``ssm`` entry for the hybrid, ``layers`` for the SSM); the SSM has no K/V
and refuses the paged layout. A spill and a revive copy it with the
slot's cursor.

The host logic is the reference's, line for line, and so is every device
write an idle slot makes: a capacity-limited MoE routes the idle rows
beside the live ones, so their cursors and caches must evolve as the
reference's do. The cache tensors are updated **in place**. The
reference's compile cache becomes CUDA graphs
(:mod:`repro_torch.serve.graphs`, on by default for a CUDA engine): the
paged decode and verify are captured once per live-block bucket, the
dense-slot decode and verify once (the recurrent families' too, their
verify with its snapshot copies), and the padded full-prompt prefill with
its write into the cache once per prompt bucket; each tick replays them.
The acceptance and the commit run after a verify's replay. The prefix-hit
(suffix) prefill, the exact-length prefill, the prefill chunks, the SLO
spills and revives and a drafter's own model calls run eagerly.
``cuda_graphs=False`` runs every tick eagerly, as the yardstick: the
captured engine runs the same kernels in the same order on the same
buffers. On the GPU every projection runs the ``dot_moa`` kernel (an MoE's
expert projections one batched launch each), the MoE's top-k combine
``moa_reduce``, a full-prompt prefill's softmax·V the flash-attention
kernel and decode and verify, paged or dense-slot (the slot's cache rows
walked as pages), the paged-attention kernel; ``attn_backend="torch"``
(with a ``backend=torch`` MOA spec) runs the plain PyTorch versions
instead. No kernel's result for a row depends on the rows beside it, so
a speculative verify scores a token as the plain decode step does, bit
for bit. Every finished request is priced
(``metrics.moa_flops``) by :func:`repro_torch.launch.costing.
request_decode_cost`, or, speculative, by ``spec_request_decode_cost``
from the verify ticks it sat through, as the reference prices it.

:meth:`ServeEngine.reload_params` swaps the weights between ticks: the
engine reads the new tree (nothing is copied, so engines that share a
tree never see each other's reloads) and drops its graphs, which bound
the old tensors; they are captured again at their next tick.

**On a device mesh** (``mesh=``, a ``DeviceMesh`` with the reference's
axis names, :func:`repro_torch.launch.mesh.make_mesh`) every rank builds
the engine from the full parameter tree and keeps its own pieces
(:class:`repro_torch.serve.mesh.MeshPlacement`): the attention's heads,
the MLP's ``ff`` and the experts over ``model`` (tensor and expert
parallel, the row-parallel products summed in f32), the vocabulary over
``model`` where it divides, the slots over ``data``; the SSM and hybrid
families serve data-parallel. The model runs on the local shards with
explicit collectives (:mod:`repro_torch.parallel.collectives`); the
kernels run unchanged on local tensors. Every rank runs the same host
logic on rank 0's inputs, so all of them plan every tick alike and meet
in the same collectives: each reading of the clock is rank 0's, broadcast
over a CPU (gloo) group, and each sampled token, acceptance and first
token is the lead rank's (:attr:`MeshPlacement.lead`), assembled over the
ranks by one all-reduce, so every rank holds all slots' tokens; so are a
drafter's proposals (rank 0's). Every rank calls the same methods of
its engine in the same order (``run``, or ``start_run`` / ``tick`` /
``finish_run``), as it would any collective. A
prefill runs on every rank (its K/V lands in the pool on every rank, or
in the slot's row where the slot lives); a decode or verify runs each
rank's own slots. Refused on a mesh, with the ROADMAP item that would
add them: ``scheduling="slo"`` (a preempted slot's state would have to
move between data ranks), a model drafter other than the oracle, and
CUDA graphs on a gloo group (which cannot capture a collective) or
across a split slot axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.interop import tree_leaves, tree_paths
from repro_torch.kernels import _build
from repro_torch.launch.costing import (request_decode_cost,
                                        spec_request_decode_cost)
from repro_torch.layers.attention import (DENSE_PAGE, dequantize_kv,
                                          last_of_equal,
                                          resolve_attn_backend)
from repro_torch.models.api import Model, build_model
from repro_torch.models.verify_common import SNAP_KEY
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import activate
from repro_torch.serve import graphs
from repro_torch.serve.kv_pool import TRASH_BLOCK, BlockPool, blocks_needed
from repro_torch.serve.metrics import (RequestMetrics, aggregate,
                                       paged_report, slo_report, spec_report)
from repro_torch.serve.request import FinishReason, Request, RequestResult
from repro_torch.serve.sampling import sample_batch
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.spec import (DraftModelDrafter, Drafter,
                                    OracleDrafter, verify_accept)
from repro_torch.serve.mesh import MeshPlacement

__all__ = ["ServeEngine", "fit_max_len"]


def _walks_dense_pages(attn_backend: str, device, paged: bool,
                       drafter: Optional[Drafter]) -> bool:
    """Whether a dense-slot cache of the engine goes through the
    paged-attention kernel, walked in ``DENSE_PAGE``-token pages: the
    engine's own (``paged=False``) or a model drafter's, on the kernel
    route (CUDA). An oracle drafts with the engine's model, a draft-model
    drafter with its own."""
    routes = [] if paged else [attn_backend]
    if isinstance(drafter, OracleDrafter):
        routes.append(attn_backend)
    elif isinstance(drafter, DraftModelDrafter):
        routes.append(drafter.model.cfg.attn_backend)
    return any(resolve_attn_backend(r, device) == "kernel" for r in routes)


def fit_max_len(max_len: int, *, attn_backend: str, device,
                paged: bool = False, block_size: int = 16,
                drafter: Optional[Drafter] = None) -> int:
    """``max_len`` rounded up to a length the engine takes: whole blocks
    of a paged pool, and whole ``DENSE_PAGE`` pages of every dense-slot
    cache the paged-attention kernel walks (``attn_backend`` is the
    engine model's)."""
    step = block_size if paged else 1
    if _walks_dense_pages(attn_backend, resolve_device(device), paged,
                          drafter):
        step = math.lcm(step, DENSE_PAGE)
    return -(-max_len // step) * step


def _on_mesh(fn):
    """Run a method of the engine inside its mesh context (the model's
    collectives and the vocab-parallel sampling read it)."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with self._mesh_context():
            return fn(self, *args, **kwargs)
    return wrapped


class _LeadClock:
    """A clock whose every reading is rank 0's, broadcast over the CPU
    process group ``group``: each rank's replica of the scheduler then
    admits on the same ticks."""

    def __init__(self, clock: Callable[[], float], group):
        import torch.distributed as dist

        self._clock, self._group = clock, group
        self._lead = dist.get_rank() == 0

    def __call__(self) -> float:
        t = torch.tensor([self._clock() if self._lead else 0.0],
                         dtype=torch.float64)
        return float(collectives.broadcast(t, 0, self._group)[0])


@dataclasses.dataclass
class _Inflight:
    """Host-side state of one admitted request (device state lives in the
    engine's batched cache at ``slot``)."""

    request: Request
    slot: int
    generated: List[int]
    next_token: int
    metrics: RequestMetrics
    #: spec mode: committed context length at each verify tick this
    #: request was active (feeds the acceptance-aware pricing)
    tick_contexts: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Prefilling:
    """Host-side state of one request mid-chunked-prefill.

    The slot is scheduler-active but not yet in ``_inflight``: no token
    has been emitted. Paged: the block table is planned up front but the
    slot's installed row stays all-trash (pos 0) until the final chunk,
    so interleaved decode ticks write only to the trash page. Dense-slot:
    per-chunk suffix K/V accumulates in ``kv_parts`` and the final chunk
    writes the whole slot row at once. The SSM and hybrid families carry
    their recurrent state from chunk to chunk in ``state``.
    """

    request: Request
    slot: int
    admitted_s: float
    done: int                 # prompt tokens already consumed
    chunks: int = 0
    #: recurrent families: the carried ``{state key, "pos"}`` between chunks
    state: Optional[dict] = None
    kv_parts: List = dataclasses.field(default_factory=list)
    plan: Optional[object] = None
    table: Optional["_SlotTable"] = None
    cached_tokens: int = 0


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
    and its cursor into ``pos[slot]``: every entry of ``pre`` but ``pos``
    (``layers``; the hybrid's ``kv`` and ``ssm``) is a tree of leaves laid
    out ``(stack, batch, ...)``, cast to the cache's types (a prefill's
    conv history arrives in the compute type). ``slot`` is a Python int,
    or a CUDA graph's ``(1,)`` device tensor (then the rows are installed
    by ``index_copy_``)."""
    trees = [(cache[key], tree) for key, tree in pre.items() if key != "pos"]
    if isinstance(slot, torch.Tensor):
        idx = slot.long()
        for big, small in trees:
            for name, leaf in big.items():
                leaf.index_copy_(1, idx, small[name].to(leaf.dtype))
        cache["pos"].index_copy_(
            0, idx, torch.as_tensor(pre["pos"]).reshape(1).to(
                cache["pos"].dtype))
    else:
        for big, small in trees:
            for name, leaf in big.items():
                leaf[:, slot] = small[name][:, 0].to(leaf.dtype)
        cache["pos"][slot] = pre["pos"]


def _read_slot(cache, slot: int):
    """Exact inverse of :func:`_write_slot`: row ``slot`` of the batched
    cache (every entry but ``pos`` and the verify's snapshot buffer) as a
    batch-1 prefill-shaped tree (copies, in the cache types)."""
    out = {key: {name: leaf[:, slot:slot + 1].clone()
                 for name, leaf in tree.items()}
           for key, tree in cache.items() if key not in ("pos", SNAP_KEY)}
    out["pos"] = cache["pos"][slot].clone()
    return out


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


def _paged_write(cache, pre_kv, pre_state, write_ids, table_row, slot,
                 pre_pos, *, kv_key: str) -> None:
    """Scatter a prefill's K/V into the pool pages of ``cache[kv_key]``
    named by ``write_ids`` (one per written logical block; shared and
    overhang blocks arrive redirected to the trash page, so the ids may
    repeat: every repeat carries the last one's block, as the reference's
    sequential scatter leaves the page, since idle slots read it), write a
    hybrid's per-slot Mamba-2 states ``pre_state`` (``None``: none), then
    install the slot's block-table row and cursor.

    ``slot`` and ``pre_pos`` are Python ints, or a CUDA graph's static
    inputs: a ``(1,)`` and a 0-d int32 device tensor, installed by
    ``index_copy_`` on the device. ``slot`` ``None``: the slot lives on
    another rank of a mesh, and only the pages are written."""
    nb = write_ids.shape[0]
    last = last_of_equal(write_ids)
    for name, leaf in cache[kv_key].items():
        s = pre_kv[name][:, 0]                   # (L, S, ...)
        s = s.reshape((s.shape[0], nb, s.shape[1] // nb)
                      + tuple(s.shape[2:]))
        leaf[:, write_ids] = s[:, last].to(leaf.dtype)
    if slot is None:
        return
    if pre_state is not None:
        _write_slot(cache, {"ssm": pre_state, "pos": pre_pos}, slot)
    if isinstance(slot, torch.Tensor):
        slot = slot.long()
        cache["block_tables"].index_copy_(0, slot, table_row[None])
        cache["pos"].index_copy_(0, slot, pre_pos.reshape(1))
    else:
        cache["block_tables"][slot] = table_row
        cache["pos"][slot] = pre_pos


def _cow_copy(cache, src: int, dst: int, slot: int, logical_idx: int, *,
              kv_key: str) -> None:
    """Copy-on-write: duplicate page ``src`` into the reserved spare
    ``dst`` and repoint this slot's table entry (``slot`` ``None``: the
    slot lives on another rank), so the imminent divergent write lands on
    a private page."""
    for leaf in cache[kv_key].values():
        leaf[:, dst] = leaf[:, src]
    if slot is not None:
        cache["block_tables"][slot, logical_idx] = dst


def _clear_slot(cache, slot: int) -> None:
    """Point a freed slot's table at the trash page and rewind its cursor:
    its (masked-out) decode writes can then never corrupt pages
    reallocated to live requests."""
    cache["block_tables"][slot] = TRASH_BLOCK
    cache["pos"][slot] = 0


def _read_paged_slot(cache, slot: int, *, has_ssm: bool):
    """Snapshot a paged slot's per-slot state: its cursor and, for the
    hybrid (``has_ssm``), its Mamba-2 states. The K/V itself is not
    copied: the spilled request keeps its ref-counted pool pages pinned."""
    out = {"pos": cache["pos"][slot].clone()}
    if has_ssm:
        out["ssm"] = {name: leaf[:, slot:slot + 1].clone()
                      for name, leaf in cache["ssm"].items()}
    return out


def _restore_paged_slot(cache, snap, table_row, slot: int) -> None:
    """Revive a spilled paged request into ``slot``: reinstall its block
    table row and cursor, and any Mamba-2 states."""
    cache["block_tables"][slot] = table_row
    _write_slot(cache, snap, slot)


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
        raises; ``False`` runs every tick eagerly. On a mesh graphs need an
        NCCL group and unsplit slots; elsewhere a CUDA mesh engine raises
        unless given ``False`` (nothing falls back to eager unasked).
    device:
        Where the engine runs: the GPU unless the caller asks for the CPU
        (no GPU raises). ``params`` must already be there.
    drafter:
        A :class:`repro_torch.serve.spec.Drafter` switches the decode tick
        to speculative mode: ``drafter.k`` drafts a slot scored in one
        verify, the accepted prefix committed. Needs
        ``model.supports_spec_decode``. The scheduler reserves a ``k``-row
        margin a request, and paged admission the matching blocks.
    prefill_chunk_tokens:
        Prefill prompts longer than this in chunks of this many tokens, one
        a tick, interleaved with decode ticks (``None``: one shot). Needs
        ``model.supports_chunked_prefill``; paged, a multiple of
        ``block_size``; no int8 KV cache.
    scheduling:
        ``"fifo"`` or ``"slo"`` (admission by priority and earliest
        deadline, with preemption; not with a drafter).
    mesh, rules:
        A ``DeviceMesh`` (axes ``data``, ``model``, optionally a leading
        ``pod``) to serve on, one rank a device, every rank building the
        engine alike; ``params`` is then the full tree (on any device),
        of which the rank keeps its pieces on ``device``. ``rules``
        defaults to :func:`repro_torch.parallel.serve_rules_for` the
        family (with :func:`~repro_torch.parallel.
        replicate_uneven_kv_heads`). See the module docstring.
    """

    def __init__(self, model: Model, params, *, n_slots: int, max_len: int,
                 prompt_buckets: Sequence[int] = (), paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 drafter: Optional[Drafter] = None, mesh=None,
                 rules=None,
                 clock: Callable[[], float] = time.monotonic,
                 prefill_chunk_tokens: Optional[int] = None,
                 scheduling: str = "fifo",
                 attn_backend: Optional[str] = None,
                 device="cuda", cuda_graphs: Optional[bool] = None):
        if model.cfg.family == "encoder":
            raise ValueError("encoder-only arch has no decode step")
        if model.cfg.family == "vlm":
            raise ValueError("vlm serving is not supported: the engine "
                             "feeds token-only prompts, but vlm prefill "
                             "needs a patch batch")
        if attn_backend is not None:
            model = build_model(dataclasses.replace(
                model.cfg, attn_backend=attn_backend))
        if drafter is not None and not model.supports_spec_decode:
            raise ValueError(
                f"family {model.cfg.family!r} (cfg {model.cfg.name!r}) has "
                "no exact multi-token verify — speculative decoding needs "
                "Model.supports_spec_decode")
        if scheduling not in SlotScheduler.POLICIES:
            raise ValueError(f"unknown scheduling {scheduling!r}; expected "
                             f"one of {SlotScheduler.POLICIES}")
        if scheduling == "slo" and drafter is not None:
            raise ValueError(
                "scheduling='slo' is incompatible with speculative "
                "decoding: preemption would have to spill the drafter's "
                "per-slot state and the verify window's tentative writes")
        self._chunk = prefill_chunk_tokens
        if self._chunk is not None:
            if self._chunk < 1:
                raise ValueError("prefill_chunk_tokens must be >= 1")
            if not model.supports_chunked_prefill:
                raise ValueError(
                    f"family {model.cfg.family!r} (cfg {model.cfg.name!r}) "
                    "does not support chunked prefill "
                    "(Model.supports_chunked_prefill)")
            align = model.prefill_chunk_alignment
            if self._chunk % align:
                raise ValueError(
                    f"prefill_chunk_tokens {self._chunk} must be a multiple "
                    f"of the model's chunk alignment {align}")
            if paged and self._chunk % block_size:
                raise ValueError(
                    f"prefill_chunk_tokens {self._chunk} must be a multiple "
                    f"of block_size {block_size} so every chunk's KV lands "
                    "on whole pool pages")
            if model.cfg.kv_cache_dtype == "int8":
                raise ValueError(
                    "chunked prefill does not support int8 KV caches: "
                    "per-chunk suffix KV is quantized per chunk, which "
                    "breaks bit-exactness with the one-shot prefill scales")
        self.device = resolve_device(device)
        #: the whole model: pricing, reports and the cache's specs (on a
        #: mesh an unloaded copy, so no full tree outlives construction)
        self._full_model = model if mesh is None else build_model(model.cfg)
        self.mesh, self.rules, self._mp = mesh, None, None
        if mesh is not None:
            if scheduling == "slo":
                raise ValueError(
                    "scheduling='slo' is not served on a mesh: a preempted "
                    "slot's state would have to move between data ranks "
                    "(ROADMAP Queue 1 item 19)")
            if isinstance(drafter, DraftModelDrafter) \
                    and not isinstance(drafter, OracleDrafter):
                raise ValueError(
                    "a draft model is not served on a mesh: its own "
                    "parameters would need their own placement (ROADMAP "
                    "Queue 1 item 19); the oracle and ngram drafters are")
            self._mp = MeshPlacement(mesh, model, rules, n_slots=n_slots)
            self.rules = self._mp.rules
            params = self._mp.local_params(params, self.device)
            model = self._mp.local_model
            clock = _LeadClock(clock, self._cpu_group())
        #: the global slots whose rows this rank's cache holds
        self._lo, self._hi = self._mp.rows if self._mp else (0, n_slots)
        self._n_rows = self._hi - self._lo
        for path, leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(
                    f"parameter {path} is on {leaf.device}, the engine runs "
                    f"on {self.device}")
        # resolve now: a 'kernel' request on the CPU fails at construction
        resolve_attn_backend(model.cfg.attn_backend, self.device)
        if _walks_dense_pages(model.cfg.attn_backend, self.device, paged,
                              drafter):
            if max_len % DENSE_PAGE:
                raise ValueError(
                    f"max_len {max_len}: the paged-attention kernel walks "
                    f"a dense-slot cache in pages of {DENSE_PAGE} tokens, "
                    "so max_len must be a multiple (fit_max_len rounds it "
                    "up)")
            if paged and isinstance(drafter, OracleDrafter) \
                    and block_size != DENSE_PAGE:
                raise ValueError(
                    f"an oracle drafter walks its dense-slot cache in pages "
                    f"of {DENSE_PAGE} tokens; it shares the target's "
                    f"arithmetic only over a pool of {DENSE_PAGE}-token "
                    f"blocks, not {block_size}")
        self.model = model
        self.params = params
        #: the cache keys of the K/V stacks and of the recurrent state
        self._kv_key, self._state_key = model.kv_key, model.state_key
        self.n_slots = n_slots
        self.max_len = max_len
        self.drafter = drafter
        self.spec_k = drafter.k if drafter is not None else 0
        self.scheduling = scheduling
        self.scheduler = SlotScheduler(n_slots, max_len,
                                       [b for b in prompt_buckets
                                        if b <= max_len],
                                       spec_margin=self.spec_k,
                                       policy=scheduling, clock=clock)
        self._clock = clock
        self._gen = generator if generator is not None \
            else torch.Generator(device=self.device).manual_seed(0)
        self._padded = model.supports_padded_prefill
        self.paged = paged
        if paged:
            self._init_paged(block_size, n_blocks)
        else:
            self.cache = model.init_cache(self._n_rows, max_len,
                                          device=self.device)
            self.cache["pos"] = torch.zeros((self._n_rows,),
                                            dtype=torch.int32,
                                            device=self.device)
        #: each cache leaf's spec on the mesh (``None`` off a mesh)
        self.cache_specs = None
        if self._mp is not None:
            self.cache_specs = self._mp.check_local(
                self._full_cache(), self.cache, paged=paged)
        self._graphs = self._init_graphs(cuda_graphs)

        self._inflight: Dict[int, _Inflight] = {}
        #: slot -> mid-chunked-prefill request state
        self._prefilling: Dict[int, _Prefilling] = {}
        #: uid -> spilled (preempted) request record awaiting revival
        self._spilled: Dict[int, dict] = {}
        self._preemptions = 0
        self._spills = 0
        self._revivals = 0
        self._chunk_ticks = 0
        self._admissions = 0
        self._steps = 0
        self._occupancy_sum = 0.0
        self._fast_forward_s = 0.0
        # set here so preempt() works before the first run
        self._t_start = self._clock()
        self._compile_s = 0.0
        self._log_start = 0
        self._spec_ticks = 0
        self._spec_emitted = 0
        self._spec_slot_steps = 0.0
        self._accept_hist = [0] * (self.spec_k + 1)
        self._draft_steps_start = 0
        self._tick_contexts: Dict[int, List[int]] = {}
        if drafter is not None:
            drafter.bind(self)

    # ---- paged setup -------------------------------------------------------
    def _init_paged(self, block_size: int, n_blocks: Optional[int]) -> None:
        if not self.model.cache_spec().pageable:
            raise ValueError(
                f"family {self.model.cfg.family!r} has no KV cache to page "
                "— its decode state is constant-size per slot")
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
        self._spec = self._full_model.cache_spec()
        # physical pages: pool blocks 1..n plus the id-0 trash page
        self.cache = self.model.init_paged_cache(
            self._n_rows, self.n_blocks + 1, block_size, self._max_blocks,
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

    def _full_cache(self):
        """The whole mesh's cache as ``meta`` tensors (its specs' shapes)."""
        meta = torch.device("meta")
        if self.paged:
            return self._full_model.init_paged_cache(
                self.n_slots, self.n_blocks + 1, self.block_size,
                self._max_blocks, device=meta)
        cache = self._full_model.init_cache(self.n_slots, self.max_len,
                                            device=meta)
        cache["pos"] = torch.zeros((self.n_slots,), dtype=torch.int32,
                                   device=meta)
        return cache

    @staticmethod
    def _cpu_group():
        """A process group that carries CPU tensors: the world's if it is
        gloo, else a new gloo group."""
        import torch.distributed as dist

        if dist.get_backend() == "gloo":
            return None
        return dist.new_group(backend="gloo")

    def _mesh_context(self):
        if self._mp is None:
            return contextlib.nullcontext()
        return activate(self.mesh, self.rules, self._mp.shard)

    def _init_graphs(self, cuda_graphs: Optional[bool]
                     ) -> Optional[graphs.GraphCache]:
        if cuda_graphs is None:
            cuda_graphs = graphs.API.supports(self.device)
        elif cuda_graphs and not graphs.API.supports(self.device):
            raise ValueError(f"cuda_graphs=True needs a CUDA engine; this "
                             f"one runs on {self.device}")
        if cuda_graphs and self._mp is not None:
            import torch.distributed as dist

            backend = dist.get_backend()
            if backend != "nccl":
                raise ValueError(
                    f"cuda_graphs on a mesh needs collectives a CUDA graph "
                    f"can capture (nccl); this mesh's process group is "
                    f"{backend!r}: pass cuda_graphs=False")
            if self._n_rows != self.n_slots:
                raise ValueError(
                    "cuda_graphs across a split slot axis are not ported "
                    "(ROADMAP Queue 1 item 19): pass cuda_graphs=False")
        if not cuda_graphs:
            return None
        return graphs.GraphCache(
            self._decode_body, self._prefill_body, self._verify_body,
            n_slots=self.n_slots,
            max_blocks=self._max_blocks if self.paged else 0,
            max_bucket=max(self.scheduler.buckets), window=self.spec_k + 1,
            device=self.device)

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
        worst-case lifetime (prefix hits count as free; spec mode adds the
        verify window's margin)."""
        return self._pool.can_admit(req.prompt,
                                    req.max_new_tokens + self.spec_k,
                                    match_tail=self._match_tail)

    def _plan_tables(self, req: Request):
        """Reserve pool pages for one admission: share matched prefix
        pages, allocate the rest (plus the CoW spare for a matched tail),
        and build the slot's logical→physical table. In spec mode the plan
        covers ``spec_k`` rows past the worst-case length, so every
        tentative verify write lands on a slot-private page."""
        pool = self._pool
        plan = pool.plan(req.prompt, req.max_new_tokens + self.spec_k,
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
                self.cache[self._kv_key], self._dev(table.blocks[:n_pref]),
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
            _paged_write(self.cache, kv, None, self._dev(write_ids),
                         self._dev(row), self._row(slot), pre["pos"],
                         kv_key=self._kv_key)
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
        _cow_copy(self.cache, src, dst, self._row(slot), table.tail_idx,
                  kv_key=self._kv_key)
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
        self._clear(slot)

    def _row(self, slot):
        """Slot ``slot``'s row in this rank's cache, or ``None`` where it
        lives on another rank (a graph's device tensor passes through: a
        graph never serves a split slot axis)."""
        if isinstance(slot, torch.Tensor):
            return slot
        row = slot - self._lo
        return row if 0 <= row < self._n_rows else None

    def _install(self, pre, slot: int) -> None:
        """:func:`_write_slot` where the slot lives on this rank."""
        row = self._row(slot)
        if row is not None:
            _write_slot(self.cache, pre, row)

    def _clear(self, slot: int) -> None:
        """:func:`_clear_slot` where the slot lives on this rank."""
        row = self._row(slot)
        if row is not None:
            _clear_slot(self.cache, row)

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

    def _admission_gate(self, req: Request) -> bool:
        """Paged admission gate: a spilled request already holds its
        worst-case block reservation (revival allocates nothing); a fresh
        one must fit the pool."""
        return req.uid in self._spilled or self._block_gate(req)

    def _admit(self, slot: int, req: Request, now_s: float,
               results: List[RequestResult]) -> None:
        """Bind ``req`` to ``slot``: revive it if a preemption spilled it,
        start a chunked prefill if its prompt exceeds the chunk budget,
        else prefill in one shot and seed its first token."""
        if req.uid in self._spilled:
            self._revive(slot, req)
            return
        if self._chunk is not None and req.prompt_len > self._chunk:
            self._begin_chunked(slot, req, now_s)
            return
        self._admissions += 1
        if self.paged:
            logits, cached_tokens = self._paged_prefill(slot, req)
        else:
            empty = np.zeros((0,), np.int32)
            logits = self._full_prefill(req.prompt_array(), empty, empty,
                                        slot)
            cached_tokens = 0
        if self.drafter is not None:
            self.drafter.admit(slot, req.prompt)
        self._seed(slot, req, logits, now_s, cached_tokens, 1, results)

    def _seed(self, slot: int, req: Request, logits, admitted_s: float,
              cached_tokens: int, chunks: int,
              results: List[RequestResult]) -> None:
        """Sample the first token from prefill logits and move the request
        into the decode set (or finish it on the spot)."""
        first = int(self._from_lead(req.sampler(
            logits[:, -1], None if req.sampler.greedy else self._gen))[0])
        t_first = self._now(self._t_start)
        metrics = RequestMetrics(arrival_s=req.arrival_s,
                                 admitted_s=admitted_s,
                                 first_token_s=t_first,
                                 prompt_tokens=req.prompt_len,
                                 cached_prompt_tokens=cached_tokens,
                                 deadline_s=req.deadline_s,
                                 prefill_chunks=chunks)
        inf = _Inflight(request=req, slot=slot, generated=[first],
                        next_token=first, metrics=metrics)
        if first == req.eos_id or req.max_new_tokens == 1:
            self._finish(inf, t_first, results)
        else:
            if self.paged:
                self._apply_cow(slot)
            self._inflight[slot] = inf

    # ---- chunked prefill ---------------------------------------------------
    def _begin_chunked(self, slot: int, req: Request, now_s: float) -> None:
        """Open a chunked prefill: paged, reserve the blocks up front (the
        slot's installed table row stays all-trash until the final chunk)
        and start past a prefix-cache hit's matched blocks; seed a
        recurrent family's carried state with zeros."""
        self._admissions += 1
        pf = _Prefilling(request=req, slot=slot, admitted_s=now_s, done=0)
        if self.paged:
            plan, table = self._plan_tables(req)
            if plan.n_shared:
                self._prefix_hits += 1
                self._shared_block_hits += plan.n_shared
            pf.plan, pf.table = plan, table
            if self._suffix_capable:
                # as the one-shot suffix path: at least one position is
                # recomputed
                n_pref = min(len(plan.full_matched),
                             (req.prompt_len - 1) // self.block_size)
                pf.done = pf.cached_tokens = n_pref * self.block_size
        if self._state_key is not None:
            one = self.model.init_cache(1, self.max_len, device=self.device)
            pf.state = {self._state_key: one[self._state_key],
                        "pos": torch.zeros((), dtype=torch.int32,
                                           device=self.device)}
        self._prefilling[slot] = pf

    def _empty_prefix(self):
        """Zero-length prefix K/V: chunk 0 of a chunked prefill is a suffix
        prefill (the hybrid's: a chunk) with nothing in front."""
        kv = self.cache[self._kv_key]
        return {name: torch.zeros(
            (kv[name].shape[0], 1, 0) + tuple(kv[name].shape[3:]),
            dtype=self.model.cfg.cdtype, device=self.device)
            for name in ("k", "v")}

    def _chunk_prefix_kv(self, pf: _Prefilling):
        """Dense K/V over the first ``pf.done`` prompt tokens, feeding the
        next chunk's suffix prefill: paged, gathered back from the pages
        this prefill wrote; dense-slot, the accumulated parts, merged."""
        if pf.done == 0:
            return self._empty_prefix()
        if self.paged:
            ids = pf.table.blocks[: pf.done // self.block_size]
            return _gather_prefix(self.cache[self._kv_key], self._dev(ids),
                                  cdtype=self.model.cfg.cdtype)
        if len(pf.kv_parts) > 1:
            pf.kv_parts = [{name: torch.cat([part[name]
                                             for part in pf.kv_parts], dim=2)
                            for name in pf.kv_parts[0]}]
        return pf.kv_parts[0]

    def _store_chunk_kv(self, pf: _Prefilling, kv, final: bool, state_final,
                        slot: int) -> None:
        """Bank one chunk's suffix K/V. Paged: scatter it onto this chunk's
        pool pages now (shared and overhang blocks to the trash page, rows
        zero-padded to whole pages) and install the real table row and
        cursor, and a hybrid's Mamba-2 states ``state_final``, only with
        the final chunk. Dense-slot: keep it, and write the whole slot row
        at the final chunk. Rows past the prompt are masked by ``pos`` until
        decode overwrites them."""
        p = pf.request.prompt_len
        if self.paged:
            bs = self.block_size
            pad_rows = -kv["k"].shape[2] % bs
            if pad_rows:
                kv = {name: torch.nn.functional.pad(
                    x, (0, 0) * (x.dim() - 3) + (0, pad_rows))
                    for name, x in kv.items()}
            n_written = kv["k"].shape[2] // bs
            table = pf.table
            write_ids = self._write_ids(table, pf.done // bs, n_written)
            row = np.full((self._max_blocks,), TRASH_BLOCK, np.int32)
            if final:
                row[: len(table.blocks)] = table.blocks
            _paged_write(self.cache, kv, state_final, self._dev(write_ids),
                         self._dev(row), self._row(slot), p if final else 0,
                         kv_key=self._kv_key)
            return
        pf.kv_parts.append(kv)
        if final:
            merged = self._chunk_prefix_kv(pf)
            pad_rows = self.max_len - merged["k"].shape[2]
            merged = {name: torch.nn.functional.pad(
                x, (0, 0) * (x.dim() - 3) + (0, pad_rows))
                for name, x in merged.items()}
            pre = {self._kv_key: merged, "pos": p}
            if state_final is not None:
                pre["ssm"] = state_final
            self._install(pre, slot)

    def _prefill_tick(self, results: List[RequestResult]) -> None:
        """Advance the lowest-numbered prefilling slot by one chunk; the
        final chunk installs the slot's cache state and seeds the first
        token as a one-shot admission does."""
        slot = min(self._prefilling)
        pf = self._prefilling[slot]
        req = pf.request
        p = req.prompt_len
        take = min(self._chunk, p - pf.done)
        end = pf.done + take
        final = end >= p
        pf.chunks += 1
        self._chunk_ticks += 1
        toks = {"tokens": self._dev(
            np.asarray(req.prompt[pf.done:end], np.int32)[None, :])}
        family = self.model.cfg.family
        if family == "ssm":
            logits, pf.state = self.model.prefill_chunk(self.params, toks,
                                                        state=pf.state)
            if final:      # the carried state is the prefill cache
                self._install(pf.state, slot)
        elif family == "hybrid":
            logits, out = self.model.prefill_chunk(
                self.params, toks, state=pf.state,
                prefix_kv=self._chunk_prefix_kv(pf))
            pf.state = {"ssm": out["ssm"], "pos": out["pos"]}
            self._store_chunk_kv(pf, out["kv"], final,
                                 out["ssm"] if final else None, slot)
        else:
            logits, pre = self.model.prefill_suffix(
                self.params, toks, prefix=self._chunk_prefix_kv(pf),
                prompt_len=end)
            self._store_chunk_kv(pf, pre["layers"], final, None, slot)
        pf.done = end
        if final:
            self._prefilling.pop(slot)
            if self.paged:
                self._register_prompt_blocks(req, pf.plan, pf.table)
                self._tables[slot] = pf.table
            if self.drafter is not None:
                self.drafter.admit(slot, req.prompt)
            self._seed(slot, req, logits, pf.admitted_s, pf.cached_tokens,
                       pf.chunks, results)

    # ---- preemption --------------------------------------------------------
    def preempt(self, slot: int) -> None:
        """Spill the request in ``slot`` and return it to the ready queue.

        A decoding request's device state is snapshotted (dense-slot: the
        slot's row; paged: its cursor, its pool pages staying pinned under
        their refcounts) and revived bit for bit at its next admission. A
        mid-prefill request discards its progress and frees its pages: no
        token was emitted yet, so it restarts from scratch. Not on a
        mesh (its state would have to move between data ranks)."""
        if self._mp is not None:
            raise ValueError("preemption is not served on a mesh (ROADMAP "
                             "Queue 1 item 19)")
        now = self._now(self._t_start)
        if slot in self._inflight:
            inf = self._inflight.pop(slot)
            inf.metrics.preempted += 1
            rec = {"request": inf.request, "generated": inf.generated,
                   "next_token": inf.next_token, "metrics": inf.metrics}
            if self.paged:
                rec["snap"] = _read_paged_slot(
                    self.cache, slot, has_ssm=self._state_key is not None)
                rec["table"] = self._tables.pop(slot)
                _clear_slot(self.cache, slot)
            else:
                rec["snap"] = _read_slot(self.cache, slot)
            self._spilled[inf.request.uid] = rec
            self._spills += 1
        elif slot in self._prefilling:
            pf = self._prefilling.pop(slot)
            if self.paged:
                for b in pf.table.blocks:
                    self._pool.free(b)
                if pf.table.cow_spare is not None:
                    self._pool.free(pf.table.cow_spare)
                _clear_slot(self.cache, slot)
        else:
            raise KeyError(f"slot {slot} has no preemptible request")
        self.scheduler.preempt(slot, now)
        self._preemptions += 1

    def _revive(self, slot: int, req: Request) -> None:
        """Reinstall a spilled request into ``slot`` and resume decoding
        where it left off (its TTFT was banked at its first admission)."""
        rec = self._spilled.pop(req.uid)
        if self.paged:
            table = rec["table"]
            row = np.full((self._max_blocks,), TRASH_BLOCK, np.int32)
            row[: len(table.blocks)] = table.blocks
            _restore_paged_slot(self.cache, rec["snap"], self._dev(row), slot)
            self._tables[slot] = table
        else:
            _write_slot(self.cache, rec["snap"], slot)
        self._inflight[slot] = _Inflight(
            request=req, slot=slot, generated=rec["generated"],
            next_token=rec["next_token"], metrics=rec["metrics"])
        self._revivals += 1

    def _maybe_preempt(self, now_s: float) -> None:
        """SLO policy: when no slot is free and the best waiting request
        strictly outranks the worst running one, preempt the latter, at
        most one preemption a tick (the strict rank and the uid tiebreak
        keep a pair from thrashing)."""
        if self.scheduler.has_free or not self._inflight:
            return
        cand = self.scheduler.ready_head(now_s)
        if cand is None:
            return
        if self.paged and not self._admission_gate(cand):
            return   # freeing a slot would not make the candidate fit

        def rank(r):
            return (-r.priority,
                    r.deadline_s if r.deadline_s is not None
                    else float("inf"))

        cand_rank = rank(cand)
        victims = [(rank(inf.request), inf.request.uid, s)
                   for s, inf in self._inflight.items()
                   if rank(inf.request) > cand_rank]
        if not victims:
            return
        self.preempt(max(victims)[2])

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
        if self.drafter is not None:
            self.drafter.release(inf.slot)
            self._tick_contexts[inf.request.uid] = inf.tick_contexts
        self.scheduler.release(inf.slot)
        self._inflight.pop(inf.slot, None)

    def _from_lead(self, x: torch.Tensor, *, rows: bool = False
                   ) -> torch.Tensor:
        """Rank 0's ``x`` on every rank of a mesh (one sum all-reduce over
        the world, which only the lead contributes to); ``rows``: ``x`` is
        this rank's ``(n_rows, ...)`` rows of the slots, and the result
        every slot's, each slot's rows from the lead rank of its data
        index. The identity off a mesh."""
        if self._mp is None:
            return x
        import torch.distributed as dist

        mp = self._mp
        pieces, idx = (mp.slot_ways, mp.slot_index) if rows else (1, 0)
        buf = torch.zeros((pieces,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        if mp.lead if rows else dist.get_rank() == 0:
            buf[idx] = x
        collectives.all_reduce(buf)
        return buf.reshape((-1,) + tuple(x.shape[1:])) if rows else buf[0]

    def _local(self, a: np.ndarray) -> np.ndarray:
        """This rank's rows of a per-slot host array."""
        return a[self._lo:self._hi]

    def _sample(self, logits, temps, greedy):
        greedy = self._local(greedy)
        return self._from_lead(sample_batch(
            logits, self._dev(self._local(temps)), self._dev(greedy),
            self._gen, all_greedy=bool(greedy.all())),
            rows=True).cpu().numpy()

    def _count_step(self, hw: int, window: int) -> None:
        """The run counters of one decode or verify step of ``window`` rows
        a slot (paged: over ``hw`` live blocks)."""
        self._steps += 1
        self._occupancy_sum += len(self._inflight) / self.n_slots
        if self.paged:
            self._block_occ_sum += self._pool.in_use / self.n_blocks
            self._peak_blocks = max(self._peak_blocks, self._pool.in_use)
            g, f = self._kv_bytes_tick(hw, window)
            self._gathered_kv_bytes += g
            self._fused_kv_bytes += f
            self._kv_step_log.append((g, f))

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
        self._count_step(hw, 1)
        now = self._now(self._t_start)
        for slot in sorted(self._inflight):
            inf = self._inflight[slot]
            tok = int(next_toks[slot])
            inf.generated.append(tok)
            inf.next_token = tok
            if tok == inf.request.eos_id \
                    or len(inf.generated) >= inf.request.max_new_tokens:
                self._finish(inf, now, results)

    def _accept(self, logits, draft, temps, greedy):
        """The acceptance of one verify (:func:`repro_torch.serve.spec.
        verify_accept`) on the host: ``(out (n_slots, k+1), n_acc)``."""
        greedy = self._local(greedy)
        out, n_acc = verify_accept(
            logits, self._dev(self._local(draft)),
            self._dev(self._local(temps)), self._dev(greedy), self._gen,
            all_greedy=bool(greedy.all()))
        both = self._from_lead(torch.cat([out, n_acc[:, None]], dim=1),
                               rows=True).cpu().numpy()
        return both[:, :-1], both[:, -1]

    def _spec_tick(self, results: List[RequestResult]) -> None:
        """One speculative tick: draft → verify → accept → commit.

        The drafter proposes ``k`` tokens a live slot; one verify scores
        the pending token and the window, writing all ``k + 1`` K/V rows
        tentatively; the acceptance picks each slot's accepted prefix; the
        commit advances each slot's cursor by ``accepted + 1`` (0 for idle
        slots), which is the rejection's rollback. Each slot emits
        ``accepted + 1`` tokens, the last its pending next token."""
        k = self.spec_k
        histories = {slot: tuple(inf.request.prompt) + tuple(inf.generated)
                     for slot, inf in self._inflight.items()}
        proposals = self.drafter.propose(histories)
        if self._mp is not None:     # rank 0's drafts on every rank
            drafts = np.zeros((self.n_slots, k), np.int32)
            for slot, d in proposals.items():
                drafts[slot] = d
            drafts = self._from_lead(self._dev(drafts)).cpu().numpy()
            proposals = {slot: drafts[slot] for slot in proposals}
        toks = np.zeros((self.n_slots, k + 1), np.int32)
        temps = np.zeros((self.n_slots,), np.float32)
        greedy = np.ones((self.n_slots,), bool)
        for slot, inf in self._inflight.items():
            toks[slot, 0] = inf.next_token
            toks[slot, 1:] = proposals[slot]
            temps[slot] = max(inf.request.sampler.temperature, 0.0)
            greedy[slot] = inf.request.sampler.greedy
        hw = self._live_blocks(k + 1) if self.paged else 0
        out, n_acc = self._accept(self._verify(hw, toks), toks[:, 1:], temps,
                                  greedy)
        keep = np.zeros((self.n_slots,), np.int32)
        for slot in self._inflight:
            keep[slot] = n_acc[slot] + 1
        self.model.commit_verified(self.cache, self._dev(self._local(keep)),
                                   None)
        self._spec_ticks += 1
        self._spec_slot_steps += len(self._inflight)
        self._count_step(hw, k + 1)
        now = self._now(self._t_start)
        for slot in sorted(self._inflight):
            inf = self._inflight[slot]
            inf.tick_contexts.append(
                inf.request.prompt_len + len(inf.generated) - 1)
            accepted = int(n_acc[slot])
            self._accept_hist[accepted] += 1
            done = False
            for tok in out[slot, : accepted + 1]:
                tok = int(tok)
                inf.generated.append(tok)
                inf.next_token = tok
                self._spec_emitted += 1
                if tok == inf.request.eos_id \
                        or len(inf.generated) >= inf.request.max_new_tokens:
                    done = True
                    break
            if done:
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

    def _verify_body(self, tokens: torch.Tensor, hw: int) -> torch.Tensor:
        """One verify of ``tokens (n_slots, k + 1)``: paged over ``hw``
        live blocks, or dense-slot (``hw`` 0). The cursors stay; the
        commit follows the acceptance."""
        if not self.paged:
            return self.model.verify_step(self.params, self.cache, tokens)[0]
        return self.model.paged_verify_step(self.params, self.cache, tokens,
                                            live_blocks=hw)[0]

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
            self._install(pre, slot)
            return logits
        kv, state = self.model.split_prefill_cache(pre)
        _paged_write(self.cache, kv, state, write_ids, row, self._row(slot),
                     pre["pos"], kv_key=self._kv_key)
        return logits

    def _decode(self, hw: int, toks: np.ndarray) -> torch.Tensor:
        """Logits ``(n_slots, 1, V)`` of one decode step (paged: over
        ``hw`` live blocks): a graph's replay, or the eager step. On a
        mesh: this rank's slots and slice of the vocabulary."""
        toks = self._local(toks)
        if self._graphs is not None:
            return self._graphs.decode(hw, toks)
        return self._decode_body(self._dev(toks), hw)

    def _verify(self, hw: int, toks: np.ndarray) -> torch.Tensor:
        """Logits ``(n_slots, k + 1, V)`` of one verify (paged: over ``hw``
        live blocks): a graph's replay, or the eager body."""
        toks = self._local(toks)
        if self._graphs is not None:
            return self._graphs.verify(hw, toks)
        return self._verify_body(self._dev(toks), hw)

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
        helpers, and one decode per live-block bucket (dense: one), or in
        spec mode one verify per bucket, each committed with ``keep`` 0.
        One-time costs (kernel builds, CUDA context, library handles,
        allocator growth, graph captures) then land in ``compile_s``
        instead of ``wall_s`` / TTFT. The writes are harmless: a dense
        slot's row is overwritten at its next admission, paged writes land
        on the trash page, idle cursors advance as the reference's do, and
        a verify's rows lie past cursors it leaves in place. With CUDA
        graphs each bucket's prefill (with its write), decode or verify is
        captured here. Not covered: the prefix-hit gather and suffix
        prefill, the exact-length prefill, the prefill chunks and a
        drafter's model calls; on the card every kernel library is built
        and loaded here all the same, so their first run builds nothing."""
        n = self.n_slots
        if self.device.type == "cuda":
            _build.load_all()
        trash = np.full((self._max_blocks if self.paged else 0,),
                        TRASH_BLOCK, np.int32)
        if self._padded:
            for bucket in self.scheduler.buckets:
                self._prefill(np.zeros((1, bucket), np.int32), trash, trash,
                              0, bucket)
        if self.paged:
            # copying page 0 onto itself and re-clearing an empty slot are
            # no-ops by construction
            _cow_copy(self.cache, TRASH_BLOCK, TRASH_BLOCK, self._row(0), 0,
                      kv_key=self._kv_key)
            self._clear(0)
        buckets = self._hw_buckets() if self.paged else [0]
        greedy = np.ones((n,), bool)
        zeros = np.zeros((n,), np.float32)
        if self.drafter is not None:
            toks = np.zeros((n, self.spec_k + 1), np.int32)
            keep0 = self._dev(np.zeros((self._n_rows,), np.int32))
            for hw in buckets:
                logits = self._verify(hw, toks)
                self.model.commit_verified(self.cache, keep0, None)
            self._accept(logits, toks[:, 1:], zeros, greedy)
        else:
            toks0 = np.zeros((n, 1), np.int32)
            for hw in buckets:
                logits = self._decode(hw, toks0)
            self._sample(logits[:, -1], zeros, greedy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- public API --------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Queue a request (admitted when arrived, a slot frees up, and,
        paged, the pool can cover its worst-case block need)."""
        if self.paged:
            need = blocks_needed(request.prompt_len,
                                 request.max_new_tokens + self.spec_k,
                                 self.block_size)
            if need > self.n_blocks:
                raise ValueError(
                    f"request {request.uid}: needs {need} blocks but the "
                    f"pool only has {self.n_blocks} — it could never be "
                    "admitted")
        self.scheduler.submit(request)

    @torch.no_grad()
    def reload_params(self, params) -> None:
        """Swap the weight tree between ticks (live reload).

        The new tree must match the current one's structure, shapes and
        dtypes (the reference's checks and errors; leaves are numbered in
        sorted-key order, as ``jax.tree_util`` flattens a dict), and lie on
        the engine's device. The engine then reads the new tree, as the
        reference's swaps its reference: nothing is copied and no tensor
        is written, so a tree shared with other engines (a replica fleet's
        factory shares one) stays theirs unchanged. The captured graphs
        bound the old tensors, so every one is dropped first (after the
        device has finished its replays) and captured again at its next
        call. An oracle drafter that drafts with the engine's weights
        follows them. A paged engine forgets its prefix cache
        (:meth:`BlockPool.forget_cached`): its pages hold K/V of the old
        weights, which the reference's engine would go on matching, so a
        request admitted after a reload prefills under the new weights
        alone. In-flight slots keep decoding, now against the new weights;
        callers that need every generation pinned to one weight version
        (the replica router's rolling reload) drain the engine first. On
        a mesh ``params`` is the full tree, of which the engine keeps this
        rank's pieces, as at construction."""
        if self._mp is not None:
            params = self._mp.local_params(params, self.device)
        old, new = tree_paths(self.params), tree_paths(params)
        if list(old) != list(new):
            raise ValueError(
                "reload_params: new weight tree structure differs from the "
                f"serving one ({sorted(new)} vs {sorted(old)})")
        for i, (key, cur) in enumerate(old.items()):
            leaf = new[key]
            if (tuple(cur.shape) != tuple(leaf.shape)
                    or cur.dtype != leaf.dtype):
                raise ValueError(
                    f"reload_params: leaf {i} changed layout "
                    f"({tuple(leaf.shape)}/{leaf.dtype} vs "
                    f"{tuple(cur.shape)}/{cur.dtype}) — a reload may not "
                    "change the architecture")
            if leaf.device != self.device:
                raise ValueError(
                    f"reload_params: leaf {key} is on {leaf.device}, the "
                    f"engine runs on {self.device}")
        if self.paged:   # cached pages hold K/V of the old weights
            self._pool.forget_cached()
        if self._graphs is not None:
            if self.device.type == "cuda":   # no replay still reads them
                torch.cuda.synchronize(self.device)
            self._graphs.drop()
        if self.drafter is not None \
                and getattr(self.drafter, "params", None) is self.params:
            self.drafter.params = params
        self.params = params

    @torch.no_grad()
    @_on_mesh
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
        if self.drafter is not None:
            self._spec_ticks = 0
            self._spec_emitted = 0
            self._spec_slot_steps = 0.0
            self._accept_hist = [0] * (self.spec_k + 1)
            self._draft_steps_start = self.drafter.draft_steps
            self._tick_contexts = {}
        self._prefix_hits = 0
        self._shared_block_hits = 0
        self._cow_count = 0
        self._admissions = 0
        self._block_occ_sum = 0.0
        self._peak_blocks = 0
        self._gathered_kv_bytes = 0
        self._fused_kv_bytes = 0
        self._kv_step_log = []
        self._preemptions = 0
        self._spills = 0
        self._revivals = 0
        self._chunk_ticks = 0
        self._log_start = len(self.scheduler.admission_log)
        self._t_start = self._clock() if t_origin is None else t_origin

    @torch.no_grad()
    @_on_mesh
    def tick(self, results: List[RequestResult]) -> None:
        """One scheduling tick: (SLO: one preemption at most), admit what
        arrived, one prefill chunk, one decode or verify step. Appends
        newly finished requests to ``results``; a no-op when the scheduler
        has no work."""
        if self.scheduler.done:
            return
        now = self._now(self._t_start)
        if not self.scheduler.active and not self.scheduler.has_ready \
                and self.scheduler.next_arrival_s > now:
            # idle: fast-forward the engine clock to the next arrival
            self._fast_forward_s += self.scheduler.next_arrival_s - now
            now = self._now(self._t_start)
        if self.scheduling == "slo":
            self._maybe_preempt(now)
        gate = self._admission_gate if self.paged else None
        while True:
            # one at a time so each admission's block allocation is
            # visible to the next gate evaluation
            admitted = self.scheduler.admit_ready(now, gate=gate, limit=1)
            if not admitted:
                break
            self._admit(admitted[0][0], admitted[0][1], now, results)
        if self.paged and not self._inflight and not self._prefilling \
                and self._spilled:
            # stall escape: every runnable request is spilled but the gate
            # vetoes the (fresh) ready head; a spilled one holds its
            # reservation, so it always fits
            got = self.scheduler.admit_revivable(now, set(self._spilled))
            if got is not None:
                self._admit(got[0], got[1], now, results)
        if self._prefilling:
            self._prefill_tick(results)
        if self._inflight:
            if self.drafter is not None:
                self._spec_tick(results)
            else:
                self._decode_tick(results)

    def run(self, requests: Sequence[Request] = (),
            max_steps: Optional[int] = None, *, warmup: bool = False
            ) -> Tuple[List[RequestResult], dict]:
        """Serve until every submitted request completes; returns
        ``(results sorted by uid, report)`` — the reference's aggregate
        plus ``slot_reuse``, the ``paged``, ``spec`` and ``slo``
        sub-reports where they apply, and the ``device`` the run used.
        ``max_steps`` is a runaway backstop (default 1e6 decode ticks and
        prefill chunks)."""
        self.start_run(warmup=warmup)
        for r in requests:
            self.submit(r)
        results: List[RequestResult] = []
        limit = max_steps if max_steps is not None else 1_000_000
        while not self.scheduler.done:
            self.tick(results)
            if self._steps + self._chunk_ticks >= limit:
                raise RuntimeError(
                    f"serve engine exceeded {limit} decode steps with "
                    f"{len(self._inflight)} requests still in flight")
        return self.finish_run(results)

    def mesh_report(self) -> Optional[dict]:
        """The mesh's axes and sizes, its process group's backend, the
        family rules it serves by and this rank's place in it (``None``
        off a mesh)."""
        if self._mp is None:
            return None
        import torch.distributed as dist

        mp = self._mp
        return {"axes": dict(mp.sizes), "coords": dict(mp.coords),
                "backend": dist.get_backend(), "ranks": dist.get_world_size(),
                "slot_rows": [self._lo, self._hi],
                "family_rules": self._full_model.cfg.family,
                "split": {"heads": mp.shard.heads, "ff": mp.shard.ff,
                          "experts": mp.shard.experts,
                          "vocab": mp.shard.vocab}}

    def finish_run(self, results: List[RequestResult]
                   ) -> Tuple[List[RequestResult], dict]:
        """Price the completed requests and build the run report; the
        closing half of the tick-level API."""
        wall = self._now(self._t_start)
        for r in results:
            if self.drafter is not None:
                # every (k + 1)-token verify a request sat through is
                # compute spent, accepted or not
                r.metrics.moa_flops = spec_request_decode_cost(
                    self._full_model.cfg, k=self.spec_k,
                    tick_contexts=self._tick_contexts.get(r.uid, ()))
            else:
                r.metrics.moa_flops = request_decode_cost(
                    self._full_model.cfg,
                    prompt_tokens=r.metrics.prompt_tokens,
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
        if self.scheduling == "slo" or any(
                r.metrics.deadline_s is not None for r in results):
            report["slo"] = slo_report(
                results, wall_s=wall, preemptions=self._preemptions,
                spills=self._spills, revivals=self._revivals,
                prefill_chunk_tokens=self._chunk or 0,
                prefill_chunk_count=self._chunk_ticks)
        if self.drafter is not None:
            report["spec"] = spec_report(
                k=self.spec_k, verify_ticks=self._spec_ticks,
                emitted_tokens=self._spec_emitted,
                slot_steps=self._spec_slot_steps,
                accepted_hist=self._accept_hist,
                draft_steps=self.drafter.draft_steps
                - self._draft_steps_start)
        report["device"] = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        report["mesh"] = self.mesh_report()
        report["cuda_graphs"] = self._graphs is not None
        report["graphs"] = (self._graphs.report()
                            if self._graphs is not None else None)
        if self.paged:
            report["paged"] = paged_report(
                spec=self._spec, n_slots=self.n_slots, max_len=self.max_len,
                block_size=self.block_size, n_blocks=self.n_blocks,
                admissions=self._admissions, prefix_hits=self._prefix_hits,
                shared_block_hits=self._shared_block_hits,
                cow_count=self._cow_count,
                block_occ_sum=self._block_occ_sum, decode_steps=self._steps,
                peak_blocks=self._peak_blocks,
                attn_backend=resolve_attn_backend(
                    self.model.cfg.attn_backend, self.device),
                gathered_kv_bytes=self._gathered_kv_bytes,
                fused_kv_bytes=self._fused_kv_bytes)
        results.sort(key=lambda r: r.uid)
        return results, report
