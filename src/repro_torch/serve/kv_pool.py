"""Paged KV-cache block pool: allocator, ref-counted prefix cache, CoW plan.

Copied from ``repro/serve/kv_pool.py``. Host-side bookkeeping only — no
device arrays live here. The engine owns the pooled device cache
(``(stack, n_phys_blocks, block_size, ...)`` leaves); this module decides
*which physical block holds which logical block of which request*, exactly
like the paper's lesson applied to cache memory: one shared physical pool
time-multiplexed across requests instead of a dense ``n_slots x max_len``
region statically over-provisioned per slot (Shen et al.,
arXiv:1607.00064, resource partitioning).

Physical block ids are ``1..n_blocks``; **id 0 is the trash block** — the
engine redirects writes for logical blocks it must not touch (shared
pages, padding beyond a request's table) to id 0, so every device write
keeps a static shape and shared content is never clobbered.

Three block states partition ``1..n_blocks``:

* **free** — on the free list, content garbage.
* **allocated** — ``refcount >= 1`` requests map a logical block here.
* **evictable** — ``refcount == 0`` but the block still holds prompt KV
  registered in the prefix trie; it is reclaimable (LRU) when the free
  list runs dry, and revivable by a later prefix match.

The prefix trie is keyed by the **exact token chain** from position 0 to
the block's end (a content hash with no collisions), so two requests
sharing a prompt prefix map their leading full blocks to the same physical
pages. A *partial* tail block (prompt length not block-aligned, or an
identical full prompt) may also be shared; the first divergent write —
the first generated token's KV — triggers copy-on-write into a spare
block that admission reserved, so backpressure stays preempt-free: a
request that is admitted never needs another block mid-flight.

Invariants (``BlockPool.check`` asserts P1-P3):

P1. free / allocated / evictable partition ``1..n_blocks``.
P2. refcounts are >= 1 for allocated blocks and never go negative:
    freeing a non-allocated block raises (no double-free).
P3. every trie entry points at an allocated or evictable block, each
    block has at most one trie entry, and the trie is **prefix-closed**:
    every block-aligned proper prefix of a registered chain is itself
    registered. Closure is what makes registered content *reachable* —
    ``plan`` matches full blocks front-to-back and a partial tail only
    behind a fully matched prefix — so LRU eviction must cascade: when a
    block is reclaimed, the chain suffix rooted below it is unregistered
    too (evictable descendants return to the free list; they could never
    be matched again and would otherwise squat in LRU as dead cache).
P4. ``alloc`` never returns a block that is still referenced.
P5. an admission plan's ``new_needed`` never exceeds ``available`` at the
    time ``can_admit`` approved it (the memory-aware admission rule).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

__all__ = ["AdmissionPlan", "BlockPool", "TRASH_BLOCK", "blocks_needed"]

#: physical id of the write-trash page (never allocated, never read).
TRASH_BLOCK = 0


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block_size: int) -> int:
    """Worst-case logical blocks a request needs over its whole lifetime.

    Token positions ``0 .. prompt_len + max_new_tokens - 1`` must be
    mappable (the final sampled token is never written back, so this
    over-reserves by at most one block — the price of a simple rule).
    """
    return -(-(prompt_len + max_new_tokens) // block_size)


@dataclasses.dataclass
class AdmissionPlan:
    """What admitting one request would do to the pool (no mutation yet).

    ``new_needed`` counts fresh allocations: every logical block not
    matched as a shared full block, **plus** a copy-on-write spare when
    the partial tail matched (the spare is what keeps admission
    preempt-free), which is why ``new_needed == n_logical - n_full``.
    """

    n_logical: int                    # table length in blocks
    full_matched: List[int]           # physical ids of matched full blocks
    tail_matched: Optional[int]       # physical id of a matched partial tail
    new_needed: int                   # fresh blocks to allocate

    @property
    def n_shared(self) -> int:
        return len(self.full_matched) + (1 if self.tail_matched else 0)


class BlockPool:
    """Fixed pool of ``n_blocks`` KV pages with a token-hash prefix trie."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1:
            raise ValueError("need at least one block")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO free list over ids n_blocks..1 so pop() hands out low ids
        # first (deterministic tests)
        self._free: List[int] = list(range(n_blocks, 0, -1))
        self._ref: Dict[int, int] = {}                  # id -> refcount >= 1
        # token-chain -> block id; chains are exact token tuples from
        # position 0 through the block's last stored token
        self._trie: Dict[Tuple[int, ...], int] = {}
        self._block_key: Dict[int, Tuple[int, ...]] = {}   # reverse of _trie
        self._evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU
        # counters (engine metrics)
        self.hits = 0          # blocks served from the trie
        self.evictions = 0     # cached blocks reclaimed for new allocations

    # ---- capacity ----------------------------------------------------------
    @property
    def available(self) -> int:
        """Blocks allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._evictable)

    @property
    def in_use(self) -> int:
        """Blocks holding live (referenced) request state."""
        return len(self._ref)

    @property
    def resident(self) -> int:
        """Blocks holding data (referenced + cached-evictable)."""
        return len(self._ref) + len(self._evictable)

    # ---- allocation --------------------------------------------------------
    def _take(self) -> int:
        if self._free:
            bid = self._free.pop()
        elif self._evictable:
            bid, _ = self._evictable.popitem(last=False)   # LRU eviction
            self._evict_registration(bid)
            self.evictions += 1
        else:
            raise RuntimeError("block pool exhausted — admission gate "
                               "should have prevented this allocation")
        self._ref[bid] = 1
        return bid

    def _evict_registration(self, bid: int) -> None:
        """Unregister an evicted block *and* the chain suffix rooted below
        it (invariant P3's prefix closure).

        Dropping only the evicted block's own entry would strand every
        descendant chain: ``plan`` matches front-to-back, so a chain whose
        parent is gone can never be served again, yet its block would keep
        its trie entry and sit in the LRU queue as unreclaimable-by-match
        dead cache. Cascading keeps the trie prefix-closed; evictable
        descendants go straight back to the free list (their content is
        unreachable garbage now), while still-referenced descendants merely
        lose their registration and free normally when released.
        """
        root = self._block_key.get(bid)
        self._drop_registration(bid)
        if root is None:
            return
        bs = self.block_size
        if len(root) % bs:
            return      # partial-tail chains never have descendants
        dropped = {root}
        # length order visits parents before children, so one pass over a
        # snapshot unregisters the whole subtree under ``root``
        for chain in sorted(self._trie, key=len):
            aligned = (len(chain) - 1) // bs * bs
            if aligned and chain[:aligned] in dropped:
                dropped.add(chain)
                child = self._trie[chain]
                self._drop_registration(child)
                if child in self._evictable:
                    del self._evictable[child]
                    self._free.append(child)

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` fresh blocks (refcount 1 each)."""
        if n > self.available:
            raise RuntimeError(
                f"asked for {n} blocks with only {self.available} available")
        return [self._take() for _ in range(n)]

    def share(self, block_id: int) -> None:
        """Add a reference to a matched block (reviving it if evictable)."""
        if block_id in self._ref:
            self._ref[block_id] += 1
        elif block_id in self._evictable:
            del self._evictable[block_id]
            self._ref[block_id] = 1
        else:
            raise KeyError(f"block {block_id} is not live (free or unknown)")
        self.hits += 1

    def free(self, block_id: int) -> None:
        """Drop one reference. At refcount 0 a trie-registered block turns
        evictable (content stays matchable); an unregistered one returns to
        the free list. Freeing a non-allocated block raises (no
        double-free)."""
        if block_id not in self._ref:
            raise KeyError(f"double free of block {block_id}")
        self._ref[block_id] -= 1
        if self._ref[block_id] == 0:
            del self._ref[block_id]
            if block_id in self._block_key:
                self._evictable[block_id] = None       # newest at LRU tail
            else:
                self._free.append(block_id)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    # ---- prefix trie -------------------------------------------------------
    def register(self, block_id: int, chain: Tuple[int, ...]) -> None:
        """Publish a prompt block's content under its token chain. A chain
        already registered (by a concurrent identical admission) keeps its
        first block; re-registering the same pair is a no-op."""
        if block_id not in self._ref:
            raise KeyError(f"cannot register non-allocated block {block_id}")
        chain = tuple(chain)
        if chain in self._trie or block_id in self._block_key:
            return
        self._trie[chain] = block_id
        self._block_key[block_id] = chain

    def match(self, chain: Tuple[int, ...]) -> Optional[int]:
        """Look up a token chain; returns the block id without referencing
        it (callers follow up with :meth:`share`)."""
        return self._trie.get(tuple(chain))

    def forget_cached(self) -> int:
        """Drop every trie registration: no prompt block is matchable any
        more. Evictable cached blocks go back to the free list (oldest
        first); referenced blocks keep their owners and free normally. The
        engine calls this when its weights change, since a cached page
        holds K/V computed under the old ones. Returns the blocks freed."""
        freed = list(self._evictable)
        self._evictable.clear()
        self._free.extend(freed)
        self._trie.clear()
        self._block_key.clear()
        return len(freed)

    def _drop_registration(self, block_id: int) -> None:
        key = self._block_key.pop(block_id, None)
        if key is not None:
            del self._trie[key]

    # ---- admission planning ------------------------------------------------
    def plan(self, prompt: Tuple[int, ...], max_new_tokens: int, *,
             match_tail: bool = True) -> AdmissionPlan:
        """Pure lookup: how the pool would serve this request.

        Walks the prompt in ``block_size`` chunks matching full blocks
        front-to-back (stopping at the first miss — a prefix property),
        then optionally the partial tail under the full-prompt chain.
        ``match_tail=False`` is the dense-family mode, where the tail is
        recomputed by the suffix prefill anyway.
        """
        bs = self.block_size
        p = len(prompt)
        n_logical = blocks_needed(p, max_new_tokens, bs)
        full_matched: List[int] = []
        for i in range(p // bs):
            bid = self.match(prompt[: (i + 1) * bs])
            if bid is None:
                break
            full_matched.append(bid)
        tail = None
        if match_tail and p % bs and len(full_matched) == p // bs:
            tail = self.match(prompt)
        return AdmissionPlan(
            n_logical=n_logical, full_matched=full_matched,
            tail_matched=tail,
            new_needed=n_logical - len(full_matched))

    def can_admit(self, prompt: Tuple[int, ...], max_new_tokens: int, *,
                  match_tail: bool = True) -> bool:
        """The memory-aware admission rule: enough blocks for the whole
        worst-case lifetime, counting prefix-cache hits as free.

        Matched blocks that are currently *evictable* still sit in
        ``available``, but admission will revive them (share), taking them
        off the allocatable set — so they must not double-count as both a
        hit and allocatable capacity.
        """
        plan = self.plan(prompt, max_new_tokens, match_tail=match_tail)
        matched = list(plan.full_matched)
        if plan.tail_matched is not None:
            matched.append(plan.tail_matched)
        revived = sum(1 for b in matched if b in self._evictable)
        return plan.new_needed <= self.available - revived

    # ---- invariants (test hook) -------------------------------------------
    def check(self) -> None:
        """Assert invariants P1-P3 (cheap; called from property tests)."""
        free, alloc = set(self._free), set(self._ref)
        evict = set(self._evictable)
        assert not (free & alloc) and not (free & evict) \
            and not (alloc & evict), "block states overlap"
        assert free | alloc | evict == set(range(1, self.n_blocks + 1)), \
            "block states do not partition the pool"
        assert all(c >= 1 for c in self._ref.values()), "refcount < 1"
        assert set(self._block_key) <= alloc | evict, \
            "trie entry points at a free block"
        assert {self._trie[k] for k in self._trie} == set(self._block_key), \
            "trie and reverse map disagree"
        for bid, key in self._block_key.items():
            assert self._trie.get(key) == bid, "trie reverse-map mismatch"
        bs = self.block_size
        for chain in self._trie:
            aligned = (len(chain) - 1) // bs * bs
            assert aligned == 0 or chain[:aligned] in self._trie, \
                "trie lost prefix closure (orphaned chain suffix)"
