"""Slot scheduler: admission bookkeeping for the continuous-batching engine
(copied from ``repro/serve/scheduler.py``).

Pure Python — no device work happens here. The engine owns the batched
cache; the scheduler decides *which request enters which slot when*.

Invariants (``check()`` audits the structural ones after any operation):

1. A slot is either free or bound to exactly one in-flight request.
2. Admission follows the *policy* order over **arrived** requests (a
   request is arrived once the engine clock reaches its ``arrival_s``):
   ``"fifo"`` orders by ``(arrival_s, uid)`` — exactly the historical
   behaviour — while ``"slo"`` orders by ``(priority desc, deadline asc,
   arrival_s, uid)`` (EDF within a priority class; no deadline sorts
   last). Ties beyond that break by submission order.
3. An admitted request fits its slot for its whole lifetime:
   ``prompt_len + max_new_tokens + spec_margin <= max_len`` (checked at
   submit; ``spec_margin`` is 0 unless the engine runs speculative decode,
   where it reserves room for the verify window's tentative writes).
4. ``prompt_len`` never exceeds the largest prefill bucket.
5. A freed slot's device state is garbage until the next admission
   overwrites it (the engine masks freed slots out of all metrics).
6. When an admission ``gate`` is installed (the paged engine's
   memory-aware rule: "free slot **and** enough free KV blocks"), a
   rejected head-of-queue request blocks everything behind it — the
   policy order is never reordered by backpressure. Admitted requests
   hold their worst-case block reservation, so under ``"fifo"`` they are
   never evicted; under ``"slo"`` the engine may *preempt* them (below),
   which keeps the reservation but frees the slot.
7. ``preempt(slot)`` unbinds an active request and returns it to the
   ready queue under the policy key; the slot is immediately free and
   the request is re-admissible exactly like a fresh arrival. A request
   is never simultaneously active and queued, and every preemption is
   recorded in ``preemption_log``.
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.request import Request

__all__ = ["SlotScheduler", "default_buckets"]


def default_buckets(max_len: int) -> Tuple[int, ...]:
    """Power-of-two prompt buckets, capped by a final ``max_len`` bucket:
    8, 16, 32, ..., max_len.

    Bucketing bounds the number of prefill shapes to ``len(buckets)`` —
    prompts are right-padded up to the nearest bucket.
    The trailing ``max_len`` bucket ensures any prompt that fits the cache
    also fits a bucket (invariant 3 alone decides admissibility).
    """
    out, b = [], 8
    while b < max_len:
        out.append(b)
        b *= 2
    if not out or out[-1] != max_len:
        out.append(max_len)
    return tuple(out)


class SlotScheduler:
    """Policy-ordered admission of arrived requests into free decode slots.

    Two queues: ``_pending`` is a heap keyed by arrival time (requests the
    clock has not reached yet); once arrived, a request is *promoted* into
    ``_ready``, a heap keyed by the admission policy. Splitting the two
    keeps the policy key free to ignore arrival order (SLO mode) without
    ever admitting a request before its ``arrival_s``.
    """

    #: admission policies: FIFO (arrival order) or SLO (priority, then
    #: earliest deadline first)
    POLICIES = ("fifo", "slo")

    def __init__(self, n_slots: int, max_len: int,
                 buckets: Sequence[int] = (), spec_margin: int = 0,
                 policy: str = "fifo", clock=None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if spec_margin < 0:
            raise ValueError("spec_margin must be >= 0")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {self.POLICIES}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.policy = policy
        #: virtual clock for methods called without an explicit ``now_s``
        #: (tests inject a deterministic one; the engine always passes
        #: ``now_s`` explicitly)
        self._clock = clock if clock is not None else time.monotonic
        #: extra cache rows reserved past every request's worst-case length
        #: (speculative decoding: a verify window of k draft tokens may
        #: tentatively write up to k rows past the final committed token,
        #: and those writes must stay inside the slot — invariant 3 becomes
        #: ``prompt + max_new_tokens + spec_margin <= max_len``)
        self.spec_margin = spec_margin
        self.buckets: Tuple[int, ...] = tuple(sorted(buckets)) \
            or default_buckets(max_len)
        self._free: List[int] = list(range(n_slots))   # min-heap: lowest id
        heapq.heapify(self._free)
        # arrival heap: (arrival_s, uid, submit_seq, request); the sequence
        # number breaks (arrival, uid) ties so Request never gets compared
        self._pending: List[Tuple[float, int, int, Request]] = []
        # ready heap: (*policy_key, request) — arrived, waiting for a slot
        self._ready: List[tuple] = []
        self._seq = itertools.count()
        self.active: Dict[int, Request] = {}           # slot -> request
        #: admission history [(uid, slot, engine_time_s)] — slot-reuse is
        #: observable here (a slot id appearing more than once)
        self.admission_log: List[Tuple[int, int, float]] = []
        #: preemption history [(uid, slot, engine_time_s)]
        self.preemption_log: List[Tuple[int, int, float]] = []

    # ---- policy ------------------------------------------------------------
    def _key(self, req: Request, seq: int) -> tuple:
        """Heap key ordering the ready queue (ends in ``(uid, seq)`` so
        entries are always totally ordered without comparing Requests)."""
        if self.policy == "slo":
            deadline = (req.deadline_s if req.deadline_s is not None
                        else float("inf"))
            return (-req.priority, deadline, req.arrival_s, req.uid, seq)
        return (req.arrival_s, req.uid, seq)

    def _promote(self, now_s: float) -> None:
        """Move every arrived request from the arrival heap to the ready
        heap (policy order takes over from arrival order)."""
        while self._pending and self._pending[0][0] <= now_s:
            _, _, seq, req = heapq.heappop(self._pending)
            heapq.heappush(self._ready, self._key(req, seq) + (req,))

    # ---- submission --------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Queue a request for admission at its ``arrival_s`` (invariant 3
        and 4 checked here, so a bad request fails before taking a slot)."""
        p = request.prompt_len
        if p + request.max_new_tokens + self.spec_margin > self.max_len:
            margin = (f" + spec_margin {self.spec_margin}"
                      if self.spec_margin else "")
            raise ValueError(
                f"request {request.uid}: prompt {p} + max_new_tokens "
                f"{request.max_new_tokens}{margin} exceeds max_len "
                f"{self.max_len}")
        if p > self.buckets[-1]:
            raise ValueError(
                f"request {request.uid}: prompt {p} tokens exceeds the "
                f"largest prefill bucket {self.buckets[-1]}")
        heapq.heappush(self._pending, (request.arrival_s, request.uid,
                                       next(self._seq), request))

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket that fits ``prompt_len`` tokens."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(f"prompt_len {prompt_len} exceeds buckets "
                         f"{self.buckets}")

    # ---- admission ---------------------------------------------------------
    @property
    def has_pending(self) -> bool:
        """Anything still waiting (future arrivals or arrived-but-queued)."""
        return bool(self._pending or self._ready)

    @property
    def next_arrival_s(self) -> float:
        """Arrival time of the earliest *future* queued request (inf if
        none). Requests already promoted to the ready queue have arrived
        and do not appear here — they are waiting on a slot, not time."""
        return self._pending[0][0] if self._pending else float("inf")

    @property
    def has_free(self) -> bool:
        """True when at least one slot is unbound."""
        return bool(self._free)

    @property
    def has_ready(self) -> bool:
        """True when an arrived request is waiting on a slot (only
        meaningful after a ``_promote``-ing call like ``admit_ready`` or
        ``ready_head`` at the current engine time)."""
        return bool(self._ready)

    def ready_head(self, now_s: float) -> Optional[Request]:
        """Best admissible request under the policy at ``now_s`` (None if
        nothing has arrived). Promotes arrivals first, so the engine's
        preemption check sees exactly what ``admit_ready`` would admit."""
        self._promote(now_s)
        return self._ready[0][-1] if self._ready else None

    def admit_ready(self, now_s: Optional[float] = None, gate=None,
                    limit: int = 0) -> List[Tuple[int, Request]]:
        """Pop arrived requests into free slots in policy order; returns
        the new ``(slot, request)`` bindings (engine then prefills each).

        ``gate(request) -> bool`` vetoes admissions that a slot alone
        cannot satisfy (the paged engine's block-availability check); a
        vetoed head request stops the loop — invariant 6. ``limit`` caps
        admissions per call (0 = unlimited); the paged engine admits one
        at a time so each admission's allocation is visible to the next
        gate evaluation. ``now_s`` defaults to the scheduler's clock.
        """
        if now_s is None:
            now_s = self._clock()
        self._promote(now_s)
        admitted = []
        while self._free and self._ready:
            if limit and len(admitted) >= limit:
                break
            if gate is not None and not gate(self._ready[0][-1]):
                break
            req = heapq.heappop(self._ready)[-1]
            slot = heapq.heappop(self._free)
            self.active[slot] = req
            self.admission_log.append((req.uid, slot, now_s))
            admitted.append((slot, req))
        return admitted

    def admit_revivable(self, now_s: float,
                        revivable) -> Optional[Tuple[int, Request]]:
        """Admit the best ready request whose uid is in ``revivable``,
        skipping (but preserving) everything ahead of it.

        This is the engine's memory-stall escape hatch: a spilled
        (preempted, paged) request keeps its worst-case block reservation,
        so reviving it needs no new blocks and always makes progress even
        when the gate vetoes every fresh request at the head of the queue.
        Returns the ``(slot, request)`` binding, or None if no revivable
        request is ready or no slot is free.
        """
        if not self._free:
            return None
        self._promote(now_s)
        skipped: List[tuple] = []
        found = None
        while self._ready:
            entry = heapq.heappop(self._ready)
            if entry[-1].uid in revivable:
                found = entry[-1]
                break
            skipped.append(entry)
        for entry in skipped:
            heapq.heappush(self._ready, entry)
        if found is None:
            return None
        slot = heapq.heappop(self._free)
        self.active[slot] = found
        self.admission_log.append((found.uid, slot, now_s))
        return (slot, found)

    def release(self, slot: int) -> None:
        """Free a slot whose request finished (invariant 1: must be active)."""
        if slot not in self.active:
            raise KeyError(f"slot {slot} is not active")
        del self.active[slot]
        heapq.heappush(self._free, slot)

    def preempt(self, slot: int, now_s: Optional[float] = None) -> Request:
        """Unbind the request in ``slot`` and return it to the ready queue
        (invariant 7). The engine is responsible for spilling/snapshotting
        the slot's device state before calling this; the returned request
        is re-admissible immediately (its ``arrival_s`` has long passed).
        """
        if slot not in self.active:
            raise KeyError(f"slot {slot} is not active")
        if now_s is None:
            now_s = self._clock()
        req = self.active.pop(slot)
        heapq.heappush(self._free, slot)
        heapq.heappush(self._ready, self._key(req, next(self._seq)) + (req,))
        self.preemption_log.append((req.uid, slot, now_s))
        return req

    @property
    def done(self) -> bool:
        return not self._pending and not self._ready and not self.active

    def slot_reuse_count(self, start: int = 0) -> int:
        """Number of admissions (from ``admission_log[start:]``) that reused
        a slot occupied earlier *in that slice* — pass the log length at
        run start to get a per-run count on a reused engine."""
        seen, reused = set(), 0
        for _, slot, _ in self.admission_log[start:]:
            if slot in seen:
                reused += 1
            seen.add(slot)
        return reused

    # ---- auditing ----------------------------------------------------------
    def check(self) -> None:
        """Structural audit of invariants 1–4 and 7 (raises AssertionError).

        Cheap enough to run after every operation in property tests:
        free/active slots partition ``range(n_slots)``; no request is in
        two places at once; every tracked request satisfies the fit and
        bucket bounds; all three heaps are well-formed.
        """
        free = list(self._free)
        assert len(set(free)) == len(free), "duplicate free slot"
        assert not (set(free) & set(self.active)), \
            "slot both free and active"
        assert set(free) | set(self.active) == set(range(self.n_slots)), \
            "slots lost: free/active do not partition range(n_slots)"
        queued = [e[-1] for e in self._pending] + [e[-1] for e in self._ready]
        uids = [r.uid for r in queued] + [r.uid for r in self.active.values()]
        assert len(set(uids)) == len(uids), \
            "request queued/active in more than one place"
        for req in queued + list(self.active.values()):
            p = req.prompt_len
            assert p + req.max_new_tokens + self.spec_margin <= self.max_len
            assert p <= self.buckets[-1]
        # heap property (heapq is a plain list; corruption would silently
        # reorder admissions)
        for heap in (self._free, self._pending, self._ready):
            for i in range(1, len(heap)):
                assert heap[(i - 1) // 2] <= heap[i], "heap order violated"
