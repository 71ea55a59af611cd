"""Slot scheduler: admission bookkeeping for the continuous-batching engine.

Host logic copied from ``repro/serve/scheduler.py`` (the reference's own
property tests hold it there), cut to the FIFO admission the port's engine
runs: the reference's ``"slo"`` policy, preemption and speculative-decode
margin come with those engine features (ROADMAP Queue 1, item 8). Pure
Python — no device work happens here. The engine owns the batched cache;
the scheduler decides *which request enters which slot when*.

Invariants (``check()`` audits the structural ones after any operation):

1. A slot is either free or bound to exactly one in-flight request.
2. Admission follows ``(arrival_s, uid)`` order over **arrived** requests
   (a request is arrived once the engine clock reaches its
   ``arrival_s``); ties beyond that break by submission order.
3. An admitted request fits its slot for its whole lifetime:
   ``prompt_len + max_new_tokens <= max_len`` (checked at submit).
4. ``prompt_len`` never exceeds the largest prefill bucket.
5. A freed slot's device state is garbage until the next admission
   overwrites it (the engine masks freed slots out of all metrics).
6. When an admission ``gate`` is installed (the paged engine's
   memory-aware rule: "free slot **and** enough free KV blocks"), a
   rejected head-of-queue request blocks everything behind it — the
   arrival order is never reordered by backpressure. Admitted requests
   hold their worst-case block reservation, so they are never evicted.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Sequence, Tuple

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
    """FIFO admission of arrived requests into free decode slots.

    Two queues: ``_pending`` is a heap keyed by arrival time (requests the
    clock has not reached yet); once arrived, a request is *promoted* into
    ``_ready``, the heap admission pops from.
    """

    def __init__(self, n_slots: int, max_len: int,
                 buckets: Sequence[int] = ()):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_len = max_len
        self.buckets: Tuple[int, ...] = tuple(sorted(buckets)) \
            or default_buckets(max_len)
        self._free: List[int] = list(range(n_slots))   # min-heap: lowest id
        heapq.heapify(self._free)
        # arrival heap: (arrival_s, uid, submit_seq, request); the sequence
        # number breaks (arrival, uid) ties so Request never gets compared
        self._pending: List[Tuple[float, int, int, Request]] = []
        # ready heap, same entries — arrived, waiting for a slot
        self._ready: List[Tuple[float, int, int, Request]] = []
        self._seq = itertools.count()
        self.active: Dict[int, Request] = {}           # slot -> request
        #: admission history [(uid, slot, engine_time_s)] — slot-reuse is
        #: observable here (a slot id appearing more than once)
        self.admission_log: List[Tuple[int, int, float]] = []

    def _promote(self, now_s: float) -> None:
        """Move every arrived request from the arrival heap to the ready
        heap."""
        while self._pending and self._pending[0][0] <= now_s:
            heapq.heappush(self._ready, heapq.heappop(self._pending))

    # ---- submission --------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Queue a request for admission at its ``arrival_s`` (invariant 3
        and 4 checked here, so a bad request fails before taking a slot)."""
        p = request.prompt_len
        if p + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt {p} + max_new_tokens "
                f"{request.max_new_tokens} exceeds max_len {self.max_len}")
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
    def next_arrival_s(self) -> float:
        """Arrival time of the earliest *future* queued request (inf if
        none). Requests already promoted to the ready queue have arrived
        and do not appear here — they are waiting on a slot, not time."""
        return self._pending[0][0] if self._pending else float("inf")

    @property
    def has_ready(self) -> bool:
        """True when an arrived request is waiting on a slot (only
        meaningful after an ``admit_ready`` at the current engine time)."""
        return bool(self._ready)

    def admit_ready(self, now_s: float, gate=None,
                    limit: int = 0) -> List[Tuple[int, Request]]:
        """Pop arrived requests into free slots in arrival order; returns
        the new ``(slot, request)`` bindings (engine then prefills each).

        ``gate(request) -> bool`` vetoes admissions that a slot alone
        cannot satisfy (the paged engine's block-availability check); a
        vetoed head request stops the loop — invariant 6. ``limit`` caps
        admissions per call (0 = unlimited); the paged engine admits one
        at a time so each admission's allocation is visible to the next
        gate evaluation.
        """
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

    def release(self, slot: int) -> None:
        """Free a slot whose request finished (invariant 1: must be active)."""
        if slot not in self.active:
            raise KeyError(f"slot {slot} is not active")
        del self.active[slot]
        heapq.heappush(self._free, slot)

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
        """Structural audit of invariants 1–4 (raises AssertionError).

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
            assert p + req.max_new_tokens <= self.max_len
            assert p <= self.buckets[-1]
        # heap property (heapq is a plain list; corruption would silently
        # reorder admissions)
        for heap in (self._free, self._pending, self._ready):
            for i in range(1, len(heap)):
                assert heap[(i - 1) // 2] <= heap[i], "heap order violated"
