"""Fault-tolerant replica-set serving: N engines behind one router (the
port of ``repro/serve/router.py``, host logic line for line).

The :class:`ReplicaSet` drives N :class:`~repro_torch.serve.engine.
ServeEngine` replicas tick-by-tick on one shared clock (a
:class:`~repro_torch.serve.clock.StepClock` makes the whole fleet a pure
function of (model, workload, failure schedule, dt): bit-identical
metrics JSON across runs). Per router step, in a fixed order:

1. **Chaos** — each replica's :class:`~repro_torch.runtime.failures
   .FailureInjector` fires at its scheduled steps; a
   :class:`SimulatedFailure` kills that replica (engine and device state
   discarded).
2. **Reload** — poll the :class:`~repro_torch.checkpoint.watcher
   .CheckpointWatcher`; a new checkpoint step starts a rolling reload:
   one replica at a time is drained (no new routes), its weights swapped
   between ticks once it owns zero requests, then it rejoins. No
   in-flight request is dropped and none straddles two weight versions.
3. **Detect** — the :class:`~repro_torch.runtime.heartbeat.HeartbeatMonitor`
   flags replicas whose beats stopped (``miss_limit`` silent steps); the
   dead replica's requests re-enter the router queue.
4. **Dispatch** — arrived requests route by session affinity: rendezvous
   (highest-random-weight) hash of the prompt's prefix-trie key (its
   first KV-block of tokens) over *accepting* replicas. HRW moves only
   the dead replica's keys when the fleet shrinks, so prefix-cache
   locality survives routing and affinity is stable for live replicas.
5. **Tick** — every live replica advances one engine tick and heartbeats
   its measured duration.

Requeued requests restart from the prompt on the new replica: a crashed
replica's KV pages and slot snapshots are gone, but requests are
self-contained and greedy decode is deterministic, so the regenerated
stream is bit-identical to the one the dead replica was producing. On the
card that holds because no kernel's row depends on the rows beside it: a
requeued request decodes in another slot, beside other requests, and
gives the same bits.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.launch.costing import request_decode_cost
from repro_torch.runtime.failures import FailureInjector, SimulatedFailure
from repro_torch.runtime.heartbeat import HeartbeatMonitor
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import _dist
from repro_torch.serve.replica import DEAD, DRAINING, HEALTHY, Replica
from repro_torch.serve.request import Request, RequestResult

__all__ = ["ReplicaSet"]


class ReplicaSet:
    """Router + N replicas (see module docstring for the step protocol).

    ``engine_factory`` must build engines that share the router's
    ``clock`` (the fleet runs on one timeline). ``failure_injectors``
    maps replica id → :class:`FailureInjector` whose scheduled steps are
    *router* steps. ``watcher``/``load_params`` enable rolling weight
    reloads: when the watcher reports a new checkpoint step,
    ``load_params(step)`` is called once and the fleet drains/swaps one
    replica at a time.
    """

    def __init__(self, engine_factory: Callable[[], ServeEngine], *,
                 n_replicas: int, clock: Callable[[], float],
                 miss_limit: int = 3,
                 failure_injectors: Optional[
                     Mapping[int, FailureInjector]] = None,
                 watcher=None,
                 load_params: Optional[Callable[[int], object]] = None,
                 affinity_block: Optional[int] = None):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self._clock = clock
        self.replicas = [Replica(rid, engine_factory, t_origin=0.0)
                         for rid in range(n_replicas)]
        engine = self.replicas[0].engine
        self._cfg = engine.model.cfg
        if affinity_block is None:
            affinity_block = engine.block_size if engine.paged else 16
        self.affinity_block = max(1, affinity_block)
        self.monitor = HeartbeatMonitor(n_replicas, miss_limit=miss_limit)
        self.injectors = dict(failure_injectors or {})
        self.watcher = watcher
        self._load_params = load_params

        self._step = 0
        self._last_now = 0.0
        self._requests: Dict[int, Request] = {}
        self._queue: List[Request] = []          # awaiting dispatch
        self._assigned: Dict[int, int] = {}      # uid -> rid
        self._results: Dict[int, RequestResult] = {}
        #: rid -> uids lost in a crash, awaiting heartbeat detection
        self._pending_loss: Dict[int, Set[int]] = {}
        self._requeue_count: Dict[int, int] = {}
        self._requeued_at: Dict[int, float] = {}
        self._requeue_latencies: List[float] = []
        self.requeues = 0
        self.deaths_detected = 0
        self.reloads_completed = 0
        self.reload_dropped = 0
        self._reload_queue: List[int] = []
        self._reload_params = None
        self._reload_version = 0
        self._reload_next: Optional[Tuple[int, object]] = None

    # ---- affinity ----------------------------------------------------------
    def _affinity_key(self, prompt: Sequence[int]) -> Tuple[int, ...]:
        """The prompt's prefix-trie key: its first KV-block of tokens (the
        unit the paged pool's prefix cache dedups on), so requests sharing
        a cached prefix land on the replica whose trie is warm."""
        return tuple(prompt[: self.affinity_block])

    def route(self, prompt: Sequence[int]) -> Optional[int]:
        """Rendezvous-hash the prompt's prefix key over accepting
        replicas; None when no replica accepts routes right now."""
        key = ",".join(str(t) for t in self._affinity_key(prompt))
        best_rid, best_w = None, -1
        for rep in self.replicas:
            if not rep.accepting:
                continue
            w = zlib.crc32(f"{key}|{rep.rid}".encode())
            if w > best_w:
                best_rid, best_w = rep.rid, w
        return best_rid

    # ---- public ops (also the chaos suite's op vocabulary) -----------------
    def submit(self, request: Request) -> None:
        if request.uid in self._requests:
            raise ValueError(f"duplicate request uid {request.uid}")
        self._requests[request.uid] = request
        self._queue.append(request)

    def kill(self, rid: int) -> bool:
        """Crash a replica (chaos op / injector target). Idempotent: a
        dead replica stays dead. Its requests are requeued only once the
        heartbeat monitor notices the missing beats."""
        rep = self.replicas[rid]
        if not rep.alive:
            return False
        lost = rep.kill()
        self._pending_loss[rid] = lost
        return True

    def revive(self, rid: int) -> bool:
        """Bring a dead replica back with a fresh engine. Idempotent on
        live replicas. A rejoining node announces it holds no state, so
        any crash loss not yet detected by heartbeat is requeued now."""
        rep = self.replicas[rid]
        if rep.alive:
            return False
        if rid in self._pending_loss:
            self._requeue(rid)
        rep.revive()
        return True

    def begin_reload(self, version: int, params) -> None:
        """Start a rolling weight reload (normally triggered by the
        checkpoint watcher). If one is already in progress the new target
        is deferred until it completes — versions are never skipped."""
        if self._reload_queue:
            self._reload_next = (version, params)
            return
        self._reload_version = version
        self._reload_params = params
        self._reload_queue = [r.rid for r in self.replicas if r.alive]

    @property
    def reloading(self) -> bool:
        return bool(self._reload_queue)

    @property
    def outstanding(self) -> int:
        """Submitted requests that have not completed."""
        return len(self._requests) - len(self._results)

    @property
    def alive_replicas(self) -> List[int]:
        return [r.rid for r in self.replicas if r.alive]

    # ---- internals ---------------------------------------------------------
    def _requeue(self, rid: int) -> None:
        lost = self._pending_loss.pop(rid)
        for uid in sorted(lost):
            # the dead replica can never surface this uid; restart it
            # from its self-contained Request on whoever affinity picks
            del self._assigned[uid]
            self._queue.append(self._requests[uid])
            self._requeue_count[uid] = self._requeue_count.get(uid, 0) + 1
            self._requeued_at[uid] = self._last_now
            self.requeues += 1
        self.deaths_detected += 1

    def _dispatch(self, now: float) -> None:
        # arrival order, uid tie-break; requeued requests arrived long ago
        # so they naturally lead the queue
        self._queue.sort(key=lambda r: (r.arrival_s, r.uid))
        held: List[Request] = []
        for req in self._queue:
            if req.arrival_s > now:
                held.append(req)
                continue
            rid = self.route(req.prompt)
            if rid is None:
                held.append(req)  # nobody accepting; retry next step
                continue
            self.replicas[rid].submit(req)
            self._assigned[req.uid] = rid
        self._queue = held

    def _advance_reload(self) -> None:
        if self.watcher is not None and self._load_params is not None:
            new_step = self.watcher.poll()
            if new_step is not None:
                self.begin_reload(new_step, self._load_params(new_step))
        while self._reload_queue:
            rep = self.replicas[self._reload_queue[0]]
            if rep.state == DEAD:
                self._reload_queue.pop(0)  # crashed mid-drain: skip it
                continue
            if rep.state == HEALTHY:
                rep.begin_drain()
            if rep.state == DRAINING and rep.drained:
                # proof obligation for "no request dropped": count what a
                # buggy drain would have abandoned (always zero)
                self.reload_dropped += len(rep.uids)
                rep.reload(self._reload_params, self._reload_version)
                self._reload_queue.pop(0)
                continue
            break  # head is mid-drain: one replica at a time
        if not self._reload_queue and self._reload_params is not None:
            self._reload_params = None
            self.reloads_completed += 1
            if self._reload_next is not None:
                version, params = self._reload_next
                self._reload_next = None
                self.begin_reload(version, params)

    def _on_result(self, r: RequestResult) -> None:
        if r.uid in self._results:
            raise RuntimeError(f"request {r.uid} completed twice")
        self._results[r.uid] = r
        self._assigned.pop(r.uid, None)
        if r.uid in self._requeued_at:
            self._requeue_latencies.append(
                r.metrics.admitted_s - self._requeued_at.pop(r.uid))

    # ---- the router tick ---------------------------------------------------
    def step(self) -> None:
        """One router step (see module docstring for the phase order)."""
        now = self._last_now = self._clock()
        for rid in sorted(self.injectors):
            try:
                self.injectors[rid].maybe_fail(self._step)
            except SimulatedFailure:
                self.kill(rid)
        self._advance_reload()
        for rid in self.monitor.dead_workers(self._step):
            if rid in self._pending_loss:
                self._requeue(rid)
        self._dispatch(now)
        for rep in self.replicas:
            if not rep.alive:
                continue  # no beat: this silence is what detection reads
            t0 = self._clock()
            finished = rep.tick()
            self.monitor.beat(rep.rid, self._step, self._clock() - t0)
            for r in finished:
                self._on_result(r)
        self._step += 1

    def run(self, requests: Sequence[Request] = (), *,
            max_steps: Optional[int] = None,
            actions: Optional[Mapping[int, Callable[["ReplicaSet"], None]]]
            = None) -> Tuple[List[RequestResult], dict]:
        """Serve until every request completes and any rolling reload
        finishes. ``actions`` maps router step → callback (used by the CLI
        and benchmarks to schedule checkpoint saves mid-run). Raises
        :class:`SimulatedFailure` if the whole fleet is dead with work
        outstanding: the condition a supervisor would restart on."""
        for req in sorted(requests, key=lambda r: (r.arrival_s, r.uid)):
            self.submit(req)
        limit = max_steps if max_steps is not None else 1_000_000
        while self.outstanding or self._reload_queue:
            if actions and self._step in actions:
                actions[self._step](self)
            if self.outstanding and not self.alive_replicas:
                raise SimulatedFailure(
                    f"all {len(self.replicas)} replicas dead with "
                    f"{self.outstanding} requests outstanding")
            self.step()
            if self._step >= limit:
                raise RuntimeError(
                    f"replica router exceeded {limit} steps with "
                    f"{self.outstanding} requests outstanding")
        return self.finish()

    def finish(self) -> Tuple[List[RequestResult], dict]:
        """Price completed requests and build the fleet report (the
        deterministic metrics JSON the chaos suite compares)."""
        results = sorted(self._results.values(), key=lambda r: r.uid)
        for r in results:
            r.metrics.moa_flops = request_decode_cost(
                self._cfg, prompt_tokens=r.metrics.prompt_tokens,
                new_tokens=r.metrics.new_tokens)
        total_new = sum(r.metrics.new_tokens for r in results)
        wall = self._last_now
        report = {
            "n_replicas": len(self.replicas),
            "router_steps": self._step,
            "wall_s": wall,
            "requests": len(self._requests),
            "completed": len(results),
            "lost_requests": len(self._requests) - len(self._results),
            "kills": sum(r.kills for r in self.replicas),
            "deaths_detected": self.deaths_detected,
            "requeues": self.requeues,
            "requeued_requests": len(self._requeue_count),
            "requeue_latency_ms": _dist(
                [1e3 * v for v in self._requeue_latencies]),
            "reloads_completed": self.reloads_completed,
            "reload_dropped": self.reload_dropped,
            "stragglers": len(self.monitor.reports),
            "total_new_tokens": total_new,
            "tok_per_s": total_new / max(wall, 1e-9),
            "replicas": [r.summary() for r in self.replicas],
        }
        return results, report

    # ---- invariants (exercised after every chaos-suite op) -----------------
    def check(self) -> None:
        """Audit router bookkeeping; raises AssertionError on violation.

        R1: queued/assigned/completed partition the submitted uids.
        R2: every uid assigned to a dead replica is awaiting requeue in
            its ``_pending_loss`` entry (nothing can be silently lost).
        R3: a live replica's engine owns exactly the uids the router
            assigned to it.
        R4: at most one replica is draining (rolling reload is serial)
            and any draining replica is the head of the reload queue.
        """
        queued = {r.uid for r in self._queue}
        assigned = set(self._assigned)
        done = set(self._results)
        assert not (queued & assigned), "R1: uid both queued and assigned"
        assert not (queued & done), "R1: uid both queued and completed"
        assert not (assigned & done), "R1: uid both assigned and completed"
        assert queued | assigned | done == set(self._requests), \
            "R1: a submitted uid is unaccounted for (lost)"
        pending = {u for s in self._pending_loss.values() for u in s}
        for uid, rid in self._assigned.items():
            if not self.replicas[rid].alive:
                assert uid in pending, \
                    f"R2: uid {uid} stuck on dead replica {rid}"
        for rep in self.replicas:
            if rep.alive:
                owned = {u for u, rid in self._assigned.items()
                         if rid == rep.rid}
                assert rep.uids == owned, \
                    f"R3: replica {rep.rid} owns {rep.uids} != {owned}"
        draining = [r.rid for r in self.replicas if r.state == DRAINING]
        assert len(draining) <= 1, f"R4: concurrent drains {draining}"
        if draining:
            assert self._reload_queue \
                and self._reload_queue[0] == draining[0], \
                "R4: draining replica is not the reload head"
