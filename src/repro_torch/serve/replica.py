"""One serve replica: a :class:`~repro_torch.serve.engine.ServeEngine` plus
the fleet lifecycle state the router steers it through (the port of
``repro/serve/replica.py``).

State machine::

    healthy ──kill──▶ dead ──revive──▶ healthy
       │                                  ▲
       └──drain (reload)──▶ draining ─────┘
                               │   (drained: swap params, rejoin)
                               └──kill──▶ dead

* **healthy** — accepts new routes, ticks, heartbeats.
* **draining** — ticks and heartbeats but accepts no new routes; the
  router holds it here until every request it owns completes, then swaps
  its weights between ticks and returns it to *healthy*. Draining before
  the swap is what pins every generation to exactly one weight version.
* **dead** — a crash. The engine object (device caches, slot state) is
  discarded; heartbeats stop, and the router's :class:`HeartbeatMonitor`
  detects the silence and requeues the replica's requests. Revival builds
  a *fresh* engine: on the card its CUDA graphs are captured again, at the
  first tick of each bucket (graphs bind one engine's cache and workspace
  addresses, so there is no module-level cache to reuse as the
  reference's compile cache is); ``revive_s`` sums the capture seconds of
  the revived engines.

A killed replica's device state is unrecoverable, so crash recovery does
not try to move KV pages or spilled slot snapshots across replicas: the
:class:`~repro_torch.serve.request.Request` is self-contained (prompt, budget,
sampler), and greedy decode is deterministic, so re-prefilling the prompt
on a live replica regenerates the exact token stream the dead replica
would have produced. The engine's spill/revive machinery still runs
*within* a replica (SLO preemption), unchanged.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Set

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request, RequestResult

__all__ = ["Replica", "HEALTHY", "DRAINING", "DEAD"]

HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"


class Replica:
    """A router-managed serve engine.

    ``engine_factory`` builds a fresh :class:`ServeEngine` (used at
    construction and again on every revival); ``t_origin`` is the fleet
    clock origin every engine run is pinned to, so all replicas report on
    one timeline.
    """

    def __init__(self, rid: int, engine_factory: Callable[[], ServeEngine],
                 *, t_origin: float = 0.0):
        self.rid = rid
        self._factory = engine_factory
        self._t_origin = t_origin
        self.engine: Optional[ServeEngine] = engine_factory()
        if self.engine.drafter is not None:
            raise ValueError(
                "replica serving drives engines tick-by-tick without a "
                "closing report; speculative decoding's per-run drafter "
                "bookkeeping is not supported here")
        self.engine.start_run(t_origin=t_origin)
        self.state = HEALTHY
        #: uids currently owned by this replica (submitted, not finished)
        self.uids: Set[int] = set()
        self.ticks = 0
        self.completed = 0
        self.param_version = 0
        self.kills = 0
        self.revivals = 0
        self.reloads = 0
        #: capture seconds of revived engines since killed, and whether
        #: the live engine is a revived one
        self._revived_capture_s = 0.0
        self._engine_revived = False

    # ---- routing predicates ------------------------------------------------
    @property
    def alive(self) -> bool:
        return self.state != DEAD

    @property
    def accepting(self) -> bool:
        """May the router assign new requests here?"""
        return self.state == HEALTHY

    @property
    def drained(self) -> bool:
        """No queued, prefilling, in-flight, or spilled work left."""
        return self.engine is not None and self.engine.scheduler.done

    # ---- lifecycle ---------------------------------------------------------
    def submit(self, request: Request) -> None:
        if not self.alive:
            raise RuntimeError(f"replica {self.rid} is dead")
        self.engine.submit(request)
        self.uids.add(request.uid)

    def tick(self) -> List[RequestResult]:
        """One engine tick; returns the requests that finished on it."""
        if not self.alive:
            raise RuntimeError(f"replica {self.rid} is dead")
        buf: List[RequestResult] = []
        self.engine.tick(buf)
        self.ticks += 1
        for r in buf:
            self.uids.discard(r.uid)
        self.completed += len(buf)
        return buf

    def kill(self) -> Set[int]:
        """Crash: drop the engine (device state is gone) and stop
        heartbeating. Returns the uids that were lost with it — the router
        requeues them once the heartbeat monitor notices the silence."""
        lost, self.uids = self.uids, set()
        self._revived_capture_s += self._engine_capture_s()
        self._engine_revived = False
        self.engine = None
        self.state = DEAD
        self.kills += 1
        return lost

    def revive(self) -> None:
        """Rejoin after a crash with a fresh engine (same factory, same
        fleet clock origin); its graphs are captured anew as it ticks."""
        if self.alive:
            raise RuntimeError(f"replica {self.rid} is not dead")
        self.engine = self._factory()
        self.engine.start_run(t_origin=self._t_origin)
        self.state = HEALTHY
        self.revivals += 1
        self._engine_revived = True

    def _engine_capture_s(self) -> float:
        graphs = self.engine._graphs if self._engine_revived else None
        return graphs.capture_s if graphs is not None else 0.0

    @property
    def revive_capture_s(self) -> float:
        """CUDA-graph capture seconds of the engines revived so far (0 on
        the CPU, which never captures)."""
        return self._revived_capture_s + self._engine_capture_s()

    def begin_drain(self) -> None:
        if self.state != HEALTHY:
            raise RuntimeError(
                f"replica {self.rid} cannot drain from {self.state!r}")
        self.state = DRAINING

    def reload(self, params, version: int) -> None:
        """Swap weights between ticks and rejoin. The router only calls
        this once the replica is drained, so no request straddles two
        weight versions."""
        if self.state != DRAINING:
            raise RuntimeError(
                f"replica {self.rid} must be draining to reload "
                f"(state {self.state!r})")
        if not self.drained:
            raise RuntimeError(
                f"replica {self.rid} still owns {len(self.uids)} requests; "
                "reload would mix weight versions mid-generation")
        self.engine.reload_params(params)
        self.param_version = version
        self.state = HEALTHY
        self.reloads += 1

    def summary(self) -> dict:
        return {
            "rid": self.rid,
            "state": self.state,
            "ticks": self.ticks,
            "completed": self.completed,
            "param_version": self.param_version,
            "kills": self.kills,
            "revivals": self.revivals,
            "reloads": self.reloads,
        }
