"""Deterministic virtual clocks for the serve engine and its tests (copied
from ``repro/serve/clock.py``).

The engine reads time only through its injected ``clock`` callable
(default ``time.monotonic``). Swapping in a :class:`StepClock` turns the
whole serve stack into a deterministic discrete-event simulator: every
clock read advances virtual time by a fixed ``dt``, so TTFT, queueing
delay, and deadline attainment become exact, replayable numbers — no
wall-clock sleeps, no flaky timing assertions.

A frozen clock (``lambda: 0.0``) also works and is what the legacy tests
use, but it hides queueing delay entirely (time never passes, so every
request's TTFT is 0 unless the engine fast-forwards to an arrival). The
StepClock is what makes FIFO-vs-SLO scheduling *observable*: a request
stuck behind a long generation accumulates dt per engine clock read.
"""

from __future__ import annotations

__all__ = ["StepClock"]


class StepClock:
    """Virtual clock: each call returns the current time, then advances
    it by ``dt`` seconds. Deterministic and monotonic by construction.

    ``dt`` is the simulated cost of one engine clock read; the engine
    reads the clock a small, deterministic number of times per tick, so
    simulated time scales with scheduling work, not host speed.
    """

    def __init__(self, dt: float = 1e-3, start: float = 0.0):
        if dt < 0:
            raise ValueError("dt must be >= 0")
        self.dt = float(dt)
        self.now = float(start)
        #: total number of reads (handy for asserting determinism)
        self.reads = 0

    def __call__(self) -> float:
        t = self.now
        self.now += self.dt
        self.reads += 1
        return t

    def advance(self, seconds: float) -> None:
        """Jump forward without counting a read (test convenience)."""
        if seconds < 0:
            raise ValueError("cannot move a monotonic clock backwards")
        self.now += float(seconds)
