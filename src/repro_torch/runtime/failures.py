"""Deterministic failure injection for fault-tolerance testing (the port of
``repro/runtime/failures.py``)."""

from __future__ import annotations

from typing import Iterable, Set

__all__ = ["SimulatedFailure", "FailureInjector"]


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss, a preemption or a link error."""


class FailureInjector:
    """Raise :class:`SimulatedFailure` at scheduled steps (each fires once:
    a restarted run that re-executes the same step number survives it,
    like a replaced node)."""

    def __init__(self, fail_at_steps: Iterable[int] = (),
                 kind: str = "node_loss"):
        self._pending: Set[int] = set(fail_at_steps)
        self.kind = kind
        self.fired = []

    def maybe_fail(self, step: int):
        if step in self._pending:
            self._pending.discard(step)
            self.fired.append(step)
            raise SimulatedFailure(f"{self.kind} at step {step}")
