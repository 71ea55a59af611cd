"""Deterministic failure injection for fault-tolerance testing (the port of
``repro/runtime/failures.py``)."""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Set

__all__ = ["SimulatedFailure", "FailureInjector"]


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss, a preemption or a link error."""


class FailureInjector:
    """Raise :class:`SimulatedFailure` at scheduled steps (each fires once:
    a restarted run that re-executes the same step number survives it,
    like a replaced node). ``lose``: ``{step: ranks}``, the mesh ranks a
    failure at that step takes away for good (none: the node is replaced);
    :attr:`lost` gathers them, and a meshed trainer re-plans its mesh for
    the ranks that remain."""

    def __init__(self, fail_at_steps: Iterable[int] = (),
                 kind: str = "node_loss",
                 lose: Optional[Mapping[int, Iterable[int]]] = None):
        self._lose = {int(s): tuple(r) for s, r in (lose or {}).items()}
        self._pending: Set[int] = set(fail_at_steps) | set(self._lose)
        self.kind = kind
        self.fired = []
        self.lost: Set[int] = set()

    def maybe_fail(self, step: int):
        if step in self._pending:
            self._pending.discard(step)
            self.fired.append(step)
            self.lost.update(self._lose.get(step, ()))
            raise SimulatedFailure(f"{self.kind} at step {step}")
