"""Restart supervisor: a checkpoint-restore training loop with a retry
budget — the port of ``repro/runtime/supervisor.py``.

  run → SimulatedFailure → restore the latest checkpoint → re-plan the
  mesh for the surviving devices (elastic) → resume at the step after it.

The training function is handed ``(start_step, restored_state)`` and
checkpoints through the manager; the data pipeline's determinism by step
(:mod:`repro_torch.data.pipeline`) makes the resumed run bit-identical to
an uninterrupted one on the same mesh. The re-plan lives in the
``restore_fn`` (:meth:`repro_torch.launch.train.TrainLoop.restore_state`):
it plans a mesh for the ranks that remain
(:func:`repro_torch.runtime.elastic.plan_mesh_shape`) and restores the
checkpoint's slices onto it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.failures import SimulatedFailure

__all__ = ["Supervisor", "RunResult"]


@dataclasses.dataclass
class RunResult:
    final_state: Any
    restarts: int
    failures: List[str]
    completed: bool
    wall_time_s: float


class Supervisor:
    def __init__(self, manager: CheckpointManager, *, max_restarts: int = 3):
        self.manager = manager
        self.max_restarts = max_restarts

    def run(self, train_fn: Callable[[int, Optional[Any]], Any],
            *, restore_fn: Optional[Callable[[int], Any]] = None) -> RunResult:
        """``train_fn(start_step, restored_state) -> final_state``;
        ``restore_fn(step) -> state`` rebuilds the state from the
        checkpoint (the supervisor assumes no state structure). More than
        ``max_restarts`` failures end the run, not completed."""
        restarts = 0
        failures: List[str] = []
        t0 = time.monotonic()
        while True:
            start_step = 0
            restored = None
            latest = self.manager.latest_step()
            if latest is not None and restore_fn is not None:
                restored = restore_fn(latest)
                start_step = latest + 1
            try:
                final_state = train_fn(start_step, restored)
                return RunResult(final_state, restarts, failures, True,
                                 time.monotonic() - t0)
            except SimulatedFailure as e:
                failures.append(str(e))
                restarts += 1
                if restarts > self.max_restarts:
                    return RunResult(None, restarts, failures, False,
                                     time.monotonic() - t0)
