"""Checkpoint watcher: edge-triggered "a newer step landed" polling (the
port of ``repro/checkpoint/watcher.py``).

The serve-side half of the train → checkpoint → serve-reload loop: a
:class:`~repro_torch.serve.router.ReplicaSet` polls the watcher once per
router step and starts a rolling weight reload when a new checkpoint
commits. Polling keys off :meth:`CheckpointManager.available_steps`, which
only lists steps whose manifest rename committed: a crash mid-save is
never reported.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointWatcher"]


class CheckpointWatcher:
    """Report each new latest checkpoint step exactly once.

    ``start_step`` is the step the caller already serves (``None``:
    nothing loaded yet, so any existing checkpoint is news). ``poll()``
    returns the new latest step the first time it is seen, else ``None``.
    A step is news only if it is newer than the last seen: retention
    shrinking ``available_steps`` never re-reports.
    """

    def __init__(self, manager: CheckpointManager, *,
                 start_step: Optional[int] = None):
        self.manager = manager
        self._seen = start_step

    def poll(self) -> Optional[int]:
        latest = self.manager.latest_step()
        if latest is None:
            return None
        if self._seen is None or latest > self._seen:
            self._seen = latest
            return latest
        return None
