"""Checkpoints of the port (:mod:`repro.checkpoint`): the same on-disk
format, so a checkpoint crosses between the two packages both ways, and
the watcher that turns a newly committed step into a fleet reload."""

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.watcher import CheckpointWatcher

__all__ = ["CheckpointManager", "CheckpointWatcher"]
