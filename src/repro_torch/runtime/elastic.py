"""Fleet and mesh sizing for however many devices are there (the port of
``repro/runtime/elastic.py``): host arithmetic only.

Policy: keep the model axis fixed if possible (its degree is dictated by
memory per device), shrink the data axis; fall back to shrinking the model
axis when too few devices remain. The serve CLI's ``--replicas -1`` plans
the replica count from ``torch.cuda.device_count()``; a meshed trainer's
restart plans its mesh for the ranks that remain and restores its
checkpoint onto it (``CheckpointManager.restore(mesh=, specs=)``, each rank
its own slices), in :meth:`repro_torch.launch.train.TrainLoop.
restore_state`.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["plan_mesh_shape", "plan_replicas"]


def plan_mesh_shape(n_devices: int, *, model_parallel: int = 16,
                    min_model_parallel: int = 1) -> Tuple[int, int]:
    """→ (data, model) using as many of ``n_devices`` as possible."""
    if n_devices < 1:
        raise ValueError("no devices")
    mp = min(model_parallel, n_devices)
    while mp >= min_model_parallel:
        if n_devices % mp == 0:
            return (n_devices // mp, mp)
        mp -= 1
    return (n_devices, 1)


def plan_replicas(n_devices: int, *, devices_per_replica: int = 1,
                  min_replicas: int = 1) -> int:
    """Serve-fleet sizing: how many replicas the surviving devices carry.

    Each replica needs ``devices_per_replica`` devices (its model-parallel
    degree is a memory fact, so the replica count is the elastic axis: a
    lost host shrinks the fleet, never a replica). Floors at
    ``min_replicas`` so a degraded fleet keeps serving even when the device
    budget formally rounds to zero.
    """
    if n_devices < 1:
        raise ValueError("no devices")
    if devices_per_replica < 1:
        raise ValueError("devices_per_replica must be >= 1")
    if min_replicas < 1:
        raise ValueError("min_replicas must be >= 1")
    return max(min_replicas, n_devices // devices_per_replica)
