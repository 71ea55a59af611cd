"""Timing for the paper runners: CUDA events on the card, the host clock on
the CPU, and every time labelled with the clock that took it."""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

__all__ = ["time_us", "derived", "parse_derived"]


def time_us(fn: Callable[[], object], device: torch.device,
            reps: int = 5) -> Tuple[float, str]:
    """Mean microseconds of ``fn()`` over ``reps`` calls after one warm-up
    call, and the clock: ``"cuda_events"`` (device time between two events
    on the current stream) or ``"host"`` (CPU tensors)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) * 1e3 / reps, "cuda_events"
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6, "host"


def derived(**items) -> str:
    """``key=value;key=value`` in the given order (the reference's
    ``derived`` format)."""
    return ";".join(f"{k}={v}" for k, v in items.items())


def parse_derived(s: str) -> dict:
    """``"a=1(paper:0);b=x"`` → ``{"a": "1(paper:0)", "b": "x"}``."""
    return dict(item.split("=", 1) for item in s.split(";") if item)
