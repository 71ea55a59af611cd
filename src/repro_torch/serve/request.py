"""Request and result types for the serve engine (copied from
``repro/serve/request.py``).

Units: all timestamps are **seconds on the engine clock** (0 = engine
start); all lengths are **tokens**; token ids are vocabulary indices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

from repro_torch.serve.metrics import RequestMetrics
from repro_torch.serve.sampling import GREEDY, Sampler

__all__ = ["FinishReason", "Request", "RequestResult"]


class FinishReason(str, enum.Enum):
    EOS = "eos"          # sampled the request's eos_id
    LENGTH = "length"    # produced max_new_tokens


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request (immutable; prompt stored as a token tuple).

    ``arrival_s`` is the open-loop arrival offset in seconds from engine
    start; the scheduler will not admit the request before the engine clock
    reaches it. ``max_new_tokens`` counts generated tokens including the
    one produced by the prefill logits.

    ``priority`` and ``deadline_s`` only influence admission order under
    the scheduler's ``"slo"`` policy (higher priority first, then earliest
    deadline); FIFO ignores both. ``deadline_s`` is the **absolute** engine
    time by which the first token should be emitted (TTFT SLO) — deadline
    attainment in :mod:`repro_torch.serve.metrics` compares it against
    ``first_token_s`` on the same clock.
    """

    uid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_s: float = 0.0
    sampler: Sampler = GREEDY
    eos_id: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens must be "
                             f">= 1, got {self.max_new_tokens}")
        if self.deadline_s is not None and self.deadline_s <= self.arrival_s:
            raise ValueError(
                f"request {self.uid}: deadline_s {self.deadline_s} must be "
                f"after arrival_s {self.arrival_s} (absolute engine time)")

    @property
    def prompt_len(self) -> int:
        """Prompt length in tokens."""
        return len(self.prompt)

    def prompt_array(self) -> np.ndarray:
        """Prompt as a ``(1, prompt_len)`` int32 array (prefill layout)."""
        return np.asarray(self.prompt, np.int32)[None, :]


@dataclasses.dataclass
class RequestResult:
    """Completed request: generated tokens + per-request metrics."""

    uid: int
    tokens: np.ndarray            # (new_tokens,) int32 generated ids
    prompt_len: int               # tokens
    slot: int                     # decode slot the request ran in
    finish_reason: FinishReason
    metrics: RequestMetrics

    def to_json(self) -> dict:
        """JSON-able record (the reference's per-request schema)."""
        return {
            "uid": self.uid,
            "prompt_tokens": self.prompt_len,
            "new_tokens": int(self.tokens.size),
            "slot": self.slot,
            "finish_reason": self.finish_reason.value,
            **self.metrics.to_json(),
        }
