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
    one produced by the prefill logits. (The reference's ``priority`` and
    ``deadline_s`` come with SLO scheduling, ROADMAP Queue 1, item 8.)
    """

    uid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_s: float = 0.0
    sampler: Sampler = GREEDY
    eos_id: Optional[int] = None

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens must be "
                             f">= 1, got {self.max_new_tokens}")

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

