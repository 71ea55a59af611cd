"""Token sampling for the engine (``repro/serve/sampling.py``).

A :class:`Sampler` carries one request's policy; :func:`sample_batch`
applies a mixed batch of policies in one call. Greedy is ``argmax`` (first
index on ties, as ``jnp.argmax``); temperature sampling draws from a
``torch.Generator`` and so cannot match ``jax.random`` draw for draw — its
bar is determinism under a seed. On a mesh that splits the vocabulary the
logits are this rank's slice: greedy takes the global argmax
(:func:`repro_torch.parallel.collectives.vocab_argmax`) and a temperature
row samples from its whole row (``vocab_gather``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.parallel.collectives import vocab_argmax, vocab_gather

__all__ = ["Sampler", "GREEDY", "sample_batch"]


def _categorical(logits: torch.Tensor, temperature: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Next-token policy: ``temperature <= 0`` is greedy argmax, otherwise
    categorical sampling over ``logits / temperature``."""

    temperature: float = 0.0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def __call__(self, logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        """``logits (B, vocab)`` → ``(B,)`` int32 token ids; ``generator``
        is required unless greedy."""
        if self.greedy:
            return vocab_argmax(logits).to(torch.int32)
        if generator is None:
            raise ValueError("non-greedy Sampler needs a torch.Generator")
        temp = torch.tensor(self.temperature, device=logits.device)
        return _categorical(vocab_gather(logits), temp,
                            generator).to(torch.int32)


#: the default policy (argmax decode)
GREEDY = Sampler(0.0)


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor,
                 greedy_mask: torch.Tensor,
                 generator: Optional[torch.Generator], *,
                 all_greedy: Optional[bool] = None) -> torch.Tensor:
    """Per-row mixed sampling: ``logits (B, vocab)`` → ``(B,)`` int32.

    ``temperature (B,)`` and ``greedy_mask (B,)`` carry each slot's policy;
    greedy rows take the argmax, the rest sample at their own temperature.
    An all-greedy batch draws nothing from ``generator``. ``all_greedy``:
    whether every row is greedy, where the caller knows it from its host
    state (``None``: read from ``greedy_mask``, a device sync on CUDA).
    """
    greedy_tok = vocab_argmax(logits).to(torch.int32)
    greedy_mask = greedy_mask.to(logits.device)
    if all_greedy is None:
        all_greedy = bool(greedy_mask.all())
    if all_greedy:
        return greedy_tok
    temp = torch.clamp(temperature.to(logits.device), min=1e-6)[:, None]
    sampled = _categorical(vocab_gather(logits), temp,
                           generator).to(torch.int32)
    return torch.where(greedy_mask, greedy_tok, sampled)
