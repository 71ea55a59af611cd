"""Deterministic, restart-safe synthetic data pipeline — the port of
``repro/data/pipeline.py``.

* **Stateless indexing** — ``batch_for_step(step)`` is a pure function of
  ``(seed, step)``: its draws come from a host ``torch.Generator`` seeded
  from both, so a restarted job resumes mid-epoch with zero drift and no
  iterator state in the checkpoint. The draws cannot match ``jax.random``'s
  draw for draw; what carries over is the process, the fields, keys,
  shapes and dtypes, and determinism under a seed.
* **Host sharding** — each host takes its contiguous slice of the global
  batch (:func:`host_shard`); a meshed trainer's data rank takes its rows
  so, every rank building the same global batch
  (:func:`repro_torch.launch.steps.local_batch`).
* **Learnability** — tokens follow a noisy affine bigram process
  (``next = (a·prev + c) mod V`` with probability ``1 - noise``, the
  reference's map in the same int32 arithmetic), so a small model reduces
  its loss within tens of steps.

Batches are made on the host (CPU tensors); the trainer moves them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = ["SyntheticLMData", "host_shard"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    family: str = "dense"      # encoder family gets frames/mask/targets
    d_model: int = 0           # encoder/vlm stub embedding dim
    n_patches: int = 0         # vlm prefix

    def _bigram_next(self, prev):
        a = 2 * (self.seed % 1000) + 1  # odd multiplier → full-period affine map
        c = (self.seed * 7919 + 13) % self.vocab
        return (prev * a + c) % self.vocab

    def _generator(self, step: int) -> torch.Generator:
        """The host generator of ``step``: seeded from ``(seed, step)``,
        each taken modulo 2**32."""
        return torch.Generator().manual_seed(
            ((self.seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))

    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        """Global batch for ``step`` (pure function): ``tokens`` and
        ``labels`` ``(B, S - n_patches)`` int32 (plus ``patches`` ``(B,
        n_patches, d_model)`` f32 for a vlm), or for the encoder family
        ``frames`` ``(B, S, d_model)`` f32, ``mask`` bool, ``targets``
        int32."""
        g = self._generator(step)
        B, S = self.global_batch, self.seq_len
        if self.family == "encoder":
            frames = 0.02 * torch.randn((B, S, self.d_model), generator=g)
            mask = torch.rand((B, S), generator=g) < 0.35
            targets = torch.randint(0, self.vocab, (B, S), generator=g,
                                    dtype=torch.int32)
            return {"frames": frames, "mask": mask, "targets": targets}

        s_text = S - self.n_patches
        first = torch.randint(0, self.vocab, (B,), generator=g,
                              dtype=torch.int32)
        rand = torch.randint(0, self.vocab, (s_text, B), generator=g,
                             dtype=torch.int32)
        use_noise = torch.rand((s_text, B), generator=g) < self.noise
        # one extra token so labels are a clean shift
        tokens_ext = torch.empty((B, s_text + 1), dtype=torch.int32)
        tokens_ext[:, 0] = prev = first
        for t in range(s_text):
            prev = torch.where(use_noise[t], rand[t], self._bigram_next(prev))
            tokens_ext[:, t + 1] = prev
        batch = {"tokens": tokens_ext[:, :-1].contiguous(),
                 "labels": tokens_ext[:, 1:].contiguous()}
        if self.n_patches:
            batch["patches"] = 0.02 * torch.randn(
                (B, self.n_patches, self.d_model), generator=g)
        return batch

    def iterate(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch_for_step(step)
            step += 1


def host_shard(batch: Dict[str, torch.Tensor], host_id: int,
               n_hosts: int) -> Dict[str, torch.Tensor]:
    """This host's contiguous slice of the global batch (batch-dim split)."""
    def slice_leaf(a):
        b = a.shape[0]
        if b % n_hosts:
            raise ValueError(f"batch {b} does not split over {n_hosts} hosts")
        per = b // n_hosts
        return a[host_id * per:(host_id + 1) * per]

    return {k: slice_leaf(v) for k, v in batch.items()}
