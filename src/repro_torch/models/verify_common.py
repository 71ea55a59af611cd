"""Scanned speculative verify for the families with recurrent state — the
port of ``repro/models/verify_common.py``.

Attention families verify a ``T``-token window in one wide call: their
decode state is position-addressed, so rejecting a draft suffix is a
cursor rewind. The SSM and hybrid families carry a recurrent state that
the draft tokens change irreversibly, so their verify is ``T`` calls of
the family's own one-token decode step, bit for bit the sequential
decode, with a snapshot of the recurrent leaves before the first step and
after every step. The commit restores, per slot, the snapshot at its
accepted length (snapshot 0, the pre-verify state, for a slot that
rejected everything or is idle).

The port's decode steps update the cache in place, so the snapshots go
into a buffer of the cache itself, ``cache["snap"]``: one ``(T + 1, stack,
B, ...)`` tensor a recurrent leaf, allocated at the first verify of a
window ``T`` and written again by every later one (a CUDA graph of the
verify binds it); :func:`scan_commit` reads it before the next verify.
Conventions shared with the attention families' verify: ``pos`` is left
at its pre-verify value (position-addressed leaves hold all ``T``
tentative writes) and the commit advances it by ``keep``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.layers.common import Params

__all__ = ["SNAP_KEY", "scan_verify", "scan_commit"]

#: the cache key of the snapshot buffer
SNAP_KEY = "snap"


def _snapshots(cache: Params, state_key: str, window: int) -> Params:
    """The cache's snapshot buffer for a window of ``window - 1`` tokens,
    made (once) on first use."""
    state = cache[state_key]
    buf = cache.get(SNAP_KEY)
    if buf is None or any(buf[name].shape[0] != window
                          or buf[name].shape[1:] != leaf.shape
                          for name, leaf in state.items()):
        buf = {name: torch.empty((window,) + tuple(leaf.shape),
                                 dtype=leaf.dtype, device=leaf.device)
               for name, leaf in state.items()}
        cache[SNAP_KEY] = buf
    return buf


def scan_verify(decode_fn: Callable, cache: Params, tokens: torch.Tensor,
                state_key: str) -> Tuple[torch.Tensor, Params, Params]:
    """Verify ``tokens (B, T)`` as ``T`` sequential ``decode_fn(cache,
    (B, 1) tokens) -> logits`` steps, each in place. ``cache[state_key]``
    holds the recurrent leaves ``(stack, B, ...)``; their state before the
    first step and after each step go to the snapshot buffer. Returns
    ``(logits (B, T, V), cache, snapshots)`` with ``pos`` rewound to its
    pre-verify value."""
    T = tokens.shape[1]
    snaps = _snapshots(cache, state_key, T + 1)
    state = cache[state_key]
    for name, leaf in state.items():
        snaps[name][0].copy_(leaf)
    logits = []
    for t in range(T):
        logits.append(decode_fn(cache, tokens[:, t:t + 1])[:, 0])
        for name, leaf in state.items():
            snaps[name][t + 1].copy_(leaf)
    cache["pos"].sub_(T)
    return torch.stack(logits, dim=1), cache, snaps


def scan_commit(cache: Params, keep: torch.Tensor, aux, state_key: str
                ) -> Params:
    """Restore each slot's recurrent leaves from snapshot ``keep[b]`` of
    ``aux`` (what :func:`scan_verify` returned; ``None``: the cache's own
    snapshot buffer, which is what it returns, so a caller that kept only
    the logits, as a CUDA graph's replay does, commits the same) and
    advance ``pos`` by ``keep``, in place (a 0-d cursor becomes a ``(B,)``
    one, as the reference's broadcast makes it)."""
    if aux is None:
        aux = cache[SNAP_KEY]
    idx = keep.long()
    rows = torch.arange(idx.shape[0], device=idx.device)
    for name, leaf in cache[state_key].items():
        # (T+1, stack, B, ...)[keep[b], :, b] → (B, stack, ...)
        leaf.copy_(aux[name][idx, :, rows].movedim(0, 1))
    pos = cache["pos"]
    if pos.dim() == 0:
        cache["pos"] = pos + keep.to(pos.dtype)
    else:
        pos.add_(keep.to(pos.dtype))
    return cache
