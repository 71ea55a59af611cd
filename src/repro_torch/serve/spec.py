"""Speculative decoding: draft proposers and the acceptance rule — the port
of ``repro/serve/spec.py``.

* :func:`verify_accept` — greedy exact-match rows and temperature
  rejection-sampling rows in one call. Greedy rows are the reference's
  exactly (argmax with the first index on ties, the exact-match cumprod,
  ``n_acc``). Temperature rows draw from a ``torch.Generator`` and so
  cannot match ``jax.random`` draw for draw: their bar is that of
  :mod:`repro_torch.serve.sampling`, the same run under one seed.
* :class:`Drafter` — the proposer interface: per engine tick it sees every
  active slot's token history (prompt + generated, ending with the pending
  next token) and returns exactly ``k`` proposed tokens per slot.
* :class:`NgramDrafter` — prompt-lookup decoding (no model).
* :class:`DraftModelDrafter` — a model greedily continuing each slot on its
  own dense-slot cache, teacher-forced on the committed tokens each tick
  through its ``verify_step`` / ``commit_verified``; the rollout runs on a
  ``clone()`` of that cache (a recurrent drafter's: of its K/V and its
  recurrent state, not of its verify's snapshots). Its model calls run
  eagerly.
* :class:`OracleDrafter` — the target model drafting for itself;
  ``accept_prob < 1`` corrupts proposals from ``np.random.default_rng(seed)``
  as the reference does, so the accept patterns are the reference's.
* :func:`resolve_drafter` — the spec-string registry (``"ngram?n=3"``,
  ``"oracle?accept=0.5"``).
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.interop import tree_map
from repro_torch.models.verify_common import SNAP_KEY
from repro_torch.parallel.collectives import vocab_argmax, vocab_gather

__all__ = ["Drafter", "NgramDrafter", "DraftModelDrafter", "OracleDrafter",
           "verify_accept", "resolve_drafter"]


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------


def verify_accept(logits: torch.Tensor, draft: torch.Tensor,
                  temps: torch.Tensor, greedy: torch.Tensor,
                  generator: Optional[torch.Generator], *,
                  all_greedy: Optional[bool] = None):
    """Mixed-policy acceptance over one verify window.

    ``logits (B, T, V)`` are the verify pass's per-position target logits
    (position ``i`` is the distribution of the token after the ``i``-th fed
    token), ``draft (B, T-1)`` the proposed tokens, ``temps (B,)`` and
    ``greedy (B,)`` each slot's policy. Returns ``(out (B, T) int32, n_acc
    (B,) int32)``: slot ``b`` emits ``out[b, : n_acc[b] + 1]``, its accepted
    drafts followed by one correction or bonus token.

    Greedy rows accept a draft token iff it equals the target argmax and
    emit the argmax sequence itself. Temperature rows run exact rejection
    sampling against the deterministic proposal (accept ``d`` with
    probability ``p(d)``; on rejection sample from ``p`` with ``d`` zeroed,
    after a full window a bonus token from ``p``); an all-greedy batch draws
    nothing from ``generator``. ``all_greedy``: whether every row is
    greedy, where the caller knows it from its host state (``None``: read
    from ``greedy``, a device sync on CUDA).
    """
    draft = draft.to(device=logits.device, dtype=torch.long)
    greedy = greedy.to(logits.device)
    g = vocab_argmax(logits).to(torch.int32)                       # (B, T)
    acc = draft == g[:, :-1]
    sampled = not (bool(greedy.all()) if all_greedy is None
                   else all_greedy)
    if sampled:
        logits = vocab_gather(logits)          # whole rows on a mesh
    B, T, V = logits.shape
    if sampled:
        temps = torch.clamp(temps.to(logits.device).float(), min=1e-6)
        lp = logits.float() / temps[:, None, None]
        p = torch.softmax(lp, dim=-1)
        p_draft = p[:, :-1].gather(-1, draft[..., None])[..., 0]   # (B, T-1)
        u = torch.rand((B, T - 1), generator=generator,
                       device=logits.device)
        acc = torch.where(greedy[:, None], acc, u < p_draft)
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    if not sampled:
        return g, n_acc.to(torch.int32)
    # residual sample at the rejection position, bonus after a full window
    resid = p[:, :-1].scatter(-1, draft[..., None], 0.0)
    resid_tok = torch.multinomial(
        torch.clamp(resid, min=1e-30).reshape(-1, V), 1,
        generator=generator).reshape(B, T - 1)
    bonus_tok = torch.multinomial(p[:, -1], 1, generator=generator)
    idx = torch.arange(T - 1, device=logits.device)[None]
    cont = torch.where(idx < n_acc[:, None], draft, resid_tok)
    out_sampled = torch.cat([cont, bonus_tok], dim=1).to(torch.int32)
    out = torch.where(greedy[:, None], g, out_sampled)
    return out, n_acc.to(torch.int32)


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


class Drafter(abc.ABC):
    """Draft proposer for the engine's speculative decode tick.

    Lifecycle: the engine calls :meth:`bind` once at construction, then
    :meth:`admit` / :meth:`release` as requests enter and leave slots, and
    :meth:`propose` once per verify tick. ``draft_steps`` counts draft
    model calls (0 for model-free drafters).
    """

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"draft window k must be >= 1, got {k}")
        self.k = k
        self.draft_steps = 0

    def bind(self, engine) -> None:
        """Called once by the engine before serving starts."""

    def admit(self, slot: int, prompt: Sequence[int]) -> None:
        """A request entered ``slot`` with this prompt."""

    def release(self, slot: int) -> None:
        """The request in ``slot`` finished."""

    @abc.abstractmethod
    def propose(self, histories: Dict[int, Sequence[int]]
                ) -> Dict[int, List[int]]:
        """Exactly ``k`` continuation tokens per active slot;
        ``histories[slot]`` is the slot's prompt plus every committed
        token, the last being the pending next token."""


class NgramDrafter(Drafter):
    """Prompt-lookup decoding: the longest suffix n-gram (``max_ngram``
    down to 1) that reoccurs earlier in the history selects its most
    recent prior occurrence, and the ``k`` tokens that followed it are the
    draft (padded by repeating the last token)."""

    def __init__(self, k: int, *, max_ngram: int = 3):
        super().__init__(k)
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, histories):
        return {slot: self._lookup(list(hist))
                for slot, hist in histories.items()}

    def _lookup(self, hist: List[int]) -> List[int]:
        pad = [hist[-1]] * self.k
        for n in range(min(self.max_ngram, len(hist) - 1), 0, -1):
            pat = hist[-n:]
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == pat:
                    cont = hist[start + n:start + n + self.k]
                    if cont:
                        return cont + pad[:self.k - len(cont)]
        return pad


class DraftModelDrafter(Drafter):
    """A model greedily continuing every slot on its own dense-slot cache
    (``n_slots × max_len``, on the engine's device).

    Each tick teacher-forces the committed tokens (one ``verify_step`` over
    the padded per-slot deltas, committed at each slot's delta length),
    then rolls out ``k - 1`` greedy decode steps on a ``clone()`` of the
    synced cache, so speculation never pollutes it. Any model with an exact
    verify (``Model.supports_spec_decode``) can draft.
    """

    def __init__(self, model, params, k: int):
        super().__init__(k)
        if not model.supports_spec_decode:
            raise ValueError(
                f"draft model family {model.cfg.family!r} has no exact "
                "multi-token verify, so its state cannot be re-synced "
                "after a rejected speculation")
        self.model = model
        self.params = params

    def bind(self, engine) -> None:
        self.max_len = engine.max_len
        self.n_slots = engine.n_slots
        self.device = engine.device
        self._bucket_for = engine.scheduler.bucket_for
        cache = self.model.init_cache(self.n_slots, self.max_len,
                                      device=self.device)
        cache["pos"] = torch.zeros((self.n_slots,), dtype=torch.int32,
                                   device=self.device)
        self.cache = cache
        self._consumed: Dict[int, int] = {}

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @torch.no_grad()
    def admit(self, slot, prompt):
        from repro_torch.serve.engine import _write_slot

        p = len(prompt)
        toks = np.asarray(prompt, np.int32)[None, :]
        if self.model.supports_padded_prefill:
            padded = np.zeros((1, self._bucket_for(p)), np.int32)
            padded[0, :p] = toks[0]
            _, pre = self.model.prefill(self.params,
                                        {"tokens": self._dev(padded)},
                                        max_len=self.max_len, prompt_len=p)
        else:
            _, pre = self.model.prefill(self.params,
                                        {"tokens": self._dev(toks)},
                                        max_len=self.max_len)
        _write_slot(self.cache, pre, slot)
        self._consumed[slot] = p
        self.draft_steps += 1

    def release(self, slot):
        self._consumed.pop(slot, None)

    @torch.no_grad()
    def propose(self, histories):
        slots = sorted(histories)
        hists = {s: list(histories[s]) for s in slots}
        deltas = {s: hists[s][self._consumed[s]:] for s in slots}
        B, k = self.n_slots, self.k
        # teacher-force the committed deltas in one window of fixed width
        # k + 1 (a tick commits at most k drafts + 1 correction); padding
        # past a slot's delta is committed away by its keep count
        n_tf = max(max(len(d) for d in deltas.values()), k + 1)
        tf_toks = np.zeros((B, n_tf), np.int32)
        keep = np.zeros((B,), np.int32)
        last = np.zeros((B,), np.int64)
        for s in slots:
            tf_toks[s, : len(deltas[s])] = deltas[s]
            keep[s] = len(deltas[s])
            last[s] = len(deltas[s]) - 1
        logits, cache, aux = self.model.verify_step(
            self.params, self.cache, self._dev(tf_toks))
        self.cache = self.model.commit_verified(cache, self._dev(keep), aux)
        self.draft_steps += n_tf
        first = vocab_argmax(logits[torch.arange(B, device=self.device),
                                    self._dev(last)])
        drafts = np.zeros((B, k), np.int32)
        drafts[:, 0] = first.cpu().numpy()
        # greedy rollout of the remaining k - 1 drafts on a throwaway copy
        # (a recurrent drafter's verify snapshots are not part of it)
        if k > 1:
            work = {key: tree_map(torch.clone, tree)
                    for key, tree in self.cache.items() if key != SNAP_KEY}
            cur, rolled = first.to(torch.int32), []
            for j in range(1, k):
                lg, work = self.model.decode_step(self.params, work,
                                                  cur[:, None])
                cur = vocab_argmax(lg[:, -1]).to(torch.int32)
                rolled.append(cur)
                self.draft_steps += 1
            # one copy to the host for the whole rollout
            drafts[:, 1:] = torch.stack(rolled, dim=1).cpu().numpy()
        for s in slots:
            self._consumed[s] = len(hists[s])
        return {s: drafts[s].tolist() for s in slots}


class OracleDrafter(DraftModelDrafter):
    """The target model drafting for itself (the accept-rate dial).

    Greedy proposals from the target's own weights match its greedy
    continuation, so greedy requests accept every draft (up to the
    arithmetic of a ``k + 1``-row verify against one-row decode steps).
    ``accept_prob < 1`` independently corrupts each proposed token (off by
    one mod vocab, never the argmax), drawn from
    ``np.random.default_rng(seed)`` as the reference draws them.
    """

    def __init__(self, k: int, *, accept_prob: float = 1.0, seed: int = 0):
        Drafter.__init__(self, k)
        if not 0.0 <= accept_prob <= 1.0:
            raise ValueError(f"accept_prob must be in [0, 1], "
                             f"got {accept_prob}")
        self.accept_prob = accept_prob
        self._corrupt_rng = np.random.default_rng(seed)

    def bind(self, engine) -> None:
        self.model = engine.model
        self.params = engine.params
        super().bind(engine)

    def propose(self, histories):
        out = super().propose(histories)
        if self.accept_prob >= 1.0:
            return out
        vocab = self.model.cfg.vocab
        for s, toks in out.items():
            corrupt = self._corrupt_rng.random(self.k) >= self.accept_prob
            out[s] = [int((t + 1) % vocab) if c else int(t)
                      for t, c in zip(toks, corrupt)]
        return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def resolve_drafter(spec: str, k: int) -> Drafter:
    """A drafter from a spec string (``name?key=val&key=val``):
    ``"ngram"`` / ``"ngram?n=3"`` → :class:`NgramDrafter`; ``"oracle"`` /
    ``"oracle?accept=0.5&seed=1"`` → :class:`OracleDrafter`.
    :class:`DraftModelDrafter` needs a built model and parameters, so it
    has no spec-string form."""
    name, _, query = spec.partition("?")
    args: Dict[str, str] = {}
    if query:
        for pair in query.split("&"):
            key, _, val = pair.partition("=")
            if not key or not val:
                raise ValueError(f"bad drafter spec {spec!r}")
            args[key] = val
    if name == "ngram":
        drafter = NgramDrafter(k, max_ngram=int(args.pop("n", 3)))
    elif name == "oracle":
        drafter = OracleDrafter(k, accept_prob=float(args.pop("accept", 1.0)),
                                seed=int(args.pop("seed", 0)))
    else:
        raise ValueError(f"unknown drafter {name!r} (known: ngram, oracle)")
    if args:
        raise ValueError(f"drafter {name!r} got unknown keys "
                         f"{sorted(args)}")
    return drafter
