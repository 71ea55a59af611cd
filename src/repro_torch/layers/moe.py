"""Mixture-of-Experts layer: top-k router + capacity scatter dispatch — the
port of ``repro/layers/moe.py``.

Per group of tokens: router logits → top-k expert ids and renormalised
gates; each (token, choice) claims a slot in its expert's capacity buffer,
ranked by a cumsum over the one-hot assignments in token-major order;
tokens scatter into ``(G, E, C, d)``; the experts run a SwiGLU, each
contraction one batched call over the expert axis
(:meth:`repro_torch.moa.MOAStrategy.batched_dot`: one ``dot_moa`` launch on
the card); the outputs are gathered back and the top-k gate-weighted rows
combined by the strategy's ``sum`` (``moa_reduce`` on the card). Choices
over capacity are dropped; the Switch-style load-balance loss is returned.

On a mesh that splits ``experts`` over ``model`` (expert parallelism) the
router and the routing stay replicated, so every rank picks the same
experts; each rank runs the batched contractions of its own ``E / M``
experts, combines the top-k choices that landed on them (the others as
exact zeros) and the f32 partial combines are summed over the ranks
before the one cast. Under autograd the dispatched tokens and the gates
enter the split computation through the column op, so their gradients sum
the ranks' partial ones, and the combine's sum is the row op. On a data
axis each rank routes its own rows: its groups are the global batch's
(``G`` from the global token count, a whole number of groups a rank), or
any, where no choice can be dropped (the dropless regime); and the
load-balance loss reads the global batch's ``density`` and mean
``probs``, summed over ``data`` as GSPMD computes them.

Where PyTorch differs from JAX, the port pins the reference's semantics:

* top-k keeps the lower expert index first on ties (``lax.top_k``): a
  stable descending sort, where ``torch.topk`` promises no order;
* the dispatch scatter adds (``.at[].add``): every dropped choice sends an
  exact zero row to slot 0 of its expert, where it may meet a kept row, so
  the scatter is an ``index_add_`` (adding exact zeros leaves the kept row's
  value, in any order), never a plain ``index_put_`` on duplicate indices.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.layers.common import Params, dense_init
from repro_torch.layers.numerics import silu_f32
from repro_torch.moa import active_strategy
from repro_torch.parallel.collectives import (column_input,
                                              reduce_partial, split)
from repro_torch.parallel.sharding import active_shard

__all__ = ["Routing", "init_moe", "route", "moe_forward"]


def init_moe(generator: torch.Generator, *, d_model: int, d_ff: int,
             n_experts: int, dtype=torch.float32, device=None) -> Params:
    """One layer's router and expert weights (stddev ``1/sqrt(fan_in)``)."""
    def w(shape, fan_in):
        return dense_init(generator, shape, dtype, fan_in=fan_in,
                          device=device)

    return {"router": w((d_model, n_experts), d_model),
            "w_gate": w((n_experts, d_model, d_ff), d_model),
            "w_up": w((n_experts, d_model, d_ff), d_model),
            "w_down": w((n_experts, d_ff, d_model), d_ff)}


class Routing(NamedTuple):
    """One call's routing: router ``probs (G, tg, E)`` (f32), the top-k
    ``gates`` (renormalised) and ``expert_ids (G, tg, k)``, and per
    (token, choice) in token-major order its capacity ``slot (G, tg*k)``
    and ``keep`` mask; ``capacity`` rows per expert and group."""

    probs: torch.Tensor
    gates: torch.Tensor
    expert_ids: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` (int64) without its range check, which reads
    the ids back to the host on the CPU (the ids are top-k indices, in
    range by construction)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def route(router_logits: torch.Tensor, *, n_experts: int, top_k: int,
          capacity_factor: float) -> Routing:
    """Top-k routing and per-group capacity ranks of ``router_logits (G,
    tg, E)`` (f32)."""
    G, tg, _ = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    # lax.top_k: the larger value first, the lower index first on ties
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    expert_ids = order[..., :top_k]
    gates = torch.gather(probs, -1, expert_ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # truncated as Python truncates: at 4 decode slots, 1 row an expert
    capacity = max(int(tg * top_k / n_experts * capacity_factor), 1)
    flat_ids = expert_ids.reshape(G, tg * top_k)          # token-major
    onehot = _one_hot(flat_ids, n_experts)
    ranks = torch.cumsum(onehot, dim=1) - onehot
    slot = (ranks * onehot).sum(-1)
    return Routing(probs, gates, expert_ids, slot, slot < capacity, capacity)


def moe_forward(params: Params, x: torch.Tensor, *, n_experts: int,
                top_k: int, capacity_factor: float = 1.25,
                group_size: int = 4096, compute_dtype=torch.bfloat16,
                strategy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE to ``x (B, S, d)``; returns ``(y, aux_loss)``.

    Tokens are split into G groups of about ``group_size`` (capacity
    applies per group). ``strategy`` (``cfg.moa_for("moe")``) schedules the
    router and expert contractions and the top-k combine; ``None`` with no
    active scope keeps plain f32 products and ``torch.sum``."""
    B, S, d = x.shape
    T = B * S
    G = _groups(T, group_size, n_experts=n_experts, top_k=top_k,
                capacity_factor=capacity_factor)
    tg = T // G
    xt = x.reshape(G, tg, d).to(compute_dtype)
    strat = active_strategy(strategy)

    def expert_dot(operands, weights):
        """``(G, E, C, a) x (E, a, b) -> (G, E, C, b)``."""
        w = weights.to(compute_dtype)
        if strat is None:
            return torch.einsum("gecd,edf->gecf", operands.float(),
                                w.float()).to(compute_dtype)
        return strat.batched_dot(operands, w, out_dtype=compute_dtype)

    router = params["router"].to(compute_dtype)
    if strat is None:
        logits = torch.einsum("gtd,de->gte", xt.float(), router.float())
    else:
        logits = strat.dot(xt, router, out_dtype=torch.float32)
    r = route(logits.float(), n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    C = r.capacity
    flat_ids = r.expert_ids.reshape(G, tg * top_k)
    keep = r.keep[..., None]
    safe_slot = torch.where(r.keep, r.slot, torch.zeros_like(r.slot))

    # dispatch: token-major repeat (jnp.repeat), dropped choices as zero
    # rows at slot 0 of their expert, added into the capacity buffers; the
    # repeat as a broadcast, whose backward is a sum over the k copies in
    # a fixed order (repeat_interleave's adds them with atomics on CUDA)
    xrep = xt[:, :, None].expand(G, tg, top_k, d).reshape(G, tg * top_k, d)
    contrib = torch.where(keep, xrep, torch.zeros_like(xrep))
    experts = split("experts")
    if experts:                      # dispatched to this rank's experts
        contrib = column_input(contrib, "experts")
    g_idx = torch.arange(G, device=x.device)[:, None]
    dest = ((g_idx * n_experts + flat_ids) * C + safe_slot).reshape(-1)
    buf = torch.zeros((G * n_experts * C, d), dtype=compute_dtype,
                      device=x.device)
    buf.index_add_(0, dest, contrib.reshape(-1, d))
    buf = buf.reshape(G, n_experts, C, d)
    gates_k = r.gates
    if experts:                      # this rank's experts only
        gates_k = column_input(gates_k, "experts")
        lo, hi = experts
        buf = buf[:, lo:hi].contiguous()
        mine = (flat_ids >= lo) & (flat_ids < hi)
        dest = ((g_idx * (hi - lo) + torch.clamp(flat_ids - lo, 0,
                                                   hi - lo - 1)) * C
                + safe_slot).reshape(-1)
        keep = keep & mine[..., None]

    gates = expert_dot(buf, params["w_gate"])
    ups = expert_dot(buf, params["w_up"])
    h = silu_f32(gates, out_dtype=compute_dtype) * ups
    out_buf = expert_dot(h, params["w_down"])

    # combine: the token-side MOA over the k gate-weighted expert rows
    gathered = out_buf.reshape(-1, d)[dest].reshape(G, tg * top_k, d)
    gathered = torch.where(keep, gathered, torch.zeros_like(gathered))
    weighted = gathered * gates_k.reshape(G, tg * top_k, 1).to(compute_dtype)
    weighted = weighted.reshape(G, tg, top_k, d)
    if experts:                      # f32 partials, summed over ranks
        part = weighted.float().sum(dim=2) if strat is None \
            else strat.sum(weighted, axis=2).float()
        y = reduce_partial(part).to(compute_dtype)
    elif strat is None:
        y = torch.sum(weighted, dim=2)
    else:
        y = strat.sum(weighted, axis=2).to(compute_dtype)

    # Switch-style load-balance auxiliary loss, over the global batch
    n_tok = T * _data_size()
    density = reduce_partial(_one_hot(
        r.expert_ids[..., 0], n_experts).float().sum(dim=(0, 1)),
        "data") / n_tok
    mean_probs = reduce_partial(r.probs.sum(dim=(0, 1)), "data") / n_tok
    aux = n_experts * torch.sum(density * mean_probs)
    return y.reshape(B, S, d), aux


def _data_size() -> int:
    shard = active_shard()
    return 1 if shard is None or shard.data is None else shard.data.size


def _groups(T: int, group_size: int, *, n_experts: int, top_k: int,
            capacity_factor: float) -> int:
    """How many capacity groups this rank's ``T`` tokens form: those of one
    device over the global batch (``T`` times the data ranks), of which
    each rank holds a whole number; else, in the dropless regime (no
    choice dropped however the tokens group), as one device would group
    ``T`` tokens. A capacity-limited MoE whose groups would straddle data
    ranks is refused."""
    def groups(n):
        g = max(n // group_size, 1)
        while n % g:
            g -= 1
        return g

    D = _data_size()
    g_all = groups(T * D)
    if D == 1:
        return g_all
    if g_all % D == 0:
        return g_all // D
    if capacity_factor >= n_experts / max(top_k, 1):
        return groups(T)
    raise ValueError(
        f"a capacity-limited MoE ({capacity_factor=}) over a data axis of "
        f"{D}: the global batch's {T * D} tokens form {g_all} capacity "
        f"group(s), which do not split into whole groups a rank; use a "
        f"global batch of a multiple of {D} groups of {group_size} tokens")
