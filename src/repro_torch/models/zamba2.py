"""Zamba2-style hybrid, zamba2-1.2b and its smokes — the port of
``repro/models/zamba2.py``: a Mamba-2 backbone and one **shared**
attention + SwiGLU block.

``n_layers`` Mamba-2 layers; after each group of ``attn_every`` of them the
shared block runs, with small per-application input norms; the layers past
the last whole group (the tail: 2 of zamba2-1.2b's 38) run after the last
application. The shared block's K/V (one cache per application point) is
the only state that grows with the sequence; the Mamba-2 states are
per-slot constants, dense in both cache layouts.

On the card the shared block is the served path's kernel work: its seven
projections run ``dot_moa`` through the configured MOA strategy, the
prefill's softmax·V the flash-attention kernel, and decode, paged or
dense-slot (the slot's cache rows walked as pages), the paged-attention
kernel. The Mamba-2 layers are plain PyTorch, as the reference's are plain
jnp (:mod:`repro_torch.layers.ssd`). A prefill chunk attends over its
prefix and itself with the one-shot ``full_attention``, as the reference's
does.

Decode steps update the cache **in place** and return it, as the dense
family's do; the speculative verify is ``T`` decode steps with per-step
snapshots of the Mamba-2 states (:mod:`repro_torch.models.verify_common`).
The K/V caches are kept in the compute type whatever ``kv_cache_dtype``
says: the reference's hybrid cache is ``cfg.cdtype``, never quantized.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.common import Params, dense_init, rms_norm
from repro_torch.layers.embedding import embed, init_embedding, unembed
from repro_torch.layers.mlp import swiglu
from repro_torch.layers.rope import apply_rope
from repro_torch.layers.ssd import init_ssm_state
from repro_torch.models import mamba2 as mamba_lm
from repro_torch.models import verify_common
from repro_torch.models.transformer import (_pad_seq, _train_attention,
                                            layer, layers, remat)

__all__ = ["SERVE_AUDIT",
           "init_params", "forward", "init_cache", "init_paged_cache",
           "prefill", "prefill_chunk", "decode_step", "paged_decode_step",
           "verify_step", "paged_verify_step", "commit_verified",
           "n_applications"]

#: the serve-path surface the static audits enumerate (the reference's
#: ``SERVE_AUDIT``; ``repro_torch.analysis.targets``)
SERVE_AUDIT = {
    "phases": ("prefill", "decode", "verify", "commit"),
    "paged": True,
    "kv_key": "kv",
    "suffix_prefill": False,
    "prefill_chunk": True,
}


def n_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def _schedule(cfg: ModelConfig):
    """``[(application index or None, [layer indices])]``: each group of
    ``attn_every`` layers followed by its application of the shared block,
    then the tail layers with none."""
    n_apps, g = n_applications(cfg), cfg.attn_every
    out = [(a, list(range(a * g, (a + 1) * g))) for a in range(n_apps)]
    if cfg.n_layers > n_apps * g:
        out.append((None, list(range(n_apps * g, cfg.n_layers))))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters with the reference's tree, shapes and
    initializers: the Mamba-2 layers stacked ``(L, ...)``, the shared
    attention and SwiGLU, and the per-application norms stacked
    ``(n_apps, d_model)``."""
    dt, d = cfg.pdtype, cfg.d_model
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    n_apps = n_applications(cfg)

    def w(d_in, d_out):
        return dense_init(generator, (d_in, d_out), dt, fan_in=d_in,
                          device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    emb = init_embedding(generator, cfg.vocab, d, tie=cfg.tie_embeddings,
                         dtype=dt, device=device)
    layers = mamba_lm.init_layers(cfg, generator, device)
    return {
        "embed": emb,
        "layers": layers,
        "shared_attn": {"wq": w(d, hd), "wk": w(d, kvd), "wv": w(d, kvd),
                        "wo": w(hd, d)},
        "shared_mlp": {"w_gate": w(d, cfg.d_ff), "w_up": w(d, cfg.d_ff),
                       "w_down": w(cfg.d_ff, d)},
        "app_norms": {"attn": {"scale": ones(n_apps, d)},
                      "mlp": {"scale": ones(n_apps, d)}},
        "final_norm": {"scale": ones(d)},
    }


# ---------------------------------------------------------------------------
# the shared block
# ---------------------------------------------------------------------------


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                compute_dtype=cfg.cdtype, strategy=cfg.moa_for("attention"))


def _mlp(params: Params, app_norm: Params, h, cfg: ModelConfig):
    """``h + swiglu(rms(h))`` of the shared MLP."""
    hn = rms_norm(app_norm["mlp"], h)
    return h + swiglu(params["shared_mlp"], hn, strategy=cfg.moa_for("mlp"),
                      compute_dtype=cfg.cdtype)


def _qkv(params: Params, app_norm: Params, h, positions, cfg: ModelConfig):
    """The shared block's normed q/k/v projections with RoPE."""
    hn = rms_norm(app_norm["attn"], h)
    q, k, v = attn_lib._project_qkv(
        params["shared_attn"], hn, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        compute_dtype=cfg.cdtype, strategy=cfg.moa_for("attention"))
    return (apply_rope(q, positions, theta=cfg.rope_theta),
            apply_rope(k, positions, theta=cfg.rope_theta), v)


def _attn_out(params: Params, h, o, cfg: ModelConfig):
    """``h + o @ wo`` (``o`` is ``(B, S, H, D)``)."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return h + attn_lib._moa_dot(
        o, params["shared_attn"]["wo"].to(cfg.cdtype),
        strategy=cfg.moa_for("attention"), compute_dtype=cfg.cdtype)


def _app_norm(params: Params, a: int) -> Params:
    return layer(params["app_norms"], a)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params: Params, batch: dict, cfg: ModelConfig):
    """Full forward → logits ``(B, S, V)`` in f32; differentiable (the
    training forward): each Mamba-2 layer under ``cfg.remat`` as the
    reference's scans are (the shared block is not), the shared block's
    softmax·V through the plain versions per ``cfg.attn_impl``
    (``transformer._train_attention``)."""
    h = embed(params["embed"], batch["tokens"], compute_dtype=cfg.cdtype)
    positions = torch.arange(h.shape[1], device=h.device)
    mamba = layers(params["layers"], cfg.n_layers)
    norms = layers(params["app_norms"], n_applications(cfg))
    for a, idx in _schedule(cfg):
        for i in idx:
            h = remat(cfg, mamba_lm.block, cfg, mamba[i], h)
        if a is None:
            continue
        o = _train_attention(cfg, *_qkv(params, norms[a], h, positions, cfg))
        h = _mlp(params, norms[a], _attn_out(params, h, o, cfg), cfg)
    h = rms_norm(params["final_norm"], h)
    return unembed(params["embed"], h, compute_dtype=cfg.cdtype)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _ssm_stack(cfg: ModelConfig, batch: int, device) -> Params:
    one = init_ssm_state(batch, d_model=cfg.d_model, d_state=cfg.d_state,
                         headdim=cfg.headdim, n_groups=cfg.n_groups,
                         d_conv=cfg.d_conv, expand=cfg.expand, device=device)
    return {k: v.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def _stack_apps(cfg: ModelConfig, one: Params) -> Params:
    return {k: v.unsqueeze(0).repeat((n_applications(cfg),) + (1,) * v.dim())
            for k, v in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Params:
    """Dense-slot decode state: the Mamba-2 states ``ssm`` (``(L, batch,
    ...)``), the shared block's K/V ``kv`` (``(n_apps, batch, max_len, Hk,
    D)`` in the compute type) and a 0-d int32 cursor."""
    kv = attn_lib.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                                dtype=cfg.cdtype, device=device)
    return {"ssm": _ssm_stack(cfg, batch, device),
            "kv": _stack_apps(cfg, kv),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_phys_blocks: int,
                     block_size: int, max_blocks: int, *, device) -> Params:
    """Paged decode state: the shared block's K/V in one page pool per
    application point (``(n_apps, n_phys, bs, Hk, D)``), the Mamba-2 states
    dense per slot, per-slot block tables and ``(n_slots,)`` cursors."""
    pool = attn_lib.init_kv_pool(n_phys_blocks, block_size, cfg.n_kv_heads,
                                 cfg.head_dim, dtype=cfg.cdtype,
                                 device=device)
    return {
        "ssm": _ssm_stack(cfg, n_slots, device),
        "kv": _stack_apps(cfg, pool),
        "block_tables": torch.zeros((n_slots, max_blocks), dtype=torch.int32,
                                    device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def prefill(params: Params, batch: dict, cfg: ModelConfig, *, max_len: int):
    """Prefill an exact-length prompt: ``(last-position logits, cache)``,
    the cache holding every layer's Mamba-2 state (``ssm``), each
    application's post-RoPE K/V padded with zeros to ``max_len`` (``kv``),
    and the cursor ``S``. The shared block's softmax·V is the flash kernel
    on the ``kernel`` backend (``attention.prefill_attention``)."""
    h = embed(params["embed"], batch["tokens"], compute_dtype=cfg.cdtype)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    states, kvs = [], []
    for a, idx in _schedule(cfg):
        for i in idx:
            h, h_last, tail = mamba_lm.layer_forward(
                cfg, layer(params["layers"], i), h)
            states.append({"h": h_last, "conv": tail.to(cfg.cdtype)})
        if a is None:
            continue
        norms = _app_norm(params, a)
        q, k, v = _qkv(params, norms, h, positions, cfg)
        o = attn_lib.prefill_attention(q, k, v, causal=True,
                                       q_chunk=cfg.q_chunk,
                                       kv_chunk=cfg.kv_chunk,
                                       backend=cfg.attn_backend)
        h = _mlp(params, norms, _attn_out(params, h, o, cfg), cfg)
        kvs.append({"k": _pad_seq(k, max_len), "v": _pad_seq(v, max_len)})
    h = rms_norm(params["final_norm"], h[:, -1:])
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    return logits, {"ssm": mamba_lm.stack_states(states),
                    "kv": {n: torch.stack([e[n] for e in kvs])
                           for n in ("k", "v")},
                    "pos": S}


def prefill_chunk(params: Params, batch: dict, cfg: ModelConfig, *,
                  state: Params, prefix_kv: Params):
    """Continue a chunked prefill from the carried Mamba-2 states and the
    shared block's cached prefix K/V.

    ``state`` is ``{"ssm", "pos"}`` of what :func:`prefill` or an earlier
    chunk returned (zeroed for chunk 0); ``prefix_kv`` holds each
    application's prefix K/V, ``{"k", "v"}: (n_apps, 1, P, Hk, D)`` in the
    compute type. The chunk's queries attend over ``concat(prefix, chunk)``
    with :func:`~repro_torch.layers.attention.full_attention` and explicit
    positions, as the reference's do. Returns ``(logits, {"ssm", "kv",
    "pos"})``, ``kv`` the chunk's own K/V ``(n_apps, B, S, Hk, D)``."""
    h = embed(params["embed"], batch["tokens"], compute_dtype=cfg.cdtype)
    S = h.shape[1]
    P = prefix_kv["k"].shape[2]
    dev = h.device
    positions_q = P + torch.arange(S, device=dev)
    positions_kv = torch.arange(P + S, device=dev)
    states, kvs = [], []
    for a, idx in _schedule(cfg):
        for i in idx:
            h, st = mamba_lm.continue_layer(cfg, layer(params["layers"], i),
                                            h, layer(state["ssm"], i))
            states.append(st)
        if a is None:
            continue
        norms = _app_norm(params, a)
        q, k, v = _qkv(params, norms, h, positions_q, cfg)
        k_full = torch.cat([prefix_kv["k"][a].to(cfg.cdtype), k], dim=1)
        v_full = torch.cat([prefix_kv["v"][a].to(cfg.cdtype), v], dim=1)
        o = attn_lib.full_attention(q, k_full, v_full, causal=True,
                                    positions_q=positions_q,
                                    positions_kv=positions_kv)
        h = _mlp(params, norms, _attn_out(params, h, o, cfg), cfg)
        kvs.append({"k": k, "v": v})
    h = rms_norm(params["final_norm"], h[:, -1:])
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    return logits, {"ssm": mamba_lm.stack_states(states),
                    "kv": {n: torch.stack([e[n] for e in kvs])
                           for n in ("k", "v")},
                    "pos": state["pos"] + S}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode(params: Params, cache: Params, tokens, cfg: ModelConfig,
            attend):
    """One token a row through every layer; ``attend(a, hn)`` is the
    shared block's attention of application ``a`` (writing its K/V in
    place). Advances the cursors in place."""
    h = embed(params["embed"], tokens, compute_dtype=cfg.cdtype)
    for a, idx in _schedule(cfg):
        for i in idx:
            h = mamba_lm.layer_decode(cfg, layer(params["layers"], i), h,
                                      layer(cache["ssm"], i))
        if a is None:
            continue
        norms = _app_norm(params, a)
        h = _mlp(params, norms, h + attend(a, rms_norm(norms["attn"], h)),
                 cfg)
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    cache["pos"].add_(1)
    return logits, cache


def decode_step(params: Params, cache: Params, tokens, cfg: ModelConfig):
    """One token step against the dense-slot cache (``pos`` 0-d or
    ``(B,)``), in place: ``(logits (B, 1, V), cache)``."""
    pos = cache["pos"]

    def attend(a, hn):
        return attn_lib.attention_decode(
            params["shared_attn"], hn, layer(cache["kv"], a), pos,
            backend=cfg.attn_backend, **_attn_kw(cfg))[0]

    return _decode(params, cache, tokens, cfg, attend)


def paged_decode_step(params: Params, cache: Params, tokens,
                      cfg: ModelConfig, *, live_blocks: Optional[int] = None):
    """:func:`decode_step` with the shared block's K/V read and written
    through the block tables (``cfg.attn_backend``: the paged-attention
    kernel or the gathered plain path, bounded by ``live_blocks``); the
    dense per-slot Mamba-2 states are as in the dense-slot step."""
    pos, tables = cache["pos"], cache["block_tables"]
    targets = attn_lib.paged_write_targets(tables, pos,
                                           cache["kv"]["k"].shape[2])

    def attend(a, hn):
        return attn_lib.attention_decode_paged(
            params["shared_attn"], hn, layer(cache["kv"], a), tables, pos,
            targets, backend=cfg.attn_backend, live_blocks=live_blocks,
            **_attn_kw(cfg))[0]

    return _decode(params, cache, tokens, cfg, attend)


# ---------------------------------------------------------------------------
# speculative verify: T scanned decode steps, Mamba-2 states snapshotted
# ---------------------------------------------------------------------------


def verify_step(params: Params, cache: Params, tokens, cfg: ModelConfig):
    """Score ``tokens (B, T)`` as T dense-slot decode steps: ``(logits (B,
    T, V), cache, snapshots)``; the K/V rows are written tentatively and
    ``pos`` is left at its pre-verify value."""
    return verify_common.scan_verify(
        lambda c, t: decode_step(params, c, t, cfg)[0], cache, tokens, "ssm")


def paged_verify_step(params: Params, cache: Params, tokens,
                      cfg: ModelConfig, *, live_blocks: Optional[int] = None):
    """Paged twin of :func:`verify_step`: the scanned step is
    :func:`paged_decode_step`; ``live_blocks`` must cover the deepest
    cursor plus the window."""
    return verify_common.scan_verify(
        lambda c, t: paged_decode_step(params, c, t, cfg,
                                       live_blocks=live_blocks)[0],
        cache, tokens, "ssm")


def commit_verified(cache: Params, keep, aux, cfg: ModelConfig) -> Params:
    """Restore each slot's Mamba-2 states at its accepted length and
    advance the cursors by ``keep``, in place."""
    del cfg
    return verify_common.scan_commit(cache, keep, aux, "ssm")
