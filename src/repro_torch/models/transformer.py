"""Dense GQA transformer LM — the port of ``repro/models/transformer.py``:
the dense family, the encoder (hubert-xlarge: bidirectional, no RoPE, a
GELU MLP with biases, learned absolute positions and a mask embedding over
precomputed frame embeddings) and the VLM backbone (llava-next-34b: a
``mm_projector`` maps precomputed patch embeddings into a prefix of the
token sequence); the training forward and the serving functions.

Structure per layer (pre-norm): ``h += attn(rms(h)); h += mlp(rms(h))``.
Layer parameters are stacked on a leading ``L`` axis exactly as the
reference stacks them (``params["layers"]["attn"]["wq"]`` is
``(L, d_model, H·D)``); where the reference scans over that axis the port
loops over it, taking views.

Prefill's softmax·V runs the flash-attention kernel on the ``kernel``
attention backend (the reference calls its jnp twin there); paged decode
runs the paged-attention kernel; dense-slot decode and verify attend over
their cache through the same kernel, the cache's rows walked as pages
(``attention.dense_attention``; the plain version, the reference's jnp
``full_attention``, on the CPU or ``attn_backend="torch"``); every
projection runs ``dot_moa`` through the configured MOA strategy. The
causal forward (:func:`forward`, the training forward) attends through
the plain versions only, as the reference's does, and runs each layer under
``cfg.remat`` (:func:`remat`); its projections run ``dot_moa`` through the
MOA backend's ``autograd.Function`` (the plain f32 transpose rule
backward).

Both decode steps update the cache **in place** (KV rows or pool pages, and
the ``pos`` cursors) and return it, where the reference returns a new tree;
so do the speculative verify (its tentative K/V rows) and
:func:`commit_verified` (the cursors).

The serving functions take the layer's MLP as ``mlp(cfg, layer, h) -> h``
(default: the residual SwiGLU), so the MoE family
(:mod:`repro_torch.models.moe_transformer`) runs the same skeleton with its
expert layer, as the reference's MoE module repeats it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import tree_map
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.common import Params, dense_init, rms_norm
from repro_torch.layers.embedding import embed, init_embedding, unembed
from repro_torch.layers.mlp import gelu_mlp, init_gelu_mlp, swiglu
from repro_torch.layers.rope import apply_rope
from repro_torch.parallel.collectives import fsdp_layer
from repro_torch.parallel.sharding import (activate, active_context,
                                           active_shard)

__all__ = [
    "SERVE_AUDIT",
    "init_params", "layer", "layers", "remat", "embed_inputs", "forward",
    "encode",
    "init_cache", "init_paged_cache", "prefill", "prefill_suffix",
    "decode_step", "paged_decode_step", "verify_impl", "verify_step", "paged_verify_step",
    "commit_verified",
]

#: the serve-path surface the static audits enumerate (the reference's
#: ``SERVE_AUDIT``; ``repro_torch.analysis.targets``)
SERVE_AUDIT = {
    "phases": ("prefill", "decode", "verify", "commit"),
    "paged": True,
    "kv_key": "layers",
    "suffix_prefill": True,
}

#: ``mlp(cfg, layer params, h) -> h + mlp(rms(h))``
MLP = Callable


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator, device, *,
                mlp: Optional[Callable[[], Params]] = None) -> Params:
    """Random parameters with the reference's tree, shapes and
    initializers (truncated normals: stddev ``1/sqrt(fan_in)`` for weights,
    0.02 for the embedding table, ``d_model**-0.5`` for the untied
    unembedding; norm scales 1), drawn from ``generator`` on ``device`` in
    ``cfg.param_dtype``. The draws differ from ``jax.random``'s; parity
    tests move the reference's parameters across with :mod:`interop`.
    ``mlp()`` draws the layers' MLP entry after the embedding: by default
    ``{"mlp": ...}``, the SwiGLU's (the encoder's GELU MLP); the MoE family
    passes its experts'. The encoder adds ``pos_embed`` ``(min(max_position,
    32768), d)`` and ``mask_embed`` ``(d,)``, the VLM ``mm_projector.w``
    ``(d, d)``, each 0.02 × a normal draw."""
    dt, L, d = cfg.pdtype, cfg.n_layers, cfg.d_model
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def w(d_in, d_out):
        return dense_init(generator, (L, d_in, d_out), dt, fan_in=d_in,
                          device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    attn = {"wq": w(d, hd), "wk": w(d, kvd), "wv": w(d, kvd), "wo": w(hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", hd), ("bk", kvd), ("bv", kvd)):
            attn[name] = torch.zeros((L, width), dtype=dt, device=device)
    embed = init_embedding(generator, cfg.vocab, d, tie=cfg.tie_embeddings,
                           dtype=dt, device=device)
    if mlp is not None:
        mlp_entry = mlp()
    elif cfg.family == "encoder":
        mlp_entry = {"mlp": init_gelu_mlp(generator, d, cfg.d_ff, dt,
                                          lead=(L,), device=device)}
    else:
        mlp_entry = {"mlp": {"w_gate": w(d, cfg.d_ff), "w_up": w(d, cfg.d_ff),
                             "w_down": w(cfg.d_ff, d)}}
    params = {
        "embed": embed,
        "layers": {"attn_norm": {"scale": ones(L, d)}, "attn": attn,
                   "mlp_norm": {"scale": ones(L, d)}, **mlp_entry},
        "final_norm": {"scale": ones(d)},
    }

    def normal(*shape):
        return (0.02 * torch.randn(shape, generator=generator, device=device)
                ).to(dt)

    if cfg.family == "encoder":
        params["pos_embed"] = normal(min(cfg.max_position, 32768), d)
        params["mask_embed"] = normal(d)
    if cfg.family == "vlm":
        params["mm_projector"] = {"w": normal(d, d)}
    return params


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters (or KV pool) as views of the stacked tree."""
    return tree_map(lambda t: t[i], stacked)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention(cfg: ModelConfig, q, k, v):
    """Softmax·V over a whole prompt (``cfg.attn_impl``; causal but for
    the encoder) for the serving functions and the encoder's encode: the
    flash kernel on the ``kernel`` backend. On a mesh that replicates the
    KV heads beside split q heads, the rank's KV heads alone."""
    k, v = attn_lib.rank_kv(k), attn_lib.rank_kv(v)
    if cfg.attn_impl == "full":
        return attn_lib.full_attention(q, k, v, causal=cfg.is_causal)
    return attn_lib.prefill_attention(q, k, v, causal=cfg.is_causal,
                                      q_chunk=cfg.q_chunk,
                                      kv_chunk=cfg.kv_chunk,
                                      backend=cfg.attn_backend)


def _train_attention(cfg: ModelConfig, q, k, v):
    """The training forward's softmax·V (``cfg.attn_impl``; causal but for
    the encoder), as the reference's ``attention_forward``: the plain
    chunked twin or the one-shot scores, never a kernel (the kernel has no
    backward); the rank's KV heads alone, as :func:`_attention`."""
    k, v = attn_lib.rank_kv(k), attn_lib.rank_kv(v)
    if cfg.attn_impl == "full":
        return attn_lib.full_attention(q, k, v, causal=cfg.is_causal)
    return attn_lib.flash_attention(q, k, v, causal=cfg.is_causal,
                                    q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk)


def _mlp(cfg: ModelConfig, lyr: Params, h):
    """``h + swiglu(rms(h))`` (the encoder: ``gelu_mlp``)."""
    hn = rms_norm(lyr["mlp_norm"], h)
    fn = gelu_mlp if cfg.family == "encoder" else swiglu
    return h + fn(lyr["mlp"], hn, strategy=cfg.moa_for("mlp"),
                  compute_dtype=cfg.cdtype)


def _layer_qkv(cfg: ModelConfig, lyr: Params, h, positions):
    """RMSNorm, the q/k/v projections and RoPE (none for the encoder) of
    one layer."""
    hn = rms_norm(lyr["attn_norm"], h)
    q, k, v = attn_lib._project_qkv(
        lyr["attn"], hn, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, compute_dtype=cfg.cdtype,
        strategy=cfg.moa_for("attention"))
    if cfg.family != "encoder":
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _attn_out(cfg: ModelConfig, lyr: Params, h, o):
    """``h + o @ wo`` (``o`` is ``(B, S, H, D)``)."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return h + attn_lib._out_proj(o, lyr["attn"]["wo"].to(cfg.cdtype),
                                  strategy=cfg.moa_for("attention"),
                                  compute_dtype=cfg.cdtype)


def embed_inputs(params: Params, batch: dict, cfg: ModelConfig):
    """Token (+ modality prefix) embedding → ``(h, positions,
    text_offset)``.

    The encoder takes ``frames (B, T, d)`` (the stubbed frontend's frame
    embeddings), replaces the frames ``mask`` marks by ``mask_embed`` and
    adds ``pos_embed[:T]``; the VLM prepends ``patches (B, P, d) @
    mm_projector.w`` (a plain product: the reference's ``@`` runs outside
    any kernel) to the token embeddings, so the text starts at ``P``."""
    cd = cfg.cdtype
    if cfg.family == "encoder":
        frames = batch["frames"].to(cd)
        if "mask" in batch:
            frames = torch.where(batch["mask"][..., None],
                                 params["mask_embed"].to(cd), frames)
        T = frames.shape[1]
        h = frames + params["pos_embed"][:T].to(cd)[None]
        return h, torch.arange(T, device=h.device), 0
    tokens = batch["tokens"]
    h = embed(params["embed"], tokens, compute_dtype=cd)
    if cfg.family == "vlm":
        patches = batch["patches"].to(cd) @ params["mm_projector"]["w"].to(cd)
        h = torch.cat([patches, h], dim=1)
        return (h, torch.arange(h.shape[1], device=h.device),
                patches.shape[1])
    return h, torch.arange(tokens.shape[1], device=tokens.device), 0


def layers(stacked: Params, n_layers: int) -> list:
    """Every layer's parameters as views of the stacked tree, one
    ``unbind`` a leaf: under autograd one node then stacks the layers'
    gradients into the leaf's, where ``n_layers`` selects would each fill
    a leaf-sized buffer of zeros."""
    per = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda views: views[i], per) for i in range(n_layers)]


#: the products the ``"dots"`` remat policy saves (the plain route's; a
#: ``dot_moa`` launch is no aten op, so the kernel route recomputes it)
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.mm.dtype)


def _save_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _in_context(context, shard, fn, *args):
    with activate(*context, shard):
        return fn(*args)


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat`` where autograd records it (the
    reference's ``_remat`` of a scanned layer): ``"none"`` saves every
    activation; ``"dots"`` saves the products and recomputes the rest
    (``dots_with_no_batch_dims_saveable``; a selective checkpoint);
    anything else (``"full"``, the registry's default) keeps only the
    layer's inputs and recomputes the layer in the backward."""
    from torch.utils import checkpoint

    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    shard = active_shard()
    if shard is not None:
        # the backward's recompute may run on autograd's device thread,
        # which does not see this thread's mesh context: carry it along
        fn = functools.partial(_in_context, active_context(), shard, fn)
    if cfg.remat == "dots":
        return checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                checkpoint.create_selective_checkpoint_contexts,
                _save_products))
    return checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _block(cfg: ModelConfig, lyr: Params, h, positions,
           attention=_train_attention):
    """One layer of the forward: ``h += attn(rms(h)); h +=
    mlp(rms(h))`` (under FSDP on the layer's gathered weights)."""
    lyr = fsdp_layer(lyr)
    q, k, v = _layer_qkv(cfg, lyr, h, positions)
    return _mlp(cfg, lyr, _attn_out(cfg, lyr, h, attention(cfg, q, k, v)))


def forward(params: Params, batch: dict, cfg: ModelConfig, *,
            attention=_train_attention):
    """Full forward → logits ``(B, S_text, V)`` in f32 (the VLM's text
    positions only); differentiable: the training forward, each layer
    under ``cfg.remat``, attends through the plain versions
    (:func:`_train_attention`); :func:`encode` passes the serving
    ``attention``."""
    h, positions, text_off = embed_inputs(params, batch, cfg)
    for lyr in layers(params["layers"], cfg.n_layers):
        h = remat(cfg, _block, cfg, lyr, h, positions, attention)
    h = rms_norm(params["final_norm"], h)
    if text_off:
        h = h[:, text_off:]
    return unembed(params["embed"], h, compute_dtype=cfg.cdtype)


def encode(params: Params, batch: dict, cfg: ModelConfig):
    """The encoder's bidirectional encode (its "prefill": no cache, no
    decode step) → logits ``(B, T, V)``: :func:`forward` with the serving
    attention, the flash kernel on the ``kernel`` backend."""
    return forward(params, batch, cfg, attention=_attention)


# ---------------------------------------------------------------------------
# Serving: prefill + paged decode
# ---------------------------------------------------------------------------


def kv_dtype(cfg: ModelConfig) -> torch.dtype:
    """KV element type: int8 for a quantized cache, else the compute type."""
    return torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.cdtype


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Params:
    """Dense-slot decode state: per layer ``(batch, max_len, Hk, D)`` K/V
    (int8 plus f32 scales for a quantized cache), stacked ``(L, ...)``, and
    a 0-d int32 cursor (the engine makes it a ``(batch,)`` vector)."""
    one = attn_lib.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                 cfg.head_dim, dtype=kv_dtype(cfg),
                                 device=device)
    layers = {k: v.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * v.dim())
              for k, v in one.items()}
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_phys_blocks: int,
                     block_size: int, max_blocks: int, *, device) -> Params:
    """Paged decode state: one physical page pool per layer (stacked
    ``(L, n_phys, bs, Hk, D)``), per-slot int32 block tables (all zeros =
    every logical block on the write-trash page 0) and ``(n_slots,)`` int32
    position cursors."""
    one = attn_lib.init_kv_pool(n_phys_blocks, block_size, cfg.n_kv_heads,
                                cfg.head_dim, dtype=kv_dtype(cfg),
                                device=device)
    layers = {k: v.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * v.dim())
              for k, v in one.items()}
    return {
        "layers": layers,
        "block_tables": torch.zeros((n_slots, max_blocks), dtype=torch.int32,
                                    device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


def _kv_entry(cfg: ModelConfig, k, v) -> Params:
    """A layer's K/V as the cache stores them (quantized for int8)."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = attn_lib.quantize_kv(k)
        vq, vs = attn_lib.quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _pad_seq(t, length: int):
    """Zero-pad the sequence axis (1) of ``t`` to ``length``."""
    return torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, length - t.shape[1]))


def _stack(entries) -> Params:
    """Per-layer ``{name: (B, S, ...)}`` → ``{name: (L, B, S, ...)}``."""
    return {name: torch.stack([e[name] for e in entries])
            for name in entries[0]}


def _last_real_slice(h, prompt_len):
    """Hidden state at the last real prompt position ``(B, 1, d)`` and the
    cache cursor after it (``prompt_len``, or the full length).

    ``prompt_len`` is a Python int, ``None``, or a 0-d int32 tensor on
    ``h``'s device: then the row is picked on the device (the reference's
    ``lax.dynamic_slice_in_dim`` on a traced length) and the cursor is that
    tensor, so a CUDA graph of the prefill serves every length of its
    bucket."""
    if prompt_len is None:
        return h[:, -1:], h.shape[1]
    if isinstance(prompt_len, torch.Tensor):
        return h.index_select(1, (prompt_len - 1).reshape(1)), prompt_len
    return h[:, prompt_len - 1:prompt_len], int(prompt_len)


def prefill(params: Params, batch: dict, cfg: ModelConfig, *, max_len: int,
            prompt_len: Union[int, torch.Tensor, None] = None,
            mlp: MLP = _mlp):
    """Prefill a (possibly right-padded) prompt; returns
    ``(logits (B, 1, V) at position prompt_len - 1, cache)``.

    ``cache["layers"]`` holds each layer's post-RoPE K/V padded with zeros
    to ``max_len`` (``(L, B, max_len, Hk, D)``, int8 plus f32 scales for a
    quantized cache); ``cache["pos"]`` is the cursor ``prompt_len`` (a
    Python int, or the 0-d int32 tensor given as ``prompt_len``: see
    :func:`_last_real_slice`). Positions past ``prompt_len`` are
    causal-masked garbage.
    """
    h, positions, _ = embed_inputs(params, batch, cfg)
    entries = []
    for i in range(cfg.n_layers):
        lyr = layer(params["layers"], i)
        q, k, v = _layer_qkv(cfg, lyr, h, positions)
        h = mlp(cfg, lyr, _attn_out(cfg, lyr, h, _attention(cfg, q, k, v)))
        entries.append(tree_map(lambda t: _pad_seq(t, max_len),
                                _kv_entry(cfg, k, v)))
    h = rms_norm(params["final_norm"], h)
    h_last, pos = _last_real_slice(h, prompt_len)
    logits = unembed(params["embed"], h_last, compute_dtype=cfg.cdtype)
    return logits, {"layers": _stack(entries), "pos": pos}


def prefill_suffix(params: Params, batch: dict, cfg: ModelConfig, *,
                   prefix: Params, prompt_len: int, mlp: MLP = _mlp):
    """Prefill only the suffix of a prompt whose leading blocks hit the
    prefix cache; returns ``(last-position logits, suffix cache)``.

    ``prefix`` holds the cached prefix K/V, ``{"k", "v"}: (L, 1, P, Hk, D)``
    in the compute type; ``batch["tokens"]`` is the suffix right-padded to
    a block-aligned bucket and ``prompt_len`` the *total* true length, so
    the suffix sits at positions ``P .. prompt_len - 1``. The suffix
    queries attend over ``concat(prefix, suffix)`` with the one-shot
    :func:`~repro_torch.layers.attention.full_attention`: plain PyTorch,
    as the reference runs jnp outside any kernel here — not a fallback.
    """
    P = prefix["k"].shape[2]
    h, _, _ = embed_inputs(params, batch, cfg)
    S = h.shape[1]
    dev = h.device
    positions_q = P + torch.arange(S, device=dev)
    positions_kv = torch.arange(P + S, device=dev)
    entries = []
    for i in range(cfg.n_layers):
        lyr = layer(params["layers"], i)
        q, k, v = _layer_qkv(cfg, lyr, h, positions_q)
        k_full = torch.cat([prefix["k"][i].to(cfg.cdtype), k], dim=1)
        v_full = torch.cat([prefix["v"][i].to(cfg.cdtype), v], dim=1)
        o = attn_lib.full_attention(q, attn_lib.rank_kv(k_full),
                                    attn_lib.rank_kv(v_full), causal=True,
                                    positions_q=positions_q,
                                    positions_kv=positions_kv)
        h = mlp(cfg, lyr, _attn_out(cfg, lyr, h, o))
        entries.append(_kv_entry(cfg, k, v))
    h = rms_norm(params["final_norm"], h)
    h_last, _ = _last_real_slice(h, prompt_len - P)
    logits = unembed(params["embed"], h_last, compute_dtype=cfg.cdtype)
    return logits, {"layers": _stack(entries), "pos": int(prompt_len)}


def decode_step(params: Params, cache: Params, tokens, cfg: ModelConfig, *,
                mlp: MLP = _mlp):
    """One token step for every row of the dense-slot cache
    (``init_cache`` layout, ``pos`` 0-d or ``(B,)``); ``tokens (B, 1)``.
    Writes each row's K/V at its cursor, attends over ``pos + 1``
    positions, advances the cursors by one -- in place -- and returns
    ``(logits (B, 1, V), cache)``."""
    pos = cache["pos"]
    h = embed(params["embed"], tokens, compute_dtype=cfg.cdtype)
    for i in range(cfg.n_layers):
        lyr = layer(params["layers"], i)
        hn = rms_norm(lyr["attn_norm"], h)
        a, _ = attn_lib.attention_decode(
            lyr["attn"], hn, layer(cache["layers"], i), pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            compute_dtype=cfg.cdtype, strategy=cfg.moa_for("attention"),
            backend=cfg.attn_backend)
        h = mlp(cfg, lyr, h + a)
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    pos.add_(1)
    return logits, cache


def paged_decode_step(params: Params, cache: Params, tokens,
                      cfg: ModelConfig, *, live_blocks: Optional[int] = None,
                      mlp: MLP = _mlp):
    """One token step for every slot against the paged cache
    (``init_paged_cache`` layout); ``tokens (B, 1)``. Writes each slot's
    new K/V into its page, attends over its pages (``cfg.attn_backend``:
    the paged-attention kernel or the gathered plain path), advances every
    cursor by one — in place — and returns ``(logits (B, 1, V), cache)``.
    ``live_blocks`` bounds the KV walk to the batch's high-water block."""
    pos, tables = cache["pos"], cache["block_tables"]
    # every layer writes at the same page and offset: find them once
    targets = attn_lib.paged_write_targets(
        tables, pos, cache["layers"]["k"].shape[2])
    h = embed(params["embed"], tokens, compute_dtype=cfg.cdtype)
    for i in range(cfg.n_layers):
        lyr = layer(params["layers"], i)
        hn = rms_norm(lyr["attn_norm"], h)
        a, _ = attn_lib.attention_decode_paged(
            lyr["attn"], hn, layer(cache["layers"], i), tables, pos,
            targets, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            compute_dtype=cfg.cdtype, strategy=cfg.moa_for("attention"),
            backend=cfg.attn_backend, live_blocks=live_blocks)
        h = mlp(cfg, lyr, h + a)
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    pos.add_(1)
    return logits, cache


# ---------------------------------------------------------------------------
# Speculative verify
# ---------------------------------------------------------------------------


def verify_impl(params: Params, cache: Params, tokens, cfg: ModelConfig, *,
                paged: bool, mlp: MLP = _mlp,
                live_blocks: Optional[int] = None):
    """The verify of the dense and MoE families (which differ only in
    ``mlp``); ``paged`` picks the KV layout (``live_blocks`` bounds the
    paged walk, as in :func:`paged_decode_step`). The write targets are
    found once for every layer. See :func:`verify_step`."""
    pos = cache["pos"]
    B, T = tokens.shape
    kv = cache["layers"]
    if paged:
        tables = cache["block_tables"]
        targets = attn_lib.paged_verify_targets(tables, pos, T,
                                                kv["k"].shape[2])
    else:
        targets = attn_lib.verify_write_targets(pos, B, T, kv["k"].shape[2])
    h = embed(params["embed"], tokens, compute_dtype=cfg.cdtype)
    for i in range(cfg.n_layers):
        lyr = layer(params["layers"], i)
        hn = rms_norm(lyr["attn_norm"], h)
        common = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                      compute_dtype=cfg.cdtype,
                      strategy=cfg.moa_for("attention"))
        if paged:
            a, _ = attn_lib.attention_verify_paged(
                lyr["attn"], hn, layer(kv, i), tables, pos, targets,
                backend=cfg.attn_backend, live_blocks=live_blocks, **common)
        else:
            a, _ = attn_lib.attention_verify(lyr["attn"], hn, layer(kv, i),
                                             pos, targets,
                                             backend=cfg.attn_backend,
                                             **common)
        h = mlp(cfg, lyr, h + a)
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    return logits, cache, None


def verify_step(params: Params, cache: Params, tokens, cfg: ModelConfig, *,
                mlp: MLP = _mlp):
    """Score ``tokens (B, T)`` a slot in one call against the dense-slot
    cache (speculative verify): column 0 is each slot's pending token,
    columns ``1..T-1`` its draft. All T K/V rows are written in place,
    tentatively, and logits come back at every position: ``[:, i]`` is the
    ``i``-th of T sequential :func:`decode_step` calls, up to the rounding
    of a ``T``-row product. ``pos`` stays at the pre-verify cursor;
    :func:`commit_verified` advances it, which is the whole rollback
    (rejected rows are masked garbage until overwritten). Returns
    ``(logits (B, T, V), cache, None)``."""
    return verify_impl(params, cache, tokens, cfg, paged=False, mlp=mlp)


def paged_verify_step(params: Params, cache: Params, tokens,
                      cfg: ModelConfig, *, live_blocks: Optional[int] = None,
                      mlp: MLP = _mlp):
    """Paged twin of :func:`verify_step`: the tentative rows scatter
    through the block tables; ``live_blocks`` must cover the deepest
    cursor plus the window."""
    return verify_impl(params, cache, tokens, cfg, paged=True, mlp=mlp,
                       live_blocks=live_blocks)


def commit_verified(cache: Params, keep, aux, cfg: ModelConfig) -> Params:
    """Advance each slot's cursor past its accepted tokens, in place:
    ``keep (B,)`` is accepted drafts + 1 for an active slot, 0 for an idle
    one. ``aux`` is unused: the cache is position-addressed, so the cursor
    is the rollback. A lockstep batch's 0-d cursor becomes a ``(B,)`` one,
    as the reference's broadcast makes it."""
    del aux, cfg
    pos = cache["pos"]
    if pos.dim() == 0:
        cache["pos"] = pos + keep.to(pos.dtype)
    else:
        pos.add_(keep.to(pos.dtype))
    return cache
