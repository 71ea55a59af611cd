"""Mamba-2 LM (attention-free SSD stack), mamba2-370m and its smoke — the
port of ``repro/models/mamba2.py``.

Per layer: ``h += mamba2(rms(h))``; no positional encoding. Decode keeps
each layer's recurrent state (``h`` in f32 and the conv history in bf16),
constant in sequence length. Layer parameters are stacked on a leading
``L`` axis as the reference stacks them; the port loops over it.

The decode step updates the state **in place** and returns the cache, as
the dense family's does; the speculative verify is ``T`` decode steps
with per-step state snapshots (:mod:`repro_torch.models.verify_common`).
No TPU kernel runs on this family's path: its projections are plain
products (the reference's ``@``) and its unembedding a library product.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import Params, rms_norm
from repro_torch.layers.embedding import embed, init_embedding, unembed
from repro_torch.layers.ssd import (conv_tail, init_mamba2_block,
                                    init_ssm_state, mamba2_decode,
                                    mamba2_forward)
from repro_torch.models import verify_common
from repro_torch.models.transformer import layer, layers, remat
from repro_torch.parallel.collectives import fsdp_layer

__all__ = ["SERVE_AUDIT",
           "init_params", "init_layers", "layer_forward", "block",
           "layer_decode", "forward", "init_cache", "prefill", "prefill_chunk",
           "decode_step", "verify_step", "commit_verified"]

#: the serve-path surface the static audits enumerate (the reference's
#: ``SERVE_AUDIT``; ``repro_torch.analysis.targets``)
SERVE_AUDIT = {
    "phases": ("prefill", "decode", "verify", "commit"),
    "paged": False,
    "kv_key": None,
    "suffix_prefill": False,
    "prefill_chunk": True,
}


def init_layers(cfg: ModelConfig, generator: torch.Generator, device
                ) -> Params:
    """The ``cfg.n_layers`` Mamba-2 layers (``{"norm", "mixer"}``), each
    drawn into its row of the stacked ``(L, ...)`` tensors."""
    out = None
    for i in range(cfg.n_layers):
        one = {"norm": {"scale": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                                            device=device)},
               "mixer": init_mamba2_block(
                   generator, d_model=cfg.d_model, d_state=cfg.d_state,
                   headdim=cfg.headdim, n_groups=cfg.n_groups,
                   d_conv=cfg.d_conv, expand=cfg.expand, dtype=cfg.pdtype,
                   device=device)}
        if out is None:
            out = _alloc_like(one, cfg.n_layers)
        _set_row(out, one, i)
    return out


def _alloc_like(tree, n: int):
    if isinstance(tree, dict):
        return {k: _alloc_like(v, n) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                       device=tree.device)


def _set_row(out, one, i: int) -> None:
    for k, v in one.items():
        if isinstance(v, dict):
            _set_row(out[k], v, i)
        else:
            out[k][i] = v


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters with the reference's tree, shapes and
    initializers, drawn from ``generator`` on ``device``."""
    emb = init_embedding(generator, cfg.vocab, cfg.d_model,
                         tie=cfg.tie_embeddings, dtype=cfg.pdtype,
                         device=device)
    return {"embed": emb, "layers": init_layers(cfg, generator, device),
            "final_norm": {"scale": torch.ones((cfg.d_model,),
                                               dtype=cfg.pdtype,
                                               device=device)}}


def _ssm_kw(cfg: ModelConfig) -> dict:
    return dict(d_state=cfg.d_state, headdim=cfg.headdim,
                n_groups=cfg.n_groups, expand=cfg.expand,
                compute_dtype=cfg.cdtype)


def layer_forward(cfg: ModelConfig, lyr: Params, h, initial_state=None):
    """One layer over a segment: ``(h + mamba2(rms(h)), h_last, conv
    inputs of the segment's last d_conv - 1 positions)``."""
    hn = rms_norm(lyr["norm"], h)
    y, h_last = mamba2_forward(lyr["mixer"], hn, ssd_chunk=cfg.ssd_chunk,
                               initial_state=initial_state, **_ssm_kw(cfg))
    tail = conv_tail(lyr["mixer"], hn, d_inner=cfg.d_inner,
                     n_groups=cfg.n_groups, d_state=cfg.d_state,
                     compute_dtype=cfg.cdtype)
    return h + y, h_last, tail


def block(cfg: ModelConfig, lyr: Params, h):
    """One layer of the training forward: ``h + mamba2(rms(h))`` (under
    FSDP on the layer's gathered weights)."""
    lyr = fsdp_layer(lyr)
    y, _ = mamba2_forward(lyr["mixer"], rms_norm(lyr["norm"], h),
                          ssd_chunk=cfg.ssd_chunk, **_ssm_kw(cfg))
    return h + y


def layer_decode(cfg: ModelConfig, lyr: Params, h, state: Params):
    """One layer's decode step, its state updated in place."""
    return h + mamba2_decode(lyr["mixer"], rms_norm(lyr["norm"], h), state,
                             **_ssm_kw(cfg))


def forward(params: Params, batch: dict, cfg: ModelConfig):
    """Full forward → logits ``(B, S, V)`` in f32; differentiable (the
    training forward: each layer under ``cfg.remat``, as the reference's
    scan is)."""
    h = embed(params["embed"], batch["tokens"], compute_dtype=cfg.cdtype)
    for lyr in layers(params["layers"], cfg.n_layers):
        h = remat(cfg, block, cfg, lyr, h)
    h = rms_norm(params["final_norm"], h)
    return unembed(params["embed"], h, compute_dtype=cfg.cdtype)


def stack_states(states) -> Params:
    """Per-layer ``{"h", "conv"}`` → stacked ``(L, B, ...)`` leaves."""
    return {name: torch.stack([s[name] for s in states])
            for name in ("h", "conv")}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Params:
    """Zeroed recurrent state of every layer, stacked ``(L, batch, ...)``,
    and a 0-d int32 cursor; ``max_len`` is unused (constant-size state)."""
    del max_len
    one = init_ssm_state(batch, d_model=cfg.d_model, d_state=cfg.d_state,
                         headdim=cfg.headdim, n_groups=cfg.n_groups,
                         d_conv=cfg.d_conv, expand=cfg.expand, device=device)
    return {"layers": {k: v.unsqueeze(0).repeat((cfg.n_layers,)
                                                 + (1,) * v.dim())
                       for k, v in one.items()},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _logits(params: Params, h, cfg: ModelConfig):
    h = rms_norm(params["final_norm"], h[:, -1:])
    return unembed(params["embed"], h, compute_dtype=cfg.cdtype)


def prefill(params: Params, batch: dict, cfg: ModelConfig, *, max_len: int):
    """Chunked-scan prefill of an exact-length prompt → ``(last-position
    logits, cache)``: each layer's final ``h`` and its last ``d_conv - 1``
    conv inputs (compute dtype), and the cursor ``S``."""
    del max_len
    h = embed(params["embed"], batch["tokens"], compute_dtype=cfg.cdtype)
    states = []
    for i in range(cfg.n_layers):
        h, h_last, tail = layer_forward(cfg, layer(params["layers"], i), h)
        states.append({"h": h_last, "conv": tail.to(cfg.cdtype)})
    return _logits(params, h, cfg), {"layers": stack_states(states),
                                     "pos": h.shape[1]}


def continue_layer(cfg: ModelConfig, lyr: Params, h, st: Params):
    """One layer of a prefill chunk from its carried ``{"h", "conv"}``:
    ``(h, new state)``, the conv history the last ``d_conv - 1`` inputs
    overall (the chunk's tail spliced behind the carried one)."""
    h, h_last, tail = layer_forward(cfg, lyr, h, initial_state=st)
    k1 = cfg.d_conv - 1
    conv = torch.cat([st["conv"], tail.to(st["conv"].dtype)], dim=1)[:, -k1:]
    return h, {"h": h_last, "conv": conv}


def prefill_chunk(params: Params, batch: dict, cfg: ModelConfig, *,
                  state: Params):
    """Continue a chunked prefill from ``state``, what :func:`prefill` or
    an earlier chunk returned (a zeroed :func:`init_cache` for chunk 0):
    ``(logits, {"layers", "pos"})``, the final chunk's state being the
    prefill cache. Chunks aligned to ``cfg.ssd_chunk`` continue the scan as
    one long scan would."""
    h = embed(params["embed"], batch["tokens"], compute_dtype=cfg.cdtype)
    S = h.shape[1]
    states = []
    for i in range(cfg.n_layers):
        h, st = continue_layer(cfg, layer(params["layers"], i), h,
                               layer(state["layers"], i))
        states.append(st)
    return _logits(params, h, cfg), {"layers": stack_states(states),
                                     "pos": state["pos"] + S}


def decode_step(params: Params, cache: Params, tokens, cfg: ModelConfig):
    """One token a row (``tokens (B, 1)``): every layer's state and the
    cursors updated in place; returns ``(logits (B, 1, V), cache)``."""
    h = embed(params["embed"], tokens, compute_dtype=cfg.cdtype)
    for i in range(cfg.n_layers):
        h = layer_decode(cfg, layer(params["layers"], i), h,
                         layer(cache["layers"], i))
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    cache["pos"].add_(1)
    return logits, cache


def verify_step(params: Params, cache: Params, tokens, cfg: ModelConfig):
    """Score ``tokens (B, T)`` as T decode steps with per-step state
    snapshots: ``(logits (B, T, V), cache, snapshots)``, ``pos`` at its
    pre-verify value (:func:`repro_torch.models.verify_common.
    scan_verify`)."""
    return verify_common.scan_verify(
        lambda c, t: decode_step(params, c, t, cfg)[0], cache, tokens,
        "layers")


def commit_verified(cache: Params, keep, aux, cfg: ModelConfig) -> Params:
    """Restore each slot's state at its accepted length and advance the
    cursors by ``keep``, in place."""
    del cfg
    return verify_common.scan_commit(cache, keep, aux, "layers")
