"""MoE transformer LM (moonshot 64 experts top-6) — the port of
``repro/models/moe_transformer.py``.

The dense skeleton with the MLP replaced by the expert layer
(:func:`repro_torch.layers.moe.moe_forward`): prefill, suffix prefill,
both decode steps and both verify steps are :mod:`repro_torch.models.transformer`'s with
:func:`moe_mlp` in the MLP's place, over the same caches. ``forward`` also
returns the router's load-balance loss, averaged over the layers.

The expert weights are drawn one layer at a time into the stacked
``cfg.pdtype`` tensors: a whole-stack draw runs in f32 first, which for
moonshot's ``w_gate`` ``(48, 64, 2048, 1408)`` would be two 35 GB
temporaries. The rest is drawn as the dense family's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import Params, rms_norm
from repro_torch.layers.embedding import unembed
from repro_torch.layers.moe import init_moe, moe_forward
from repro_torch.models import transformer as dense
from repro_torch.parallel.collectives import fsdp_layer

__all__ = ["SERVE_AUDIT",
           "init_params", "moe_mlp", "forward", "init_cache",
           "init_paged_cache", "prefill", "prefill_suffix", "decode_step",
           "paged_decode_step", "verify_step", "paged_verify_step",
           "commit_verified"]

#: the serve-path surface the static audits enumerate (the reference's
#: ``SERVE_AUDIT``; ``repro_torch.analysis.targets``)
SERVE_AUDIT = {
    "phases": ("prefill", "decode", "verify", "commit"),
    "paged": True,
    "kv_key": "layers",
    "suffix_prefill": True,
}

init_cache = dense.init_cache
init_paged_cache = dense.init_paged_cache
commit_verified = dense.commit_verified


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters with the reference's tree, shapes and
    initializers (:func:`repro_torch.models.transformer.init_params`), the
    router and experts (:func:`repro_torch.layers.moe.init_moe`) in the
    MLP's place, each layer's drawn into its row of the stacked ``(L,
    ...)`` tensors."""
    L = cfg.n_layers

    def experts():
        out = None
        for i in range(L):
            one = init_moe(generator, d_model=cfg.d_model, d_ff=cfg.d_ff,
                           n_experts=cfg.n_experts, dtype=cfg.pdtype,
                           device=device)
            if out is None:
                out = {k: torch.empty((L,) + tuple(v.shape), dtype=v.dtype,
                                      device=device) for k, v in one.items()}
            for k, v in one.items():
                out[k][i] = v
        return {"moe": out}

    return dense.init_params(cfg, generator, device, mlp=experts)


def _moe(cfg: ModelConfig, lyr: Params, h):
    """``(moe(rms(h)), aux)``."""
    hn = rms_norm(lyr["mlp_norm"], h)
    return moe_forward(lyr["moe"], hn, n_experts=cfg.n_experts,
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       compute_dtype=cfg.cdtype, strategy=cfg.moa_for("moe"))


def moe_mlp(cfg: ModelConfig, lyr: Params, h):
    """``h + moe(rms(h))``: the MLP of :mod:`~repro_torch.models.
    transformer`'s serving functions."""
    return h + _moe(cfg, lyr, h)[0]


def _block(cfg: ModelConfig, lyr: Params, h, positions):
    """One layer: attention, then the experts → ``(h, aux)`` (under FSDP
    on the layer's gathered weights)."""
    lyr = fsdp_layer(lyr)
    q, k, v = dense._layer_qkv(cfg, lyr, h, positions)
    h = dense._attn_out(cfg, lyr, h, dense._train_attention(cfg, q, k, v))
    m, aux = _moe(cfg, lyr, h)
    return h + m, aux


def forward(params: Params, batch: dict, cfg: ModelConfig):
    """Full causal forward → ``(logits (B, S, V) in f32, aux_loss_mean)``;
    differentiable, each layer under ``cfg.remat`` (as the dense
    family's)."""
    h, positions, _ = dense.embed_inputs(params, batch, cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for lyr in dense.layers(params["layers"], cfg.n_layers):
        h, aux = dense.remat(cfg, _block, cfg, lyr, h, positions)
        aux_sum = aux_sum + aux
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h, compute_dtype=cfg.cdtype)
    return logits, aux_sum / cfg.n_layers


def prefill(params: Params, batch: dict, cfg: ModelConfig, *, max_len: int,
            prompt_len: Union[int, torch.Tensor, None] = None):
    """Prefill; as :func:`repro_torch.models.transformer.prefill`. Right
    padding is exact only in the dropless regime (pad tokens compete for
    expert capacity): ``Model.supports_padded_prefill`` gates it."""
    return dense.prefill(params, batch, cfg, max_len=max_len,
                         prompt_len=prompt_len, mlp=moe_mlp)


def prefill_suffix(params: Params, batch: dict, cfg: ModelConfig, *,
                   prefix: Params, prompt_len: int):
    """Suffix-only prefill behind a cached prefix; exact only in the
    dropless regime (``Model.prefill_suffix`` gates it)."""
    return dense.prefill_suffix(params, batch, cfg, prefix=prefix,
                                prompt_len=prompt_len, mlp=moe_mlp)


def decode_step(params: Params, cache: Params, tokens, cfg: ModelConfig):
    """Dense-slot decode step, in place; as :func:`repro_torch.models.
    transformer.decode_step`."""
    return dense.decode_step(params, cache, tokens, cfg, mlp=moe_mlp)


def paged_decode_step(params: Params, cache: Params, tokens,
                      cfg: ModelConfig, *, live_blocks: Optional[int] = None):
    """Paged decode step, in place; the MoE layers are untouched, only the
    attention's KV goes through the block tables."""
    return dense.paged_decode_step(params, cache, tokens, cfg,
                                   live_blocks=live_blocks, mlp=moe_mlp)


def verify_step(params: Params, cache: Params, tokens, cfg: ModelConfig):
    """Dense-slot verify of ``tokens (B, T)``; as :func:`repro_torch.models.
    transformer.verify_step`. Routing a ``(B, T)`` window through the
    experts in one call equals T decode steps only in the dropless regime
    (``Model.supports_spec_decode`` gates it)."""
    return dense.verify_step(params, cache, tokens, cfg, mlp=moe_mlp)


def paged_verify_step(params: Params, cache: Params, tokens,
                      cfg: ModelConfig, *, live_blocks: Optional[int] = None):
    """Paged verify; as :func:`repro_torch.models.transformer.
    paged_verify_step`, gated like :func:`verify_step`."""
    return dense.paged_verify_step(params, cache, tokens, cfg,
                                   live_blocks=live_blocks, mlp=moe_mlp)
