"""Analytic FLOPs of one forward pass and the serve engine's request
pricing — the port of the parts of ``repro/launch/costing.py`` the engine
needs (``forward_flops`` and its per-layer terms, ``request_decode_cost``,
``kv_bytes_per_token``), and the speculative-decoding and chunked-prefill
estimators (``spec_request_decode_cost``, ``expected_accepted_len``,
``spec_decode_cost``, ``spec_break_even_accept``,
``prefill_chunk_guidance``).

Conventions, as the reference's: 1 MAC = 2 FLOPs, global FLOPs per pass.
Each contraction site scales its FLOPs by its MOA strategy's
``cost(n)["flops"]`` over the exact ``2n - 1`` (:func:`_moa_flops_multiplier`):
tree and serial price at 1.0x, the LOA's ~6 ops an add inflate the total.
The result is arithmetic on the config, device-free, and equals the
reference's for the same config. What this leaves for later (the dry-run
cell model) is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig

__all__ = ["forward_flops", "request_decode_cost", "kv_bytes_per_token",
           "spec_request_decode_cost", "expected_accepted_len",
           "spec_decode_cost", "spec_break_even_accept",
           "prefill_chunk_guidance"]


def _attn_layer_flops(cfg: ModelConfig, T: float,
                      S_attn: float) -> Dict[str, float]:
    """One attention layer over ``T`` tokens attending to ``S_attn``
    positions (the full ``T x S_attn`` rectangle: causal blocks are masked,
    not skipped, in the reference's flash path)."""
    d, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn_qkv": 2 * T * d * (H * Dh + 2 * Kv * Dh),
        "attn_scores_pv": 4 * T * S_attn * H * Dh,
        "attn_out": 2 * T * d * H * Dh,
    }


def _mlp_layer_flops(cfg: ModelConfig, T: float) -> float:
    if cfg.family == "encoder":
        return 4 * T * cfg.d_model * cfg.d_ff       # in + out
    return 6 * T * cfg.d_model * cfg.d_ff           # swiglu: gate, up, down


def _moe_layer_flops(cfg: ModelConfig, T: float) -> Dict[str, float]:
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    slots = T * k * cf                               # E·C buffer rows
    return {
        "moe_router": 2 * T * cfg.d_model * E,
        "moe_experts": 6 * slots * cfg.d_model * cfg.d_ff,
    }


def _ssd_layer_flops(cfg: ModelConfig, T: float,
                     decode: bool) -> Dict[str, float]:
    d, di = cfg.d_model, cfg.d_inner
    H, P, N = cfg.n_ssm_heads, cfg.headdim, cfg.d_state
    d_in_proj = 2 * di + 2 * cfg.n_groups * cfg.d_state + H
    conv_dim = di + 2 * cfg.n_groups * cfg.d_state
    out = {
        "ssm_proj": 2 * T * d * d_in_proj + 2 * T * di * d,
        "ssm_conv": 2 * T * cfg.d_conv * conv_dim,
    }
    if decode:
        # outer product dB·x + readout h·C (2THPN each) + the dt broadcast
        out["ssm_core"] = 4 * T * H * P * N + 2 * T * H * N
    else:
        # chunked SSD: CBᵀ over n, the decay mask, ·X over s; the states
        # and y_off pay a 2THPN contraction and a K=1 decay dot each
        L = cfg.ssd_chunk
        out["ssm_core"] = (2 * T * L * H * (N + P + 1)
                           + 4 * T * H * P * (N + 1))
    return out


def _moa_flops_multiplier(cfg: ModelConfig, site: str,
                          n_operands: int) -> float:
    """Strategy-scheduled FLOPs over the exact ``2n - 1`` of one
    ``n``-operand dot-product output (``cfg.moa_for(site).cost``)."""
    if n_operands < 2:
        return 1.0
    cost = cfg.moa_for(site).cost(n_operands, cfg.compute_dtype)
    exact = 2.0 * n_operands - 1.0
    return float(cost["flops"]) / exact


def forward_flops(cfg: ModelConfig, *, tokens: float, s_attn: float,
                  decode: bool = False) -> Dict[str, float]:
    """Global FLOPs of one forward pass over ``tokens`` tokens, by
    component, with each site's MOA multiplier applied."""
    comp: Dict[str, float] = {}
    L = cfg.n_layers

    def add(d: Dict[str, float], mult: float = 1.0):
        for k, v in d.items():
            comp[k] = comp.get(k, 0.0) + v * mult

    if cfg.family in ("dense", "encoder", "vlm"):
        add(_attn_layer_flops(cfg, tokens, s_attn), L)
        comp["mlp"] = L * _mlp_layer_flops(cfg, tokens)
    elif cfg.family == "moe":
        add(_attn_layer_flops(cfg, tokens, s_attn), L)
        add(_moe_layer_flops(cfg, tokens), L)
    elif cfg.family == "ssm":
        add(_ssd_layer_flops(cfg, tokens, decode), L)
    elif cfg.family == "hybrid":
        add(_ssd_layer_flops(cfg, tokens, decode), L)
        n_apps = cfg.n_layers // cfg.attn_every
        add(_attn_layer_flops(cfg, tokens, s_attn), n_apps)
        comp["mlp"] = n_apps * _mlp_layer_flops(cfg, tokens)
    # logits (VLM: the text positions only, approximated by their share)
    logits_tokens = tokens
    if cfg.family == "vlm":
        logits_tokens = tokens * max(
            1 - cfg.n_patches / max(s_attn, 1), 0.05)
    comp["logits"] = 2 * logits_tokens * cfg.d_model * cfg.vocab

    m_attn = _moa_flops_multiplier(cfg, "attention", cfg.d_model)
    for key in ("attn_qkv", "attn_out"):
        if key in comp:
            comp[key] *= m_attn
    m_mlp = _moa_flops_multiplier(cfg, "mlp", max(cfg.d_ff, cfg.d_model))
    if "mlp" in comp:
        comp["mlp"] *= m_mlp
    if "moe_experts" in comp:
        # the router (d_model operands) and the experts (d_ff) share the
        # "moe" site's strategy
        comp["moe_experts"] *= _moa_flops_multiplier(cfg, "moe", cfg.d_ff)
        comp["moe_router"] *= _moa_flops_multiplier(cfg, "moe", cfg.d_model)
    return comp


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes one token occupies across every KV-bearing stack
    (layers, or the hybrid's attention applications; 0 for a pure SSM and
    the cacheless encoder), int8 scales included: the cache layout's
    arithmetic (``Model.cache_spec`` for the ported families)."""
    if cfg.family in ("ssm", "encoder"):
        return 0.0
    stacks = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.n_layers)
    # the hybrid's shared-attention cache stays in the compute type
    if cfg.kv_cache_dtype == "int8" and cfg.family != "hybrid":
        per = 2 * cfg.n_kv_heads * (cfg.head_dim + 4)     # + f32 scales
    else:
        per = 2 * cfg.n_kv_heads * cfg.head_dim * cfg.cdtype.itemsize
    return float(stacks * per)


def request_decode_cost(cfg: ModelConfig, *, prompt_tokens: int,
                        new_tokens: int) -> float:
    """Strategy-priced FLOPs of one served request's decode steps: the
    first token comes from the prefill logits, so :func:`forward_flops`
    is summed over the other ``new_tokens - 1`` one-token steps, each
    attending over ``prompt_tokens + t + 1`` positions."""
    total = 0.0
    for t in range(max(new_tokens - 1, 0)):
        s_attn = float(prompt_tokens + t + 1)
        total += sum(forward_flops(cfg, tokens=1.0, s_attn=s_attn,
                                   decode=True).values())
    return total


def spec_request_decode_cost(cfg: ModelConfig, *, k: int,
                             tick_contexts) -> float:
    """Strategy-priced FLOPs one speculatively served request spent on
    target-side verify passes: at each verify tick it was active
    (``tick_contexts``: its committed context then) ``k + 1`` tokens
    attending on average the mid-window context. Rejected drafts are
    compute spent, so a low accept rate costs more FLOPs per emitted
    token; draft-model work is not attributed per request."""
    total = 0.0
    for ctx in tick_contexts:
        s_attn = float(ctx) + (k + 2) / 2.0
        total += sum(forward_flops(cfg, tokens=float(k + 1), s_attn=s_attn,
                                   decode=True).values())
    return total


def _decode_step_flops(cfg: ModelConfig, *, tokens: float,
                       s_attn: float) -> float:
    return sum(forward_flops(cfg, tokens=tokens, s_attn=s_attn,
                             decode=True).values())


def prefill_chunk_guidance(cfg: ModelConfig, *, n_slots: int,
                           max_len: int, mean_context: float,
                           stall_budget_ticks: float = 4.0,
                           block_size: int = 0) -> dict:
    """Size ``ServeEngine(prefill_chunk_tokens=...)`` from the cost model:
    the largest chunk (a multiple of the family's alignment and, paged, of
    ``block_size``) whose prefill FLOPs stay within ``stall_budget_ticks``
    batched decode ticks at ``mean_context``; at least one alignment unit.
    Returns ``prefill_chunk_tokens``, ``alignment``, ``decode_tick_flops``,
    ``chunk_prefill_flops`` and ``stall_ticks``."""
    if n_slots < 1 or max_len < 1:
        raise ValueError("n_slots and max_len must be >= 1")
    if stall_budget_ticks <= 0:
        raise ValueError("stall_budget_ticks must be > 0")
    align = cfg.ssd_chunk if cfg.family in ("ssm", "hybrid") else 1
    if block_size:
        align = align * block_size // math.gcd(align, block_size)
    tick_flops = _decode_step_flops(cfg, tokens=float(n_slots),
                                    s_attn=mean_context)

    def chunk_flops(c: float) -> float:
        # a mid-prompt chunk attends on average ~max_len/2 prior positions
        return sum(forward_flops(cfg, tokens=c, s_attn=max_len / 2.0,
                                 decode=False).values())

    best = align
    c = align
    while c + align <= max_len \
            and chunk_flops(float(c + align)) \
            <= stall_budget_ticks * tick_flops:
        c += align
        best = c
    return {
        "prefill_chunk_tokens": best,
        "alignment": align,
        "decode_tick_flops": tick_flops,
        "chunk_prefill_flops": chunk_flops(float(best)),
        "stall_ticks": chunk_flops(float(best)) / max(tick_flops, 1e-9),
    }


def expected_accepted_len(k: int, accept_prob: float) -> float:
    """Expected accepted drafts a verify with i.i.d. per-position accept
    probability ``a``: ``sum_{i=1..k} a**i``."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    a = min(max(accept_prob, 0.0), 1.0)
    return float(sum(a ** i for i in range(1, k + 1)))


def spec_decode_cost(cfg: ModelConfig, *, k: int, accept_prob: float,
                     s_attn: float,
                     draft_cfg: Optional[ModelConfig] = None
                     ) -> Dict[str, float]:
    """Acceptance-aware speculative-decoding estimate at context
    ``s_attn``: a tick scores ``k + 1`` tokens in one target pass plus
    ``k`` draft steps (none for a lookup drafter, ``draft_cfg=None``) and
    emits ``expected_accepted_len + 1`` tokens. ``step_speedup`` counts
    emitted tokens per serial target pass (a verify priced as one decode
    step, a draft step at its FLOPs share of one); ``flops_overhead`` the
    strategy-priced FLOPs per emitted token over plain decode (always at
    least 1)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    emitted = expected_accepted_len(k, accept_prob) + 1.0
    target_step = _decode_step_flops(cfg, tokens=1.0, s_attn=s_attn)
    verify = _decode_step_flops(cfg, tokens=float(k + 1), s_attn=s_attn)
    if draft_cfg is None:
        draft_step, draft_total = 0.0, 0.0
    else:
        draft_step = _decode_step_flops(draft_cfg, tokens=1.0,
                                        s_attn=s_attn)
        draft_total = k * draft_step
    draft_ratio = draft_step / max(target_step, 1e-30)
    tick_latency_steps = 1.0 + k * draft_ratio
    return {
        "k": float(k),
        "accept_prob": float(accept_prob),
        "expected_tokens_per_step": emitted,
        "target_step_flops": target_step,
        "verify_flops": verify,
        "draft_flops": draft_total,
        "flops_per_token_plain": target_step,
        "flops_per_token_spec": (verify + draft_total) / emitted,
        "flops_overhead": (verify + draft_total) / (emitted * target_step),
        "step_speedup": emitted / tick_latency_steps,
    }


def spec_break_even_accept(cfg: ModelConfig, *, k: int, s_attn: float,
                           draft_cfg: Optional[ModelConfig] = None,
                           tol: float = 1e-3) -> float:
    """Smallest per-position accept probability at which speculation wins
    (``step_speedup > 1``), by bisection; 1.0 means it never pays at this
    ``k`` and draft cost."""
    def speedup(a: float) -> float:
        return spec_decode_cost(cfg, k=k, accept_prob=a, s_attn=s_attn,
                                draft_cfg=draft_cfg)["step_speedup"]

    if speedup(1.0) <= 1.0:
        return 1.0
    lo, hi = 0.0, 1.0
    if speedup(lo) > 1.0:
        return 0.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if speedup(mid) > 1.0:
            hi = mid
        else:
            lo = mid
    return hi
