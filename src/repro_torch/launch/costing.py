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
reference's for the same config.

The cell model: :func:`estimate_cell` prices one (arch, shape, mesh) cell
per device — FLOPs, first-order HBM bytes and ring-collective wire bytes
(``2·B·(k−1)/k`` an all-reduce, ``B·(k−1)/k`` an all-gather or
reduce-scatter, for a per-device buffer of ``B`` bytes over a group of
``k``) — and :func:`serve_target_cost` prices one serve-path audit target
(``repro_torch.analysis``), keyed the way its targets are built. Neither
holds a device constant: they count work, not time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeSpec

__all__ = ["forward_flops", "request_decode_cost", "kv_bytes_per_token",
           "spec_request_decode_cost", "expected_accepted_len",
           "spec_decode_cost", "spec_break_even_accept",
           "prefill_chunk_guidance", "MeshMeta", "CellCost",
           "estimate_cell", "kv_resident_bytes", "serve_target_cost",
           "NONCONTRACTION_COMPONENTS", "SERVE_PHASES", "ring_all_reduce",
           "ring_all_gather", "ring_reduce_scatter", "all_to_all"]

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class MeshMeta:
    """A cell's mesh: ``pod × data × model`` devices, and the layout
    levers the cell model prices."""

    pod: int
    data: int
    model: int
    fsdp: bool = True
    compress_grads: bool = False    # int8 gradient all-reduce (+err state)
    attn_cp: bool = False           # context-parallel attention: a2a layout
                                    # swap replaces the attn-out all-reduce
    kv_dim_shard: bool = False      # shard cache head_dim over model when
                                    # kv_heads doesn't divide it

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data

    def kv_shard_ways(self, cfg: ModelConfig) -> int:
        """How many ways the KV cache actually shards (divisibility)."""
        ways = self.dp if cfg.n_kv_heads else self.chips
        if not cfg.n_kv_heads:
            return ways
        if cfg.n_kv_heads % self.model == 0:
            return self.dp * self.model
        if self.kv_dim_shard and cfg.head_dim % self.model == 0:
            return self.dp * self.model
        return self.dp  # kv heads replicated over the model axis


@dataclasses.dataclass
class CellCost:
    flops: float                  # per device
    hbm_bytes: float              # per device
    collective_bytes: float       # per device (wire)
    components: Dict[str, float]  # named breakdown (global FLOPs)
    bytes_components: Dict[str, float]
    collective_components: Dict[str, float]


# ---- ring-collective wire models (bytes per device) ------------------------


def ring_all_reduce(buf_bytes: float, k: int) -> float:
    return 0.0 if k <= 1 else 2.0 * buf_bytes * (k - 1) / k


def ring_all_gather(full_bytes: float, k: int) -> float:
    """Gathering shards into ``full_bytes`` per device."""
    return 0.0 if k <= 1 else full_bytes * (k - 1) / k


ring_reduce_scatter = ring_all_gather


def all_to_all(buf_bytes: float, k: int) -> float:
    return 0.0 if k <= 1 else buf_bytes * (k - 1) / k


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


# ---------------------------------------------------------------------------
# serve-path audit targets
# ---------------------------------------------------------------------------

#: components of :func:`forward_flops` computed without a matrix product
#: (the depthwise conv is a shift-multiply-sum), so the static contraction
#: count cannot see them; :func:`serve_target_cost` leaves them out
NONCONTRACTION_COMPONENTS = ("ssm_conv",)

#: the serve-path phases ``repro_torch.analysis.targets`` builds per
#: family; the keying below tracks ``build_family_targets`` exactly
SERVE_PHASES = (
    "prefill", "decode", "verify", "prefill_chunk",
    "paged_decode", "paged_decode_hw", "paged_decode_fused",
    "paged_verify", "paged_verify_fused", "paged_suffix_prefill",
)


def _ssd_conv_hist_flops(cfg: ModelConfig, batch: float) -> float:
    """A layer's FLOPs of the conv-history recompute in a serve prefill:
    the last ``d_conv - 1`` input positions of each sequence are projected
    again to seed the decode cache's rolling conv window — work the plain
    training forward does not do."""
    d_in_proj = (2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
                 + cfg.n_ssm_heads)
    return 2.0 * batch * (cfg.d_conv - 1) * cfg.d_model * d_in_proj


def serve_target_cost(cfg: ModelConfig, phase: str, *, slots: int,
                      max_len: int, window: int, block_size: int,
                      prefill_len: int) -> Dict[str, float]:
    """Analytic cost of one serve-path audit target, keyed the way
    ``repro_torch.analysis.targets`` shapes it (``AUDIT_SHAPE``).

    Returns ``{"flops", "components"}`` and, for the paged phases,
    ``"kv_gather_bytes"``. ``flops`` counts matrix products only
    (:data:`NONCONTRACTION_COMPONENTS` left out), plus the conv-history
    recompute (``ssm_conv_hist``) of a recurrent family's prefill-like
    phases. ``kv_gather_bytes`` prices the gathered KV stream: the whole
    resident window a decode or verify pass (``slots × s_kv ×
    kv_bytes_per_token``), once a pass but for the hybrid's sequential
    verify (once a verify step), and 0 on the kernel route, which walks the
    pool in place (its operands are the audit's ``pallas_stream_bytes``,
    recorded, not reconciled).
    """
    if phase not in SERVE_PHASES:
        raise ValueError(f"unknown serve phase {phase!r}; "
                         f"expected one of {SERVE_PHASES}")
    hw = max((max_len // block_size) // 2, 1)   # the targets' half window
    batch = None                                # conv-hist rebuild batch
    if phase == "prefill":
        tokens, s_attn, decode = slots * prefill_len, prefill_len, False
        logits_tokens, batch = slots, slots     # last-position logits
    elif phase in ("decode", "paged_decode", "paged_decode_fused"):
        tokens, s_attn, decode = slots, max_len, True
        logits_tokens = slots
    elif phase == "paged_decode_hw":
        tokens, s_attn, decode = slots, hw * block_size, True
        logits_tokens = slots
    elif phase in ("verify", "paged_verify", "paged_verify_fused"):
        tokens, s_attn, decode = slots * window, max_len, True
        logits_tokens = slots * window
    else:  # prefill_chunk / paged_suffix_prefill: one sequence, a chunk
        #    attending its own tokens plus an equal-length prior context
        tokens, s_attn, decode = prefill_len, 2 * prefill_len, False
        logits_tokens, batch = 1, 1
    comp = forward_flops(cfg, tokens=float(tokens), s_attn=float(s_attn),
                         decode=decode)
    comp["logits"] = 2.0 * logits_tokens * cfg.d_model * cfg.vocab
    for key in NONCONTRACTION_COMPONENTS:
        comp.pop(key, None)
    if batch is not None and cfg.family in ("ssm", "hybrid"):
        comp["ssm_conv_hist"] = cfg.n_layers * _ssd_conv_hist_flops(
            cfg, float(batch))
    out: Dict[str, float] = {"flops": float(sum(comp.values()))}
    if phase.startswith("paged_"):
        kvbpt = kv_bytes_per_token(cfg)
        if phase == "paged_decode":
            kv = slots * max_len * kvbpt
        elif phase == "paged_decode_hw":
            kv = slots * hw * block_size * kvbpt
        elif phase == "paged_verify":
            steps = window if cfg.family == "hybrid" else 1
            kv = slots * max_len * kvbpt * steps
        else:
            # the suffix prefill takes its prefix K/V as a dense operand
            # (gathered by the engine before the call); the kernel route
            # walks the pool in place
            kv = 0.0
        out["kv_gather_bytes"] = float(kv)
    out["components"] = comp  # type: ignore[assignment]
    return out


def kv_resident_bytes(cfg: ModelConfig, *, n_blocks_in_use: int,
                      block_size: int) -> float:
    """Bytes the paged KV cache holds resident: the blocks in use, not the
    dense layout's ``n_slots · max_len`` reservation."""
    return n_blocks_in_use * block_size * kv_bytes_per_token(cfg)


# ---------------------------------------------------------------------------
# the cell model
# ---------------------------------------------------------------------------


def _train_multiplier(cfg: ModelConfig) -> float:
    """fwd=1, bwd=2, remat recompute: full≈+1, dots≈+0.5, none=+0."""
    return {"full": 4.0, "dots": 3.5, "none": 3.0}[cfg.remat]


def estimate_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshMeta, *,
                  resident_kv_tokens: Optional[float] = None) -> CellCost:
    """Per-device cost of one cell: ``cfg`` at ``shape`` on ``mesh``.

    ``resident_kv_tokens``: the KV tokens a decode cell's cache actually
    holds (paged serving: blocks in use × block size); by default the
    dense layout's whole ``B × S`` reservation.
    """
    B, S = shape.global_batch, shape.seq_len
    phase = shape.phase
    decode = phase == "decode"
    tokens = float(B) if decode else float(B * S)
    s_attn = float(S)

    comp = forward_flops(cfg, tokens=tokens, s_attn=s_attn, decode=decode)
    fwd = sum(comp.values())
    if phase == "train":
        mult = _train_multiplier(cfg)
        total_flops = (fwd - comp["logits"]) * mult + comp["logits"] * 3.0
    else:
        total_flops = fwd

    # ---- HBM bytes (first-order) -------------------------------------------
    pbytes_f32 = cfg.param_count() * F32
    pbytes_bf16 = cfg.param_count() * BF16
    chips = mesh.chips
    bcomp: Dict[str, float] = {}
    T_dev = tokens / max(mesh.dp, 1)
    d = cfg.d_model
    if phase == "train":
        # weights ×2 (fwd+bwd reads), grad write, adam m/v r+w, param r+w
        bcomp["params_opt"] = (2 * pbytes_bf16 + 8 * pbytes_f32) / chips
        if mesh.compress_grads:
            bcomp["error_feedback"] = 2 * pbytes_f32 / chips
        # residual + ~8 intermediates per layer, fwd write + bwd read, ×2 remat
        act_mult = {"full": 1.0, "dots": 1.5, "none": 2.0}[cfg.remat]
        bcomp["activations"] = (cfg.n_layers * T_dev * d * BF16
                                * 8 * 2 * act_mult) / mesh.model
        # flash KV re-read: KV streamed once per q-chunk
        if cfg.family in ("dense", "vlm", "moe", "encoder"):
            nq = max(S // cfg.q_chunk, 1)
            kv_b = tokens * cfg.n_kv_heads * cfg.head_dim * 2 * BF16
            bcomp["kv_stream"] = (cfg.n_layers * nq * kv_b) / chips
        bcomp["logits"] = 3 * T_dev * cfg.vocab * F32 / mesh.model
    elif phase == "prefill":
        bcomp["params"] = pbytes_bf16 / chips
        bcomp["activations"] = (cfg.n_layers * T_dev * d * BF16 * 8) \
            / mesh.model
        if cfg.family in ("dense", "vlm", "moe"):
            nq = max(S // cfg.q_chunk, 1)
            kv_b = tokens * cfg.n_kv_heads * cfg.head_dim * 2 * BF16
            bcomp["kv_stream"] = (cfg.n_layers * nq * kv_b) / chips
            bcomp["kv_cache_write"] = (cfg.n_layers * tokens * cfg.n_kv_heads
                                       * cfg.head_dim * 2 * BF16) / chips
    else:  # decode
        bcomp["params"] = pbytes_bf16 / chips
        kv_ways = mesh.kv_shard_ways(cfg)
        kv_tokens = float(B * S) if resident_kv_tokens is None \
            else float(resident_kv_tokens)
        if cfg.family in ("dense", "vlm", "moe", "hybrid"):
            bcomp["kv_cache_read"] = \
                kv_bytes_per_token(cfg) * kv_tokens / kv_ways
        if cfg.family in ("ssm", "hybrid"):
            ssm_state = (cfg.n_layers * B * cfg.n_ssm_heads * cfg.headdim
                         * cfg.d_state * F32)
            bcomp["ssm_state"] = 2 * ssm_state / chips

    # ---- collective wire bytes ----------------------------------------------
    ccomp: Dict[str, float] = {}
    tp = mesh.model
    n_attn = cfg.n_layers if cfg.family not in ("ssm", "hybrid") else \
        (cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)

    def block_ar_count() -> float:
        """Activation all-reduces a forward pass: one a sharded-output
        block (attention out, dense MLP down); an MoE layer's combine is
        its all-to-all (charged apart), and context-parallel attention
        swaps the attention's for a layout all-to-all."""
        attn_ar = 0 if mesh.attn_cp else n_attn
        if cfg.family == "moe":
            return attn_ar
        if cfg.family == "ssm":
            return cfg.n_layers  # ssm out_proj AR
        if cfg.family == "hybrid":
            return cfg.n_layers + attn_ar + n_attn  # mamba + shared mlp
        return attn_ar + cfg.n_layers  # attn + mlp per layer

    if phase == "train":
        grad_shard = pbytes_f32 / tp          # per model-shard gradient bytes
        grad_elem = 1.0 if mesh.compress_grads else 1.0 * F32
        ccomp["grad_reduce"] = ring_all_reduce(
            grad_shard * (grad_elem / F32), mesh.dp)
        if mesh.fsdp:
            # weights gathered over data axis fwd+bwd (bf16 compute copies)
            ccomp["fsdp_allgather"] = 2 * ring_all_gather(
                pbytes_bf16 / tp, mesh.data)
        act = T_dev * d * BF16
        ccomp["tp_activations"] = 2 * block_ar_count() * ring_all_reduce(
            act, tp)
        if mesh.attn_cp:
            # layout swap: each device exchanges only its activation shard
            ccomp["attn_cp_a2a"] = 2 * 2 * n_attn * all_to_all(act / tp, tp)
        if cfg.loss_impl == "gather":
            ccomp["logits_gather"] = ring_all_gather(
                T_dev * cfg.vocab * F32, tp) * 3  # fwd + bwd scatter
        else:
            ccomp["vocab_parallel_ce"] = ring_all_reduce(T_dev * F32 * 2, tp)
        if cfg.family == "moe":
            ccomp["moe_all_to_all"] = 2 * 2 * cfg.n_layers * all_to_all(
                T_dev * cfg.top_k * d * BF16, tp)
    else:
        act = (tokens / max(mesh.dp, 1)) * d * BF16
        ccomp["tp_activations"] = block_ar_count() * ring_all_reduce(act, tp)
        if mesh.attn_cp:
            ccomp["attn_cp_a2a"] = 2 * n_attn * all_to_all(act / tp, tp)
        if cfg.family == "moe":
            ccomp["moe_all_to_all"] = 2 * cfg.n_layers * all_to_all(
                (tokens / max(mesh.dp, 1)) * cfg.top_k * d * BF16, tp)
        if decode and shape.global_batch < mesh.dp:
            # SP decode: split-K softmax combine over the data axis
            stats = cfg.n_heads * 2 * F32 * B
            ccomp["sp_softmax_combine"] = n_attn * ring_all_reduce(
                stats, mesh.data)

    return CellCost(
        flops=total_flops / chips,
        hbm_bytes=sum(bcomp.values()),
        collective_bytes=sum(ccomp.values()),
        components=comp,
        bytes_components=bcomp,
        collective_components=ccomp,
    )
