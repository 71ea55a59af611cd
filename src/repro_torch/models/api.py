"""Uniform model API — the port of ``repro/models/api.py`` for the served
dense and MoE families.

``build_model(cfg)`` returns a :class:`Model`, an ``nn.Module`` whose
parameters, once :meth:`Model.init` or :meth:`Model.load_params` ran, are
registered under the reference pytree's paths (``layers.attn.wq``, stacked
on a leading ``L`` axis). Like the reference, the serving methods take the
parameter tree explicitly (``model.prefill(params, batch, ...)``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.common import Params
from repro_torch.models import moe_transformer, transformer

__all__ = ["CacheSpec", "Model", "build_model"]

#: the module of each ported family
_FAMILIES = {"dense": transformer, "moe": moe_transformer}

#: where each unported family lands (ROADMAP Queue 1)
_UNPORTED = {
    "ssm": "ROADMAP Queue 1, item 10 (SSM and hybrid)",
    "hybrid": "ROADMAP Queue 1, item 10 (SSM and hybrid)",
    "encoder": "ROADMAP Queue 1, item 12 (training; the engine serves no "
               "encoder)",
    "vlm": "ROADMAP Queue 1, item 12 (training; the engine serves no vlm)",
}


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Decode-cache layout summary (the reference's ``CacheSpec``):
    ``n_kv_stacks`` KV stacks (layers), ``kv_bytes_per_token`` across all
    of them (int8 scales included), ``slot_state_bytes`` of per-slot
    constant state (0 for the dense family)."""

    family: str
    n_kv_stacks: int
    n_kv_heads: int
    head_dim: int
    kv_bytes_per_token: int
    slot_state_bytes: int

    def kv_block_bytes(self, block_size: int) -> int:
        """Bytes of one physical page across all KV stacks."""
        return self.kv_bytes_per_token * block_size

    def dense_kv_bytes(self, n_slots: int, max_len: int) -> int:
        """KV bytes a dense-slot layout reserves for ``n_slots·max_len``."""
        return self.kv_bytes_per_token * n_slots * max_len


class _ParamTree(nn.Module):
    """A nested dict of tensors registered as submodules and parameters
    under its own keys (no gradients: the port serves)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, _ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Params:
        out = {k: m.tree() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


class Model(nn.Module):
    """A dense or MoE decoder with the reference ``Model``'s serving
    surface."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self._mod = _FAMILIES[cfg.family]

    # ---- parameters -------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, *,
             seed: int = 0,
             device: Union[str, torch.device] = "cuda") -> Params:
        """Random parameters on ``device`` (the GPU unless the caller asks
        for the CPU; no GPU raises), drawn from ``generator`` or from a new
        one seeded with ``seed``. Registers them and returns the tree."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        return self.load_params(
            self._mod.init_params(self.cfg, generator, dev))

    def load_params(self, params: Params) -> Params:
        """Register ``params`` (e.g. from :func:`repro_torch.interop.
        from_numpy`) and return the registered tree."""
        for key in list(self._modules):
            del self._modules[key]
        for key, value in params.items():
            self.add_module(key, _ParamTree(value))
        return self.params()

    def params(self) -> Params:
        """The registered parameters as the reference's nested dict."""
        return {k: m.tree() for k, m in self._modules.items()}

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---- forward ----------------------------------------------------------
    def forward_with_aux(self, params: Params, batch: dict):
        """``(logits, aux)``: the MoE router's load-balance loss beside the
        logits (``None`` for the dense family)."""
        out = self._mod.forward(params, batch, self.cfg)
        return out if isinstance(out, tuple) else (out, None)

    def forward(self, params: Params, batch: dict):
        """Causal forward → logits ``(B, S, V)``."""
        return self.forward_with_aux(params, batch)[0]

    # ---- serving ----------------------------------------------------------
    @property
    def supports_padded_prefill(self) -> bool:
        """Whether right-padded prompts are exact: padded K/V rows are
        masked; an MoE's pad tokens compete for expert capacity, so it is
        exact only in the dropless regime (``capacity_factor >= n_experts
        / top_k``)."""
        cfg = self.cfg
        if cfg.family == "moe":
            return cfg.capacity_factor >= cfg.n_experts / max(cfg.top_k, 1)
        return True

    def cache_spec(self) -> CacheSpec:
        cfg = self.cfg
        item = transformer.kv_dtype(cfg).itemsize
        per_layer = 2 * cfg.n_kv_heads * cfg.head_dim * item
        if cfg.kv_cache_dtype == "int8":
            per_layer += 2 * cfg.n_kv_heads * 4            # f32 scales
        return CacheSpec(family=cfg.family, n_kv_stacks=cfg.n_layers,
                         n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                         kv_bytes_per_token=cfg.n_layers * per_layer,
                         slot_state_bytes=0)

    def init_cache(self, batch: int, max_len: int, *, device):
        """Zeroed dense-slot decode state for ``batch`` sequences of
        ``max_len`` tokens, with a 0-d int32 cursor (the engine makes it a
        ``(batch,)`` vector)."""
        return self._mod.init_cache(self.cfg, batch, max_len, device=device)

    def init_paged_cache(self, n_slots: int, n_phys_blocks: int,
                         block_size: int, max_blocks: int, *, device):
        return self._mod.init_paged_cache(self.cfg, n_slots, n_phys_blocks,
                                          block_size, max_blocks,
                                          device=device)

    def split_prefill_cache(self, pre):
        """``(kv leaves (L, 1, max_len, ...), per-slot state)``; the dense
        and MoE families keep no per-slot state."""
        return pre["layers"], None

    def prefill(self, params: Params, batch: dict, *, max_len: int,
                prompt_len: Union[int, torch.Tensor, None] = None):
        """``prompt_len``: a Python int, or a 0-d int32 tensor on the
        tokens' device (the last real row is then picked on the device, as
        a CUDA graph of the prefill needs)."""
        return self._mod.prefill(params, batch, self.cfg, max_len=max_len,
                                 prompt_len=prompt_len)

    def prefill_suffix(self, params: Params, batch: dict, *, prefix,
                       prompt_len: int):
        """Suffix-only prefill against cached prefix K/V: the dense family
        always, an MoE only in the dropless regime (below it, expert
        capacity couples the suffix to the prefix it no longer sees)."""
        if self.cfg.family == "moe" and not self.supports_padded_prefill:
            raise ValueError(
                f"family {self.cfg.family!r} cannot skip prefix prefill "
                "compute (expert-capacity coupling)")
        return self._mod.prefill_suffix(params, batch, self.cfg,
                                        prefix=prefix, prompt_len=prompt_len)

    def decode_step(self, params: Params, cache, tokens):
        """One decode step against the dense-slot cache, in place."""
        return self._mod.decode_step(params, cache, tokens, self.cfg)

    def paged_decode_step(self, params: Params, cache, tokens, *,
                          live_blocks: Optional[int] = None):
        return self._mod.paged_decode_step(params, cache, tokens, self.cfg,
                                           live_blocks=live_blocks)

    # ---- chunked prefill --------------------------------------------------
    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether a prompt can be prefilled in chunks interleaved with
        decode ticks, equal to the one-shot prefill: the attention families
        chunk through :meth:`prefill_suffix` (dense always, an MoE only
        dropless)."""
        if self.cfg.family == "moe":
            return self.supports_padded_prefill
        return self.cfg.family == "dense"

    @property
    def prefill_chunk_alignment(self) -> int:
        """Chunk boundaries must be multiples of this many tokens: 1 for
        the attention families (the paged engine still aligns chunks to
        ``block_size``)."""
        return 1

    # ---- speculative decoding ---------------------------------------------
    @property
    def supports_spec_decode(self) -> bool:
        """Whether a T-token verify is exact: the dense family always, an
        MoE only in the dropless regime (below it, expert capacity couples
        the draft window's tokens)."""
        if self.cfg.family == "moe":
            return self.supports_padded_prefill
        return self.cfg.family == "dense"

    def _check_spec(self) -> None:
        if not self.supports_spec_decode:
            raise ValueError(
                f"family {self.cfg.family!r} (cfg {self.cfg.name!r}) has no "
                "exact multi-token verify (capacity-limited MoE couples the "
                "draft window through expert capacity)")

    def verify_step(self, params: Params, cache, tokens):
        """Score ``tokens (B, T)`` in one call against the dense-slot cache
        (column 0 each slot's pending token, then its draft): ``(logits
        (B, T, V), cache, aux)``, the T rows written tentatively in place,
        ``pos`` still at the pre-verify cursor."""
        self._check_spec()
        return self._mod.verify_step(params, cache, tokens, self.cfg)

    def paged_verify_step(self, params: Params, cache, tokens, *,
                          live_blocks: Optional[int] = None):
        """:meth:`verify_step` against the paged cache; ``live_blocks``
        must cover the deepest cursor plus the window."""
        self._check_spec()
        return self._mod.paged_verify_step(params, cache, tokens, self.cfg,
                                           live_blocks=live_blocks)

    def commit_verified(self, cache, keep, aux=None):
        """Advance each slot's ``pos`` by ``keep (B,)`` (accepted drafts +
        1; 0 for idle slots), in place."""
        return self._mod.commit_verified(cache, keep, aux, self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        where = _UNPORTED.get(cfg.family)
        if where is None:
            raise ValueError(f"unknown family {cfg.family!r}")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {where}")
    return Model(cfg)
