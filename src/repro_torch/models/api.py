"""Uniform model API — the port of ``repro/models/api.py`` for all six
families: dense, MoE, SSM (Mamba-2), hybrid (Zamba2), the encoder (HuBERT:
its prefill is the bidirectional encode, and it has no decode step) and
the VLM (LLaVA: its prefill takes the patch batch); training
(:meth:`Model.loss`) for all six.

``build_model(cfg)`` returns a :class:`Model`, an ``nn.Module`` whose
parameters, once :meth:`Model.init` or :meth:`Model.load_params` ran, are
registered under the reference pytree's paths (``layers.attn.wq``, stacked
on a leading ``L`` axis). Like the reference, the serving and training
methods take the parameter tree explicitly (``model.prefill(params,
batch, ...)``, ``model.loss(params, batch)``): the serving tree is the
registered one, without gradients; a train state holds its own leaves
that require grad (:func:`repro_torch.launch.steps.init_train_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.layers.common import Params
from repro_torch.models import (losses, mamba2, moe_transformer,
                                transformer, zamba2)
from repro_torch.parallel.collectives import fsdp_params

__all__ = ["CacheSpec", "Model", "build_model"]

#: the module of each family
_FAMILIES = {"dense": transformer, "encoder": transformer,
             "vlm": transformer, "moe": moe_transformer, "ssm": mamba2,
             "hybrid": zamba2}

#: the families with a recurrent (per-slot, constant-size) decode state
_RECURRENT = ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Decode-cache layout summary (the reference's ``CacheSpec``):
    ``n_kv_stacks`` KV stacks (layers), ``kv_bytes_per_token`` across all
    of them (int8 scales included), ``slot_state_bytes`` of per-slot
    constant state (the SSM and hybrid families' recurrent state; 0 for
    the dense and MoE families)."""

    family: str
    n_kv_stacks: int
    n_kv_heads: int
    head_dim: int
    kv_bytes_per_token: int
    slot_state_bytes: int

    @property
    def pageable(self) -> bool:
        """Whether the family has K/V to page (not the pure SSM)."""
        return self.n_kv_stacks > 0

    def kv_block_bytes(self, block_size: int) -> int:
        """Bytes of one physical page across all KV stacks."""
        return self.kv_bytes_per_token * block_size

    def dense_kv_bytes(self, n_slots: int, max_len: int) -> int:
        """KV bytes a dense-slot layout reserves for ``n_slots·max_len``."""
        return self.kv_bytes_per_token * n_slots * max_len


class _ParamTree(nn.Module):
    """A nested dict of tensors registered as submodules and parameters
    under its own keys, without gradients: the serving tree. Training
    differentiates a train state's own leaves, which share these tensors'
    storage when the state was drawn through :meth:`Model.init`."""

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
    """A model of any of the six families with the reference ``Model``'s
    serving surface and its ``loss``."""

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
        self._modules.clear()
        self._parameters.clear()
        for key, value in params.items():
            if isinstance(value, Mapping):
                self.add_module(key, _ParamTree(value))
            else:               # a top-level leaf (the encoder's pos_embed)
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))
        return self.params()

    def params(self) -> Params:
        """The registered parameters as the reference's nested dict."""
        return _ParamTree.tree(self)

    def abstract_params(self) -> Params:
        """The parameter tree's shapes and dtypes as ``meta`` tensors (the
        reference's ``eval_shape`` of ``init``): no memory, no draws."""
        return self._mod.init_params(self.cfg, torch.Generator(),
                                     torch.device("meta"))

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---- forward ----------------------------------------------------------
    def forward_with_aux(self, params: Params, batch: dict):
        """``(logits, aux)``: the MoE router's load-balance loss beside the
        logits (``None`` for the other families). Under FSDP ``params``
        are this rank's slices, gathered where they are read
        (:func:`repro_torch.parallel.collectives.fsdp_params`; each layer
        its own, :func:`~repro_torch.parallel.collectives.fsdp_layer`)."""
        out = self._mod.forward(fsdp_params(params), batch, self.cfg)
        return out if isinstance(out, tuple) else (out, None)

    def forward(self, params: Params, batch: dict):
        """The training forward → logits ``(B, S, V)`` (the VLM's text
        positions only)."""
        return self.forward_with_aux(params, batch)[0]

    # ---- training ---------------------------------------------------------
    def loss(self, params: Params, batch: dict):
        """``(loss, metrics)`` of ``batch``: mean cross-entropy of
        ``tokens`` (a VLM's also ``patches``) against ``labels`` over an
        optional ``loss_mask``, plus ``0.01 * aux`` for the MoE
        (``metrics["aux_loss"]``); the encoder's masked-prediction loss of
        ``frames`` against ``targets`` at the frames ``mask`` marks.
        ``metrics`` also has ``tokens`` and ``accuracy``, each a 0-d f32
        tensor. On a mesh (this model the local one of a rank: its heads,
        ``ff`` and experts; ``batch`` this rank's rows) ``loss`` is this
        rank's share of the global batch's, and ``metrics`` are the global
        batch's (:mod:`repro_torch.models.losses`)."""
        logits, aux = self.forward_with_aux(params, batch)
        if self.cfg.family == "encoder":
            loss, metrics = losses.masked_lm_loss(
                logits, batch["targets"], batch["mask"],
                impl=self.cfg.loss_impl)
        else:
            loss, metrics = losses.softmax_cross_entropy(
                logits, batch["labels"], mask=batch.get("loss_mask"),
                impl=self.cfg.loss_impl)
        if aux is not None:
            loss = loss + 0.01 * aux
            metrics = dict(metrics, aux_loss=aux,
                           loss=metrics["loss"] + 0.01 * aux.detach())
        return loss, metrics

    # ---- serving ----------------------------------------------------------
    @property
    def supports_padded_prefill(self) -> bool:
        """Whether right-padded prompts are exact: padded K/V rows are
        masked; an MoE's pad tokens compete for expert capacity, so it is
        exact only in the dropless regime (``capacity_factor >= n_experts
        / top_k``); a recurrent state would absorb the pad tokens, so the
        SSM and hybrid families prefill at the exact length; a VLM's
        ``prompt_len`` would count text while its sequence carries the
        patch prefix; the encoder has no prefill cache."""
        cfg = self.cfg
        if cfg.family == "moe":
            return cfg.capacity_factor >= cfg.n_experts / max(cfg.top_k, 1)
        return cfg.family == "dense"

    @property
    def kv_key(self) -> Optional[str]:
        """The cache key of the K/V stacks: ``"kv"`` (hybrid), ``"layers"``
        (dense, MoE), ``None`` (SSM: no K/V)."""
        return {"hybrid": "kv", "ssm": None}.get(self.cfg.family, "layers")

    @property
    def state_key(self) -> Optional[str]:
        """The cache key of the per-slot recurrent state: ``"ssm"``
        (hybrid), ``"layers"`` (SSM), ``None`` (dense, MoE)."""
        return {"hybrid": "ssm", "ssm": "layers"}.get(self.cfg.family)

    def cache_spec(self) -> CacheSpec:
        """Bytes a token of K/V takes across all stacks, and a slot's
        constant recurrent state (the reference's, from ``init_cache``'s
        shapes: the hybrid's K/V in the compute type, the conv history in
        bf16 and ``h`` in f32); all zeros for the encoder."""
        cfg = self.cfg
        if cfg.family == "encoder":
            return CacheSpec(family=cfg.family, n_kv_stacks=0, n_kv_heads=0,
                             head_dim=0, kv_bytes_per_token=0,
                             slot_state_bytes=0)
        slot_state = 0
        if cfg.family in _RECURRENT:
            conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
            slot_state = cfg.n_layers * (
                cfg.n_ssm_heads * cfg.headdim * cfg.d_state * 4
                + (cfg.d_conv - 1) * conv_dim * 2)
        if cfg.family == "ssm":
            return CacheSpec(family=cfg.family, n_kv_stacks=0,
                             n_kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.head_dim, kv_bytes_per_token=0,
                             slot_state_bytes=slot_state)
        if cfg.family == "hybrid":
            stacks = zamba2.n_applications(cfg)
            per_stack = 2 * cfg.n_kv_heads * cfg.head_dim * cfg.cdtype.itemsize
        else:
            stacks = cfg.n_layers
            item = transformer.kv_dtype(cfg).itemsize
            per_stack = 2 * cfg.n_kv_heads * cfg.head_dim * item
            if cfg.kv_cache_dtype == "int8":
                per_stack += 2 * cfg.n_kv_heads * 4         # f32 scales
        return CacheSpec(family=cfg.family, n_kv_stacks=stacks,
                         n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                         kv_bytes_per_token=stacks * per_stack,
                         slot_state_bytes=slot_state)

    def init_cache(self, batch: int, max_len: int, *, device):
        """Zeroed dense-slot decode state for ``batch`` sequences of
        ``max_len`` tokens, with a 0-d int32 cursor (the engine makes it a
        ``(batch,)`` vector)."""
        return self._mod.init_cache(self.cfg, batch, max_len, device=device)

    def init_paged_cache(self, n_slots: int, n_phys_blocks: int,
                         block_size: int, max_blocks: int, *, device):
        """Paged decode state: K/V page pools, per-slot block tables and
        cursors (a hybrid's Mamba-2 states dense per slot). The SSM family
        has no K/V to page and raises."""
        if not self.cache_spec().pageable:
            raise ValueError(
                f"family {self.cfg.family!r} has no KV cache to page — its "
                "decode state is constant-size per slot")
        return self._mod.init_paged_cache(self.cfg, n_slots, n_phys_blocks,
                                          block_size, max_blocks,
                                          device=device)

    def split_prefill_cache(self, pre):
        """``(kv leaves (stack, 1, max_len, ...), per-slot state or
        None)``: the hybrid's K/V and Mamba-2 states; the dense and MoE
        families keep no per-slot state."""
        if self.cfg.family == "hybrid":
            return pre["kv"], pre["ssm"]
        return pre["layers"], None

    def prefill(self, params: Params, batch: dict, *, max_len: int,
                prompt_len: Union[int, torch.Tensor, None] = None):
        """``(logits (B, 1, V) at the last real position, cache)``; a VLM's
        ``batch`` also holds ``patches``, prefilled ahead of the text (the
        cursor is then ``P + S_text``). The encoder's "prefill" is the
        bidirectional encode: ``(logits (B, T, V), {"pos": T})``, no KV
        cache. ``prompt_len``: a Python int, or a 0-d int32 tensor on the
        tokens' device (the last real row is then picked on the device, as
        a CUDA graph of the prefill needs); only where
        :attr:`supports_padded_prefill`, else it raises."""
        cfg = self.cfg
        if cfg.family == "encoder":
            logits = transformer.encode(params, batch, cfg)
            return logits, {"pos": torch.tensor(
                logits.shape[1], dtype=torch.int32, device=logits.device)}
        if prompt_len is None:
            return self._mod.prefill(params, batch, cfg, max_len=max_len)
        if not self.supports_padded_prefill:
            raise ValueError(
                f"family {cfg.family!r} cannot prefill padded prompts: "
                "recurrent state would absorb the pad tokens")
        return self._mod.prefill(params, batch, cfg, max_len=max_len,
                                 prompt_len=prompt_len)

    def prefill_suffix(self, params: Params, batch: dict, *, prefix,
                       prompt_len: int):
        """Suffix-only prefill against cached prefix K/V: the dense family
        always, an MoE only in the dropless regime (below it, expert
        capacity couples the suffix to the prefix it no longer sees). The
        recurrent families have no position-addressed prefix to resume
        from and chunk through :meth:`prefill_chunk` instead."""
        if not (self.cfg.family == "dense" or (
                self.cfg.family == "moe" and self.supports_padded_prefill)):
            raise ValueError(
                f"family {self.cfg.family!r} cannot skip prefix prefill "
                "compute (expert-capacity or recurrent-state coupling)")
        return self._mod.prefill_suffix(params, batch, self.cfg,
                                        prefix=prefix, prompt_len=prompt_len)

    def decode_step(self, params: Params, cache, tokens):
        """One decode step against the dense-slot cache, in place
        (``tokens (B, 1)``; a VLM continues at ``pos = P + S_text``)."""
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
        dropless), the SSM and hybrid families through
        :meth:`prefill_chunk` (carried recurrent state). The encoder has no
        decode; the VLM is not served."""
        if self.cfg.family == "moe":
            return self.supports_padded_prefill
        return self.cfg.family in ("dense",) + _RECURRENT

    @property
    def prefill_chunk_alignment(self) -> int:
        """Chunk boundaries must be multiples of this many tokens: the
        recurrent families' ``ssd_chunk`` (the chunked scan's grouping must
        be the one-shot scan's), 1 for the attention families (the paged
        engine still aligns chunks to ``block_size``)."""
        if self.cfg.family in _RECURRENT:
            return self.cfg.ssd_chunk
        return 1

    def prefill_chunk(self, params: Params, batch: dict, *, state,
                      prefix_kv=None):
        """Continue a recurrent family's chunked prefill from carried
        ``state`` (what :meth:`prefill` or an earlier chunk returned); the
        hybrid also takes ``prefix_kv``, the shared block's prefix K/V
        ``(n_apps, 1, P, Hk, D)``. Attention families raise: they chunk
        through :meth:`prefill_suffix`."""
        if self.cfg.family == "ssm":
            return mamba2.prefill_chunk(params, batch, self.cfg, state=state)
        if self.cfg.family == "hybrid":
            return zamba2.prefill_chunk(params, batch, self.cfg, state=state,
                                        prefix_kv=prefix_kv)
        raise ValueError(
            f"family {self.cfg.family!r} has no carried-state prefill "
            "chunk — attention families chunk via prefill_suffix")

    # ---- speculative decoding ---------------------------------------------
    @property
    def supports_spec_decode(self) -> bool:
        """Whether a T-token verify is exact: the dense family always, an
        MoE only in the dropless regime (below it, expert capacity couples
        the draft window's tokens), the SSM and hybrid families by
        construction (T scanned decode steps with state snapshots). The
        encoder has no decode; the VLM is not served."""
        if self.cfg.family == "moe":
            return self.supports_padded_prefill
        return self.cfg.family in ("dense",) + _RECURRENT

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
        ``pos`` still at the pre-verify cursor; ``aux`` is ``None``, or a
        recurrent family's state snapshots for :meth:`commit_verified`."""
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
        1; 0 for idle slots), in place; a recurrent family also restores
        each slot's state from the snapshot ``aux`` holds at ``keep``."""
        return self._mod.commit_verified(cache, keep, aux, self.cfg)

    # ---- shapes -----------------------------------------------------------
    def _token_split(self, seq_len: int):
        """``(patch prefix, text)`` of a VLM sequence of ``seq_len``
        positions (at most half of it patches); ``(0, seq_len)`` for the
        other families."""
        if self.cfg.family == "vlm":
            n_patches = min(self.cfg.n_patches, seq_len // 2)
            return n_patches, seq_len - n_patches
        return 0, seq_len

    def input_specs(self, shape: ShapeSpec) -> Dict[str, Any]:
        """The batch of ``shape``'s phase as ``meta`` tensors (the
        reference's ``ShapeDtypeStruct`` stand-ins: no memory). A decode
        shape gives one token a sequence and the dense-slot cache of
        ``shape.seq_len`` positions (:meth:`init_cache`); the encoder's
        frames and the VLM's patches are bf16, as the reference's."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        meta = torch.device("meta")

        def sds(dims, dtype):
            return torch.empty(dims, dtype=dtype, device=meta)

        if shape.phase == "decode":
            return {"tokens": sds((B, 1), torch.int32),
                    "cache": self.init_cache(B, S, device=meta)}
        if cfg.family == "encoder":
            specs = {"frames": sds((B, S, cfg.d_model), torch.bfloat16),
                     "mask": sds((B, S), torch.bool)}
            if shape.phase == "train":
                specs["targets"] = sds((B, S), torch.int32)
            return specs
        n_patches, s_text = self._token_split(S)
        specs = {"tokens": sds((B, s_text), torch.int32)}
        if n_patches:
            specs["patches"] = sds((B, n_patches, cfg.d_model),
                                   torch.bfloat16)
        if shape.phase == "train":
            specs["labels"] = sds((B, s_text), torch.int32)
        return specs

    def make_batch(self, generator: torch.Generator, shape: ShapeSpec, *,
                   batch_override: Optional[int] = None,
                   seq_override: Optional[int] = None) -> Dict[str, Any]:
        """A random batch of ``shape``'s phase (training and prefill
        inputs; the reference's smoke batch) drawn from ``generator``, on
        its device: tokens, labels and targets uniform over the
        vocabulary, frames and patches ``0.02 · N(0, 1)`` in f32, the
        encoder's mask Bernoulli(0.35)."""
        cfg = self.cfg
        B = batch_override or shape.global_batch
        S = seq_override or shape.seq_len
        kw = dict(generator=generator, device=generator.device)

        def tokens(*dims):
            return torch.randint(0, cfg.vocab, dims, dtype=torch.int32, **kw)

        if cfg.family == "encoder":
            out = {"frames": 0.02 * torch.randn((B, S, cfg.d_model), **kw),
                   "mask": torch.rand((B, S), **kw) < 0.35}
            if shape.phase == "train":
                out["targets"] = tokens(B, S)
            return out
        n_patches, s_text = self._token_split(S)
        out = {"tokens": tokens(B, s_text)}
        if n_patches:
            out["patches"] = 0.02 * torch.randn((B, n_patches, cfg.d_model),
                                                **kw)
        if shape.phase == "train":
            out["labels"] = tokens(B, s_text)
        return out


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(cfg)
