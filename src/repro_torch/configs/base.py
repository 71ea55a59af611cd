"""Model/shape configuration schema — the port of ``repro/configs/base.py``.

Same fields, defaults and validation as the reference; dtype names stay
strings (``"bfloat16"``) and resolve to ``torch.dtype`` through
:attr:`ModelConfig.pdtype` / :attr:`ModelConfig.cdtype`. The ``moa`` spec is
validated by the port's own strategy registry, and ``attn_backend`` takes
the port's names: ``torch`` (plain PyTorch), ``kernel`` (the hand-written
CUDA kernels) or ``auto`` (kernel for CUDA tensors, plain for CPU tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple, Union

import torch

from repro_torch.device import as_dtype
from repro_torch.moa import MOAStrategy, resolve

__all__ = ["ModelConfig", "MOA_SITES", "ATTN_BACKEND_CHOICES", "ShapeSpec",
           "SHAPES", "shape_applicable"]

#: call sites that consult a per-site MOA override in ``moa_overrides``
MOA_SITES = ("attention", "mlp", "moe")

#: valid ``attn_backend`` values
ATTN_BACKEND_CHOICES = ("auto", "torch", "kernel")

#: ``moa`` / ``moa_overrides`` values: a spec string or a strategy instance
MOASpec = Union[str, MOAStrategy]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 5e5
    attn_impl: str = "flash"    # flash | full
    q_chunk: int = 256
    kv_chunk: int = 512
    # mlp
    d_ff: int = 0
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2 / zamba2)
    d_state: int = 0
    headdim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    ssd_chunk: int = 256
    # hybrid: one shared attention+MLP block every `attn_every` mamba layers
    attn_every: int = 0
    # vlm
    n_patches: int = 0
    # embeddings
    tie_embeddings: bool = False
    max_position: int = 1 << 20
    # MOA strategy (the paper's knob): a repro_torch.moa spec string or an
    # MOAStrategy instance, plus optional per-site overrides keyed by
    # MOA_SITES, normalized to a sorted tuple so the config stays hashable
    moa: MOASpec = "serial?chunk=4096"
    moa_overrides: Tuple[Tuple[str, MOASpec], ...] = ()
    # serving
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (quantized cache)
    # attention backend of prefill (flash) and paged decode: "torch" runs
    # the plain PyTorch versions, "kernel" the CUDA kernels, "auto" the
    # kernels on CUDA tensors and the plain versions on CPU tensors
    attn_backend: str = "auto"
    attn_cp: bool = False
    # training / lowering
    remat: str = "full"         # none | dots | full
    loss_impl: str = "vocab_parallel"   # vocab_parallel | gather
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        overrides = self.moa_overrides
        if isinstance(overrides, Mapping):
            overrides = tuple(sorted(overrides.items()))
            object.__setattr__(self, "moa_overrides", overrides)
        for site, spec in overrides:
            if site not in MOA_SITES:
                raise ValueError(f"unknown MOA site {site!r}; "
                                 f"expected one of {MOA_SITES}")
            resolve(spec)   # validate eagerly — typos fail at config time
        resolve(self.moa)
        if self.attn_backend not in ATTN_BACKEND_CHOICES:
            raise ValueError(f"unknown attn_backend {self.attn_backend!r}; "
                             f"expected one of {ATTN_BACKEND_CHOICES}")

    # ---- derived ----------------------------------------------------------
    @property
    def moa_strategy(self) -> MOAStrategy:
        """The model-wide default strategy (``moa_for`` adds per-site)."""
        return resolve(self.moa)

    def moa_for(self, site: str) -> MOAStrategy:
        """Strategy for a call site, honouring ``moa_overrides``."""
        for key, spec in self.moa_overrides:
            if key == site:
                return resolve(spec)
        return resolve(self.moa)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def pdtype(self) -> torch.dtype:
        return as_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return as_dtype(self.compute_dtype)

    @property
    def is_causal(self) -> bool:
        return self.family != "encoder"

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6·N·D."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = 0
        mlp = 0
        ssm = 0
        moe = 0
        if self.family in ("dense", "encoder", "vlm", "moe"):
            hd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            attn = d * (hd + 2 * kvd) + hd * d
        if self.family in ("dense", "encoder", "vlm"):
            mlp = 3 * d * self.d_ff if self.family != "encoder" else 2 * d * self.d_ff
        if self.family == "moe":
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            proj_in = d * (2 * di + 2 * self.n_groups * self.d_state
                           + self.n_ssm_heads)
            ssm = proj_in + di * d + self.d_conv * (
                di + 2 * self.n_groups * self.d_state)
        if self.family == "hybrid":
            hd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            shared = d * (hd + 2 * kvd) + hd * d + 3 * d * self.d_ff
            return emb + L * ssm + shared
        return emb + L * (attn + mlp + ssm + moe)

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        hd = self.n_heads * self.head_dim
        kvd = self.n_kv_heads * self.head_dim
        attn = d * (hd + 2 * kvd) + hd * d
        active_moe = self.top_k * 3 * d * self.d_ff + d * self.n_experts
        return emb + L * (attn + active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    phase: str                  # train | prefill | decode


#: the assignment's four cell shapes (the reference's ``SHAPES``)
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """The assignment's skip rules: ``(applicable, why not)``."""
    if cfg.family == "encoder" and shape.phase == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch: O(S^2) at 524k infeasible; "
                       "run only for SSM/hybrid per assignment")
    return True, ""
