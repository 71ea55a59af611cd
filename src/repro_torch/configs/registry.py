"""Architecture registry: ``--arch <id>`` lookup + reduced smoke configs."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (hubert_xlarge, llama3_8b, llama3_405b,
                                 llama4_maverick_400b_a17b, llava_next_34b,
                                 mamba2_370m, moonshot_v1_16b_a3b,
                                 qwen1_5_32b, yi_34b, zamba2_1_2b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      shape_applicable)

__all__ = ["ARCHS", "get_config", "list_archs", "smoke_config",
           "valid_cells", "SHAPES", "ShapeSpec"]

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen1_5_32b.CONFIG,
        yi_34b.CONFIG,
        llama3_8b.CONFIG,
        llama3_405b.CONFIG,
        llava_next_34b.CONFIG,
        zamba2_1_2b.CONFIG,
        hubert_xlarge.CONFIG,
        mamba2_370m.CONFIG,
        llama4_maverick_400b_a17b.CONFIG,
        moonshot_v1_16b_a3b.CONFIG,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests.

    Preserves the structural features (GQA ratio, MoE routing arity, hybrid
    grouping, biases, tying) while shrinking every dimension — the same
    reduction as the reference's, so both packages build one config.
    """
    kv_ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    n_heads = 4
    updates = dict(
        n_layers=3 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=n_heads if cfg.n_heads else 0,
        n_kv_heads=(max(n_heads // kv_ratio, 1) if cfg.n_kv_heads else 0),
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=257,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        capacity_factor=8.0 if cfg.n_experts else cfg.capacity_factor,
        d_state=16 if cfg.d_state else 0,
        headdim=16 if cfg.d_state else 64,
        expand=cfg.expand,
        attn_every=1 if cfg.attn_every else 0,
        n_patches=8 if cfg.n_patches else 0,
        q_chunk=16,
        kv_chunk=16,
        ssd_chunk=8,
        moa="serial?chunk=32",
        remat="none",
        max_position=2048,
        name=cfg.name + "-smoke",
    )
    return dataclasses.replace(cfg, **updates)


def valid_cells():
    """All ``(arch, shape name, applicable, why not)`` cells under the
    assignment's skip rules."""
    cells = []
    for arch, cfg in sorted(ARCHS.items()):
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            cells.append((arch, sname, ok, why))
    return cells
