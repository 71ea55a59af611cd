"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16) expert
d_ff=1408, vocab=163840, MoE 64 experts top-6 (kimi/moonlight style).
[hf:moonshotai/Moonlight-16B-A3B; hf-verified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
    rope_theta=5e5,
)
