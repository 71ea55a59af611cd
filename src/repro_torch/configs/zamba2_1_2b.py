"""zamba2-1.2b [hybrid] — 38 Mamba2 layers, d_model=2048, ssm_state=64,
shared attention block (32H kv=32, head_dim 64) + shared d_ff=8192 MLP
applied every 6 mamba layers, vocab=32000. [arXiv:2411.15242; hf-verified]

Runs long_500k: SSM state is O(1) in sequence; only the shared block's
(periodic) KV caches scale with context.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    d_state=64,
    headdim=64,
    n_groups=1,
    expand=2,          # d_inner = 4096 → 64 ssm heads
    attn_every=6,      # 6 shared-block applications + 2 tail mamba layers
    rope_theta=1e4,
)
