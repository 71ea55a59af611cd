"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192, vocab=202048, MoE 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4 family]

The 202k vocab makes the logits softmax the largest *distributed* MOA in
the assignment — the vocab-parallel CE path (losses.py) is load-bearing.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    rope_theta=5e5,
)
