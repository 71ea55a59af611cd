"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783]

The d_ff=53248 down-projection is the widest dense MOA in the assignment
(53 248 operands per output element) — the natural subject for the paper's
serialized-reduction strategy (``moa_chunk``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
)
