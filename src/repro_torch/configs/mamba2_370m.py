"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) ssm_state=128,
vocab=50280, SSD (state-space duality). [arXiv:2405.21060]

The paper's technique applies to the SSD scan itself: ``ssd_chunk`` is the
serialized-MOA cluster size (intra-chunk MXU tree / inter-chunk serial
accumulator) — see docs/moa-strategies.md.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    vocab=50280,
    d_state=128,
    headdim=64,
    n_groups=1,
    expand=2,          # d_inner = 2048 → 32 ssm heads
    tie_embeddings=True,
)
