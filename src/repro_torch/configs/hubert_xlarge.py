"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504
(masked-unit prediction targets), encoder-only. [arXiv:2106.07447]

Per the assignment: the conv waveform frontend is a STUB — inputs are
precomputed frame embeddings at d_model. Encoder-only ⇒ decode shapes are
skipped (no autoregressive step exists).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
)
