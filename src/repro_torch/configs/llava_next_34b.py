"""llava-next-34b [vlm] — yi-34b backbone (60L d_model=7168 56H GQA kv=8
d_ff=20480 vocab=64000) with anyres patch tiling.
[hf:llava-hf/llava-v1.6 family]

Per the assignment the modality frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings at d_model (anyres tiling happens
upstream of this framework); the backbone + mm-projector are real.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    n_patches=2304,   # anyres high-res tiling budget (stubbed frontend)
)
