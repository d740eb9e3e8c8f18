"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1024 d_inner=2048 (32 heads x 64) ssm_state=128 vocab=50280.
AMLA is inapplicable (no softmax rescale) — DESIGN.md §Arch-applicability.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    d_inner=2048,
    ssm_state=128,
    ssm_head_dim=64,
    conv_width=4,
    tie_embeddings=True,
)
