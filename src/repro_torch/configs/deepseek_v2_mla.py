"""deepseek-v2-mla: the paper's native attention geometry.

60L d_model=5120, 128 heads, MLA latent 512 + rope 64 (576-wide cache),
d_nope=d_vhead=128, dense d_ff=12288, vocab=102400.  [arXiv:2405.04434]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-mla",
    family="mla",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=1,
    head_dim=192,  # d_nope + d_rope (pre-absorption)
    d_ff=12288,
    vocab_size=102400,
    mla=MLAConfig(d_latent=512, d_rope=64, d_nope=128, d_vhead=128),
    attn_scale=None,
    rope_theta=10000.0,
    tie_embeddings=False,
)
