"""seamless-m4t-medium [audio]: encoder-decoder, audio frontend stubbed.

12L (enc) + 12L (dec), d_model=1024 16H (kv=16, head_dim=64) d_ff=4096
vocab=256206.  The caller provides precomputed frame embeddings.
[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    act="gelu",
    tie_embeddings=True,
)
