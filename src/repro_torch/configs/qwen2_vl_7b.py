"""qwen2-vl-7b [vlm]: GQA + M-RoPE; vision tower stubbed.

28L d_model=3584 28H (GQA kv=4, head_dim=128) d_ff=18944 vocab=152064,
mrope sections (16, 24, 24).  The caller provides the patch embeddings.
[arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    vision_stub_tokens=256,
    tie_embeddings=False,
)
