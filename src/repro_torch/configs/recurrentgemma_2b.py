"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000,
lru_width=2560, local window 2048.  [arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("recurrent", "recurrent", "local"),
    window=2048,
    d_inner=2560,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)
