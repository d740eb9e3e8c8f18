"""gemma2-2b [dense]: local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000,
window 4096, attn softcap 50, final softcap 30, sandwich norms.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)
