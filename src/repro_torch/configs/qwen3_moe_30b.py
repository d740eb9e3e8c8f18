"""qwen3-moe-30b-a3b [moe]: GQA + 128-expert top-8 MoE, QK-norm.

48L d_model=2048 32H (GQA kv=4, head_dim=128) expert d_ff=768 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    qk_norm=True,
    n_experts=128,
    n_experts_active=8,
    d_ff_expert=768,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
