"""granite-moe-3b-a800m [moe]: GQA + 40-expert top-8 MoE.

32L d_model=1536 24H (GQA kv=8, head_dim=64) expert d_ff=512 vocab=49155.
NOTE: assignment's structured field says 40 experts, its comment says 32;
we follow the structured field (see DESIGN.md §Arch-applicability).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    n_experts=40,
    n_experts_active=8,
    d_ff_expert=512,
    tie_embeddings=True,
)
