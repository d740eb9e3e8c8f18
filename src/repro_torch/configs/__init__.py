"""Architecture registry: full configs + reduced smoke configs.

Copied from ``repro.configs``; only the architectures the port serves are
registered: ``deepseek-v2-mla`` (paged and dense), the dense-served GQA
stacks ``gemma2-2b``, ``qwen2.5-3b``, ``qwen1.5-0.5b`` and
``internlm2-20b``, the MoE stacks ``qwen3-moe-30b-a3b`` and
``granite-moe-3b-a800m``, the Mamba-2 stack ``mamba2-370m``, the RG-LRU
hybrid ``recurrentgemma-2b``, the vision-language ``qwen2-vl-7b`` (all
dense-served) and the encoder-decoder ``seamless-m4t-medium`` (served
through ``EncDecModel.init_cache`` / ``decode_step``): all eleven of the
reference's architectures.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_v2_mla,
    gemma2_2b,
    granite_moe_3b,
    internlm2_20b,
    mamba2_370m,
    qwen1_5_0_5b,
    qwen2_5_3b,
    qwen2_vl_7b,
    qwen3_moe_30b,
    recurrentgemma_2b,
    seamless_m4t_medium,
)
from repro_torch.configs.base import (
    LM_SHAPES,
    LONG_CONTEXT_ARCHS,
    MLAConfig,
    ModelConfig,
    ShapeConfig,
    runnable_shapes,
)

# The ten assigned architectures (+ the paper's own geometry as a bonus).
ASSIGNED = [
    "recurrentgemma-2b",
    "gemma2-2b",
    "internlm2-20b",
    "qwen1.5-0.5b",
    "qwen2.5-3b",
    "seamless-m4t-medium",
    "mamba2-370m",
    "qwen2-vl-7b",
    "granite-moe-3b-a800m",
    "qwen3-moe-30b-a3b",
]
BONUS = ["deepseek-v2-mla"]

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        recurrentgemma_2b.CONFIG,
        gemma2_2b.CONFIG,
        internlm2_20b.CONFIG,
        qwen1_5_0_5b.CONFIG,
        qwen2_5_3b.CONFIG,
        seamless_m4t_medium.CONFIG,
        mamba2_370m.CONFIG,
        qwen2_vl_7b.CONFIG,
        granite_moe_3b.CONFIG,
        qwen3_moe_30b.CONFIG,
        deepseek_v2_mla.CONFIG,
    ]
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, narrow
    widths, tiny vocab/experts — preserving every structural feature
    (pattern, softcaps, biases, qk-norm, MoE/MLA/SSM plumbing)."""
    period = len(cfg.layer_pattern)
    updates = dict(
        name=cfg.name + "-smoke",
        dtype="float32",
        n_layers=2 * period + (1 if cfg.n_layers % period else 0),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        window=min(cfg.window, 32) if cfg.window else None,
    )
    if cfg.encoder_layers:
        updates["encoder_layers"] = 2
    if cfg.n_experts:
        updates.update(n_experts=8, n_experts_active=2, d_ff_expert=32)
    if cfg.d_inner:
        updates.update(d_inner=128)
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_head_dim=16)
    if cfg.mla:
        updates["mla"] = MLAConfig(d_latent=64, d_rope=16, d_nope=32, d_vhead=32)
        updates["head_dim"] = 48
    if cfg.vision_stub_tokens:
        updates["vision_stub_tokens"] = 16
    if cfg.family == "vlm":
        updates["mrope_sections"] = (2, 3, 3)  # sums to head_dim//2 = 8
    return dataclasses.replace(cfg, **updates)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"{name!r} is not ported yet; the port serves {sorted(REGISTRY)}"
        )
    cfg = REGISTRY[name]
    return smoke_config(cfg) if smoke else cfg


__all__ = [
    "ASSIGNED",
    "BONUS",
    "LM_SHAPES",
    "LONG_CONTEXT_ARCHS",
    "REGISTRY",
    "ModelConfig",
    "MLAConfig",
    "ShapeConfig",
    "get_config",
    "runnable_shapes",
    "smoke_config",
]
