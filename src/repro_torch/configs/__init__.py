"""Architecture registry: full configs + reduced smoke configs.

Copied from ``repro.configs``; only the architectures the port serves are
registered: ``deepseek-v2-mla`` (paged and dense) and the dense-served GQA
stacks ``gemma2-2b``, ``qwen2.5-3b`` and ``qwen1.5-0.5b``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import deepseek_v2_mla, gemma2_2b, qwen1_5_0_5b, qwen2_5_3b
from repro_torch.configs.base import MLAConfig, ModelConfig

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        gemma2_2b.CONFIG,
        qwen1_5_0_5b.CONFIG,
        qwen2_5_3b.CONFIG,
        deepseek_v2_mla.CONFIG,
    ]
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, narrow
    widths, tiny vocab — preserving every structural feature."""
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
    if cfg.mla:
        updates["mla"] = MLAConfig(d_latent=64, d_rope=16, d_nope=32, d_vhead=32)
        updates["head_dim"] = 48
    return dataclasses.replace(cfg, **updates)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"{name!r} is not ported yet; the port serves {sorted(REGISTRY)}"
        )
    cfg = REGISTRY[name]
    return smoke_config(cfg) if smoke else cfg


__all__ = ["REGISTRY", "ModelConfig", "MLAConfig", "get_config", "smoke_config"]
