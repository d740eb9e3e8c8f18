"""Config dataclasses (copied from ``repro.configs.base``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_latent: int = 512  # compressed KV width (cached)
    d_rope: int = 64  # shared rotary key width (cached)
    d_nope: int = 128  # per-head no-rope query/key width (absorbed)
    d_vhead: int = 128  # per-head value width after un-absorption


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | hybrid | ssm | moe | encdec | vlm | mla
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    rope_theta: float = 10000.0
    layer_pattern: tuple = ("global",)  # cycled over layers
    window: Optional[int] = None  # sliding window for "local" layers
    mrope_sections: tuple = (16, 24, 24)

    # paper technique plumbing
    attn_variant: str = "amla"  # "base" | "amla"
    attn_impl: str = "xla"

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # recurrent / ssm
    d_inner: int = 0
    ssm_state: int = 0
    conv_width: int = 4
    ssm_head_dim: int = 64

    # MLA
    mla: Optional[MLAConfig] = None
    mla_absorbed_train: bool = False

    # encoder-decoder
    encoder_layers: int = 0

    # vlm
    vision_stub_tokens: int = 0

    decode_unroll: bool = False
    cache_layout: str = "bshd"

    act: str = "silu"
    norm_eps: float = 1e-6
    post_norms: bool = False  # gemma2 sandwich norms
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer kind list (pattern cycled to n_layers)."""
        pat = list(self.layer_pattern)
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula, for the kinds
        the port serves (GQA or MLA attention + dense MLP); raises for the
        others."""
        d, v = self.d_model, self.vocab_size
        n = v * d if self.tie_embeddings else 2 * v * d
        for kind in self.layer_kinds():
            if kind not in ("global", "local") or self.n_experts:
                raise NotImplementedError(
                    f"param_count covers dense attention stacks; {self.name!r} "
                    f"has a {kind!r} layer"
                )
            if self.mla is not None:
                m = self.mla
                n += d * self.n_heads * (m.d_nope + m.d_rope)
                n += self.n_heads * m.d_nope * m.d_latent
                n += d * (m.d_latent + m.d_rope)
                n += self.n_heads * m.d_latent * m.d_vhead
                n += self.n_heads * m.d_vhead * d
            else:
                hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
                n += d * (hq + 2 * hkv) * dh + hq * dh * d
            n += 3 * d * self.d_ff
            n += 2 * d  # norms
        return int(n)
