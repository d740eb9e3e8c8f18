"""Roofline analysis from a counted step (counterpart of
``repro/roofline/analysis.py``).

Hardware model: one NVIDIA H100 SXM, as ``chip_smoke.py`` reads the card
("NVIDIA H100 80GB HBM3, 700.00 W"); the figures are NVIDIA's datasheet
peaks at the full 700 W limit, not measurements:
    peak bf16 dense compute   989 TFLOP/s (fp16 the same; fp32 without
                              TF32: 67 TFLOP/s, ``PEAK_FLOPS_BY_DTYPE``)
    HBM3 bandwidth            3.35 TB/s
    NVLink                    900 GB/s to the host's other cards, all to
                              all: 450 GB/s each way

Three terms, all in seconds per step per card (the counter's per-device
numbers, :mod:`repro_torch.launch.dryrun`):

    compute    = FLOPs / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective wire bytes / NVLINK_BW

The step's compute term takes every counted FLOP at the bf16 peak, as
the reference's takes its chip's.  A single kernel's least time
(:func:`kernel_bound`, ``chip_smoke.py``'s ``bound_ms``) takes its work at
the peak of its operands' dtype.

A ring collective sends and receives at once, so its wire bytes are taken
at one direction's rate.  Past one host's 8 cards the links are the
network, slower than NVLink; the term does not model that.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

PEAK_FLOPS = 989e12
PEAK_FLOPS_BY_DTYPE = {torch.bfloat16: PEAK_FLOPS, torch.float16: PEAK_FLOPS,
                       torch.float32: 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9


def kernel_bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """``(least ms, "bytes" | "operations")`` of a kernel launch that moves
    ``nbytes`` and does ``flops`` on ``dtype`` operands: the larger of the
    two times at the card's memory rate and that dtype's peak."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS_BY_DTYPE[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_per_device: float = 0.0
    cast_bytes_per_device: float = 0.0  # dtype casts, apart from the memory term

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        dominant-term bound: useful_model_flops / (bound_time * peak)."""
        if self.bound_time_s <= 0:
            return 0.0
        return self.model_flops_per_device / (self.bound_time_s * PEAK_FLOPS)

    def to_dict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "cast_bytes_per_device": self.cast_bytes_per_device,
            "dominant": self.dominant,
            "bound_time_s": self.bound_time_s,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_from_cost(cost, *, model_flops_total: float = 0.0,
                       n_chips: int = 256) -> RooflineTerms:
    """Three-term roofline of one card's counted :class:`~repro_torch
    .roofline.op_cost.Cost` (the counterpart of the reference's
    ``roofline_from_compiled``, whose HLO walk the counter replaces)."""
    return RooflineTerms(
        compute_s=cost.flops / PEAK_FLOPS,
        memory_s=cost.bytes / HBM_BW,
        collective_s=cost.coll_total / NVLINK_BW,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        coll_bytes_per_device=cost.coll_total,
        model_flops_per_device=model_flops_total / n_chips,
        cast_bytes_per_device=cost.cast_bytes,
    )


# ---------------------------------------------------------------------------
# Analytic "useful" FLOPs (MODEL_FLOPS) per (arch x shape)
# ---------------------------------------------------------------------------
def model_flops(cfg, shape) -> float:
    """6*N*D for training, 2*N_active*D + attention reads for inference."""
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    kinds = cfg.layer_kinds()
    n_attn_layers = sum(1 for k in kinds if k in ("global", "local"))

    def attn_flops_prefill(tokens_sq_sum):
        # 2 matmuls (QK^T, PV), causal halves the area; per attn layer.
        if cfg.mla is not None:
            width = cfg.mla.d_latent + cfg.mla.d_rope + cfg.mla.d_latent
            return n_attn_layers * cfg.n_heads * tokens_sq_sum * width
        return n_attn_layers * cfg.n_heads * tokens_sq_sum * 2 * cfg.head_dim

    if shape.kind == "train":
        tokens = b * s
        flops = 6.0 * n_active * tokens
        flops += 3 * attn_flops_prefill(b * s * s)  # fwd+bwd, causal ~ s^2/2 *2
        return flops
    if shape.kind == "prefill":
        tokens = b * s
        return 2.0 * n_active * tokens + attn_flops_prefill(b * s * s / 2 * 2)
    # decode: s_q new tokens against a cache of s keys
    tokens = b * shape.s_q
    flops = 2.0 * n_active * tokens
    if cfg.mla is not None:
        width = 2 * cfg.mla.d_latent + cfg.mla.d_rope
        flops += 2.0 * n_attn_layers * b * shape.s_q * cfg.n_heads * s * width
    else:
        flops += (
            2.0 * n_attn_layers * b * shape.s_q * cfg.n_heads * s * 2 * cfg.head_dim
        )
    return flops
