"""Public attention API (counterpart of ``repro/core/attention.py``).

Shapes follow the (batch, seq, heads, head_dim) convention:
    q: (B, Sq, Hq, Dh)      k/v: (B, Sk, Hkv, Dh[v])    with Hq % Hkv == 0.

``variant`` selects the paper's algorithm: "base" (Algorithm 1, fp32
multiply rescale) or "amla" (Algorithm 2, MUL-by-ADD rescale).  There is no
``impl`` switch: both entry points run the port's kernels through
:mod:`repro_torch.kernels.ops` — the CUDA kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors — which is the reference's
``impl="pallas"`` path.  :func:`_naive_attention` is the full-softmax fp32
oracle the tests hold them against.  The reference's blockwise ``"xla"``
scan (``core/flash.py``, ``core/amla.py``) is not ported.

MLA (the paper's native geometry) enters through :func:`mla_attention`,
where K and V are two views of a single latent cache (Dk = 576 = 512
latent + 64 rope, Dv = 512).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _naive_attention(q, k, v, *, scale, causal, window, softcap, kv_len, q_offset):
    """Full-softmax oracle (fp32); ``q_offset (B,)`` is the absolute
    position of ``q[:, 0]`` (0 when None)."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    dev = q.device
    qh = q.reshape(b, sq, hkv, group, dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(sk, device=dev)[None, None, None, None, :]
    base = (
        torch.as_tensor(q_offset, device=dev).reshape(b, 1)
        if q_offset is not None
        else torch.zeros((b, 1), dtype=torch.int64, device=dev)
    )
    qpos = (base + torch.arange(sq, device=dev)[None, :])[:, None, None, :, None]
    mask = torch.ones(s.shape, dtype=torch.bool, device=dev)
    if kv_len is not None:
        mask &= kpos < torch.as_tensor(kv_len, device=dev).reshape(b, 1, 1, 1, 1)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(b, sq, hq, v.shape[-1])


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    variant: str = "amla",
    causal: bool = False,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    kv_len=None,  # (B,) valid key count per example
    q_offset=None,  # (B,) absolute position of q[:, 0]
) -> torch.Tensor:
    """GQA/MQA/MHA attention.  Returns (B, Sq, Hq, Dh) in q.dtype."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = v.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if scale is None:
        scale = 1.0 / dh**0.5
    if q_offset is None:
        # Decode convention: queries are the last `sq` positions of the kv.
        base = (
            torch.as_tensor(kv_len, device=q.device) - sq
            if kv_len is not None
            else torch.full((b,), sk - sq, device=q.device)
        )
        q_offset = torch.clamp_min(base, 0).to(torch.int32)
    return ops.gqa_attention(
        q, k, v, variant=variant, causal=causal, window=window, softcap=softcap,
        scale=scale, kv_len=kv_len, q_offset=q_offset,
    )


def mla_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dk) absorbed queries (Dk = Dc + Dr = 576)
    c_kv: torch.Tensor,  # (B, Sk, Dk) shared latent cache (rope part included)
    *,
    d_v: int = 512,  # latent value width (Dv = Dc)
    variant: str = "amla",
    causal: bool = False,
    scale: float | None = None,
    kv_len=None,
    q_offset=None,
) -> torch.Tensor:
    """Multi-head Latent Attention (paper §2.2): K and V are views of one
    latent cache shared by all heads.  Returns (B, Sq, Hq, d_v) fp32."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    return ops.mla_decode(
        q, c_kv, d_v=d_v, variant=variant, scale=scale, kv_len=kv_len,
        causal=causal, q_offset=q_offset,
    )
