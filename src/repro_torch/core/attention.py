"""Public attention API (counterpart of ``repro/core/attention.py``).

Shapes follow the (batch, seq, heads, head_dim) convention:
    q: (B, Sq, Hq, Dh)      k/v: (B, Sk, Hkv, Dh[v])    with Hq % Hkv == 0.

``variant`` selects the paper's algorithm: "base" (Algorithm 1, fp32
multiply rescale) or "amla" (Algorithm 2, MUL-by-ADD rescale).  There is no
``impl`` switch: both entry points run the port's kernels through
:mod:`repro_torch.kernels.ops` — the CUDA kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors — which is the reference's
``impl="pallas"`` path.  :func:`_naive_attention` is the full-softmax fp32
oracle the tests hold them against.

Training: the reference trains through its blockwise ``"xla"`` scan
(``core/flash.py``, ``core/amla.py``), whose autodiff is its gradient
(no Pallas kernel has a backward there).  :func:`blockwise_attention` is
that scan, ported (:mod:`repro_torch.core.flash`,
:mod:`repro_torch.core.amla`).  When an input needs a gradient, both entry
points run through :class:`_KernelForward`: the forward is the kernel, as
when serving, and the backward recomputes the blockwise path on the saved
inputs and returns autograd's gradient through it — the reference's
gradient, the AMLA cut at every KV block but the last included.  When no
input needs one, nothing is recorded.

MLA (the paper's native geometry) enters through :func:`mla_attention`,
where K and V are two views of a single latent cache (Dk = 576 = 512
latent + 64 rope, Dv = 512).
"""

from __future__ import annotations

import torch

from repro_torch.core.amla import flash_attention_amla
from repro_torch.core.flash import flash_attention_base
from repro_torch.kernels import ops

XLA_BLOCK = 512  # the reference's blockwise KV block


def _flash_fn(variant: str):
    if variant == "base":
        return flash_attention_base
    if variant == "amla":
        return flash_attention_amla
    raise ValueError(f"unknown attention variant: {variant}")


class _KernelForward(torch.autograd.Function):
    """``kernel(*tensors)`` forward; backward by autograd through
    ``blockwise(*tensors)`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, blockwise, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.blockwise = blockwise
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.blockwise(*inputs).to(grad.dtype)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return None, None, *(next(got) if t.requires_grad else None for t in inputs)


def _with_gradient(kernel, blockwise, *tensors):
    """``kernel(*tensors)``, through :class:`_KernelForward` when autograd
    would record it (an input needs a gradient), directly otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _KernelForward.apply(kernel, blockwise, *tensors)
    return kernel(*tensors)


def _kernel_width(d_k: int, d_v: int) -> int:
    """The least head width ``>= max(d_k, d_v)`` the GQA kernels take (a
    multiple of 8 up to 32, of 32 above)."""
    w = max(d_k, d_v)
    return -(-w // 8) * 8 if w <= 32 else -(-w // 32) * 32


def _decode_offset(q_offset, kv_len, b, sq, sk, device):
    """The decode convention: queries are the last ``sq`` positions of the
    keys, unless ``q_offset`` says otherwise."""
    if q_offset is not None:
        return q_offset
    base = (
        torch.as_tensor(kv_len, device=device) - sq
        if kv_len is not None
        else torch.full((b,), sk - sq, device=device)
    )
    return torch.clamp_min(base, 0).to(torch.int32)


def blockwise_attention(q, k, v, *, variant="amla", causal=False, window=None,
                        softcap=None, scale=None, kv_len=None, q_offset=None,
                        block_size=XLA_BLOCK):
    """The reference's ``impl="xla"`` path: the query positions of a KV
    head group folded into ``Sq * group`` rows per (batch, KV head), one
    blockwise scan over each (batched here where the reference ``vmap``s).
    Returns (B, Sq, Hq, Dv) in ``q.dtype``."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, dv = v.shape
    group = hq // hkv
    dev = q.device
    if scale is None:
        scale = 1.0 / dh**0.5
    q_offset = _decode_offset(q_offset, kv_len, b, sq, sk, dev)
    qr = q.reshape(b, sq, hkv, group, dh).permute(0, 2, 1, 3, 4).reshape(b, hkv, sq * group, dh)
    off = torch.as_tensor(q_offset, device=dev).to(torch.int32).reshape(b)
    q_pos = (off[:, None] + torch.arange(sq, dtype=torch.int32, device=dev)[None, :])
    q_pos = torch.repeat_interleave(q_pos, group, dim=1)[:, None, :]  # (B, 1, rows)
    lens = (torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(b)
            if kv_len is not None else torch.full((b,), sk, dtype=torch.int32, device=dev))
    out = _flash_fn(variant)(
        qr, k.transpose(1, 2), v.transpose(1, 2), scale=scale,
        block_size=min(block_size, sk), q_pos=q_pos, kv_len=lens[:, None], causal=causal,
        window=window, softcap=softcap,
    )  # (B, Hkv, Sq*group, Dv)
    out = out.reshape(b, hkv, sq, group, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, sq, hq, dv).to(q.dtype)


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
    """GQA/MQA/MHA attention through ``ops.gqa_attention`` (K6 for Sq <= 8,
    K7 above).  Returns (B, Sq, Hq, Dv) in q.dtype; differentiable
    (backward through :func:`blockwise_attention`).

    Where Dk and Dv differ (MLA's expanded training form) or the width is
    one the kernels do not take, q, k and v get zero columns up to
    :func:`_kernel_width`: zero columns of q and k add exact zeros to every
    score, zero columns of v give zero output columns, which are sliced
    off; the scale is passed, so the padding changes no number."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, dv = v.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if scale is None:
        scale = 1.0 / dh**0.5
    q_offset = _decode_offset(q_offset, kv_len, b, sq, sk, q.device)
    opts = dict(variant=variant, causal=causal, window=window, softcap=softcap, scale=scale,
                kv_len=kv_len, q_offset=q_offset)
    width = _kernel_width(dh, dv)

    def kernel(q, k, v):
        if width == dh == dv:
            return ops.gqa_attention(q, k, v, **opts)
        pad = lambda t: torch.nn.functional.pad(t, (0, width - t.shape[-1]))
        return ops.gqa_attention(pad(q), pad(k), pad(v), **opts)[..., :dv]

    return _with_gradient(kernel, lambda q, k, v: blockwise_attention(q, k, v, **opts), q, k, v)


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
    latent cache shared by all heads, through the contiguous MLA decode
    (K4).  Returns (B, Sq, Hq, d_v) fp32; differentiable (backward through
    :func:`blockwise_attention` over the latent rows as K and V, the
    reference's ``impl="xla"`` form)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    opts = dict(variant=variant, causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset)

    def kernel(q, c_kv):
        return ops.mla_decode(q, c_kv, d_v=d_v, **opts)

    def blockwise(q, c_kv):
        return blockwise_attention(q, c_kv[:, :, None, :], c_kv[:, :, None, :d_v], **opts)

    return _with_gradient(kernel, blockwise, q, c_kv)
