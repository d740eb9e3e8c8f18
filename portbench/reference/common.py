"""Plain PyTorch pieces of the reference decoders: fp32 arithmetic with
TF32 off, no kernel, no cache, no batching of requests.

Nothing here imports the program.  The reference reads the weights the
benchmark drew (bf16 on the card) and widens one layer at a time, so a
60-layer model in fp32 never has to fit beside the bf16 one.

``precision="fp8"`` is the control: every product with a weight takes its
two operands rounded to float8 e4m3, the activation by row and the weight
by output column, each with its own scale (the form an fp8 serving path
would take); attention and the norms stay fp32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight of the tree: its path, shape, storage dtype, the standard
    deviation it is drawn with, and whether a token's forward pass
    multiplies by it (what model FLOPs count)."""

    path: tuple
    shape: tuple
    dtype: torch.dtype
    std: float
    matmul: bool


def weight_dtype(model: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[model["dtype"]]


def norm_leaf(path, dim) -> Leaf:
    # (1 + scale) RMSNorm gains drawn near 1, so the norms are exercised
    return Leaf(path, (dim,), torch.float32, 0.1, False)


def dense_leaf(path, d_in, d_out, dtype, std=None) -> Leaf:
    return Leaf(path, (d_in, d_out), dtype, std or 1.0 / math.sqrt(d_in), True)


def tables(model: dict) -> list[Leaf]:
    """Embedding (std 1) and untied unembedding (std 1/sqrt(d): logits of
    order one) tables and the final norm."""
    d, v, dt = model["d_model"], model["vocab_size"], weight_dtype(model)
    if model.get("tie_embeddings", True):
        raise ValueError("the reference decoders take untied tables")
    return [
        Leaf(("embed", "table"), (v, d), dt, 1.0, False),
        Leaf(("unembed", "table"), (v, d), dt, 1.0 / math.sqrt(d), True),
        norm_leaf(("final_norm", "scale"), d),
    ]


def mlp_leaves(l, model) -> list[Leaf]:
    d, ff, dt = model["d_model"], model["d_ff"], weight_dtype(model)
    return [
        norm_leaf(("layers", l, "ln2", "scale"), d),
        dense_leaf(("layers", l, "mlp", "gate", "w"), d, ff, dt),
        dense_leaf(("layers", l, "mlp", "up", "w"), d, ff, dt),
        dense_leaf(("layers", l, "mlp", "down", "w"), ff, d, dt),
    ]


def check_plain(model: dict, extra=()) -> None:
    """The options these decoders implement; any other raises, so a
    configuration the reference does not cover is never compared."""
    unsupported = {
        "qkv_bias": False, "qk_norm": False, "attn_softcap": None, "final_softcap": None,
        "post_norms": False, "embed_scale": False, "n_experts": 0, "window": None,
        "act": "silu", "attn_scale": None, **dict(extra),
    }
    for key, plain in unsupported.items():
        if model.get(key, plain) != plain:
            raise ValueError(f"the reference does not implement {key}={model[key]!r}")
    if tuple(model.get("layer_pattern", ("global",))) != ("global",):
        raise ValueError("the reference implements all-global attention stacks only")


# -- arithmetic -------------------------------------------------------------- #
def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), returned widened to fp32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Arith:
    """Products with weights at the reference's precision."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: 'fp32' or 'fp8'")
        self.precision = precision

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (..., k) @ w (k, n)`` in fp32."""
        x = x.to(torch.float32)
        w = w.to(torch.float32)
        if self.precision == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return torch.matmul(x, w)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the two halves of the last dim (GPT-NeoX form).
    x: (S, H, D), positions: (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float, block: int = 512,
                     own_from: int | None = None) -> torch.Tensor:
    """Softmax attention of every position over itself and the positions
    before it.  q: (S, H, Dk); k: (S, H, Dk); v: (S, H, Dv) (each head its
    own keys); fp32, blocks of ``block`` query rows.  With ``own_from``,
    a key at that position or later is seen by its own query alone (a
    planted fault: the rows a decode wrote are dropped)."""
    s = q.shape[0]
    qh, kh, vh = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
    out = torch.empty((q.shape[1], s, v.shape[-1]), dtype=torch.float32, device=q.device)
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(a + block, s)
        scores = torch.matmul(qh[:, a:b], kh[:, :b].transpose(1, 2)) * scale
        rows = torch.arange(a, b, device=q.device)[:, None]
        mask = keys[None, :b] > rows
        if own_from is not None:
            mask |= (keys[None, :b] >= own_from) & (keys[None, :b] != rows)
        scores.masked_fill_(mask, float("-inf"))
        out[:, a:b] = torch.matmul(torch.softmax(scores, dim=-1), vh[:, :b])
    return out.transpose(0, 1)


def mlp(w: dict, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    g = torch.nn.functional.silu(ar.mm(x, w["gate"]["w"]))
    return ar.mm(g * ar.mm(x, w["up"]["w"]), w["down"]["w"])


def layer_at(params: dict, l: int) -> dict:
    """Layer ``l``'s weights widened to fp32 (one layer on the device at a
    time)."""
    def widen(t):
        if isinstance(t, dict):
            return {k: widen(v) for k, v in t.items()}
        return t.to(torch.float32)
    return widen(params["layers"][l])


def decode_logits(params, model, seqs, want, layer_fn, *, precision="fp32", drop_written=None):
    """fp32 logits of each sequence at the positions in ``want``: the whole
    sequence runs through every layer (causal attention), layer by layer
    over all sequences, then the final norm and the unembedding at those
    positions.  seqs: token tensors (S_i,); want: index tensors;
    ``drop_written``: each sequence's prompt length, past which the rows
    are dropped (``causal_attention``'s ``own_from``)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ar = Arith(precision)
        table = params["embed"]["table"]
        xs = [table[s].to(torch.float32) for s in seqs]
        pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
        drops = drop_written or [None] * len(seqs)
        for l in range(model["n_layers"]):
            w = layer_at(params, l)
            xs = [layer_fn(w, x, p, model, ar, own) for x, p, own in zip(xs, pos, drops)]
            del w
        out = []
        for x, idx in zip(xs, want):
            h = rmsnorm(params["final_norm"]["scale"], x[idx], model["norm_eps"])
            out.append(ar.mm(h, params["unembed"]["table"].T))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
