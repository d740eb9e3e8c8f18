"""Reference decoder with Multi-head Latent Attention (DeepSeek-V2,
arXiv:2405.04434 §2.1) and a dense SwiGLU MLP in every layer, written
from the equations in the paper's expanded form: each head's no-rope key
and its value are made from the shared latent ``c`` by ``W_UK`` and
``W_UV``, the rope key is one per token, shared by the heads.

Weights keep the program's layouts: ``wq_nope (d, h, n)``, ``wq_rope (d,
h, r)``, ``w_uk (h, n, c)``, ``w_uv (h, c, v)``, ``wkv_down`` / ``wk_rope``
/ ``wo`` dense ``(d_in, d_out)``.  The query is unfactored (the program's
configuration has no ``q_lora_rank``).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import common


def leaves(model: dict) -> list[common.Leaf]:
    common.check_plain(model)
    m = model["mla"]
    d, h, dt = model["d_model"], model["n_heads"], common.weight_dtype(model)
    n, r, c, v = m["d_nope"], m["d_rope"], m["d_latent"], m["d_vhead"]
    out = common.tables(model)
    for l in range(model["n_layers"]):
        a = ("layers", l, "attn")
        out += [
            common.norm_leaf(("layers", l, "ln1", "scale"), d),
            common.Leaf(a + ("wq_nope",), (d, h, n), dt, 1.0 / math.sqrt(d), True),
            common.Leaf(a + ("wq_rope",), (d, h, r), dt, 1.0 / math.sqrt(d), True),
            common.Leaf(a + ("w_uk",), (h, n, c), dt, 1.0 / math.sqrt(n), True),
            common.dense_leaf(a + ("wkv_down", "w"), d, c, dt),
            common.dense_leaf(a + ("wk_rope", "w"), d, r, dt),
            common.Leaf(a + ("w_uv",), (h, c, v), dt, 1.0 / math.sqrt(c), True),
            common.dense_leaf(a + ("wo", "w"), h * v, d, dt),
        ]
        out += common.mlp_leaves(l, model)
    return out


def layer(w: dict, x: torch.Tensor, pos: torch.Tensor, model: dict, ar,
          own_from: int | None = None) -> torch.Tensor:
    m, eps, theta = model["mla"], model["norm_eps"], model["rope_theta"]
    s, d = x.shape
    h = model["n_heads"]
    a = w["attn"]
    y = common.rmsnorm(w["ln1"]["scale"], x, eps)
    c = ar.mm(y, a["wkv_down"]["w"])  # (S, c)
    k_rope = common.rope(ar.mm(y, a["wk_rope"]["w"])[:, None, :], pos, theta)  # (S, 1, r)
    q_nope = ar.mm(y, a["wq_nope"].reshape(d, -1)).reshape(s, h, m["d_nope"])
    q_rope = common.rope(ar.mm(y, a["wq_rope"].reshape(d, -1)).reshape(s, h, m["d_rope"]),
                         pos, theta)
    # per head: k_nope = c W_UK^T, v = c W_UV (one product over all heads)
    k_nope = ar.mm(c, a["w_uk"].permute(2, 0, 1).reshape(m["d_latent"], -1)).reshape(s, h, -1)
    v = ar.mm(c, a["w_uv"].permute(1, 0, 2).reshape(m["d_latent"], -1)).reshape(s, h, -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(s, h, m["d_rope"])], dim=-1)
    o = common.causal_attention(q, k, v, 1.0 / math.sqrt(m["d_nope"] + m["d_rope"]),
                                 own_from=own_from)
    x = x + ar.mm(o.reshape(s, h * m["d_vhead"]), a["wo"]["w"])
    return x + common.mlp(w["mlp"], common.rmsnorm(w["ln2"]["scale"], x, eps), ar)


def logits(params, model, seqs, want, *, precision="fp32", drop_written=None):
    return common.decode_logits(params, model, seqs, want, layer, precision=precision,
                                drop_written=drop_written)
