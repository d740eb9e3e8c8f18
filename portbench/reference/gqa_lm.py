"""Reference decoder with grouped-query attention (query head ``i`` reads
key/value head ``i // (Hq / Hkv)``), rotary positions on the whole head
and a dense SwiGLU MLP in every layer: InternLM2 (arXiv:2403.17297) and the
other Llama-form stacks.

Weights keep the program's layouts: ``wq`` ``(d, Hq * Dh)``, ``wk`` /
``wv`` ``(d, Hkv * Dh)``, ``wo`` ``(Hq * Dh, d)``, heads contiguous in the
columns.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import common


def leaves(model: dict) -> list[common.Leaf]:
    common.check_plain(model, extra={"mla": None})
    d, hq, hkv, dh = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    dt = common.weight_dtype(model)
    out = common.tables(model)
    for l in range(model["n_layers"]):
        a = ("layers", l, "attn")
        out += [
            common.norm_leaf(("layers", l, "ln1", "scale"), d),
            common.dense_leaf(a + ("wq", "w"), d, hq * dh, dt),
            common.dense_leaf(a + ("wk", "w"), d, hkv * dh, dt),
            common.dense_leaf(a + ("wv", "w"), d, hkv * dh, dt),
            common.dense_leaf(a + ("wo", "w"), hq * dh, d, dt),
        ]
        out += common.mlp_leaves(l, model)
    return out


def layer(w: dict, x: torch.Tensor, pos: torch.Tensor, model: dict, ar,
          own_from: int | None = None) -> torch.Tensor:
    eps, theta = model["norm_eps"], model["rope_theta"]
    hq, hkv, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    s = x.shape[0]
    a = w["attn"]
    y = common.rmsnorm(w["ln1"]["scale"], x, eps)
    q = common.rope(ar.mm(y, a["wq"]["w"]).reshape(s, hq, dh), pos, theta)
    k = common.rope(ar.mm(y, a["wk"]["w"]).reshape(s, hkv, dh), pos, theta)
    v = ar.mm(y, a["wv"]["w"]).reshape(s, hkv, dh)
    group = hq // hkv
    k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    o = common.causal_attention(q, k, v, 1.0 / math.sqrt(dh), own_from=own_from)
    x = x + ar.mm(o.reshape(s, hq * dh), a["wo"]["w"])
    return x + common.mlp(w["mlp"], common.rmsnorm(w["ln2"]["scale"], x, eps), ar)


def logits(params, model, seqs, want, *, precision="fp32", drop_written=None):
    return common.decode_logits(params, model, seqs, want, layer, precision=precision,
                                drop_written=drop_written)
