"""The yardstick's peaks and its count of attention work, from shapes.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet (dense bf16 989 TFLOP/s,
HBM3 3.35 TB/s), at its full 700 W.

An attention call is counted once for the whole operation (the decode
kernel and the combine of its splits together), so a change that fuses,
splits or reorders the kernels reads the same work:

* bytes: the queries once (bf16), every live cache row once (its storage
  width and dtype), the final output once (fp32, as the op returns it);
* FLOPs: per (query row, key it attends) ``2 (Dk + Dv) H`` for MLA over
  the latent rows (``Dk`` = latent + rope, ``Dv`` = latent) and ``4 Dh Hq``
  for GQA.

The bound of a call is the larger of bytes / bandwidth and FLOPs / peak.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 dense
HBM_BYTES_PER_S = 3.35e12
Q_BYTES, OUT_BYTES = 2, 4
ROW_BYTES = {"bfloat16": 2, "float32": 4}


def pairs(kv_len: int, q_rows: int = 1) -> int:
    """(query row, key) pairs of ``q_rows`` causal rows ending a sequence
    of ``kv_len`` keys."""
    return sum(kv_len - q_rows + j + 1 for j in range(q_rows))


def attention_call(kv_lens, model: dict, q_rows: int = 1) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's attention over requests with
    ``kv_lens`` keys each (after this step's rows are written), ``q_rows``
    query rows a request."""
    b = len(kv_lens)
    rows = sum(kv_lens)
    n_pairs = sum(pairs(k, q_rows) for k in kv_lens)
    elt = ROW_BYTES[model["dtype"]]
    if model.get("mla"):
        m, h = model["mla"], model["n_heads"]
        dk, dv = m["d_latent"] + m["d_rope"], m["d_latent"]
        flops = 2.0 * (dk + dv) * h * n_pairs
        nbytes = b * q_rows * h * (dk * Q_BYTES + dv * OUT_BYTES) + rows * dk * elt
    else:
        hq, hkv, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
        flops = 4.0 * dh * hq * n_pairs
        nbytes = b * q_rows * hq * dh * (Q_BYTES + OUT_BYTES) + rows * 2 * hkv * dh * elt
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def step_flops(kv_lens, model: dict, matmul_params: int, q_rows: int = 1) -> float:
    """Model FLOPs of one forward step: 2 x the weights each token
    multiplies by, plus every layer's attention."""
    flops, _ = attention_call(kv_lens, model, q_rows)
    return 2.0 * matmul_params * len(kv_lens) * q_rows + model["n_layers"] * flops
