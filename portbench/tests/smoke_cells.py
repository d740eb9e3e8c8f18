"""Cells of the two configurations' forms at smoke widths, for runs of the
whole harness on the CPU (the plain versions of the program's kernels)."""

from portbench.core import spec

MLA = dict(family="mla", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=48, d_ff=128,
           vocab_size=512, mla=dict(d_latent=64, d_rope=16, d_nope=32, d_vhead=32),
           attn_scale=None, rope_theta=10000.0, norm_eps=1e-6, act="silu",
           tie_embeddings=False, attn_variant="amla")
GQA = dict(family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
           d_ff=128, vocab_size=512, attn_scale=None, rope_theta=1e6, norm_eps=1e-6,
           act="silu", tie_embeddings=False, attn_variant="amla")
# bf16 smoke runs read widest gaps of about 1e-3 of a logit, the fp8 control
# 5e-2 and more: a limit between them
LIMIT = 1e-2


def cell(form: str, dtype: str = "bfloat16", limit: float = LIMIT) -> spec.Cell:
    if form == "mla":
        config = dict(name="smoke-mla", reference="mla_lm", model=dict(MLA, dtype=dtype))
        session = dict(kind="paged", page_size=16, num_splits=2, prefill_chunk=16)
    else:
        config = dict(name="smoke-gqa", reference="gqa_lm", model=dict(GQA, dtype=dtype))
        session = dict(kind="dense", batch=4, max_len=1024)
    traffic = dict(kind="closed_batch", sequences=3,
                   prompt_len=dict(dist="uniform", lo=20, hi=60))
    workload = dict(session=session, warm_steps=2, trace_steps=2, step_floor_ms=1.0,
                    check=dict(requests=2, max_gap=limit))
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    return spec.Cell(name="smoke", config=config, traffic=traffic, workload=workload, chips=1,
                     end_to_end=bench["end_to_end"], per_layer=[])
