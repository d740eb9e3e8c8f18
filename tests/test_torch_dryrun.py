"""The port's dry run and hill climb (repro_torch.launch.dryrun,
repro_torch.launch.hillclimb), counterparts of the reference's
``repro.launch.dryrun`` / ``hillclimb`` (``test_loss_and_dryrun.py:60``):
the input stand-ins, the spec-derived collective model against closed
forms on a 2 x 2 mesh, one smoke-width cell per family, the CLI at full
width, and the hill climb's policies."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import LM_SHAPES, get_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import logical_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.roofline.op_cost import OpCounter
from repro_torch.runtime.train_loop import TrainConfig, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,shape_name,want", [
    ("qwen1.5-0.5b", "train_4k", {"tokens": (256, 4096), "labels": (256, 4096)}),
    ("seamless-m4t-medium", "train_4k", {"src_embeds": (256, 2048, 1024), "src_len": (256,),
                                          "tokens": (256, 2048), "labels": (256, 2048)}),
    ("qwen2-vl-7b", "prefill_32k", {"tokens": (32, 32768), "vision_embeds": (32, 256, 3584)}),
    ("mamba2-370m", "long_500k", {"tokens": (1, 1), "cache_len": ()}),
])
def test_input_specs_shapes_and_dtypes(arch, shape_name, want):
    specs = dryrun.input_specs(arch, shape_name)
    assert {k: tuple(v.shape) for k, v in specs.items()} == want
    for k, v in specs.items():
        assert v.is_meta
        assert v.dtype == (torch.bfloat16 if "embeds" in k else torch.int32)


def _tree():
    """A table, a weight and a bias, fp32 (131072, 16384, 256 bytes)."""
    m = lambda *s: torch.empty(s, device="meta")
    return {"embed": {"table": m(512, 64)},
            "layers": [{"attn": {"wq": {"w": m(64, 64), "b": m(64)}}}]}


def _coll(policy, kind="train", microbatches=3, remat=True, tokens=10):
    cfg = get_config("qwen1.5-0.5b", smoke=True)  # 2 layers: 4 sublayers
    mesh = logical_mesh({"data": 2, "model": 2}, device="cpu")
    c = dryrun.collective_cost(cfg, _tree(), mesh, multi_pod=False, policy=policy, kind=kind,
                               tokens=tokens, microbatches=microbatches, remat=remat)
    return c.coll, c.coll_counts


def test_collectives_tp_fsdp_closed_form():
    # table (model, data), w (data, model): gathered over data to their
    # model shards before each of 3 x (1 + remat) forwards, gradients
    # reduce-scattered; the bias replicated: gradient all-reduced over
    # data; 4 sublayers x 3 x 3 passes of 10 tokens x 64 bf16 all-reduced
    coll, counts = _coll("tp_fsdp")
    assert coll == {
        "all-gather": (65536 + 8192) * 6,
        "reduce-scatter": 65536 + 8192,
        "all-reduce": 2 * 256 + 4 * 9 * 2 * 10 * 64 * 2,
    }
    assert counts == {"all-gather": 12, "reduce-scatter": 2, "all-reduce": 1 + 36}


def test_collectives_fsdp_has_no_activation_all_reduce():
    # no TP: the table stays replicated (vocab and width do not split 2 x
    # 10^9), w gathered over data; "model" carries data parallelism
    coll, _ = _coll("fsdp")
    assert coll == {
        "all-gather": 16384 * 6,
        "reduce-scatter": 16384,
        "all-reduce": 2 * 131072 + 2 * 16384 // 2 + 2 * 256,
    }


def test_collectives_fsdp2d_and_dp():
    coll, _ = _coll("fsdp2d")  # every leaf over (data, model): gathered whole
    full = 131072 + 16384 + 256
    assert coll == {"all-gather": full * 6, "reduce-scatter": full}
    coll, _ = _coll("dp")  # nothing gathered: every gradient all-reduced
    assert coll == {"all-reduce": 2 * full}


def test_collectives_serving_gathers_once():
    coll, counts = _coll("tp_fsdp", kind="decode", tokens=8)
    assert coll == {"all-gather": 65536 + 8192, "all-reduce": 4 * 2 * 8 * 64 * 2}
    assert counts == {"all-gather": 2, "all-reduce": 4}


@pytest.mark.parametrize("arch,widths", [
    # (n_heads, n_kv_heads, d_ff, d_ff_expert, d_inner, vocab) on one of 16 cards
    ("qwen1.5-0.5b", (1, 1, 176, 0, 0, 9496)),
    ("internlm2-20b", (3, 1, 1024, 0, 0, 5784)),  # 8 KV heads < 16: one replicated
    ("qwen3-moe-30b-a3b", (2, 1, 0, 48, 0, 9496)),
    ("deepseek-v2-mla", (8, 1, 768, 0, 0, 6400)),
    # d_inner whole: the blocks take their share through card_share (2 of
    # 32 SSM heads of 64; 160 RG-LRU channels); vocab rounded up
    ("mamba2-370m", (1, 1, 0, 0, 2048, 3143)),
    ("recurrentgemma-2b", (1, 1, 480, 0, 2560, 16000)),
])
def test_local_config_is_one_tensor_parallel_cards_widths(arch, widths):
    cfg = get_config(arch)
    local = dryrun.local_config(cfg, 16)
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.d_ff_expert, local.d_inner,
            local.vocab_size) == widths
    assert local.d_model == cfg.d_model and local.head_dim == cfg.head_dim
    assert dryrun.local_config(cfg, 1) is cfg
    plan = dryrun.card_share(cfg, build_model(cfg).init(None, "meta"),
                             dryrun.make_production_mesh(multi_pod=False, device="cpu"), "tp_fsdp")
    kinds = set(cfg.layer_kinds())
    assert (plan is not None) == bool(kinds & {"ssm", "recurrent"})
    if plan is not None:  # a card's heads / channels of the split blocks
        assert (plan.ssm, plan.rec) == ("ssm" in kinds, "recurrent" in kinds)
        nh = cfg.d_inner // cfg.ssm_head_dim
        assert plan.part(nh if plan.ssm else cfg.d_inner) == (0, 2 if plan.ssm else 160)


def _step_bytes(cfg, m):
    """(all bytes, the products' bytes) of one smoke train step at the
    widths one of ``m`` tensor-parallel cards runs."""
    model = build_model(dryrun.local_config(cfg, m))
    params = model.init(None, "meta", dtype=torch.float32)
    batch = {k: dryrun.meta((2, 64), torch.int32) for k in ("tokens", "labels")}
    with OpCounter() as c:
        make_train_step(model, TrainConfig(remat=False, n_loss_chunks=4))(
            params, adamw_init(params), None, batch, 0)
    return c.cost.bytes, c.products.bytes


def test_tensor_parallel_non_product_bytes_fall_with_the_model_axis():
    """One card's count splits per-head and d_ff work (softmax, attention's
    backward, silu(g) * u, the loss over its vocabulary shard), not only the
    products: the bytes of the ops that are not products fall with the
    model axis, and those of the d_model-wide norms and residuals, counted
    whole, keep them above 1 / m of the unsplit step's."""
    cfg = get_config("qwen1.5-0.5b", smoke=True)  # 4 heads, d_ff 128
    rest = {}
    for m in (1, 2, 4):
        total, products = _step_bytes(cfg, m)
        rest[m] = total - products
    assert rest[1] > rest[2] > rest[4] > rest[1] / 4
    mesh = lambda m: logical_mesh({"data": 2, "model": m}, device="cpu")
    counts = [dryrun.count_decode("qwen1.5-0.5b", "decode_32k", mesh(m), False, smoke=True)
              for m in (1, 4)]
    assert counts[1].cost.bytes < counts[0].cost.bytes
    assert counts[1].cost.flops < counts[0].cost.flops


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen1.5-0.5b", "train_4k"),  # dense
    ("deepseek-v2-mla", "decode_32k"),  # mla
    ("granite-moe-3b-a800m", "prefill_32k"),  # moe
    ("mamba2-370m", "long_500k"),  # ssm
    ("recurrentgemma-2b", "decode_32k"),  # hybrid
    ("qwen2-vl-7b", "prefill_32k"),  # vlm
    ("seamless-m4t-medium", "train_4k"),  # encdec
])
def test_run_cell_smoke_per_family(arch, shape_name, tmp_path):
    rec = dryrun.run_cell(arch, shape_name, False, str(tmp_path), smoke=True)
    for k in ("arch", "shape", "kind", "mesh", "n_chips", "memory", "model_flops_total",
              "roofline", "collectives", "count_s"):
        assert k in rec
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["bound_time_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
    assert rec["memory"]["argument_size_in_bytes"] > 0
    kind = LM_SHAPES[shape_name].kind
    if kind != "train":
        assert rec["memory"]["alias_size_in_bytes"] > 0  # the cache, written in place
    assert rec["collectives"]["bytes"]["all-gather"] > 0
    saved = json.loads((tmp_path / f"{arch}__{shape_name}__16x16.json").read_text())
    assert saved["roofline"] == r


def test_run_cell_charges_the_kernels_on_the_path():
    rec = dryrun.run_cell("gemma2-2b", "decode_32k", False, None, smoke=True)
    # K6 takes bf16 rows (ops.gqa_attention casts), split by the H100 rule
    # on meta and merged by K3
    assert set(rec["kernel_charges"]) == {"gqa_decode_rows", "combine_split_partials"}
    rec = dryrun.run_cell("qwen1.5-0.5b", "prefill_32k", True, None, smoke=True)
    assert set(rec["kernel_charges"]) == {"flash_prefill"}
    assert rec["mesh"] == "2x16x16" and rec["n_chips"] == 512


def test_dryrun_cli_full_width_cell(tmp_path):
    """The counterpart of the reference's CLI cell (qwen1.5-0.5b decode_32k
    on the single-pod mesh), at full width: meta stand-ins, no card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--archs", "qwen1.5-0.5b",
         "--shapes", "decode_32k", "--meshes", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-800:]
    assert "[OK]" in r.stdout and "dry-run complete: 1 ok, 0 failed, 0 skipped" in r.stdout
    rec = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__16x16.json").read_text())
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_dryrun_cli_skips_documented_inapplicability(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--archs", "qwen1.5-0.5b", "--shapes", "long_500k", "--meshes", "single",
                     "--out", str(tmp_path)])
    assert "[SKIP] qwen1.5-0.5b long_500k" in out.getvalue()
    assert "dry-run complete: 0 ok, 0 failed, 1 skipped" in out.getvalue()


def test_hillclimb_policies_move_the_collective_term(tmp_path):
    rows = {}
    for policy in ("tp_fsdp", "fsdp", "fsdp2d", "dp"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            hillclimb.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                            "--policy", policy, "--tag", policy,
                            "--out", str(tmp_path / "hc.jsonl")])
        lines = out.getvalue().splitlines()
        assert lines[0].startswith("tag,policy,accum,remat,chunks,compute_s,memory_s,")
        rows[policy] = lines[1].split(",")
        assert rows[policy][:2] == [policy, policy]
    assert len({r[7] for r in rows.values()}) == 4  # collective_s differs
    recs = [json.loads(x) for x in (tmp_path / "hc.jsonl").read_text().splitlines()]
    assert [r["policy"] for r in recs] == ["tp_fsdp", "fsdp", "fsdp2d", "dp"]
