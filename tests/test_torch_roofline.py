"""The port's roofline tooling (repro_torch.configs' shape grid,
repro_torch.roofline) against the JAX reference (repro.configs,
repro.roofline): the shape grid, the registry lists, ``active_param_count``
and ``model_flops`` equal; ``RooflineTerms`` reads the same; the dtype
table matches; the dispatcher counter's trip counts are exact (the
counterpart of ``test_hlo_cost.py``) and its count of a train step sits
near the reference walker's; the meta count of a step equals a CPU count
of it; every kernel wrapper's meta branch returns the plain version's
shapes and dtypes and charges its bound formula."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_cost as ref_hlo
from repro_torch import configs as port_configs
from repro_torch.kernels import flash_prefill as k7
from repro_torch.kernels import gqa_decode as k6
from repro_torch.kernels import mla_decode as k4
from repro_torch.kernels import mla_decode_combine as k3
from repro_torch.kernels import ops
from repro_torch.roofline import analysis, op_cost
from repro_torch.roofline.op_cost import OpCounter

ARCHS = sorted(ref_configs.REGISTRY)


def test_shape_grid_and_registry_lists_equal():
    assert port_configs.ASSIGNED == ref_configs.ASSIGNED
    assert port_configs.BONUS == ref_configs.BONUS
    assert port_configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS
    assert list(port_configs.LM_SHAPES) == list(ref_configs.LM_SHAPES)
    for name, shape in ref_configs.LM_SHAPES.items():
        assert dataclasses.astuple(port_configs.LM_SHAPES[name]) == dataclasses.astuple(shape)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_equal(arch, smoke):
    ref_cfg = ref_configs.get_config(arch, smoke=smoke)
    cfg = port_configs.get_config(arch, smoke=smoke)
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert port_configs.runnable_shapes(cfg) == ref_configs.runnable_shapes(ref_cfg)
    for name in ref_configs.runnable_shapes(ref_cfg):
        got = analysis.model_flops(cfg, port_configs.LM_SHAPES[name])
        want = ref_analysis.model_flops(ref_cfg, ref_configs.LM_SHAPES[name])
        assert got == want, (name, got, want)


@pytest.mark.parametrize("terms", [
    (1e-3, 2e-3, 5e-4, 1e12, 2e9, 1e8, 3e11, 1e6),
    (5e-3, 1e-4, 9e-3, 4e12, 1e8, 4e9, 1e12, 0.0),
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
])
def test_roofline_terms_read_the_same(terms):
    got = analysis.RooflineTerms(*terms)
    want = ref_analysis.RooflineTerms(*terms)
    assert list(got.to_dict()) == list(want.to_dict())
    assert got.dominant == want.dominant
    assert got.bound_time_s == want.bound_time_s
    assert got.useful_ratio == want.useful_ratio


def test_h100_peaks():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    c = op_cost.Cost(flops=989e9, bytes=3.35e9, coll={"all-reduce": 450e6})
    t = analysis.roofline_from_cost(c, model_flops_total=2 * 989e9, n_chips=2)
    assert t.compute_s == pytest.approx(1e-3) and t.memory_s == pytest.approx(1e-3)
    assert t.collective_s == pytest.approx(1e-3) and t.useful_ratio == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(op_cost.HLO_DTYPES))
def test_shape_bytes_table_matches(name):
    dt = op_cost.HLO_DTYPES[name]
    assert op_cost.shape_bytes((2, 3), dt) == ref_hlo.shape_bytes(f"{name}[2,3]")
    assert op_cost.shape_bytes((), dt) == ref_hlo.shape_bytes(f"{name}[]")
    assert op_cost.tensor_bytes(torch.empty((5, 7), dtype=dt, device="meta")) == \
        ref_hlo.shape_bytes(f"{name}[5,7]")


def test_loop_of_products_counted_per_trip():
    """8 products (64 x 512 @ 512 x 512) in a Python loop: exactly
    8 * 2 * 64 * 512^2 flops (the reference needs its trip-count parser)."""
    w = torch.empty(8, 512, 512, device="meta")
    x = torch.empty(64, 512, device="meta")
    with OpCounter() as c:
        for i in range(8):
            x = torch.tanh(x @ w[i])
    assert c.products.flops == 8 * 2 * 64 * 512 * 512
    assert c.cost.flops == 8 * (2 * 64 * 512 * 512 + 8 * 64 * 512)
    assert c.cost.transcendentals == 8 * 64 * 512


def test_nested_loops_counted_exactly():
    w = torch.empty(5, 128, 128, device="meta")
    x = torch.empty(16, 128, device="meta")
    with OpCounter() as c:
        for i in range(5):
            for _ in range(3):
                x = x @ w[i]
    assert c.cost.flops == 5 * 3 * 2 * 16 * 128 * 128


def test_unrolled_products_match_reference_walker():
    def f_jax(w, x):
        c = x
        for i in range(4):
            c = c @ w[i]
        return c.sum()

    compiled = jax.jit(f_jax).lower(
        jax.ShapeDtypeStruct((4, 256, 256), jnp.float32),
        jax.ShapeDtypeStruct((32, 256), jnp.float32)).compile()
    want = ref_hlo.cost_from_compiled(compiled).flops
    w = torch.empty(4, 256, 256, device="meta")
    x = torch.empty(32, 256, device="meta")
    with OpCounter() as c:
        for i in range(4):
            x = x @ w[i]
        x.sum()
    assert c.cost.flops == pytest.approx(want, rel=0.05)


def test_rules_per_op_class():
    a = torch.empty(4, 8, device="meta")
    with OpCounter() as c:
        a.to(torch.bfloat16)  # cast: 2 x result bytes, apart
    assert (c.cost.cast_bytes, c.cost.bytes, c.cost.flops) == (2 * 4 * 8 * 2, 0, 0)
    with OpCounter() as c:
        a.t(), a.view(32), a.unsqueeze(0)  # views and metadata
    assert (c.cost.flops, c.cost.bytes, c.n_ops) == (0, 0, 3)
    with OpCounter() as c:
        a.sum(dim=1)  # reduction: 2 per result element, operand + result bytes
    assert (c.cost.flops, c.cost.bytes) == (2 * 4, 4 * 8 * 4 + 4 * 4)
    with OpCounter() as c:
        a + a  # arithmetic: 1 per element
    assert (c.cost.flops, c.cost.bytes) == (32, 3 * 32 * 4)
    with OpCounter() as c:
        torch.exp(a)
    assert (c.cost.flops, c.cost.transcendentals) == (8 * 32, 32)
    big = torch.empty(100, 8, device="meta")
    with OpCounter() as c:
        big[10:14].clone()  # the slice: 2 x result bytes; the clone: its boundary
    assert c.cost.bytes == 2 * 128 + (128 + 128)
    with OpCounter() as c:
        big[:4].copy_(a)  # the slice, then copy_ into it: 2 x update bytes
    assert c.cost.bytes == 2 * 128 + 2 * 128


def test_collectives_counted_by_ring_conventions():
    """Functional and process-group collectives on a one-rank gloo group
    (a process of its own: the group is process state): all-reduce 2 x
    operand bytes, all-gather the result's, reduce-scatter the operand's."""
    code = (
        "import warnings; warnings.simplefilter('ignore')\n"
        "import torch, torch.distributed as dist\n"
        "from torch.distributed import _functional_collectives as funcol\n"
        "from repro_torch.launch.mesh import init_local_process_group\n"
        "from repro_torch.roofline.op_cost import OpCounter\n"
        "init_local_process_group('cpu')\n"
        "t = torch.ones(16)\n"
        "with OpCounter() as c:\n"
        "    a = funcol.all_reduce(t, 'sum', dist.group.WORLD) + 0\n"
        "    g = funcol.all_gather_tensor(t, 0, dist.group.WORLD) + 0\n"
        "    r = funcol.reduce_scatter_tensor(t, 'sum', 0, dist.group.WORLD) + 0\n"
        "    dist.all_reduce(t)\n"
        "print(sorted(c.cost.coll.items()), sorted(c.cost.coll_counts.items()))\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr[-1500:]
    assert out.stdout.strip() == (
        "[('all-gather', 64), ('all-reduce', 256), ('reduce-scatter', 64)] "
        "[('all-gather', 1), ('all-reduce', 2), ('reduce-scatter', 1)]")


def _smoke_step(device):
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.train_loop import TrainConfig, make_train_step

    cfg = port_configs.get_config("qwen1.5-0.5b", smoke=True)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = model.init(gen, device, dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64))).to(device)
             for k in ("tokens", "labels")}
    step = make_train_step(model, TrainConfig(remat=False, n_loss_chunks=4))
    with OpCounter() as c:
        step(params, adamw_init(params), None, batch, 0)
    return cfg, c


@pytest.fixture(scope="module")
def smoke_counts():
    return _smoke_step("meta"), _smoke_step("cpu")


# The reference walker's flops for its own smoke step (b 4, s 64, no remat,
# 4 loss chunks; test_hlo_cost.py:78) were 216,918,676 against the port's
# 234,566,556 (1.08x): the port counts its unfused ops, the blockwise
# AMLA forward the kernel charge stands for, and a softmax per element.
PORT_OVER_REFERENCE = (0.9, 1.5)


def test_smoke_train_step_flops_sane(smoke_counts):
    (cfg, c), _ = smoke_counts
    analytic = 6.0 * cfg.param_count() * 4 * 64
    assert 0.5 * analytic < c.cost.flops < 4.0 * analytic
    assert c.charges["flash_prefill"].flops > 0


def test_smoke_train_step_near_reference_walker(smoke_counts):
    from repro.configs import get_config
    from repro.models.model_zoo import build_model
    from repro.optim.adamw import adamw_init
    from repro.runtime.train_loop import TrainConfig, make_train_step

    cfg = get_config("qwen1.5-0.5b", smoke=True)
    model = build_model(cfg)
    params_like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct((4, 64), jnp.int32) for k in ("tokens", "labels")}
    step = make_train_step(model, TrainConfig(remat=False, n_loss_chunks=4))
    compiled = jax.jit(step).lower(params_like, jax.eval_shape(adamw_init, params_like), None,
                                   batch, jax.ShapeDtypeStruct((), jnp.int32)).compile()
    ref = ref_hlo.cost_from_compiled(compiled)
    (_, c), _ = smoke_counts
    lo, hi = PORT_OVER_REFERENCE
    assert lo < c.cost.flops / ref.flops < hi, (c.cost.flops, ref.flops)


def test_meta_count_equals_cpu_count(smoke_counts):
    (_, meta), (_, cpu) = smoke_counts
    assert meta.cost.flops == cpu.cost.flops
    assert meta.cost.bytes == cpu.cost.bytes
    assert meta.cost.cast_bytes == cpu.cost.cast_bytes
    assert {k: (v.flops, v.bytes) for k, v in meta.charges.items()} == \
        {k: (v.flops, v.bytes) for k, v in cpu.charges.items()}
    assert meta.peak_bytes > 0 and cpu.peak_bytes > 0


# --------------------------------------------------------------------------- #
# kernel wrappers: meta branches and charges
# --------------------------------------------------------------------------- #
def _both(fn, *shapes_dtypes, ints=()):
    """``fn`` on seeded CPU tensors and on meta stand-ins of them, each
    under a counter: ``[(out, counter), (out, counter)]``."""
    rng = np.random.default_rng(0)
    cpu = [torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(d) for s, d in shapes_dtypes]
    cpu += [torch.as_tensor(np.asarray(v)) for v in ints]
    runs = []
    for args in (cpu, [t.to("meta") for t in cpu]):
        with OpCounter() as c:
            out = fn(*args)
        runs.append((out, c))
    return runs


def _same_structure(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    assert all(t.is_meta for t in b)


def test_k7_meta_branch_and_charge():
    b, hq, hkv, s, dh = 2, 4, 2, 256, 64
    bf = torch.bfloat16
    runs = _both(lambda q, k, v, n: k7.flash_prefill(q, k, v, n, scale=0.125),
                 ((b, hq, s, dh), bf), ((b, hkv, s, dh), bf), ((b, hkv, s, dh), bf),
                 ints=([s, s],))
    (out, cpu), (mout, meta) = runs
    _same_structure(out, mout)
    pairs = b * hq * s * (s + 1) // 2
    nbytes = b * hq * s * dh * 2 + b * hkv * s * dh * 4 + b * hq * s * dh * 4
    for c in (cpu, meta):
        assert (c.charges["flash_prefill"].flops, c.charges["flash_prefill"].bytes) == \
            (4 * dh * pairs, nbytes)
        assert c.n_ops == 0  # nothing inside the wrapper is counted


def test_k7_charge_reads_kv_len_and_window():
    b, h, s, dh = 2, 2, 128, 32
    q = torch.zeros(b, h, s, dh)
    with OpCounter() as c:
        k7.flash_prefill(q, q, q, torch.tensor([128, 40]), scale=1.0, window=16)
    vis = [min(16, i + 1) for i in range(s)]
    vis2 = [max(0, min(40, i + 1) - max(0, i - 15)) for i in range(s)]
    assert c.charges["flash_prefill"].flops == 4 * dh * h * (sum(vis) + sum(vis2))


def test_k6_meta_branch_splits_and_charges_k3():
    """bf16 K6 on meta splits by the H100's SMs and merges through K3's
    meta branch, charging both; the CPU runs one split."""
    b, hkv, g, s, dh = 1, 2, 4, 1024, 64
    bf = torch.bfloat16

    def call(q, k, v, n, pos):
        return k6.gqa_decode_rows(q, k, v, n, pos, scale=0.125)

    runs = _both(call, ((b, hkv, g, dh), bf), ((b, hkv, s, dh), bf), ((b, hkv, s, dh), bf),
                 ints=([s], [[s - 1] * g]))
    (out, cpu), (mout, meta) = runs
    _same_structure(out, mout)
    want = (4 * dh * b * hkv * g * s, b * hkv * g * dh * 2 + b * hkv * s * dh * 4
            + b * hkv * g * dh * 4)
    for c in (cpu, meta):
        assert (c.charges["gqa_decode_rows"].flops, c.charges["gqa_decode_rows"].bytes) == want
    splits = k6.decode_splits(k6.H100_SMS, b * hkv, s // 512)
    assert splits == 2 and "combine_split_partials" not in cpu.charges
    assert meta.charges["combine_split_partials"].flops == 3 * dh * g * b * hkv * splits
    parts = _both(lambda q, k, v, n, pos: k6.gqa_decode_rows(q, k, v, n, pos, scale=0.125,
                                                             return_partials=True),
                  ((b, hkv, g, dh), torch.float32), ((b, hkv, s, dh), torch.float32),
                  ((b, hkv, s, dh), torch.float32), ints=([s], [[s - 1] * g]))
    _same_structure(parts[0][0], parts[1][0])


def test_k6_charge_reads_ragged_lengths():
    b, hkv, g, s, dh = 2, 1, 2, 64, 16
    q = torch.zeros(b, hkv, g, dh)
    k = torch.zeros(b, hkv, s, dh)
    with OpCounter() as c:
        k6.gqa_decode_rows(q, k, k, torch.tensor([10, 64]), torch.tensor([[8, 9], [62, 63]]),
                           scale=1.0, window=8)
    # request 0: rows at 8, 9 see keys 1..8 and 2..9 (8 each), span 1..9;
    # request 1: rows at 62, 63 see 55..62 and 56..63, span 55..63
    assert c.charges["gqa_decode_rows"].flops == 4 * dh * 4 * 8
    assert c.charges["gqa_decode_rows"].bytes == (
        b * g * dh * 4 + (9 + 9) * dh * 8 + b * g * dh * 4)


def test_k4_meta_branch_and_charge():
    b, g, s, dk, dv = 2, 8, 512, 96, 64
    runs = _both(lambda q, c_kv, n, pos: k4.mla_decode_rows(q, c_kv, n, pos, d_v=dv, scale=0.1),
                 ((b, g, dk), torch.bfloat16), ((b, s, dk), torch.bfloat16),
                 ints=([s, s], [[s - 1] * g] * b))
    (out, cpu), (mout, meta) = runs
    _same_structure(out, mout)
    want = (2 * (dk + dv) * b * g * s, b * g * dk * 2 + b * s * dk * 2 + b * g * dv * 4)
    for c in (cpu, meta):
        assert (c.charges["mla_decode_rows"].flops, c.charges["mla_decode_rows"].bytes) == want


def test_k3_meta_branch_and_charge():
    d, g, dv, b, s = 6, 4, 32, 3, 2
    dest = torch.arange(b * s, dtype=torch.int32).reshape(b, s)
    runs = _both(lambda o, lse, dt, n: k3.combine_split_partials(o, lse, dt, n),
                 ((d, g, dv), torch.float32), ((d, g, 1), torch.float32),
                 ints=(dest.numpy(), [2, 1, 2]))
    (out, cpu), (mout, meta) = runs
    _same_structure(out, mout)
    assert cpu.charges["combine_split_partials"].flops == 3 * dv * g * 5
    assert meta.charges["combine_split_partials"].flops == 3 * dv * g * 6
    assert meta.charges["combine_split_partials"].bytes == (6 * g * (dv + 1) + b * g * dv) * 4


def test_meta_skips_host_value_checks():
    assert ops._host_values(torch.zeros(2, device="meta")) is None
    assert ops._all_zero(torch.zeros(2, device="meta"))
    assert ops._all_zero(torch.zeros(2)) and not ops._all_zero(torch.ones(2))


@pytest.mark.parametrize("scheduler", ["queue", "padded"])
def test_paged_kernels_charge_visible_pairs(scheduler):
    """K2 (queue) and K5 (padded) charge 2 * (Dk + Dv) per (row, visible
    key) whatever the work split: every key below kv_len, causal at the
    decode position."""
    rng = np.random.default_rng(1)
    b, hq, dk, dv, page, w = 2, 4, 96, 64, 16, 4
    pool = torch.as_tensor(rng.normal(size=(b * w, page, dk)).astype(np.float32))
    bt = torch.arange(b * w, dtype=torch.int32).reshape(b, w)
    kv_len = np.array([23, 64], np.int32)
    q = torch.as_tensor(rng.normal(size=(b, 1, hq, dk)).astype(np.float32))
    with OpCounter() as c:
        ops.mla_decode_paged(q, pool, bt, kv_len, d_v=dv, scale=0.1, scheduler=scheduler,
                             block_k=32 if scheduler == "queue" else None, num_splits=2)
    name = "mla_decode_paged_queue_rows" if scheduler == "queue" else "mla_decode_paged_rows"
    assert c.charges[name].flops == 2 * (dk + dv) * hq * int(kv_len.sum())
    if scheduler == "padded":
        assert c.charges[name].bytes == (b * hq * dk * 2 + int(kv_len.sum()) * dk * 4
                                         + b * hq * dv * 4)
    else:
        assert c.charges["combine_split_partials"].flops > 0
