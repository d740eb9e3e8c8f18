"""Split-KV decode (``repro_torch.core.distributed``) and K6's partials
(``gqa_decode_rows(return_partials=True)``) on the CPU, held against the
JAX package.

The port runs one body per sequence shard of a logical mesh (every entry
the CPU, where K6's plain version runs) and merges the partials once; the
reference runs its ``shard_map`` on a 1 x 1 mesh.  Both are held against
the reference's ``multi_head_attention(impl="naive")`` at rel 5e-3, the
bound of ``tests/test_perf_paths.py`` and ``tests/test_attention_api.py``
(bf16 P before P.V on the reference's side, the AMLA rescale on both).
The cross-shard merge is held against the reference's ``combine_partials``
over the same slices at ``test_attention_api.py``'s fp32 bounds.  The
``seqkv`` decode of smoke qwen2.5-3b is held against plain decode and the
reference's at rtol/atol 2e-2 (``test_perf_paths.py``), and the MoE's
expert-parallel placements change no bit.
"""

import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import distributed as ref_dist
from repro.core import jax_compat
from repro.core.attention import multi_head_attention as ref_mha
from repro.core.flash import flash_attention_base
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.mesh_ctx import mesh_ctx as ref_mesh_ctx
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core import distributed as dist
from repro_torch.kernels import _build
from repro_torch.kernels import gqa_decode as port_gqa
from repro_torch.kernels import mla_decode_combine as port_combine
from repro_torch.launch.mesh import logical_mesh, make_debug_mesh
from repro_torch.models import attention_layer
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import sharding
from repro_torch.runtime.mesh_ctx import mesh_ctx

SHARDS = [1, 2, 4]
REL = 5e-3
BF, F32 = torch.bfloat16, torch.float32


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-10)


def mesh_of(n):
    return logical_mesh({"data": 1, "model": n}, "cpu")


# kv_len, window, softcap over one shape: b 2, two query rows each (the
# positions kv_len - 2, kv_len - 1), 8 / 2 heads of 32, 256 cache rows.
# "ragged": with 4 shards of 64 keys request 1 reaches shard 0 only, its
# shards 1-3 empty.
B, SQ, HQ, HKV, DH, S = 2, 2, 8, 2, 32, 256
CASES = {
    "plain": ((256, 100), None, None),
    "window_softcap": ((256, 200), 48, 20.0),
    "ragged": ((256, 40), None, None),
}


@functools.lru_cache(maxsize=None)
def case_data(name):
    lens, window, softcap = CASES[name]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, SQ, HQ, DH)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, DH)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, DH)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    kw = dict(scale=1 / math.sqrt(DH), window=window, softcap=softcap)
    return q, k, v, kv_len, kv_len - SQ, kw


@functools.partial(jax.jit, static_argnames=("variant", "scale", "window", "softcap"))
def _ref_split(q, k, v, kv_len, q_off, *, variant, scale, window, softcap):
    return ref_dist.gqa_split_kv_decode(
        q, k, v, mesh=jax_compat.make_mesh((1, 1), ("data", "model")), seq_axis="model",
        batch_axes=("data",), variant=variant, scale=scale, kv_len=kv_len, q_offset=q_off,
        window=window, softcap=softcap)


@functools.partial(jax.jit, static_argnames=("scale", "window", "softcap"))
def _ref_naive(q, k, v, kv_len, q_off, *, scale, window, softcap):
    return ref_mha(q, k, v, impl="naive", kv_len=kv_len, q_offset=q_off, causal=True,
                   scale=scale, window=window, softcap=softcap)


@functools.lru_cache(maxsize=None)
def reference_outputs(name, variant):
    """(the reference's split-KV decode on a 1 x 1 mesh, its naive
    attention); jitted, so cases of one shape and static arguments share a
    compile."""
    q, k, v, kv_len, q_off, kw = case_data(name)
    args = tuple(jnp.asarray(x) for x in (q, k, v, kv_len, q_off))
    return np.asarray(_ref_split(*args, variant=variant, **kw)), np.asarray(_ref_naive(*args, **kw))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_gqa_split_kv_decode_matches_reference(layout, variant, case, n):
    q, k, v, kv_len, q_off, kw = case_data(case)
    kk, vv = (k.swapaxes(1, 2), v.swapaxes(1, 2)) if layout == "bhsd" else (k, v)
    got = dist.gqa_split_kv_decode(
        torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(kk)),
        torch.from_numpy(np.ascontiguousarray(vv)), mesh=mesh_of(n), variant=variant,
        kv_len=torch.from_numpy(kv_len), q_offset=torch.from_numpy(q_off), kv_layout=layout,
        **kw)
    split, naive = reference_outputs(case, variant)
    assert got.shape == q.shape and got.dtype == F32
    assert rel_err(got, split) < REL
    assert rel_err(got, naive) < REL


def test_row_that_no_shard_sees_is_zero():
    """kv_len 0: every shard is empty, the row is exact zeros (and a live
    row beside it is untouched by the empty one)."""
    q, k, v, _, _, kw = case_data("plain")
    kv_len = np.asarray([0, 100], np.int32)
    out = dist.gqa_split_kv_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mesh=mesh_of(4),
        kv_len=torch.from_numpy(kv_len), q_offset=torch.from_numpy(kv_len - 1), **kw)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert float(out[1].abs().max()) > 0


def test_batch_blocks_over_the_data_axis():
    """A 2 x 2 logical mesh: requests in blocks over ``data``, keys over
    ``model``; equal to the 1 x 2 mesh's answer."""
    q, k, v, kv_len, q_off, kw = case_data("ragged")
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    kw = dict(kv_len=torch.from_numpy(kv_len), q_offset=torch.from_numpy(q_off), **kw)
    got = dist.gqa_split_kv_decode(*args, mesh=logical_mesh({"data": 2, "model": 2}, "cpu"),
                                   **kw)
    want = dist.gqa_split_kv_decode(*args, mesh=mesh_of(2), batch_axes=(), **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not split"):
        dist.gqa_split_kv_decode(*args, mesh=logical_mesh({"data": 1, "model": 3}, "cpu"), **kw)


@functools.lru_cache(maxsize=None)
def seq_parallel_case(variant):
    """``test_attention_api.py``'s inputs and the reference's answers: its
    ``seq_parallel_decode_batched`` on a 1-device mesh, its naive
    attention."""
    b, g, s, d = 2, 8, 256, 64
    rng = np.random.default_rng(23)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in ((b, g, d), (b, s, d), (b, s, d)))
    kv_len = np.asarray([s, 100], np.int32)
    want = jax.jit(functools.partial(
        ref_dist.seq_parallel_decode_batched, mesh=jax.make_mesh((1,), ("data",)),
        variant=variant, scale=0.125))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       kv_len=jnp.asarray(kv_len))
    naive = ref_mha(jnp.asarray(q)[:, None], jnp.asarray(k)[:, :, None],
                    jnp.asarray(v)[:, :, None], impl="naive", scale=0.125,
                    kv_len=jnp.asarray(kv_len))[:, 0]
    return (q, k, v, kv_len), np.asarray(want), np.asarray(naive)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("variant", ["base", "amla"])
def test_seq_parallel_decode_batched_matches_reference(variant, n):
    """Every key below kv_len visible, one head: against the reference's
    split decode and its naive attention; the one-request form equal to
    the batched one's row."""
    (q, k, v, kv_len), want, naive = seq_parallel_case(variant)
    mesh = logical_mesh({"data": n}, "cpu")
    got = dist.seq_parallel_decode_batched(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mesh=mesh,
        variant=variant, scale=0.125, kv_len=torch.from_numpy(kv_len))
    assert rel_err(got, want) < REL and rel_err(got, naive) < REL
    one = dist.seq_parallel_decode(torch.from_numpy(q[1]), torch.from_numpy(k[1]),
                                   torch.from_numpy(v[1]), mesh=mesh, variant=variant,
                                   scale=0.125, kv_len=100)
    assert torch.equal(one, got[1])


def test_cross_shard_merge_matches_combine_partials():
    """``test_attention_api.py``'s merge: 4 slices of 128 keys, each
    attended by K6's plain version with ``return_partials`` (fp32, base)
    and merged by ``combine_shard_partials``, against the reference's
    ``combine_partials`` of ``flash_attention_base`` residuals over the same
    slices (fp32 matmuls) and its single pass, at that test's bounds."""
    g, s, d, shards = 8, 512, 64, 4
    rng = np.random.default_rng(20)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in ((g, d), (s, d), (s, d)))
    full = flash_attention_base(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125,
                                matmul_dtype=jnp.float32)
    accs, ms, ls, os_, lses = [], [], [], [], []
    for i in range(shards):
        sl = slice(i * s // shards, (i + 1) * s // shards)
        a, m, l = flash_attention_base(jnp.asarray(q), jnp.asarray(k[sl]), jnp.asarray(v[sl]),
                                       scale=0.125, return_residuals=True,
                                       matmul_dtype=jnp.float32)
        accs.append(a), ms.append(m), ls.append(l)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x))[None, None]
        o, lse = port_gqa.gqa_decode_rows(
            t(q), t(k[sl]), t(v[sl]), torch.tensor([s // shards]),
            torch.full((1, g), s, dtype=torch.int32), variant="base", scale=0.125,
            return_partials=True)
        os_.append(o), lses.append(lse)
    want = ref_dist.combine_partials(jnp.stack(accs), jnp.stack(ms), jnp.stack(ls))
    got = dist.combine_shard_partials(torch.cat(os_), torch.cat(lses))[0, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(full), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("variant", ["amla", "base"])
def test_plain_partials_merge_to_the_split_walk(variant):
    """``attend_plain(return_partials=True)``: one normalized partial and
    lse per split (-inf for a split with no key, its rows zero); merged
    by ``combine_shard_partials`` they give the split walk's merged answer."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 2, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 2, 1300, 32)).astype(np.float32))
            for _ in range(2))
    lens = torch.tensor([1300, 300])
    pos = (lens - 1)[:, None].repeat(1, 4)
    kw = dict(variant=variant, scale=0.2, block_k=128, softcap=None, window=None, num_splits=4)
    o, lse = port_gqa.attend_plain(q, k, v, lens, pos, return_partials=True, **kw)
    assert o.shape == (4, 2, 2, 4, 32) and lse.shape == (4, 2, 2, 4)
    # request 1's 3 live blocks over 4 splits: split 0 takes none
    assert torch.isinf(lse[0, 1]).all() and torch.equal(o[0, 1], torch.zeros_like(o[0, 1]))
    want = port_gqa.attend_plain(q, k, v, lens, pos, **kw)
    torch.testing.assert_close(dist.combine_shard_partials(o, lse), want, rtol=1e-6, atol=1e-6)


class _Lib:
    """Stands in for the kernel library: records each call, returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "load", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(port_gqa, "_sm_count", lambda device: 132)

    def no_combine(*a):
        raise AssertionError("return_partials launched the combine")

    monkeypatch.setattr(port_combine, "combine_split_partials", no_combine)
    return fake


K6_LSE, K6_SPLITS = 6, 13


@pytest.mark.parametrize("dtype", [BF, F32])
def test_return_partials_launch(lib, dtype):
    """K6 with ``return_partials``: bf16 over its splits, fp32 at one; an
    lse buffer either way, and no combine launch; the partials come back
    as ``(splits, B, Hkv, G, Dh)`` and ``(splits, B, Hkv, G)``."""
    rn = lambda *sh: torch.zeros(sh, dtype=dtype)
    q, k, v = rn(2, 2, 4, 64), rn(2, 2, 1300, 64), rn(2, 2, 1300, 64)
    lens = torch.full((2,), 1300, dtype=torch.int32)
    pos = torch.full((2, 4), 1299, dtype=torch.int32)
    before = port_gqa.gqa_decode_rows.launches
    o, lse = port_gqa._decode_cuda(q, k, v, lens, pos, variant="amla", scale=0.1, block_k=512,
                                   softcap=None, window=None, return_partials=True)
    (name, args), = lib.calls
    splits = args[K6_SPLITS]
    assert name == "amla_gqa_decode" and args[K6_LSE] is not None
    assert (splits > 1) == (dtype == BF)
    assert o.shape == (splits, 2, 2, 4, 64) and lse.shape == (splits, 2, 2, 4)
    assert port_gqa.gqa_decode_rows.launches == before + 1
    if dtype == F32:  # without partials fp32 passes no lse, as before
        port_gqa._decode_cuda(q, k, v, lens, pos, variant="amla", scale=0.1, block_k=512,
                              softcap=None, window=None)
        assert lib.calls[1][1][K6_LSE] is None


def test_unequal_widths_raise_on_the_kernel_path(lib):
    """K6 takes Dk == Dv: a launch with other widths raises ValueError (the
    CPU's plain version takes them)."""
    q, k, v = torch.zeros(1, 1, 8, 64), torch.zeros(1, 1, 128, 64), torch.zeros(1, 1, 128, 32)
    with pytest.raises(ValueError, match="head dims differ"):
        port_gqa._decode_cuda(q, k, v, torch.tensor([128]), torch.full((1, 8), 128),
                              variant="amla", scale=0.1, block_k=128, softcap=None,
                              window=None, return_partials=True)
    out = dist.seq_parallel_decode(q[0, 0], k[0, 0], v[0, 0], mesh=logical_mesh({"data": 2}, "cpu"),
                                   scale=0.1)
    assert out.shape == (8, 32)


@pytest.fixture(scope="module")
def qwen_pair():
    name = "qwen2.5-3b"
    ref_cfg = ref_get_config(name, smoke=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = get_config(name, smoke=True)
    return dict(ref_model=ref_model, ref_params=ref_params, model=build_model(cfg),
                params=convert_params(ref_params, cfg, device="cpu"), cfg=cfg)


@functools.lru_cache(maxsize=None)
def _prompt_and_token(vocab):
    rng = np.random.default_rng(3)
    return rng.integers(2, vocab, size=(2, 6)), rng.integers(2, vocab, size=(2, 1))


@pytest.mark.parametrize("n", SHARDS)
def test_seqkv_decode_matches_plain_and_reference(qwen_pair, monkeypatch, n):
    """Smoke qwen2.5-3b (fp32): a 6-token prefill, then one decode step
    under ``mesh_ctx(seqkv)`` over 1, 2 and 4 logical sequence shards of a
    16-row cache: every layer takes the split-KV branch; logits against the
    plain decode and the reference's seqkv decode on its 1 x 1 mesh at
    rtol/atol 2e-2."""
    model, params, cfg = qwen_pair["model"], qwen_pair["params"], qwen_pair["cfg"]
    prompt, tok = _prompt_and_token(cfg.vocab_size)
    calls = []
    orig = attention_layer.gqa_split_kv_decode

    def spy(*a, **kw):
        calls.append(kw["mesh"].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(attention_layer, "gqa_split_kv_decode", spy)

    def port(ctx):
        cache = model.init_cache(params, 2, 16)
        model.prefill(params, cache, torch.from_numpy(prompt))
        with ctx:
            logits, _ = model.decode_step(params, cache, torch.from_numpy(tok), np.int32(6))
        return logits.numpy()

    plain = port(mesh_ctx(None, "tp_fsdp"))
    assert not calls
    seqkv = port(mesh_ctx(mesh_of(n), "seqkv"))
    assert calls == [{"data": 1, "model": n}] * cfg.n_layers
    ref_model, ref_params = qwen_pair["ref_model"], qwen_pair["ref_params"]
    cache = ref_model.init_cache(ref_params, 2, 16)
    _, cache = ref_model.prefill(ref_params, cache, jnp.asarray(prompt))
    with ref_mesh_ctx(jax_compat.make_mesh((1, 1), ("data", "model")), "seqkv", False):
        want, _ = ref_model.decode_step(ref_params, cache, jnp.asarray(tok), jnp.int32(6))
    np.testing.assert_allclose(seqkv, plain, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(seqkv, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_moe_placements_change_no_value(monkeypatch):
    """Smoke qwen3-moe (fp32): the forward under ``mesh_ctx(tp_fsdp)`` on
    a 1 x 1 mesh takes the expert-parallel placements (three per MoE
    layer) and is bit-equal to the forward without a mesh."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    calls = []
    orig = sharding.with_sharding_constraint

    def spy(t, sh):
        calls.append(tuple(sh.spec))
        return orig(t, sh)

    monkeypatch.setattr(sharding, "with_sharding_constraint", spy)
    plain = model.forward(params, {"tokens": tokens})
    assert not calls
    with mesh_ctx(make_debug_mesh("cpu"), "tp_fsdp"):
        placed = model.forward(params, {"tokens": tokens})
    moe_layers = sum(1 for p in params["layers"] if "router" in p.get("mlp", {}))
    assert moe_layers and len(calls) == 3 * moe_layers
    assert calls[:3] == [("model", "data", None), ("model", "data", None), ("data", None)]
    for a, b in zip(plain if isinstance(plain, tuple) else (plain,),
                    placed if isinstance(placed, tuple) else (placed,)):
        assert torch.equal(a, b)
