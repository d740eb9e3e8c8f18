"""The port's paged MLA model (repro_torch.models) against the JAX reference
on the deepseek-v2-mla smoke config (fp32, 2 layers), with the reference's
weights carried across by ``repro_torch.convert``.

Each layer's output activations are compared on a prefill chunk and on a
decode step (both sides attending through their own paged caches), then
the logits of the full ``lm_prefill_paged`` / ``lm_decode_step_paged``.
Tolerance 2e-3 absolute on activations and logits (their scale is O(1)):
the attention of the two sides agrees to the reference's AMLA fp32
tolerance (2e-3), and the remaining layer math is the same fp32 arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.models import transformer as ref_tf
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.kv_cache import LayeredPagedKVCache as RefCache
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.kv_cache import LayeredPagedKVCache

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK, NUM_PAGES = 16, 32, 16, 16
TOL = 2e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's queue kernel run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.  The alias
    is undone after each test, and so are the jit traces made under it:
    a cached trace would let a later reference test of the same shapes
    skip the lookup that fails without the alias, and so change its
    outcome."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights():
    ref_params = ref_build_model(REF_CFG).init(jax.random.PRNGKey(0))
    return ref_params, convert_params(ref_params, CFG, device="cpu")


def _caches():
    r = RefCache(num_layers=CFG.n_layers, num_pages=NUM_PAGES, page_size=PAGE,
                 width=80, dtype=jnp.float32)
    p = LayeredPagedKVCache(num_layers=CFG.n_layers, num_pages=NUM_PAGES, page_size=PAGE,
                            width=80, dtype=torch.float32, device="cpu")
    return r, p


def test_config_and_converted_weights(weights):
    ref_params, params = weights
    full, ref_full = get_config("deepseek-v2-mla"), ref_get_config("deepseek-v2-mla")
    for ours, theirs in ((CFG, REF_CFG), (full, ref_full)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert full.param_count() == ref_full.param_count()
    per_layer = ref_tf.per_layer_params(ref_params, REF_CFG)
    assert len(params["layers"]) == len(per_layer) == CFG.n_layers
    for ours, theirs in zip(params["layers"], per_layer):
        for k in ("wq_nope", "w_uk", "w_uv", "wo"):
            w = theirs["attn"][k]["w"] if k == "wo" else theirs["attn"][k]
            got = ours["attn"][k]["w"] if k == "wo" else ours["attn"][k]
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def _walk(side, params, cache, tokens, positions, q_offset, rids, write):
    """One forward pass layer by layer; returns each layer's output."""
    if side == "ref":
        x = ref_tf._paged_embed(params["embed"], jnp.asarray(tokens), cfg=REF_CFG)
        layers = ref_tf.per_layer_params(params, REF_CFG)
    else:
        x = tf.embed_tokens(params, torch.from_numpy(tokens), cfg=CFG)
        layers = params["layers"]
    bt, kv = cache.block_table(rids, width=NUM_PAGES)
    outs = []
    for l, p_l in enumerate(layers):
        kw = dict(d_v=64, scale=tf.mla_scale(CFG), block_k=BLOCK_K, num_splits=2)
        if side == "ref":
            lat, q = ref_tf._paged_attn_inputs(p_l, x, jnp.asarray(positions), cfg=REF_CFG)
            write(l, np.asarray(lat))
            attn = ref_ops.mla_decode_paged(
                q, cache.layer_pages(l), jnp.asarray(bt), jnp.asarray(kv), interpret=True,
                compute_dtype=jnp.float32,
                q_offset=None if q_offset is None else jnp.asarray(q_offset), **kw)
            x = ref_tf._paged_layer_post(p_l, x, attn, cfg=REF_CFG)
            outs.append(np.asarray(x))
        else:
            lat, q = tf.paged_attn_inputs(p_l, x, torch.from_numpy(positions), cfg=CFG)
            write(l, lat.numpy())
            attn = ops.mla_decode_paged(
                q, cache.layer_pages(l), torch.from_numpy(bt), kv, compute_dtype=torch.float32,
                q_offset=None if q_offset is None else torch.from_numpy(q_offset), **kw)
            x = tf.paged_layer_post(p_l, x, attn, cfg=CFG)
            outs.append(x.numpy())
    return outs


def test_per_layer_activations_prefill_chunk_then_decode(pallas_interpret, weights):
    ref_params, params = weights
    rng = np.random.default_rng(0)
    caches = dict(zip(("ref", "port"), _caches()))
    # prefill: one 13-token chunk of request 0 and a 5-token one of request 1
    prompts = [rng.integers(2, CFG.vocab_size, size=n) for n in (13, 5)]
    for rid, prompt in enumerate(prompts):
        n = len(prompt)
        tok = np.zeros((1, CHUNK), np.int64)
        tok[0, :n] = prompt
        pos = np.arange(CHUNK, dtype=np.int32)[None]
        outs = {}
        for side, params_s in (("ref", ref_params), ("port", params)):
            c = caches[side]
            c.alloc(rid)
            plan = c.reserve(rid, n)
            if side == "ref":
                write = lambda l, lat, c=c, plan=plan: c.write_layer(l, plan, jnp.asarray(lat[0, :n]))
            else:
                write = lambda l, lat, c=c, plan=plan: c.write_layer(l, plan, torch.from_numpy(lat[0, :n]))
            outs[side] = _walk(side, params_s, c, tok, pos, np.zeros((1,), np.int32), [rid], write)
        for l in range(CFG.n_layers):
            err = np.abs(outs["ref"][l][:, :n] - outs["port"][l][:, :n]).max()
            assert err <= TOL, (rid, l, err)
    # decode: one row for both requests
    tok = rng.integers(2, CFG.vocab_size, size=(2, 1))
    outs = {}
    for side, params_s in (("ref", ref_params), ("port", params)):
        c = caches[side]
        pos = np.asarray([[c.seq_len(0)], [c.seq_len(1)]], np.int32)
        plans = [c.reserve(r, 1) for r in (0, 1)]
        pids = np.asarray([p[0][0] for p in plans], np.int32)
        offs = np.asarray([p[0][1] for p in plans], np.int32)
        if side == "ref":
            write = lambda l, lat, c=c: c.write_layer_tokens(l, pids, offs, jnp.asarray(lat.reshape(2, -1)))
        else:
            write = lambda l, lat, c=c: c.write_layer_tokens(l, pids, offs, torch.from_numpy(lat.reshape(2, -1)))
        outs[side] = _walk(side, params_s, c, tok, pos, None, [0, 1], write)
    for l in range(CFG.n_layers):
        assert np.abs(outs["ref"][l] - outs["port"][l]).max() <= TOL, l
    np.testing.assert_allclose(
        caches["port"].pages.numpy(), np.asarray(caches["ref"].pages), atol=TOL, rtol=0)


def test_prefill_and_decode_logits_match_reference(pallas_interpret, weights):
    ref_params, params = weights
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in (23, 9)]
    rcache, pcache = _caches()
    for rid, prompt in enumerate(prompts):
        rcache.alloc(rid)
        pcache.alloc(rid)
        want = ref_tf.lm_prefill_paged(
            ref_params, prompt, cfg=REF_CFG, cache=rcache, rid=rid, chunk=CHUNK,
            table_width=NUM_PAGES, block_k=BLOCK_K, interpret=True, compute_dtype=jnp.float32)
        got = tf.lm_prefill_paged(
            params, prompt, cfg=CFG, cache=pcache, rid=rid, chunk=CHUNK,
            table_width=NUM_PAGES, block_k=BLOCK_K, compute_dtype=torch.float32)
        assert got.shape == want.shape == (1, CFG.vocab_size)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    tokens = np.asarray([[7], [300]], np.int32)
    for _ in range(2):
        want = ref_tf.lm_decode_step_paged(
            ref_params, tokens, cfg=REF_CFG, cache=rcache, rids=[0, 1], table_width=NUM_PAGES,
            block_k=BLOCK_K, num_splits=2, interpret=True, compute_dtype=jnp.float32)
        got = tf.lm_decode_step_paged(
            params, tokens, cfg=CFG, cache=pcache, rids=[0, 1], table_width=NUM_PAGES,
            block_k=BLOCK_K, num_splits=2, compute_dtype=torch.float32)
        assert got.shape == want.shape == (2, 1, CFG.vocab_size)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
        tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)
    # a 3-row step takes the explicit-position path (q_positions)
    tokens = np.asarray([[5, 6, 7], [8, 9, 10]], np.int32)
    want = ref_tf.lm_decode_step_paged(
        ref_params, tokens, cfg=REF_CFG, cache=rcache, rids=[0, 1], table_width=NUM_PAGES,
        block_k=BLOCK_K, interpret=True, compute_dtype=jnp.float32)
    got = tf.lm_decode_step_paged(
        params, tokens, cfg=CFG, cache=pcache, rids=[0, 1], table_width=NUM_PAGES,
        block_k=BLOCK_K, compute_dtype=torch.float32)
    assert got.shape == want.shape == (2, 3, CFG.vocab_size)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_model_hooks_and_unported_paths(weights):
    _, params = weights
    model = build_model(CFG)
    cache = model.init_paged_cache(params, num_pages=4, page_size=PAGE)
    assert cache.pages.shape == (CFG.n_layers, 4, PAGE, 80) and cache.pages.dtype == torch.float32
    assert model.layer_params(params) is params["layers"]
    # head chunks (tensor-parallel head groups): each chunk of heads is its
    # own K2 + K3 call over the one schedule, and a row does not depend on
    # its neighbours, so two chunks give the unchunked logits.  On the card
    # that holds bit for bit (chip_smoke.py); here the plain version's
    # matmuls over 2 and 4 query rows may block differently in the CPU's
    # BLAS (measured: the decode step's logits 1.2e-4 apart at |logit| 22),
    # so the logits are held within 1e-5 of their largest magnitude and
    # the greedy picks equal
    prompt = np.random.default_rng(8).integers(2, CFG.vocab_size, size=37).tolist()
    out = []
    for h in (1, 2):
        c = model.init_paged_cache(params, num_pages=NUM_PAGES, page_size=PAGE)
        c.alloc(0)
        kw = dict(cfg=CFG, cache=c, table_width=NUM_PAGES, block_k=BLOCK_K,
                  compute_dtype=torch.float32, head_shards=h)
        first = tf.lm_prefill_paged(params, prompt, rid=0, chunk=CHUNK, **kw)
        step = tf.lm_decode_step_paged(params, np.asarray([[5]]), rids=[0], **kw)
        out.append((first, step))
    for a, b in zip(out[0], out[1]):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    cache.alloc(0)
    with pytest.raises(ValueError, match="must divide n_heads"):
        tf.lm_prefill_paged(params, [1, 2], cfg=CFG, cache=cache, rid=0, head_shards=3)
    with pytest.raises(ValueError, match="no MLA geometry"):
        tf.check_paged_compatible(dataclasses.replace(CFG, mla=None))
