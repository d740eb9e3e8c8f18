"""The encoder-decoder family (seamless-m4t: non-causal encoder, causal
decoder with cross-attention over a static memory) in the port against
the JAX reference, on the CPU at fp32: smoke ``seamless-m4t-medium`` (2
encoder + 2 decoder layers, 4/4 heads x 16, GeGLU MLPs, tied embeddings)
with the reference's weights carried across by ``repro_torch.convert`` and
the reference attending with ``attn_impl="pallas_interpret"``.

Logits and hidden states agree within 2e-3 of the largest magnitude (at
least 2e-3 absolute: the dense path's tolerance) and greedy tokens are
equal, for: ``cross_attention_apply`` (over ``memory`` and over
``memory_kv``, with and without ``memory_len``), ``encode`` (which ignores
``src_len``, as the reference does), ``decode_stack`` with and without a
cache, ``encdec_cache_init``, ``EncDecModel.forward`` and the reference's
serving form: ``init_cache`` over the source frames, ``decode_step`` over
the target prompt at ``cache_len`` 0 (1, 5 and 24 tokens: K6 with
q_pos = kv_len - 1, K6 with q_pos = Sk, K7), then greedy steps.  Also:
decode against the full forward, the config and converted tree, and the
session and launcher refusing an encoder-decoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models import attention_layer as ref_attn
from repro.models import encdec as ref_encdec
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.launch import serve
from repro_torch.models import attention_layer as attn
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import EncDecModel, build_model
from repro_torch.runtime.serve_loop import ServingSession

ARCH = "seamless-m4t-medium"
TOL = 2e-3
B, SS = 2, 20  # batch, source frames


@pytest.fixture(scope="module")
def _module_traces():
    """Clear jax's caches when the module starts and when it ends, so the
    reference's interpret-mode traces are shared within the module only
    (every test that traces a reference kernel takes the alias below)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def pallas_interpret(monkeypatch, _module_traces):
    """Let the reference's Pallas kernels run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``; undone
    after each test."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield


@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_get_config(ARCH, smoke=True), attn_impl="pallas_interpret")
    cfg = get_config(ARCH, smoke=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_model=ref_model, ref_params=ref_params,
                model=build_model(cfg), params=convert_params(ref_params, cfg, device="cpu"))


def max_err(a, b):
    """max |a - b| over max(1, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def src_embeds(cfg, seed, b=B, ss=SS):
    """Seeded frame embeddings at the reference tests' scale (x 0.02)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, ss, cfg.d_model)) * 0.02).astype(np.float32)


def tokens_for(cfg, seed, st, b=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, st)).astype(np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# cross-attention, encoder, decoder
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("st", [1, 5, 24], ids=["st1", "st5", "st24"])
@pytest.mark.parametrize("form", ["memory", "memory_kv", "memory_len"])
def test_cross_attention_apply_matches_reference(pallas_interpret, pair, form, st):
    """Over the encoder output (``memory``), over precomputed K/V
    (``memory_kv``, the decode path) and bounded by ``memory_len``; St of
    1 and 5 run K6 (q_pos kv_len - 1 and Sk), 24 runs K7."""
    ref_cfg, cfg = pair["ref_cfg"], pair["cfg"]
    p_ref = jax.tree.map(lambda a: a[0], pair["ref_params"]["dec_layers"])["cross_attn"]
    p = pair["params"]["dec_layers"][0]["cross_attn"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, st, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, SS, cfg.d_model)).astype(np.float32)
    lens = np.array([SS, 13], np.int32) if form == "memory_len" else None
    kv_ref = kv = None
    if form == "memory_kv":
        k = rng.standard_normal((B, SS, cfg.n_heads, cfg.head_dim)).astype(np.float32)
        v = rng.standard_normal((B, SS, cfg.n_heads, cfg.head_dim)).astype(np.float32)
        kv_ref, kv = {"k": jnp.asarray(k), "v": jnp.asarray(v)}, {"k": t(k), "v": t(v)}
    want, want_kv = ref_attn.cross_attention_apply(
        p_ref, jnp.asarray(x), memory_kv=kv_ref, memory=jnp.asarray(mem), cfg=ref_cfg,
        memory_len=None if lens is None else jnp.asarray(lens), dtype=jnp.float32)
    got, got_kv = attn.cross_attention_apply(
        p, t(x), memory_kv=kv, memory=t(mem), cfg=cfg,
        memory_len=None if lens is None else t(lens), dtype=torch.float32)
    assert got.shape == want.shape
    assert max_err(got.numpy(), want) <= TOL
    for name in ("k", "v"):
        np.testing.assert_allclose(got_kv[name].numpy(), np.asarray(want_kv[name]),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="memory_kv or memory"):
        attn.cross_attention_apply(p, t(x), cfg=cfg)


def test_encode_matches_reference_and_ignores_src_len(pallas_interpret, pair):
    ref_cfg, cfg = pair["ref_cfg"], pair["cfg"]
    src = src_embeds(cfg, 2)
    want = ref_encdec.encode(pair["ref_params"], jnp.asarray(src), cfg=ref_cfg, dtype=jnp.float32)
    got = encdec.encode(pair["params"], t(src), cfg=cfg, dtype=torch.float32)
    assert max_err(got.numpy(), want) <= TOL
    # the reference's encoder attends to every frame whatever src_len says
    short = encdec.encode(pair["params"], t(src), cfg=cfg, src_len=t([5, 9]),
                          dtype=torch.float32)
    assert torch.equal(short, got)


@pytest.mark.parametrize("cached", [False, True], ids=["no-cache", "cache"])
def test_decode_stack_matches_reference(pallas_interpret, pair, cached):
    """Without a cache over ``memory`` (the training form) and with one
    over its precomputed cross K/V, a 24-token prompt at cache_len 0 then
    one token at cache_len 24; the self-attention rows written in place
    equal the reference's."""
    ref_cfg, cfg = pair["ref_cfg"], pair["cfg"]
    rp, p = pair["ref_params"], pair["params"]
    src = src_embeds(cfg, 3)
    toks = tokens_for(cfg, 3, 25)
    if not cached:
        mem_ref = ref_encdec.encode(rp, jnp.asarray(src), cfg=ref_cfg, dtype=jnp.float32)
        want, _ = ref_encdec.decode_stack(rp, jnp.asarray(toks), mem_ref, cfg=ref_cfg,
                                          dtype=jnp.float32)
        mem = encdec.encode(p, t(src), cfg=cfg, dtype=torch.float32)
        got, cache = encdec.decode_stack(p, t(toks).long(), mem, cfg=cfg, dtype=torch.float32)
        assert cache is None
        assert max_err(got.numpy(), want) <= TOL
        return
    ref_cache = ref_encdec.encdec_cache_init(rp, ref_cfg, jnp.asarray(src), 32, dtype=jnp.float32)
    cache = encdec.encdec_cache_init(p, cfg, t(src), 32, dtype=torch.float32)
    for lo, hi in ((0, 24), (24, 25)):
        lens = np.full((B,), lo, np.int32)
        want, ref_cache = ref_encdec.decode_stack(
            rp, jnp.asarray(toks[:, lo:hi]), None, cfg=ref_cfg, cache=ref_cache,
            cache_len=jnp.asarray(lens), dtype=jnp.float32)
        got, cache = encdec.decode_stack(p, t(toks[:, lo:hi]).long(), None, cfg=cfg, cache=cache,
                                         cache_len=lens, dtype=torch.float32)
        assert max_err(got.numpy(), want) <= TOL, (lo, hi)
    for l, c in enumerate(cache["self"]):
        for name in ("k", "v"):  # port rows (B, H, S, Dh), reference (L, B, S, H, Dh)
            np.testing.assert_allclose(c[name].transpose(1, 2).numpy(),
                                       np.asarray(ref_cache["self"][name][l]),
                                       rtol=2e-3, atol=2e-3)


def test_encdec_cache_init_matches_reference(pallas_interpret, pair):
    ref_cfg, cfg = pair["ref_cfg"], pair["cfg"]
    src = src_embeds(cfg, 4)
    want = ref_encdec.encdec_cache_init(pair["ref_params"], ref_cfg, jnp.asarray(src), 48,
                                        dtype=jnp.float32)
    got = encdec.encdec_cache_init(pair["params"], cfg, t(src), 48, dtype=torch.float32)
    assert len(got["self"]) == len(got["cross"]) == cfg.n_layers
    for l in range(cfg.n_layers):
        for name in ("k", "v"):
            cross = got["cross"][l][name]
            assert tuple(cross.shape) == (B, SS, cfg.n_heads, cfg.head_dim)
            assert max_err(cross.numpy(), want["cross"][name][l]) <= TOL
            own = got["self"][l][name]
            assert tuple(own.shape) == (B, cfg.n_kv_heads, 48, cfg.head_dim)
            assert not own.any()
            assert tuple(want["self"][name][l].shape) == (B, 48, cfg.n_kv_heads, cfg.head_dim)


# --------------------------------------------------------------------------- #
# the model and its serving form
# --------------------------------------------------------------------------- #
def test_forward_matches_reference(pallas_interpret, pair):
    """``EncDecModel.forward`` with ``src_len``: the encoder sees every
    frame, the cross-attention only the first ``src_len``."""
    cfg = pair["cfg"]
    src, toks, lens = src_embeds(cfg, 5), tokens_for(cfg, 5, 24), np.array([SS, 11], np.int32)
    ref_model, rp = pair["ref_model"], pair["ref_params"]
    hidden, aux = ref_model.forward(rp, {"tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(src),
                                         "src_len": jnp.asarray(lens)})
    want = np.asarray(ref_model.logits(rp, hidden))
    model, p = pair["model"], pair["params"]
    got = model.logits(p, model.forward(p, {"tokens": t(toks).long(), "src_embeds": t(src),
                                            "src_len": t(lens)}))
    assert float(aux) == 0.0
    assert max_err(got.numpy(), want) <= TOL
    whole = model.logits(p, model.forward(p, {"tokens": t(toks).long(), "src_embeds": t(src)}))
    assert torch.equal(whole[0], got[0]) and not torch.equal(whole[1], got[1])


@pytest.mark.parametrize("prompt", [1, 5, 24])
def test_serving_form_matches_reference(pallas_interpret, pair, prompt):
    """The reference's serving form (``dryrun.lower_prefill`` /
    ``lower_decode``): ``init_cache`` over the frames, ``decode_step``
    over the target prompt at cache_len 0, then 4 greedy steps.  Every
    step's logits within tolerance, tokens equal."""
    cfg = pair["cfg"]
    ref_model, rp, model, p = pair["ref_model"], pair["ref_params"], pair["model"], pair["params"]
    src, toks = src_embeds(cfg, 6), tokens_for(cfg, 6, prompt)
    ref_cache = ref_model.init_cache(rp, jnp.asarray(src), 32)
    cache = model.init_cache(p, t(src), 32)
    zeros = np.zeros((B,), np.int32)
    logits, ref_cache = ref_model.decode_step(rp, ref_cache, jnp.asarray(toks), jnp.asarray(zeros))
    want = [np.asarray(logits)]
    got = [model.decode_step(p, cache, t(toks).long(), zeros)[0]]
    assert got[0].shape == (B, prompt, cfg.vocab_size)
    ref_tok, tok = [], []
    for i in range(4):
        ref_tok.append(np.asarray(jnp.argmax(want[-1][:, -1], -1)).astype(np.int32))
        tok.append(torch.argmax(got[-1][:, -1], -1))
        lens = np.full((B,), prompt + i, np.int32)
        logits, ref_cache = ref_model.decode_step(rp, ref_cache, jnp.asarray(ref_tok[-1])[:, None],
                                                  jnp.asarray(lens))
        want.append(np.asarray(logits))
        got.append(model.decode_step(p, cache, tok[-1][:, None], t(lens))[0])
    for i, (g, w) in enumerate(zip(got, want)):
        assert max_err(g.numpy(), w) <= TOL, f"call {i}"
    np.testing.assert_array_equal(np.stack([x.numpy() for x in tok]), np.stack(ref_tok))


def test_decode_matches_full_forward(pair):
    """Token-by-token decode against ``forward`` with ``src_embeds`` over
    the same tokens, at the reference's tolerance
    (``tests/test_models_smoke.py``: rtol = atol = 0.15); the largest
    difference is printed in the message."""
    cfg, model = pair["cfg"], pair["model"]
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    s = 12
    src = t(src_embeds(cfg, 7, b=1))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, s)))
    full = model.logits(params, model.forward(params, {"tokens": tokens, "src_embeds": src}))
    cache = model.init_cache(params, src, 32)
    steps = torch.cat([
        model.decode_step(params, cache, tokens[:, i : i + 1], np.asarray([i], np.int32))[0]
        for i in range(s)], 1).numpy()
    worst = float(np.max(np.abs(steps - full.numpy())))
    print(f"{ARCH}: max |decode - full forward| = {worst:.3e}")
    np.testing.assert_allclose(steps, full.numpy(), rtol=0.15, atol=0.15,
                               err_msg=f"max |decode - full forward| = {worst:.3e}")


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_config_and_converted_tree(pair):
    """The config is the reference's (full and smoke; the full model's
    0.665 B parameters, encoder included); the converted tree holds the
    reference's ``enc_layers`` / ``dec_layers`` unstacked along their
    leading axis, ``enc_norm``, ``final_norm`` and the tied table; a
    port-initialised tree has the same leaves and shapes (and a bf16 one
    the table's fp32 copy)."""
    ref_cfg, cfg = ref_get_config(ARCH, smoke=True), pair["cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    full, ref_full = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert full.param_count() == ref_full.param_count() == 665_057_280
    rp, p = pair["ref_params"], pair["params"]
    fresh = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert set(p) == set(fresh) == {"enc_layers", "dec_layers", "embed", "enc_norm", "final_norm"}
    for name, n in (("enc_layers", cfg.encoder_layers), ("dec_layers", cfg.n_layers)):
        assert len(p[name]) == len(fresh[name]) == n
        for l in range(n):
            got, drawn = dict(leaves(p[name][l])), dict(leaves(fresh[name][l]))
            want = dict(leaves(jax.tree.map(lambda a: a[l], rp[name])))
            assert got.keys() == want.keys() == drawn.keys()
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
                assert tuple(drawn[k].shape) == tuple(np.shape(want[k])), k
    for name in ("embed", "enc_norm", "final_norm"):
        for k, v in leaves(rp[name]):
            np.testing.assert_array_equal(dict(leaves(p[name]))[k].numpy(), np.asarray(v))
    assert "table_f32" not in p["embed"]  # fp32 tables multiply as they are
    bf16 = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu", dtype=torch.bfloat16)
    assert torch.equal(bf16["embed"]["table_f32"], bf16["embed"]["table"].float())
    n_params = sum(x.numel() for k, x in leaves(fresh) if not k.endswith("table_f32"))
    assert n_params == sum(np.size(a) for a in jax.tree.leaves(rp))


def test_session_and_launcher_refuse_an_encoder_decoder(pair, capsys):
    """No serving session holds an encoder-decoder (the reference's cannot
    either); the error names the serving form.  ``lm_init``, which builds
    decoder-only stacks, refuses it too."""
    model, p = pair["model"], pair["params"]
    assert isinstance(model, EncDecModel)
    with pytest.raises(ValueError, match=r"EncDecModel\.init_cache.*decode_step"):
        ServingSession(model, p, batch_size=2, max_len=32)
    with pytest.raises(SystemExit, match=r"EncDecModel\.init_cache"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        tf.lm_init(torch.Generator().manual_seed(0), pair["cfg"], device="cpu",
                   dtype=torch.float32)
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        EncDecModel(get_config("qwen2-vl-7b", smoke=True))
