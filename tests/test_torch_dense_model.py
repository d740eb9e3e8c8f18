"""The port's dense-cache model path (repro_torch.models) against the JAX
reference, on the CPU: smoke ``gemma2-2b`` (local/global layers with a
32-key window, softcaps, sandwich norms, GeGLU, scaled embeddings),
``qwen2.5-3b`` (GQA group 2 after the smoke cut, QKV bias) and
``deepseek-v2-mla`` (absorbed MLA over a dense latent cache), fp32, with
the reference's weights carried across by ``repro_torch.convert``.

The reference runs with ``attn_impl="pallas_interpret"``, so both sides
attend through their kernels (the port's plain versions here).  Each
layer's output and cache are compared on a prefill and on ragged decode
steps, then the logits of ``prefill``/``decode_step``.  Tolerance 2e-3
relative to the tensor's largest magnitude, and at least 2e-3 absolute
(logits and most activations are O(1); gemma2's residual stream is O(10),
its embeddings scaled by sqrt(d)): the attention of both sides rounds to
bf16 at the same places and agrees to the reference's AMLA bound; the
rest of the layer is the same fp32 arithmetic.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models import attention_layer as ref_attn
from repro.models import layers as ref_layers
from repro.models import mla_layer as ref_mla
from repro.models import transformer as ref_tf
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.models import attention_layer, mla_layer
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import EncDecModel, build_model

ARCHS = ["gemma2-2b", "qwen2.5-3b", "deepseek-v2-mla"]
MAX_LEN, PROMPT = 64, 40  # the prompt is longer than gemma2's smoke window
TOL = 2e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's contiguous MLA kernel run in interpret mode on
    this jax, which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.
    The alias is undone after each test, and so are the jit traces made
    under it (a cached trace would change a later reference test's
    outcome)."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    name = request.param
    ref_cfg = dataclasses.replace(ref_get_config(name, smoke=True), attn_impl="pallas_interpret")
    cfg = get_config(name, smoke=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_model=ref_model, ref_params=ref_params,
                model=build_model(cfg), params=convert_params(ref_params, cfg, device="cpu"))


def max_err(a, b):
    """max |a - b| over max(1, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def ref_cache_rows(cfg, cache):
    """A reference per-layer cache in the port's layout: (B, Hkv, S, Dh)
    K/V (the reference's default layout is (B, S, Hkv, Dh)), or the latent
    rows."""
    if cfg.mla:
        return {"c": np.asarray(cache["c"])}
    return {k: np.asarray(cache[k]).transpose(0, 2, 1, 3) for k in ("k", "v")}


def walk(pair, side, tokens, caches, cache_len):
    """One forward pass layer by layer over per-layer caches; returns each
    layer's output (the caches are updated: in place for the port)."""
    cfg, ref_cfg = pair["cfg"], pair["ref_cfg"]
    b, s = tokens.shape
    positions = np.asarray(cache_len)[:, None] + np.arange(s)[None, :]
    outs = []
    if side == "ref":
        x = ref_layers.embed(pair["ref_params"]["embed"], jnp.asarray(tokens), dtype=jnp.float32)
        if ref_cfg.embed_scale:
            x = x * jnp.asarray(math.sqrt(ref_cfg.d_model), jnp.float32)
        layer_params = ref_tf.per_layer_params(pair["ref_params"], ref_cfg)
        for l, (p_l, kind) in enumerate(zip(layer_params, ref_cfg.layer_kinds())):
            x, caches[l], _ = ref_tf.layer_apply(
                p_l, x, cfg=ref_cfg, kind=kind, positions=jnp.asarray(positions),
                cache=caches[l], cache_len=jnp.asarray(cache_len), dtype=jnp.float32)
            outs.append(np.asarray(x))
        return outs
    x = tf.embed_tokens(pair["params"], torch.from_numpy(tokens), cfg=cfg)
    for l, (p_l, kind) in enumerate(zip(pair["params"]["layers"], cfg.layer_kinds())):
        x, _, _ = tf.layer_apply(p_l, x, cfg=cfg, kind=kind, positions=torch.from_numpy(positions),
                                 cache=caches[l], cache_len=cache_len, dtype=torch.float32)
        outs.append(x.numpy())
    return outs


def test_layers_caches_and_logits_match_reference(pallas_interpret, pair):
    cfg, ref_cfg = pair["cfg"], pair["ref_cfg"]
    rng = np.random.default_rng(0)
    b = 2
    caches = {
        "ref": [ref_tf.layer_cache_init(ref_cfg, k, b, MAX_LEN, jnp.float32)
                for k in ref_cfg.layer_kinds()],
        "port": tf.lm_cache_init(cfg, b, MAX_LEN, dtype=torch.float32, device="cpu"),
    }
    prompt = rng.integers(2, cfg.vocab_size, size=(b, PROMPT))
    steps = [(prompt, np.zeros((b,), np.int32))]
    # ragged decode: the second row continues from an earlier position
    for i in range(2):
        steps.append((rng.integers(2, cfg.vocab_size, size=(b, 1)),
                      np.asarray([PROMPT + i, PROMPT - 5 + i], np.int32)))
    for tokens, cache_len in steps:
        want = walk(pair, "ref", tokens, caches["ref"], cache_len)
        got = walk(pair, "port", tokens, caches["port"], cache_len)
        for l, (g, w) in enumerate(zip(got, want)):
            assert max_err(g, w) <= TOL, f"layer {l}"
        for l, (g, w) in enumerate(zip(caches["port"], caches["ref"])):
            for k, rows in ref_cache_rows(cfg, w).items():
                assert max_err(g[k].numpy(), rows) <= TOL, f"cache {k} of layer {l}"

    # the whole model: bucket-padded prefill at last_pos, then decode steps
    ref_model, model = pair["ref_model"], pair["model"]
    ref_cache = ref_model.init_cache(pair["ref_params"], b, MAX_LEN)
    cache = model.init_cache(pair["params"], b, MAX_LEN)
    want, ref_cache = ref_model.prefill(pair["ref_params"], ref_cache, jnp.asarray(prompt),
                                        last_pos=jnp.int32(PROMPT - 3))
    got, cache = model.prefill(pair["params"], cache, torch.from_numpy(prompt),
                               last_pos=PROMPT - 3)
    assert got.shape == want.shape == (b, 1, cfg.vocab_size)
    assert max_err(got.numpy(), want) <= TOL
    for tokens, cache_len in steps[1:]:
        want, ref_cache = ref_model.decode_step(pair["ref_params"], ref_cache,
                                                jnp.asarray(tokens), jnp.asarray(cache_len))
        got, cache = model.decode_step(pair["params"], cache, torch.from_numpy(tokens), cache_len)
        assert max_err(got.numpy(), want) <= TOL


def test_gqa_apply_without_cache_matches_reference(pair):
    """The cache-less path (keys are the call's own), on a local layer; for
    MLA the expanded (training) form the reference takes without a cache,
    held against the reference's blockwise ``impl="xla"`` attention (its
    interpret-mode prefill kernel takes one width for K and V, the
    expanded form two)."""
    cfg, ref_cfg = pair["cfg"], pair["ref_cfg"]
    x = np.random.default_rng(1).normal(0, 1, (2, PROMPT, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(PROMPT), (2, PROMPT))
    p_ref = ref_tf.per_layer_params(pair["ref_params"], ref_cfg)[0]["attn"]
    if cfg.mla:
        want, _ = ref_mla.mla_apply(p_ref, jnp.asarray(x),
                                    cfg=dataclasses.replace(ref_cfg, attn_impl="xla"),
                                    positions=jnp.asarray(pos), dtype=jnp.float32)
        got, cache = mla_layer.mla_apply(pair["params"]["layers"][0]["attn"], torch.from_numpy(x),
                                         cfg=cfg, positions=torch.from_numpy(pos.copy()),
                                         dtype=torch.float32)
        assert cache is None
        assert max_err(got.numpy(), want) <= TOL
        return
    kind = cfg.layer_kinds()[0]
    window = cfg.window if kind == "local" else None
    want, _ = ref_attn.gqa_apply(p_ref, jnp.asarray(x), cfg=ref_cfg, positions=jnp.asarray(pos),
                                 window=window, dtype=jnp.float32)
    got, cache = attention_layer.gqa_apply(
        pair["params"]["layers"][0]["attn"], torch.from_numpy(x), cfg=cfg,
        positions=torch.from_numpy(pos.copy()), window=window, dtype=torch.float32)
    assert cache is None
    assert max_err(got.numpy(), want) <= TOL


def test_configs_and_converted_gqa_trees(pair):
    """Configs are the reference's; the converted tree carries every leaf of
    the reference's per-layer tree (gemma2's pos0/pos1 groups and sandwich
    norms, qwen's QKV biases) unchanged."""
    cfg, ref_cfg = pair["cfg"], pair["ref_cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(dataclasses.replace(ref_cfg, attn_impl="xla"))
    full, ref_full = get_config(cfg.name[: -len("-smoke")]), ref_get_config(cfg.name[: -len("-smoke")])
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert full.param_count() == ref_full.param_count()
    ref_layers_p = ref_tf.per_layer_params(pair["ref_params"], ref_cfg)
    assert len(pair["params"]["layers"]) == len(ref_layers_p) == cfg.n_layers

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, tree

    for ours, theirs in zip(pair["params"]["layers"], ref_layers_p):
        got, want = dict(leaves(ours)), dict(leaves(theirs))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if cfg.qkv_bias:
        assert "b" in pair["params"]["layers"][0]["attn"]["wq"]
    if cfg.post_norms:
        assert "post_ln2" in pair["params"]["layers"][0]


def test_backends_accept_and_reject_configs():
    """lm_init builds GQA stacks, and recurrent, MoE and vlm stacks with
    the reference's parameter tree (same leaves, same shapes); the paged
    backend still rejects non-MLA stacks; an encdec config builds an
    EncDecModel, which lm_init refuses."""
    gemma = get_config("gemma2-2b", smoke=True)
    params = build_model(gemma).init(torch.Generator().manual_seed(0), "cpu")
    assert [set(p) >= {"ln1", "attn", "mlp", "post_ln1"} for p in params["layers"]] == [True] * 4
    with pytest.raises(ValueError, match="no MLA geometry"):
        tf.check_paged_compatible(gemma)

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from shapes(v, f"{prefix}/{k}")
        else:
            yield prefix, tuple(tree.shape)

    for new in (dict(layer_pattern=("recurrent",), d_inner=64),
                dict(n_experts=4, n_experts_active=2, d_ff_expert=32)):
        cfg = dataclasses.replace(gemma, **new)
        ours = tf.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu", dtype=torch.float32)
        ref_cfg = dataclasses.replace(ref_get_config("gemma2-2b", smoke=True), **new)
        theirs = ref_tf.per_layer_params(ref_tf.lm_init(jax.random.PRNGKey(0), ref_cfg), ref_cfg)
        assert len(ours["layers"]) == len(theirs) == cfg.n_layers
        for got, want in zip(ours["layers"], theirs):
            assert dict(shapes(got)) == dict(shapes(want))
        assert ("rec" if "d_inner" in new else "mlp") in ours["layers"][0]
        with pytest.raises(ValueError, match="no MLA geometry"):
            tf.check_paged_compatible(cfg)
    vlm, ref_vlm = get_config("qwen2-vl-7b", smoke=True), ref_get_config("qwen2-vl-7b", smoke=True)
    ours = tf.lm_init(torch.Generator().manual_seed(0), vlm, device="cpu", dtype=torch.float32)
    theirs = ref_tf.per_layer_params(ref_tf.lm_init(jax.random.PRNGKey(0), ref_vlm), ref_vlm)
    assert [dict(shapes(p)) for p in ours["layers"]] == [dict(shapes(p)) for p in theirs]
    assert "unembed" in ours and "b" in ours["layers"][0]["attn"]["wq"]
    encdec = get_config("seamless-m4t-medium", smoke=True)
    assert isinstance(build_model(encdec), EncDecModel)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tf.lm_init(torch.Generator().manual_seed(0), encdec, device="cpu", dtype=torch.float32)
