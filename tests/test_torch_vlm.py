"""The vision-language family (qwen2-vl: M-RoPE and a stubbed vision tower)
in the port against the JAX reference, on the CPU at fp32: smoke
``qwen2-vl-7b`` (2 layers, 4/2 heads x 16, M-RoPE sections (2, 3, 3), 16
vision stub tokens) with the reference's weights carried across by
``repro_torch.convert`` and the reference attending with
``attn_impl="pallas_interpret"``.

Logits agree within 2e-3 of the largest logit (at least 2e-3 absolute:
the dense path's tolerance; attention rounds q, k, v and p to bf16 in
both packages) and greedy tokens are equal, for: ``mrope_positions``
(with and without vision, at offsets; exact), ``mrope`` (bit-equal to the
port's ``rope`` when t = h = w), ``gqa_apply`` with 3-D positions,
``LanguageModel.forward`` with ``vision_embeds``, the reference's vision
prefill (``launch/dryrun.lower_prefill``'s ``lm_apply`` over
``mrope_positions`` and ``embeds_override`` into a dense cache) followed by
greedy ``decode_step``s, including the position jump after it, and the
text-only ``ServingSession`` stream.  Also: decode against the full
forward, the configs and converted tree, the decode step through
``DenseDecodeStep`` and ``launch/serve --arch qwen2-vl-7b``.
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
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro.models import vlm as ref_vlm
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.serve_loop import ServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.launch import serve
from repro_torch.models import attention_layer as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models import vlm
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import ServingSession
from repro_torch.runtime.step_graph import DenseDecodeStep

ARCH = "qwen2-vl-7b"
TOL = 2e-3


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


def vision_embeds(cfg, b, seed):
    """Seeded patch embeddings at the reference tests' scale (x 0.02)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.vision_stub_tokens, cfg.d_model)) * 0.02).astype(
        np.float32)


# --------------------------------------------------------------------------- #
# positions and rotary embeddings
# --------------------------------------------------------------------------- #
POSITIONS = [
    # (batch, seq_len, n_vision, grid_hw, offset)
    pytest.param(2, 9, 0, None, None, id="text-only"),
    pytest.param(2, 24, 16, None, None, id="vision-16-square"),
    pytest.param(1, 20, 12, (3, 4), None, id="vision-grid-3x4"),
    pytest.param(3, 10, 7, None, None, id="vision-7-ragged-grid"),
    pytest.param(2, 1, 0, None, np.array([5, 260], np.int32), id="decode-offset-per-slot"),
    pytest.param(2, 24, 16, None, 3, id="vision-scalar-offset"),
]


@pytest.mark.parametrize("b,s,nv,grid,offset", POSITIONS)
def test_mrope_positions_match_reference(b, s, nv, grid, offset):
    want = np.asarray(ref_vlm.mrope_positions(
        b, s, nv, grid_hw=grid, offset=None if offset is None else jnp.asarray(offset)))
    for off in (offset, None if offset is None else torch.as_tensor(offset)):
        got = vlm.mrope_positions(b, s, nv, grid_hw=grid, offset=off, device="cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, b, s)
        np.testing.assert_array_equal(got.numpy(), want)


def test_mrope_positions_never_read_a_tensor_offset_back():
    """A tensor offset stays where it lies: a meta tensor (no data at all)
    gives meta positions, so nothing reads it back to the host (what a
    CUDA graph of the decode step needs); without a device the positions
    go to the card, which this machine lacks."""
    off = torch.zeros((4,), dtype=torch.int32, device="meta")
    pos = vlm.mrope_positions(4, 1, 0, offset=off)
    assert pos.device.type == "meta" and tuple(pos.shape) == (3, 4, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            vlm.mrope_positions(4, 1, 0)


def test_mrope_matches_reference_and_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    pos3 = ref_vlm.mrope_positions(2, 24, 16, offset=jnp.asarray([0, 7]))
    want = np.asarray(ref_layers.mrope(jnp.asarray(x), pos3, sections=(2, 3, 3), theta=1e6))
    got = layers.mrope(torch.from_numpy(x), torch.from_numpy(np.array(pos3)),
                       sections=(2, 3, 3), theta=1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    print(f"max |mrope port - reference| = {np.abs(got - want).max():.3e}")
    # t = h = w: M-RoPE is RoPE, bit for bit
    text = vlm.mrope_positions(2, 24, 0, offset=torch.tensor([3, 100]), device="cpu")
    xt = torch.from_numpy(x)
    assert torch.equal(layers.mrope(xt, text, sections=(2, 3, 3), theta=1e6),
                       layers.rope(xt, text[0], theta=1e6))
    with pytest.raises(ValueError, match="do not sum"):
        layers.mrope(xt, text, sections=(2, 3, 4))


@pytest.mark.parametrize("cached", [False, True], ids=["no-cache", "cache"])
def test_gqa_apply_with_mrope_positions(pallas_interpret, pair, cached):
    ref_cfg, cfg = pair["ref_cfg"], pair["cfg"]
    p_ref = ref_tf.per_layer_params(pair["ref_params"], ref_cfg)[0]["attn"]
    p = pair["params"]["layers"][0]["attn"]
    rng = np.random.default_rng(2)
    b, s = 2, 24
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos3 = np.asarray(ref_vlm.mrope_positions(b, s, 16))
    kw = {}
    ref_kw = {}
    if cached:
        ref_kw = dict(cache=ref_attn.init_kv_cache(ref_cfg, b, 32, jnp.float32),
                      cache_len=jnp.zeros((b,), jnp.int32))
        kw = dict(cache=attn.init_kv_cache(cfg, b, 32, dtype=torch.float32, device="cpu"),
                  cache_len=np.zeros((b,), np.int32))
    want, ref_cache = ref_attn.gqa_apply(p_ref, jnp.asarray(x), cfg=ref_cfg,
                                         positions=jnp.asarray(pos3), dtype=jnp.float32, **ref_kw)
    got, cache = attn.gqa_apply(p, torch.from_numpy(x), cfg=cfg, positions=torch.from_numpy(pos3),
                                dtype=torch.float32, **kw)
    assert max_err(got.numpy(), want) <= TOL
    if cached:  # the M-RoPE'd keys land in the port's (B, Hkv, S, Dh) rows
        np.testing.assert_allclose(cache["k"].transpose(1, 2)[:, :s].numpy(),
                                   np.asarray(ref_cache["k"])[:, :s], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def test_forward_with_vision_embeds_matches_reference(pallas_interpret, pair):
    cfg = pair["cfg"]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    vis = vision_embeds(cfg, 2, 3)
    ref_model, rp = pair["ref_model"], pair["ref_params"]
    want = np.asarray(ref_model.logits(rp, ref_model.forward(
        rp, {"tokens": jnp.asarray(tokens), "vision_embeds": jnp.asarray(vis)})[0]))
    model, p = pair["model"], pair["params"]
    got = model.logits(p, model.forward(
        p, {"tokens": torch.from_numpy(tokens).long(), "vision_embeds": torch.from_numpy(vis)}))
    assert max_err(got.numpy(), want) <= TOL
    # the patches do move the text logits: they are not ignored
    plain = model.logits(p, model.forward(p, {"tokens": torch.from_numpy(tokens).long()}))
    assert max_err(plain.numpy(), want) > 10 * TOL


def test_vision_prefill_then_decode_matches_reference(pallas_interpret, pair):
    """The reference's vision prefill (``dryrun.lower_prefill``): patches
    then text through ``lm_apply`` at ``mrope_positions(B, S, Nv)`` into a
    dense cache at ``cache_len`` 0, then greedy ``decode_step``s at
    ``cache_len`` S + i.  Every logit within tolerance, tokens equal; and
    the caveat both packages share: text sits at ``max(grid) + i``, but a
    decode step positions its token at ``cache_len``, Nv - max(grid)
    further on."""
    ref_cfg, cfg = pair["ref_cfg"], pair["cfg"]
    ref_model, rp, model, p = pair["ref_model"], pair["ref_params"], pair["model"], pair["params"]
    b, s, nv, max_len, steps = 2, 40, cfg.vision_stub_tokens, 64, 4
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    vis = vision_embeds(cfg, b, 4)

    pos_ref = ref_vlm.mrope_positions(b, s, nv)
    hidden, ref_cache, _ = ref_tf.lm_apply(
        rp, jnp.asarray(tokens), cfg=ref_cfg, positions=pos_ref,
        cache=ref_model.init_cache(None, b, max_len), cache_len=jnp.zeros((b,), jnp.int32),
        embeds_override=jnp.asarray(vis), dtype=jnp.float32)
    want = [np.asarray(ref_tf.lm_logits(rp, hidden[:, -1:], cfg=ref_cfg, dtype=jnp.float32))]

    cache = model.init_cache(p, b, max_len)
    hidden, _, _ = tf.lm_apply(p, torch.from_numpy(tokens).long(), cfg=cfg,
                               positions=vlm.mrope_positions(b, s, nv, device="cpu"), cache=cache,
                               cache_len=0, embeds_override=torch.from_numpy(vis))
    got = [model.logits(p, hidden[:, -1:])]
    ref_tok, tok = [], []
    for i in range(steps):
        ref_tok.append(np.asarray(jnp.argmax(want[-1][:, -1], -1)))
        tok.append(torch.argmax(got[-1][:, -1], -1))
        lens = np.full((b,), s + i, np.int32)
        logits, ref_cache = ref_model.decode_step(rp, ref_cache, jnp.asarray(ref_tok[-1])[:, None],
                                                  jnp.asarray(lens))
        want.append(np.asarray(logits))
        got.append(model.decode_step(p, cache, tok[-1][:, None], torch.from_numpy(lens))[0])
    for i, (g, w) in enumerate(zip(got, want)):
        assert max_err(g.numpy(), w) <= TOL, f"call {i}"
    np.testing.assert_array_equal(np.stack([t.numpy() for t in tok]), np.stack(ref_tok))

    grid = int(np.ceil(np.sqrt(nv)))
    last_text = vlm.mrope_positions(b, s, nv, device="cpu")[:, 0, -1]
    step_pos = model._positions({}, torch.zeros((b, 1), dtype=torch.int64),
                                cache_len=torch.full((b,), s, dtype=torch.int32))
    assert last_text.tolist() == [grid + s - nv - 1] * 3
    assert step_pos[:, 0, 0].tolist() == [s] * 3  # not grid + s - nv
    np.testing.assert_array_equal(
        step_pos.numpy(), np.asarray(ref_model._positions({}, jnp.zeros((b, 1), jnp.int32),
                                                          cache_len=jnp.full((b,), s))))


def record(ref, port):
    """Record every prefill's and decode step's logits of both sessions."""
    seen = {"ref": [], "port": []}
    prefill, decode = ref._prefill, ref._decode

    def ref_prefill(*a):
        out = prefill(*a)
        seen["ref"].append(np.asarray(out[0])[:, -1])
        return out

    def ref_decode(*a):
        out = decode(*a)
        seen["ref"].append(np.asarray(out[0])[:, -1])
        return out

    ref._prefill, ref._decode = ref_prefill, ref_decode
    port_prefill, run = port.model.prefill, port.step_graph.graphs.run

    def port_prefill_rec(*a, **k):
        out = port_prefill(*a, **k)
        seen["port"].append(out[0][:, -1].numpy())
        return out

    def port_run(*a, **k):
        out = run(*a, **k)
        seen["port"].append(out[:, -1].numpy())
        return out

    port.model.prefill, port.step_graph.graphs.run = port_prefill_rec, port_run
    return seen


def test_text_only_session_matches_reference_session(pallas_interpret, pair):
    """``ServingSession`` serves a vlm text-only, as the reference's does
    (M-RoPE with t = h = w from the slot's cache_len): ragged prompts of
    5 (bucket 8), 17 (past the 16 edge: bucket 32) and 12 tokens, an
    idle slot, a recycled slot, more requests than slots."""
    cfg = pair["cfg"]
    ref = RefSession(pair["ref_model"], pair["ref_params"], batch_size=2, max_len=64)
    port = ServingSession(build_model(cfg), pair["params"], batch_size=2, max_len=64)
    seen = record(ref, port)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 17, 12)]
    for s in (ref, port):
        assert (s.add_request(prompts[0]), s.add_request(prompts[1])) == (0, 1)
        assert s.add_request(prompts[2]) is None
        for _ in range(3):
            s.step()
        s.finish(0)
        for _ in range(2):
            s.step()
        assert s.add_request(prompts[2]) == 2
        for _ in range(3):
            s.step()
    assert len(seen["port"]) == len(seen["ref"]) == 3 + 8
    for i, (got, want) in enumerate(zip(seen["port"], seen["ref"])):
        assert got.shape == want.shape
        assert max_err(got, want) <= TOL, f"call {i}"
    assert port.outputs == ref.outputs
    assert port.prefill_compiles == ref.prefill_compiles == 3
    assert [port._bucket_len(n) for n in (5, 17, 12)] == [8, 32, 16]
    np.testing.assert_array_equal(port.cache_len, ref.cache_len)


def test_dense_decode_step_stages_mrope_positions(pair):
    """The graphed decode step (walked eagerly on the CPU over the same
    staged tensors) equals ``model.decode_step`` bit for bit: its M-RoPE
    positions come from the staged ``cache_len`` tensor."""
    cfg, model, p = pair["cfg"], pair["model"], pair["params"]
    b, max_len = 3, 32
    cache = model.init_cache(p, b, max_len)
    ref_cache = model.init_cache(p, b, max_len)
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 8)))
    model.prefill(p, cache, prompt)
    model.prefill(p, ref_cache, prompt)
    step = DenseDecodeStep(model, p, cache, b)
    last = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    lens = np.array([8, 5, 8], np.int32)
    got = step(last, lens)
    want, _ = model.decode_step(p, ref_cache, torch.from_numpy(last).long()[:, None],
                                torch.from_numpy(lens))
    assert torch.equal(got, want)
    assert step.state == []


def test_decode_matches_full_forward(pair):
    """Token-by-token decode against the full text-only forward, at the
    reference's tolerance (``tests/test_models_smoke.py``: rtol = atol =
    0.15); the largest difference is printed in the message."""
    cfg, model = pair["cfg"], pair["model"]
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    s = 12
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, s)))
    full = model.logits(params, model.forward(params, {"tokens": tokens})).numpy()
    cache = model.init_cache(params, 1, 32)
    steps = torch.cat([
        model.decode_step(params, cache, tokens[:, t : t + 1], np.asarray([t], np.int32))[0]
        for t in range(s)], 1).numpy()
    worst = float(np.max(np.abs(steps - full)))
    print(f"{ARCH}: max |decode - full forward| = {worst:.3e}")
    np.testing.assert_allclose(steps, full, rtol=0.15, atol=0.15,
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
    7.615 B parameters); the converted tree carries every leaf (GQA with
    QKV biases, an untied unembedding) unchanged; a port-initialised tree
    has the same leaves and shapes."""
    ref_cfg, cfg = ref_get_config(ARCH, smoke=True), pair["cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    full, ref_full = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert full.param_count() == ref_full.param_count() == 7_615_483_904
    ref_params = pair["ref_params"]
    ref_layers = ref_tf.per_layer_params(ref_params, ref_cfg)
    fresh = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    params = pair["params"]
    assert {"embed", "unembed", "final_norm", "layers"} == set(params) == set(fresh)
    for ours, theirs, new in zip(params["layers"], ref_layers, fresh["layers"]):
        got, want, drawn = dict(leaves(ours)), dict(leaves(theirs)), dict(leaves(new))
        assert got.keys() == want.keys() == drawn.keys()
        assert {"/attn/wq/b", "/attn/wk/b", "/attn/wv/b"} <= set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            assert tuple(drawn[k].shape) == tuple(np.shape(want[k])), k
    np.testing.assert_array_equal(params["unembed"]["table"].numpy(),
                                  np.asarray(ref_params["unembed"]["table"]))
    n_params = sum(t.numel() for k, t in leaves(fresh) if not k.endswith("table_f32"))
    assert n_params == sum(np.size(a) for a in jax.tree.leaves(ref_params))


def test_launch_serve_takes_qwen2_vl(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                "--gen-len", "3", "--batch", "2", "--max-len", "64"])
    assert "served 3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no MLA geometry"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cache", "paged"])
