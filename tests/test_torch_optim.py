"""AdamW, clipping, the cosine schedule and gradient compression
(``repro_torch.optim``) against the JAX package's ``repro.optim``, on the
CPU; and the reference's weight-decay rule on its stacked tree.

Tolerances: AdamW steps on the same fp32 inputs within 1e-6 of each
leaf's largest magnitude (the same fp32 arithmetic; ``sqrt`` and ``pow``
may differ in the last place); the schedule within 1e-6 relative; bf16
and int8 compression bit for bit (int8 draws its rounding noise from
JAX's threefry keys, ``repro_torch.core.prng``; converted trees in
``test_torch_prng.py``), and int8 by its properties too: values on the
per-tensor grid, within one grid step of the input, reproducible from the
key, unbiased under error feedback.

The decay caveat the port reproduces: the reference decays by ``ndim >=
2`` on its tree, where every leaf of a scanned layer group is stacked
along a leading axis, so per-layer norm scales and biases are decayed;
only ``final_norm`` and the unscanned remainder layers escape.  The port
holds layers unstacked and decays by ``reference_decay_mask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch.configs import get_config
from repro_torch.convert import convert_opt_state, convert_params
from repro_torch.core import prng, tree
from repro_torch.optim import adamw, compression

STEP_TOL = 1e-6


def max_leaf_err(got_tree, want_tree) -> float:
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(tree.leaves(got_tree), tree.leaves(want_tree), strict=True))


# --------------------------------------------------------------------------- #
# AdamW (the reference's cases, then against the reference)
# --------------------------------------------------------------------------- #
def test_adamw_minimises_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor([2.0])}
    state = adamw.adamw_init(params)
    for _ in range(200):
        g = {k: 2 * v for k, v in params.items()}
        params, state, _ = adamw.adamw_update(g, state, params, lr=0.05, weight_decay=0.0)
    assert float(sum((v ** 2).sum() for v in params.values())) < 1e-2


def test_clip_by_global_norm():
    clipped, norm = adamw.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape_and_reference():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.cosine_schedule(s, **kw)) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)
    for s in [0, 1, 7, 10, 33, 99, 100, 150]:
        want = float(ref_adamw.cosine_schedule(jnp.int32(s), peak_lr=3e-4, warmup_steps=10,
                                               total_steps=100))
        got = float(adamw.cosine_schedule(s, peak_lr=3e-4, warmup_steps=10, total_steps=100))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_weight_decay_by_rank_by_default():
    params = {"w": torch.ones((2, 2)), "scale": torch.ones((2,))}
    zero = tree.tree_map(torch.zeros_like, params)
    new_p, _, _ = adamw.adamw_update(zero, adamw.adamw_init(params), params, lr=0.1,
                                     weight_decay=0.5, clip_norm=None)
    assert float(new_p["w"][0, 0]) < 1.0  # decayed
    assert float(new_p["scale"][0]) == 1.0  # not decayed


def random_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 4), "b": (4,), "deep": [{"m": (3, 5)}, {"m": (3, 5)}]}
    return tree.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes)


@pytest.mark.parametrize("clip_norm", [None, 1.0, 1e3])
def test_adamw_steps_match_reference(clip_norm):
    """Three steps from the same parameters and gradients: parameters,
    moments, count and metrics as the reference's."""
    p_np = random_tree(0)
    tp = tree.tree_map(torch.from_numpy, p_np)
    jp = tree.tree_map(jnp.asarray, p_np)
    ts, js = adamw.adamw_init(tp), ref_adamw.adamw_init(jp)
    for i in range(3):
        g_np = tree.tree_map(lambda x: x * (i + 1), random_tree(10 + i))
        tp, ts, tm = adamw.adamw_update(tree.tree_map(torch.from_numpy, g_np), ts, tp, lr=3e-2,
                                        clip_norm=clip_norm)
        jp, js, jm = ref_adamw.adamw_update(tree.tree_map(jnp.asarray, g_np), js, jp,
                                            lr=jnp.float32(3e-2), clip_norm=clip_norm)
    as_t = lambda t: tree.tree_map(lambda x: torch.from_numpy(np.array(x)), t)
    assert max_leaf_err(tp, as_t(jp)) < STEP_TOL
    assert max_leaf_err(ts.mu, as_t(js.mu)) < STEP_TOL
    assert max_leaf_err(ts.nu, as_t(js.nu)) < STEP_TOL
    assert int(ts.count) == int(js.count) == 3
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b", "seamless-m4t-medium"])
def test_one_step_decays_what_the_stacked_reference_decays(arch):
    """Reference caveat, both packages: one AdamW step with zero gradients
    on the reference's stacked tree decays every leaf of a scanned layer
    (norm scales and biases included: e.g. the first layer's ``ln1``
    scale) and leaves ``final_norm`` (and recurrentgemma's two unscanned
    remainder layers' norm scales) alone.  The port's step, with
    ``reference_decay_mask``, gives the same parameters."""
    ref_cfg = ref_get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    ref_params = jax.tree.map(  # norm scales start at 0: give every leaf a value to decay
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
        ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    zero = jax.tree.map(jnp.zeros_like, ref_params)
    ref_new, _, _ = ref_adamw.adamw_update(zero, ref_adamw.adamw_init(ref_params), ref_params,
                                           lr=jnp.float32(0.1), weight_decay=0.5)
    decayed = lambda new, old: bool(jnp.all(jnp.abs(new) < jnp.abs(old)))
    stack = "enc_layers" if arch == "seamless-m4t-medium" else "groups"
    first = (ref_new[stack]["ln1"]["scale"], ref_params[stack]["ln1"]["scale"]) if (
        stack == "enc_layers") else (ref_new["groups"]["pos0"]["ln1"]["scale"],
                                     ref_params["groups"]["pos0"]["ln1"]["scale"])
    assert first[0].ndim == 2 and decayed(*first)
    np.testing.assert_array_equal(ref_new["final_norm"]["scale"], ref_params["final_norm"]["scale"])
    for layer_new, layer_old in zip(ref_new.get("rem", []), ref_params.get("rem", [])):
        np.testing.assert_array_equal(layer_new["ln1"]["scale"], layer_old["ln1"]["scale"])

    cfg = get_config(arch, smoke=True)
    params = convert_params(ref_params, cfg, device="cpu")
    mask = adamw.reference_decay_mask(params, cfg)
    new, _, _ = adamw.adamw_update(tree.tree_map(torch.zeros_like, params),
                                   adamw.adamw_init(params), params, lr=0.1, weight_decay=0.5,
                                   decay=mask)
    want = convert_params(ref_new, cfg, device="cpu")
    assert max_leaf_err(new, want) < STEP_TOL
    layers_key = "enc_layers" if arch == "seamless-m4t-medium" else "layers"
    assert mask[layers_key][0]["ln1"]["scale"] is True and mask["final_norm"]["scale"] is False
    # the default rank rule on the unstacked tree would not decay them
    plain, _, _ = adamw.adamw_update(tree.tree_map(torch.zeros_like, params),
                                     adamw.adamw_init(params), params, lr=0.1, weight_decay=0.5)
    assert torch.equal(plain[layers_key][0]["ln1"]["scale"], params[layers_key][0]["ln1"]["scale"])


def test_optimizer_state_converts_from_reference():
    """The reference's AdamW state after a step, carried across by
    ``convert_opt_state``, equals the port's state after the same step."""
    ref_cfg = ref_get_config("qwen1.5-0.5b", smoke=True)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    g = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
                     ref_params)
    _, ref_state, _ = ref_adamw.adamw_update(g, ref_adamw.adamw_init(ref_params), ref_params,
                                             lr=jnp.float32(1e-3))
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    params = convert_params(ref_params, cfg, device="cpu")
    _, state, _ = adamw.adamw_update(convert_params(g, cfg, device="cpu"),
                                     adamw.adamw_init(params), params, lr=1e-3)
    got = convert_opt_state(ref_state, cfg, device="cpu")
    assert int(got.count) == int(state.count) == 1 and got.count.dtype == torch.int32
    assert max_leaf_err(got.mu, state.mu) < STEP_TOL
    assert max_leaf_err(got.nu, state.nu) < STEP_TOL


# --------------------------------------------------------------------------- #
# compression
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_error_feedback_unbiased(mode):
    params = {"w": torch.zeros((64,))}
    state = compression.compression_init(params, mode)
    g_true = torch.from_numpy(np.random.default_rng(0).normal(size=64).astype(np.float32)) * 1e-3
    total, n = torch.zeros(64), 50
    for i in range(n):
        gc, state = compression.compress_grads({"w": g_true}, state, mode=mode,
                                               rng=prng.fold_in(prng.prng_key(17), i))
        total = total + gc["w"]
    err = torch.linalg.norm(total - n * g_true) / torch.linalg.norm(n * g_true)
    assert float(err) < 0.05, float(err)


def test_bf16_compression_matches_reference():
    g_np = random_tree(3)
    params = tree.tree_map(torch.from_numpy, g_np)
    state = compression.compression_init(params, "bf16")
    jstate = ref_comp.compression_init(tree.tree_map(jnp.asarray, g_np), "bf16")
    for i in range(3):
        g = tree.tree_map(lambda x: x * (1 + i), random_tree(20 + i))
        gc, state = compression.compress_grads(tree.tree_map(torch.from_numpy, g), state,
                                               mode="bf16", rng=prng.prng_key(i))
        jgc, jstate = ref_comp.compress_grads(tree.tree_map(jnp.asarray, g), jstate, mode="bf16",
                                              rng=jax.random.PRNGKey(i))
        for a, b in zip(tree.leaves(gc), jax.tree.leaves(jgc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree.leaves(state.residual), jax.tree.leaves(jstate.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_compression_properties():
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(32, 16)).astype(np.float32))
    state = compression.compression_init({"w": g}, "int8")
    step_key = lambda step: prng.fold_in(prng.prng_key(17), step)
    out, new = compression.compress_grads({"w": g}, state, mode="int8", rng=step_key(7))
    scale = float(g.abs().max()) / 127.0
    q = out["w"] / scale
    assert torch.allclose(q, torch.round(q), atol=1e-4)  # on the per-tensor grid
    assert float((out["w"] - g).abs().max()) <= scale * (1 + 1e-5)  # within one step
    assert torch.equal(new.residual["w"], g - out["w"])  # error feedback
    again, _ = compression.compress_grads({"w": g}, state, mode="int8", rng=step_key(7))
    other, _ = compression.compress_grads({"w": g}, state, mode="int8", rng=step_key(8))
    assert torch.equal(again["w"], out["w"]) and not torch.equal(other["w"], out["w"])
    # the reference's draw from the same key, bit for bit
    jout, jnew = ref_comp.compress_grads(
        {"w": jnp.asarray(g.numpy())}, ref_comp.compression_init({"w": jnp.zeros((32, 16))}, "int8"),
        mode="int8", rng=jax.random.fold_in(jax.random.PRNGKey(17), 7))
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))
    np.testing.assert_array_equal(new.residual["w"].numpy(), np.asarray(jnew.residual["w"]))
    assert compression.compression_init({"w": g}, "none") is None
    with pytest.raises(ValueError, match="unknown compression mode"):
        compression.compression_init({"w": g}, "fp8")
