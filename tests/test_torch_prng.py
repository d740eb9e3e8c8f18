"""Threefry keys and uniform draws (``repro_torch.core.prng``) and int8
gradient compression (``repro_torch.optim.compression``) against JAX and
the JAX package, bit for bit, on the CPU.

The port compresses the reference's leaves: its scanned layer groups
stacked (``groups/pos{j}``), the remainder layers and the top-level
leaves alone, in the reference's flattening order, with one key per leaf
split from the step's key.  So the compressed gradients and residuals of
a converted tree are the reference's, unstacked, bit for bit.  One int8
training step is held against the reference's at the fp32 tolerances of
``test_torch_train_loop.py`` (its first moment up to the quantizer's
grid flips, see the test).
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
from repro.runtime import train_loop as ref_train_loop
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core import prng, tree
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import compression
from repro_torch.optim.adamw import adamw_init, reference_leaves
from repro_torch.runtime.train_loop import TrainConfig, make_train_step

LOSS_TOL = 1e-5
GRAD_TOL = 2.0**-8


@pytest.mark.parametrize("seed", [0, 17, 123456789, 2**32 - 1, -1, 2**33 + 5])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 3, 2**31 + 7, 2**32 - 1])
def test_fold_in_matches_jax(data):
    want = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(17), data), 1)
    got = prng.fold_in(prng.fold_in(prng.prng_key(17), data), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num", [1, 2, 7, 300])
def test_split_matches_jax(num):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    tkey = prng.fold_in(prng.prng_key(5), 9)
    np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                  np.asarray(jax.random.split(key, num)))
    # a key split from a split key, as compress_grads' leaves are
    np.testing.assert_array_equal(prng.split(prng.split(tkey, num)[-1], 3).numpy(),
                                  np.asarray(jax.random.split(jax.random.split(key, num)[-1], 3)))


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 4), (300, 300), (2, 17, 33), (3, 96, 257)],
                         ids=str)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.5, 0.5)])
def test_uniform_matches_jax(shape, bounds):
    """Shapes past 2^16 elements and a 3-d stacked leaf included; the
    chunked hash (``prng._CHUNK``) is crossed with a small chunk."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), 4)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, *bounds))
    got = prng.uniform(prng.fold_in(prng.prng_key(17), 4), shape, *bounds)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_chunks_are_seamless(monkeypatch):
    key = prng.fold_in(prng.prng_key(3), 2)
    whole = prng.random_bits(key, (7, 1000))
    monkeypatch.setattr(prng, "_CHUNK", 999)
    assert torch.equal(prng.random_bits(key, (7, 1000)), whole)
    want = jax.random.bits(jax.random.fold_in(jax.random.PRNGKey(3), 2), (7, 1000), jnp.uint32)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(want).astype(np.int64))


def test_threefry_known_answer():
    """The Random123 known-answer vector of threefry2x32 (20 rounds)."""
    b1, b2 = prng.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert (b1, b2) == (0xC4923A9C, 0x483DF7A0)


# --------------------------------------------------------------------------- #
# compression over the reference's stacked leaves
# --------------------------------------------------------------------------- #
def random_grads_like(ref_params, seed):
    rng = np.random.default_rng(seed)
    scale = lambda i: 10.0 ** (i % 5 - 3)  # leaves of very different magnitudes
    leaves, treedef = jax.tree.flatten(ref_params)
    return treedef.unflatten([
        (rng.normal(size=np.shape(x)) * scale(i)).astype(np.float32) for i, x in enumerate(leaves)])


@pytest.mark.parametrize("arch", ["deepseek-v2-mla", "recurrentgemma-2b", "seamless-m4t-medium"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compress_grads_matches_reference_after_unstacking(arch, mode):
    """Two steps of error feedback on a converted smoke tree: scanned
    groups (and recurrentgemma's remainder layer, the encoder-decoder's
    vmapped layers) compressed as the reference's stacked leaves."""
    ref_cfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    jstate = ref_comp.compression_init(ref_params, mode)
    state = compression.compression_init(convert_params(ref_params, cfg, device="cpu"), mode)
    for step in range(2):
        g = random_grads_like(ref_params, 10 + step)
        jkey = jax.random.fold_in(jax.random.PRNGKey(17), step)
        jgc, jstate = ref_comp.compress_grads(jax.tree.map(jnp.asarray, g), jstate,
                                              mode=mode, rng=jkey)
        gc, state = compression.compress_grads(
            convert_params(g, cfg, device="cpu"), state, mode=mode, cfg=cfg,
            rng=prng.fold_in(prng.prng_key(17), step))
        for got, want in ((gc, jgc), (state.residual, jstate.residual)):
            want = convert_params(want, cfg, device="cpu")
            for a, b in zip(tree.leaves(got), tree.leaves(want), strict=True):
                assert torch.equal(a, b)


def test_reference_leaves_order_and_stacking():
    """recurrentgemma smoke: 7 layers of period 3 are two scanned groups
    (pos0..pos2 stacking layers j, j+3) and one remainder layer, in the
    reference's flattening order."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    ref_params = ref_build_model(ref_get_config("recurrentgemma-2b", smoke=True)).init(
        jax.random.PRNGKey(0))
    params = convert_params(ref_params, cfg, device="cpu")
    refs = reference_leaves(params, cfg)
    want = jax.tree.leaves(ref_params)
    assert len(refs) == len(want)
    flat = dict(tree.leaves_with_paths(params))
    for ref, w in zip(refs, want):
        got = torch.stack([flat[p] for p in ref.paths]) if ref.stacked else flat[ref.paths[0]]
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    layers = sorted({p[1] for ref in refs if ref.stacked for p in ref.paths})
    assert layers == list(range(6))
    assert {p[1] for ref in refs if not ref.stacked for p in ref.paths if p[0] == "layers"} == {6}


def test_int8_train_step_matches_reference():
    """One int8-compressed step from the reference's converted weights.

    The loss, the learning rate and the norm of the compressed gradients
    at the fp32 step's tolerances.  The gradients entering the quantizer
    differ from the reference's by bf16 roundings of attention's input
    gradients (``test_torch_train_loop.py``), and stochastic rounding
    turns an input difference of d at an element into one grid step
    (``max|e| / 127`` of the reference leaf) with probability about d /
    step: so the first moment is held within one bf16 step (2^-8) of the
    reference leaf's largest magnitude at all but 5% of the elements
    (measured: at most 2.3%, 3 of the 128 stacked ``ln1`` scales; 1.1%
    of the first layer's ``wk``), and those within
    one grid step more.  The parameters move within ``2 lr`` of the
    reference's everywhere."""
    arch = "qwen1.5-0.5b"
    ref_model = ref_build_model(ref_get_config(arch, smoke=True))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    tc = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20, remat=False, compression="int8")
    cfg = get_config(arch, smoke=True)
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                            seed=0).batch_at(0)
    ref_step = ref_train_loop.make_train_step(ref_model, ref_train_loop.TrainConfig(**tc))
    rp, ro, rc, rm = ref_step(ref_params, ref_adamw.adamw_init(ref_params),
                              ref_comp.compression_init(ref_params, "int8"),
                              {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(3))
    params = convert_params(ref_params, cfg, device="cpu")
    p, o, c, m = make_train_step(build_model(cfg), TrainConfig(**tc))(
        params, adamw_init(params), compression.compression_init(params, "int8"), batch, 3)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_TOL)
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-4)
    mu = dict(tree.leaves_with_paths(o.mu))
    ref_mu = dict(tree.leaves_with_paths(convert_params(ro.mu, cfg, device="cpu")))
    for ref in reference_leaves(params, cfg):
        got = torch.stack([mu[q] for q in ref.paths])
        want = torch.stack([ref_mu[q] for q in ref.paths])
        top = float(want.abs().max())
        d = (got - want).abs()
        assert float((d > GRAD_TOL * top).float().mean()) <= 0.05, ref.paths
        assert float(d.max()) <= top * (GRAD_TOL + 1 / 127), ref.paths
    lr = float(rm["lr"])
    for a, b in zip(tree.leaves(p), tree.leaves(convert_params(rp, cfg, device="cpu")),
                    strict=True):
        assert float((a - b).abs().max()) <= 2 * lr * (1 + 1e-4)
    assert len(reference_leaves(c.residual, cfg)) == len(jax.tree.leaves(rc.residual))
