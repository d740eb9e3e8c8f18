"""The training loss: ``layers.chunked_cross_entropy`` and
``LanguageModel.loss`` / ``EncDecModel.loss`` of every architecture
against the JAX package, on the CPU at smoke size, fp32, with the
reference's weights carried across by ``convert_params``.

Tolerances (fp32): the cross-entropy within 1e-5 relative (a sum of
logsumexps in another order); the model losses within 1e-5 relative
(attention rounds the same products to bf16 on both sides: measured
below 1e-6); gradients within 2e-3 of each leaf's largest magnitude
(attention's input gradients are rounded to bf16 on both sides, and a
few of those roundings land one bf16 step, 2^-8 to 2^-7 of an element,
apart: measured at most 1.5e-3, on qwen1.5-0.5b's K projection, below
1e-3 elsewhere).

qwen1.5-0.5b (dense GQA with QKV bias), deepseek-v2-mla (the expanded MLA
form) and granite-moe-3b-a800m (with the MoE aux loss) hold loss and
gradients against JAX; the other eight hold the loss value and give
finite gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import convert_params
from repro_torch.core import tree
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import MOE_AUX_COEF, build_model

LOSS_TOL = 1e-5
GRAD_TOL = 2e-3
GRAD_ARCHS = ["qwen1.5-0.5b", "deepseek-v2-mla", "granite-moe-3b-a800m"]
LOSS_ARCHS = sorted(set(REGISTRY) - set(GRAD_ARCHS))


# --------------------------------------------------------------------------- #
# chunked cross-entropy
# --------------------------------------------------------------------------- #
def direct_ce(table, hidden, labels):
    logits = hidden @ table.T
    lse = torch.logsumexp(logits, -1)
    lab = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    valid = labels >= 0
    return torch.where(valid, lse - lab, 0.0).sum() / valid.sum().clamp_min(1)


def ce_inputs(seed, b=2, s=16, d=8, v=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(v, d)).astype(np.float32), rng.normal(size=(b, s, d)).astype(np.float32),
            rng.integers(-1, v, size=(b, s)).astype(np.int32))


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 17, 99])
def test_chunked_ce_equals_direct_and_reference(n_chunks, seed):
    table, hidden, labels = ce_inputs(seed)
    got = layers.chunked_cross_entropy({"table": torch.from_numpy(table)}, torch.from_numpy(hidden),
                                       torch.from_numpy(labels).long(), n_chunks=n_chunks,
                                       dtype=torch.float32)
    want = ref_layers.chunked_cross_entropy({"table": jnp.asarray(table)}, jnp.asarray(hidden),
                                            jnp.asarray(labels), n_chunks=n_chunks,
                                            dtype=jnp.float32)
    direct = direct_ce(*(torch.from_numpy(x) for x in (table, hidden)),
                       torch.from_numpy(labels).long())
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    assert float(got) == pytest.approx(float(direct), rel=LOSS_TOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_chunked_ce_gradients_match_reference(softcap):
    """Gradients reach both the hidden states and the table, as JAX's."""
    table, hidden, labels = ce_inputs(5, s=32)
    t, h = (torch.from_numpy(x).requires_grad_() for x in (table, hidden))
    loss = layers.chunked_cross_entropy({"table": t}, h, torch.from_numpy(labels).long(),
                                        n_chunks=4, softcap=softcap, dtype=torch.bfloat16)
    loss.backward()
    f = lambda t, h: ref_layers.chunked_cross_entropy(
        {"table": t}, h, jnp.asarray(labels), n_chunks=4, softcap=softcap, dtype=jnp.bfloat16)
    want_loss, (gt, gh) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(table),
                                                                 jnp.asarray(hidden))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    for g, w in ((t.grad, gt), (h.grad, gh)):
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)) <= GRAD_TOL * np.max(np.abs(w))
    assert float(h.grad.abs().sum()) > 0


def test_chunked_ce_keeps_one_chunk_of_logits():
    """Under autograd each chunk is checkpointed: no saved tensor holds
    more than one chunk's logits (B x S/n x V), where an unchunked loss
    keeps all of them."""
    table, hidden, labels = ce_inputs(3, b=2, s=64, d=8, v=512)
    t, h = (torch.from_numpy(x).requires_grad_() for x in (table, hidden))
    sizes = []

    def pack(x):
        sizes.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = layers.chunked_cross_entropy({"table": t}, h, torch.from_numpy(labels).long(),
                                            n_chunks=8, dtype=torch.float32)
    loss.backward()
    assert max(sizes) <= 2 * 8 * 512 and h.grad is not None
    sizes.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        direct_ce(t, h, torch.from_numpy(labels).long())
    assert max(sizes) >= 2 * 64 * 512


# --------------------------------------------------------------------------- #
# model losses of every family
# --------------------------------------------------------------------------- #
def family_batch(cfg, seed=0, b=2, s=32):
    """Tokens and next-token labels (the last ignored), plus a vlm's patch
    embeddings or an encoder-decoder's frame embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(size=(b, cfg.vision_stub_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(size=(b, 24, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v))
            for k, v in batch.items()}


def with_grads(params):
    return tree.tree_map(lambda p: p.detach().requires_grad_(), params)


def setup(arch):
    ref_model = ref_build_model(ref_get_config(arch, smoke=True))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    return ref_model, ref_params, build_model(cfg), cfg


def max_leaf_err(got_tree, want_tree) -> float:
    """Largest of each leaf's max |got - want| over its max |want|."""
    errs = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for g, w in zip(tree.leaves(got_tree), tree.leaves(want_tree), strict=True)]
    return max(errs)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    ref_model, ref_params, model, cfg = setup(arch)
    batch = family_batch(cfg)
    want, ref_grads = jax.value_and_grad(ref_model.loss)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = with_grads(convert_params(ref_params, cfg, device="cpu"))
    loss = model.loss(params, torch_batch(batch))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_TOL)
    grads = tree.tree_map(lambda p: p.grad, params)
    assert max_leaf_err(grads, convert_params(ref_grads, cfg, device="cpu")) < GRAD_TOL


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_matches_reference_and_gradients_are_finite(arch):
    ref_model, ref_params, model, cfg = setup(arch)
    batch = family_batch(cfg)
    want = ref_model.loss(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = with_grads(convert_params(ref_params, cfg, device="cpu"))
    loss = model.loss(params, torch_batch(batch))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_TOL)
    grads = [p.grad for p in tree.leaves(params)]
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    assert sum(g is not None and float(g.abs().sum()) > 0 for g in grads) > len(grads) // 2


def test_moe_aux_loss_matches_reference():
    """``lm_apply`` returns the summed MoE aux loss, the reference's; the
    loss adds ``MOE_AUX_COEF`` times it."""
    ref_model, ref_params, model, cfg = setup("granite-moe-3b-a800m")
    tokens = family_batch(cfg)["tokens"]
    _, _, want = ref_tf.lm_apply(ref_params, jnp.asarray(tokens), cfg=ref_model.cfg,
                                 dtype=jnp.float32)
    params = convert_params(ref_params, cfg, device="cpu")
    _, _, aux = tf.lm_apply(params, torch.from_numpy(tokens).long(), cfg=cfg)
    assert float(aux) == pytest.approx(float(want), rel=1e-5) and float(aux) > 0
    assert MOE_AUX_COEF == 0.01
    _, _, dense_aux = tf.lm_apply(convert_params(setup("qwen1.5-0.5b")[1],
                                                 get_config("qwen1.5-0.5b", smoke=True),
                                                 device="cpu"),
                                  torch.from_numpy(tokens % 512).long(),
                                  cfg=get_config("qwen1.5-0.5b", smoke=True))
    assert dense_aux == 0.0


def test_serving_forward_keeps_its_signature():
    """``forward`` returns the hidden states alone, and serving records
    nothing: no parameter needs a gradient there."""
    _, ref_params, model, cfg = setup("qwen1.5-0.5b")
    params = convert_params(ref_params, cfg, device="cpu")
    hidden = model.forward(params, torch_batch(family_batch(cfg)))
    assert isinstance(hidden, torch.Tensor) and hidden.shape == (2, 32, cfg.d_model)
    assert hidden.grad_fn is None
