"""The training step (``repro_torch.runtime.train_loop.make_train_step``)
on the CPU, held against the JAX package's ``make_train_step``: one step,
gradient accumulation, strided microbatches, remat, compression, the
refusal of a serving tree.  The supervisor, the launcher and the
lifecycle train -> checkpoint -> restore -> serve are in
``test_torch_train_lifecycle.py``.

One step at fp32 compute from the reference's converted weights on the
same batch (``SyntheticLMData``, bit-equal to the reference's): loss
within 1e-5 relative, ``grad_norm`` within 1e-4 relative (measured
1.1e-5), the first moment (0.1 x the clipped gradient) within one bf16
step (2^-8) of each leaf's largest magnitude: attention's input gradients
are rounded to bf16 on both sides and a few of those roundings land one
step apart, noise that adds up towards the first layer (measured at most
2.6e-3, deepseek-v2-mla layer 0's ``w_uv``).  Adam's first step moves an
element by ``lr * g / (|g| + eps)``, about ``lr`` whatever ``|g|``, so an
element whose gradient is below that noise (the K bias's gradient, zero
in exact arithmetic: softmax ignores a shift of a row's scores) may move
the other way: the parameters are held within 2e-3 of each leaf's
largest magnitude where the reference's gradient exceeds the noise, and
within the step's size, ``2 lr``, everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.runtime import train_loop as ref_train_loop
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.compression import compression_init
from repro_torch.runtime.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

LOSS_TOL = 1e-5
GRAD_TOL = 2.0**-8
PARAM_TOL = 2e-3


def tiny(arch="qwen1.5-0.5b"):
    cfg = get_config(arch, smoke=True)
    return build_model(cfg), cfg


def data_for(cfg, batch=4, seq=32, seed=0):
    return SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed)


def state_of(model, seed=0):
    params, opt, _ = init_train_state(model, torch.Generator().manual_seed(seed), "cpu")
    return params, opt


def max_leaf_err(got_tree, want_tree) -> float:
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(tree.leaves(got_tree), tree.leaves(want_tree), strict=True))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-mla"])
def test_one_step_matches_reference(arch):
    ref_model = ref_build_model(ref_get_config(arch, smoke=True))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    tc = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20, remat=False)
    batch = data_for(ref_model.cfg).batch_at(0)
    ref_step = ref_train_loop.make_train_step(ref_model, ref_train_loop.TrainConfig(**tc))
    rp, ro, _, rm = ref_step(ref_params, ref_adamw.adamw_init(ref_params), None,
                             {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(3))
    model, cfg = tiny(arch)
    params = convert_params(ref_params, cfg, device="cpu")
    p, o, c, m = make_train_step(model, TrainConfig(**tc))(params, adamw_init(params), None,
                                                           batch, 3)
    assert c is None and int(o.count) == 1
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_TOL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-4)
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    ref_mu = convert_params(ro.mu, cfg, device="cpu")
    assert max_leaf_err(o.mu, ref_mu) < GRAD_TOL
    lr = float(rm["lr"])
    for a, b, mu in zip(tree.leaves(p), tree.leaves(convert_params(rp, cfg, device="cpu")),
                        tree.leaves(ref_mu), strict=True):
        d = (a - b).abs()
        resolved = mu.abs() > GRAD_TOL * mu.abs().max()
        assert float(d[resolved].max()) <= PARAM_TOL * float(b.abs().max())
        assert float(d.max()) <= 2 * lr * (1 + 1e-4)


def test_grad_accum_matches_full_batch():
    """Four strided microbatches give the full batch's loss and update."""
    model, cfg = tiny()
    params, opt = state_of(model)
    batch = data_for(cfg).batch_at(0)
    kw = dict(remat=False, clip_norm=None, warmup_steps=1)
    p1, _, _, m1 = make_train_step(model, TrainConfig(grad_accum=1, **kw))(
        params, opt, None, batch, 1)
    p4, _, _, m4 = make_train_step(model, TrainConfig(grad_accum=4, **kw))(
        params, adamw_init(params), None, batch, 1)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-3)
    assert max(float((a - b).abs().max())
               for a, b in zip(tree.leaves(p1), tree.leaves(p4))) < 5e-3


def test_microbatches_are_strided():
    """Microbatch m takes rows [m::a]: with a = batch, each microbatch is
    one row, and their mean loss is the strided rows' mean loss."""
    model, cfg = tiny()
    params, opt = state_of(model)
    batch = data_for(cfg, batch=4).batch_at(0)
    seen = []
    loss_of = model.loss

    def spy(p, b, **kw):
        seen.append(b["tokens"].numpy().copy())
        return loss_of(p, b, **kw)

    model.loss = spy
    make_train_step(model, TrainConfig(grad_accum=2, remat=False))(params, opt, None, batch, 1)
    np.testing.assert_array_equal(seen[0], batch["tokens"][0::2])
    np.testing.assert_array_equal(seen[1], batch["tokens"][1::2])


def test_train_loss_decreases():
    model, cfg = tiny()
    params, opt = state_of(model)
    step = make_train_step(model, TrainConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60,
                                              remat=False))
    data = data_for(cfg)
    losses, comp = [], None
    for s in range(30):
        params, opt, comp, m = step(params, opt, comp, data.batch_at(s % 4), s)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_remat_equals_no_remat():
    """Remat runs each layer again in the backward: the same arithmetic,
    the same loss and parameters bit for bit."""
    model, cfg = tiny()
    params, opt = state_of(model)
    batch = data_for(cfg).batch_at(1)
    out = [make_train_step(model, TrainConfig(remat=r, warmup_steps=1))(
        params, adamw_init(params), None, batch, 2) for r in (False, True)]
    assert float(out[0][3]["loss"]) == float(out[1][3]["loss"])
    for a, b in zip(tree.leaves(out[0][0]), tree.leaves(out[1][0])):
        assert torch.equal(a, b)


def test_remat_recomputes_each_layers_attention():
    """Under remat each layer's attention kernel runs twice a step (the
    forward and the backward's recompute), once without."""
    from repro_torch.kernels import flash_prefill

    model, cfg = tiny()
    params, opt = state_of(model)
    batch = data_for(cfg).batch_at(0)
    calls = []
    orig = flash_prefill._prefill_plain

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    flash_prefill._prefill_plain = counting
    try:
        for remat in (False, True):
            calls.clear()
            make_train_step(model, TrainConfig(remat=remat))(params, opt, None, batch, 0)
            assert len(calls) == cfg.n_layers * (2 if remat else 1)
    finally:
        flash_prefill._prefill_plain = orig


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_train_with_compression_and_remat(mode):
    model, cfg = tiny()
    params, opt = state_of(model)
    comp = compression_init(params, mode)
    step = make_train_step(model, TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=40,
                                              remat=True, compression=mode))
    data = data_for(cfg)
    losses = []
    for s in range(15):
        params, opt, comp, m = step(params, opt, comp, data.batch_at(s % 4), s)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert comp is not None and tree.leaves(comp.residual)


def test_serving_tree_is_refused_for_training():
    model, cfg = tiny()
    params = model.init(torch.Generator().manual_seed(0), "cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="table_f32"):
        make_train_step(model, TrainConfig())(params, adamw_init(params), None,
                                              data_for(cfg).batch_at(0), 0)


def test_base_and_amla_variants_agree_end_to_end():
    """Model-level logits with variant=base vs variant=amla agree."""
    import dataclasses

    cfg_a = get_config("qwen2.5-3b", smoke=True)
    cfg_b = dataclasses.replace(cfg_a, attn_variant="base")
    m_a, m_b = build_model(cfg_a), build_model(cfg_b)
    params = m_a.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg_a.vocab_size, (2, 24)))
    la = m_a.logits(params, m_a.forward(params, {"tokens": tokens}))
    lb = m_b.logits(params, m_b.forward(params, {"tokens": tokens}))
    assert float(torch.linalg.norm(la - lb) / torch.linalg.norm(lb)) < 1e-3
