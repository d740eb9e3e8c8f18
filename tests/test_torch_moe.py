"""The port's MoE MLP (repro_torch.models.moe) against the JAX reference's,
on the CPU at fp32: the smoke ``qwen3-moe-30b-a3b`` and
``granite-moe-3b-a800m`` geometries (8 experts, top 2), the reference's
weights carried across, at token counts where the capacity drops tokens.
Output and aux loss within 1e-4 of the tensor's largest magnitude: both
sides route identically (fp32 router, the same stable dispatch) and add
each token's expert outputs in the same order; only the products'
summation order differs; the same at bf16 weights, where the expert
products must stay fp32 as the reference's do.  Then the reference's capacity semantics at the
model level: a bucketed prefill's pad tokens take capacity (logits within
2e-3 of the reference's, which padding moves), and an MLA + MoE stack
served paged gives the reference's tokens."""

import math

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.serve_loop import PagedServingSession as RefPaged
from repro_torch.configs import get_config
from repro_torch.convert import _tree_map, convert_params
from repro_torch.models import moe
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import PagedServingSession

TOL = 1e-4
LOGITS_TOL = 2e-3  # the dense path's model-level tolerance


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's Pallas kernels run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.  The alias
    is undone after each test, and so are the jit traces made under it."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def to_torch(tree):
    return _tree_map(lambda a: torch.from_numpy(np.array(np.asarray(a))), tree)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def max_err(a, b):
    """max |a - b| over max(1, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def dropped(cfg, params, x):
    """Token-expert pairs past capacity, counted from the routing."""
    n = x.shape[0] * x.shape[1]
    logits = x.reshape(n, -1).astype(np.float64) @ np.asarray(params["router"], np.float64)
    top = np.argsort(-logits, axis=1)[:, : cfg.n_experts_active]
    counts = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
    cap = max(math.ceil(n * cfg.n_experts_active / cfg.n_experts * cfg.capacity_factor), 1)
    return int(np.clip(counts - cap, 0, None).sum())


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("b,s", [(2, 24), (4, 1), (1, 8)])
def test_moe_apply_matches_reference(arch, b, s):
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    ref_params = ref_moe.moe_init(jax.random.PRNGKey(1), ref_cfg)
    # a skewed router (one expert favoured) so that tokens are dropped
    ref_params["router"] = ref_params["router"].at[:, 0].add(0.5)
    x = np.random.default_rng(2).normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_apply(ref_params, jnp.asarray(x), cfg=ref_cfg, dtype=jnp.float32)
    got, aux = moe.moe_apply(to_torch(ref_params), torch.from_numpy(x), cfg=cfg,
                             dtype=torch.float32)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= TOL
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))
    if b * s >= 8:
        assert dropped(cfg, ref_params, x) > 0  # the capacity cut some tokens


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("b,s", [(2, 24), (4, 1)])
def test_moe_apply_bf16_keeps_fp32_products(arch, b, s):
    """bf16 weights and compute dtype, fp32 activations: the reference's
    expert products write fp32 (``preferred_element_type``), and so must
    the port's, into ``silu(g) * u`` and the combine.  Both sides then
    agree to 1e-4 of the largest magnitude (8e-8 measured); products
    rounded to bf16 before the combine are 2.6e-3 to 2.9e-3 off."""
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    ref_params = ref_moe.moe_init(jax.random.PRNGKey(1), ref_cfg)
    ref_params["router"] = ref_params["router"].at[:, 0].add(0.5)
    ref_params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref_params)
    x = np.random.default_rng(2).normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_apply(ref_params, jnp.asarray(x), cfg=ref_cfg,
                                       dtype=jnp.bfloat16)
    params = _tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16),
                       ref_params)
    got, aux = moe.moe_apply(params, torch.from_numpy(x), cfg=cfg, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= TOL
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))


def test_moe_combine_is_deterministic_and_ordered():
    """Two calls give the same bits, and they equal a token-by-token
    definition: experts fill in token order up to capacity, and a token's
    kept expert outputs are summed in increasing expert order from zero."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu", dtype=torch.float32)
    p["router"][:, 3] += 0.5  # expert 3 overflows
    x = torch.randn((3, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    a, _ = moe.moe_apply(p, x, cfg=cfg, dtype=torch.float32)
    b, _ = moe.moe_apply(p, x, cfg=cfg, dtype=torch.float32)
    assert torch.equal(a, b)

    xf = x.reshape(-1, cfg.d_model)
    n, e, k = xf.shape[0], cfg.n_experts, cfg.n_experts_active
    top_w, top_i = torch.topk(torch.softmax(xf @ p["router"], -1), k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    cap = math.ceil(n * k / e * cfg.capacity_factor)
    filled, kept = [0] * e, {}
    for t in range(n):
        for j in range(k):
            ex = int(top_i[t, j])
            if filled[ex] < cap:
                filled[ex] += 1
                kept[t, ex] = top_w[t, j]
    assert max(filled) == cap and len(kept) < n * k
    want = torch.zeros_like(xf)
    for t in range(n):
        for ex in range(e):
            if (t, ex) in kept:
                h = torch.nn.functional.silu(xf[t] @ p["gate"][ex]) * (xf[t] @ p["up"][ex])
                want[t] = want[t] + kept[t, ex] * (h @ p["down"][ex])
    assert rel_err(a.reshape(n, -1).numpy(), want.numpy()) <= TOL


def test_moe_bucketed_prefill_keeps_the_references_capacity(pallas_interpret):
    """A 5-token prompt bucketed to 8: the 3 pad tokens take expert capacity
    (capacity from 8 tokens), which moves the last real position's logits
    in the reference; the port's bucketed prefill gives the reference's
    bucketed logits, not its exact-length ones."""
    ref_cfg = dataclasses.replace(ref_get_config("qwen3-moe-30b-a3b", smoke=True),
                                  attn_impl="pallas_interpret")
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    pair = dict(ref_params=ref_model.init(jax.random.PRNGKey(0)))
    pair["params"] = convert_params(pair["ref_params"], cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(2, cfg.vocab_size, size=5)
    padded = np.concatenate([prompt, np.zeros(3, prompt.dtype)])[None]
    logits = {}
    for name, toks in (("exact", prompt[None]), ("bucketed", padded)):
        want, _ = ref_model.prefill(pair["ref_params"], ref_model.init_cache(
            pair["ref_params"], 1, 64), jnp.asarray(toks, jnp.int32), last_pos=jnp.int32(4))
        got, _ = model.prefill(pair["params"], model.init_cache(pair["params"], 1, 64),
                               torch.from_numpy(toks), last_pos=4)
        assert max_err(got.numpy(), want) <= LOGITS_TOL, name
        logits[name] = np.asarray(want)
    moved = float(np.max(np.abs(logits["exact"] - logits["bucketed"])))
    print(f"bucketing moved the last real position's logits by {moved:.3f}; greedy token "
          f"{int(logits['exact'].argmax())} exact, {int(logits['bucketed'].argmax())} bucketed")
    assert moved > 100 * LOGITS_TOL, f"padding moved the logits by only {moved:.3e}"


def test_mla_moe_stack_serves_paged_like_the_reference(pallas_interpret):
    """An MLA + MoE stack (smoke deepseek-v2-mla with 8 experts, top 2)
    through both packages' PagedServingSession: the MoE branch of the
    post-attention half (``paged_layer_post``) gives the reference's
    greedy tokens, with its capacity from each prefill chunk's and decode
    step's own token count."""
    moe = dict(n_experts=8, n_experts_active=2, d_ff_expert=32)
    ref_cfg = dataclasses.replace(ref_get_config("deepseek-v2-mla", smoke=True), **moe)
    cfg = dataclasses.replace(get_config("deepseek-v2-mla", smoke=True), **moe)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = convert_params(ref_params, cfg, device="cpu")
    assert "router" in params["layers"][0]["mlp"]
    kw = dict(num_pages=24, page_size=16, block_k=32, prefill_chunk=16)
    ref = RefPaged(ref_model, ref_params, **kw)
    port = PagedServingSession(build_model(cfg), params, **kw)
    prompts = [np.random.default_rng(2).integers(2, cfg.vocab_size, size=n).tolist()
               for n in (5, 23)]
    for s in (ref, port):
        assert [s.add_request(p) for p in prompts] == [0, 1]
        for _ in range(4):
            s.step()
    assert port.outputs == ref.outputs


def test_wide_products_gradient_is_the_widened_products():
    """bf16 expert products with fp32 output have a gradient off the CPU
    (PyTorch has none for ``bmm(..., out_dtype=)``, so a MoE step on the
    card could not train): ``_WideProducts``' backward equals autograd's
    through the CPU's widened product, bit for bit."""
    rng = np.random.default_rng(0)
    a0 = torch.as_tensor(rng.normal(size=(3, 5, 8)).astype(np.float32)).bfloat16()
    b0 = torch.as_tensor(rng.normal(size=(3, 8, 4)).astype(np.float32)).bfloat16()
    g = torch.as_tensor(rng.normal(size=(3, 5, 4)).astype(np.float32))
    a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    y = moe._WideProducts.apply(a, b)
    y.backward(g)
    a2, b2 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    y2 = torch.bmm(a2.float(), b2.float())
    y2.backward(g)
    assert y.dtype == torch.float32 and torch.equal(y, y2)
    assert a.grad.dtype == torch.bfloat16 and torch.equal(a.grad, a2.grad)
    assert b.grad.dtype == torch.bfloat16 and torch.equal(b.grad, b2.grad)


def test_expert_products_differentiate_off_the_cpu():
    a = torch.empty(2, 4, 8, dtype=torch.bfloat16, device="meta", requires_grad=True)
    b = torch.empty(2, 8, 6, dtype=torch.bfloat16, device="meta", requires_grad=True)
    y = moe.expert_products(a, b)
    assert y.dtype == torch.float32 and y.shape == (2, 4, 6)
    y.sum().backward()
    assert a.grad.dtype == torch.bfloat16 and a.grad.shape == a.shape
    assert b.grad.dtype == torch.bfloat16 and b.grad.shape == b.shape


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m"])
def test_wide_products_gradient_matches_reference_grad(arch, monkeypatch):
    """The gradient a MoE train step takes on the card, where bf16 expert
    products go through ``_WideProducts``, run here on the CPU in the
    widened product's place: the expert weights', the router's and the
    input's gradients of ``sum(out * g) + aux`` equal ``jax.grad`` of the
    reference's bf16 MoE within 1e-4 of each tensor's largest magnitude
    (both sides round the weights' gradients to bf16: 5.2e-7 measured)."""
    monkeypatch.setattr(moe, "expert_products", lambda a, b: moe._WideProducts.apply(a, b))
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    ref_params = ref_moe.moe_init(jax.random.PRNGKey(1), ref_cfg)
    ref_params["router"] = ref_params["router"].at[:, 0].add(0.5)
    ref_params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref_params)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    g = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)

    def f(p, x):
        out, aux = ref_moe.moe_apply(p, x, cfg=ref_cfg, dtype=jnp.bfloat16)
        return jnp.sum(out * g) + aux

    want_p, want_x = jax.grad(f, argnums=(0, 1))(ref_params, jnp.asarray(x))
    params = _tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                       .requires_grad_(), ref_params)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(params, xt, cfg=cfg, dtype=torch.bfloat16)
    (torch.sum(out * torch.from_numpy(g)) + aux).backward()
    for k in ("gate", "up", "down", "router"):
        assert params[k].grad.dtype == torch.bfloat16
        assert rel_err(params[k].grad.float().numpy(), np.asarray(want_p[k], np.float32)) <= TOL, k
    assert rel_err(xt.grad.numpy(), want_x) <= TOL
