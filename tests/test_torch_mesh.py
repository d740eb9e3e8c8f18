"""The port's mesh side on the CPU: meshes (``launch.mesh``), the mesh
context, the partition specs of every policy (``runtime.sharding``) held
against the JAX package's, placement on a one-rank ``DeviceMesh``, the
sharded train / serve step factories and elastic resharding.

The reference's spec functions read only ``mesh.shape[axis]``, so they are
called with a stand-in mesh of the production shapes (1 x 1, 16 x 16, 2 x
16 x 16) on ``jax.eval_shape`` trees, and the port's on its own shape tree
(meta tensors): every port leaf must get the spec of the reference leaf
that holds it, the reference's stacking axis dropped (the port keeps one
entry per layer).  Placement runs on a world-size-1 gloo process group on
a ``HashStore`` (no port opened), where a 1 x 1 mesh's local shard is the
whole tensor: the factories must be bit-equal to the unsharded calls.
"""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.configs import ASSIGNED, BONUS
from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime import sharding as ref_sharding
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import mesh as port_mesh
from repro_torch.models.attention_layer import init_kv_cache
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import adamw_init, reference_leaves
from repro_torch.optim.compression import compression_init
from repro_torch.runtime import elastic, mesh_ctx, serve_loop, sharding, train_loop

ARCHS = ASSIGNED + BONUS
POLICIES = ["tp_fsdp", "fsdp", "fsdp2d", "dp", "tp", "seqkv"]
MESHES = [{"data": 1, "model": 1}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]


@pytest.fixture(scope="module")
def group():
    """A world-size-1 gloo process group for this module (torn down after
    it, unless one existed before)."""
    made = not tdist.is_initialized()
    port_mesh.init_local_process_group("cpu")
    yield
    if made:
        tdist.destroy_process_group()


def stand_in(shape):
    return types.SimpleNamespace(shape=dict(shape))


@functools.lru_cache(maxsize=None)
def shape_trees(arch, smoke=True, batch=2, max_len=64):
    """(reference config, its params and cache as eval_shape trees (the
    cache in the port's (B, Hkv, S, Dh) layout), port config, its params
    and cache as meta tensors)."""
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=smoke), cache_layout="bhsd")
    cfg = get_config(arch, smoke=smoke)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_params = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    params = model.init(None, "meta", dtype=torch.float32)
    if cfg.family == "encdec":
        ss = 8
        src = jax.ShapeDtypeStruct((batch, ss, cfg.d_model), jax.numpy.float32)
        ref_cache = jax.eval_shape(lambda p, x: ref_model.init_cache(p, x, max_len),
                                   ref_params, src)
        cross = {k: torch.empty((batch, ss, cfg.n_heads, cfg.head_dim), device="meta")
                 for k in ("k", "v")}
        cache = {"self": [init_kv_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="meta")
                          for _ in range(cfg.n_layers)],
                 "cross": [dict(cross) for _ in range(cfg.n_layers)]}
    else:
        ref_cache = jax.eval_shape(lambda p: ref_model.init_cache(p, batch, max_len), ref_params)
        cache = model.init_cache(params, batch, max_len)
    return ref_cfg, ref_params, ref_cache, cfg, params, cache


def cache_leaves(cache, cfg):
    """[(port paths, stacked)] of each reference cache leaf, in its
    flattening order: the decoder-only stack as ``reference_leaves`` maps
    layers (``groups/pos{j}``, ``rem``), the encoder-decoder's ``cross`` and
    ``self`` stacked whole."""
    if cfg.family != "encdec":
        return [([p[1:] for p in r.paths], r.stacked)  # ("layers", i, ...) -> (i, ...)
                for r in reference_leaves({"layers": cache}, cfg)]
    return [([(key, i, name) for i in range(len(cache[key]))], True)
            for key in sorted(cache) for name in sorted(cache[key][0])]


def held(ref_fn, port_fn, ref_tree, leaf_map, port_tree):
    """Every port leaf's spec against its reference leaf's (stacking axis
    dropped, and the shapes checked to match); returns the leaves held."""
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    flat = dict(tree.leaves_with_paths(port_tree))
    assert len(ref_flat) == len(leaf_map)
    n = 0
    for (rpath, rleaf), (paths, stacked) in zip(ref_flat, leaf_map):
        want = tuple(ref_fn(rpath, rleaf))
        rshape = tuple(rleaf.shape)
        if stacked:
            want, rshape = want[1:], rshape[1:]
        for p in paths:
            assert tuple(flat[p].shape) == rshape, (p, rshape)
            assert tuple(port_fn(p, flat[p])) == want, (p, want)
            n += 1
    assert n == len(flat)
    return n


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, policy):
    ref_cfg, ref_params, _, cfg, params, _ = shape_trees(arch)
    leaf_map = [(r.paths, r.stacked) for r in reference_leaves(params, cfg)]
    for shape in MESHES:
        mp = "pod" in shape
        held(ref_sharding.param_spec_fn(stand_in(shape), multi_pod=mp, policy=policy, cfg=ref_cfg),
             sharding.param_spec_fn(stand_in(shape), multi_pod=mp, policy=policy, cfg=cfg),
             ref_params, leaf_map, params)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, policy):
    """Caches of batch 2 and 32 (batch over data, or the sequence fallback)
    and batches of 1 to 512 rows."""
    for batch in (2, 32):
        ref_cfg, _, ref_cache, cfg, _, cache = shape_trees(arch, batch=batch)
        for shape in MESHES:
            mp = "pod" in shape
            held(ref_sharding.cache_spec_fn(stand_in(shape), multi_pod=mp, policy=policy),
                 sharding.cache_spec_fn(stand_in(shape), multi_pod=mp, policy=policy),
                 ref_cache, cache_leaves(cache, cfg), cache)
    for shape in MESHES:
        mp = "pod" in shape
        ref_fn = ref_sharding.batch_spec_fn(stand_in(shape), multi_pod=mp, policy=policy)
        fn = sharding.batch_spec_fn(stand_in(shape), multi_pod=mp, policy=policy)
        for b in (1, 2, 16, 32, 512):
            leaf = jax.ShapeDtypeStruct((b, 64), jax.numpy.int32)
            assert tuple(fn(("tokens",), torch.empty((b, 64), device="meta"))) == tuple(
                ref_fn((), leaf))


@pytest.mark.parametrize("policy", POLICIES)
def test_full_width_deepseek_specs_at_multi_pod(policy):
    """deepseek-v2-mla at its published widths on the 2 x 16 x 16 mesh:
    the reference's shapes from ``jax.eval_shape``, the port's from its
    meta tree; parameters, and a 128 x 32768 cache."""
    ref_cfg, ref_params, ref_cache, cfg, params, cache = shape_trees(
        "deepseek-v2-mla", smoke=False, batch=128, max_len=32768)
    shape = MESHES[2]
    held(ref_sharding.param_spec_fn(stand_in(shape), multi_pod=True, policy=policy, cfg=ref_cfg),
         sharding.param_spec_fn(stand_in(shape), multi_pod=True, policy=policy, cfg=cfg),
         ref_params, [(r.paths, r.stacked) for r in reference_leaves(params, cfg)], params)
    held(ref_sharding.cache_spec_fn(stand_in(shape), multi_pod=True, policy=policy),
         sharding.cache_spec_fn(stand_in(shape), multi_pod=True, policy=policy),
         ref_cache, cache_leaves(cache, cfg), cache)


def test_serving_table_copy_takes_the_table_spec():
    """A serving tree's fp32 unembedding copy (no reference leaf) is
    sharded as the table it copies."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    params = build_model(cfg).init(None, "meta", dtype=torch.bfloat16)
    fn = sharding.param_spec_fn(stand_in(MESHES[1]), multi_pod=False, cfg=cfg)
    emb = params["embed"]
    assert fn(("embed", "table_f32"), emb["table_f32"]) == fn(("embed", "table"), emb["table"])


def test_mesh_shapes_and_names():
    debug = port_mesh.make_debug_mesh("cpu")
    assert debug.shape == {"data": 1, "model": 1} and debug.axis_names == ("data", "model")
    prod = port_mesh.make_production_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    multi = port_mesh.make_production_mesh(multi_pod=True, device="cpu")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert all(d == torch.device("cpu") for d in multi.devices.flat)
    logical = port_mesh.logical_mesh({"data": 1, "model": 4}, "cpu")
    assert logical.shape == {"data": 1, "model": 4}
    if not torch.cuda.is_available():
        for make in (port_mesh.make_debug_mesh, port_mesh.make_production_mesh):
            with pytest.raises(RuntimeError, match="needs CUDA"):
                make()


def test_placement_needs_a_group_of_the_mesh_size(group):
    """The production mesh is a layout at world size 1: placing on it, and
    a train step over it, raise; the debug mesh gives its DeviceMesh, made
    once."""
    prod = port_mesh.make_production_mesh(device="cpu")
    t = torch.arange(32.0).reshape(16, 2)
    with pytest.raises(RuntimeError, match="world size 256"):
        sharding.place(t, sharding.NamedSharding(prod, sharding.P("data", None)))
    debug = port_mesh.make_debug_mesh("cpu")
    dm = debug.device_mesh()
    assert dm.mesh_dim_names == ("data", "model") and tuple(dm.shape) == (1, 1)
    assert debug.device_mesh() is dm
    model = build_model(get_config("qwen1.5-0.5b", smoke=True))
    like = model.init(None, "meta", dtype=torch.float32)
    compile_for, _ = train_loop.jit_train_step(model, train_loop.TrainConfig(), prod, like)
    with pytest.raises(RuntimeError, match="world size 256"):
        compile_for({"tokens": np.zeros((16, 8))})(None, None, None, {}, 0)


@pytest.mark.parametrize("spec", [("data", "model"), (("data", "model"), None), (None, None),
                                  ("model", None)])
def test_place_round_trip_is_exact(group, spec):
    """A spec's placements (``Shard(i)`` where a mesh axis names dim i) on
    the 1 x 1 mesh: the local shard is the tensor itself (no copy), its
    full value equal bit for bit; a value-preserving constraint moves no
    value."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = port_mesh.make_debug_mesh("cpu")
    t = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    sh = sharding.NamedSharding(mesh, sharding.P(*spec))
    d = sharding.place(t, sh)
    want = [Shard(spec.index(ax)) if ax in spec else
            next((Shard(i) for i, e in enumerate(spec) if isinstance(e, tuple) and ax in e),
                 Replicate()) for ax in ("data", "model")]
    assert list(d.placements) == want
    assert d.to_local().data_ptr() == t.data_ptr() and torch.equal(d.full_tensor(), t)
    other = sharding.NamedSharding(mesh, sharding.P(None, "model"))
    assert torch.equal(sharding.with_sharding_constraint(d, other).full_tensor(), t)
    assert sharding.with_sharding_constraint(t, other) is t


def test_mesh_ctx_sets_and_restores():
    mesh = port_mesh.make_debug_mesh("cpu")
    assert mesh_ctx.current_mesh() is None and mesh_ctx.current_policy() == "tp_fsdp"
    with mesh_ctx.mesh_ctx(mesh, "seqkv"):
        assert mesh_ctx.current_mesh() is mesh and mesh_ctx.current_policy() == "seqkv"
        assert mesh_ctx.data_axes_in_ctx() == ("data",)
        with mesh_ctx.mesh_ctx(mesh, "fsdp", multi_pod=True):
            assert mesh_ctx.data_axes_in_ctx() == ("pod", "data")
        assert mesh_ctx.current_policy() == "seqkv"
    assert mesh_ctx.current_mesh() is None
    mesh_ctx.set_mesh_ctx(mesh, "tp")
    assert mesh_ctx.current_policy() == "tp"
    mesh_ctx.clear_mesh_ctx()
    assert mesh_ctx.current_mesh() is None and mesh_ctx.current_policy() == "tp_fsdp"


def tiny_state(arch="qwen1.5-0.5b"):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params, opt, _ = train_loop.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    return model, cfg, params, opt


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_jit_train_step_equals_make_train_step(group, compression):
    """One step through ``jit_train_step`` on the 1 x 1 mesh is bit-equal
    to ``make_train_step``'s (``test_runtime.py``'s finite loss too)."""
    model, cfg, params, opt = tiny_state()
    comp = compression_init(params, compression)
    tc = train_loop.TrainConfig(remat=False, compression=compression)
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                            seed=0).batch_at(0)
    mesh = port_mesh.make_debug_mesh("cpu")
    like = model.init(None, "meta", dtype=torch.float32)
    compile_for, sh = train_loop.jit_train_step(model, tc, mesh, like, donate=False)
    assert set(sh) == {"params", "opt", "comp", "batch_fn"}
    assert (sh["comp"] is None) == (compression == "none")
    got = compile_for(batch)(params, opt, comp, batch, 0)
    want = train_loop.make_train_step(model, tc)(params, adamw_init(params),
                                                  compression_init(params, compression),
                                                  batch, 0)
    assert np.isfinite(float(got[3]["loss"]))
    for a, b in zip(tree.leaves(got), tree.leaves(want), strict=True):
        assert torch.equal(a, b)


def test_jit_serve_fns_equal_the_models_calls(group):
    """Prefill and decode through ``jit_serve_fns`` on the 1 x 1 mesh:
    logits and caches bit-equal to ``model.prefill`` / ``decode_step``."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 6)))
    nxt = torch.tensor([[7], [9]])
    mesh = port_mesh.make_debug_mesh("cpu")
    caches = [model.init_cache(params, 2, 16) for _ in range(2)]
    compile_prefill, compile_decode, sh = serve_loop.jit_serve_fns(
        model, mesh, model.init(None, "meta"), caches[0], policy="seqkv")
    assert set(sh) == {"params", "cache"}
    assert tuple(sh["cache"][0]["k"].spec) == ("data", None, "model", None)
    got = [compile_prefill(tokens)(params, caches[0], tokens),
           compile_decode(nxt)(params, caches[0], nxt, np.int32(6))]
    want = [model.prefill(params, caches[1], tokens), model.decode_step(params, caches[1], nxt,
                                                                        np.int32(6))]
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])
    for a, b in zip(tree.leaves(caches[0]), tree.leaves(caches[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["tp", "tp_fsdp"])
def test_jit_serve_fns_serve_an_encoder_decoder(group, policy):
    """``jit_serve_fns`` of an ``EncDecModel`` (no ``prefill``) on the 1 x 1
    mesh: it returns; its decode of the target prompt at ``cache_len`` 0
    and of one token after it, over the caller's ``init_cache``, is
    bit-equal to ``decode_step``'s, logits and caches; its
    ``compile_prefill`` raises at use, naming the serving form, as the
    reference's fails only when traced."""
    cfg = get_config("seamless-m4t-medium", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    src = torch.from_numpy((rng.standard_normal((2, 10, cfg.d_model)) * 0.02).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 6)))
    nxt = torch.tensor([[7], [9]])
    caches = [model.init_cache(params, src, 16) for _ in range(2)]
    mesh = port_mesh.make_debug_mesh("cpu")
    compile_prefill, compile_decode, sh = serve_loop.jit_serve_fns(
        model, mesh, model.init(None, "meta"), caches[0], policy=policy)
    assert set(sh) == {"params", "cache"}
    zeros, six = np.zeros((2,), np.int32), np.full((2,), 6, np.int32)
    got = [compile_decode(prompt)(params, caches[0], prompt, zeros),
           compile_decode(nxt)(params, caches[0], nxt, six)]
    want = [model.decode_step(params, caches[1], prompt, zeros),
            model.decode_step(params, caches[1], nxt, six)]
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])
    for a, b in zip(tree.leaves(caches[0]), tree.leaves(caches[1]), strict=True):
        assert torch.equal(a, b)
    prefill = compile_prefill(prompt)
    with pytest.raises(ValueError, match=r"init_cache.*decode_step"):
        prefill(params, caches[0], prompt)


def test_reshard_train_state_preserves_values(group):
    """``test_runtime.py``'s elastic case: 1 x 1 -> 1 x 1, every leaf
    bit-equal, placed by the new mesh's specs."""
    model, cfg, params, opt = tiny_state()
    mesh_a, mesh_b = port_mesh.make_debug_mesh("cpu"), port_mesh.make_debug_mesh("cpu")
    p2, o2 = elastic.reshard_train_state(params, opt, mesh_a, mesh_b)
    for a, b in zip(tree.leaves((params, opt)), tree.leaves((p2, o2)), strict=True):
        assert torch.equal(b.to_local(), a) and torch.equal(b.full_tensor(), a)
    again, _ = elastic.reshard_train_state(p2, o2, mesh_b, mesh_a)
    for a, b in zip(tree.leaves(params), tree.leaves(again)):
        assert torch.equal(b.to_local(), a)
