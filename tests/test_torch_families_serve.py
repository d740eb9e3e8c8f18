"""The MoE, Mamba-2 and RG-LRU hybrid families (and internlm2's dense GQA)
through the port's dense ``ServingSession`` against the JAX reference's,
on the CPU at fp32: smoke ``qwen3-moe-30b-a3b``, ``granite-moe-3b-a800m``,
``mamba2-370m``, ``recurrentgemma-2b`` (7 layers: two (rec, rec, local)
groups and a recurrent remainder) and ``internlm2-20b``, with the
reference's weights carried across by ``repro_torch.convert`` and the
reference attending with ``attn_impl="pallas_interpret"``.

Every prefill's and decode step's logits agree within 2e-3 (relative to
the largest logit, at least 2e-3 absolute: the dense path's tolerance),
and the greedy tokens are equal, over ragged prompts (a 5-token MoE
prompt bucketed to 8, whose pad tokens take expert capacity as in the
reference; a 300-token prompt, past the SSM's 256-step chunk and the
hybrid's 32-key smoke window), an idle slot decoded between requests, a
finished slot reused and more requests than slots.  Also: decode against
the full forward, the configs and converted trees, and ``launch/serve
--arch`` on the dense cache.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.serve_loop import ServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import ServingSession

ARCHS = ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m", "mamba2-370m", "recurrentgemma-2b",
         "internlm2-20b"]
TOL = 2e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's Pallas kernels run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.  The alias
    is undone after each test, and so are the jit traces made under it."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def make_pair(arch):
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), attn_impl="pallas_interpret")
    cfg = get_config(arch, smoke=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_model=ref_model, ref_params=ref_params,
                model=build_model(cfg), params=convert_params(ref_params, cfg, device="cpu"))


def max_err(a, b):
    """max |a - b| over max(1, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def recorded(ref, port):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_session_matches_reference_session(pallas_interpret, arch):
    pair = make_pair(arch)
    cfg = pair["cfg"]
    ref = RefSession(pair["ref_model"], pair["ref_params"], batch_size=2, max_len=512)
    port = ServingSession(pair["model"], pair["params"], batch_size=2, max_len=512)
    seen = recorded(ref, port)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 300, 12)]
    for s in (ref, port):
        assert (s.add_request(prompts[0]), s.add_request(prompts[1])) == (0, 1)
        assert s.add_request(prompts[2]) is None  # more requests than slots
        for _ in range(3):
            s.step()
        s.finish(0)
        for _ in range(2):  # slot 0 idle: decoded all the same
            s.step()
        assert s.add_request(prompts[2]) == 2  # into the freed slot
        for _ in range(3):
            s.step()
    assert len(seen["port"]) == len(seen["ref"]) == 3 + 8
    for i, (got, want) in enumerate(zip(seen["port"], seen["ref"])):
        assert got.shape == want.shape
        assert max_err(got, want) <= TOL, f"call {i}"
    assert port.outputs == ref.outputs
    assert port.prefill_compiles == ref.prefill_compiles
    np.testing.assert_array_equal(port.cache_len, ref.cache_len)
    # buckets 8/512/16 for attention stacks, else the 3 exact lengths
    assert port.prefill_compiles == 3
    bucketed = set(cfg.layer_kinds()) <= {"global", "local"}
    assert port._bucket_len(5) == (8 if bucketed else 5)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_decode_matches_full_forward(arch):
    """Token-by-token decode against the full forward over the same tokens,
    at the reference's tolerance (``tests/test_models_smoke.py``: rtol =
    atol = 0.15); the largest difference is printed in the message."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    s = 12
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, s)))
    hidden, _, _ = tf.lm_apply(params, tokens, cfg=cfg)
    full = model.logits(params, hidden).numpy()
    cache = model.init_cache(params, 1, 32)
    steps = torch.cat([
        model.decode_step(params, cache, tokens[:, t : t + 1], np.asarray([t], np.int32))[0]
        for t in range(s)], 1).numpy()
    worst = float(np.max(np.abs(steps - full)))
    print(f"{arch}: max |decode - full forward| = {worst:.3e}")
    np.testing.assert_allclose(steps, full, rtol=0.15, atol=0.15,
                               err_msg=f"max |decode - full forward| = {worst:.3e}")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_converted_trees(arch):
    """The configs are the reference's (full and smoke, parameter counts
    too); the converted tree carries every leaf of the reference's
    per-layer tree unchanged (MoE stacks, ``rec.*``, ``ssm.*``, and
    recurrentgemma's remainder layer); a port-initialised tree has the
    same leaves and shapes."""
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    full, ref_full = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert full.param_count() == ref_full.param_count()
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(1))
    params = convert_params(ref_params, cfg, device="cpu")
    ref_layers = ref_tf.per_layer_params(ref_params, ref_cfg)
    fresh = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    assert len(params["layers"]) == len(ref_layers) == len(fresh["layers"]) == cfg.n_layers
    for ours, theirs, new in zip(params["layers"], ref_layers, fresh["layers"]):
        got, want, drawn = dict(leaves(ours)), dict(leaves(theirs)), dict(leaves(new))
        assert got.keys() == want.keys() == drawn.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            assert tuple(drawn[k].shape) == tuple(np.shape(want[k])), k
    n_params = sum(t.numel() for _, t in leaves(fresh) if not _.endswith("table_f32"))
    assert n_params == sum(np.size(a) for a in jax.tree.leaves(ref_params))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_dense_takes_the_new_archs(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                "--gen-len", "3", "--batch", "2", "--max-len", "64"])
    assert "served 3 requests" in capsys.readouterr().out
    if arch != "internlm2-20b":
        with pytest.raises(ValueError, match="no MLA geometry"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--cache", "paged"])
