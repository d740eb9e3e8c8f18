"""The port's RG-LRU block (repro_torch.models.recurrent) against the JAX
reference's, on the CPU at fp32 with the smoke ``recurrentgemma-2b``
widths and the reference's weights carried across: the doubling scan
against ``jax.lax.associative_scan``, the causal conv, and the block at
S = 1 (a decode step) and S = 300 from a nonzero state, output and new
cache within 1e-4 of the tensor's largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import recurrent as ref_rec
from repro_torch.configs import get_config
from repro_torch.convert import _tree_map
from repro_torch.models import recurrent

TOL = 1e-4


def to_torch(tree):
    return _tree_map(lambda a: torch.from_numpy(np.array(np.asarray(a))), tree)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("s", [1, 2, 5, 300])
def test_scan_and_conv_match_reference(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 24)).astype(np.float32)
    b = rng.normal(0, 1, (2, s, 24)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, 24)).astype(np.float32)
    want = ref_rec._rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = recurrent.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    assert rel_err(got.numpy(), want) <= TOL
    w = rng.normal(0, 0.5, (4, 24)).astype(np.float32)
    bias = rng.normal(0, 0.5, (24,)).astype(np.float32)
    state = rng.normal(0, 1, (2, 3, 24)).astype(np.float32)
    for st in (None, state):
        want = ref_rec._causal_conv(jnp.asarray(b), jnp.asarray(w), jnp.asarray(bias),
                                    None if st is None else jnp.asarray(st))
        got = recurrent.causal_conv(torch.from_numpy(b), torch.from_numpy(w),
                                    torch.from_numpy(bias),
                                    None if st is None else torch.from_numpy(st))
        for g, w_ in zip(got, want):
            assert rel_err(g.numpy(), w_) <= TOL


@pytest.mark.parametrize("s", [1, 300])
def test_rglru_block_matches_reference(s):
    ref_cfg = ref_get_config("recurrentgemma-2b", smoke=True)
    cfg = get_config("recurrentgemma-2b", smoke=True)
    ref_params = ref_rec.rglru_block_init(jax.random.PRNGKey(4), ref_cfg)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, s, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, cfg.d_inner)).astype(np.float32)
    conv = rng.normal(0, 1, (2, cfg.conv_width - 1, cfg.d_inner)).astype(np.float32)
    want, want_cache = ref_rec.rglru_block_apply(
        ref_params, jnp.asarray(x), cfg=ref_cfg,
        cache={"h": jnp.asarray(h0), "conv": jnp.asarray(conv)}, dtype=jnp.float32)
    cache = recurrent.init_rglru_cache(cfg, 2, device="cpu")
    cache["h"].copy_(torch.from_numpy(h0))
    cache["conv"].copy_(torch.from_numpy(conv))
    h_buf, conv_buf = cache["h"], cache["conv"]
    got, out_cache = recurrent.rglru_block_apply(to_torch(ref_params), torch.from_numpy(x),
                                                 cfg=cfg, cache=cache, dtype=torch.float32)
    assert out_cache["h"] is h_buf and out_cache["conv"] is conv_buf  # written in place
    assert rel_err(got.numpy(), want) <= TOL
    for k in ("h", "conv"):
        assert rel_err(cache[k].numpy(), want_cache[k]) <= TOL, k
    # without a cache: the zero state
    want0, _ = ref_rec.rglru_block_apply(ref_params, jnp.asarray(x), cfg=ref_cfg,
                                         dtype=jnp.float32)
    got0, none = recurrent.rglru_block_apply(to_torch(ref_params), torch.from_numpy(x),
                                             cfg=cfg, dtype=torch.float32)
    assert none is None and rel_err(got0.numpy(), want0) <= TOL
