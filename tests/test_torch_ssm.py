"""The port's Mamba-2 block (repro_torch.models.ssm) against the JAX
reference's, on the CPU at fp32 with the smoke ``mamba2-370m`` widths
(8 heads x 16, state 16) and the reference's weights carried across: the
block at S = 1 (the exact single-step decode branch), S = 40 (one chunk)
and S = 300 (past ``CHUNK`` = 256: padded to 512 after the softplus) from
a nonzero state, output and new cache within 1e-4 of the tensor's
largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.convert import _tree_map
from repro_torch.models import ssm

TOL = 1e-4


def to_torch(tree):
    return _tree_map(lambda a: torch.from_numpy(np.array(np.asarray(a))), tree)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("s", [1, 40, 300])
def test_mamba2_block_matches_reference(s):
    ref_cfg = ref_get_config("mamba2-370m", smoke=True)
    cfg = get_config("mamba2-370m", smoke=True)
    ref_params = ref_ssm.mamba2_block_init(jax.random.PRNGKey(6), ref_cfg)
    rng = np.random.default_rng(7)
    nh = cfg.d_inner // cfg.ssm_head_dim
    x = rng.normal(0, 1, (2, s, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, nh, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
    conv = rng.normal(0, 1, (2, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)).astype(
        np.float32)
    want, want_cache = ref_ssm.mamba2_block_apply(
        ref_params, jnp.asarray(x), cfg=ref_cfg,
        cache={"h": jnp.asarray(h0), "conv": jnp.asarray(conv)}, dtype=jnp.float32)
    cache = ssm.init_ssm_cache(cfg, 2, device="cpu")
    cache["h"].copy_(torch.from_numpy(h0))
    cache["conv"].copy_(torch.from_numpy(conv))
    h_buf, conv_buf = cache["h"], cache["conv"]
    got, out_cache = ssm.mamba2_block_apply(to_torch(ref_params), torch.from_numpy(x), cfg=cfg,
                                            cache=cache, dtype=torch.float32)
    assert out_cache["h"] is h_buf and out_cache["conv"] is conv_buf  # written in place
    assert got.shape == (2, s, cfg.d_model)
    assert rel_err(got.numpy(), want) <= TOL
    for k in ("h", "conv"):
        assert rel_err(cache[k].numpy(), want_cache[k]) <= TOL, k
    # without a cache: the zero state, and the chunked path even at S = 1
    want0, _ = ref_ssm.mamba2_block_apply(ref_params, jnp.asarray(x), cfg=ref_cfg,
                                          dtype=jnp.float32)
    got0, none = ssm.mamba2_block_apply(to_torch(ref_params), torch.from_numpy(x), cfg=cfg,
                                        dtype=torch.float32)
    assert none is None and rel_err(got0.numpy(), want0) <= TOL


def test_ssd_chunked_masks_before_the_exp():
    """Decay rates large enough that exp(cum_t - cum_u) above the diagonal
    overflows fp32: the output stays finite and equal to the reference's."""
    rng = np.random.default_rng(8)
    b, s, nh, hd, ds = 1, 256, 2, 4, 3
    x = rng.normal(0, 1, (b, s, nh, hd)).astype(np.float32)
    dt = np.full((b, s, nh), 2.0, np.float32)
    a = np.asarray([40.0, 0.5], np.float32)  # cum falls by 80 a step: exp(+) overflows
    bb = rng.normal(0, 1, (b, s, ds)).astype(np.float32)
    c = rng.normal(0, 1, (b, s, ds)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, nh, hd, ds)).astype(np.float32)
    want_y, want_h = ref_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, c, h0)))
    got_y, got_h = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, c, h0)))
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    assert rel_err(got_y.numpy(), want_y) <= TOL
    assert rel_err(got_h.numpy(), want_h) <= TOL
