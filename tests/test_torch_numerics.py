"""The port's AMLA numerics (repro_torch.core.numerics) against the JAX
reference (repro.core.numerics): int32 bit patterns equal on seeded sweeps
(zeros, subnormals, underflow, negative accumulators, the MIN_EXP_DELTA
clamp); ``round_scale_to_pow2``'s ``exp`` output within 1 ulp (the two
libraries' exp implementations may round differently), its ``n`` exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import numerics as ref
from repro_torch.core import numerics as port


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _accumulators(rng, n):
    """fp32 accumulators over the whole exponent range, both signs, plus
    exact zeros (both signs) and subnormals."""
    mags = rng.normal(0.0, 1.0, n) * np.exp2(rng.integers(-150, 127, n))
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, -3e-39, 1.0, -1.0])
    return np.concatenate([mags, special]).astype(np.float32)


def test_constants_match():
    assert port.M_INIT == ref.M_INIT
    assert port.M_CLAMP == ref.M_CLAMP
    assert port.MIN_EXP_DELTA == ref.MIN_EXP_DELTA
    assert port.MANTISSA_BITS == ref.MANTISSA_BITS
    assert port.LN2 == ref.LN2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitcasts_roundtrip_bit_exact(seed):
    x = _accumulators(np.random.default_rng(seed), 4096)
    i_ref = np.array(ref.as_int32(jnp.asarray(x)))
    i_port = port.as_int32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(i_port, i_ref)
    np.testing.assert_array_equal(
        _bits(port.as_fp32(torch.from_numpy(i_ref))), _bits(ref.as_fp32(jnp.asarray(i_ref)))
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pow2_int_increment_bit_exact(seed):
    rng = np.random.default_rng(seed)
    n = 20000
    dn = np.concatenate(
        [rng.integers(-200, 8, n), [0, -29, -30, -31, -144270]]
    ).astype(np.int32)
    eps = np.concatenate(
        [rng.normal(0, 4e-3, n // 2), np.zeros(n - n // 2), [0.0, 1e-7, -1e-7, 2e-3, -2e-3]]
    ).astype(np.float32)
    got = port.pow2_int_increment(torch.from_numpy(dn), torch.from_numpy(eps)).numpy()
    want = np.asarray(ref.pow2_int_increment(jnp.asarray(dn), jnp.asarray(eps)))
    np.testing.assert_array_equal(got, want)
    # a no-op update rounds to exactly 0 (the rescale-skip condition)
    assert port.pow2_int_increment(torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(4)).eq(0).all()
    got0 = port.pow2_int_increment(torch.from_numpy(dn)).numpy()
    np.testing.assert_array_equal(got0, np.asarray(ref.pow2_int_increment(jnp.asarray(dn))))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_int_increment_bit_exact(seed):
    rng = np.random.default_rng(seed)
    x = _accumulators(rng, 20000)
    # exponent deltas from the clamp up to a small growth, with eps parts,
    # including increments that underflow small and negative accumulators
    inc = (rng.integers(-31, 3, x.size) * (1 << 23)
           + rng.integers(-(1 << 21), 1 << 21, x.size)).astype(np.int32)
    got = port.apply_int_increment(torch.from_numpy(x), torch.from_numpy(inc))
    want = ref.apply_int_increment(jnp.asarray(x), jnp.asarray(inc))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_pow2_mul_by_add_bit_exact(seed):
    rng = np.random.default_rng(seed)
    x = _accumulators(rng, 20000)
    n = rng.integers(-160, 160, x.size).astype(np.int32)
    got = port.pow2_mul_by_add(torch.from_numpy(x), torch.from_numpy(n))
    want = ref.pow2_mul_by_add(jnp.asarray(x), jnp.asarray(n))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_round_scale_to_pow2_n_exact_inv_r_within_one_ulp(seed):
    rng = np.random.default_rng(seed)
    m = np.concatenate(
        [rng.normal(0, 30, 20000), rng.uniform(ref.M_INIT, ref.M_CLAMP, 20000),
         [ref.M_INIT, -ref.M_CLAMP, ref.M_CLAMP, 0.0]]
    ).astype(np.float32)
    n_p, r_p = port.round_scale_to_pow2(torch.from_numpy(m))
    n_r, r_r = ref.round_scale_to_pow2(jnp.asarray(m))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))
    ulps = np.abs(_bits(r_p).astype(np.int64) - _bits(r_r).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()


def test_bf16_round_and_softcap():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 3, 10000), [0.70710677, 1.4142135, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(port.bf16_round(torch.from_numpy(x))), _bits(ref.bf16_round(jnp.asarray(x)))
    )
    np.testing.assert_allclose(
        port.softcap(torch.from_numpy(x), 30.0).numpy(),
        np.asarray(ref.softcap(jnp.asarray(x), 30.0)),
        rtol=2e-7, atol=1e-6,
    )
