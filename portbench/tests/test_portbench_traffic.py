"""Every seed gets the same set of lengths, in its own order, and its own
tokens; seeds past 32 bits work; a traffic kind is found by its name."""

import numpy as np
import pytest

from portbench.core import bench, traffic

BATCH = dict(kind="closed_batch", sequences=32, prompt_len=dict(dist="uniform", lo=2049, hi=3072))


def prompts(params, seed, vocab):
    return bench.part("drivers", params["kind"]).Load(params, seed, vocab).prompts


@pytest.mark.parametrize("seeds", [(1, 2), (2**31 + 5, 2**33 + 7)])
def test_same_lengths_other_order(seeds):
    a, b = (prompts(BATCH, s, 102400) for s in seeds)
    la, lb = [len(p) for p in a], [len(p) for p in b]
    assert sorted(la) == sorted(lb) and la != lb
    assert min(la) >= 2049 and max(la) <= 3072
    assert not np.array_equal(a[0][:50], b[0][:50])


def test_same_seed_same_requests():
    a, b = (prompts(BATCH, 9, 100) for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(2 <= x.min() and x.max() < 100 for x in a)


def test_closed_batch_sizes_the_session():
    load = bench.part("drivers", "closed_batch").Load(BATCH, 3, 100)
    assert load.live == 32 and load.longest == max(len(p) for p in load.prompts)


def test_quantiles():
    assert traffic.lengths(dict(dist="uniform", lo=0, hi=100), 4) == [12, 38, 62, 88]
    with pytest.raises(ValueError):
        traffic.lengths(dict(dist="zipf", lo=0, hi=100), 4)


def test_unknown_kind_is_refused():
    with pytest.raises(SystemExit, match="drivers/closed_loop.py"):
        prompts(dict(kind="closed_loop"), 1, 10)
