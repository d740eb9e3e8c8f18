"""The port's paged KV cache (repro_torch.runtime.kv_cache) against the
JAX reference (repro.runtime.kv_cache): the same op sequence on both caches
gives identical block tables, free lists, refcounts and pool bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import kv_cache as ref
from repro_torch.runtime import kv_cache as port

L, PAGES, PAGE, W = 3, 12, 8, 24


def _pair(num_pages=PAGES):
    r = ref.LayeredPagedKVCache(num_layers=L, num_pages=num_pages, page_size=PAGE,
                                width=W, dtype=jnp.float32)
    p = port.LayeredPagedKVCache(num_layers=L, num_pages=num_pages, page_size=PAGE,
                                 width=W, dtype=torch.float32, device="cpu")
    return r, p


def _assert_same(r, p, rids):
    assert list(r._free) == list(p._free)
    np.testing.assert_array_equal(r._ref, p._ref)
    live = [x for x in rids if x in r._seq_pages]
    assert live == [x for x in rids if x in p._seq_pages]
    if live:
        bt_r, kv_r = r.block_table(live, width=PAGES)
        bt_p, kv_p = p.block_table(live, width=PAGES)
        np.testing.assert_array_equal(bt_r, bt_p)
        np.testing.assert_array_equal(kv_r, kv_p)
    np.testing.assert_array_equal(np.asarray(r.pages), p.pages.numpy())
    assert r.refcount_sweep()["free_pages"] == p.refcount_sweep()["free_pages"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_op_sequence_matches_reference(seed):
    """alloc / chunked prefill writes / batched one-row decode writes /
    free, in a seeded random order that recycles pages (fragmented FIFO
    reuse), with OutOfPagesError raised identically."""
    rng = np.random.default_rng(seed)
    r, p = _pair()
    live, next_rid = [], 0
    for _ in range(40):
        op = rng.choice(["admit", "decode", "free"], p=[0.35, 0.45, 0.2])
        if op == "admit":
            n = int(rng.integers(1, 3 * PAGE))
            if not r.has_room(None, n):
                assert not p.has_room(None, n)
                continue
            rid = next_rid
            next_rid += 1
            r.alloc(rid)
            p.alloc(rid)
            plan_r, plan_p = r.reserve(rid, n), p.reserve(rid, n)
            assert plan_r == plan_p
            for layer in range(L):
                rows = rng.normal(0, 1, (n, W)).astype(np.float32)
                r.write_layer(layer, plan_r, jnp.asarray(rows))
                p.write_layer(layer, plan_p, torch.from_numpy(rows))
            live.append(rid)
        elif op == "decode" and live:
            need = sum(r.pages_needed_for_append(x, 1) for x in live)
            assert need == sum(p.pages_needed_for_append(x, 1) for x in live)
            if need > r.num_free_pages:
                with pytest.raises(port.OutOfPagesError):
                    for x in live:
                        p.reserve(x, PAGE * PAGES)
                continue
            plans = [(r.reserve(x, 1), p.reserve(x, 1)) for x in live]
            assert all(a == b for a, b in plans)
            pids = np.asarray([a[0][0] for a, _ in plans], np.int32)
            offs = np.asarray([a[0][1] for a, _ in plans], np.int32)
            for layer in range(L):
                rows = rng.normal(0, 1, (len(live), W)).astype(np.float32)
                r.write_layer_tokens(layer, pids, offs, jnp.asarray(rows))
                p.write_layer_tokens(layer, pids, offs, torch.from_numpy(rows))
        elif op == "free" and live:
            rid = live.pop(int(rng.integers(len(live))))
            r.free(rid)
            p.free(rid)
        _assert_same(r, p, list(range(next_rid)))
        for x in live:
            np.testing.assert_array_equal(
                np.asarray(r.gather_contiguous(x, layer=1)), p.gather_contiguous(x, layer=1).numpy()
            )


def test_all_layer_write_and_layer_views_match_reference():
    r, p = _pair()
    rows = np.random.default_rng(4).normal(0, 1, (L, 13, W)).astype(np.float32)
    for c in (r, p):
        c.alloc(0)
    r.append(0, jnp.asarray(rows))
    p.write_reserved(p.reserve(0, 13), torch.from_numpy(rows))
    _assert_same(r, p, [0])
    np.testing.assert_array_equal(np.asarray(r.layer_pages(2)), p.layer_pages(2).numpy())


def test_single_pool_cache_matches_reference():
    r = ref.PagedKVCache(num_pages=4, page_size=PAGE, width=W, dtype=jnp.float32)
    p = port.PagedKVCache(num_pages=4, page_size=PAGE, width=W, dtype=torch.float32,
                          device="cpu")
    rows = np.random.default_rng(6).normal(0, 1, (2 * PAGE + 3, W)).astype(np.float32)
    for c in (r, p):
        c.alloc(0)
        c.alloc(1)
    r.append(1, jnp.asarray(rows[:5]))
    p.write_reserved(p.reserve(1, 5), torch.from_numpy(rows[:5]))
    r.append(0, jnp.asarray(rows))
    p.write_reserved(p.reserve(0, len(rows)), torch.from_numpy(rows))
    np.testing.assert_array_equal(np.asarray(r.pages), p.pages.numpy())
    for x, y in zip(r.block_table([0, 1]), p.block_table([0, 1])):
        np.testing.assert_array_equal(x, y)


def test_admission_errors_and_double_free_match_reference():
    r, p = _pair(num_pages=2)
    for c in (r, p):
        c.alloc(0)
    with pytest.raises(ref.OutOfPagesError):
        r.reserve(0, 2 * PAGE + 1)
    with pytest.raises(port.OutOfPagesError):
        p.reserve(0, 2 * PAGE + 1)
    assert p.seq_len(0) == r.seq_len(0) == 0  # unchanged after the error
    with pytest.raises(KeyError):
        p.alloc(0)
    r.free(0)
    p.free(0)
    r.free(0)  # a double free is a no-op in production on both
    p.free(0)
    _assert_same(r, p, [0])


def test_bf16_pool_and_unported_int8_pool():
    """bf16 is the default pool; an int8 pool (ported since) carries a
    per-row fp32 scale pool, as the reference's does."""
    p = port.LayeredPagedKVCache(num_layers=1, num_pages=2, page_size=4, width=8, device="cpu")
    assert p.pages.dtype == torch.bfloat16 and p.scales is None
    q = port.PagedKVCache(num_pages=2, page_size=4, width=8, dtype=torch.int8, device="cpu")
    r = ref.PagedKVCache(num_pages=2, page_size=4, width=8, dtype=jnp.int8)
    assert q.quantized and q.pages.dtype == torch.int8
    assert tuple(q.scales.shape) == r.scales.shape and q.scales.dtype == torch.float32
    spec = port.CacheSpec("int8")
    assert spec.quantized and spec.bytes_per_row(576) == ref.CacheSpec("int8").bytes_per_row(576)
    assert port.CacheSpec("bf16").bytes_per_page(128, 576) == ref.CacheSpec("bf16").bytes_per_page(128, 576)
    with pytest.raises(ValueError, match="unknown cache dtype"):
        port.CacheSpec("fp8")


# --------------------------------------------------------------------------- #
# retention and rollback bookkeeping (pins, adoption, truncate, debug)
# --------------------------------------------------------------------------- #


def _pair_of(dtype, num_pages=PAGES, debug=False):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[dtype]
    r = ref.LayeredPagedKVCache(num_layers=L, num_pages=num_pages, page_size=PAGE, width=W,
                                dtype=jdt, debug=debug)
    p = port.LayeredPagedKVCache(num_layers=L, num_pages=num_pages, page_size=PAGE, width=W,
                                 dtype=tdt, device="cpu", debug=debug)
    return r, p


def _assert_same_books(r, p):
    """Free list order, refcounts, pins, sequence tables, the census, the
    sweep, and every byte of the pools (int8 scales included)."""
    assert list(r._free) == list(p._free)
    np.testing.assert_array_equal(r._ref, p._ref)
    np.testing.assert_array_equal(r._pin, p._pin)
    assert r._seq_pages == p._seq_pages and r._seq_len == p._seq_len
    assert r.live_sequences() == p.live_sequences()
    assert r.pool_occupancy() == p.pool_occupancy()
    assert r.refcount_sweep() == p.refcount_sweep()
    live = r.live_sequences()
    if live:
        for x, y in zip(r.block_table(live, width=r.num_pages),
                        p.block_table(live, width=p.num_pages)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(r.pages), p.pages.numpy())
    if r.scales is not None:
        np.testing.assert_array_equal(np.asarray(r.scales), p.scales.numpy())


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retention_churn_matches_reference(dtype, seed):
    """A seeded admit / adopt / fork / append / truncate / pin / unpin /
    free churn (pages recycled through the FIFO free list, copy-on-write
    faults, rollbacks into shared pages) on both packages: identical
    bookkeeping and pool bytes after every operation."""
    rng = np.random.default_rng(seed)
    r, p = _pair_of(dtype, num_pages=16)
    live, pinned, next_rid = [], [], 0

    def both(name, *args):
        want = getattr(r, name)(*args)
        got = getattr(p, name)(*args)
        assert got == want, name
        return got

    def append(rid, n):
        rows = rng.normal(0, 1, (L, n, W)).astype(np.float32)
        r.append(rid, jnp.asarray(rows))
        p.append(rid, torch.from_numpy(rows))

    for _ in range(60):
        op = rng.choice(["admit", "adopt", "fork", "append", "truncate", "pin", "unpin",
                         "free"])
        if op == "admit" and both("has_room", None, 2 * PAGE):
            both("alloc", next_rid)
            append(next_rid, int(rng.integers(1, 2 * PAGE)))
            live.append(next_rid)
            next_rid += 1
        elif op == "adopt" and pinned:
            pids = pinned[int(rng.integers(len(pinned)))]
            both("adopt_pages", next_rid, pids, len(pids) * PAGE)
            live.append(next_rid)
            next_rid += 1
        elif op == "fork" and live:
            src = live[int(rng.integers(len(live)))]
            both("fork", src, next_rid, int(rng.integers(0, both("seq_len", src) + 1)))
            live.append(next_rid)
            next_rid += 1
        elif op == "append" and live:
            rid = live[int(rng.integers(len(live)))]
            n = int(rng.integers(1, PAGE + 3))
            if both("has_room", rid, n):
                append(rid, n)
        elif op == "truncate" and live:
            rid = live[int(rng.integers(len(live)))]
            both("truncate", rid, int(rng.integers(0, both("seq_len", rid) + 1)))
        elif op == "pin" and live:
            rid = live[int(rng.integers(len(live)))]
            full = both("seq_len", rid) // PAGE
            if full:
                pids = both("seq_pages", rid)[:full]
                both("pin_pages", pids)
                pinned.append(pids)
        elif op == "unpin" and pinned:
            both("unpin_pages", pinned.pop(int(rng.integers(len(pinned)))))
        elif op == "free" and live:
            both("free", live.pop(int(rng.integers(len(live)))))
        _assert_same_books(r, p)
    for rid in live:
        both("free", rid)
    for pids in pinned:
        both("unpin_pages", pids)
    _assert_same_books(r, p)
    assert p.refcount_sweep()["free_pages"] == 16


def test_pins_adoption_and_census_match_reference():
    r, p = _pair_of("f32")
    rows = np.random.default_rng(8).normal(0, 1, (L, 2 * PAGE + 3, W)).astype(np.float32)
    for c, x in ((r, jnp.asarray(rows)), (p, torch.from_numpy(rows))):
        c.alloc(0)
        c.append(0, x)
        c.pin_pages(c.seq_pages(0)[:2])
        c.free(0)  # the pinned pages stay: retained, not free
    _assert_same_books(r, p)
    assert p.pool_occupancy() == {"live_pages": 0, "retained_pages": 2,
                                  "free_pages": PAGES - 2, "pinned_pages": 2}
    pids = [int(x) for x in np.nonzero(p._pin)[0]]
    for c in (r, p):
        c.adopt_pages(5, pids, 2 * PAGE)
    _assert_same_books(r, p)
    assert p.pool_occupancy()["live_pages"] == 2 and p.page_refcount(pids[0]) == 2
    for c in (r, p):
        c.unpin_pages(pids)
        c.free(5)
    _assert_same_books(r, p)
    assert p.num_free_pages == PAGES
    for c in (r, p):
        with pytest.raises(ValueError, match="free list"):
            c.pin_pages([0])
        with pytest.raises(ValueError, match="retention pin"):
            c.unpin_pages([0])
        with pytest.raises(ValueError, match="on the free list"):
            c.adopt_pages(6, [0], PAGE)


def test_debug_double_free_raises_as_in_the_reference():
    r, p = _pair_of("f32", debug=True)
    for c, err in ((r, ref.DoubleFreeError), (p, port.DoubleFreeError)):
        c.alloc(0)
        c.free(0)
        with pytest.raises(err, match="already freed or never allocated"):
            c.free(0)
        with pytest.raises(err):
            c.free(9)
    _assert_same_books(r, p)
    assert port.PagedKVCache(num_pages=2, page_size=4, width=8, device="cpu").debug is False
