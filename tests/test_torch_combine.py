"""What the split-KV combine's (K3) launcher is handed, checked on the CPU
(no card, no nvcc).

The CUDA path (``_combine_cuda``) is driven with CPU tensors against a
stand-in for the kernel library that records each call (as in
``test_torch_gqa_mma.py``): one launch merges one source, or the two
sources of the shared-prefix path where they lie (slot ``s < D0`` of the
first, ``s - D0`` of the second), over a 1-D grid of ``B x G`` rows.  On
CPU tensors both entry points run the plain version and never touch the
library.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode_combine as port_combine

# positions of amla_combine_split_partials' arguments
O0, LSE0, O1, LSE1, DEST, NS, OUT, D0, B, G, DV, S = range(12)


class _Lib:
    """Stands in for the kernel library: records each entry point's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "load", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return fake


@pytest.fixture
def no_build(monkeypatch):
    def load():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_build, "load", load)


def _partials(d, g, d_v, seed=0):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.normal(0, 1, (d, g, d_v)).astype(np.float32))
    lse = torch.from_numpy(rng.normal(0, 1, (d, g, 1)).astype(np.float32))
    return o, lse


def _tables(b, s, slots):
    dest = torch.arange(b * s, dtype=torch.int32).reshape(b, s) % slots
    return dest, torch.full((b,), s, dtype=torch.int32)


@pytest.mark.parametrize("b,g,d_v,s", [(4, 128, 512, 2), (16, 2, 256, 16), (64, 1, 64, 4)])
def test_one_source_launch_arguments(lib, b, g, d_v, s):
    """One launch, one source: its pointers, no second source, D0 = its
    slot count, and B x G rows of Dv columns into a fresh output."""
    o, lse = _partials(b * s + 1, g, d_v)
    dest, n = _tables(b, s, b * s + 1)
    before = port_combine.combine_split_partials.launches
    out = port_combine._combine_cuda([o], [lse], dest, n)
    (name, args), = lib.calls
    assert name == "amla_combine_split_partials"
    assert port_combine.combine_split_partials.launches == before + 1
    assert (args[O0], args[LSE0], args[O1], args[LSE1]) == (o.data_ptr(), lse.data_ptr(), None, None)
    assert (args[DEST], args[NS], args[OUT]) == (dest.data_ptr(), n.data_ptr(), out.data_ptr())
    assert args[D0] == b * s + 1
    assert args[B] * args[G] == b * g and (args[DV], args[S]) == (d_v, s)
    assert out.shape == (b, g, d_v) and out.dtype == torch.float32


def test_hetero_merge_reads_both_sources_in_place(lib, monkeypatch):
    """The shared-prefix merge hands the launcher both sources' own
    pointers and the first source's slot count D0; nothing is
    concatenated."""
    so, slse = _partials(9, 128, 512, 1)
    po, plse = _partials(4, 128, 512, 2)
    dest, n = _tables(5, 3, 13)

    def cat(*a, **k):
        raise AssertionError("the CUDA path concatenated its sources")

    monkeypatch.setattr(torch, "cat", cat)
    out = port_combine._combine_cuda([so, po], [slse, plse], dest, n)
    (_, args), = lib.calls
    assert (args[O0], args[LSE0], args[O1], args[LSE1]) == (
        so.data_ptr(), slse.data_ptr(), po.data_ptr(), plse.data_ptr())
    assert args[D0] == 9 and args[B] * args[G] == 5 * 128
    assert out.shape == (5, 128, 512)


@pytest.mark.parametrize("second,what", [
    ((4, 64, 512), "G"),
    ((4, 128, 256), "Dv"),
])
def test_sources_must_share_g_and_dv(lib, second, what):
    so, slse = _partials(9, 128, 512)
    po, plse = _partials(*second)
    dest, n = _tables(5, 3, 13)
    with pytest.raises(ValueError, match="must share G=128 and Dv=512"):
        port_combine._combine_cuda([so, po], [slse, plse], dest, n)
    assert not lib.calls, what


def test_more_than_two_sources_or_mismatched_lists_raise(lib):
    parts = [_partials(3, 8, 64, i) for i in range(3)]
    dest, n = _tables(2, 2, 9)
    with pytest.raises(ValueError, match="one or two sources"):
        port_combine._combine_cuda([p[0] for p in parts], [p[1] for p in parts], dest, n)
    with pytest.raises(ValueError, match="one or two sources"):
        port_combine._combine_cuda([parts[0][0], parts[1][0]], [parts[0][1]], dest, n)
    assert not lib.calls


def test_bad_types_and_lse_shapes_raise(lib):
    o, lse = _partials(5, 8, 64)
    dest, n = _tables(2, 2, 5)
    with pytest.raises(TypeError, match="float32"):
        port_combine._combine_cuda([o.half()], [lse], dest, n)
    with pytest.raises(ValueError, match=r"lse must be \(D=5, G=8, 1\)"):
        port_combine._combine_cuda([o], [lse[:4]], dest, n)
    assert not lib.calls


def test_rows_past_the_old_grid_cap(lib):
    """B = 70000 requests of one row: the 1-D grid takes B x G rows with no
    65535 cap, and the wrapper does not hold one either."""
    o, lse = _partials(3, 1, 64)
    dest, n = _tables(70000, 2, 3)
    out = port_combine._combine_cuda([o], [lse], dest, n)
    (_, args), = lib.calls
    assert (args[B], args[G], args[B] * args[G]) == (70000, 1, 70000)
    assert out.shape == (70000, 1, 64)


def test_cpu_tensors_run_the_plain_version(no_build):
    """On CPU tensors both entry points run the plain version (the hetero
    one on the concatenation, the reference's definition)."""
    so, slse = _partials(9, 4, 64, 3)
    po, plse = _partials(4, 4, 64, 4)
    dest, n = _tables(5, 3, 13)
    n[0] = 0
    want = port_combine._combine_plain(torch.cat([so, po]), torch.cat([slse, plse]), dest, n)
    got = port_combine.combine_hetero_partials([so, po], [slse, plse], dest, n)
    assert torch.equal(got, want) and torch.equal(got[0], torch.zeros_like(got[0]))
    dest1, n1 = _tables(3, 3, 9)
    assert torch.equal(port_combine.combine_split_partials(so, slse, dest1, n1),
                       port_combine._combine_plain(so, slse, dest1, n1))
