"""K6's partials and the split-KV decode on a card, against their plain
versions on the same inputs.  Every test is marked ``cuda`` and skips
without a card; this file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_split_kv_cuda.py

Tolerances are K6's (``tests/test_torch_cuda.py``): 1e-2 at bf16, 2e-3
for fp32 amla, 1e-4 for fp32 base.  K6 without partials must equal its
partials merged by K3 bit for bit (the path it takes over its splits).
"""

import math

import pytest
import torch

from repro_torch.core import distributed as dist
from repro_torch.kernels import gqa_decode as gd
from repro_torch.kernels import mla_decode_combine as comb
from repro_torch.launch.mesh import logical_mesh

pytestmark = pytest.mark.cuda
TOL = {(torch.bfloat16, "amla"): 1e-2, (torch.bfloat16, "base"): 1e-2,
       (torch.float32, "amla"): 2e-3, (torch.float32, "base"): 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inputs(dtype, device, b=3, hq=8, hkv=2, s=2048, dh=128):
    gen = torch.Generator(device).manual_seed(0)
    rn = lambda *sh: torch.randn(sh, generator=gen, device=device).to(dtype)
    lens = torch.tensor([s, 700, 0], device=device)
    return rn(b, 1, hq, dh), rn(b, hkv, s, dh), rn(b, hkv, s, dh), lens


@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_partials_merge_to_the_unsplit_call(cuda_device, dtype, variant):
    q, k, v, lens = inputs(dtype, cuda_device)
    b, _, hq, dh = q.shape
    hkv, g = k.shape[1], hq // k.shape[1]
    rows = q.reshape(b, hkv, g, dh)
    pos = torch.clamp_min(lens - 1, 0)[:, None].expand(b, g).to(torch.int32)
    kw = dict(variant=variant, scale=1 / math.sqrt(dh))
    whole = gd.gqa_decode_rows(rows, k, v, lens, pos, **kw)
    o, lse = gd.gqa_decode_rows(rows, k, v, lens, pos, return_partials=True, **kw)
    n = o.shape[0]
    assert lse.shape == (n, b, hkv, g) and torch.isinf(lse[:, 2]).all()
    merged = (comb.combine_split_partials(o.reshape(n * b * hkv, g, dh),
                                          lse.reshape(n * b * hkv, g, 1),
                                          *gd.split_tables(b * hkv, n, q.device))
              .view(b, hkv, g, dh) if n > 1 else o[0])
    assert torch.equal(merged, whole)
    plain_o, plain_lse = gd.attend_plain(rows, k, v, lens, pos, block_k=512, softcap=None,
                                         window=None, num_splits=n, return_partials=True, **kw)
    assert float((o - plain_o).abs().max()) <= TOL[(dtype, variant)]
    live = torch.isfinite(plain_lse)
    assert torch.equal(live, torch.isfinite(lse))
    assert float((lse[live] - plain_lse[live]).abs().max()) <= 1e-3


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_kv_decode_matches_the_cpu(cuda_device, dtype, n):
    """Over n logical shards of the card against the same call on the
    CPU (K6's plain version), a request no shard sees exact zeros."""
    q, k, v, lens = inputs(dtype, cuda_device)
    kw = dict(scale=1 / math.sqrt(q.shape[-1]), kv_layout="bhsd", window=100, softcap=30.0)
    got = dist.gqa_split_kv_decode(q, k, v, mesh=logical_mesh({"data": 1, "model": n}, "cuda"),
                                   kv_len=lens, q_offset=torch.clamp_min(lens - 1, 0), **kw)
    cpu = [t.cpu() for t in (q, k, v, lens)]
    want = dist.gqa_split_kv_decode(*cpu[:3], mesh=logical_mesh({"data": 1, "model": n}, "cpu"),
                                    kv_len=cpu[3], q_offset=torch.clamp_min(cpu[3] - 1, 0), **kw)
    assert float((got.float().cpu() - want.float()).abs().max()) <= TOL[(dtype, "amla")]
    assert torch.equal(got[2], torch.zeros_like(got[2]))
