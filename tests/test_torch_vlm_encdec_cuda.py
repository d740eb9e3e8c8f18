"""K6 and K7 on a card at the shapes the vision-language (qwen2-vl-7b) and
encoder-decoder (seamless-m4t-medium) families give them, against their
plain PyTorch versions on the same inputs; and the smoke seamless model's
serving form on the card against the CPU.  Every test is marked ``cuda``
and skips without a card; this file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_vlm_encdec_cuda.py

Tolerances are ``tests/test_torch_cuda.py``'s: fp32 ``base`` 1e-4, fp32
``amla`` 2e-3, bf16 1e-2.  The shapes: K7 non-causal at seamless's 16 x 64
heads over 1024 frames (the encoder, Sq = 1024; the cross-attention over
a 32-token prompt, Sq = 32), with a second request's kv_len short of the
frames; K6 at qwen2-vl's group of 7 query heads per KV head (Dh 128: rows
past G in the 16-row tile) and at seamless's cross-attention decode (one
query row per head over 1024 frames, through ``ops.gqa_attention`` with
1 and 4 query tokens: q_pos = kv_len - 1, then q_pos = Sk).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_prefill as port_prefill
from repro_torch.kernels import gqa_decode as port_gqa
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build_model

TOL = {(torch.float32, "base"): 1e-4, (torch.float32, "amla"): 2e-3,
       (torch.bfloat16, "base"): 1e-2, (torch.bfloat16, "amla"): 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [32, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_noncausal_flash_prefill_over_1024_frames(cuda_device, variant, dtype, sq):
    """K7 with causal=0: every query sees every key below kv_len, none
    past it, whatever its row (the causal skip of keys past a tile's last
    row must be off)."""
    q = _randn((2, 16, sq, 64), 1, dtype)
    k = _randn((2, 16, 1024, 64), 2, dtype)
    v = _randn((2, 16, 1024, 64), 3, dtype)
    kv = torch.tensor([1024, 700], dtype=torch.int32)
    kw = dict(variant=variant, scale=1 / 8, causal=False)
    n = port_prefill.flash_prefill.launches
    got = port_prefill.flash_prefill(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
                                     kv.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert port_prefill.flash_prefill.launches == n + 1
    want = port_prefill.flash_prefill(q, k, v, kv, **kw)
    err = (got.cpu() - want).abs().max().item()
    print(f"K7 non-causal Sq {sq} {dtype} {variant}: max |kernel - plain| {err:.3e}")
    assert err <= TOL[dtype, variant]
    # the first query row sees all 1024 (700) keys: not the causal answer
    causal = port_prefill.flash_prefill(q, k, v, kv, variant=variant, scale=1 / 8, causal=True)
    assert (causal[:, :, 0] - want[:, :, 0]).abs().max().item() > 10 * TOL[dtype, variant]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_gqa_decode_at_group_seven(cuda_device, variant, dtype):
    """K6 at qwen2-vl-7b's geometry (28 query heads over 4 KV heads x 128:
    G = 7 rows, fewer than the 16-row tile), kv_len 0, ragged and full,
    over transposed views of (B, S, Hkv, Dh) caches."""
    lens = [0, 777, 4500]
    q = _randn((3, 4, 7, 128), 4, dtype)
    k = _randn((3, 4500, 4, 128), 5, dtype)
    v = _randn((3, 4500, 4, 128), 6, dtype)
    kv = torch.tensor(lens, dtype=torch.int32)
    pos = torch.clamp_min(kv - 1, 0)[:, None].repeat(1, 7)
    kw = dict(variant=variant, scale=1 / math.sqrt(128))
    n = port_gqa.gqa_decode_rows.launches
    d = cuda_device
    got = port_gqa.gqa_decode_rows(q.to(d), k.to(d).transpose(1, 2), v.to(d).transpose(1, 2),
                                   kv.to(d), pos.to(d), **kw)
    torch.cuda.synchronize()
    assert port_gqa.gqa_decode_rows.launches == n + 1
    want = port_gqa.gqa_decode_rows(q, k.transpose(1, 2), v.transpose(1, 2), kv, pos, **kw)
    err = (got.cpu() - want).abs().max().item()
    print(f"K6 G 7 {dtype} {variant}: max |kernel - plain| {err:.3e}")
    assert err <= TOL[dtype, variant]
    assert torch.isfinite(got).all() and got[0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_decode_over_1024_frames(cuda_device, dtype, sq):
    """Seamless's cross-attention decode: ``ops.gqa_attention`` non-causal
    with no kv_len (every frame visible) over a (B, 1024, 16, 64) memory,
    1 query token (K6 at q_pos 1023) and 4 (K6 at q_pos = Sk); the card
    against the CPU and against the full-softmax answer."""
    q = _randn((2, sq, 16, 64), 7, dtype)
    k = _randn((2, 1024, 16, 64), 8, dtype)
    v = _randn((2, 1024, 16, 64), 9, dtype)
    kw = dict(causal=False, scale=1 / 8)
    n = port_gqa.gqa_decode_rows.launches
    got = ops.gqa_attention(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert port_gqa.gqa_decode_rows.launches == n + 1
    want = ops.gqa_attention(q, k, v, **kw)
    err = (got.cpu().float() - want.float()).abs().max().item()
    print(f"K6 cross Sq {sq} {dtype}: max |kernel - plain| {err:.3e}")
    assert err <= TOL[dtype, "amla"]
    full = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8, -1)
    exact = torch.einsum("bhqk,bkhd->bqhd", full, v.float())
    assert (want.float() - exact).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_smoke_seamless_serving_form_on_card_matches_cpu(cuda_device):
    """``init_cache`` + ``decode_step`` over a 24-token prompt at cache_len
    0 and 4 greedy steps, smoke seamless at fp32, on the card (K7 encoder
    and prompt, K6 decode) and on the CPU: the same greedy tokens, logits
    within 2e-2 (attention takes bf16 inputs, so an fp32 ulp apart can be
    a bf16 step apart)."""
    cfg = get_config("seamless-m4t-medium", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), "cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    p_card = to(p_cpu, cuda_device)
    rng = np.random.default_rng(0)
    src = torch.from_numpy((rng.standard_normal((2, 40, cfg.d_model)) * 0.02).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    runs = []
    for p, dev in ((p_cpu, "cpu"), (p_card, cuda_device)):
        cache = model.init_cache(p, src.to(dev), 32)
        logits, _ = model.decode_step(p, cache, prompt.to(dev), torch.zeros(2, dtype=torch.int32,
                                                                             device=dev))
        seen, toks = [logits[:, -1].cpu()], []
        for i in range(4):
            toks.append(torch.argmax(seen[-1], -1))
            lens = torch.full((2,), 24 + i, dtype=torch.int32, device=dev)
            logits, _ = model.decode_step(p, cache, toks[-1][:, None].to(dev), lens)
            seen.append(logits[:, -1].cpu())
        runs.append((seen, torch.stack(toks)))
    (cpu, cpu_toks), (card, card_toks) = runs
    worst = max((a - b).abs().max().item() for a, b in zip(card, cpu))
    print(f"smoke seamless card vs CPU: max |logits| {worst:.3e}")
    assert torch.equal(card_toks, cpu_toks)
    assert worst <= 2e-2
