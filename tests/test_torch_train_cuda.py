"""The training path on a card: the attention Function (K7 forward,
blockwise backward) against ``blockwise_attention`` on the same inputs,
its launches, and smoke train steps on the card against the CPU.  Every
test is marked ``cuda`` and skips without a card; this file imports
nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances: K7's forward within 1e-2 (bf16 inputs) or 2e-3 (fp32 inputs)
of the blockwise forward (``tests/test_torch_cuda.py``'s K7 tolerances:
both round the products to bf16, in another order); the backward equal
to autograd through ``blockwise_attention`` (the same computation on the
same inputs); a smoke step's loss within 1e-4 relative of the CPU's (the
forward's attention is K7 on the card and its plain version on the CPU,
bf16 rounding in another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import attention, tree
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import flash_prefill as port_prefill
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.train_loop import TrainConfig, init_train_state, make_train_step

FWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def randn(shape, seed, dtype, device):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def function_vs_blockwise(q, k, v, **kw):
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_ins = [t.detach().requires_grad_() for t in (q, k, v)]
    port_prefill.flash_prefill.launches = port_prefill.flash_prefill.mma_launches = 0
    out = attention.multi_head_attention(*ins, **kw)
    launches = port_prefill.flash_prefill.launches, port_prefill.flash_prefill.mma_launches
    ref = attention.blockwise_attention(*ref_ins, **kw)
    ct = torch.randn_like(out)
    got = torch.autograd.grad(out, ins, ct)
    want = torch.autograd.grad(ref, ref_ins, ct)
    out, ref = out.detach(), ref.detach()
    err = float((out.float() - ref.float()).abs().max()) / max(1.0, float(ref.abs().max()))
    return launches, err, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("geom", [(16, 16, 64), (8, 2, 128), (4, 4, 16)])
def test_attention_function_on_card(cuda_device, dtype, variant, geom):
    hq, hkv, d = geom
    b, s = 2, 700
    q = randn((b, s, hq, d), 1, dtype, cuda_device)
    k, v = (randn((b, s, hkv, d), i, dtype, cuda_device) for i in (2, 3))
    kw = dict(variant=variant, causal=True, scale=d ** -0.5, kv_len=np.full((b,), s, np.int32),
              q_offset=np.zeros((b,), np.int32))
    launches, err, got, want = function_vs_blockwise(q, k, v, **kw)
    print(f"forward vs blockwise {err:.3e}")
    assert launches == (1, 1)
    assert err <= FWD_TOL[dtype]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_expanded_mla_widths_on_card(cuda_device):
    """Dk 48, Dv 32 (smoke deepseek-v2-mla's expanded form): K7 at 64 with
    zero columns, the output's true width, the blockwise gradient."""
    q, k = (randn((2, 256, 4, 48), i, torch.float32, cuda_device) for i in (4, 5))
    v = randn((2, 256, 4, 32), 6, torch.float32, cuda_device)
    kw = dict(variant="amla", causal=True, scale=48 ** -0.5)
    launches, err, got, want = function_vs_blockwise(q, k, v, **kw)
    assert launches == (1, 1) and err <= FWD_TOL[torch.float32]
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_serving_call_records_nothing_on_card(cuda_device):
    q, k, v = (randn((1, 64, 4, 64), i, torch.bfloat16, cuda_device) for i in range(3))
    port_prefill.flash_prefill.launches = 0
    out = attention.multi_head_attention(q, k, v, causal=True, q_offset=np.zeros(1, np.int32))
    assert out.grad_fn is None and port_prefill.flash_prefill.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-mla"])
def test_smoke_train_step_card_vs_cpu(cuda_device, arch):
    """One remat step from the same fp32 weights: the loss within 1e-4
    relative of the CPU's, K7 launched twice per layer (forward + remat
    recompute)."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params, _, _ = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                            seed=0).batch_at(0)
    step = make_train_step(model, TrainConfig(remat=True, warmup_steps=1))
    _, _, _, m_cpu = step(params, adamw_init(params), None, batch, 1)
    on_card = tree.tree_map(lambda t: t.to(cuda_device), params)
    port_prefill.flash_prefill.launches = 0
    _, _, _, m_card = step(on_card, adamw_init(on_card), None, batch, 1)
    torch.cuda.synchronize()
    assert port_prefill.flash_prefill.launches == 2 * cfg.n_layers
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-4)
