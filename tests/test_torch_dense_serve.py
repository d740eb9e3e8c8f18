"""The port's dense ``ServingSession`` against the JAX reference's, on the
CPU, and the reference's session cases (``tests/test_runtime.py``) on the
port.

Greedy tokens must be identical to the JAX ``ServingSession`` run with
``attn_impl="pallas_interpret"`` on the fp32 smoke configs of
``gemma2-2b``, ``qwen2.5-3b`` and ``deepseek-v2-mla``, over 12 decode
steps with a mid-stream finish and re-admission into the freed slot.
Seed 0: every step's top-2 logit gap on these untrained models stays above
0.15 (measured on the port), far above the 2e-3 the two sides' logits can
differ by, so greedy equality is a fair test.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.serve_loop import ServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import ServingSession

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's contiguous MLA kernel run in interpret mode on
    this jax, which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.
    The alias is undone after each test, and so are the jit traces made
    under it (a cached trace would change a later reference test's
    outcome)."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-3b", "deepseek-v2-mla"])
def test_greedy_tokens_match_reference_session(pallas_interpret, arch):
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), attn_impl="pallas_interpret")
    cfg = get_config(arch, smoke=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = convert_params(ref_params, cfg, device="cpu")
    sessions = (RefSession(ref_model, ref_params, batch_size=2, max_len=64),
                ServingSession(build_model(cfg), params, batch_size=2, max_len=64))
    rng = np.random.default_rng(0)
    # 5 tokens prefill as decode rows (K6), 40 through the flash prefill (K7),
    # past gemma2's smoke window of 32
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 12)]
    for s in sessions:
        assert (s.add_request(prompts[0]), s.add_request(prompts[1])) == (0, 1)
        for _ in range(8):
            s.step()
        s.finish(0)
        assert s.add_request(prompts[2]) == 2  # into the freed slot
        for _ in range(4):
            s.step()
    ref, port = sessions
    assert port.outputs == ref.outputs
    assert len(port.outputs[1]) == 13 and len(port.outputs[2]) == 5
    assert port.prefill_compiles == ref.prefill_compiles == 3  # buckets 8, 64, 16
    np.testing.assert_array_equal(port.cache_len, ref.cache_len)


# --------------------------------------------------------------------------- #
# the reference's session cases (tests/test_runtime.py), on the port
# --------------------------------------------------------------------------- #
def tiny_model(seed=0):
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(seed), "cpu")


def test_serving_session_slots_and_outputs():
    model, params = tiny_model()
    sess = ServingSession(model, params, batch_size=2, max_len=64)
    r1 = sess.add_request([5, 6, 7])
    r2 = sess.add_request([9, 10, 11, 12])
    assert r1 is not None and r2 is not None
    assert sess.add_request([1]) is None  # no free slot
    for _ in range(4):
        sess.step()
    out1 = sess.finish(r1)
    assert len(out1) == 5  # 1 prefill token + 4 steps
    r3 = sess.add_request([3, 4])  # slot reuse
    assert r3 is not None
    sess.step()
    out2 = sess.finish(r2)
    out3 = sess.finish(r3)
    assert len(out2) == 6 and len(out3) == 2


def test_serving_session_prompt_length_validation():
    model, params = tiny_model()
    sess = ServingSession(model, params, batch_size=1, max_len=16)
    with pytest.raises(ValueError, match="at least one prompt token"):
        sess.add_request([])
    with pytest.raises(ValueError, match="max_len=16"):
        sess.add_request(list(range(2, 19)))  # 17 tokens
    # the boundary itself is fine: a max_len prompt fills the slot exactly
    assert sess.add_request(list(range(2, 18))) is not None


def test_serving_session_recycled_slot_invariant():
    model, params = tiny_model()
    sess = ServingSession(model, params, batch_size=1, max_len=32)
    r1 = sess.add_request([5, 6, 7])
    for _ in range(2):
        sess.step()
    sess.finish(r1)
    assert sess.cache_len[0] == 0 and sess.last_token[0] == 0
    # corrupt the freed slot: the admission-time invariant must now fire
    sess.last_token[0] = 99
    with pytest.raises(AssertionError, match="stale state"):
        sess.add_request([3, 4])
    sess.last_token[0] = 0
    assert sess.add_request([3, 4]) is not None  # clean slot admits again


def test_serving_session_matches_batch_decode():
    """Slot-based serving produces the same tokens as direct decode, and
    a prefill clears the slot's stale rows (the cache then equals a fresh
    batch-1 cache's)."""
    model, params = tiny_model(1)
    prompt = [5, 6, 7, 8]

    sess = ServingSession(model, params, batch_size=2, max_len=32)
    sess.add_request([9, 9, 9, 9, 9, 9, 9])  # fills slot 0's rows, then leaves
    for _ in range(3):
        sess.step()
    sess.finish(0)
    rid = sess.add_request(prompt)
    for _ in range(3):
        sess.step()
    got = sess.finish(rid)

    cache = model.init_cache(params, 1, 32)
    logits, cache = model.prefill(params, cache, torch.tensor([prompt]))
    want = [int(torch.argmax(logits[0, -1]))]
    clen = len(prompt)
    for i in range(3):
        logits, cache = model.decode_step(params, cache, torch.tensor([[want[-1]]]),
                                          np.asarray([clen + i], np.int32))
        want.append(int(torch.argmax(logits[0, -1])))
    assert got == want
    for ours, fresh in zip(sess.cache, cache):
        for k in fresh:
            # the slot holds what a fresh batch-1 cache holds: the request's
            # rows, and zeros past them where the previous request wrote
            np.testing.assert_allclose(ours[k][0].numpy(), fresh[k][0].numpy(), atol=1e-5)
            assert not ours[k][0, :, clen + 3 :].any()


def test_launch_serve_dense_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--cache", "dense", "--smoke",
         "--requests", "3", "--gen-len", "4", "--batch", "2", "--max-len", "64",
         "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "serving qwen1.5-0.5b with the dense cache backend on cpu" in out.stdout
    assert "served 3 requests, 12 decode tokens" in out.stdout
    assert "prefill compiles:" in out.stdout
