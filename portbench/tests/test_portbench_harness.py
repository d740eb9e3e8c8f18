"""The whole harness on the CPU at smoke widths: a sound run is correct,
its control and each fault a serving cell can have are not."""

import importlib

import pytest
import torch

from portbench.core import bench, weights
from smoke_cells import LIMIT, cell

SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


def run(form, hook=None, seed=SEED, readings=(), **kw):
    return bench.run(cell(form, **kw), seed, 0.3, False, device="cpu", session_hook=hook,
                     readings=readings)


@pytest.mark.parametrize("form", ["mla", "gqa"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sound_run_is_correct(form, dtype):
    result, ctx = run(form, dtype=dtype)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] == 3
    assert set(result["metrics"]) == {"out_tok_s", "tpot_p95_ms", "setup_s"}
    assert list(result)[-1] == "check"
    assert ctx.tokens_compared > 20
    # fp32 serving agrees with the fp32 reference token for token
    if dtype == "float32":
        assert result["check"]["widest_gap"]["value"] < 1e-4


@pytest.mark.parametrize("form", ["mla", "gqa"])
@pytest.mark.parametrize("reading", ["control", "state_unchanged", "token_altered"])
def test_control_is_not_correct(form, reading):
    """The reference in fp8 in the program's place, and each fault planted
    in the reference put there, read a gap past the limit on the sample
    a sound run is judged on."""
    _, ctx = run(form, readings=(reading,))
    assert ctx.readings["program"] <= LIMIT < ctx.readings[reading], ctx.readings


def test_planted_faults_leave_the_prompt_alone():
    """The dropped rows are the generated tokens' only: at the prompt's last
    position (the first served token) the reference reads as sound."""
    c = cell("gqa", dtype="float32")
    ref = importlib.import_module(f"portbench.reference.{c.config['reference']}")
    params = weights.make(ref.leaves(c.model), 5, "cpu")
    seq = torch.randint(2, 512, (40,), generator=torch.Generator().manual_seed(1))
    want = torch.arange(29, 40)
    sound = ref.logits(params, c.model, [seq], [want])[0]
    dropped = ref.logits(params, c.model, [seq], [want], drop_written=[30])[0]
    assert torch.equal(sound[:2], dropped[:2])  # positions 29, 30: nothing dropped yet
    assert not torch.allclose(sound[2:], dropped[2:])


class AlteredToken:
    """A token altered where it is produced: after each step the newest
    token of the first live request is replaced."""

    def __init__(self, sess):
        self.__dict__["inner"] = sess

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self):
        self.inner.step()
        rid = self.inner.live()[0]
        toks = self.inner.tokens(rid)
        toks[-1] = (toks[-1] + 1) % 512


class StateUnchanged(AlteredToken):
    """A step that returns its state unchanged: every cache row the step
    wrote is put back as it was."""

    def step(self):
        caches = self.inner.sess.cache
        tensors = ([caches.pages] if hasattr(caches, "pages")
                   else [t for c in caches for t in c.values()])
        saved = [t.clone() for t in tensors]
        self.inner.step()
        for t, s in zip(tensors, saved):
            t.copy_(s)


@pytest.mark.parametrize("form", ["mla", "gqa"])
@pytest.mark.parametrize("fault", [AlteredToken, StateUnchanged], ids=["token", "state"])
def test_faults_are_not_correct(form, fault):
    result, _ = run(form, hook=fault)
    assert not result["correct"], result["check"]
    assert result["check"]["widest_gap"]["value"] > LIMIT


def test_a_session_that_serves_nothing_fails():
    class Idle(AlteredToken):
        def step(self):
            pass

    result, _ = run("mla", hook=Idle)
    assert not result["correct"] and result["failed"] == 3


@pytest.mark.parametrize("form", ["mla", "gqa"])
def test_reference_matches_the_program_forward(form):
    """The plain reference against the program's fp32 forward over a dense
    cache (its CPU plain path; ``decode_step`` at ``cache_len`` 0 returns
    every position's logits).  The program's attention takes q, k, v (the
    latent rows) in bf16 even in an fp32 model (``ops.gqa_attention``, K4's
    rows), so the logits differ by bf16 steps: 2.6e-3 of the largest here,
    held at 1e-2; a wrong rotation, head map or scale moves them by O(1)."""
    c = cell(form, dtype="float32")
    ref = importlib.import_module(f"portbench.reference.{c.config['reference']}")
    leaves = ref.leaves(c.model)
    model = bench.build_model_for(c.config)
    bench.check_layout(model, leaves)
    params = weights.make(leaves, 5, "cpu")
    tokens = torch.randint(2, 512, (1, 70), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cache = model.init_cache(params, 1, 128)
        want = model.decode_step(params, cache, tokens, torch.zeros(1, dtype=torch.int32))[0][0]
    got = ref.logits(params, c.model, [tokens[0]], [torch.arange(70)])[0]
    assert torch.allclose(got, want, atol=1e-2 * want.abs().max().item()), \
        (got - want).abs().max()


def test_layout_mismatch_is_refused():
    c = cell("mla")
    ref = importlib.import_module("portbench.reference.mla_lm")
    leaves = ref.leaves(c.model)[:-1]
    with pytest.raises(SystemExit, match="layout"):
        bench.check_layout(bench.build_model_for(c.config), leaves)
