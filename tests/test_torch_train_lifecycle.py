"""The training supervisor, the launcher and the lifecycle train ->
checkpoint -> restore -> serve (``runtime.fault_tolerance
.TrainingSupervisor``, ``launch.train``, ``runtime.train_loop
.serving_params``) on the CPU; the step itself is held against the JAX
package's in ``test_torch_train_loop.py``.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import train as train_launch
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.fault_tolerance import TrainingSupervisor
from repro_torch.runtime.serve_loop import ServingSession
from repro_torch.runtime.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
    serving_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny(arch="qwen1.5-0.5b"):
    cfg = get_config(arch, smoke=True)
    return build_model(cfg), cfg


def data_for(cfg, batch=4, seq=32, seed=0):
    return SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed)


def state_of(model, seed=0):
    params, opt, _ = init_train_state(model, torch.Generator().manual_seed(seed), "cpu")
    return params, opt


# --------------------------------------------------------------------------- #
# supervisor
# --------------------------------------------------------------------------- #
def supervised_step(model):
    raw = make_train_step(model, TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=100,
                                             remat=False))

    def step_fn(state, batch, step):
        p, o, _, m = raw(state["params"], state["opt"], None, batch, step)
        return {"params": p, "opt": o}, m

    return step_fn


def test_supervisor_recovers_from_failures(tmp_path):
    model, cfg = tiny()
    params, opt = state_of(model)
    fail_at = {7, 13}

    def failure_hook(step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError(f"injected failure at {step}")

    sup = TrainingSupervisor(ckpt_manager=CheckpointManager(str(tmp_path), keep=2),
                             data=data_for(cfg), ckpt_every=5, failure_hook=failure_hook)
    state, last, history = sup.run(supervised_step(model), {"params": params, "opt": opt},
                                   start_step=0, num_steps=20)
    assert sup.restarts == 2
    assert last >= 20
    assert [s for s, _ in history] == list(range(20))
    assert all(np.isfinite(float(m["loss"])) for _, m in history)


def test_supervisor_resumes_from_checkpoint(tmp_path):
    model, cfg = tiny()
    params, opt = state_of(model)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    sup = TrainingSupervisor(ckpt_manager=mgr, data=data_for(cfg), ckpt_every=4)
    state, last, _ = sup.run(supervised_step(model), {"params": params, "opt": opt},
                             start_step=0, num_steps=8)
    assert mgr.committed_steps() == [4, 8]
    sup2 = TrainingSupervisor(ckpt_manager=mgr, data=data_for(cfg), ckpt_every=4)
    state2, last2, hist2 = sup2.run(supervised_step(model), {"params": params, "opt": opt},
                                    start_step=0, num_steps=2)
    assert hist2[0][0] == 8 and last2 == 10


# --------------------------------------------------------------------------- #
# launcher
# --------------------------------------------------------------------------- #
def test_launch_train_cpu_smoke(capsys):
    history = train_launch.main(["--smoke", "--device", "cpu", "--steps", "30", "--batch", "4",
                                 "--seq", "32", "--log-every", "10"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done: 30 steps" in out
    assert float(history[-1][1]["loss"]) < float(history[0][1]["loss"]) - 0.5


def test_launch_train_resumes_through_supervisor(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "3", "--remat"]
    train_launch.main(args + ["--steps", "6"])
    assert "finished at step 6 (0 restarts)" in capsys.readouterr().out
    history = train_launch.main(args + ["--steps", "2"])
    assert [s for s, _ in history] == [6, 7]
    assert "finished at step 8" in capsys.readouterr().out


def test_launch_train_without_cuda_raises():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                          "--steps", "1"], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "needs CUDA" in out.stderr


# --------------------------------------------------------------------------- #
# the lifecycle (test_system.py's)
# --------------------------------------------------------------------------- #
def serve_tokens(model, params, prompts, steps=4):
    sess = ServingSession(model, params, batch_size=len(prompts), max_len=48)
    rids = [sess.add_request(p) for p in prompts]
    for _ in range(steps):
        sess.step()
    return [sess.finish(r) for r in rids]


def test_train_checkpoint_restore_serve_roundtrip(tmp_path):
    """The paper's native (MLA) architecture, amla on: train, checkpoint
    asynchronously, restore, make the serving tree (bf16 is not needed at
    smoke's fp32 config; the table copy is made from the trained table),
    and serve the same tokens as from the in-memory trained parameters."""
    model, cfg = tiny("deepseek-v2-mla")
    assert cfg.attn_variant == "amla"
    params, opt = state_of(model)
    step = make_train_step(model, TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=20,
                                              remat=False))
    data = data_for(cfg)
    losses = []
    for s in range(10):
        params, opt, _, m = step(params, opt, None, data.batch_at(s % 3), s)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses

    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(10, {"params": params, "opt": opt})
    mgr.wait()
    st, restored = mgr.restore_latest({"params": params, "opt": opt})
    assert st == 10
    for a, b in zip(tree.leaves(params), tree.leaves(restored["params"])):
        assert torch.equal(a, b)

    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    got = serve_tokens(model, serving_params(restored["params"], cfg), prompts)
    want = serve_tokens(model, serving_params(params, cfg), prompts)
    assert got == want
    assert all(len(o) == 5 and all(0 <= t < cfg.vocab_size for t in o) for o in got)


def test_serving_params_cast_and_table_copy():
    """A bf16 config's serving tree: weights at bf16, norm scales and
    biases fp32, as ``model.init`` makes them, and the fp32 table copy
    equal to the trained table's bf16 rounding."""
    import dataclasses

    model, cfg = tiny()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = build_model(cfg)
    params, _ = state_of(model)
    serving = serving_params(params, cfg)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(tree.leaves(serving), tree.leaves(init)):
        assert a.dtype == b.dtype and a.shape == b.shape
    table = serving["embed"]
    assert torch.equal(table["table_f32"], params["embed"]["table"].bfloat16().float())
