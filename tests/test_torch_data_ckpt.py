"""The synthetic data pipeline and the checkpoint manager
(``repro_torch.data``, ``repro_torch.checkpoint``) against the JAX
package's, on the CPU: batches bit-equal to the reference's, the
reference's checkpoint cases on the port, and checkpoints crossing between
the packages in both directions (the same layout: JAX key-path names, bf16
as ``uint16`` with ``bfloat16`` in the manifest), bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import convert_opt_state, convert_params
from repro_torch.core import tree
from repro_torch.data.pipeline import IGNORE, SyntheticLMData
from repro_torch.optim.adamw import adamw_init


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=128, global_batch=8, seed=3),
    dict(vocab_size=151936, seq_len=2048, global_batch=2, seed=0),
    dict(vocab_size=100, seq_len=32, global_batch=8, seed=0, num_shards=4, shard_id=2),
    dict(vocab_size=512, seq_len=64, global_batch=4, seed=9, mean_doc_len=16),
])
def test_batches_equal_reference(kw):
    ours, ref = SyntheticLMData(**kw), RefData(**kw)
    for step in (0, 1, 42):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_data_determinism_and_sharding():
    d = SyntheticLMData(vocab_size=1000, seq_len=128, global_batch=8, seed=3)
    np.testing.assert_array_equal(d.batch_at(42)["tokens"], d.batch_at(42)["tokens"])
    assert not np.array_equal(d.batch_at(42)["tokens"], d.batch_at(43)["tokens"])
    shards = [SyntheticLMData(vocab_size=100, seq_len=32, global_batch=8, seed=0, num_shards=4,
                              shard_id=i) for i in range(4)]
    assert all(s.local_batch == 2 for s in shards)
    assert not np.array_equal(shards[0].batch_at(0)["tokens"], shards[1].batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLMData(vocab_size=100, seq_len=32, global_batch=6, num_shards=4)


def test_data_labels_shifted_and_masked():
    b = SyntheticLMData(vocab_size=50, seq_len=64, global_batch=2, seed=1).batch_at(0)
    assert (b["labels"][:, -1] == IGNORE).all()
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 50


def test_data_prefetch_iterator():
    d = SyntheticLMData(vocab_size=50, seq_len=16, global_batch=2, seed=1)
    it = d.iterate(start_step=5)
    step, batch = next(it)
    assert step == 5
    np.testing.assert_array_equal(batch["tokens"], d.batch_at(5)["tokens"])
    assert next(it)[0] == 6
    it.close()


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def state():
    return {
        "params": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                   "layers": [{"b": torch.ones(3)}, {"b": torch.full((3,), 2.0)}]},
        "opt": adamw_init({"w": torch.zeros((2, 3))}),
        "comp": None,
        "step": torch.tensor(7, dtype=torch.int32),
    }


def assert_trees_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip_and_layout(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = state()
    mgr.save(10, st)
    step, restored = mgr.restore_latest(st)
    assert step == 10
    assert_trees_equal(restored, st)
    assert restored["params"]["w"].dtype == torch.bfloat16
    with open(tmp_path / "step_00000010" / "manifest.json") as f:
        man = json.load(f)
    i = man["names"].index("['params']/['w']")
    assert man["dtypes"][i] == "bfloat16"
    assert "['opt']/.count" in man["names"] and "['params']/['layers']/[1]/['b']" in man["names"]
    with np.load(tmp_path / "step_00000010" / "shard_00000.npz") as z:
        assert z[f"a{i}"].dtype == np.uint16
    assert os.path.exists(tmp_path / "step_00000010" / "COMMIT")


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, state())
    assert mgr.committed_steps() == [3, 4]


def test_checkpoint_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, state())
    bad = tmp_path / "step_00000009"
    os.makedirs(bad)
    (bad / "shard_00000.npz").write_bytes(b"garbage")
    step, _ = mgr.restore_latest(state())
    assert step == 5


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    st = state()
    mgr.save(3, st)
    st["params"]["w"].add_(1)  # the host copy was taken at save: later writes do not leak in
    mgr.wait()
    assert mgr.committed_steps() == [3]
    _, restored = mgr.restore_latest(st)
    assert torch.equal(restored["params"]["w"], st["params"]["w"] - 1)


def test_checkpoint_tree_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"params": state()["params"]})


def test_reference_checkpoint_restores_through_port(tmp_path):
    """A train state the JAX package saved — stacked fp32 parameters, the
    AdamW state after a step, a bf16 leaf — reads back through the port's
    manager and ``convert_params`` / ``convert_opt_state`` bit for bit."""
    ref_cfg = ref_get_config("qwen1.5-0.5b", smoke=True)
    params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    g = jax.tree.map(lambda p: p * 0.5, params)
    _, opt, _ = ref_adamw.adamw_update(g, ref_adamw.adamw_init(params), params,
                                       lr=jnp.float32(1e-3))
    half = jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4)
    RefCheckpointManager(str(tmp_path)).save(4, {"params": params, "opt": opt, "half": half})

    mgr = CheckpointManager(str(tmp_path))
    assert mgr.committed_steps() == [4]
    tree_ = mgr.read(4)
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    assert_trees_equal(convert_params(tree_["params"], cfg, device="cpu"),
                       convert_params(params, cfg, device="cpu"))
    got, want = (convert_opt_state(tree_["opt"], cfg, device="cpu"),
                 convert_opt_state(opt, cfg, device="cpu"))
    assert_trees_equal(got, want)
    assert tree_["half"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree_["half"].float().numpy(), np.asarray(half, np.float32))


def test_port_checkpoint_restores_through_reference(tmp_path):
    """The other way: the reference's manager restores what the port wrote
    (bf16 and int32 leaves included)."""
    st = state()
    CheckpointManager(str(tmp_path)).save(2, st)
    like = {
        "params": {"w": jnp.zeros((2, 3), jnp.bfloat16),
                   "layers": [{"b": jnp.zeros(3)}, {"b": jnp.zeros(3)}]},
        "opt": ref_adamw.adamw_init({"w": jnp.zeros((2, 3))}),
        "comp": None,
        "step": jnp.int32(0),
    }
    step, restored = RefCheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 2
    for a, b in zip(jax.tree.leaves(restored), tree.leaves(st)):
        assert np.asarray(a).dtype == (jnp.bfloat16 if b.dtype == torch.bfloat16
                                       else b.numpy().dtype)
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
