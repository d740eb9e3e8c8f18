"""Training launcher (counterpart of ``repro/launch/train.py``): the
reference's flags plus ``--device``.  Trains on the card by default and
raises where there is no CUDA, unless ``--device cpu`` is given (the
kernels' plain PyTorch versions).  With ``--ckpt-dir`` the steps run under
:class:`~repro_torch.runtime.fault_tolerance.TrainingSupervisor`, which
resumes from the newest committed checkpoint there.

When the caller has a process group of several ranks up
(:func:`repro_torch.launch.mesh.init_process_group`), each rank generates
its own shard of every batch (``SyntheticLMData(num_shards=world_size,
shard_id=rank)``, the reference's ``jax.process_count()`` /
``jax.process_index()``), the global batch is their concatenation in rank
order, and the steps run rank-locally through ``jit_train_step`` on a
``world_size x 1`` mesh of the ranks (the gradient all-reduced over them).
With ``--ckpt-dir`` every rank runs the supervisor with its own
``CheckpointManager`` over the same directory, as the reference's
processes do: each rank saves and restores its own shards, and rank 0
commits each step once every rank's shard is written
(:mod:`repro_torch.checkpoint.checkpoint`).  Only rank 0 prints.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
        --steps 100 --batch 8 --seq 128 --device cpu [--ckpt-dir DIR]
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.distributed import all_gather_dim
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import rank_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.compression import compression_init
from repro_torch.runtime.fault_tolerance import TrainingSupervisor
from repro_torch.runtime.train_loop import (
    TrainConfig,
    init_train_state,
    jit_train_step,
    make_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", default="none")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    tc = TrainConfig(
        peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        grad_accum=args.grad_accum,
        remat=args.remat,
        compression=args.compression,
    )
    params, opt, _ = init_train_state(model, torch.Generator(dev).manual_seed(args.seed), dev)
    comp = compression_init(params, tc.compression)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed, num_shards=world,
                           shard_id=rank)
    if world > 1:
        mesh = rank_mesh(f"{world}x1", dev.type)
        compile_for, _ = jit_train_step(model, tc, mesh, params)

        def raw_step(p, o, c, batch, step):
            # the global batch: every rank's shard, in rank order
            batch = {k: all_gather_dim(torch.as_tensor(v, device=dev), 0, ("data",), mesh=mesh)
                     for k, v in batch.items()}
            return compile_for(batch)(p, o, c, batch, step)
    else:
        raw_step = make_train_step(model, tc)

    def step_fn(state, batch, step):
        p, o, c, m = raw_step(state["params"], state["opt"], state["comp"], batch, step)
        return {"params": p, "opt": o, "comp": c}, m

    state = {"params": params, "opt": opt, "comp": comp}
    t0 = time.time()

    def log(s, m):
        if s % args.log_every == 0 and rank == 0:
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e}", flush=True)

    if args.ckpt_dir:
        sup = TrainingSupervisor(
            ckpt_manager=CheckpointManager(args.ckpt_dir, keep=3, async_save=True),
            data=data, ckpt_every=args.ckpt_every,
        )

        def logged_step(state, batch, step):
            state, m = step_fn(state, batch, step)
            log(step, m)
            return state, m

        state, last, history = sup.run(logged_step, state, start_step=0, num_steps=args.steps)
        if rank == 0:
            print(f"finished at step {last} ({sup.restarts} restarts)")
    else:
        history = []
        for s in range(args.steps):
            state, m = step_fn(state, data.batch_at(s), s)
            history.append((s, m))
            log(s, m)

    dt = time.time() - t0
    first, final = float(history[0][1]["loss"]), float(history[-1][1]["loss"])
    if rank == 0:
        print(f"done: {len(history)} steps in {dt:.1f}s "
              f"({dt / max(len(history), 1) * 1e3:.0f} ms/step), loss {first:.4f} -> {final:.4f}")
    return history


if __name__ == "__main__":
    main()
