"""Perf hillclimbing tool: count ONE (arch x shape) cell under a knob
combination and report the roofline terms (counterpart of
``repro/launch/hillclimb.py``, which lowers and compiles the cell).

Knobs:
    --policy   tp_fsdp | fsdp | fsdp2d | dp      parallelism layout
    --accum    gradient accumulation factor       (train cells)
    --remat    on | off                           (train cells)
    --loss-chunks N                               chunked-CE chunk count

Each invocation prints one CSV row and, with ``--out``, appends a JSON
record.  The count is :mod:`repro_torch.launch.dryrun`'s, on meta-device
stand-ins (no card, no arithmetic):

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch qwen1.5-0.5b --shape train_4k --policy fsdp2d --accum 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import LM_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import analysis
from repro_torch.runtime.mesh_ctx import mesh_ctx


def count_cell(arch, shape_name, *, multi_pod, policy, accum, remat, loss_chunks):
    """One card's :class:`~repro_torch.launch.dryrun.Count` of the cell
    under the knobs (prefill and decode take the policy only)."""
    shape = LM_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")  # shapes only
    with mesh_ctx(mesh, policy, multi_pod):
        if shape.kind == "train":
            return dryrun.count_train(arch, shape_name, mesh, multi_pod, policy=policy,
                                      accum=accum, remat=remat, loss_chunks=loss_chunks)
        return dryrun.COUNTERS[shape.kind](arch, shape_name, mesh, multi_pod, policy=policy)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--policy", default="tp_fsdp")
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--remat", default="on", choices=["on", "off"])
    ap.add_argument("--loss-chunks", type=int, default=16)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="append JSON record here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = LM_SHAPES[args.shape]
    n_chips = 512 if args.multi_pod else 256
    t0 = time.time()
    count = count_cell(
        args.arch, args.shape,
        multi_pod=args.multi_pod, policy=args.policy, accum=args.accum,
        remat=args.remat == "on", loss_chunks=args.loss_chunks,
    )
    dt = time.time() - t0
    mf = analysis.model_flops(cfg, shape)
    terms = analysis.roofline_from_cost(count.cost, model_flops_total=mf, n_chips=n_chips)
    temp = count.memory["temp_size_in_bytes"]
    rec = {
        "tag": args.tag,
        "arch": args.arch,
        "shape": args.shape,
        "policy": args.policy,
        "accum": args.accum,
        "remat": args.remat,
        "loss_chunks": args.loss_chunks,
        "multi_pod": args.multi_pod,
        "count_s": round(dt, 1),
        "temp_bytes": int(temp),
        "roofline": terms.to_dict(),
        "coll_bytes": count.cost.coll,
        "coll_counts": count.cost.coll_counts,
    }
    print(
        "tag,policy,accum,remat,chunks,compute_s,memory_s,collective_s,"
        "dominant,bound_ms,useful,roofline_frac,temp_GB"
    )
    r = terms.to_dict()
    print(
        f"{args.tag},{args.policy},{args.accum},{args.remat},"
        f"{args.loss_chunks},{r['compute_s']:.4f},{r['memory_s']:.4f},"
        f"{r['collective_s']:.4f},{r['dominant']},"
        f"{r['bound_time_s'] * 1e3:.1f},{r['useful_ratio']:.3f},"
        f"{r['roofline_fraction']:.4f},{temp / 1e9:.2f}"
    )
    print("coll bytes:", {k: f"{v / 1e9:.2f}GB" for k, v in count.cost.coll.items()})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
