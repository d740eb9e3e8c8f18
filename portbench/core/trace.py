"""A traced stretch of steps: ``torch.profiler`` with device activity only
(no host op recording, no sync between steps, so the host runs as it does
in the window) around ``n`` steps, reduced to the device's kernels, its
busy time (the union of every kernel, copy and set) over the stretch's
host-clock length, and the idle gaps with the CUDA runtime call that was
open in each.

The kernel name classes are a frozen copy of the program's
``launch/decode_trace.py`` (cuBLAS products, the port's attention
kernels, and the rest as small ops)."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

CUBLAS = ("gemm", "cutlass", "nvjet", "xmma", "cublas")
ATTENTION = ("mla_decode_queue", "combine_kernel", "mla_decode_rows", "gqa_decode",
             "gqa_rows", "flash_prefill", "mla_decode_padded")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 120


def kind_of(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ATTENTION):
        return "attention"
    if any(k in low for k in CUBLAS):
        return "cublas"
    return "small_ops"


@dataclasses.dataclass
class Traced:
    steps: int
    window_s: float
    busy_s: float
    kernels: list  # (name, seconds) of every kernel of the stretch
    idle: list  # (the runtime call open, seconds) of every idle gap between device ops

    def kernel_s(self, pred) -> float:
        return sum(d for n, d in self.kernels if pred(n))

    def breakdown(self, top: int = 10) -> dict:
        def ranked(pairs):
            total: dict = {}
            for n, d in pairs:
                total[n[:NAME_CHARS]] = total.get(n[:NAME_CHARS], 0.0) + d
            return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(self.kernels), "idle_gaps": ranked(self.idle)}


def _union(intervals) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events: list, steps: int, window_s: float) -> Traced:
    """Reduce a chrome trace's events (times in µs) of a stretch of
    ``steps`` steps that lasted ``window_s`` on the host's clock."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    kernels = [(e["name"], e["dur"] / 1e6) for e in device if e["cat"] == "kernel"]
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and "dur" in e),
                  key=lambda e: e["ts"])
    idle, nxt, open_ = [], 0, []
    for (_, edge), (a, _) in zip(busy, busy[1:]):
        # the shortest runtime call open at the gap's middle names it
        mid = 0.5 * (edge + a)
        while nxt < len(host) and host[nxt]["ts"] <= mid:
            open_.append(host[nxt])
            nxt += 1
        open_ = [e for e in open_ if e["ts"] + e["dur"] >= mid]
        what = min(open_, key=lambda e: e["dur"])["name"] if open_ else "host: no runtime call"
        idle.append((what, (a - edge) / 1e6))
    return Traced(steps=steps, window_s=window_s,
                  busy_s=sum(b - a for a, b in busy) / 1e6, kernels=kernels, idle=idle)


def trace_steps(step, n: int) -> Traced:
    """Run ``step()`` ``n`` times under the profiler, timed from a synced
    device to the device synced after the last, and reduce the trace
    (written under ``TMPDIR``, read and deleted)."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events, n, window_s)
