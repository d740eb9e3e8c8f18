"""One run of one cell: weights and requests from the seed, set-up, the
measured window, optionally a traced stretch after it, the correctness
check, and the metrics the cell reports."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import math
import time

from portbench.core import check, spec, stats, trace, weights


@dataclasses.dataclass
class Context:
    """What a metric reader reads (``metrics/<name>.py``: ``read(ctx)``)."""

    cell: spec.Cell
    matmul_params: int  # weights a token multiplies by
    head_params: int  # of them, the unembedding's (a prompt runs it at its last token only)
    setup_s: float
    t0: float  # the window, host clock
    t1: float
    steps: int
    records: list
    counters: tuple  # the session's counters at t0 and at t1
    traced: trace.Traced | None = None
    traced_kv: list | None = None  # per traced step, every live request's keys
    tokens_compared: int = 0
    setup_parts: dict | None = None  # seconds of each part of the set-up
    step_s: list | None = None  # host-clock length of each step of the window
    readings: dict | None = None  # the widest gap of each reading (``check.gaps``)
    check_s: float = 0.0  # the correctness check's seconds (after the window)

    @property
    def model(self) -> dict:
        return self.cell.model

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def port_config(config: dict):
    """The program's ``ModelConfig`` from a configuration file's ``model``."""
    from repro_torch.configs.base import MLAConfig, ModelConfig

    fields = dict(config["model"])
    if fields.get("mla"):
        fields["mla"] = MLAConfig(**fields["mla"])
    for key in ("layer_pattern", "mrope_sections"):
        if key in fields:
            fields[key] = tuple(fields[key])
    return ModelConfig(name=config["name"], **fields)


def build_model_for(config: dict):
    """The program's model object of a configuration file."""
    from repro_torch.models.model_zoo import build_model

    return build_model(port_config(config))


def check_layout(model, leaves) -> None:
    """The reference's leaves are the program's tree, path for path (the
    program's own fp32 copy of the unembedding table aside)."""
    port = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(path + (i,), v)
        elif path[-1] != "table_f32":
            port[path] = (tuple(node.shape), node.dtype)

    walk((), model.init(None, "meta"))
    ours = {leaf.path: (tuple(leaf.shape), leaf.dtype) for leaf in leaves}
    if ours != port:
        diff = sorted(set(ours.items()) ^ set(port.items()), key=str)[:6]
        raise SystemExit(f"the reference's weight layout is not the program's: {diff}")


def part(folder: str, name: str):
    """``portbench/<folder>/<name>.py``: a session kind, a traffic kind or
    a metric's reader, found by the name the cell's files give."""
    path = spec.HERE / folder / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no {folder}/{name}.py in the benchmark")
    mod_spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def read_metrics(entries: list, ctx: Context) -> dict:
    """Each metric's reader; one that finds nothing to read is left out."""
    out = {}
    for entry in entries:
        value = part("metrics", entry["name"]).read(ctx)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


class Driver:
    """Requests into the session, tokens out, every token timed when the
    host has read it."""

    def __init__(self, sess, clock=time.perf_counter):
        self.sess, self.clock = sess, clock
        self.records: list[stats.Record] = []
        self.by_rid: dict[int, stats.Record] = {}

    def send(self, prompt) -> stats.Record:
        rec = stats.Record(prompt=prompt.tolist())
        rec.rid = self.sess.add(rec.prompt)
        if rec.rid is None:
            raise RuntimeError("the session refused a request the cell sized it for")
        self.records.append(rec)
        self.by_rid[rec.rid] = rec
        self.harvest(self.clock())
        return rec

    def harvest(self, now: float) -> None:
        for rid in self.sess.live():
            rec = self.by_rid[rid]
            new = self.sess.tokens(rid)[len(rec.tokens):]
            rec.tokens += new
            rec.times += [now] * len(new)

    def step(self) -> float:
        self.sess.step()
        now = self.clock()
        self.harvest(now)
        return now

    def kv_lens(self) -> list[int]:
        """Keys each live request attends at the next step (its prompt, the
        tokens written back, and the one it feeds now)."""
        return [len(self.by_rid[r].prompt) + len(self.by_rid[r].tokens) for r in self.sess.live()]


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        t_start: float | None = None, session_hook=None,
        readings: tuple = ()) -> tuple[dict, "Context"]:
    """One run; returns (the result's line, the run's context).
    ``session_hook(sess)`` may wrap the session (the tests' faults);
    ``readings`` names more of ``check.gaps``' readings to take on the same
    sample (``ctx.readings``: the calibration, never a benchmark run)."""
    import torch

    from repro_torch.models import layers as port_layers

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    wl = cell.workload
    reference = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    leaves = reference.leaves(cell.model)
    model = build_model_for(cell.config)
    check_layout(model, leaves)

    # -- set-up: weights, the program's own preparation of them, its kernel
    # build, prefill, warm-up (the graph captures)
    parts = {"imports": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name], mark = now - mark, now

    params = weights.make(leaves, seed, device)
    port_layers.keep_fp32_table(params["unembed"])
    lap("weights")
    if cuda:
        from repro_torch.kernels import _build

        _build.build()
        lap("build")
    load = part("drivers", cell.traffic["kind"]).Load(cell.traffic, seed,
                                                      cell.model["vocab_size"])
    extra = wl["warm_steps"] + (wl["trace_steps"] if traced else 0)
    headroom = extra + math.ceil(seconds * 1e3 / wl["step_floor_ms"]) + 1
    Session = part("sessions", wl["session"]["kind"]).Session
    sess = Session(model, params, wl["session"], live=load.live, max_prompt=load.longest,
                   headroom=headroom)
    if session_hook is not None:
        sess = session_hook(sess)
    drv = Driver(sess)
    load.setup(drv, wl["warm_steps"], lap)
    # what set-up left behind goes to the collector's permanent generation,
    # so a collection inside the window does not walk the weight tree
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # -- the window
    c0 = sess.counters()
    t0 = drv.clock()
    ends = [t0]
    while ends[-1] - t0 < seconds:
        ends.append(load.step(drv))
    t1, steps = ends[-1], len(ends) - 1
    c1 = sess.counters()
    tr, traced_kv = None, None
    if traced:
        traced_kv = []

        def one():
            traced_kv.append(drv.kv_lens())
            load.step(drv)

        tr = trace.trace_steps(one, wl["trace_steps"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    sess.close()
    del sess, drv.sess
    params["unembed"].pop("table_f32", None)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check: the plain reference over a sample of what was served
    t_check = time.perf_counter()
    in_window = [r for r in drv.records if any(t0 < t <= t1 for t in r.times)]
    failed = len(drv.records) - len(in_window)
    picked = check.sample(drv.records, wl["check"]["requests"], seed)
    got = check.gaps(reference, params, cell.model, picked, device, ("program",) + readings)
    limits = {"widest_gap": wl["check"]["max_gap"], "failed": 0}
    compared = {"widest_gap": got["program"], "failed": failed}
    correct = all(compared[k] <= limits[k] for k in limits)
    if cuda:
        torch.cuda.synchronize()
    check_s = time.perf_counter() - t_check

    head = [leaf for leaf in leaves if leaf.path == ("unembed", "table")]
    ctx = Context(cell=cell, matmul_params=weights.flops_params(leaves),
                  head_params=weights.flops_params(head), setup_s=setup_s,
                  t0=t0, t1=t1, steps=steps, records=drv.records, counters=(c0, c1),
                  traced=tr, traced_kv=traced_kv,
                  step_s=[b - a for a, b in zip(ends, ends[1:])])
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end, ctx)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": len(drv.records), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["check"] = {k: {"value": compared[k], "limit": limits[k]} for k in limits}
    ctx.tokens_compared, ctx.setup_parts, ctx.check_s = got.pop("tokens"), parts, check_s
    ctx.readings = got
    return result, ctx
