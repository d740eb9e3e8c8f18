"""Per-op FLOP / byte counter over PyTorch's dispatcher (counterpart of
``repro/roofline/hlo_cost.py``).

The reference walks the compiled HLO of a jitted step.  The port has no
HLO: :class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten op
a step dispatches, on any device (on the meta device nothing is computed,
so a full-width step is counted without memory), and accumulates the
reference's :class:`Cost` with the reference walker's rules:

    views, metadata              no bytes (``NO_BYTES``)
    products                     2 * M * N * K flops (``mm``, ``bmm``,
                                 ``addmm``, ``baddbmm``, convolutions: the
                                 formulas of ``torch.utils.flop_counter``),
                                 operand + result bytes
    reductions                   2 flops per result element
    transcendentals              8 flops + 1 transcendental per element
    plain arithmetic             1 flop per element
    dtype-changing copies        ``cast_bytes`` += 2 x result bytes
    host-to-device copies        no bytes (host values staged as inputs,
                                 as the reference's step takes them)
    slicing, gathering           2 x result bytes
    index_put_ / scatter / copy_ 2 x update bytes
    collectives                  wire bytes by the ring conventions below
    any other op                 operand + result bytes (its boundary)

Eager PyTorch has no fusion: every op boundary is a round trip through
device memory, so ``bytes`` is an upper bound on the HBM traffic of the
step, larger than the reference's fusion-boundary count of the same step.
An operand's bytes are its elements' bytes, capped at its storage's (a
broadcast view reads its storage once).  Trip counts need no parser: an
eager loop dispatches each iteration.

Kernels written by hand dispatch no aten op for their work: each wrapper
charges its launch (``flops``, ``bytes``) inside :func:`kernel`, and the
aten ops inside it (argument checks, the plain version on the CPU, the
meta branch) are not counted a second time.  Kernel charges and products
are also kept apart in ``OpCounter.products`` (the matrix and kernel
work; the rest is elementwise, reductions and data movement) and per
wrapper in ``OpCounter.charges``.

The counter also tracks the peak of live bytes: every storage it sees is
live from then until its last reference goes (a weakref finalizer).

Conventions for collective wire bytes (per participating device):
    all-gather          result bytes
    all-reduce          2 * operand bytes       (reduce-scatter + all-gather)
    reduce-scatter      operand bytes
    all-to-all          operand bytes
    collective-permute  operand bytes
"""

from __future__ import annotations

import contextlib
import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# the reference's dtype table (hlo_cost._DTYPE_BYTES) by its HLO names
HLO_DTYPES = {
    "f64": torch.float64, "f32": torch.float32, "f16": torch.float16,
    "bf16": torch.bfloat16, "f8e4m3fn": torch.float8_e4m3fn, "f8e5m2": torch.float8_e5m2,
    "s64": torch.int64, "u64": torch.uint64, "s32": torch.int32, "u32": torch.uint32,
    "s16": torch.int16, "u16": torch.uint16, "s8": torch.int8, "u8": torch.uint8,
    "pred": torch.bool, "c64": torch.complex64, "c128": torch.complex128,
}
_DTYPE_BYTES = {dt: torch.empty((), dtype=dt).element_size() for dt in HLO_DTYPES.values()}


def shape_bytes(shape, dtype) -> int:
    """Bytes of a ``(shape, dtype)`` array (4 per element for a dtype the
    table lacks, as the reference's default)."""
    return math.prod(shape) * _DTYPE_BYTES.get(dtype, 4)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its elements', capped at its storage's."""
    return min(shape_bytes(t.shape, t.dtype), t.untyped_storage().nbytes())


@dataclass
class Cost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    # dtype-conversion traffic, reported apart from ``bytes`` as the
    # reference reports it (on the card a cast is real traffic: see
    # RooflineTerms.cast_bytes_per_device)
    cast_bytes: float = 0.0
    coll: dict = field(default_factory=dict)
    coll_counts: dict = field(default_factory=dict)

    def __iadd__(self, other):
        self.flops += other.flops
        self.transcendentals += other.transcendentals
        self.bytes += other.bytes
        self.cast_bytes += other.cast_bytes
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0) + v
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v
        return self

    def scaled(self, factor: float) -> "Cost":
        return Cost(
            flops=self.flops * factor,
            transcendentals=self.transcendentals * factor,
            bytes=self.bytes * factor,
            cast_bytes=self.cast_bytes * factor,
            coll={k: v * factor for k, v in self.coll.items()},
            coll_counts={k: v * factor for k, v in self.coll_counts.items()},
        )

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll.values()))


NO_BYTES = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "select", "split", "split_with_sizes", "unbind",
    "diagonal", "as_strided", "alias",
    "detach", "lift_fresh", "view_as_real", "view_as_complex", "unfold",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type", "set", "resize",
    "wait_tensor",
})
PRODUCTS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "_scaled_mm", "convolution", "_convolution",
    "convolution_backward", "linear",
})
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "var_mean", "std",
    "std_mean", "norm", "linalg_vector_norm", "logsumexp", "argmax", "argmin",
    "any", "all", "cumsum", "cumprod", "nansum",
})
ELEMENTWISE_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "tanh", "log", "log2", "log1p", "sigmoid", "rsqrt", "sqrt",
    "pow", "sin", "cos", "expm1", "atan2", "erf", "silu", "gelu", "softplus",
    "_softmax", "_log_softmax", "silu_backward", "gelu_backward",
})
ARITHMETIC = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "eq", "ne", "lt",
    "le", "gt", "ge", "where", "neg", "abs", "clamp", "clamp_min", "clamp_max",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_not", "remainder", "fmod", "floor_divide", "round",
    "floor", "ceil", "trunc", "sign", "reciprocal", "addcmul", "addcdiv", "lerp",
    "masked_fill", "square", "tanh_backward", "sigmoid_backward",
    "threshold_backward", "_softmax_backward_data", "_log_softmax_backward_data",
    "isnan", "isinf", "nan_to_num",
})
SLICING = frozenset({
    "slice", "index_select", "gather", "index", "embedding", "take_along_dim",
    "masked_select",
})
# op -> index of the update operand (args position) it writes
UPDATES = {"index_put": 2, "_index_put_impl": 2, "scatter": 3, "scatter_add": 3,
           "scatter_reduce": 3, "index_add": 3, "index_copy": 3, "copy": 1,
           "slice_scatter": 1, "select_scatter": 1, "masked_scatter": 2}
COLLECTIVES = {
    # functional collectives (torch.distributed._functional_collectives)
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
    # process-group ops (torch.distributed.* on a group)
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
}


def _op_name(func) -> str:
    """The op's packet name, an in-place op under its functional name."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and name not in COLLECTIVES else name


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _sum_bytes(ts) -> int:
    return sum(tensor_bytes(t) for t in ts)


def _elems(ts) -> int:
    return sum(t.numel() for t in ts)


def _product_flops(func, name, args, kwargs, out, outs) -> float:
    """2 * M * N * K of a product: the matrix operands' shapes (any
    ``out_dtype`` argument aside), ``torch.utils.flop_counter``'s formulas
    for the convolutions."""
    if name in ("mm", "bmm", "addmm", "baddbmm", "_scaled_mm"):
        a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
        return 2.0 * math.prod(a.shape) * b.shape[-1]
    if name == "linear":  # (..., in) x (out, in)^T, where it reaches dispatch
        return 2.0 * _elems(outs) * args[0].shape[-1]
    return float(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))


def op_cost(func, args, kwargs, out) -> tuple[Cost, bool]:
    """The :class:`Cost` of one aten op call, and whether it is a product."""
    name = _op_name(func)
    c = Cost()
    if name in NO_BYTES:
        return c, False
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if name in COLLECTIVES:
        kind = COLLECTIVES[name]
        in_b = _sum_bytes(ins)
        wire = _sum_bytes(outs) if kind == "all-gather" else in_b
        c.coll[kind] = 2 * wire if kind == "all-reduce" else wire
        c.coll_counts[kind] = 1
        c.bytes = _sum_bytes(outs)
        return c, False
    if name in PRODUCTS:
        c.flops = _product_flops(func, name, args, kwargs, out, outs)
        c.bytes = _sum_bytes(ins) + _sum_bytes(outs)
        return c, True
    if name == "_to_copy":
        if ins[0].device.type == "cpu" and outs[0].device.type != "cpu":
            return c, False  # host values staged onto the device
        if outs[0].dtype != ins[0].dtype:
            c.cast_bytes = 2 * _sum_bytes(outs)
        else:
            c.bytes = _sum_bytes(ins) + _sum_bytes(outs)
        return c, False
    if name in UPDATES:
        upd = args[UPDATES[name]]
        if isinstance(upd, torch.Tensor):
            ub, n_upd = tensor_bytes(upd), upd.numel()
        else:  # a scalar scattered at every index
            n_upd = args[2].numel()
            ub = n_upd * outs[0].element_size()
        if name == "copy" and upd.dtype != args[0].dtype:
            c.cast_bytes = 2 * ub
        else:
            c.bytes = 2 * ub
        accumulate = name in ("index_add", "scatter_add") or (
            name in ("index_put", "_index_put_impl") and len(args) > 3 and args[3])
        if accumulate:
            c.flops = float(n_upd)
        return c, False
    if name in SLICING:
        c.bytes = 2 * _sum_bytes(outs)
        return c, False
    elems = _elems(outs)
    if name in REDUCTIONS:
        c.flops = 2.0 * elems
    elif name in ELEMENTWISE_TRANSCENDENTAL:
        c.transcendentals = float(elems)
        c.flops = 8.0 * elems
    elif name in ARITHMETIC:
        c.flops = float(elems)
    c.bytes = _sum_bytes(ins) + _sum_bytes(outs)
    return c, False


class OpCounter(TorchDispatchMode):
    """Accumulates the :class:`Cost` of every aten op dispatched while it
    is entered (``with OpCounter() as c: step(...)``), plus the kernel
    charges of :func:`kernel`.

    ``cost``: everything; ``products``: the products' and the kernels' share
    of it; ``charges``: per kernel wrapper name; ``n_ops``: aten ops
    counted; ``peak_bytes``: the most bytes of storages it had seen alive at
    once."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.products = Cost()
        self.charges: dict[str, Cost] = {}
        self.launches: dict[str, int] = {}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._suspended = 0

    # -- live bytes -------------------------------------------------------- #
    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, ts) -> None:
        for t in ts:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._release, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- the mode ---------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        self.n_ops += 1
        c, is_product = op_cost(func, args, kwargs, out)
        self.cost += c
        if is_product:
            self.products += c
        self._track(_tensors((args, kwargs, out)))
        return out

    def charge(self, name: str, flops: float, nbytes: float, transcendentals: float = 0.0):
        c = Cost(flops=float(flops), bytes=float(nbytes), transcendentals=float(transcendentals))
        self.cost += c
        self.products += c
        self.charges.setdefault(name, Cost())
        self.charges[name] += c
        self.launches[name] = self.launches.get(name, 0) + 1

    @contextlib.contextmanager
    def suspended(self):
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1


def active_counters() -> list[OpCounter]:
    """The :class:`OpCounter` modes entered on this thread, innermost last."""
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, OpCounter)]


def counting() -> bool:
    """Whether a counter may be entered (any dispatch mode is): one
    integer read, so a wrapper that sees False launches at once, without
    building its charge or entering :func:`kernel`."""
    return torch._C._len_torch_dispatch_stack() > 0


def charge(flops: float, bytes: float, transcendentals: float = 0.0, *, name: str = "kernel"):
    """Add one kernel launch's work to every entered counter."""
    for c in active_counters():
        c.charge(name, flops, bytes, transcendentals)


@contextlib.contextmanager
def kernel(name: str, cost_fn):
    """One kernel launch: where a counter is entered, charge ``cost_fn()``
    (``(flops, bytes)``; host reads allowed: the counting pass is not
    timed) to it under ``name`` and count no aten op inside the block;
    elsewhere do nothing (``cost_fn`` is not called).  Wrappers enter it
    only where :func:`counting`."""
    counters = active_counters()
    if not counters:
        yield
        return
    with contextlib.ExitStack() as stack:
        for c in counters:
            stack.enter_context(c.suspended())
        flops, nbytes = cost_fn()
        charge(flops, nbytes, name=name)
        yield
