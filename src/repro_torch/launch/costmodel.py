"""Cost model for the roofline: flops and bytes of a recorded run, and the
bytes its collectives move.

Port of `repro.launch.costmodel`. The reference walks a traced jaxpr
(`jaxpr_cost`), where scan lengths are static, and parses the compiled
HLO for collectives (`collective_bytes`). The port has neither: its
program is eager Python. Its analogue of the jaxpr is a **recorded run**
of the port's own program under a `TorchDispatchMode` (`count`,
`Recording`), on real tensors or on ``meta`` tensors (shapes only, no
storage: the port's `jax.eval_shape`). Eager loops run every trip, so a
trip count is exact by construction ("loops multiply").

What a run counts (the reference's classification, `costmodel.py:39-54`
there):

* matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``, ``convolution``): exact flops (2 M N K) and their operand and
  output bytes;
* element-wise ops: 1 flop an output element and no bytes (assumed fused,
  as in the reference);
* gathers, scatters, reductions, sort, cumsum, top-k and ``arange`` (the
  reference's ``iota``): operand and output bytes. A gather reads the rows
  it addresses, not its whole table (ROADMAP Queue 3): its bytes are the
  rows read, the output written and the index read; a scatter's the values
  read, the rows written and the index;
* views, reshapes, copies and dtype conversions are free;
* a host read of a device value (``aten._local_scalar_dense``,
  ``aten.is_nonzero``) is data-dependent control flow, the analogue of the
  reference's ``while``: each counts one ``unknown_loops``.

``bytes`` is that fusion-optimistic figure. ``eager_bytes`` is the second
figure: every op's operands and outputs (views excepted; a gather's and a
scatter's as above), which is what the unfused program moves; `launch.dryrun` records it as the reference's
``cost_analysis_raw``.

**The hand kernels** (`kernels.ops`, ctypes launches the dispatcher never
sees) each declare their cost, a function of the shapes
(`kernels.costs`, the formula chip_smoke.py's bounds use). Under an active
count an entry adds its declared cost once a call, whichever route runs
(hand kernel or plain twin), and the ops inside it are not counted
(`repro_torch._count.declared`). With no count active the hook is one
list test.

**Collectives** (`collective_bytes`): the points where positions of a
mesh meet report their bytes and group size to the active count
(`repro_torch._count.collective`), and the ops inside them are not
counted as compute. A `Recording` is the `_count.Tally` those hooks
report to, pushed by `count`. Each call counts its logical
bytes by the layout (not the physical copies: on one card the "copies"
between logical shards are copies within its memory), with the
reference's ring factors: (g - 1) / g of the tensor a position holds
after the collective (the gathered tensor, or the summed one of a reduce),
2 (g - 1) / g for an all-reduce. The nearest reference kind of each:

=========================================  =====================  ======================
point where positions meet                 forward                backward
=========================================  =====================  ======================
``spmd.replicate`` (owner to its shards)   all-gather (a bcast)   reduce-scatter (a reduce)
``spmd.model_sum`` (shards to the owner)   reduce-scatter         all-gather
``spmd.gather`` (a weight at its use)      all-gather             reduce-scatter
``spmd.model_gather``                      all-gather             reduce-scatter
``spmd.model_sum_scatter``                 reduce-scatter         all-gather
``spmd.model_allsum``                      its model_sum and      (theirs)
                                           replicate: a ring
                                           all-reduce
``spmd.gather_rows`` (rows to every group) all-gather             reduce-scatter
``spmd.batch_fold`` (groups' scalars)      all-reduce             all-gather
``spmd.replica_sum`` (replicas' grads)     all-reduce             --
``core.distributed`` model-axis sum        all-reduce (psum)      --
``core.distributed`` vote                  all-reduce (pmax)      --
``core.distributed`` doc gather            all-gather             --
=========================================  =====================  ======================

``collective_bytes`` also keeps the counts by these names (``by_name``).

**Scope.** The port's mesh program runs every position in one thread, so
every count is **global**, the sum over positions, for the WMD program
too (the reference counts its shard_map per device); the roofline divides
by chips for every cell (ROADMAP Queue 3).

**Data-dependent ops on meta.** ``aten::unique_consecutive`` (the
embedding backward), ``unique``, ``nonzero`` and ``masked_select`` have no
meta kernel or a data-dependent shape: on meta tensors the count answers
with the worst-case shapes (every element distinct, every one selected)
and counts how many ops it answered so (``worst_case_ops``).

**Memory.** A run also tracks the bytes of the storages its ops allocate
(``live_bytes``, ``peak_bytes``): `launch.dryrun`'s ``temp_size_in_bytes``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import _count

# ---------------------------------------------------------------------------
# the classification
# ---------------------------------------------------------------------------

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "exp2",
    "log", "log2", "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "neg", "abs",
    "floor", "ceil", "round", "sign", "erf", "erfinv", "cos", "sin",
    "where", "clamp", "clamp_min", "clamp_max", "nextafter", "remainder",
    "fmod", "atan2", "expm1", "log1p", "square", "reciprocal", "silu",
    "gelu", "relu", "softplus", "lerp", "addcmul", "addcdiv", "logit",
    "masked_fill", "tanh_backward", "sigmoid_backward", "silu_backward",
    "gelu_backward", "threshold_backward", "softplus_backward",
}
_BYTES_OPS = {
    "sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "sort",
    "cumsum", "logcumsumexp", "cummax", "cummin", "topk", "arange", "var",
    "var_mean", "std", "norm", "linalg_vector_norm", "logsumexp", "any",
    "all", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "segment_reduce",
    "_segment_reduce_backward", "unique_consecutive", "_unique2",
    "unique_dim", "nonzero", "masked_select", "nansum", "count_nonzero",
    "median", "kthvalue", "searchsorted", "bincount",
}
_REDUCING_MINMAX = {"max", "min"}      # with a dim: a reduction; else binary
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
_SCATTERS = {"index_put", "_index_put_impl", "scatter", "scatter_add",
             "scatter_reduce", "index_add", "index_copy",
             "embedding_dense_backward"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
            "dot", "vdot"}
_CONVS = {"convolution", "_convolution"}
_HOST_READS = {"_local_scalar_dense", "is_nonzero"}
_DATA_DEPENDENT = {"unique_consecutive", "_unique2", "unique_dim",
                   "nonzero", "masked_select"}
_NO_WRITE = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided"}

# the reference's HLO dtype table, by torch dtype
_DTYPE_BYTES = {
    torch.float64: 8, torch.float32: 4, torch.bfloat16: 2,
    torch.float16: 2, torch.int64: 8, torch.int32: 4, torch.int16: 2,
    torch.int8: 1, torch.uint8: 1, torch.bool: 1, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.complex64: 8, torch.complex128: 16,
    torch.uint16: 2, torch.uint32: 4, torch.uint64: 8,
}


def _shape_bytes(shape, dtype) -> float:
    """Bytes of a tensor of ``shape`` and ``dtype`` (the reference parses
    them from HLO text; the port reads them off the tensor)."""
    n = 1
    for d in shape:
        n *= int(d)
    return float(n * _DTYPE_BYTES[dtype])


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size()))


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    unknown_loops: int = 0

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.collective_bytes + o.collective_bytes,
                    self.unknown_loops + o.unknown_loops)

    def __mul__(self, k: float):
        return Cost(self.flops * k, self.bytes * k,
                    self.collective_bytes * k, self.unknown_loops)


class Recording(_count.Tally):
    """What one counted run did (module docstring): beside a `Tally`'s
    kernels and collectives, ``flops`` (of them ``matmul_flops``, the
    matmul-like ops'), ``bytes`` (fusion-optimistic), ``eager_bytes``,
    ``unknown_loops``, ``worst_case_ops``; ``ops`` (op name -> calls
    counted); ``kernel_cost`` (entry -> summed Cost); ``live_bytes`` /
    ``peak_bytes`` of the storages the run allocated (those of ops run
    quiet too); ``seconds``."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0.0
        self.unknown_loops = 0
        self.worst_case_ops = 0
        self.ops: collections.Counter = collections.Counter()
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self.seconds = 0.0
        self._tracked: dict = {}

    @property
    def kernel_cost(self) -> dict:
        return {k: Cost(flops=f, bytes=b)
                for k, (b, f) in self.kernel_sums.items()}

    # -- memory ---------------------------------------------------------------
    def _track(self, out, args) -> None:
        """Track the storages of a (not in-place, not view) op's outputs
        that are not one of its inputs."""
        for t in out:
            if any(t is a for a in args):
                continue
            s = t.untyped_storage()
            key = id(s)
            if key in self._tracked:
                continue
            n = float(s.nbytes())
            self._tracked[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(s, self._release, key)

    def _release(self, key) -> None:
        self.live_bytes -= self._tracked.pop(key, 0.0)

    # -- the op -----------------------------------------------------------------
    def _op(self, func, args, ins, outs) -> None:
        name = func.overloadpacket.__name__
        kind = _kind(func)
        if kind == "host":
            self.unknown_loops += 1
            return
        self.ops[name] += 1
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        if kind == "gather":
            idx = sum(_nbytes(t) for t in ins
                      if not t.is_floating_point() and t.dtype != torch.bool)
            moved = 2 * out_b + idx
            self.bytes += moved
            self.eager_bytes += moved
            return
        if kind == "scatter":
            moved = _scatter_bytes(name, args)
            self.bytes += moved
            self.eager_bytes += moved
            return
        self.eager_bytes += (in_b + (0.0 if name in _NO_WRITE else out_b))
        if kind in ("matmul", "conv"):
            f = _matmul_flops(name, args) if kind == "matmul" \
                else _conv_flops(args, outs)
            self.flops += f
            self.matmul_flops += f
            self.bytes += in_b + out_b
        elif kind == "elementwise":
            self.flops += float(sum(t.numel() for t in outs))
        elif kind == "bytes":
            self.bytes += in_b + out_b


def _tensors(*trees) -> list:
    """The tensors of ops' arguments or outputs: tensors, and lists,
    tuples and dicts of them, one level deep."""
    out = []
    for tree in trees:
        items = tree.values() if isinstance(tree, dict) else \
            tree if isinstance(tree, (list, tuple)) else (tree,)
        for x in items:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _broadcast(shapes) -> tuple:
    """The broadcast of int shapes (`torch.broadcast_shapes` without its
    symbolic-shape machinery)."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _kind(func) -> str:
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and name != "_" else name
    if base in _HOST_READS:
        return "host"
    if func.is_view:
        return "view"
    if base in _MATMULS:
        return "matmul"
    if base in _CONVS:
        return "conv"
    if base in _GATHERS:
        return "gather"
    if base in _SCATTERS:
        return "scatter"
    if base in _REDUCING_MINMAX:
        overload = func._overloadname
        return "elementwise" if overload in ("other", "binary") else "bytes"
    if base in _ELEMENTWISE:
        return "elementwise"
    if base in _BYTES_OPS:
        return "bytes"
    return "free"


def _matmul_flops(name: str, args) -> float:
    base = name.rstrip("_")
    if base in ("addmm", "baddbmm", "addbmm", "addmv"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if base in ("dot", "vdot"):
        return 2.0 * a.shape[0]
    if base in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    if base in ("bmm", "baddbmm", "addbmm"):
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _conv_flops(args, outs) -> float:
    w = args[1]
    per_out = 1
    for d in w.shape[1:]:
        per_out *= int(d)
    return 2.0 * outs[0].numel() * per_out if outs else 0.0


def _scatter_bytes(name: str, args) -> float:
    """Values read, rows written, index read."""
    ts = [a for a in _tensors(args)]
    if not ts:
        return 0.0
    dst, rest = ts[0], ts[1:]
    vals = [t for t in rest if t.dtype == dst.dtype]
    idx = [t for t in rest if t.dtype != dst.dtype]
    if name.startswith("embedding_dense_backward"):
        return 2 * _nbytes(ts[0]) + sum(_nbytes(t) for t in ts[1:])
    v = sum(_nbytes(t) for t in vals) if vals else _nbytes(dst)
    return 2 * v + sum(_nbytes(t) for t in idx)


def _worst_case(name: str, args, kwargs):
    """The worst-case outputs of a data-dependent op on meta tensors
    (every element distinct, every one selected), or None."""
    x = args[0]
    n = x.numel()
    long = dict(dtype=torch.int64, device=x.device)
    if name in ("unique_consecutive", "_unique2"):
        # (self, [sorted,] return_inverse, return_counts, ...)
        flags = list(args[2 if name == "_unique2" else 1:]) + [False] * 2
        inverse = kwargs.get("return_inverse", flags[0])
        counts = kwargs.get("return_counts", flags[1])
        return (torch.empty((n,), dtype=x.dtype, device=x.device),
                torch.empty(tuple(x.shape) if inverse else (0,), **long),
                torch.empty((n,) if counts else (0,), **long))
    if name == "nonzero":
        return torch.empty((n, x.dim()), **long)
    if name == "masked_select":
        shape = torch.broadcast_shapes(x.shape, args[1].shape)
        m = 1
        for d in shape:
            m *= d
        return torch.empty((m,), dtype=x.dtype, device=x.device)
    return None


_COMPARISONS = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and",
                "logical_or", "logical_not", "logical_xor", "bitwise_and",
                "bitwise_or", "bitwise_not", "bitwise_xor", "isnan",
                "isinf", "isfinite"}


@functools.lru_cache(maxsize=None)
def _fast_kind(func) -> str | None:
    """How `_meta_answer` makes ``func``'s output on meta tensors, if it
    does: "pointwise" (the broadcast of its tensor arguments, its dtype
    from a one-element stand-in), "inplace", "convert", "mm" or "bmm"."""
    name = func.overloadpacket.__name__
    if "out" in func._overloadname:
        return None
    if name in ("_to_copy", "clone"):
        return "convert"
    if name in ("mm", "bmm"):
        return name
    base = name[:-1] if name.endswith("_") else name
    if base in _ELEMENTWISE or base in _COMPARISONS:
        return "inplace" if name.endswith("_") else "pointwise"
    return None


def _stand_in(x):
    """A one-element CPU tensor of ``x``'s dtype and rank (so that it
    promotes as ``x`` does); a non-tensor as it is."""
    if isinstance(x, torch.Tensor):
        return torch.zeros((1,) * x.dim(), dtype=x.dtype)
    return x


def _key(x):
    """What of an argument decides a pointwise op's result dtype: a
    tensor's dtype and whether it has dimensions, a scalar's type, any
    other value itself."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, x.dim() > 0)
    if isinstance(x, (bool, int, float, complex)):
        return type(x)
    return x


_DTYPES: dict = {}


def _pointwise_dtype(func, args, kwargs):
    """The result dtype of a pointwise op, from one-element stand-ins of
    its arguments (cached by their dtypes and ranks)."""
    key = (func, tuple(_key(a) for a in args),
           tuple((k, _key(v)) for k, v in kwargs.items()))
    got = _DTYPES.get(key)
    if got is None:
        got = _DTYPES[key] = func(
            *[_stand_in(a) for a in args],
            **{k: _stand_in(v) for k, v in kwargs.items()}).dtype
    return got


def _meta_answer(func, args, kwargs):
    """The output of ``func`` on meta tensors made from its shapes alone,
    for the ops where PyTorch's own meta kernels (Python reference
    implementations) cost most of a dry run; None for every other op.
    Outputs are contiguous (a real kernel may keep an input's permuted
    strides; a contiguous tensor takes every view that one does)."""
    kind = _fast_kind(func)
    if kind is None:
        return None
    x = args[0]
    dev = x.device
    if kind == "inplace":
        return x
    if kind == "convert":
        return torch.empty(x.shape, dtype=kwargs.get("dtype") or x.dtype,
                           device=kwargs.get("device") or dev)
    if kind == "mm":
        return torch.empty((x.shape[0], args[1].shape[1]), dtype=x.dtype,
                           device=dev)
    if kind == "bmm":
        return torch.empty((x.shape[0], x.shape[1], args[1].shape[2]),
                           dtype=x.dtype, device=dev)
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    ts += [a for a in kwargs.values() if isinstance(a, torch.Tensor)]
    return torch.empty(_broadcast([t.shape for t in ts]),
                       dtype=_pointwise_dtype(func, args, kwargs),
                       device=ts[0].device)


class _CountMode(TorchDispatchMode):
    def __init__(self, rec: Recording):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        name = func.overloadpacket.__name__
        out = None
        if args and isinstance(args[0], torch.Tensor) \
                and args[0].device.type == "meta":
            if name in _DATA_DEPENDENT:
                out = _worst_case(name, args, kwargs)
                rec.worst_case_ops += 1
            else:
                out = _meta_answer(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if _kind(func) == "view":
            return out
        ins, outs = _tensors(args, kwargs), _tensors(out)
        if not rec._quiet:
            rec._op(func, args, ins, outs)
        if not name.endswith("_"):
            rec._track(outs, ins)
        return out


@contextlib.contextmanager
def count():
    """Count every op run inside (module docstring); yields the
    `Recording`, complete when the block ends."""
    rec = Recording()
    t0 = time.perf_counter()
    try:
        with _count.active(rec), _CountMode(rec):
            yield rec
    finally:
        rec.seconds = time.perf_counter() - t0


def record(fn: Callable, *args, **kwargs) -> tuple[Any, Recording]:
    """``fn(*args, **kwargs)`` under `count`: (its result, the
    recording)."""
    with count() as rec:
        out = fn(*args, **kwargs)
    return out, rec


# ---------------------------------------------------------------------------
# the reference's two entry points
# ---------------------------------------------------------------------------

def jaxpr_cost(jaxpr: Recording) -> Cost:
    """The port's analogue of the reference's jaxpr walk: the `Cost` of a
    recorded run (`count` / `record`; the port's jaxpr): its flops and
    fusion-optimistic bytes, the wire bytes of its collectives and its
    host reads."""
    rec = jaxpr
    return Cost(flops=rec.flops, bytes=rec.bytes,
                collective_bytes=sum(v for _, v in rec.by_kind.values()),
                unknown_loops=rec.unknown_loops)


def collective_bytes(hlo: Recording) -> dict[str, Any]:
    """Global wire bytes of every collective of a recorded run, by the
    reference's kinds: {"total", "by_kind", "count", "unknown_trip_whiles"}
    and ``by_name`` (the port's collectives by name: [calls, bytes]).
    Loops are exact (eager), so ``unknown_trip_whiles`` is the run's
    data-dependent host reads, after which its trips followed the data.
    ``hlo``: the recorded run (the reference parses HLO text)."""
    rec = hlo
    by_kind = {k: v for k, (_, v) in rec.by_kind.items()}
    return {"total": sum(by_kind.values()), "by_kind": by_kind,
            "count": {k: c for k, (c, _) in rec.by_kind.items()},
            "unknown_trip_whiles": rec.unknown_loops,
            "by_name": {k: list(v) for k, v in rec.collectives.items()}}
