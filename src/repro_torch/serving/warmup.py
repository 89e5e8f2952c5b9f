"""Ahead-of-time warmup: a registry of every program shape the serving
envelope can dispatch, each dispatched once at startup.

The port of `repro.serving.warmup`. The registry (`ShapeRegistry`,
`ProgramShape`), the warmup pass (`warm`, `WarmupReport`) and their labels
are the reference's; the compile side is re-spelled on the port's build
layer (`kernels._build`), since the port has no XLA programs to compile.

Why a registry
--------------
A dispatch shape is the pow2 Q admission bucket x the request kind (plain
distances / pruned top-k / union rerank) x k x the engine knobs (impl,
docs_chunk, tol, prune_chunk). In the port a first dispatch of a shape
pays what a later one does not: the kernels' nvcc build when the build
directory is cold, the libraries' load, the CUDA context and cuBLAS
handles, the caching allocator's first blocks, and the K and M caches'
first rows. The registry enumerates the whole envelope from the service
config -- the same config the coalescer's admission rules read -- so
"every shape the coalescer can dispatch has run once" is a checkable
statement (tests/test_torch_warmup.py cross-checks the registry against a
randomized session's dispatch log).

    registry = ShapeRegistry.from_service(svc, max_batch=16, ks=(8,))
    report = warm(svc, registry)          # one dispatch per shape
    report.shapes["top_k/q8/k8"].wall_s   # first-call seconds per shape

The build directory as the compile cache
----------------------------------------
`enable_compilation_cache(dir)` points the kernel build directory
(`kernels._build.BUILD_DIR`, ``build/repro_torch`` by default) at ``dir``:
libraries are named by a hash of their source and flags, so a later
process -- the next serve run -- finds them there and loads them without
running nvcc. `flush_compilation_cache` reports the ``.so`` entries and
bytes there (libraries are written when built; nothing is buffered).

Compile accounting
------------------
`measure_compiles()` counts, inside a ``with`` block, nvcc compiles and
"persistent hits" -- libraries loaded from the build directory without a
compile -- from the build layer's counters (`kernels._build.builds`). A
shape whose libraries are already loaded in the process counts neither;
on the CPU nothing is built and both stay 0.

Cascade shapes
--------------
The top-k warm dispatches run the full retrieval cascade (tier 0, the
LC-RWMD kernel, the capped doc-side bound, the M cache's miss rows), so no
extra registry entries are needed for the tiers; `_bound_chunk_payloads`
also sweeps the M-row table's chunk counts, as the reference does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.formats import next_pow2 as _next_pow2
from repro_torch.kernels import _build

_KINDS = ("plain", "top_k", "top_k_union")


# -- compile accounting -------------------------------------------------------

@dataclasses.dataclass
class CompileCounter:
    """Build-or-load tallies for one measured span.

    ``events`` counts every library the build layer built or loaded;
    ``persistent_hits`` the subset loaded from the build directory without
    running nvcc. ``compiles`` -- what the zero-first-hit and cold-start
    numbers mean -- is the difference: libraries that paid an nvcc
    compile."""
    events: int = 0
    event_s: float = 0.0
    persistent_hits: int = 0
    retrieval_s: float = 0.0

    @property
    def compiles(self) -> int:
        return self.events - self.persistent_hits

    @property
    def compile_s(self) -> float:
        return max(0.0, self.event_s - self.retrieval_s)


@contextlib.contextmanager
def measure_compiles():
    """Count nvcc compiles (and libraries loaded from the build directory)
    issued while the block runs, by any thread. Nestable; yields a
    `CompileCounter` whose fields are final once the block exits."""
    counter = CompileCounter()
    start = _build.build_counts()
    try:
        yield counter
    finally:
        end = _build.build_counts()
        counter.persistent_hits = end["loads"] - start["loads"]
        counter.retrieval_s = end["load_s"] - start["load_s"]
        counter.events = (end["compiles"] - start["compiles"]
                          + counter.persistent_hits)
        counter.event_s = (end["compile_s"] - start["compile_s"]
                           + counter.retrieval_s)


# -- the build directory ------------------------------------------------------

def enable_compilation_cache(cache_dir: str | os.PathLike) -> str:
    """Point the kernel build directory at ``cache_dir`` (created if
    missing): kernels built from now on are written there, and a later
    process built the same way loads them without running nvcc. Call it
    before the first kernel launch of the process (libraries already
    loaded stay loaded). Returns the directory."""
    return os.fspath(_build.set_build_dir(os.fspath(cache_dir)))


def flush_compilation_cache() -> dict | None:
    """Surface the build directory's on-disk state.

    Libraries are written when they are built, so there is nothing to
    force out; "flush" means walking the directory so shutdown paths exit
    with the persisted state on record. Returns ``{"dir", "entries",
    "bytes"}`` (the ``.so`` libraries there) or None when the directory
    does not exist."""
    cache_dir = _build.BUILD_DIR
    if not cache_dir.is_dir():
        return None
    entries = 0
    n_bytes = 0
    for path in cache_dir.iterdir():
        if path.suffix == ".so":
            entries += 1
            with contextlib.suppress(OSError):
                n_bytes += path.stat().st_size
    return {"dir": str(cache_dir), "entries": entries, "bytes": n_bytes}


# -- the registry -------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class ProgramShape:
    """One dispatch shape of the serving envelope.

    ``kind`` is the request kind the coalescer cuts batches by ("plain"
    distance rows, "top_k" = pruned per-query rerank, "top_k_union" = the
    offline bulk mode's (Q, chunk) union rerank); ``q_bucket`` the pow2
    admission bucket; ``k`` the retrieval size (None for plain);
    ``impl`` the contraction path the dispatch asks for (default: the
    port's service default, "kernel")."""
    kind: str
    q_bucket: int
    k: int | None = None
    impl: str = "kernel"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.q_bucket != _next_pow2(self.q_bucket):
            raise ValueError(f"q_bucket must be a power of two, "
                             f"got {self.q_bucket}")
        if (self.k is None) == (self.kind != "plain"):
            raise ValueError(f"k must be set iff kind is top_k*, "
                             f"got kind={self.kind!r} k={self.k}")

    @property
    def label(self) -> str:
        tail = "" if self.k is None else f"/k{self.k}"
        return f"{self.kind}/q{self.q_bucket}{tail}"


class ShapeRegistry:
    """The serving envelope as an explicit, enumerable set of shapes.

    Built from the service config (`from_service`) rather than hand-listed:
    the pow2 Q buckets come from the admission rule (`_next_pow2`, the same
    rounding `WMDService._padded_query_batch` and the coalescer's
    ``max_batch`` use), the kinds and ks from what the deployment serves.
    ``covers`` is the membership test the warmup tests use to prove the
    coalescer can never dispatch a shape outside the registry."""

    def __init__(self, shapes: Iterable[ProgramShape]):
        self.shapes: tuple[ProgramShape, ...] = \
            tuple(dict.fromkeys(shapes))           # de-dup, keep order

    @classmethod
    def from_service(cls, svc, *, max_batch: int = 16,
                     ks: Sequence[int] = (),
                     kinds: Sequence[str] | None = None,
                     impl: str | None = None) -> "ShapeRegistry":
        """Enumerate the envelope: every pow2 Q bucket up to ``max_batch``
        x every request kind x every k the deployment serves.

        ``kinds`` defaults to "plain" plus "top_k" when ``ks`` is
        non-empty ("top_k_union" -- the offline mode's rerank shape -- must
        be requested explicitly: it is never dispatched by the online
        coalescer). ``impl`` defaults to the service's configured impl, so
        the registry follows the config instead of restating it."""
        if kinds is None:
            kinds = ("plain",) + (("top_k",) if ks else ())
        for kind in kinds:
            if kind not in _KINDS:
                raise ValueError(f"unknown kind {kind!r}")
        if any(kind != "plain" for kind in kinds) and not ks:
            raise ValueError("top_k kinds need at least one k in ks")
        impl = svc.impl if impl is None else impl
        buckets = []
        b = 1
        while b <= _next_pow2(max_batch):
            buckets.append(b)
            b *= 2
        shapes = []
        for kind in kinds:
            for b in buckets:
                if kind == "plain":
                    shapes.append(ProgramShape(kind, b, impl=impl))
                else:
                    shapes.extend(ProgramShape(kind, b, k=int(k), impl=impl)
                                  for k in ks)
        return cls(shapes)

    def __len__(self) -> int:
        return len(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    def covers(self, kind: str, q: int, k: int | None = None) -> bool:
        """True iff a dispatch of ``q`` requests of ``kind`` (with ``k``)
        pads into a bucket this registry enumerates."""
        b = _next_pow2(max(int(q), 1))
        return any(s.kind == kind and s.q_bucket == b and s.k == k
                   for s in self.shapes)

    @property
    def labels(self) -> list[str]:
        return [s.label for s in self.shapes]


# -- the warmup pass ----------------------------------------------------------

@dataclasses.dataclass
class ShapeWarmup:
    """Per-shape outcome of one warmup dispatch."""
    shape: ProgramShape
    wall_s: float                 # whole dispatch (compile + solve)
    compiles: int                 # nvcc compiles triggered
    compile_s: float              # ... their total duration
    persistent_hits: int          # libraries loaded from the build dir
    retrieval_s: float            # ... their load time


@dataclasses.dataclass
class WarmupReport:
    """Outcome of one registry-driven warmup pass.

    ``shapes`` maps `ProgramShape.label` to its `ShapeWarmup`; the scalar
    totals are what `ServingStats` and the launcher's stats record. A
    *cold* start (empty build directory) shows ``compiles > 0`` and
    ``persistent_hits == 0``; a *warm* start (built by an earlier process)
    flips both; a process whose libraries are already loaded shows
    neither."""
    registry: ShapeRegistry
    shapes: dict[str, ShapeWarmup]
    wall_s: float

    @property
    def compiles(self) -> int:
        return sum(s.compiles for s in self.shapes.values())

    @property
    def compile_s(self) -> float:
        return sum(s.compile_s for s in self.shapes.values())

    @property
    def persistent_hits(self) -> int:
        return sum(s.persistent_hits for s in self.shapes.values())

    @property
    def retrieval_s(self) -> float:
        return sum(s.retrieval_s for s in self.shapes.values())

    def compile_s_by_label(self) -> dict[str, float]:
        return {lbl: s.compile_s for lbl, s in self.shapes.items()}

    def summary(self) -> dict:
        """JSON-friendly form (the launcher's ``--stats-out`` warmup
        block)."""
        return {"shapes": self.registry.labels,
                "wall_s": self.wall_s,
                "compiles": self.compiles,
                "compile_s": self.compile_s,
                "persistent_hits": self.persistent_hits,
                "retrieval_s": self.retrieval_s,
                "per_shape": {
                    lbl: {"wall_s": s.wall_s, "compiles": s.compiles,
                          "compile_s": s.compile_s,
                          "persistent_hits": s.persistent_hits}
                    for lbl, s in self.shapes.items()}}


def synth_queries(cfg, n: int, *, seed: int = 0) -> list[np.ndarray]:
    """Deterministic synthetic (V,) query histograms for warmup dispatches.

    Shapes are all that matter to a first call -- the padded batch is
    (Q_pow2, cfg.v_r) regardless of content -- so warmup does not need
    real traffic; it draws ``v_r - 1`` distinct words per query (the
    densest admissible support) from a seeded rng."""
    rng = np.random.default_rng(seed)
    words = max(1, min(cfg.v_r - 1, cfg.vocab_size - 1))
    qs = []
    for _ in range(n):
        r = np.zeros(cfg.vocab_size, np.float32)
        idx = rng.choice(cfg.vocab_size, size=words, replace=False)
        r[idx] = rng.random(words).astype(np.float32) + 0.1
        r /= r.sum()
        qs.append(r)
    return qs


def _bound_chunk_payloads(cfg, q: int, rows_bucket: int, *, seed: int = 0):
    """One payload batch per feasible M-table chunk count of a top-k shape.

    The bound tier assembles its M-row table in fixed ``rows_bucket``
    blocks, so the table (and its slot-gather program) has
    ``ceil(unique_ids / rows_bucket) * rows_bucket + 1`` rows -- a program
    shape set by the batch's UNIQUE WORD COUNT, not by (kind, Q, k). One
    dispatch per (kind, Q, k) therefore leaves every other chunk count
    cold (the reference's compile-counter tests caught exactly that).
    Sweep it: for
    each chunk count c, craft ``q`` queries whose supports union to
    ``min(c * rows_bucket, u_max)`` ids -- word 0 always in the pool (pad
    slots point at it, so it is resident in any real batch's id set),
    per-query supports striding the pool so the union is exact."""
    rng = np.random.default_rng(seed)
    words_max = max(1, min(cfg.v_r - 1, cfg.vocab_size - 1))
    u_max = min(q * words_max, cfg.vocab_size)
    c_max = -(-u_max // rows_bucket)
    for c in range(1, c_max + 1):
        u = min(c * rows_bucket, u_max)
        pool = np.zeros(u, np.int64)
        if u > 1:
            pool[1:] = rng.choice(np.arange(1, cfg.vocab_size),
                                  size=u - 1, replace=False)
        w = min(words_max, u)
        stride = -(-u // q)
        batch = []
        for i in range(q):
            idx = pool[[(i * stride + j) % u for j in range(w)]]
            r = np.zeros(cfg.vocab_size, np.float32)
            r[idx] = rng.random(w).astype(np.float32) + 0.1
            r /= r.sum()
            batch.append(r)
        yield batch


def warm(svc, registry: ShapeRegistry, *,
         queries: Sequence[np.ndarray] | None = None,
         seed: int = 0) -> WarmupReport:
    """Warm every shape in ``registry`` with one dispatch each.

    Dispatches go through the *public* entry points (`query_batch` /
    `top_k_batch`), so whatever the admission policy routes a bucket to --
    the stripes engine, the legacy route, the pruned rerank -- is exactly
    what runs first, including the K cache's miss-row kernels on the very
    first dispatch. Shapes run smallest-bucket first so per-shape
    attribution is sharp (the first shape pays the kernels' build or
    load).

    ``queries`` (optional) supplies the warmup payloads -- the deprecation
    shims pass the caller's real queries through; by default seeded
    synthetic histograms are used (`synth_queries`). Warmup dispatches hit
    the real engine, so with a K cache enabled they also pre-populate row
    residency (synthetic payloads then fill the store with synthetic ids;
    real Zipf traffic evicts them within a few batches).

    Top-k shapes additionally sweep the bound tier's unique-word-count
    dimension (`_bound_chunk_payloads`): the M-row table's chunk count is
    a program shape of its own in the reference, so each (top_k*, Q, k)
    dispatches once per feasible chunk count on top of the ``queries``
    payload, as there.
    """
    max_q = max((s.q_bucket for s in registry), default=0)
    if queries is None:
        qs = synth_queries(svc.cfg, max_q, seed=seed)
    else:
        qs = list(queries)
        if 0 < len(qs) < max_q:                # cycle short payload lists
            reps = -(-max_q // len(qs))
            qs = (qs * reps)[:max_q]
    rows_bucket = getattr(svc, "cache_rows_bucket", 128)
    shapes: dict[str, ShapeWarmup] = {}
    t_start = time.perf_counter()
    for shape in sorted(registry, key=lambda s: (s.q_bucket, s.kind)):
        batch = [qs[i] for i in range(shape.q_bucket)]
        t0 = time.perf_counter()
        with measure_compiles() as counter:
            if shape.kind == "plain":
                svc.query_batch(batch, impl=shape.impl)
            else:
                rerank = "union" if shape.kind == "top_k_union" \
                    else "per_query"
                svc.top_k_batch(batch, shape.k, prune=True,
                                impl=shape.impl, rerank=rerank)
                for sweep in _bound_chunk_payloads(
                        svc.cfg, shape.q_bucket, rows_bucket, seed=seed):
                    svc.top_k_batch(sweep, shape.k, prune=True,
                                    impl=shape.impl, rerank=rerank)
        shapes[shape.label] = ShapeWarmup(
            shape=shape, wall_s=time.perf_counter() - t0,
            compiles=counter.compiles, compile_s=counter.compile_s,
            persistent_hits=counter.persistent_hits,
            retrieval_s=counter.retrieval_s)
    return WarmupReport(registry=registry, shapes=shapes,
                        wall_s=time.perf_counter() - t_start)
