"""The Sinkhorn programs reading the iterate x, on the CPU.

The solver programs hand the iterate x itself to the type1 / type2
contractions (``from_x=True``), which form u = 1 / max(x, TINY) from it (the
kernel route's kernels as they load it), and on one model shard type1
divides by the real r in its epilogue. The element-wise spelling this
replaced -- `safe_recip` before each contraction, type1 with r = 1, then
``/ r`` after the model-axis sum -- is written out here (`_elementwise_*`).
Here:

* `core.distributed._batched_solve` and `_solve` give that spelling's bits,
  on the kernel route and the fused impl, on one and two model shards, with
  and without ``tol``, with either chunk placement and a ``docs_chunk`` that
  does not divide N, on inputs whose iterate holds 0, values below TINY,
  +inf and NaN (each seen by the contractions, checked);
* each kernel entry's plain version with ``from_x`` is `safe_recip` then
  the entry, bitwise, and a pad doc whose x is 0 comes out exactly 0;
* every call that reads x is counted where it runs
  (`kernels.sddmm_spmm.reads_x`), and the service reports the batch's
  count: ``fused_launches`` in ``last_batch_stats`` and the ``fused``
  attribute of its ``solve`` span, ``max_iter + 1`` on a one-shard
  kernel-route batch and 0 on a plain impl's.
"""
import functools
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import distributed as tdist
from repro_torch.core import formats as tf
from repro_torch.core import sparse_sinkhorn as tss
from repro_torch.core.sparse_sinkhorn import TINY, pad_k
from repro_torch.data import LiveCorpus
from repro_torch.kernels import ops
from repro_torch.kernels import sddmm_spmm as sk
from repro_torch.launch.mesh import make_mesh, shard_grid
from repro_torch.obs import Tracer
from repro_torch.serving import WMDService

CPU = torch.device("cpu")
V, W, N, Q, V_R, MAX_ITER = 24, 6, 23, 4, 6, 6
EMPTY_DOCS = (3, 17)          # zero mass: x is 0 from the first iteration


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality, NaN matching NaN."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _ell(seed: int = 0) -> tf.EllDocs:
    rng = np.random.default_rng(seed)
    c = np.zeros((V, N), np.float32)
    for j in range(N):
        if j in EMPTY_DOCS:
            continue
        idx = rng.choice(V, int(rng.integers(2, 7)), replace=False)
        c[idx, j] = rng.random(idx.size).astype(np.float32) + 0.05
        c[:, j] /= c[:, j].sum()
    return tf.ell_from_dense(c)


def _stripes(seed: int = 1):
    """K and K.*M stripes (Q, v_r, V) and r (Q, v_r) whose Sinkhorn iterates
    hold every special value: query 0's K spans 1 .. 1e-36, so its rows of
    far words fall below TINY; query 1's first r is subnormal, so its row
    overflows to +inf; query 2 reads a NaN in K; the last row of each query
    is a pad row (K 0, r 1)."""
    rng = np.random.default_rng(seed)
    m = rng.random((Q, V_R, V)).astype(np.float32) * 3
    k = np.exp(-m).astype(np.float32)
    k[0, ::2] *= np.float32(1e-36)
    r = (rng.random((Q, V_R)) + 0.1).astype(np.float32)
    r[1, 0] = np.float32(1e-40)
    k[2, 1, :V // 2] = np.nan
    k[:, -1] = 0.0
    r[:, -1] = 1.0
    return (torch.from_numpy(k), torch.from_numpy(k * m),
            torch.from_numpy(r))


class _Seen:
    """Wraps a kernel entry of `kernels.ops` and records which special
    values the iterates it is handed hold."""

    def __init__(self, monkeypatch, entry: str):
        self.kinds: set = set()
        real = getattr(ops, entry)

        def spy(k_vm, r_sel, u, *args, from_x=False, **kw):
            if from_x:
                self.note(u)
            return real(k_vm, r_sel, u, *args, from_x=from_x, **kw)

        monkeypatch.setattr(ops, entry, spy)

    def note(self, x: torch.Tensor) -> None:
        for kind, hit in (("zero", x == 0), ("tiny", (x > 0) & (x < TINY)),
                          ("inf", torch.isinf(x)), ("nan", torch.isnan(x))):
            if bool(hit.any()):
                self.kinds.add(kind)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=[CPU] * (shape[0]
                                                                * shape[1]))


def _model_sum(parts):
    """The model-axis sum: a left fold in shard order."""
    return functools.reduce(lambda a, b: a + b, parts)


def _elementwise_batched(grid, st, r, cols_d, vals_d, *, tol, placement,
                         docs_chunk):
    """`_batched_solve` in the element-wise spelling: u = `safe_recip`(x)
    before each contraction, type1 with r = 1 and the divide by r after the
    model-axis sum; the same chunks, loop and vote."""
    n_doc, n_model = grid.shape
    ones = torch.ones_like(r)
    blk = docs_chunk if placement == "iteration" else None
    n_d = [cols_d[d, 0].shape[0] for d in range(n_doc)]

    def contract(d, lo, hi, x, type1):
        u = sk.safe_recip(x)
        parts = []
        for s in range(n_model):
            k_pad, km_pad, t1, t2 = st[(s, grid[d, s])]
            c, v = cols_d[d, s][lo:hi], vals_d[d, s][lo:hi]
            parts.append(t1(k_pad, ones, u, c, v, docs_chunk=blk) if type1
                         else t2(k_pad, km_pad, u, c, v, docs_chunk=blk))
        return _model_sum(parts)

    def solve(spans):
        x0 = [torch.full((Q, V_R, hi - lo), 1.0 / V_R) for _, lo, hi in spans]

        def iteration(xs):
            return [contract(d, lo, hi, x, True) / r[:, :, None]
                    for (d, lo, hi), x in zip(spans, xs)]

        if tol:
            xs, delta, n_iter = tss.batched_sinkhorn_loop(
                iteration, x0, max_iter=MAX_ITER, tol=tol,
                delta_all_reduce=lambda ds: functools.reduce(torch.maximum,
                                                             ds))
        else:
            xs = x0
            for _ in range(MAX_ITER):
                xs = iteration(xs)
            delta = torch.zeros((Q,))
            n_iter = torch.full((Q,), MAX_ITER, dtype=torch.int32)
        return ([contract(d, lo, hi, x, False)
                 for (d, lo, hi), x in zip(spans, xs)], n_iter, delta)

    if placement == "solve" and docs_chunk and docs_chunk < max(n_d):
        pieces = [[] for _ in range(n_doc)]
        iters, deltas = [], []
        for lo in range(0, max(n_d), docs_chunk):
            spans = [(d, lo, min(lo + docs_chunk, n_d[d]))
                     for d in range(n_doc) if lo < n_d[d]]
            wmd, n_iter, delta = solve(spans)
            for (d, _, _), w in zip(spans, wmd):
                pieces[d].append(w)
            iters.append(n_iter)
            deltas.append(delta)
        return (torch.cat([torch.cat(p, -1) for p in pieces], -1),
                torch.amax(torch.stack(iters), 0),
                torch.amax(torch.stack(deltas), 0))
    wmd, n_iter, delta = solve([(d, 0, n_d[d]) for d in range(n_doc)])
    return torch.cat(wmd, -1), n_iter, delta


def _batched(shape, impl, **kw):
    """(the program's result, the element-wise spelling's, the calls that
    read x in the program)."""
    k, km, r = _stripes()
    n_model = shape[1]
    rb = tf.rebucket_for_vocab_shards(_ell(), n_model)
    mesh = _mesh(shape)
    _, cols_d, vals_d = tdist.shard_wmd_inputs(
        mesh, np.zeros((V, 1), np.float32), rb.cols, rb.vals)
    grid = shard_grid(mesh)
    vs = V // n_model
    st = tdist._contractions(grid, impl, lambda s, dev: (
        pad_k(k[:, :, s * vs:(s + 1) * vs]), pad_k(km[:, :, s * vs:(s + 1)
                                                      * vs])))
    n0 = sk.reads_x_total()
    got = tdist._batched_solve(
        grid, st, r, cols_d, vals_d, max_iter=MAX_ITER,
        docs_chunk=kw["docs_chunk"], chunk_placement=kw["placement"],
        tol=kw["tol"], check=True)
    n_read = sk.reads_x_total() - n0
    return got, _elementwise_batched(grid, st, r, cols_d, vals_d, **kw), \
        n_read


@pytest.mark.parametrize("impl", ["kernel", "fused"])
@pytest.mark.parametrize("placement,docs_chunk", [("solve", None),
                                                  ("solve", 5),
                                                  ("iteration", 5)])
@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2)])
def test_batched_solve_reading_x_is_the_elementwise_spelling(
        monkeypatch, shape, tol, placement, docs_chunk, impl):
    seen = _Seen(monkeypatch, "sddmm_spmm_type1_batch_vm")
    (wmd, n_iter, delta), (wmd0, n_iter0, delta0), n_read = _batched(
        shape, impl, tol=tol, placement=placement, docs_chunk=docs_chunk)
    if impl == "kernel":
        assert seen.kinds == {"zero", "tiny", "inf", "nan"}
    assert _same(wmd, wmd0) and bool(torch.isnan(wmd).any())
    assert torch.equal(n_iter, n_iter0) and _same(delta, delta0)
    # the kernel route counts each type1 and type2 call that read x: an
    # iteration's, one a (doc shard, model shard) position, and the
    # distance's; the plain impls launch no kernel
    n_doc, n_model = shape
    most = -(-N // n_doc)                 # the largest doc shard's docs
    chunks = -(-most // docs_chunk) if (
        placement == "solve" and docs_chunk) else 1
    if impl != "kernel":
        assert n_read == 0
    elif tol:
        assert n_read > 0
    else:
        assert n_read == chunks * n_doc * n_model * (MAX_ITER + 1)


def _per_query_inputs(shape):
    ell = _ell()
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(V, W)).astype(np.float32)
    vecs[5] = np.nan                      # a NaN K column
    mesh = _mesh(shape)
    rb = tf.rebucket_for_vocab_shards(ell, shape[1])
    vecs_d, cols_d, vals_d = tdist.shard_wmd_inputs(mesh, vecs, rb.cols,
                                                    rb.vals)
    sel = np.array([0, 1, 2, 3, 4, 0], np.int64)
    # lamb 20 puts K of far words below TINY; r 1e-40 (subnormal) makes
    # its row overflow to +inf; the last row is a pad row
    r_sel = torch.tensor([0.3, 1e-40, 0.2, 0.25, 0.25, 1.0])
    mask = torch.tensor([1.0, 1, 1, 1, 1, 0])
    return (shard_grid(mesh), torch.from_numpy(vecs[sel]), r_sel, mask,
            vecs_d, cols_d, vals_d)


def _elementwise_per_query(grid, vecs_sel, r_sel, mask, vecs_d, cols_d,
                           vals_d, impl):
    """`_solve` in the element-wise spelling (as `_elementwise_batched`)."""
    n_doc, n_model = grid.shape
    ones = torch.ones_like(r_sel)
    pairs = []
    for s in range(n_model):
        k, km = tdist.masked_k(vecs_sel, vecs_d[0, s], 20.0, mask, "jnp")
        k_pad, km_pad = pad_k(k), pad_k(km)
        pairs.append((k_pad, km_pad,
                      *tss.query_contractions(impl, k_pad, km_pad)))
    out = []
    for d in range(n_doc):
        x = torch.full((V_R, cols_d[d, 0].shape[0]), 1.0 / V_R)
        for _ in range(MAX_ITER):
            x = _model_sum([t1(k_pad, ones, sk.safe_recip(x), cols_d[d, s],
                               vals_d[d, s])
                            for s, (k_pad, _, t1, _) in enumerate(pairs)]
                           ) / r_sel[:, None]
        out.append(_model_sum([t2(k_pad, km_pad, sk.safe_recip(x),
                                  cols_d[d, s], vals_d[d, s])
                               for s, (k_pad, km_pad, _, t2)
                               in enumerate(pairs)]))
    return torch.cat(out, -1)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2)])
def test_per_query_solve_reading_x_is_the_elementwise_spelling(
        monkeypatch, shape, use_kernel):
    seen = _Seen(monkeypatch, "sddmm_spmm_type1_vm")
    args = _per_query_inputs(shape)
    got = tdist._solve(*args, lamb=20.0, max_iter=MAX_ITER,
                       use_kernel=use_kernel, kexp_impl="jnp", check=True)
    if use_kernel:
        assert seen.kinds == {"zero", "tiny", "inf", "nan"}
    want = _elementwise_per_query(*args,
                                  "kernel" if use_kernel else "fused")
    assert _same(got, want) and bool(torch.isnan(got).any())


def _x_with_specials(q, n, seed=4):
    """An iterate (q, V_R, n) holding 0, values below TINY (one subnormal),
    a negative, +inf, NaN and 1e38 among ordinary values."""
    rng = np.random.default_rng(seed)
    x = (rng.random((q, V_R, n)) + 0.01).astype(np.float32)
    flat = x.reshape(-1)
    at = rng.choice(flat.size, 7 * 3, replace=False)
    flat[at] = np.tile(np.array([0.0, 1e-35, 1e-45, -2.0, np.inf, np.nan,
                                 1e38], np.float32), 3)
    return torch.from_numpy(x)


# entry -> (plain call on x with from_x, the same on u = safe_recip(x))
def _entries(k_vm, km_vm, r, x, cols, vals):
    u = sk.safe_recip(x)
    return {
        "type1_batch": (
            sk.sddmm_spmm_type1_batch_vm_plain(k_vm, r, x, cols, vals,
                                               from_x=True),
            sk.sddmm_spmm_type1_batch_vm_plain(k_vm, torch.ones_like(r), u,
                                               cols, vals) / r[:, :, None]),
        "type2_batch": (
            sk.sddmm_spmm_type2_batch_vm_plain(k_vm, km_vm, x, cols, vals,
                                               from_x=True),
            sk.sddmm_spmm_type2_batch_vm_plain(k_vm, km_vm, u, cols, vals)),
        "type1": (
            sk.sddmm_spmm_type1_vm_plain(k_vm[0], r[0], x[0], cols, vals,
                                         from_x=True),
            sk.sddmm_spmm_type1_vm_plain(k_vm[0], torch.ones_like(r[0]),
                                         u[0], cols, vals) / r[0][:, None]),
        "type2": (
            sk.sddmm_spmm_type2_vm_plain(k_vm[0], km_vm[0], x[0], cols, vals,
                                         from_x=True),
            sk.sddmm_spmm_type2_vm_plain(k_vm[0], km_vm[0], u[0], cols,
                                         vals)),
    }


@pytest.mark.parametrize("entry", ["type1_batch", "type2_batch", "type1",
                                   "type2"])
def test_kernel_entries_reading_x_and_pad_docs(entry):
    """Each plain entry with ``from_x`` is `safe_recip` then the entry
    (type1: and the divide by r after a launch with r = 1), bitwise; four
    pad docs appended with x = 0 -- the zeros a doc-axis pad puts into x,
    which the kernels turn into u = 1e30 -- come out exactly 0."""
    k, km, r = _stripes()
    k = torch.nan_to_num(k, nan=0.5)
    ell = _ell()
    pad = 4
    cols = torch.from_numpy(np.concatenate(
        [ell.cols, np.full((pad, ell.cols.shape[1]), V, np.int32)]))
    vals = torch.from_numpy(np.concatenate(
        [ell.vals, np.zeros((pad, ell.vals.shape[1]), np.float32)]))
    x = _x_with_specials(Q, N + pad)
    x[:, :, N:] = 0.0
    k_vm, km_vm = ops.k_vocab_major(pad_k(k)), ops.k_vocab_major(pad_k(km))
    got, want = _entries(k_vm, km_vm, r, x, cols, vals)[entry]
    assert _same(got, want)
    assert bool((got[..., N:] == 0).all())


def _svc(impl="kernel", live=False, **kw):
    ell = _ell()
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(V, W)).astype(np.float32)
    cfg = WMDConfig(name="fused-iterate", vocab_size=V, embed_dim=W,
                    num_docs=N, nnz_max=ell.nnz_max, v_r=8, lamb=1.0,
                    max_iter=15)
    if not live:
        return WMDService(cfg=cfg, vecs=vecs, ell=ell, device="cpu",
                          impl=impl, **kw)
    # half the docs in the base segment, half in the delta
    docs = tf.doc_lists_from_ell(ell)
    lc = LiveCorpus(tempfile.mkdtemp(prefix="fused-iterate-"), V,
                    normalize=False)
    lc.add_docs(range(N // 2), docs[:N // 2])
    lc.compact()
    lc.add_docs(range(N // 2, N), docs[N // 2:])
    return WMDService.from_live(None, cfg, vecs, lc, device="cpu", impl=impl,
                                **kw)


def _queries():
    rng = np.random.default_rng(6)
    rs = []
    for i in range(3):
        r = np.zeros(V, np.float32)
        idx = rng.choice(V, 3 + i, replace=False)
        r[idx] = rng.random(idx.size).astype(np.float32) + 0.1
        rs.append(r / r.sum())
    return rs


@pytest.mark.parametrize("impl,kw,want", [
    ("kernel", dict(cache_capacity=64), [16]),      # the stripes route
    ("kernel", {}, [16]),                           # the legacy route
    ("kernel", dict(live=True), [16, 16]),          # a segment a program
    ("fused", dict(cache_capacity=64), [0]),        # a plain impl: u passed
])
def test_service_reports_the_launches_that_read_x(impl, kw, want):
    svc = _svc(impl, **kw)
    svc.tracer = Tracer()
    out = svc.query_batch(_queries())
    assert svc.last_batch_stats["fused_launches"] == sum(want)
    (tree,) = svc.tracer.snapshot()[0]
    assert [s["attrs"]["fused"] for s in tree["spans"]
            if s["name"] == "solve"] == want
    assert out.shape == (3, N) and np.isfinite(out).all()


@pytest.mark.parametrize("cost", ["_type1_cost", "_type2_cost"])
def test_reading_x_declares_one_reciprocal_a_row_and_doc(cost):
    """The launch tools' count: a launch that reads x does the reciprocal
    the element-wise pass did, one operation a (query row, doc)."""
    k, km, r = _stripes()
    ell = _ell()
    k_vm = ops.k_vocab_major(pad_k(k))
    x = _x_with_specials(Q, N)
    cols, vals = torch.from_numpy(ell.cols), torch.from_numpy(ell.vals)
    args = ((k_vm, r, x, cols, vals) if cost == "_type1_cost"
            else (k_vm, k_vm, x, cols, vals))
    on_u = getattr(ops, cost)(*args)
    on_x = getattr(ops, cost)(*args, from_x=True)
    assert on_x == (on_u[0], on_u[1] + Q * V_R * N)
