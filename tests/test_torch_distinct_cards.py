"""The service on distinct cards: the launch-device check of the hand
kernels, and the bytes a batch copies between cards.

* `kernels._build.check_devices` refuses an operand off the current card
  and passes operands on it (stand-in devices, on the CPU);
* `core.distributed._to` adds a copy's bytes to the tally
  (``peer_copies``) only where it crosses between two distinct cards, and
  every copy the per-query and batched programs make goes through it
  (checked against each ``Tensor.to(device)`` the programs call, with
  cards standing in on the CPU);
* `WMDService` reports what its program call added to the tally in
  ``wmd_peer_copy_bytes_total``, ``last_batch_stats["peer_bytes"]`` and the
  ``solve`` span's ``cards`` / ``peer_bytes``: 0 on a (4, 1) mesh of one
  device;
* on a machine with two cards or more (marked ``cuda``, skipped below
  two): a launch with another card's operands raises, and a mesh of
  distinct cards answers bit for bit as one card, its ``peer_bytes`` the
  bytes of the peer copies in the profiler's trace of the batch.
"""
import collections
import json
import sys

import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import distributed as tdist
from repro_torch.core.formats import EllDocs
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_mesh, shard_grid
from repro_torch.obs import Tracer
from repro_torch.serving.wmd_service import WMDService

CPU = torch.device("cpu")
V, W, N, V_R, MAX_ITER = 512, 16, 40, 8, 4


def cuda(i):
    return torch.device("cuda", i)


# -- the launch-device check --------------------------------------------------

@pytest.mark.parametrize("devices, current", [
    ([cuda(2)], 0),
    ([cuda(0), cuda(0), cuda(2)], 0),
    ([cuda(1), cuda(0)], 1),
])
def test_an_operand_off_the_current_card_is_refused(devices, current):
    bad = next(i for i, d in enumerate(devices) if d.index != current)
    with pytest.raises(RuntimeError, match=f"operand {bad} on cuda:"
                       f"{devices[bad].index}"):
        _build.check_devices("sddmm_spmm_type1_batch", devices, current)


@pytest.mark.parametrize("devices, current", [
    ([cuda(0)], 0), ([cuda(2)] * 6, 2), ([], 3)])
def test_operands_on_the_current_card_pass(devices, current):
    _build.check_devices("sddmm_spmm_type1_batch", devices, current)


# -- the tally of copies between cards ------------------------------------------

@pytest.mark.parametrize("src, dst, crosses", [
    (CPU, CPU, False), (cuda(0), cuda(0), False), (CPU, cuda(1), False),
    (cuda(1), CPU, False), (cuda(0), cuda(2), True), (cuda(3), cuda(1), True),
])
def test_only_a_copy_between_two_distinct_cards_crosses(src, dst, crosses):
    assert tdist._between_cards(src, dst) is crosses


def test_a_copy_between_cards_adds_its_bytes_by_what_it_copies(monkeypatch):
    """`_to` adds ``t.nbytes`` under its label where the copy crosses
    (cards stand in: the CPU's copy is the tensor itself), and nothing
    where it does not."""
    monkeypatch.setattr(tdist, "peer_copies", collections.Counter())
    t = torch.ones(3, 5)
    assert tdist._to(t, CPU, "r") is t
    assert tdist.peer_bytes_total() == 0
    monkeypatch.setattr(tdist, "_between_cards", lambda src, dst: True)
    tdist._to(t, CPU, "r")
    tdist._to(t[:, :2].double(), CPU, "iterate")
    assert tdist.peer_copies == {"r": 60, "iterate": 48}
    assert tdist.peer_bytes_total() == 108


def _to_calls(monkeypatch):
    """The bytes of every ``Tensor.to(device)`` that `core.distributed`
    makes, as the tally would count them were every copy between cards."""
    seen = []
    real = torch.Tensor.to

    def to(t, *args, **kw):
        if (sys._getframe(1).f_code.co_filename == tdist.__file__
                and args and isinstance(args[0], torch.device)):
            seen.append(t.nbytes)
        return real(t, *args, **kw)
    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(tdist, "_between_cards", lambda src, dst: True)
    return seen


def _program(kind, shape):
    """One call of a program on a CPU mesh of ``shape``, with its inputs
    placed beforehand: what it copies is its own."""
    vecs, ell, qs = _problem()
    mesh = make_mesh(shape, ("data", "model"), devices=[CPU] * 4)
    cfg = WMDConfig(name="t", vocab_size=V, embed_dim=W, num_docs=N,
                    nnz_max=16, v_r=V_R, lamb=1.0, max_iter=MAX_ITER)
    svc = WMDService(cfg=cfg, vecs=vecs, ell=ell, mesh=mesh,
                     cache_capacity=64)
    sel_b, r_b, mask_b = svc._padded_query_batch(qs)
    r_d = torch.from_numpy(r_b)
    kw = dict(max_iter=MAX_ITER, tol=1e-3, with_info=True, impl="fused")
    if kind == "stripes":
        k_s, km_s, _ = svc._kcache.stripes_for_batch(sel_b, mask_b)
        fn = tdist.build_wmd_batch_fn_stripes(mesh, **kw)
        return lambda: fn(k_s, km_s, r_d, svc._cols_d, svc._vals_d)
    vecs_sel = svc._vecs_d[torch.from_numpy(sel_b.astype(np.int64))]
    mask_d = torch.from_numpy(mask_b)
    if kind == "batch":
        fn = tdist.build_wmd_batch_fn(mesh, lamb=1.0, **kw)
        return lambda: fn(vecs_sel, r_d, mask_d, svc._vecs_sh, svc._cols_d,
                          svc._vals_d)
    fn = tdist.build_wmd_fn(mesh, lamb=1.0, max_iter=MAX_ITER)
    return lambda: fn(vecs_sel[0], r_d[0], mask_d[0], svc._vecs_sh,
                      svc._cols_d, svc._vals_d)


def _meta_program(kind, shape):
    """One call of a program on a mesh of four distinct ``meta:i``
    positions (shapes only, so every position's copies run), with its
    inputs placed beforehand."""
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[torch.device("meta", i) for i in range(4)])
    grid = shard_grid(mesh)
    n_doc, n_model = grid.shape
    f32, first = torch.float32, grid[0, 0]

    def blocks(shape_, dtype=f32):
        out = np.empty(grid.shape, object)
        for pos in np.ndindex(grid.shape):
            out[pos] = torch.empty(shape_, dtype=dtype, device=grid[pos])
        return out

    n, v_loc = N // n_doc, V // n_model
    cols, vals = blocks((n, 16), torch.int32), blocks((n, 16))
    q_rows = torch.empty((4, V_R, W), device=first)
    r, mask = (torch.empty((4, V_R), device=first) for _ in range(2))
    kw = dict(max_iter=MAX_ITER, impl="fused")
    if kind == "stripes":
        k_b = [torch.empty((4, V_R, v_loc + 1), device=grid[0, s])
               for s in range(n_model)]
        fn = tdist.build_wmd_batch_fn_stripes(mesh, **kw)
        return lambda: fn(k_b, k_b, r, cols, vals)
    if kind == "batch":
        fn = tdist.build_wmd_batch_fn(mesh, lamb=1.0, **kw)
        return lambda: fn(q_rows, r, mask, blocks((v_loc, W)), cols, vals)
    if kind == "query":
        fn = tdist.build_wmd_fn(mesh, lamb=1.0, max_iter=MAX_ITER)
        return lambda: fn(q_rows[0], r[0], mask[0], blocks((v_loc, W)),
                          cols, vals)
    fn = tdist.build_wmd_fn_docsharded(mesh, lamb=1.0, max_iter=MAX_ITER)
    return lambda: fn(q_rows[0], r[0], mask[0],
                      torch.empty((V, W), device=first),
                      torch.empty((N, 16), dtype=torch.int32, device=first),
                      torch.empty((N, 16), device=first))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("kind, where", [
    ("stripes", "cpu"), ("batch", "cpu"), ("query", "cpu"),
    ("stripes", "meta"), ("batch", "meta"), ("query", "meta"),
    ("docsharded", "meta")])
def test_every_copy_a_program_makes_is_tallied(monkeypatch, kind, where,
                                               shape):
    """Counted as if every copy crossed between cards, the tally of one
    program call is the bytes of every ``.to(device)`` the program makes:
    no copy bypasses `_to`. On the CPU the positions share one device (and
    the vote of ``tol > 0`` runs); on ``meta:i`` they are distinct, so the
    copies to other positions run too."""
    call = (_program if where == "cpu" else _meta_program)(kind, shape)
    seen = _to_calls(monkeypatch)
    p0 = tdist.peer_bytes_total()
    call()
    assert seen and tdist.peer_bytes_total() - p0 == sum(seen)


# -- the service's count ------------------------------------------------------

def _problem():
    rng = np.random.default_rng(33)
    vecs = rng.normal(size=(V, W)).astype(np.float32)
    cols = np.full((N, 16), V, np.int32)
    vals = np.zeros((N, 16), np.float32)
    for j in range(N):
        k = rng.integers(3, 16)
        cols[j, :k] = rng.choice(V, k, replace=False)
        vals[j, :k] = rng.random(k).astype(np.float32) + 0.1
        vals[j] /= vals[j].sum()
    qs = []
    for k in (5, 7, 8):
        r = np.zeros(V, np.float32)
        r[rng.choice(V, k, replace=False)] = rng.random(k) + 0.1
        qs.append(r / r.sum())
    return vecs, EllDocs(cols=cols, vals=vals, num_vocab=V), qs


def _svc(mesh, **kw):
    vecs, ell, _ = _problem()
    cfg = WMDConfig(name="t", vocab_size=V, embed_dim=W, num_docs=N,
                    nnz_max=16, v_r=V_R, lamb=1.0, max_iter=MAX_ITER)
    svc = WMDService(cfg=cfg, vecs=vecs, ell=ell, mesh=mesh, **kw)
    svc.tracer = Tracer()
    return svc


def _solve_attrs(svc):
    trees, _ = svc.tracer.snapshot()
    return [s["attrs"] for s in trees[-1]["spans"] if s["name"] == "solve"]


@pytest.mark.parametrize("kw", [dict(cache_capacity=64), {}])
def test_a_mesh_of_one_device_counts_no_peer_bytes(kw):
    svc = _svc(make_mesh((4, 1), ("data", "model"), devices=[CPU] * 4),
               **kw)
    svc.query_batch(_problem()[2])
    assert svc.last_batch_stats["peer_bytes"] == 0
    assert svc.metrics.counter("wmd_peer_copy_bytes_total").value == 0
    (attrs,) = _solve_attrs(svc)
    assert attrs["cards"] == 1 and attrs["peer_bytes"] == 0


@pytest.mark.parametrize("kw, route", [(dict(cache_capacity=64), "stripes"),
                                       ({}, "legacy_fused")])
def test_the_service_reports_what_its_program_copied(monkeypatch, kw,
                                                     route):
    """With every copy taken as one between cards (cards stand in on the
    CPU), the counter, the batch's stat and the ``solve`` span hold what
    the program call added to the tally, batch by batch."""
    svc = _svc(make_mesh((4, 1), ("data", "model"), devices=[CPU] * 4),
               **kw)
    monkeypatch.setattr(tdist, "_between_cards", lambda src, dst: True)
    qs = _problem()[2]
    got = []
    for _ in range(2):
        p0 = tdist.peer_bytes_total()
        svc.query_batch(qs)
        got.append(tdist.peer_bytes_total() - p0)
    assert got[0] == got[1] > 0
    assert svc._route == route
    assert svc.last_batch_stats["peer_bytes"] == got[1]
    assert svc.metrics.counter("wmd_peer_copy_bytes_total").value == sum(got)
    (attrs,) = _solve_attrs(svc)
    assert attrs == {"iters": MAX_ITER, "fused": attrs["fused"],
                     "cards": 1, "peer_bytes": got[1]}


# -- on distinct cards ----------------------------------------------------------

def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPUs, "
                    f"{torch.cuda.device_count()} visible")


@pytest.mark.cuda
def test_a_launch_with_another_cards_operands_raises():
    _cards(2)
    from repro_torch.kernels import kexp, sddmm_spmm
    a = torch.randn(8, W, device=cuda(1))
    b = torch.randn(V, W, device=cuda(1))
    with torch.cuda.device(0):
        with pytest.raises(RuntimeError, match="launched on cuda:0"):
            kexp.cdist_kexp_rows(a, b, lamb=1.0)
    with torch.cuda.device(1):
        k, km = kexp.cdist_kexp_rows(a, b, lamb=1.0)
    k_pad = torch.nn.functional.pad(k, (0, 1))[None].contiguous()
    with torch.cuda.device(0):
        with pytest.raises(RuntimeError, match="operand 0 on cuda:1"):
            sddmm_spmm.k_vocab_major(k_pad)
    torch.cuda.synchronize(cuda(1))


@pytest.mark.cuda
def test_a_mesh_of_distinct_cards_answers_as_one_card(tmp_path):
    n = min(4, torch.cuda.device_count()) if torch.cuda.is_available() else 0
    _cards(2)
    qs = _problem()[2]
    one = _svc(None, device=cuda(0), cache_capacity=64)
    logical = _svc(make_mesh((n, 1), ("data", "model"),
                             devices=[cuda(0)] * n), cache_capacity=64)
    cards = _svc(make_mesh((n, 1), ("data", "model")), cache_capacity=64)
    want = one.query_batch(qs)
    assert np.array_equal(logical.query_batch(qs), want)
    assert np.array_equal(cards.query_batch(qs), want)
    assert logical.last_batch_stats["peer_bytes"] == 0
    assert _solve_attrs(cards)[0]["cards"] == n
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        cards.query_batch(qs)
        for i in range(n):
            torch.cuda.synchronize(cuda(i))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    peer = [e["args"]["bytes"] for e in trace["traceEvents"]
            if "PtoP" in e.get("name", "")]
    assert peer and cards.last_batch_stats["peer_bytes"] == sum(peer)
