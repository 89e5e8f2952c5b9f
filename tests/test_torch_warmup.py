"""The port's warmup layer (`repro_torch.serving.warmup`,
`WMDService.warmup`, `QueryCoalescer.warm_registry`) on the CPU.

* `ShapeRegistry.from_service` gives the reference's labels for the same
  config, ``max_batch``, ``ks`` and ``kinds``; `synth_queries` and the
  M-chunk sweep give the reference's payloads.
* After `warm`, a randomized coalesced session dispatches only registered
  shapes.
* The compile side is the port's build layer: `measure_compiles` counts 0
  on the CPU (nothing is built), and counts the build layer's compiles and
  loads where they happen; `enable_compilation_cache` moves the build
  directory and `flush_compilation_cache` reports its libraries.
* `WarmupReport.summary()` has the reference's keys.
"""
import random
import types

import numpy as np
import pytest

import repro.serving.warmup as ref_warmup
from repro_torch.kernels import _build
from repro_torch.serving import (ProgramShape, QueryCoalescer, ShapeRegistry,
                                 WarmupReport, enable_compilation_cache,
                                 flush_compilation_cache, measure_compiles,
                                 warm)
from repro_torch.serving.warmup import (ShapeWarmup, _bound_chunk_payloads,
                                        synth_queries)

NEVER_MS = 10_000.0
SHAPE = dict(vocab_size=192, embed_dim=16, num_docs=32, nnz_max=32, v_r=8,
             lamb=1.0, max_iter=8)


@pytest.fixture(scope="module")
def stack():
    """Tiny corpus (the reference test's recipe) + a cached, prunable
    port service."""
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data import make_corpus
    cfg = WMDConfig(name="t-warmup", **SHAPE)
    data = make_corpus(vocab_size=192, embed_dim=16, num_docs=32,
                       num_queries=12, query_words=6, mean_words=6.0,
                       seed=0)
    return cfg, data, _fresh_service((cfg, data))


def _fresh_service(stack):
    from repro_torch.serving import WMDService
    cfg, data = stack[:2]
    return WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device="cpu",
                      cache_capacity=48, cache_rows_bucket=8, prune_chunk=8)


def test_program_shape_validation_and_labels():
    assert ProgramShape("plain", 4).label == "plain/q4"
    assert ProgramShape("top_k", 8, k=5).label == "top_k/q8/k5"
    assert ProgramShape("top_k_union", 2, k=3).label == "top_k_union/q2/k3"
    assert ProgramShape("plain", 4).impl == "kernel"   # the port's default
    for bad in (("weird", 4), ("plain", 3), ("plain", 4, 5), ("top_k", 4)):
        with pytest.raises(ValueError):
            ProgramShape(*bad)


@pytest.mark.parametrize("kw", [
    dict(max_batch=8), dict(max_batch=5), dict(max_batch=4, ks=(3, 5)),
    dict(max_batch=2, ks=(3,), kinds=("top_k_union",)),
    dict(max_batch=16, ks=(10,), kinds=("plain", "top_k", "top_k_union"))])
def test_registry_labels_match_reference(stack, kw):
    from repro.configs.sinkhorn_wmd import WMDConfig as JConfig
    from repro.launch.mesh import make_mesh
    from repro.serving import WMDService as JService
    _, data, svc = stack
    jsvc = JService(mesh=make_mesh((1, 1), ("data", "model")),
                    cfg=JConfig(name="t-warmup", **SHAPE), vecs=data.vecs,
                    ell=data.ell, impl=svc.impl)
    labels = ShapeRegistry.from_service(svc, **kw).labels
    assert labels == ref_warmup.ShapeRegistry.from_service(jsvc, **kw).labels
    assert all(s.impl == "kernel"
               for s in ShapeRegistry.from_service(svc, **kw))


def test_registry_refuses_what_the_reference_refuses(stack):
    svc = stack[2]
    fake = types.SimpleNamespace(impl="fused")
    for kw in (dict(kinds=("top_k",)), dict(kinds=("bogus",))):
        for reg_cls, s in ((ShapeRegistry, svc),
                           (ref_warmup.ShapeRegistry, fake)):
            with pytest.raises(ValueError):
                reg_cls.from_service(s, **kw)


def test_registry_covers_is_bucket_rounded(stack):
    reg = ShapeRegistry.from_service(stack[2], max_batch=4, ks=(3,))
    for q in (1, 2, 3, 4):
        assert reg.covers("plain", q) and reg.covers("top_k", q, k=3)
    assert not reg.covers("plain", 5)
    assert not reg.covers("top_k", 2, k=9)
    assert not reg.covers("top_k_union", 2, k=3)


def test_warmup_payloads_match_reference(stack):
    cfg = stack[0]
    for a, b in zip(synth_queries(cfg, 5, seed=3),
                    ref_warmup.synth_queries(cfg, 5, seed=3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and (a > 0).sum() <= cfg.v_r - 1
        np.testing.assert_allclose(a.sum(), 1.0, rtol=1e-5)
    for q in (1, 4):
        port = list(_bound_chunk_payloads(cfg, q, 8, seed=2))
        ref = list(ref_warmup._bound_chunk_payloads(cfg, q, 8, seed=2))
        assert len(port) == len(ref) == -(-min(q * (cfg.v_r - 1), 192) // 8)
        for pb, rb in zip(port, ref):
            for a, b in zip(pb, rb):
                np.testing.assert_array_equal(a, b)


def test_warm_then_session_dispatches_only_registered_shapes(stack):
    """The envelope contract: after one registry pass, a randomized
    serving session (any arrival pattern, plain and top-k mixed) lands
    every batch on a registered shape, and builds nothing."""
    _, data, _ = stack
    svc = _fresh_service(stack)
    rng = random.Random(7)
    with QueryCoalescer(svc, window_ms=5.0, max_batch=4) as co:
        reg = ShapeRegistry.from_service(co.svc, max_batch=co.max_batch,
                                         ks=(3,))
        report = co.warm_registry(ks=(3,))
        assert set(report.shapes) == set(reg.labels)
        with measure_compiles() as cc:
            futs = []
            for _ in range(40):
                q = data.queries[rng.randrange(len(data.queries))]
                futs.append(co.submit(q) if rng.random() < 0.5
                            else co.submit_top_k(q, k=3))
            for f in futs:
                f.result(timeout=60)
        log = list(co.shape_log)
    assert log and len({q for _, q, _ in log}) > 1
    for kind, q, k in log:
        assert reg.covers(kind, q, k), (kind, q, k)
    assert cc.events == 0 and cc.compiles == 0


def test_warm_report_on_the_cpu_builds_nothing(stack):
    svc = _fresh_service(stack)
    reg = ShapeRegistry.from_service(svc, max_batch=2, ks=(3,),
                                     kinds=("plain", "top_k", "top_k_union"))
    report = warm(svc, reg)
    assert set(report.shapes) == set(reg.labels)
    assert report.compiles == report.persistent_hits == 0
    assert report.compile_s == report.retrieval_s == 0.0
    assert report.wall_s > 0
    assert all(s.wall_s > 0 for s in report.shapes.values())
    rep2 = svc.warmup(max_batch=2, ks=(3,))
    assert set(rep2.shapes) == {"plain/q1", "plain/q2", "top_k/q1/k3",
                                "top_k/q2/k3"}


def _report(mod, reg):
    shapes = {s.label: mod.ShapeWarmup(shape=s, wall_s=0.5, compiles=1,
                                       compile_s=0.25, persistent_hits=2,
                                       retrieval_s=0.125) for s in reg}
    return mod.WarmupReport(registry=reg, shapes=shapes, wall_s=1.0)


def test_warmup_report_summary_has_the_reference_keys(stack):
    fake = types.SimpleNamespace(impl="kernel")
    kw = dict(max_batch=2, ks=(3,))
    ref = _report(ref_warmup, ref_warmup.ShapeRegistry.from_service(fake,
                                                                    **kw))
    port = _report(__import__("repro_torch.serving.warmup",
                              fromlist=["ShapeWarmup"]),
                   ShapeRegistry.from_service(stack[2], **kw))
    assert isinstance(port, WarmupReport)
    assert port.summary() == ref.summary()
    assert port.compile_s_by_label() == ref.compile_s_by_label()
    assert (port.compiles, port.persistent_hits) == (4, 8)
    assert ShapeWarmup.__dataclass_fields__.keys() == \
        ref_warmup.ShapeWarmup.__dataclass_fields__.keys()


def test_coalescer_warm_registry_populates_and_merges_stats(stack):
    svc = _fresh_service(stack)
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=2) as co:
        co.warm_registry()
        co.warm_registry(ks=(3,), kinds=("top_k",))
        st = co.stats()
    assert set(st.warmup_compile_s) == {
        "plain/q1", "plain/q2", "top_k/q1/k3", "top_k/q2/k3"}
    assert st.warmed_shapes == 4
    assert all(v == 0.0 for v in st.warmup_compile_s.values())


def test_deprecated_warm_shims_forward_to_registry(stack):
    _, data, _ = stack
    svc = _fresh_service(stack)
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=4) as co:
        co.warm(list(data.queries[:2]))        # 2 queries, 3 buckets
        assert set(co.stats().warmup_compile_s) == {"plain/q1", "plain/q2",
                                                    "plain/q4"}
        co.warm_top_k(list(data.queries[:1]), 3)
        assert {"top_k/q1/k3", "top_k/q2/k3", "top_k/q4/k3"} <= \
            set(co.stats().warmup_compile_s)
        co.warm([])
        assert co.stats().warmed_shapes == 6


def test_measure_compiles_reads_the_build_layer():
    """What the build layer records inside the block, and nothing else:
    one nvcc compile and two libraries loaded from the build directory."""
    saved = _build.build_counts()
    try:
        with measure_compiles() as outer:
            with measure_compiles() as cc:
                with _build._lock:
                    _build.builds["compiles"] += 1
                    _build.builds["compile_s"] += 2.0
                    _build.builds["loads"] += 2
                    _build.builds["load_s"] += 0.5
        for c in (cc, outer):
            assert (c.events, c.compiles, c.persistent_hits) == (3, 1, 2)
            assert c.compile_s == pytest.approx(2.0)
            assert c.retrieval_s == pytest.approx(0.5)
        with measure_compiles() as idle:
            pass
        assert idle.events == 0 and idle.compile_s == 0.0
    finally:
        with _build._lock:
            _build.builds.update(saved)


def test_enable_and_flush_the_build_directory(tmp_path):
    saved = _build.BUILD_DIR
    try:
        d = enable_compilation_cache(tmp_path / "kernels")
        assert d == str(tmp_path / "kernels") and _build.BUILD_DIR.is_dir()
        assert _build._target("rwmd").parent == tmp_path / "kernels"
        (tmp_path / "kernels" / "librwmd-0123456789ab.so").write_bytes(
            b"x" * 10)
        (tmp_path / "kernels" / "librwmd-0123.1.tmp").write_bytes(b"y")
        assert flush_compilation_cache() == {
            "dir": str(tmp_path / "kernels"), "entries": 1, "bytes": 10}
        _build.set_build_dir(tmp_path / "absent")
        (tmp_path / "absent").rmdir()
        assert flush_compilation_cache() is None
    finally:
        _build.BUILD_DIR = saved
