"""The port's examples (`examples/torch_*.py`) on the CPU at tiny sizes.

Each example's sizes are shrunk through its module constants (the train
example's through `model_config`), and its `main(argv)` runs with
``--device cpu``: quickstart's and doc_retrieval's distances are held to
live JAX (`repro.core`) on the same `make_corpus` seed at the engines'
``rtol=2e-3, atol=1e-5``; the service's default and ``--batch-queries``
top-3 are held to the reference example run with the same flags (its
printed lines parsed, so the distances' tolerance adds the half unit of
their 3-decimal rounding); every service mode of chip_smoke.py's phase 18
runs, its bitwise asserts holding; the train example takes 3 steps with
each router and its full-size config counts the reference's parameters;
each example takes its reference's flags, plus ``--device``, and raises
without a card unless given ``--device cpu``."""
import ast
import dataclasses
import importlib.util
import math
import pathlib
import re
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
NAMES = ("quickstart", "doc_retrieval", "wmd_query_service",
         "train_moe_sinkhorn")
TOL = dict(rtol=2e-3, atol=1e-5)
PRINT_HALF_UNIT = 5e-4      # the examples print distances to 3 decimals
SERVICE_TINY = ["--device", "cpu", "--docs", "64", "--vocab", "512"]


def _load(path: pathlib.Path):
    """An example file as a fresh module (its `main` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(EXAMPLES / f"torch_{name}.py")


# -- quickstart and doc_retrieval against live JAX ---------------------------

def test_quickstart_matches_live_jax(monkeypatch, capsys):
    """quickstart at V 1,024, w 32, N 64 (``main()`` reading ``sys.argv``):
    dense and sparse agree, and the sparse distances and nearest ids are
    live JAX's `sinkhorn_wmd_sparse` on the same corpus."""
    from repro.core import select_query, sinkhorn_wmd_sparse
    from repro.data import make_corpus
    qs = _port("quickstart")
    monkeypatch.setattr(qs, "VOCAB", 1024)
    monkeypatch.setattr(qs, "EMBED", 32)
    monkeypatch.setattr(qs, "DOCS", 64)
    monkeypatch.setattr(sys, "argv", ["torch_quickstart.py", "--device",
                                      "cpu"])
    out = qs.main()
    printed = capsys.readouterr().out
    data = make_corpus(vocab_size=1024, embed_dim=32, num_docs=64,
                       num_queries=1, seed=0)
    sel, r_sel = select_query(data.queries[0])
    ref = np.asarray(sinkhorn_wmd_sparse(sel, r_sel, data.ell.cols,
                                         data.ell.vals, data.vecs,
                                         qs.LAMB, qs.ITERS))
    np.testing.assert_allclose(out["sparse"], ref, **TOL)
    assert out["rel_diff"] <= TOL["rtol"]
    top = np.argsort(ref)[:5].tolist()
    assert np.argsort(out["sparse"])[:5].tolist() == top
    assert f"nearest docs: {top}" in printed
    assert "max rel diff" in printed


def test_doc_retrieval_matches_live_jax(monkeypatch):
    """doc_retrieval at V 512, w 16, N 64, 2 queries, 60 iterations (the
    converged loop up to 150): the fixed-iteration distances are live
    JAX's, the converged loop stops within one iteration of live JAX's
    (a delta at the tolerance's edge may cross it one step apart) and its
    distances agree."""
    from repro.core import (select_query, sinkhorn_wmd_converged,
                            sinkhorn_wmd_sparse)
    from repro.data import make_corpus
    dr = _port("doc_retrieval")
    for name, value in (("VOCAB", 512), ("EMBED", 16), ("DOCS", 64),
                        ("QUERIES", 2), ("ITERS", 60), ("MAX_ITER", 150)):
        monkeypatch.setattr(dr, name, value)
    out = dr.main(["--device", "cpu"])
    data = make_corpus(vocab_size=512, embed_dim=16, num_docs=64,
                       num_queries=2, seed=1)
    assert len(out) == 2
    for got, query in zip(out, data.queries):
        sel, r_sel = select_query(query)
        ref = np.asarray(sinkhorn_wmd_sparse(sel, r_sel, data.ell.cols,
                                             data.ell.vals, data.vecs,
                                             dr.LAMB, 60))
        np.testing.assert_allclose(got["wmd"], ref, **TOL)
        assert got["top_wmd"].tolist() == np.argsort(ref)[:10].tolist()
        conv = sinkhorn_wmd_converged(sel, r_sel, data.ell.cols,
                                      data.ell.vals, data.vecs, dr.LAMB,
                                      150, tol=dr.TOL)
        assert abs(got["n_iter"] - int(conv.n_iter)) <= 1
        np.testing.assert_allclose(got["converged_wmd"],
                                   np.asarray(conv.wmd), **TOL)


# -- the service ------------------------------------------------------------

_TOP3 = re.compile(r"^query (\d+): top3=\[([\d, ]+)\] d=\[([^\]]+)\]")


def _parsed_top3(text: str) -> dict[int, tuple[list, list]]:
    out = {}
    for line in text.splitlines():
        m = _TOP3.match(line)
        if m:
            out[int(m.group(1))] = ([int(x) for x in m.group(2).split(",")],
                                    [float(x) for x in m.group(3).split(",")])
    return out


@pytest.mark.parametrize("mode", [[], ["--batch-queries"]],
                         ids=["default", "batch-queries"])
def test_service_top3_matches_the_reference_example(mode, monkeypatch,
                                                    capsys):
    """The default mode's and ``--batch-queries``' top-3 ids and distances
    at ``--docs 64 --vocab 512`` are the reference example's printed ones
    (its run in this process, on live JAX)."""
    ref_mod = _load(EXAMPLES / "wmd_query_service.py")
    monkeypatch.setattr(sys, "argv", ["wmd_query_service.py", "--docs", "64",
                                      "--vocab", "512", *mode])
    ref_mod.main()
    ref = _parsed_top3(capsys.readouterr().out)
    out = _port("wmd_query_service").main(SERVICE_TINY + mode)
    printed = _parsed_top3(capsys.readouterr().out)
    if mode:
        got = [(np.argsort(d)[:3], np.sort(d)[:3]) for d in out["dists"]]
    else:
        got = out["top"]
    assert len(ref) == len(got) == 6
    for i, (idx, dist) in enumerate(got):
        assert list(idx) == ref[i][0] == printed[i][0], i
        np.testing.assert_allclose(
            dist, ref[i][1], rtol=TOL["rtol"],
            atol=TOL["atol"] + PRINT_HALF_UNIT)


SERVICE_MODES = {
    "default": [],
    "batch-queries": ["--batch-queries"],
    "docs-chunk": ["--docs-chunk", "32", "--batch-queries"],
    "zipf-stream": ["--zipf-stream"],
    "coalesce": ["--coalesce"],
    "top-k-prune": ["--top-k", "8", "--prune"],
    "offline-top-k-prune": ["--offline", "64", "--top-k", "8", "--prune"],
    "devices-4": ["--devices", "4", "--batch-queries"],
}


@pytest.mark.parametrize("mode", list(SERVICE_MODES))
def test_service_mode_runs_on_cpu(mode):
    """Each mode of chip_smoke.py's phase 18(c) at ``--docs 64 --vocab
    512 --device cpu``: it returns, the pruned modes' bitwise asserts
    hold, ``--devices 4`` serves on a (2, 2) mesh of CPU logical shards."""
    out = _port("wmd_query_service").main(SERVICE_TINY + SERVICE_MODES[mode])
    svc = out["svc"]
    assert svc.device.type == "cpu"
    if mode.endswith("prune"):
        assert out["exact"] is True
    if mode == "devices-4":
        assert dict(svc.mesh.shape) == {"data": 2, "model": 2}
        assert {d.type for d in svc.mesh.devices.flat} == {"cpu"}
    else:
        assert svc.mesh.size == 1
    if mode == "docs-chunk":
        assert svc.docs_chunk == 32
    if mode in ("zipf-stream", "coalesce"):
        assert svc.cache_stats.hit_rate > 0
    if mode == "coalesce":
        assert out["loadgen"].completed == 8 * 12


def test_service_cache_dir_twice(tmp_path, monkeypatch):
    """``--offline 16 --cache-dir D`` twice on one directory: both runs
    score every query and report 0 builds (on the CPU nothing is built);
    the kernels' build directory is D while they run."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    cache = tmp_path / "kernels"
    for _ in range(2):
        out = _port("wmd_query_service").main(
            SERVICE_TINY + ["--offline", "16", "--cache-dir", str(cache)])
        assert out["offline"].n == 16 and out["warmup"].compiles == 0
        assert _build.BUILD_DIR == cache and cache.is_dir()


# -- training ----------------------------------------------------------------

def _tiny(cfg):
    """``cfg`` at tiny widths: the family, router and structure kept."""
    return dataclasses.replace(
        cfg, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, vocab_size=512,
        moe=dataclasses.replace(cfg.moe, d_ff_expert=64))


@pytest.mark.parametrize("router", ["sinkhorn", "topk"])
def test_train_example_three_steps(router, tmp_path, monkeypatch, capsys):
    """3 steps of the train example on a tiny config, each router: finite
    losses, the reference's two printed lines, a checkpoint of step 3
    under ``--ckpt-dir`` suffixed with the router."""
    tr = _port("train_moe_sinkhorn")
    full = tr.model_config
    monkeypatch.setattr(tr, "model_config", lambda r: _tiny(full(r)))
    ck = tmp_path / "ck"
    out = tr.main(["--steps", "3", "--router", router, "--batch", "2",
                   "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
                   str(ck)])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    printed = capsys.readouterr().out
    assert f"model: moe-100m-{router}" in printed
    assert f"[{router}] loss {losses[0]:.4f} -> {losses[-1]:.4f} over 3 " \
           f"steps" in printed
    assert (tmp_path / f"ck-{router}").is_dir()


def _reference_config(router):
    """The reference example's ModelConfig, built from its own literal (the
    `ModelConfig(...)` call in its `main`)."""
    from repro.configs.base import ModelConfig, MoEConfig
    tree = ast.parse((EXAMPLES / "train_moe_sinkhorn.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "ModelConfig")
    return eval(compile(ast.Expression(call), "train_moe_sinkhorn.py",
                        "eval"),
                {"ModelConfig": ModelConfig, "MoEConfig": MoEConfig,
                 "args": types.SimpleNamespace(router=router)})


@pytest.mark.parametrize("router", ["sinkhorn", "topk"])
def test_train_config_counts_the_reference_parameters(router):
    """The port's full-size `model_config` is the reference's literal: the
    same name, router, parameter count and active parameter count."""
    mine = _port("train_moe_sinkhorn").model_config(router)
    ref = _reference_config(router)
    assert mine.name == ref.name == f"moe-100m-{router}"
    assert mine.moe.router == ref.moe.router == router
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()


# -- flags and the card ------------------------------------------------------

def _flags(path: pathlib.Path) -> dict[str, object]:
    """{flag: default} of every ``add_argument`` call in a file (None where
    no default is given, the literal default otherwise)."""
    flags = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            flags[node.args[0].value] = (ast.literal_eval(default)
                                         if default is not None else None)
    return flags


@pytest.mark.parametrize("name", NAMES)
def test_example_flags_are_the_reference_flags_and_device(name):
    """Each example's flags and defaults are its reference's, plus
    ``--device`` (default ``cuda``)."""
    want = _flags(EXAMPLES / f"{name}.py")
    got = _flags(EXAMPLES / f"torch_{name}.py")
    assert got.pop("--device") == "cuda"
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_a_card(name, tmp_path, monkeypatch):
    """With ``--device cuda`` (the default) and no card, each example
    raises before it computes anything: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt-dir", str(tmp_path / "ck")] \
        if name == "train_moe_sinkhorn" else []
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        _port(name).main(argv)
    assert not any(tmp_path.iterdir())
