"""The port's public names and keywords against the reference's, on the CPU.

* `repro_torch.{core,data,obs,kernels,serving,distributed,configs,models,
  optim,train,checkpoint}` re-export
  every public name of the reference's subpackage that the port has, in
  the reference's order; a name the port lacks must be listed in
  `NOT_PORTED` with the ROADMAP Queue 1 item that ports it, and must
  really be absent.
* The launch tools, `models.lm`, the language model's layers,
  `models.{registry,sharding_hints}` and `serving.serve_step` have each
  public name of the reference's module, with its parameters; the
  `WMDService` classmethods take the reference's.
* Every `ops` entry and every `kernels/*.py` kernel entry takes the
  reference's tiling keywords (``v_tile``, ``rows_blk``, ``q_blk``,
  ``interpret``) with the reference's defaults; passing them changes no
  bit, and a value the reference refuses is refused.
"""
import ast
import dataclasses
import importlib
import importlib.util
import inspect
import os
import pathlib

import numpy as np
import pytest
import torch

import repro.checkpoint
import repro.configs
import repro.core
import repro.data
import repro.distributed
import repro.kernels
import repro.models
import repro.obs
import repro.optim
import repro.serving
import repro.train
from repro.kernels import ops as ref_ops
from repro_torch.kernels import cdist as t_cdist
from repro_torch.kernels import kexp as t_kexp
from repro_torch.kernels import lcrwmd as t_lcrwmd
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import rwmd as t_rwmd
from repro_torch.kernels import sddmm_spmm as t_sddmm

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("core", "data", "obs", "kernels", "serving", "distributed",
               "configs", "models", "optim", "train", "checkpoint")

# reference names the port does not have yet -> the ROADMAP Queue 1 item
NOT_PORTED = {
    "core": {},
    "data": {},
    "obs": {},
    "kernels": {},
    "serving": {},
    "distributed": {},
    "configs": {},
    "models": {},
    "optim": {},
    "train": {},
    "checkpoint": {},
}

REF = {"core": repro.core, "data": repro.data, "obs": repro.obs,
       "kernels": repro.kernels, "serving": repro.serving,
       "distributed": repro.distributed, "configs": repro.configs,
       "models": repro.models, "optim": repro.optim, "train": repro.train,
       "checkpoint": repro.checkpoint}


def _port(sub):
    return importlib.import_module(f"repro_torch.{sub}")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_every_ported_reference_name_in_order(sub):
    ref_all, port = REF[sub].__all__, _port(sub)
    missing = [n for n in ref_all
               if n not in port.__all__ and n not in NOT_PORTED[sub]]
    assert not missing, f"repro_torch.{sub} lacks {missing} and they are " \
                        f"not listed as unported"
    assert port.__all__ == [n for n in ref_all if n not in NOT_PORTED[sub]]
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_unported_names_are_reference_names_absent_from_the_port(sub):
    port = _port(sub)
    for name, item in NOT_PORTED[sub].items():
        assert name in REF[sub].__all__, name
        assert not hasattr(port, name), f"{name} is ported: export it"
        assert item in (1, 2, 3, 4, 5)


def test_reexports_are_the_modules_objects():
    from repro_torch.core import sparse_sinkhorn
    from repro_torch.data import corpus
    from repro_torch.obs import metrics
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    assert core.sinkhorn_wmd_sparse is sparse_sinkhorn.sinkhorn_wmd_sparse
    assert kernels.ops is t_ops
    from repro_torch.data import make_corpus
    from repro_torch.obs import MetricsRegistry
    assert make_corpus is corpus.make_corpus
    assert MetricsRegistry is metrics.MetricsRegistry
    import repro_torch.distributed as distributed
    import repro_torch.serving as serving
    from repro_torch.distributed import fault_tolerance
    from repro_torch.obs import Tracer, render_prometheus
    from repro_torch.obs import export, trace
    from repro_torch.serving import coalescer, warmup
    assert Tracer is trace.Tracer
    assert render_prometheus is export.render_prometheus
    assert serving.QueryCoalescer is coalescer.QueryCoalescer
    assert serving.warm is warmup.warm
    assert distributed.fault_tolerance is fault_tolerance
    from repro_torch.distributed import elastic
    assert distributed.elastic is elastic
    import repro_torch.configs as configs
    import repro_torch.models as models
    from repro_torch.configs import registry
    from repro_torch.core import ot
    from repro_torch.data import tokens
    from repro_torch.models import registry as model_registry
    from repro_torch.serving import serve_step
    assert configs.get_config is registry.get_config
    assert models.build_model is model_registry.build_model
    assert core.sinkhorn_plan is ot.sinkhorn_plan
    from repro_torch.data import TokenPipeline
    assert TokenPipeline is tokens.TokenPipeline
    assert serving.build_serve_fns is serve_step.build_serve_fns
    import repro_torch.checkpoint as checkpoint
    import repro_torch.optim as optim
    import repro_torch.train as train
    from repro_torch.checkpoint import checkpointer
    from repro_torch.distributed import partitioning
    from repro_torch.optim import compression
    from repro_torch.train import step, trainer
    assert distributed.partitioning is partitioning
    assert optim.adamw is importlib.import_module(
        "repro_torch.optim.adamw").adamw
    assert optim.init_compression_state is compression.init_state
    assert train.Trainer is trainer.Trainer
    assert train.build_train_step is step.build_train_step
    assert checkpoint.restore is checkpointer.restore


def _public(mod) -> dict:
    """The public names a module defines (not its imports): functions,
    classes and constants."""
    out = {}
    for name, value in vars(mod).items():
        if name.startswith("_") or name == "annotations" or \
                inspect.ismodule(value):
            continue
        if callable(value) and getattr(value, "__module__", None) != \
                mod.__name__:
            continue
        out[name] = value
    return out


# names the mixers' modules define beyond the reference's: their forms on
# the port's mesh program (the reference's GSPMD places the same functions
# on a mesh), each with the test of whether its split applies
MESH_EXTRAS = {"models.layers.mla": {"splits", "mesh_full", "mesh_decode"},
               "models.layers.rglru": {"splits", "mesh_full",
                                       "mesh_decode"},
               "models.layers.xlstm": {"mlstm_splits", "mesh_mlstm_full",
                                       "mesh_mlstm_decode"}}


@pytest.mark.parametrize("module", ["models.layers.mla", "models.layers.rglru",
                                    "models.layers.xlstm", "models.encdec"])
def test_mixer_modules_have_every_reference_name(module):
    """The remaining mixers' modules have each public name of the
    reference's module (plus `MESH_EXTRAS`); a function takes the
    reference's parameters in its order (the port adds keyword-only ones:
    ``lead``, ``device``, ``donate``); a state or cache has the
    reference's fields."""
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    want, got = _public(ref), _public(port)
    assert sorted(want) == sorted(set(got) - MESH_EXTRAS.get(module, set()))
    for name, item in want.items():
        if hasattr(item, "_fields"):
            assert got[name]._fields == item._fields, name
        elif inspect.isfunction(item):
            ref_params = list(inspect.signature(item).parameters)
            mine = inspect.signature(got[name]).parameters
            assert list(mine)[:len(ref_params)] == ref_params, name
            assert all(p.kind is p.KEYWORD_ONLY
                       for p in list(mine.values())[len(ref_params):]), name
        else:
            assert got[name] == item, name


# names the port's training modules define beyond the reference's: the
# spec and sharding records the reference imports from jax, the placed
# leaf and its cutting and assembling (the reference's jax.Array and
# device_put), the state's meta-device structure and the placement helper
# of the train step
TRAINING_EXTRAS = {"distributed.partitioning": {"P", "NamedSharding",
                                                "Placed", "block_slices",
                                                "shard", "unshard"},
                   "train.step": {"state_struct", "place"}}


def _params_extend(ref_fn, port_fn, name):
    """The port's parameters are the reference's, in order, then keyword-
    only ones (a launcher's ``main`` also takes ``argv=None``, as
    `launch.serve.main` does)."""
    ref_params = list(inspect.signature(ref_fn).parameters)
    mine = inspect.signature(port_fn).parameters
    assert list(mine)[:len(ref_params)] == ref_params, name
    extra = list(mine.values())[len(ref_params):]
    if name == "main":
        assert [p.name for p in extra] == ["argv"] and \
            extra[0].default is None, name
        return
    assert all(p.kind is p.KEYWORD_ONLY for p in extra), name


@pytest.mark.parametrize("module", [
    "optim.adamw", "optim.schedules", "optim.compression",
    "checkpoint.checkpointer", "distributed.partitioning", "train.step",
    "train.trainer", "launch.train"])
def test_training_modules_have_every_reference_name(module):
    """Each public name of the reference's training modules is in the
    port's (plus `TRAINING_EXTRAS`); functions and public methods take the
    reference's parameters in its order (the port adds keyword-only ones:
    ``donate``), NamedTuples have its fields, constants its values."""
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    want, got = _public(ref), _public(port)
    assert sorted(want) == sorted(set(got) - TRAINING_EXTRAS.get(module,
                                                                 set()))
    for name, item in want.items():
        if hasattr(item, "_fields"):
            assert got[name]._fields == item._fields, name
        elif inspect.isclass(item):
            for meth, fn in vars(item).items():
                if inspect.isfunction(fn) and (not meth.startswith("_")
                                               or meth == "__init__"):
                    _params_extend(fn, getattr(got[name], meth),
                                   f"{name}.{meth}")
            for meth in vars(item):
                if not meth.startswith("__"):
                    assert hasattr(got[name], meth), f"{name}.{meth}"
        elif inspect.isfunction(item):
            _params_extend(item, got[name], name)
        else:
            assert got[name] == item, name


# names the launch tools, the language model's modules and the serving
# steps define beyond the reference's: the count's machinery, the dry
# run's meta mesh and placement bytes, the roofline's fp32 peak, terms
# and row; the mesh program's forms (`models.lm`, the layers in
# `models.layers`) and its pieces; `sharding_hints.current`
LAUNCH_LM_EXTRAS = {
    "launch.costmodel": {"Recording", "count", "record"},
    "launch.dryrun": {"count_cell", "meta_mesh", "position_bytes"},
    "launch.roofline": {"PEAK_FLOPS_FP32", "peak_flops", "row", "terms"},
    "models.lm": {"program_layout", "remat_call"},
    "models.layers.attention": {"mesh_full", "mesh_decode", "mesh_plan",
                                "mesh_cross_kv", "mesh_cross_decode",
                                "decode_qkv", "decode_attend"},
    "models.layers.moe": {"mesh_apply", "capacity", "dispatch", "experts",
                          "combine"},
    "models.layers.mlp": {"mesh_apply"},
    "models.layers.embedding": {"mesh_embed", "mesh_logits",
                                "mesh_unshard_logits", "shard_rows",
                                "finish_embed"},
    "models.sharding_hints": {"current"},
}
# constants whose values differ by design: the H100's peaks, HBM and
# NVLink rates, and the port's own output directories
DIFFERENT_VALUES = {"launch.roofline": {"PEAK_FLOPS", "HBM_BW", "LINK_BW",
                                        "OUT_DIR"},
                    "launch.dryrun": {"OUT_DIR"}}


def _reference_module(module):
    """The reference's module; `launch.dryrun` sets XLA_FLAGS at import
    (512 host devices), which is put back before any JAX backend starts."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.{module}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@pytest.mark.parametrize("module", [
    "launch.costmodel", "launch.dryrun", "launch.roofline", "models.lm",
    "models.layers.attention", "models.layers.moe", "models.layers.mlp",
    "models.layers.embedding", "models.layers.norms", "models.layers.rope",
    "models.registry", "models.sharding_hints", "serving.serve_step"])
def test_launch_and_lm_modules_have_every_reference_name(module):
    """Each public name of the reference's launch tools, language-model
    modules and serving steps is in the port's (plus `LAUNCH_LM_EXTRAS`);
    functions take the reference's parameters in its order (then
    keyword-only ones; ``main`` adds ``argv=None``), NamedTuples have its
    fields, dataclasses its fields, constants its values (but
    `DIFFERENT_VALUES`)."""
    ref = _reference_module(module)
    port = importlib.import_module(f"repro_torch.{module}")
    want, got = _public(ref), _public(port)
    assert sorted(want) == sorted(set(got) - LAUNCH_LM_EXTRAS.get(module,
                                                                  set()))
    for name, item in want.items():
        if hasattr(item, "_fields"):
            assert got[name]._fields == item._fields, name
        elif dataclasses.is_dataclass(item):
            assert [f.name for f in dataclasses.fields(got[name])] == \
                [f.name for f in dataclasses.fields(item)], name
            for meth in ("__add__", "__mul__"):
                assert hasattr(got[name], meth) == hasattr(item, meth)
        elif inspect.isfunction(item):
            _params_extend(item, got[name], name)
        elif name not in DIFFERENT_VALUES.get(module, ()):
            assert got[name] == item, name


def test_wmd_service_classmethods_take_the_reference_parameters():
    """Each classmethod of the reference's `WMDService` (``from_live``:
    mesh first) takes the same parameters, in order, in the port."""
    from repro.serving import WMDService as Ref
    from repro_torch.serving import WMDService
    found = 0
    for name, raw in vars(Ref).items():
        if isinstance(raw, classmethod):
            found += 1
            mine = inspect.getattr_static(WMDService, name)
            assert isinstance(mine, classmethod), name
            assert list(inspect.signature(mine.__func__).parameters) == \
                list(inspect.signature(raw.__func__).parameters), name
    assert found


def _reference_imports():
    """(file, subpackage, name) of every ``from repro.<sub> import name`` in
    the reference's examples and benchmarks."""
    out = []
    for path in sorted((ROOT / "examples").glob("*.py")) + sorted(
            (ROOT / "benchmarks").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module in {f"repro.{s}" for s in SUBPACKAGES}:
                sub = node.module.split(".")[1]
                out += [(path.name, sub, a.name) for a in node.names]
    return out


def test_reference_scripts_import_names_the_port_exports_or_lists():
    """A name the reference's scripts import from a subpackage is exported
    by the port's, is one of its modules, or is listed as unported."""
    found = _reference_imports()
    assert found
    for fname, sub, name in found:
        assert (name in _port(sub).__all__ or name in NOT_PORTED[sub]
                or importlib.util.find_spec(f"repro_torch.{sub}.{name}")), \
            (fname, sub, name)


# -- the tiling keywords -----------------------------------------------------

TILE_KEYS = ("v_tile", "rows_blk", "q_blk", "interpret")

# entry -> (port function, reference function or its dotted name)
ENTRIES = {
    "ops.cdist": (t_ops.cdist, ref_ops.cdist),
    "ops.cdist_kexp": (t_ops.cdist_kexp, ref_ops.cdist_kexp),
    "ops.cdist_kexp_rows": (t_ops.cdist_kexp_rows, ref_ops.cdist_kexp_rows),
    "ops.sddmm_spmm_type1_batch": (t_ops.sddmm_spmm_type1_batch,
                                   ref_ops.sddmm_spmm_type1_batch),
    "ops.sddmm_spmm_type2_batch": (t_ops.sddmm_spmm_type2_batch,
                                   ref_ops.sddmm_spmm_type2_batch),
    "ops.rwmd_bound_batch": (t_ops.rwmd_bound_batch,
                             ref_ops.rwmd_bound_batch),
    "ops.lc_rwmd_bound_batch": (t_ops.lc_rwmd_bound_batch,
                                ref_ops.lc_rwmd_bound_batch),
    "cdist.cdist": (t_cdist.cdist, "repro.kernels.cdist.cdist"),
    "kexp.cdist_kexp": (t_kexp.cdist_kexp, "repro.kernels.kexp.cdist_kexp"),
    "kexp.cdist_kexp_rows": (t_kexp.cdist_kexp_rows,
                             "repro.kernels.kexp.cdist_kexp_rows"),
    "sddmm_spmm.sddmm_spmm_type1": (
        t_sddmm.sddmm_spmm_type1, "repro.kernels.sddmm_spmm.sddmm_spmm_type1"),
    "sddmm_spmm.sddmm_spmm_type2": (
        t_sddmm.sddmm_spmm_type2, "repro.kernels.sddmm_spmm.sddmm_spmm_type2"),
    "sddmm_spmm.sddmm_spmm_type1_batch": (
        t_sddmm.sddmm_spmm_type1_batch,
        "repro.kernels.sddmm_spmm.sddmm_spmm_type1_batch"),
    "sddmm_spmm.sddmm_spmm_type2_batch": (
        t_sddmm.sddmm_spmm_type2_batch,
        "repro.kernels.sddmm_spmm.sddmm_spmm_type2_batch"),
    "rwmd.rwmd_bound_batch": (t_rwmd.rwmd_bound_batch,
                              "repro.kernels.rwmd.rwmd_bound_batch"),
    "lcrwmd.lc_rwmd_bound_batch": (
        t_lcrwmd.lc_rwmd_bound_batch,
        "repro.kernels.lcrwmd.lc_rwmd_bound_batch"),
}


def _ref_fn(ref):
    if not isinstance(ref, str):
        return ref
    mod, name = ref.rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)


def _params(fn):
    fn = inspect.unwrap(getattr(fn, "__wrapped__", fn))
    return inspect.signature(fn).parameters


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_takes_the_reference_tiling_keywords(entry):
    port, ref = ENTRIES[entry]
    ref_p, port_p = _params(_ref_fn(ref)), _params(port)
    keys = [k for k in TILE_KEYS if k in ref_p]
    assert keys, entry
    for k in keys:
        assert k in port_p, f"{entry} lacks {k}"
        assert port_p[k].kind == inspect.Parameter.KEYWORD_ONLY
        want = None if k == "q_blk" else ref_p[k].default
        assert port_p[k].default == want, (entry, k)


def _dense_problem(seed=0, m=5, v=40, w=7):
    rng = np.random.default_rng(seed)
    b = rng.normal(scale=1.3, size=(v, w)).astype(np.float32)
    a = b[rng.choice(v, m, replace=False)].copy()
    return torch.from_numpy(a), torch.from_numpy(b)


def _ell_problem(seed=1, q=3, v_r=6, v=40, n=9, nnz=5):
    rng = np.random.default_rng(seed)
    k = rng.random((q, v_r, v + 1)).astype(np.float32)
    k[:, :, v] = 0.0
    km = (k * 2.0).astype(np.float32)
    r = (rng.random((q, v_r)) + 0.1).astype(np.float32)
    u = (rng.random((q, v_r, n)) + 0.1).astype(np.float32)
    cols = rng.integers(0, v, (n, nnz)).astype(np.int32)
    cols[:, -1] = v
    vals = rng.random((n, nnz)).astype(np.float32)
    vals[:, -1] = 0.0
    return tuple(torch.from_numpy(x) for x in (k, km, r, u, cols, vals))


def _ops_calls():
    """entry -> (call taking **kw, the tiling keywords to pass)"""
    a, b = _dense_problem()
    k, km, r, u, cols, vals = _ell_problem()
    minm = km.min(dim=1).values
    return {
        "ops.cdist": (lambda **kw: (t_ops.cdist(a, b, **kw),),
                      dict(v_tile=512)),
        "ops.cdist_kexp": (lambda **kw: t_ops.cdist_kexp(a, b, lamb=1.0,
                                                         **kw),
                           dict(v_tile=512)),
        "ops.cdist_kexp_rows": (
            lambda **kw: t_ops.cdist_kexp_rows(a, b, lamb=1.0, **kw),
            dict(rows_blk=8, v_tile=512)),
        "ops.sddmm_spmm_type1_batch": (
            lambda **kw: (t_ops.sddmm_spmm_type1_batch(k, r, u, cols, vals,
                                                       **kw),),
            dict(q_blk=2)),
        "ops.sddmm_spmm_type2_batch": (
            lambda **kw: (t_ops.sddmm_spmm_type2_batch(k, km, u, cols, vals,
                                                       **kw),),
            dict(q_blk=4)),
        "ops.rwmd_bound_batch": (
            lambda **kw: (t_ops.rwmd_bound_batch(km, cols, vals, **kw),),
            dict(q_blk=4)),
        "ops.lc_rwmd_bound_batch": (
            lambda **kw: (t_ops.lc_rwmd_bound_batch(minm, cols, vals,
                                                    **kw),),
            dict(q_blk=4)),
    }


@pytest.mark.parametrize("entry", sorted(e for e in ENTRIES
                                         if e.startswith("ops.")))
def test_ops_tiling_keywords_change_no_bits(entry):
    call, kw = _ops_calls()[entry]
    want = call()
    for value in (kw, {k: 7 for k in kw}, {k: True for k in kw}):
        got = call(**value)
        assert all(torch.equal(g, x) for g, x in zip(got, want)), value


INVALID = (0, -8, 2.5, "8")


@pytest.mark.parametrize("entry", sorted(e for e in ENTRIES
                                         if e.startswith("ops.")))
def test_ops_refuse_what_the_reference_refuses(entry):
    call, kw = _ops_calls()[entry]
    a, b = _dense_problem()
    ref_fn = _ref_fn(ENTRIES[entry][1])
    for key in kw:
        for bad in INVALID + (() if key == "q_blk" else (None,)):
            with pytest.raises((TypeError, ValueError)):
                call(**{key: bad})
            if entry.startswith("ops.cdist"):
                # the reference refuses it too (ZeroDivisionError at 0)
                extra = {} if entry == "ops.cdist" else {"lamb": 1.0}
                with pytest.raises(Exception):
                    ref_fn(a.numpy(), b.numpy(), **extra, **{key: bad})


def _kernel_calls():
    """entry -> (call taking **kw on CPU tensors, the keywords to pass)"""
    a, b = _dense_problem()
    k, km, r, u, cols, vals = _ell_problem()
    minm = km.min(dim=1).values
    return {
        "cdist.cdist": (lambda **kw: t_cdist.cdist(a, b, **kw),
                        dict(v_tile=512, interpret=False)),
        "kexp.cdist_kexp": (lambda **kw: t_kexp.cdist_kexp(a, b, lamb=1.0,
                                                           **kw),
                            dict(v_tile=512, interpret=False)),
        "kexp.cdist_kexp_rows": (
            lambda **kw: t_kexp.cdist_kexp_rows(a, b, lamb=1.0, **kw),
            dict(rows_blk=8, v_tile=512, interpret=False)),
        "sddmm_spmm.sddmm_spmm_type1": (
            lambda **kw: t_sddmm.sddmm_spmm_type1(k[0], r[0], u[0], cols,
                                                  vals, **kw),
            dict(interpret=False)),
        "sddmm_spmm.sddmm_spmm_type2": (
            lambda **kw: t_sddmm.sddmm_spmm_type2(k[0], km[0], u[0], cols,
                                                  vals, **kw),
            dict(interpret=False)),
        "sddmm_spmm.sddmm_spmm_type1_batch": (
            lambda **kw: t_sddmm.sddmm_spmm_type1_batch(k, r, u, cols, vals,
                                                        **kw),
            dict(q_blk=8, interpret=False)),
        "sddmm_spmm.sddmm_spmm_type2_batch": (
            lambda **kw: t_sddmm.sddmm_spmm_type2_batch(k, km, u, cols, vals,
                                                        **kw),
            dict(q_blk=8, interpret=False)),
        "rwmd.rwmd_bound_batch": (
            lambda **kw: t_rwmd.rwmd_bound_batch(km, cols, vals, **kw),
            dict(q_blk=8, interpret=False)),
        "lcrwmd.lc_rwmd_bound_batch": (
            lambda **kw: t_lcrwmd.lc_rwmd_bound_batch(minm, cols, vals,
                                                      **kw),
            dict(q_blk=8, interpret=False)),
    }


@pytest.mark.parametrize("entry", sorted(e for e in ENTRIES
                                         if not e.startswith("ops.")))
def test_kernel_entries_take_the_keywords_and_check_them_first(entry):
    """On CPU tensors a CUDA kernel entry raises that it takes CUDA tensors,
    with the reference's keywords as without them; a keyword value the
    reference refuses is refused before that."""
    call, kw = _kernel_calls()[entry]
    with pytest.raises(ValueError, match="CUDA") as plain:
        call()
    with pytest.raises(ValueError, match="CUDA") as with_kw:
        call(**kw)
    assert str(plain.value) == str(with_kw.value)
    for key in kw:
        if key == "interpret":
            continue
        for bad in INVALID:
            with pytest.raises((TypeError, ValueError),
                               match=key):
                call(**{key: bad})
