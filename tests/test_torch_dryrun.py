"""The port's dry run and roofline (`repro_torch.launch.{dryrun,roofline}`)
on the CPU, at smoke sizes: the production mesh is monkeypatched to a
(2, 2) mesh of ``meta:i`` devices, the configs to their smoke configs and
the shapes to small ones.

* a cell's JSON has the reference's fields;
* the depth extrapolation (prefix + 1 and + 2 units) equals a full-depth
  count;
* the argument bytes a position equal the blocks `partitioning.shard`
  makes;
* the counted collective bytes equal what the spmd collectives copy
  between positions on a (2, 2) CPU mesh;
* `roofline.model_flops` equals the reference's on all 40 cells and the
  3 WMD shapes; `analyze_cell` on a synthetic record, by hand.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import cells as ref_cells
from repro.launch import roofline as ref_roofline
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import partitioning, spmd
from repro_torch.launch import costmodel, dryrun, roofline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.train.step import _MetaKey

SMALL = {"train_4k": ShapeConfig("train_4k", 16, 4, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 16, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 16, 4, "decode"),
         "long_500k": ShapeConfig("long_500k", 32, 2, "decode")}


def _meta22():
    return make_mesh((2, 2), ("data", "model"),
                     devices=[torch.device("meta", i) for i in range(4)])


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(dryrun, "meta_mesh", lambda multi_pod=False:
                        _meta22())
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "get_shape", SMALL.__getitem__)


FIELDS = ("compile_seconds", "memory_analysis", "cost_analysis_raw",
          "jaxpr_cost", "collectives", "status")


@pytest.mark.parametrize("arch,shape", [("deepseek-moe-16b", "decode_32k"),
                                        ("olmo-1b", "train_4k"),
                                        ("sinkhorn-wmd", "prod_5m_opt")])
def test_a_cell_record_has_the_reference_fields(small, tmp_path, arch,
                                                shape):
    rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    on_disk = json.loads((tmp_path / "pod16x16" /
                          f"{arch}__{shape}.json").read_text())
    for k in FIELDS:
        assert k in on_disk, k
    ma = on_disk["memory_analysis"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes"):
        assert k in ma
    assert set(on_disk["cost_analysis_raw"]) == {"flops", "bytes accessed"}
    assert set(on_disk["collectives"]) >= {"total", "by_kind", "count",
                                           "unknown_trip_whiles"}
    jc = on_disk["jaxpr_cost"]
    assert jc["flops"] > 0 and jc["bytes"] > 0
    # the eager figure moves at least what the fused one does
    assert on_disk["cost_analysis_raw"]["bytes accessed"] >= jc["bytes"]
    assert roofline.analyze_cell(on_disk)["bottleneck"] in (
        "compute", "memory", "collective")


@pytest.mark.parametrize("arch,shape", [("deepseek-moe-16b", "decode_32k"),
                                        ("olmo-1b", "train_4k"),
                                        ("recurrentgemma-9b", "prefill_32k")])
def test_depth_extrapolation_equals_the_full_count(small, arch, shape):
    # four stacked units (recurrentgemma: three of its three-block pattern
    # and a tail of one)
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, num_layers={
        "deepseek-moe-16b": 5, "olmo-1b": 4, "recurrentgemma-9b": 10}[arch])
    assert dryrun.stack_plan(cfg).n_units > 2
    mesh = _meta22()
    got = dryrun.count_cell(arch, shape, mesh, cfg=cfg)
    want = dryrun._count_at(arch, shape, mesh, cfg,
                            got["memory_analysis"]["argument_size_in_bytes"])
    for k in ("jaxpr_cost", "cost_analysis_raw", "collectives",
              "worst_case_ops", "kernels"):
        assert got[k] == want[k], k
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert got["memory_analysis"][k] == pytest.approx(
            want["memory_analysis"][k]), k
    # the peak of the live bytes is a maximum over the run, not a sum over
    # units: its extrapolation is an estimate
    assert got["memory_analysis"]["temp_size_in_bytes"] == pytest.approx(
        want["memory_analysis"]["temp_size_in_bytes"], rel=0.05)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b",
                                  "xlstm-125m"])
def test_argument_bytes_are_the_blocks_shard_makes(arch):
    cfg = get_smoke_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"),
                     devices=[torch.device("cpu")] * 4)
    params = build_model(cfg, device="cpu").init(0)
    shards = partitioning.param_shardings(mesh, params)
    placed = partitioning.shard(params, shards, copy=True)
    per = np.zeros((2, 2), np.int64)
    for leaf in repro_torch._tree.leaves(placed):
        if isinstance(leaf, partitioning.Placed):
            for c in np.ndindex(2, 2):
                per[c] += leaf.blocks[c].numel() * leaf.blocks[c]\
                    .element_size()
        else:                                 # a 0-d leaf, held once
            per[0, 0] += leaf.numel() * leaf.element_size()
    meta = build_model(cfg, device="meta").init(_MetaKey())
    assert dryrun.position_bytes(meta, partitioning.param_shardings(
        _meta22(), meta), _meta22()) == per.max()


def test_counted_collective_bytes_are_what_the_spmd_calls_copy():
    """Each collective on a (2, 2) CPU layout, under a count: its wire
    bytes are the bytes that reach a position from other positions, by
    hand from the shapes (g = 2: half the tensor a position holds)."""
    mesh = make_mesh((2, 2), ("data", "model"),
                     devices=[torch.device("cpu")] * 4)
    lay = spmd.layout(mesh)
    f32 = 4
    act = [torch.randn(3, 8, requires_grad=True) for _ in range(2)]
    part = [torch.randn(3, 8, requires_grad=True) for _ in range(4)]
    leaf = partitioning.NamedSharding(mesh, partitioning.P("data", "model")
                                      ).shard(torch.randn(6, 8), copy=True)
    leaf = leaf.map(lambda b: b.requires_grad_(True))
    with costmodel.count() as rec:
        xs = spmd.replicate(lay, act)              # 2 groups x 2 shards
        sums = spmd.model_sum(lay, part)
        gathered = spmd.model_gather(lay, part, -1)
        scattered = spmd.model_sum_scatter(lay, part, -1)
        rows = spmd.gather_rows(lay, act)
        w = spmd.gather(lay, leaf, keep=())       # all of (6, 8) a user
        loss = sum(x.sum() for x in xs + sums + gathered + scattered
                   + rows + w)
        loss.backward()
    by = costmodel.collective_bytes(rec)["by_name"]
    full = 3 * 8 * f32
    # each position receives the other shard's copy / share: half of what
    # it holds after, forward and backward
    assert by["replicate"] == [2, 2 * 4 * full / 2]
    assert by["model_sum"] == [2, 2 * 4 * full / 2]
    assert by["model_gather"] == [2, 2 * 4 * (2 * full) / 2]
    assert by["model_sum_scatter"] == [2, 2 * 4 * full / 2]
    assert by["gather_rows"] == [2, 2 * 2 * (2 * full) / 2]
    # a (6, 8) weight split over data and model: a user holds all of it,
    # 3 of its 4 blocks from other positions
    assert by["gather"] == [2, 2 * 4 * 6 * 8 * f32 * 3 / 4]


def test_model_flops_are_the_reference_rule():
    todo = ref_cells() + [("sinkhorn-wmd", s) for s in
                          ("paper_5k", "prod_5m", "prod_5m_opt")]
    assert len(todo) == 43
    for arch, shape in todo:
        assert roofline.model_flops(arch, shape) == \
            ref_roofline.model_flops(arch, shape), (arch, shape)


def test_analyze_cell_by_hand():
    rec = {"status": "ok", "arch": "olmo-1b", "shape": "decode_32k",
           "mesh": "pod16x16",
           "jaxpr_cost": {"flops": 256 * 989.4e12 * 2e-3,
                          "bytes": 256 * 3.35e12 * 5e-3,
                          "unknown_loops": 0},
           "collectives": {"total": 256 * 450e9 * 1e-3},
           "memory_analysis": {"temp_size_in_bytes": 2 ** 31}}
    r = roofline.analyze_cell(rec)
    assert r["t_compute"] == pytest.approx(2e-3)
    assert r["t_memory"] == pytest.approx(5e-3)
    assert r["t_collective"] == pytest.approx(1e-3)
    assert r["bottleneck"] == "memory"
    mf = roofline.model_flops("olmo-1b", "decode_32k")
    assert r["roofline_frac"] == pytest.approx(mf / 256 / 989.4e12 / 5e-3)
    assert r["useful_flops_frac"] == pytest.approx(
        mf / rec["jaxpr_cost"]["flops"])
    assert r["temp_gib_per_chip"] == 2.0
    wmd = dict(rec, arch="sinkhorn-wmd", shape="paper_5k",
               jaxpr_cost={"flops": 256 * 67e12 * 1e-3, "bytes": 0})
    assert roofline.analyze_cell(wmd)["t_compute"] == pytest.approx(1e-3)
    assert roofline.analyze_cell(dict(rec, status="error")) is None
    assert math.isclose(roofline.chips("pod2x16x16"), 512)
