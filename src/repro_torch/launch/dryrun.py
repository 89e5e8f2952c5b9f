"""Multi-pod dry run: count every (arch x shape x mesh) cell on ``meta``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Port of `repro.launch.dryrun`. The reference lowers and compiles each cell
on 256 (or 512) forced host devices and records XLA's memory and cost
analysis, its jaxpr cost and the HLO's collectives. The port has no
compiler: "lowering" a cell is one run of the port's own program on
``meta`` tensors (shapes, no storage, nothing on a card), under
`launch.costmodel.count`:

* the mesh is `make_production_mesh` over ``meta:i`` devices (card i of
  a 16 x 16 or 2 x 16 x 16 mesh; `launch.mesh`), the parameters come from
  the model's init on ``train.step._MetaKey`` (the port's
  ``jax.eval_shape``), the caches from ``init_cache`` on meta (full: the
  new token at the last position), the train state from `state_struct` /
  `state_shardings`, each placed on the mesh by the partitioning rules;
* the WMD cells place the meta blocks of `core.distributed.build_wmd_fn`
  (``paper_5k``, ``prod_5m``) and `build_wmd_fn_docsharded` (``*_opt``)
  directly, with the reference's doc padding and ``nnz_loc``;
* "loops multiply": the stacked units of a decoder are identical, so a
  decoder cell is counted at its prefix + 1 unit and at its prefix + 2
  units, and reported as c1 + (L_units - 1) (c2 - c1) (a full-depth run
  would take minutes a cell; a test holds the two equal at smoke depth).

Each cell writes ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``
with the reference's fields:

* ``compile_seconds``: the seconds of the meta runs;
* ``memory_analysis``, a position: ``argument_size_in_bytes`` the placed
  blocks' bytes (parameters, optimizer state and cache, at full depth from
  the placement, no run), ``temp_size_in_bytes`` the peak of the live
  meta bytes the run allocated and ``output_size_in_bytes`` those live at
  its end, each divided over the positions;
* ``jaxpr_cost``: `costmodel.jaxpr_cost` (flops, fusion-optimistic bytes,
  unknown loops), global;
* ``cost_analysis_raw``: the eager figure (every op's operands and
  outputs: what the unfused program moves), where the reference keeps
  XLA's own;
* ``collectives``: `costmodel.collective_bytes`, global;
* ``status`` ("ok", "skipped" or "error"), and ``worst_case_ops`` (the
  data-dependent ops answered with worst-case shapes on meta).
"""
import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs import (cell_supported, cells, get_config,
                                 get_shape)
from repro_torch.configs import sinkhorn_wmd as wmd_cfg
from repro_torch.data.tokens import batch_struct
from repro_torch.distributed import partitioning
from repro_torch.launch import costmodel
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.lm import stack_plan
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.train import step as train_step_mod

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# per-arch gradient-accumulation defaults of the reference's train cells
# (override with REPRO_MICROBATCHES)
_MICROBATCHES = {
    "mixtral-8x22b": 16, "deepseek-moe-16b": 16, "paligemma-3b": 8,
    "minicpm3-4b": 8, "whisper-small": 4, "recurrentgemma-9b": 4,
    "starcoder2-3b": 4, "gemma-2b": 2, "olmo-1b": 2, "xlstm-125m": 1,
}


def meta_mesh(*, multi_pod: bool = False):
    """The production mesh over ``meta:i`` devices."""
    n = 512 if multi_pod else 256
    return make_production_mesh(
        multi_pod=multi_pod,
        devices=[torch.device("meta", i) for i in range(n)])


def _place(tree, shardings):
    """The tensor leaves of ``tree`` placed by their shardings (blocks on
    the positions' devices); ints (a cache's positions) as they are."""
    return _tree.tree_map(
        lambda x, s: s.shard(x, copy=s.mesh.size > 1)
        if isinstance(x, torch.Tensor) else x, tree, shardings)


def _full_cache(cache, pos: int):
    """``cache`` with every position ``pos`` (a cache filled up to it)."""
    if isinstance(cache, dict):
        return {k: pos if k == "pos" else _full_cache(v, pos)
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [_full_cache(v, pos) for v in cache]
    if hasattr(cache, "_fields"):
        return cache._replace(**{f: pos if f == "pos" else
                                 _full_cache(getattr(cache, f), pos)
                                 for f in cache._fields})
    return cache


def position_bytes(tree, shardings, mesh) -> int:
    """The largest bytes any position holds of ``tree``'s tensor leaves
    placed by ``shardings`` (from the specs: nothing is placed)."""
    per = np.zeros(mesh.devices.shape, dtype=np.int64)

    def one(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        item = x.element_size()
        if mesh.size == 1 or x.ndim == 0:      # a 0-d leaf is held once
            per.flat[0] += x.numel() * item
            return x
        spec = partitioning.sanitize_spec(mesh, partitioning.P(*s.spec),
                                          x.shape)
        for c in np.ndindex(per.shape):
            sl = partitioning.block_slices(mesh, spec, x.shape, c)
            per[c] += math.prod(b.stop - b.start for b in sl) * item
        return x

    _tree.tree_map(one, tree, shardings)
    return int(per.max())


def _cut(cfg, units: int):
    """``cfg`` with its stacked units cut to ``units`` (prefix and tail
    kept)."""
    plan = stack_plan(cfg)
    return dataclasses.replace(cfg, num_layers=len(plan.prefix)
                               + units * len(plan.unit) + len(plan.tail))


def input_specs(arch: str, shape: str, mesh, *, cfg=None):
    """Meta stand-ins for every model input of this cell, placed on
    ``mesh`` (no storage anywhere). ``cfg`` overrides the arch's config
    (a depth cut)."""
    cfg = cfg or get_config(arch)
    sh = get_shape(shape)
    remat = os.environ.get("REPRO_REMAT", "1") == "1"
    model = build_model(cfg, remat=remat, device="meta")
    batch = batch_struct(cfg, sh)
    if sh.kind == "train":
        microbatches = int(os.environ.get(
            "REPRO_MICROBATCHES", str(_MICROBATCHES.get(arch, 1))))
        opt = adamw(warmup_cosine(1e-4, warmup_steps=100, total_steps=1000))
        state = train_step_mod.state_struct(model, opt)
        shards = train_step_mod.state_shardings(mesh, state)
        return {"kind": "train", "model": model, "opt": opt,
                "microbatches": microbatches, "args": (_place(state, shards), batch)}
    params = model.init(train_step_mod._MetaKey())
    pshard = partitioning.param_shardings(mesh, params)
    placed = _place(params, pshard)
    if sh.kind == "prefill":
        return {"kind": "prefill", "model": model, "max_len": sh.seq_len,
                "batch_size": sh.global_batch, "args": (placed, batch)}
    cache = _full_cache(model.init_cache(sh.global_batch, sh.seq_len),
                        sh.seq_len - 1)
    cshard = partitioning.cache_shardings(mesh, cache)
    tok = torch.empty((sh.global_batch, 1), dtype=torch.int32,
                      device="meta")
    return {"kind": "decode", "model": model, "max_len": sh.seq_len,
            "batch_size": sh.global_batch,
            "args": (placed, _place(cache, cshard), tok)}


def lower_cell(arch: str, shape: str, mesh, *, cfg=None):
    """The cell's step as a thunk over its placed meta inputs
    (`input_specs`)."""
    spec = input_specs(arch, shape, mesh, cfg=cfg)
    model = spec["model"]
    if spec["kind"] == "train":
        fn = train_step_mod.build_train_step(
            model, spec["opt"], mesh, donate=True,
            microbatches=spec["microbatches"])
    elif spec["kind"] == "prefill":
        prefill_for, _ = build_serve_fns(model, mesh,
                                         max_len=spec["max_len"])
        fn = prefill_for(spec["batch_size"])
    else:
        _, decode_for = build_serve_fns(model, mesh, max_len=spec["max_len"])
        fn = decode_for(spec["batch_size"], donate_cache=True)
    return lambda: fn(*spec["args"])


def _wmd_blocks(grid, shape, dtype):
    """A (D, S) object array of meta blocks, one on each position's
    device."""
    out = np.empty(grid.shape, object)
    for pos in np.ndindex(grid.shape):
        out[pos] = torch.empty(shape, dtype=dtype, device=grid[pos])
    return out


def lower_wmd(shape: str, mesh):
    """The paper's own workload as a dry-run cell: (a thunk of one query's
    program on its placed meta inputs, the bytes a position holds).

    ``*_opt`` shapes run the doc-sharded / K-replicated layout (no
    collective in the loop) over the length-bucketed ELL (nnz_max 48)."""
    from repro_torch.core.distributed import (build_wmd_fn,
                                              build_wmd_fn_docsharded)
    from repro_torch.launch.mesh import shard_grid
    f32, i32 = torch.float32, torch.int32
    first = mesh.device()
    if shape.endswith("_opt"):
        cfg = wmd_cfg.config(shape[:-4])
        doc_par = mesh.size
        num_docs = -(-cfg.num_docs // doc_par) * doc_par
        nnz = 48  # bucketed mean (bench_padding: 1.38 slots/nnz at mean 35)
        fn = build_wmd_fn_docsharded(mesh, lamb=cfg.lamb,
                                     max_iter=cfg.max_iter)
        args = (torch.empty((cfg.v_r, cfg.embed_dim), dtype=f32,
                            device=first),
                torch.empty((cfg.v_r,), dtype=f32, device=first),
                torch.empty((cfg.v_r,), dtype=f32, device=first),
                torch.empty((cfg.vocab_size, cfg.embed_dim), dtype=f32,
                            device=first),
                torch.empty((num_docs, nnz), dtype=i32, device=first),
                torch.empty((num_docs, nnz), dtype=f32, device=first))
        held = 4 * (cfg.vocab_size * cfg.embed_dim
                    + 2 * num_docs // doc_par * nnz
                    + cfg.v_r * (cfg.embed_dim + 2))
        return (lambda: fn(*args)), held
    cfg = wmd_cfg.config(shape)
    model_par = mesh.shape["model"]
    doc_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    doc_par = math.prod(mesh.shape[a] for a in doc_axes)
    # pad the doc axis to the doc-sharding factor (formats.pad_docs at load
    # time does the same for real data)
    num_docs = -(-cfg.num_docs // doc_par) * doc_par
    nnz_loc = max(cfg.nnz_max // model_par * 2, 16)  # rebucket headroom
    grid = shard_grid(mesh, doc_axes)
    n_loc = num_docs // doc_par
    fn = build_wmd_fn(mesh, lamb=cfg.lamb, max_iter=cfg.max_iter,
                      doc_axes=doc_axes)
    vecs = _wmd_blocks(grid, (cfg.vocab_size // model_par, cfg.embed_dim),
                       f32)
    cols = _wmd_blocks(grid, (n_loc, nnz_loc), i32)
    vals = _wmd_blocks(grid, (n_loc, nnz_loc), f32)
    args = (torch.empty((cfg.v_r, cfg.embed_dim), dtype=f32, device=first),
            torch.empty((cfg.v_r,), dtype=f32, device=first),
            torch.empty((cfg.v_r,), dtype=f32, device=first),
            vecs, cols, vals)
    held = 4 * (cfg.vocab_size // model_par * cfg.embed_dim
                + 2 * n_loc * nnz_loc + cfg.v_r * (cfg.embed_dim + 2))
    return (lambda: fn(*args)), held


def analyze(traced, *, hlo_collectives: bool = True, positions: int = 1,
            argument_bytes: int = 0) -> dict:
    """Count one run of ``traced`` (a thunk of the cell's step on its
    placed inputs, `costmodel.count`): the record's fields, memory a
    position of ``positions``."""
    with costmodel.count() as rec:
        out = traced()
    gc.collect()                    # cycles (autograd's) are not outputs
    live = rec.live_bytes           # the outputs', still alive here
    del out
    jc = costmodel.jaxpr_cost(rec)
    fields = {
        "compile_seconds": rec.seconds,
        "memory_analysis": {
            "argument_size_in_bytes": argument_bytes,
            "output_size_in_bytes": live / positions,
            "temp_size_in_bytes": rec.peak_bytes / positions,
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": None},
        "cost_analysis_raw": {"flops": rec.flops,
                              "bytes accessed": rec.eager_bytes},
        "jaxpr_cost": {"flops": jc.flops, "bytes": jc.bytes,
                       "unknown_loops": jc.unknown_loops},
        "worst_case_ops": rec.worst_case_ops,
        "kernels": dict(rec.kernels),
    }
    if hlo_collectives:
        fields["collectives"] = costmodel.collective_bytes(rec)
    return fields


def _extrapolate(c1, c2, units: int):
    """c1 + (units - 1) (c2 - c1), through nested dicts and lists of
    numbers (None and strings as in c1)."""
    if isinstance(c1, dict):
        return {k: _extrapolate(c1[k], c2.get(k), units) for k in c1}
    if isinstance(c1, list):
        return [_extrapolate(a, b, units) for a, b in zip(c1, c2)]
    if isinstance(c1, bool) or not isinstance(c1, (int, float)):
        return c1
    got = c1 + (units - 1) * (c2 - c1)
    return type(c1)(got) if isinstance(c1, int) else got


def _count_at(arch, shape, mesh, cfg, arg_bytes) -> dict:
    """One count of a cell at ``cfg``'s depth."""
    return analyze(lower_cell(arch, shape, mesh, cfg=cfg),
                   positions=mesh.size, argument_bytes=arg_bytes)


def count_cell(arch: str, shape: str, mesh, *, cfg=None) -> dict:
    """The record of a language-model cell: counted at 1 and 2 stacked
    units and extrapolated to the config's depth (counted once where it
    has fewer than 2 units); argument bytes from the full-depth
    placement."""
    cfg = cfg or get_config(arch)
    arg_bytes = position_bytes(*_structure(shape, mesh, cfg), mesh)
    units = stack_plan(cfg).n_units if cfg.family != "audio" else 0
    if units < 2:
        return _count_at(arch, shape, mesh, cfg, arg_bytes)
    rec = [_count_at(arch, shape, mesh, _cut(cfg, k), arg_bytes)
           for k in (1, 2)]
    out = _extrapolate(rec[0], rec[1], units)
    out["compile_seconds"] = rec[0]["compile_seconds"] + \
        rec[1]["compile_seconds"]
    out["memory_analysis"]["argument_size_in_bytes"] = arg_bytes
    out["extrapolated"] = {"units": units, "counted_at": [1, 2]}
    return out


def _structure(shape, mesh, cfg):
    """(the full-depth tree a position holds, its shardings): parameters
    and optimizer state, or parameters and cache, on meta."""
    sh = get_shape(shape)
    model = build_model(cfg, device="meta")
    if sh.kind == "train":
        opt = adamw(warmup_cosine(1e-4, warmup_steps=100, total_steps=1000))
        state = train_step_mod.state_struct(model, opt)
        return state, train_step_mod.state_shardings(mesh, state)
    params = model.init(train_step_mod._MetaKey())
    pshard = partitioning.param_shardings(mesh, params)
    if sh.kind == "prefill":
        return params, pshard
    cache = model.init_cache(sh.global_batch, sh.seq_len)
    return (params, cache), (pshard, partitioning.cache_shardings(mesh,
                                                                  cache))


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             out_dir: str = OUT_DIR) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    out_path = os.path.join(out_dir, mesh_name, f"{arch}__{shape}.json")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name}
    try:
        mesh = meta_mesh(multi_pod=multi_pod)
        if arch == "sinkhorn-wmd":
            thunk, held = lower_wmd(shape, mesh)
            rec.update(analyze(thunk, positions=mesh.size,
                               argument_bytes=held))
        else:
            ok, why = cell_supported(arch, shape)
            if not ok:
                rec.update({"status": "skipped", "reason": why})
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                return rec
            rec.update(count_cell(arch, shape, mesh))
        rec["status"] = "ok"
    except Exception as e:
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) incl. sinkhorn-wmd cells")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    todo = []
    if args.all:
        todo = cells() + [("sinkhorn-wmd", "paper_5k"),
                          ("sinkhorn-wmd", "prod_5m"),
                          ("sinkhorn-wmd", "prod_5m_opt")]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all required")

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    failed = 0
    for arch, shape in todo:
        out_path = os.path.join(args.out_dir, mesh_name,
                                f"{arch}__{shape}.json")
        if args.skip_existing and os.path.exists(out_path):
            with open(out_path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {arch} x {shape}: exists, skipping")
                    continue
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                       out_dir=args.out_dir)
        dt = time.perf_counter() - t0
        status = rec.get("status")
        extra = ""
        if status == "ok":
            ma = rec.get("memory_analysis") or {}
            extra = (f" temp={ma.get('temp_size_in_bytes', 0) / 2**30:.2f}GiB"
                     f" flops={rec.get('jaxpr_cost', {}).get('flops', 0):.3e}"
                     f" coll={rec.get('collectives', {}).get('total', 0):.3e}B")
        elif status == "error":
            failed += 1
            extra = " " + rec.get("error", "")[:160]
        print(f"[dryrun] {arch} x {shape} ({mesh_name}): {status}"
              f" ({dt:.1f}s){extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
