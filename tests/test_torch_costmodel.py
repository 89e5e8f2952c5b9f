"""The port's cost model (`repro_torch.launch.costmodel`) on the CPU: every
case of the reference's `tests/test_costmodel.py`, counted on a recorded
run (the port's jaxpr), then the port's own checks -- a meta run counts
what a CPU run of the same program counts, each `kernels.ops` entry adds
its declared cost once and nothing inside it, and the matmul flops of a
smoke forward are the reference's ``dot_general`` flops.

A scan's transpose differentiates its carry on every trip, the first one's
too; the port's loops are Python, so the gradient cases ask autograd for
the carry's gradient as well (else it skips the first matmul's input
gradient that the reference's scan computes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.launch import costmodel as ref_costmodel
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.configs import sinkhorn_wmd
from repro_torch.distributed import spmd
from repro_torch.kernels import costs, ops
from repro_torch.launch import costmodel
from repro_torch.launch.costmodel import Cost, _shape_bytes, jaxpr_cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, lm
from repro_torch.train.step import _MetaKey

META = torch.device("meta")


def _count(fn, *args):
    return costmodel.record(fn, *args)[1]


# -- the reference's cases ----------------------------------------------------

def test_dot_flops_exact():
    a = torch.empty((32, 64), device=META)
    b = torch.empty((64, 16), device=META)
    assert jaxpr_cost(_count(lambda: a @ b)).flops == 2 * 32 * 64 * 16


def test_batched_dot_flops():
    a = torch.empty((4, 8, 16), device=META)
    b = torch.empty((4, 16, 8), device=META)
    rec = _count(lambda: torch.einsum("bij,bjk->bik", a, b))
    assert jaxpr_cost(rec).flops == 4 * 2 * 8 * 16 * 8


def test_loop_trip_count_multiplies():
    def f(x, ws):
        for w in ws:
            x = x @ w
        return x
    rec = _count(f, torch.empty((8, 16), device=META),
                 torch.empty((7, 16, 16), device=META))
    assert jaxpr_cost(rec).flops == 7 * 2 * 8 * 16 * 16


def _loss(w, x, body):
    y = x
    for wi in w.unbind(0):
        y = body(y, wi)
    return torch.sum(y * y)


def _grad(w, x, body):
    w, x = w.clone().requires_grad_(), x.clone().requires_grad_()
    return torch.autograd.grad(_loss(w, x, body), (w, x))


def test_grad_counts_backward():
    body = lambda c, wi: torch.tanh(c @ wi)  # noqa: E731
    w, x = torch.randn(4, 32, 32), torch.randn(8, 32)
    fwd = jaxpr_cost(_count(_loss, w, x, body)).flops
    grad = jaxpr_cost(_count(_grad, w, x, body)).flops
    assert 2.8 < grad / fwd < 3.3          # fwd + 2x in backward


def test_remat_counts_recompute():
    def body(c, wi):
        return lm.remat_call(True, lambda c, wi: torch.tanh(c @ wi), c, wi)
    w, x = torch.randn(4, 32, 32), torch.randn(8, 32)
    grad = jaxpr_cost(_count(_grad, w, x, body)).flops
    one = 2 * 8 * 32 * 32
    assert 3.8 * 4 * one < grad < 4.4 * 4 * one   # ~4x per layer w/ remat


def test_host_read_loop_flagged_unknown():
    def f(x):
        while torch.sum(x).item() < 100.0:
            x = x * 2.0
        return x
    assert jaxpr_cost(_count(f, torch.ones(8))).unknown_loops >= 1


# the reference's HLO dtype names
_HLO = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
        "f16": torch.float16, "s64": torch.int64, "s32": torch.int32,
        "s16": torch.int16, "s8": torch.int8, "u8": torch.uint8,
        "pred": torch.bool, "f8e4m3fn": torch.float8_e4m3fn,
        "f8e5m2": torch.float8_e5m2, "c64": torch.complex64,
        "c128": torch.complex128, "u16": torch.uint16, "u32": torch.uint32,
        "u64": torch.uint64}


def test_dtype_byte_table():
    assert _shape_bytes((8, 256), torch.float32) == 8 * 256 * 4
    assert _shape_bytes((2, 4), torch.bfloat16) == 2 * 4 * 2
    assert _shape_bytes((4,), torch.float32) + _shape_bytes(
        (2,), torch.int32) == 4 * 4 + 2 * 4
    assert _shape_bytes((), torch.bool) == 1
    for name, nbytes in ref_costmodel._DTYPE_BYTES.items():
        assert costmodel._DTYPE_BYTES[_HLO[name]] == nbytes, name
        assert torch.empty(0, dtype=_HLO[name]).element_size() == nbytes


def test_collective_count_end_to_end():
    """An all-gather of f32[8, 256] over the model axis of a (2, 4) CPU
    layout, 5 times: each position (g = 4) moves 8 * 256 * 4 * 3/4 bytes a
    time, the reference's per-device figure; the port's count is global,
    over the 8 positions."""
    mesh = make_mesh((2, 4), ("data", "model"),
                     devices=[torch.device("cpu")] * 8)
    lay = spmd.layout(mesh)
    shares = [torch.randn(8, 64) for _ in range(lay.size)]

    def step():
        for _ in range(5):
            spmd.model_gather(lay, shares, -1)
    cb = costmodel.collective_bytes(_count(step))
    analytic = 8 * 256 * 4 * 0.75 * 5
    assert cb["by_kind"]["all-gather"] == analytic * lay.size
    assert cb["by_kind"]["all-gather"] / lay.size == analytic
    assert cb["count"]["all-gather"] == 5
    assert cb["by_name"] == {"model_gather": [5, analytic * lay.size]}


def test_cost_add_mul():
    c = Cost(flops=2, bytes=4, collective_bytes=6) * 3
    assert (c.flops, c.bytes, c.collective_bytes) == (6, 12, 18)
    s = c + Cost(flops=1, bytes=1, collective_bytes=1, unknown_loops=2)
    assert (s.flops, s.unknown_loops) == (7, 2)


# -- the port's own checks ----------------------------------------------------

def _same(a, b):
    assert (a.flops, a.bytes, a.eager_bytes, a.unknown_loops) == \
        (b.flops, b.bytes, b.eager_bytes, b.unknown_loops)
    assert a.ops == b.ops and a.kernels == b.kernels


def test_meta_counts_the_cpu_count_of_the_wmd_program():
    from repro_torch.core.distributed import build_wmd_fn
    cfg = sinkhorn_wmd.smoke_config()
    fn = build_wmd_fn(lamb=cfg.lamb, max_iter=cfg.max_iter)
    rng = np.random.default_rng(0)
    n, nnz = cfg.num_docs, cfg.nnz_max

    def inputs(dev):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        return (t(rng.normal(size=(cfg.v_r, cfg.embed_dim))
                  .astype(np.float32)),
                t(np.ones(cfg.v_r, np.float32)),
                t(np.ones(cfg.v_r, np.float32)),
                t(rng.normal(size=(cfg.vocab_size, cfg.embed_dim))
                  .astype(np.float32)),
                t(rng.integers(0, cfg.vocab_size, (1, n, nnz))
                  .astype(np.int32)),
                t(rng.random((1, n, nnz)).astype(np.float32)))
    cpu = _count(fn, *inputs("cpu"))
    meta = _count(fn, *[x.to("meta") for x in inputs("cpu")])
    _same(cpu, meta)
    assert cpu.kernels == {"cdist_kexp": 1} and cpu.flops > 0


def test_meta_counts_the_cpu_count_of_a_decode_step():
    cfg = dataclasses.replace(get_smoke_config("gemma-2b"),
                              compute_dtype="float32")
    recs = []
    for dev in ("cpu", "meta"):
        model = build_model(cfg, q_block=8, kv_block=8, device=dev)
        params = model.init(0 if dev == "cpu" else _MetaKey())
        cache = model.init_cache(2, 16)
        cache["pos"] = 5
        tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        recs.append(_count(model.decode, params, cache, tok))
    _same(*recs)
    assert recs[0].matmul_flops > 0


def _wmd_problem(q=3, v_r=4, v=40, n=9, nnz=5, w=6):
    g = torch.Generator().manual_seed(0)
    k = torch.rand((q, v_r, v + 1), generator=g)
    k[..., -1] = 0
    cols = torch.randint(0, v + 1, (n, nnz), generator=g, dtype=torch.int32)
    vals = torch.rand((n, nnz), generator=g)
    vals[:, -1] = 0
    u = torch.rand((q, v_r, n), generator=g)
    r = torch.rand((q, v_r), generator=g) + 0.5
    a = torch.randn((v_r, w), generator=g)
    b = torch.randn((v, w), generator=g)
    return k, cols, vals, u, r, a, b


def _entry_calls():
    k, cols, vals, u, r, a, b = _wmd_problem()
    q, v_r, vp1 = k.shape
    n, nnz = cols.shape
    uniq, live = costs.slots(cols, vals, vp1)
    kvm = k.transpose(1, 2).contiguous()
    minm = torch.amin(k, dim=1)
    return {
        "sddmm_spmm_type1_batch": (
            lambda: ops.sddmm_spmm_type1_batch_vm(kvm, r, u, cols, vals),
            costs.type1(q, v_r, n, nnz, uniq, live)),
        "sddmm_spmm_type2_batch": (
            lambda: ops.sddmm_spmm_type2_batch_vm(kvm, kvm, u, cols, vals),
            costs.type2(q, v_r, n, nnz, uniq, live)),
        "sddmm_spmm_type1": (
            lambda: ops.sddmm_spmm_type1_vm(kvm[0], r[0], u[0], cols, vals),
            costs.type1(1, v_r, n, nnz, uniq, live)),
        "sddmm_spmm_type2": (
            lambda: ops.sddmm_spmm_type2_vm(kvm[0], kvm[0], u[0], cols,
                                            vals),
            costs.type2(1, v_r, n, nnz, uniq, live)),
        "k_vocab_major": (lambda: ops.k_vocab_major(k),
                          costs.vocab_major(q, v_r, vp1)),
        "cdist_kexp": (lambda: ops.cdist_kexp(a, b, lamb=1.0),
                       costs.cost_rows(v_r, b.shape[0], a.shape[1], 2)),
        "cdist_kexp_rows": (lambda: ops.cdist_kexp_rows(a, b, lamb=1.0),
                            costs.cost_rows(v_r, b.shape[0], a.shape[1], 2)),
        "cdist": (lambda: ops.cdist(a, b),
                  costs.cost_rows(v_r, b.shape[0], a.shape[1], 1)),
        "rwmd_bound_batch": (lambda: ops.rwmd_bound_batch(k, cols, vals),
                             costs.rwmd(q, v_r, n, nnz, uniq, live)),
        "lc_rwmd_bound_batch": (
            lambda: ops.lc_rwmd_bound_batch(minm, cols, vals),
            costs.lc_rwmd(q, n, nnz, uniq, live)),
    }


@pytest.mark.parametrize("entry", sorted(_entry_calls()))
def test_each_ops_entry_counts_its_declared_cost_once(entry):
    call, (nbytes, flops) = _entry_calls()[entry]
    rec = _count(call)
    assert rec.kernels == {entry: 1}
    assert not rec.ops                      # nothing inside it counted
    assert (rec.flops, rec.bytes) == (flops, nbytes)
    assert rec.kernel_cost[entry] == Cost(flops=flops, bytes=nbytes)


def test_a_composite_entry_counts_the_entries_it_calls():
    k, cols, vals, u, r, *_ = _wmd_problem()
    rec = _count(lambda: ops.sddmm_spmm_type2_batch(k, k, u, cols, vals))
    assert rec.kernels == {"k_vocab_major": 2, "sddmm_spmm_type2_batch": 1}
    assert not rec.ops


def test_no_count_no_cost(monkeypatch):
    """Without a count an entry never reckons its declared cost (the hook
    is one list test) and gives the same bits; under a count it does."""
    call = _entry_calls()["sddmm_spmm_type1_batch"][0]
    entry = ops.sddmm_spmm_type1_batch_vm
    real, seen = entry.declared_cost, []
    monkeypatch.setattr(entry, "declared_cost",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    out = call()
    assert not seen
    assert _count(call).kernels == {"sddmm_spmm_type1_batch": 1} and seen
    assert torch.equal(out, call())


def _ref_dot_flops(jaxpr) -> float:
    """The reference's ``dot_general`` flops of a jaxpr, scans multiplied
    (its `jaxpr_cost` walk, the dot terms alone)."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            total += ref_costmodel._dot_flops(eqn)
        elif prim == "scan":
            total += _ref_dot_flops(eqn.params["jaxpr"]) * \
                eqn.params["length"]
        elif prim in ("cond", "switch"):
            total += max(_ref_dot_flops(b) for b in eqn.params["branches"])
        else:
            for v in eqn.params.values():
                subs = v if isinstance(v, (list, tuple)) else [v]
                for b in subs:
                    if hasattr(b, "jaxpr") or hasattr(b, "eqns"):
                        total += _ref_dot_flops(b)
    return total


@pytest.mark.parametrize("arch,router", [("olmo-1b", None),
                                         ("deepseek-moe-16b", "topk")])
def test_matmul_flops_match_the_reference_dot_flops(arch, router):
    """A smoke forward's (the training loss's) matmul flops, the port's
    counted on meta and the reference's from its jaxpr, within 1%."""
    rcfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")
    if router:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, router=router))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, router=router))
    b, t = 2, 16
    ref = ref_build_model(rcfg, q_block=8, kv_block=8)
    pstruct = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    bstruct = {"tokens": jax.ShapeDtypeStruct((b, t), jnp.int32),
               "labels": jax.ShapeDtypeStruct((b, t), jnp.int32)}
    want = _ref_dot_flops(jax.make_jaxpr(ref.loss)(pstruct, bstruct))
    model = build_model(tcfg, q_block=8, kv_block=8, device="meta")
    params = model.init(_MetaKey())
    batch = {k: torch.empty((b, t), dtype=torch.int32, device=META)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        got = _count(model.loss, params, batch).matmul_flops
    assert abs(got - want) <= 0.01 * want, (got, want)
