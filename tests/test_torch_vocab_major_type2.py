"""The vocab-major plain routes of kernels #4 and #1 on the CPU.

#4 `sddmm_spmm_type2_batch` reads the vocab-major copies of K and K.*M
(`ops.sddmm_spmm_type2_batch_vm`), #1 `sddmm_spmm_type1` one query's
vocab-major copy of K (`ops.sddmm_spmm_type1_vm`). On the CPU their plain
versions gather ``k_vm[:, cols]``, the very tensor the reference layout's
gather builds, so each is bitwise the reference-layout plain route, and
#4's rows are the single-query #2 route's, query by query (the contract
the card keeps between the kernels: `query(r)` runs #1 + #2,
`query_batch` #3 + #4). The problems hold ELL pad slots (col V, val 0),
pad query rows (zero K, r = 1) and, for Q > 1, a Q-filler query (all-zero
K, the last); the per-query program on these copies is held to live JAX
in `tests/test_torch_single.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import sddmm_spmm as sk


def _problem(seed, q, v_r, v, n, nnz, pad_rows=2):
    rng = np.random.default_rng(seed)
    k = rng.random((q, v_r, v + 1)).astype(np.float32)
    k[:, :, v] = 0.0
    k[:, v_r - pad_rows:] = 0.0
    if q > 1:
        k[q - 1] = 0.0
    km = (k * rng.random(k.shape) * 3).astype(np.float32)
    r = rng.random((q, v_r)).astype(np.float32) + 0.1
    r[:, v_r - pad_rows:] = 1.0
    u = (rng.random((q, v_r, n)) * 2 + 0.1).astype(np.float32)
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n):
        m = int(rng.integers(1, nnz + 1))
        cols[j, :m] = rng.choice(v, m, replace=False)
        vals[j, :m] = rng.random(m).astype(np.float32) + 0.05
    return [torch.from_numpy(a) for a in (k, km, r, u, cols, vals)]


@pytest.mark.parametrize("v_r", [8, 32, 40, 96])
@pytest.mark.parametrize("q", [1, 3])
def test_type2_vocab_major_plain_route_is_reference_layout_route_bitwise(
        v_r, q):
    k, km, _, u, cols, vals = _problem(30 + v_r, q, v_r, 300, 41, 12)
    k_vm, km_vm = ops.k_vocab_major(k), ops.k_vocab_major(km)
    assert torch.equal(km_vm, km.transpose(1, 2))
    want = sk.sddmm_spmm_type2_batch_plain(k, km, u, cols, vals)
    got = ops.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals)
    assert got.shape == (q, 41) and torch.equal(got, want)
    assert torch.equal(ops.sddmm_spmm_type2_batch(k, km, u, cols, vals), want)
    # #4 == #2 query by query, and a filler query comes out exact zeros
    for i in range(q):
        assert torch.equal(got[i], ops.sddmm_spmm_type2(k[i], km[i], u[i],
                                                        cols, vals))
    if q > 1:
        assert torch.all(got[q - 1] == 0)


@pytest.mark.parametrize("v_r", [8, 32, 40, 96])
def test_type1_single_query_vocab_major_route_is_reference_route_bitwise(
        v_r):
    k, _, r, u, cols, vals = _problem(40 + v_r, 1, v_r, 300, 41, 12)
    k_vm = ops.k_vocab_major(k)
    want = sk.sddmm_spmm_type1_plain(k[0], r[0], u[0], cols, vals)
    got = ops.sddmm_spmm_type1_vm(k_vm[0], r[0], u[0], cols, vals)
    assert got.shape == (v_r, 41) and torch.equal(got, want)
    assert torch.equal(ops.sddmm_spmm_type1(k[0], r[0], u[0], cols, vals),
                       want)
    # #1 is #3 at Q = 1, and pad query rows come out exact zeros
    assert torch.equal(got, ops.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols,
                                                          vals)[0])
    assert torch.all(got[v_r - 2:] == 0)


def test_vocab_major_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA entry points on the copies launch or raise: a CPU tensor is
    refused, and no launch is counted."""
    from repro_torch.kernels import _build
    k, km, r, u, cols, vals = _problem(5, 2, 8, 64, 9, 8)
    k_vm, km_vm = sk.k_vocab_major_plain(k), sk.k_vocab_major_plain(km)
    _build.reset_launches()
    with pytest.raises(ValueError):
        sk.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals)
    with pytest.raises(ValueError):
        sk.sddmm_spmm_type1_vm(k_vm[0], r[0], u[0], cols, vals)
    assert sum(_build.launches.values()) == 0
