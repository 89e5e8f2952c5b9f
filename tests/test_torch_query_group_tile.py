"""Card tests of #3's query-group tile: bit for bit the warp tile.

At v_r 32 and Q >= 3 `sddmm_spmm_type1_batch_vm` runs #3 on the
query-group tile (`kernels.sddmm_spmm.type1_tile`: four queries of one
document a warp, four rows a lane). Its every x element must carry the warp
tile's bits, which the test-only wrapper `sddmm_spmm_type1_batch_warp`
reaches at any shape, compared as int32 bits with NaN matching NaN, over:

* Q 3, 4, 5, 16, 17 and 64 (3, 5 and 17 leave idle groups in the last
  warp);
* ELL widths 8, 32, 144 and 150 (not a multiple of 32), with a document of
  no live slot, one of more than 32, and pad slots between live ones;
* 19 real query rows of 32 (pad rows: zero K, r 1) and a Q-filler query
  (all-zero K);
* u given, and the iterate x given (``from_x``) holding 0, values below
  TINY, a subnormal, -1, +inf, NaN and 1e38;
* docs_blk 8 and 7, neither of which divides N;

and each query's row equals #1 (`sddmm_spmm_type1_vm`) on that query.

Marked ``cuda``; every test decides inside its body whether a card is
present and skips when there is none. Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_query_group_tile.py
"""
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)

pytestmark = pytest.mark.cuda

V, N, V_R, REAL_ROWS = 3000, 203, 32, 19


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _problem(seed, q, nnz):
    """(k_vm, r, u, x, cols, vals) on the CPU: K spanning 1 .. 1e-36 so some
    slots' w fall below TINY, pad rows, a Q-filler (Q > 2), an ELL whose
    document 0 has no live slot and document 1 min(nnz, 40) live slots, and
    the other documents' live slots scattered among pad slots."""
    rng = np.random.default_rng(seed)
    k = rng.random((q, V_R, V + 1)).astype(np.float32)
    k[:, ::3] *= np.float32(1e-36)
    k[:, :, V] = 0.0
    k[:, REAL_ROWS:] = 0.0
    if q > 2:
        k[q - 1] = 0.0
    r = (rng.random((q, V_R)) + 0.1).astype(np.float32)
    r[:, REAL_ROWS:] = 1.0
    u = (rng.random((q, V_R, N)) * 2 + 0.1).astype(np.float32)
    x = (rng.random((q, V_R, N)) + 0.01).astype(np.float32)
    flat = x.reshape(-1)
    at = rng.choice(flat.size, 7 * 40, replace=False)
    flat[at] = np.tile(np.array([0.0, 1e-35, 1e-45, -1.0, np.inf, np.nan,
                                 1e38], np.float32), 40)
    cols = np.full((N, nnz), V, np.int32)
    vals = np.zeros((N, nnz), np.float32)
    for j in range(1, N):
        m = min(nnz, 40) if j == 1 else int(rng.integers(1, nnz + 1))
        at = np.sort(rng.choice(nnz, m, replace=False))   # pads between
        cols[j, at] = rng.choice(V, m, replace=False)
        vals[j, at] = rng.random(m).astype(np.float32) + 0.05
    k_vm = np.ascontiguousarray(k.transpose(0, 2, 1))
    return k_vm, r, u, x, cols, vals


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality as int32, NaN matching NaN."""
    if a.shape != b.shape:
        return False
    eq = a.view(torch.int32) == b.view(torch.int32)
    return bool((eq | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("nnz", [8, 32, 144, 150])
@pytest.mark.parametrize("q", [3, 4, 5, 16, 17, 64])
def test_query_group_tile_is_the_warp_tile_bitwise(q, nnz):
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    k_vm, r, u, x, cols, vals = (torch.from_numpy(a).to(dev)
                                 for a in _problem(q * 1000 + nnz, q, nnz))
    assert sk.type1_tile(q, V_R) == "group"
    n0 = sk.tile_launches["group"]
    for arg, from_x in ((u, False), (x, True)):
        for docs_blk in (8, 7):
            got = sk.sddmm_spmm_type1_batch_vm(k_vm, r, arg, cols, vals,
                                               docs_blk=docs_blk,
                                               from_x=from_x)
            want = sk.sddmm_spmm_type1_batch_warp(k_vm, r, arg, cols, vals,
                                                  docs_blk=docs_blk,
                                                  from_x=from_x)
            torch.cuda.synchronize()
            assert _same(got, want), (from_x, docs_blk)
            assert bool((got[:, :, 0] == 0).all())    # no live slot
            if not from_x:
                # pad rows and the filler are exact zeros (a NaN x would
                # reach them through the slot's w)
                assert bool((got[:, REAL_ROWS:] == 0).all())
                if q > 2:
                    assert bool((got[q - 1] == 0).all())
        if from_x:
            assert bool(torch.isnan(got).any())   # a NaN x reached a sum
    assert sk.tile_launches["group"] - n0 == 4
    # each query's row is #1 on that query
    for i in sorted({0, q // 2, q - 1}):
        one = sk.sddmm_spmm_type1_vm(k_vm[i], r[i], x[i], cols, vals,
                                     from_x=True)
        torch.cuda.synchronize()
        assert _same(got[i], one), i


@pytest.mark.parametrize("q,v_r", [(1, 32), (2, 32), (16, 64), (5, 128),
                                   (4, 11)])
def test_other_shapes_keep_the_warp_tile(q, v_r):
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    rng = np.random.default_rng(q + v_r)
    k_vm = torch.from_numpy(rng.random((q, V + 1, v_r)).astype(
        np.float32)).to(dev)
    k_vm[:, V] = 0.0
    r = torch.rand((q, v_r), device=dev) + 0.1
    u = torch.rand((q, v_r, N), device=dev) + 0.1
    cols = torch.randint(0, V, (N, 16), device=dev, dtype=torch.int32)
    vals = torch.rand((N, 16), device=dev)
    g0, w0 = sk.tile_launches["group"], sk.tile_launches["warp"]
    got = sk.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals)
    want = sk.sddmm_spmm_type1_batch_warp(k_vm, r, u, cols, vals)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sk.tile_launches["group"] == g0 and sk.tile_launches["warp"] == w0 + 2
