"""#3's doc tile on the CPU: the rule, the wrapper's launch and its
refusals.

`kernels.sddmm_spmm.type1_tile` chooses #3's doc tile from the shape alone:
the query-group tile (four queries of one document a warp) at v_r 32 and
Q >= 3, the warp tile (one (query, doc) pair a warp) everywhere else. The
CUDA kernels run only on a card (`tests/test_torch_query_group_tile.py`
holds the two tiles to each other bitwise there); here the wrapper runs up
to its launch, with ``_launch`` replaced by a recorder and the device check
lifted, so that:

* the C entry gets the rule's queries a warp (4 or 1), and each launch is
  counted in ``tile_launches`` under its tile (#1 and the test-only warp
  wrapper, which launches #3's entry at one query a warp, under "warp");
* every input the wrapper refused before is still refused before any
  launch, on both #3 entries, and the query-group tile refuses a k_vm
  that is not 16-byte aligned;
* on CPU tensors the CUDA entries refuse to run at all.
"""
import pytest
import torch

from repro_torch.kernels import sddmm_spmm as sk

V = 40


@pytest.mark.parametrize("q,v_r,want", [
    (3, 32, "group"), (4, 32, "group"), (5, 32, "group"), (16, 32, "group"),
    (17, 32, "group"), (64, 32, "group"),
    (1, 32, "warp"),                    # #1's shape, and a batch of one
    (2, 32, "warp"),                    # half a group warp would idle
    (16, 64, "warp"), (16, 128, "warp"), (64, 64, "warp"),
    (16, 6, "warp"), (4, 8, "warp"), (3, 11, "warp"), (16, 31, "warp"),
    (16, 33, "warp"), (1, 6, "warp"),
])
def test_type1_tile_is_a_function_of_the_shape(q, v_r, want):
    assert sk.type1_tile(q, v_r) == want
    assert sk.TILE_QUERIES[want] == (sk.GROUP_QUERIES if want == "group"
                                     else 1)


def _args(q=4, v_r=32, n=9, nnz=5):
    g = torch.Generator().manual_seed(0)
    k_vm = torch.rand((q, V + 1, v_r), generator=g)
    r = torch.rand((q, v_r), generator=g) + 0.1
    u = torch.rand((q, v_r, n), generator=g) + 0.1
    cols = torch.randint(0, V, (n, nnz), generator=g, dtype=torch.int32)
    vals = torch.rand((n, nnz), generator=g)
    return k_vm, r, u, cols, vals


@pytest.fixture
def recorded(monkeypatch):
    """The launches the #3 / #1 wrappers would make: (entry, sizes,
    from_x), with the device check lifted and ``tile_launches`` restored
    afterwards."""
    calls = []
    monkeypatch.setattr(sk, "_cuda_tensor", lambda name, t: None)
    monkeypatch.setattr(sk, "_launch", lambda name, tensors, *sizes,
                        from_x=None: calls.append((name, sizes, from_x)))
    monkeypatch.setattr(sk, "tile_launches", type(sk.tile_launches)())
    return calls


@pytest.mark.parametrize("q,v_r", [(2, 32), (3, 32), (5, 32), (16, 32),
                                   (1, 32), (16, 64), (3, 11)])
@pytest.mark.parametrize("from_x", [False, True])
def test_batch_wrapper_launches_the_rule_tile(recorded, q, v_r, from_x):
    k_vm, r, u, cols, vals = _args(q, v_r)
    x = sk.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals, docs_blk=7,
                                     from_x=from_x)
    tile = sk.type1_tile(q, v_r)
    assert x.shape == u.shape
    assert recorded == [("sddmm_spmm_type1_batch",
                         (q, v_r, V + 1, 9, 5, 7, sk.TILE_QUERIES[tile]),
                         from_x)]
    assert sk.tile_launches == {tile: 1}


def test_warp_entry_and_single_query_entry_count_as_warp(recorded):
    k_vm, r, u, cols, vals = _args(16, 32)
    sk.sddmm_spmm_type1_batch_warp(k_vm, r, u, cols, vals, from_x=True)
    sk.sddmm_spmm_type1_vm(k_vm[0], r[0], u[0], cols, vals)
    assert recorded == [
        ("sddmm_spmm_type1_batch", (16, 32, V + 1, 9, 5, 8, 1), True),
        ("sddmm_spmm_type1", (32, V + 1, 9, 5, sk.QUERY_DOCS_BLK), False)]
    assert sk.tile_launches == {"warp": 2}


def test_empty_batch_launches_nothing(recorded):
    k_vm, r, u, cols, vals = _args(16, 32)
    x = sk.sddmm_spmm_type1_batch_vm(k_vm, r, u[:, :, :0], cols[:0],
                                     vals[:0])
    assert x.shape == (16, 32, 0) and recorded == []
    assert not sk.tile_launches


def _bad(case):
    """(args, kwargs) of a call the #3 wrappers refuse."""
    k_vm, r, u, cols, vals = _args()
    kw = {}
    if case == "v_r_zero":
        k_vm, r, u = k_vm[:, :, :0], r[:, :0], u[:, :0]
    elif case == "v_r_above_128":
        k_vm, r, u = (torch.rand(4, V + 1, 129), torch.rand(4, 129),
                      torch.rand(4, 129, 9))
    elif case == "docs_blk_zero":
        kw["docs_blk"] = 0
    elif case == "cols_int64":
        cols = cols.long()
    elif case == "vals_float64":
        vals = vals.double()
    elif case == "u_not_contiguous":
        u = u.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "k_vs_u":
        k_vm = k_vm[:3]
    elif case == "k_not_vocab_major":
        k_vm = k_vm.transpose(1, 2).contiguous()
    elif case == "cols_rows":
        cols, vals = cols[:8], vals[:8]
    elif case == "r_shape":
        r = r[:, :16]
    elif case == "vals_shape":
        vals = vals[:, :4].contiguous()
    return (k_vm, r, u, cols, vals), kw


BAD = ["v_r_zero", "v_r_above_128", "docs_blk_zero", "cols_int64",
       "vals_float64", "u_not_contiguous", "k_vs_u", "k_not_vocab_major",
       "cols_rows", "r_shape", "vals_shape"]


@pytest.mark.parametrize("entry", ["sddmm_spmm_type1_batch_vm",
                                   "sddmm_spmm_type1_batch_warp"])
@pytest.mark.parametrize("case", BAD)
def test_batch_wrappers_refuse_what_they_refused(recorded, entry, case):
    args, kw = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        getattr(sk, entry)(*args, **kw)
    assert recorded == [] and not sk.tile_launches


def test_query_group_tile_refuses_an_unaligned_copy(recorded):
    k_vm, r, u, cols, vals = _args(16, 32)
    buf = torch.zeros(k_vm.numel() + 1)
    off = buf[1:].view(k_vm.shape)             # 4 bytes past the storage
    off.copy_(k_vm)
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        sk.sddmm_spmm_type1_batch_vm(off, r, u, cols, vals)
    assert recorded == []
    # the warp tile reads a float a lane and takes it
    sk.sddmm_spmm_type1_batch_warp(off, r, u, cols, vals)
    assert sk.tile_launches == {"warp": 1}


@pytest.mark.parametrize("entry", ["sddmm_spmm_type1_batch_vm",
                                   "sddmm_spmm_type1_batch_warp"])
def test_cuda_entries_refuse_cpu_tensors(entry):
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(sk, entry)(*_args(16, 32))
