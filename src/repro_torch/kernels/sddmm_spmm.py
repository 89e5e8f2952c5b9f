"""Fused SDDMM-SpMM, single-query and batched: the CUDA kernels and their
plain versions.

Port of the Pallas kernels `repro.kernels.sddmm_spmm.sddmm_spmm_type1/2`
(one query) and `sddmm_spmm_type1/2_batch` (Q queries). For each query q,
doc j and ELL slot s:

    kcol = K[q, :, cols[j, s]]                 one gather per slot
    w    = <kcol, u[q, :, j]>                  SDDMM dot
    v    = vals[j, s] / max(w, TINY)           (0 where vals == 0)
    acc += kcol * v                            SpMM, same column (type1)
    acc += (K.*M)[q, :, cols[j, s]] * v        (type2)

type1 returns x[q, :, j] = acc / r[q, :]; type2 returns wmd[q, j] =
<u[q, :, j], acc>. The ``*_vm`` entry points and their plain versions take
``from_x``: their u argument is then the Sinkhorn iterate x, and u =
`safe_recip`(x) is formed from it inside (the kernels as they load it), with
the same bits as the element-wise pass; ``reads_x`` counts those calls by
entry name, on the card and off it. The functions without ``_plain``
launch the CUDA kernels in ``csrc/sddmm_spmm.cu`` (CUDA tensors only):

  * the ``*_vm`` entry points read K (and K.*M) vocab-major, (Q, V+1, v_r),
    the copies `k_vocab_major` makes once per stripe set (a column is then
    one 128-byte line): ``sddmm_spmm_type1_batch_vm`` (#3),
    ``sddmm_spmm_type2_batch_vm`` (#4), and ``sddmm_spmm_type1_vm`` (#1)
    and ``sddmm_spmm_type2_vm`` (#2) on one query's (V+1, v_r) copies, #3's
    and #4's kernels at Q = 1. The reference layout's entries of the same
    names without ``_vm`` are the copies and the kernel in one call. #4 is
    #2 query by query, and #1 is #3 at Q = 1, bit for bit. #3 runs on one
    of two doc tiles, chosen by `type1_tile` from the shape alone and
    counted in ``tile_launches``: four queries of one document a warp at
    v_r 32 and Q >= 3, one (query, doc) pair a warp otherwise; the two
    give the same bits, and ``sddmm_spmm_type1_batch_warp`` (test-only)
    launches #3's entry on the second at any shape;
  * ``sddmm_spmm_type2_naive`` is their oracle: one query's
    reference-layout stripes (v_r, V+1), one slot at a time, the same
    per-slot step (a kernel of its own, which no serving path calls).

The ``*_plain`` functions are the gather + matmul spellings of the same
math (the single-query ones the batched at Q = 1; the vocab-major ones
gather ``k_vm[:, cols]``, the very tensor `_gather` builds from the
reference layout), used for CPU tensors and as the kernels' comparison on
the card. `repro_torch.kernels.ops` chooses between them by device.

The entry points that carry the reference's names take its tiling
keywords too (``q_blk`` on the batched ones, ``interpret``) and check
``q_blk`` as the reference's padding does (None or a positive int). The
CUDA kernels do not follow it (a block walks documents of every query),
the CUDA kernels have no interpret mode, and the result depends on tiling
in neither package.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pad import check_tile

# Reciprocal guard: K = exp(-lamb*M) underflows f32 for far word pairs, and
# the u = 1/x nonlinearity amplifies it to inf*0 = nan. Clamping the
# denominator at TINY is exact for healthy values and replaces inf by a huge
# finite number otherwise.
TINY = 1e-30


def safe_recip(x: torch.Tensor) -> torch.Tensor:
    """u = 1 / max(x, TINY), a NaN kept (torch.clamp keeps it)."""
    return 1.0 / torch.clamp(x, min=TINY)


# type1 / type2 calls that read the iterate x (``from_x``), by entry name: a
# CUDA entry counts its launch, a plain version the call that forms u from x
reads_x: collections.Counter = collections.Counter()


def reads_x_total() -> int:
    """All the calls ``reads_x`` has counted."""
    return sum(reads_x.values())


# v_r rows a warp can hold (4 per lane); the kernels refuse larger buckets
MAX_V_R = 128

# #3's doc tiles (`type1_tile`), by the queries one warp works on: "warp",
# one (query, doc) pair a warp at any v_r; "group", GROUP_QUERIES queries of
# one document a warp at v_r 32, the same bits with fewer shuffles a slot
GROUP_QUERIES = 4
TILE_QUERIES = {"warp": 1, "group": GROUP_QUERIES}

# type1 launches (#3 and #1) by doc tile
tile_launches: collections.Counter = collections.Counter()


def type1_tile(q: int, v_r: int) -> str:
    """#3's doc tile for Q queries at v_r: "group" at v_r 32 and Q >= 3,
    "warp" otherwise (Q 1 and 2, v_r 64 and 128, the tests' small v_r).
    A function of the shape alone; both tiles give the same bits. At Q 2
    half a group warp idles: on an H100 it took 0.0332 ms of device time
    against the warp tile's 0.0311 at 5,000 docs (0.2288 against 0.2577
    at 65,536); at Q 3 0.0333 against 0.0403 (0.2384 against 0.3778)."""
    return "group" if v_r == 32 and q >= 3 else "warp"


# #1's and #2's doc tile: at Q = 1 (N = 5,000, v_r = 32, H100) docs_blk 4
# took 0.0199-0.0207 ms of device time a #1 launch against 0.0209-0.0213 at
# 8 and 0.024 at 16; #2 took 0.0247-0.0262 ms at 4, 0.0254-0.0257 at 8
# and 0.0282 at 16 (chip_smoke.py phase 5); bits do not depend on it
QUERY_DOCS_BLK = 4


def _gather(k_pad: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(Q, v_r, V+1), (N, nnz) -> (Q, N, nnz, v_r): one gather for all Q."""
    return k_pad.transpose(1, 2)[:, cols]


# The two contractions of the plain spellings, written as batched matmuls
# over the (q, n) cells: a cell's bits then do not depend on Q (einsum takes
# another path at Q = 1), which the pruned rerank's (1, chunk) == (Q, chunk)
# contract needs on every device, as the kernels give it.

def slot_dots(kg: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """w[q, n, k] = sum_i kg[q, n, k, i] * u[q, i, n] -> (Q, N, nnz)."""
    return torch.matmul(kg, u.transpose(1, 2)[..., None])[..., 0]


def slot_combine(kg: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x[q, i, n] = sum_k kg[q, n, k, i] * v[q, n, k] -> (Q, v_r, N)."""
    return torch.matmul(v[:, :, None, :], kg)[:, :, 0, :].transpose(1, 2)


def _sampled_v(kg: torch.Tensor, u: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    w = slot_dots(kg, u)
    return torch.where(vals[None] != 0.0,
                       vals[None] / torch.clamp(w, min=TINY), 0.0)


def _type1_from_gather(kg, r_sel, u, vals):
    v = _sampled_v(kg, u, vals)
    return slot_combine(kg, v) / r_sel[:, :, None]


def sddmm_spmm_type1_batch_plain(k_pad, r_sel, u, cols, vals):
    """Plain version of the type1 kernel: (Q, v_r, N) iterate."""
    return _type1_from_gather(_gather(k_pad, cols), r_sel, u, vals)


def k_vocab_major_plain(k_pad: torch.Tensor) -> torch.Tensor:
    """(Q, v_r, V+1) -> the vocab-major copy (Q, V+1, v_r)."""
    return k_pad.transpose(1, 2).contiguous()


def _u(name: str, u, from_x: bool):
    """u, or (``from_x``) `safe_recip` of the iterate x, counted under
    ``name`` in ``reads_x``."""
    if not from_x:
        return u
    reads_x[name] += 1
    return safe_recip(u)


def sddmm_spmm_type1_batch_vm_plain(k_vm, r_sel, u, cols, vals, *,
                                    from_x: bool = False):
    """Plain version of #3 on the vocab-major copy k_vm (Q, V+1, v_r):
    gathers ``k_vm[:, cols]``, bitwise the reference layout's `_gather`.
    ``from_x``: u is the iterate x."""
    return _type1_from_gather(k_vm[:, cols], r_sel,
                              _u("sddmm_spmm_type1_batch", u, from_x), vals)


def _type2_from_gather(kg, kmg, u, vals):
    # reduced in the kernel's order: K.*M accumulation first, then the u
    # contraction
    acc = slot_combine(kmg, _sampled_v(kg, u, vals))
    return torch.sum(u * acc, dim=1)


def sddmm_spmm_type2_batch_plain(k_pad, km_pad, u, cols, vals):
    """Plain version of the type2 kernel: (Q, N) distances."""
    return _type2_from_gather(_gather(k_pad, cols), _gather(km_pad, cols), u,
                              vals)


def sddmm_spmm_type2_batch_vm_plain(k_vm, km_vm, u, cols, vals, *,
                                    from_x: bool = False):
    """Plain version of #4 on the vocab-major copies k_vm, km_vm
    (Q, V+1, v_r): bitwise the reference layout's
    `sddmm_spmm_type2_batch_plain`. ``from_x``: u is the iterate x."""
    return _type2_from_gather(k_vm[:, cols], km_vm[:, cols],
                              _u("sddmm_spmm_type2_batch", u, from_x), vals)


def sddmm_spmm_type1_plain(k_pad, r_sel, u, cols, vals):
    """Plain version of the single-query type1 kernel: (v_r, N) iterate."""
    return sddmm_spmm_type1_batch_plain(k_pad[None], r_sel[None], u[None],
                                        cols, vals)[0]


def sddmm_spmm_type1_vm_plain(k_vm, r_sel, u, cols, vals, *,
                              from_x: bool = False):
    """Plain version of #1 on one query's vocab-major copy k_vm (V+1, v_r):
    `sddmm_spmm_type1_batch_vm_plain` at Q = 1."""
    u = _u("sddmm_spmm_type1", u, from_x)
    return sddmm_spmm_type1_batch_vm_plain(k_vm[None], r_sel[None], u[None],
                                           cols, vals)[0]


def sddmm_spmm_type2_plain(k_pad, km_pad, u, cols, vals):
    """Plain version of the single-query type2 kernel: (N,) distances."""
    return sddmm_spmm_type2_batch_plain(k_pad[None], km_pad[None], u[None],
                                        cols, vals)[0]


def sddmm_spmm_type2_vm_plain(k_vm, km_vm, u, cols, vals, *,
                              from_x: bool = False):
    """Plain version of #2 on one query's vocab-major copies k_vm, km_vm
    (V+1, v_r): `sddmm_spmm_type2_batch_vm_plain` at Q = 1."""
    u = _u("sddmm_spmm_type2", u, from_x)
    return sddmm_spmm_type2_batch_vm_plain(k_vm[None], km_vm[None], u[None],
                                           cols, vals)[0]


def _cuda_tensor(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}")


def _check(name: str, tensors: dict, k_pad: torch.Tensor, u: torch.Tensor,
           cols: torch.Tensor, docs_blk: int, vocab_major: bool = False
           ) -> None:
    _cuda_tensor(name, k_pad)
    dev = k_pad.device
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, k_pad on {dev}")
        want = torch.int32 if arg == "cols" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    q, v_r, n = u.shape
    k_qr = (k_pad.shape[0], k_pad.shape[2]) if vocab_major else k_pad.shape[:2]
    if k_pad.dim() != 3 or k_qr != (q, v_r):
        raise ValueError(f"{name}: k {tuple(k_pad.shape)} does not match "
                         f"u {tuple(u.shape)}")
    if cols.dim() != 2 or cols.shape[0] != n:
        raise ValueError(f"{name}: cols {tuple(cols.shape)} does not match "
                         f"N = {n}")
    if not 0 < v_r <= MAX_V_R:
        raise ValueError(f"{name}: v_r = {v_r} outside (0, {MAX_V_R}]")
    if docs_blk <= 0:
        raise ValueError(f"{name}: docs_blk must be positive, got {docs_blk}")


def _launch(name: str, tensors, *sizes, from_x: bool | None = None) -> None:
    """Launch ``name`` on 6 tensors (their pointers) and the int sizes:
    (q,) v_r, vp1, n, nnz, docs_blk (the single-query entry points take no
    q), then ``from_x`` as an int where the entry takes it (the four
    serving entries; not the oracle), a set one counted in ``reads_x``."""
    if from_x is not None:
        sizes = (*sizes, int(from_x))
    fn = _build.function("sddmm_spmm", name,
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * len(sizes)
                         + [ctypes.c_void_p])
    stream = _build.stream(name, *tensors)
    _build.check_launch(name, fn(*(t.data_ptr() for t in tensors), *sizes,
                                 stream))
    if from_x:
        reads_x[name] += 1


def k_vocab_major(k_pad: torch.Tensor) -> torch.Tensor:
    """CUDA copy of K (or K.*M) stripes (Q, v_r, V+1) f32 into the
    vocab-major layout (Q, V+1, v_r) that #1, #3 and #4 read: a tiled
    transpose, one launch."""
    name = "k_vocab_major"
    _cuda_tensor(name, k_pad)
    if k_pad.dtype != torch.float32 or k_pad.dim() != 3:
        raise TypeError(f"{name}: k_pad must be (Q, v_r, V+1) float32, got "
                        f"{tuple(k_pad.shape)} {k_pad.dtype}")
    if not k_pad.is_contiguous():
        raise ValueError(f"{name}: k_pad must be contiguous")
    q, v_r, vp1 = k_pad.shape
    k_vm = torch.empty((q, vp1, v_r), dtype=torch.float32,
                       device=k_pad.device)
    if k_pad.numel():
        fn = _build.function("sddmm_spmm", name,
                             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
        _build.check_launch(name, fn(
            k_pad.data_ptr(), k_vm.data_ptr(), q, v_r, vp1,
            _build.stream(name, k_pad, k_vm)))
    return k_vm


def _type1_batch_shape(name, k_vm, r_sel, u, cols, vals, docs_blk):
    """#3's checks (`_check`, r_sel and vals against the shape): (Q, v_r,
    N)."""
    _check(name, {"k_vm": k_vm, "r_sel": r_sel, "u": u, "cols": cols,
                  "vals": vals}, k_vm, u, cols, docs_blk, vocab_major=True)
    q, v_r, n = u.shape
    if r_sel.shape != (q, v_r) or vals.shape != cols.shape:
        raise ValueError(f"{name}: r_sel {tuple(r_sel.shape)} / vals "
                         f"{tuple(vals.shape)} shape mismatch")
    return q, v_r, n


def sddmm_spmm_type1_batch_vm(k_vm, r_sel, u, cols, vals, *,
                              docs_blk: int = 8,
                              from_x: bool = False) -> torch.Tensor:
    """CUDA type1 kernel (#3) on the vocab-major copy k_vm (Q, V+1, v_r)
    with the zero pad row V, r_sel (Q, v_r), u (Q, v_r, N), cols int32 /
    vals f32 (N, nnz) with every col in [0, V]. Returns x (Q, v_r, N).
    ``docs_blk`` documents per block; ``from_x``: u is the iterate x. The
    doc tile is `type1_tile`'s, counted in ``tile_launches``."""
    name = "sddmm_spmm_type1_batch"
    q, v_r, n = _type1_batch_shape(name, k_vm, r_sel, u, cols, vals,
                                   docs_blk)
    tile = type1_tile(q, v_r)
    if tile == "group" and k_vm.data_ptr() % 16:
        raise ValueError(f"{name}: the query-group tile loads k_vm 16 bytes "
                         f"at a time; k_vm at {k_vm.data_ptr():#x} is not "
                         f"16-byte aligned")
    x = torch.empty_like(u)
    if q and n:
        _launch(name, (k_vm, r_sel, u, cols, vals, x),
                q, v_r, k_vm.shape[1], n, cols.shape[1], docs_blk,
                TILE_QUERIES[tile], from_x=from_x)
        tile_launches[tile] += 1
    return x


def sddmm_spmm_type1_batch_warp(k_vm, r_sel, u, cols, vals, *,
                                docs_blk: int = 8,
                                from_x: bool = False) -> torch.Tensor:
    """#3 on the warp tile at any shape (CUDA; the arguments of
    `sddmm_spmm_type1_batch_vm`), through #3's own entry: the tests and
    chip_smoke.py hold the query-group tile to it bitwise. No serving path
    calls it."""
    name = "sddmm_spmm_type1_batch"
    q, v_r, n = _type1_batch_shape("sddmm_spmm_type1_batch_warp", k_vm,
                                   r_sel, u, cols, vals, docs_blk)
    x = torch.empty_like(u)
    if q and n:
        _launch(name, (k_vm, r_sel, u, cols, vals, x),
                q, v_r, k_vm.shape[1], n, cols.shape[1], docs_blk,
                TILE_QUERIES["warp"], from_x=from_x)
        tile_launches["warp"] += 1
    return x


def sddmm_spmm_type1_batch(k_pad, r_sel, u, cols, vals, *,
                           docs_blk: int = 8, q_blk: int | None = None,
                           interpret: bool = False) -> torch.Tensor:
    """#3 on K in the reference layout k_pad (Q, v_r, V+1), zero pad
    column: the vocab-major copy, then `sddmm_spmm_type1_batch_vm`."""
    check_tile("sddmm_spmm_type1_batch", "q_blk", q_blk, optional=True)
    return sddmm_spmm_type1_batch_vm(k_vocab_major(k_pad), r_sel, u, cols,
                                     vals, docs_blk=docs_blk)


def sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals, *,
                              docs_blk: int = 8,
                              from_x: bool = False) -> torch.Tensor:
    """CUDA type2 kernel (#4) on the vocab-major copies k_vm, km_vm
    (Q, V+1, v_r) of K and K.*M with the zero pad row V, u (Q, v_r, N),
    cols int32 / vals f32 (N, nnz) with every col in [0, V]: the fused final
    distance, wmd (Q, N). ``docs_blk`` documents per block; ``from_x``: u
    is the iterate x."""
    name = "sddmm_spmm_type2_batch"
    _check(name, {"k_vm": k_vm, "km_vm": km_vm, "u": u, "cols": cols,
                  "vals": vals}, k_vm, u, cols, docs_blk, vocab_major=True)
    q, v_r, n = u.shape
    if km_vm.shape != k_vm.shape or vals.shape != cols.shape:
        raise ValueError(f"{name}: km_vm {tuple(km_vm.shape)} / vals "
                         f"{tuple(vals.shape)} shape mismatch")
    wmd = torch.empty((q, n), dtype=torch.float32, device=u.device)
    if q and n:
        _launch(name, (k_vm, km_vm, u, cols, vals, wmd),
                q, v_r, k_vm.shape[1], n, cols.shape[1], docs_blk,
                from_x=from_x)
    return wmd


def sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals, *,
                           docs_blk: int = 8, q_blk: int | None = None,
                           interpret: bool = False) -> torch.Tensor:
    """#4 on K and K.*M in the reference layout (Q, v_r, V+1), zero pad
    column: the two vocab-major copies, then `sddmm_spmm_type2_batch_vm`."""
    check_tile("sddmm_spmm_type2_batch", "q_blk", q_blk, optional=True)
    return sddmm_spmm_type2_batch_vm(k_vocab_major(k_pad),
                                     k_vocab_major(km_pad), u, cols, vals,
                                     docs_blk=docs_blk)


def _one_query(name: str, u: torch.Tensor) -> None:
    if u.dim() != 2:
        raise ValueError(f"{name}: u must be one query's (v_r, N), got "
                         f"{tuple(u.shape)}")


def sddmm_spmm_type1_vm(k_vm, r_sel, u, cols, vals, *,
                        docs_blk: int = QUERY_DOCS_BLK,
                        from_x: bool = False) -> torch.Tensor:
    """CUDA single-query type1 kernel (#1) on one query's vocab-major copy
    k_vm (V+1, v_r), r_sel (v_r,), u (v_r, N), cols int32 / vals f32
    (N, nnz) -> x (v_r, N): #3's kernel at Q = 1, counted as #1.
    ``from_x``: u is the iterate x."""
    name = "sddmm_spmm_type1"
    _one_query(name, u)
    _check(name, {"k_vm": k_vm, "r_sel": r_sel, "u": u, "cols": cols,
                  "vals": vals}, k_vm[None], u[None], cols, docs_blk,
           vocab_major=True)
    v_r, n = u.shape
    if r_sel.shape != (v_r,) or vals.shape != cols.shape:
        raise ValueError(f"{name}: r_sel {tuple(r_sel.shape)} / vals "
                         f"{tuple(vals.shape)} shape mismatch")
    x = torch.empty_like(u)
    if n:
        _launch(name, (k_vm, r_sel, u, cols, vals, x),
                v_r, k_vm.shape[0], n, cols.shape[1], docs_blk, from_x=from_x)
        tile_launches["warp"] += 1
    return x


def sddmm_spmm_type1(k_pad, r_sel, u, cols, vals, *,
                     docs_blk: int = QUERY_DOCS_BLK,
                     interpret: bool = False) -> torch.Tensor:
    """#1 on one query's reference-layout stripe k_pad (v_r, V+1): its
    vocab-major copy, then `sddmm_spmm_type1_vm`."""
    return sddmm_spmm_type1_vm(k_vocab_major(k_pad[None])[0], r_sel, u,
                               cols, vals, docs_blk=docs_blk)


def sddmm_spmm_type2_vm(k_vm, km_vm, u, cols, vals, *,
                        docs_blk: int = QUERY_DOCS_BLK,
                        from_x: bool = False) -> torch.Tensor:
    """CUDA single-query type2 kernel (#2) on one query's vocab-major
    copies k_vm, km_vm (V+1, v_r) of K and K.*M, u (v_r, N), cols int32 /
    vals f32 (N, nnz) -> wmd (N,): #4's kernel at Q = 1, counted as #2.
    ``from_x``: u is the iterate x."""
    name = "sddmm_spmm_type2"
    _one_query(name, u)
    _check(name, {"k_vm": k_vm, "km_vm": km_vm, "u": u, "cols": cols,
                  "vals": vals}, k_vm[None], u[None], cols, docs_blk,
           vocab_major=True)
    v_r, n = u.shape
    if km_vm.shape != k_vm.shape or vals.shape != cols.shape:
        raise ValueError(f"{name}: km_vm {tuple(km_vm.shape)} / vals "
                         f"{tuple(vals.shape)} shape mismatch")
    wmd = torch.empty((n,), dtype=torch.float32, device=u.device)
    if n:
        _launch(name, (k_vm, km_vm, u, cols, vals, wmd),
                v_r, k_vm.shape[0], n, cols.shape[1], docs_blk, from_x=from_x)
    return wmd


def sddmm_spmm_type2(k_pad, km_pad, u, cols, vals, *,
                     docs_blk: int = QUERY_DOCS_BLK,
                     interpret: bool = False) -> torch.Tensor:
    """#2 on one query's reference-layout stripes k_pad, km_pad (v_r, V+1):
    their vocab-major copies, then `sddmm_spmm_type2_vm`."""
    return sddmm_spmm_type2_vm(k_vocab_major(k_pad[None])[0],
                               k_vocab_major(km_pad[None])[0], u, cols, vals,
                               docs_blk=docs_blk)


def sddmm_spmm_type2_naive(k_pad, km_pad, u, cols, vals, *,
                           docs_blk: int = 8) -> torch.Tensor:
    """The oracle of #2 and #4 (CUDA): one query's reference-layout stripes
    k_pad, km_pad (v_r, V+1), one slot at a time, the kernels' per-slot
    step and slot order -> (N,) distances, bitwise theirs. No serving path
    calls it."""
    name = "sddmm_spmm_type2_naive"
    _one_query(name, u)
    _check(name, {"k_pad": k_pad, "km_pad": km_pad, "u": u, "cols": cols,
                  "vals": vals}, k_pad[None], u[None], cols, docs_blk)
    v_r, n = u.shape
    if km_pad.shape != k_pad.shape or vals.shape != cols.shape:
        raise ValueError(f"{name}: km_pad {tuple(km_pad.shape)} / vals "
                         f"{tuple(vals.shape)} shape mismatch")
    wmd = torch.empty((n,), dtype=torch.float32, device=u.device)
    if n:
        _launch(name, (k_pad, km_pad, u, cols, vals, wmd),
                v_r, k_pad.shape[1], n, cols.shape[1], docs_blk)
    return wmd
