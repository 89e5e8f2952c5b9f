"""Declared costs of the hand-written kernels: (bytes, flops) of one launch.

The dispatcher never sees a ctypes launch, so each `kernels.ops` entry
declares what its kernel does (`repro_torch._count.declared`), and
chip_smoke.py's bounds use the same formulas. Bytes are the least the
function must move: each input read once, each output written once,
float32 and int32 words of 4 bytes; the K (or M) columns #1-#4 and #8
read are the distinct words their documents hold (``uniq``), the slots
they walk the nonzero ones (``live``).

`slots` reckons ``uniq`` and ``live`` from the ELL: exactly on tensors
that hold data (only while a count is active: it reads the values), and
on ``meta`` tensors as their upper bounds, min(V + 1, slots) distinct
words and every slot nonzero. Every function returns None at the sizes
where its wrapper launches nothing.
"""
from __future__ import annotations

import torch

F32 = 4


def slots(cols: torch.Tensor, vals: torch.Tensor, vp1: int
          ) -> tuple[int, int]:
    """(distinct words, nonzero slots) of an ELL (N, nnz)."""
    if cols.device.type == "meta":
        return min(vp1, cols.numel()), cols.numel()
    live = vals != 0
    return int(torch.unique(cols[live]).numel()), int(live.sum())


def vocab_major(q: int, v_r: int, vp1: int):
    """`k_vocab_major`: the (Q, v_r, V+1) stripes read, their copy
    written."""
    if not q * v_r * vp1:
        return None
    return F32 * 2 * q * v_r * vp1, 0


def type1(q: int, v_r: int, n: int, nnz: int, uniq: int, live: int):
    """#3 (and #1 at Q = 1): the K columns of the distinct words, r, u in
    and x out, the ELL; 4 v_r + 1 operations a live slot a query and the
    1 / r scale."""
    if not q * n:
        return None
    rows = q * v_r
    return (F32 * (rows * uniq + rows + 2 * rows * n + 2 * n * nnz),
            q * live * (4 * v_r + 1) + rows * n)


def type2(q: int, v_r: int, n: int, nnz: int, uniq: int, live: int):
    """#4 (and #2 at Q = 1): K's and K.*M's columns, u, the ELL and the
    (Q, N) distances; the u contraction on top of #3's slot work."""
    if not q * n:
        return None
    rows = q * v_r
    return (F32 * (2 * rows * uniq + rows * n + 2 * n * nnz + q * n),
            q * live * (4 * v_r + 1) + 2 * rows * n)


def cost_rows(m: int, v: int, w: int, outputs: int):
    """#5, #6 (``outputs`` 2: K and K.*M) and #7 (1: M): a (m, w) and
    b (V, w) read, the (m, V) outputs written; the dot products, the norms
    and 4 operations an output element."""
    if not m * v:
        return None
    return (F32 * (m * w + v * w + outputs * m * v),
            2 * m * v * w + 2 * (m + v) * w + 4 * outputs * m * v)


def rwmd(q: int, v_r: int, n: int, nnz: int, uniq: int, live: int):
    """#8: the M columns of the distinct words, the ELL and the bounds; a
    min over v_r and a multiply-add a live slot a query."""
    if not q * n:
        return None
    return (F32 * (q * v_r * uniq + 2 * n * nnz + q * n),
            q * live * (v_r + 1))


def lc_rwmd(q: int, n: int, nnz: int, uniq: int, live: int):
    """#9: the column mins of the distinct words, the ELL and the bounds;
    a multiply-add a live slot a query."""
    if not q * n:
        return None
    return F32 * (q * uniq + 2 * n * nnz + q * n), 2 * q * live
