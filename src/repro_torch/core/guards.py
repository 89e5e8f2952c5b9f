"""Numeric guards for the Sinkhorn-WMD engine: typed errors instead of
silently-wrong distances.

A numpy copy of `repro.core.guards`; callers hand it host arrays.

The paper's O(V^2) entropic formulation has one classic numerical failure
mode: K = exp(-lambda * M) underflows. In fp32 with flush-to-zero the
smallest positive value is 2^-149, so a K entry is representable only while
``lambda * M[i, j] < 149 * ln 2 ~ 103.28``. With euclidean costs
``M[i, j] <= 2 * max_i ||vec_i||``, which gives the *a-priori* risk gate
`underflow_possible`. Past that point whole K rows (excluding the always-1
self column) flush to zero, the solver's safe-reciprocal clamps keep every
iterate finite, and the distances come out as EXACT ZEROS -- not NaN -- so a
finite-only check cannot catch it. Measured on the bench corpus: at
lambda = 30 11/18 real query rows have an identically-zero K*M stripe and
6/18 (query, doc) distances collapse to 0.0; at the shipped lambda = 1.0
none do and the gate is off.

Two layers of defense, both read-only (guards never perturb computed bits):

  pre-check   `check_km_rows` -- a real query row whose K*M stripe is
              identically zero has lost ALL cost signal; the solve is
              guaranteed garbage, so fail fast before paying for it.
  post-check  `check_distances` -- non-finite distances always raise;
              exact-zero (query, doc) cells raise only under the risk gate
              (a zero distance to a non-empty doc is otherwise legitimate
              for a doc identical to the query... except entropic WMD with
              lambda < inf never returns exactly 0.0 for a real transport
              problem -- but duplicate-free corpora are not a contract we
              own, so the gate keeps the check conservative), with
              empty/pad docs masked out (they legitimately solve to 0).

`validate_query` is the admission-boundary guard (`InvalidQueryError`):
malformed query histograms are rejected before they can poison a whole
coalesced batch.

All guards raise subclasses of `GuardError` so callers can catch the
family; `serving.resilience` maps them to non-retryable failures (retrying
a deterministic numerical error is wasted work).
"""
from __future__ import annotations

import math

import numpy as np

# fp32 smallest positive subnormal is 2^-149; exp(-x) flushes to +0.0 once
# x > 149 * ln 2. This is the hard floor -- with subnormals disabled (FTZ)
# the effective floor is the smallest *normal* (2^-126), so the gate below
# uses the conservative (larger-coverage) subnormal limit.
_FP32_EXP_UNDERFLOW = 149.0 * math.log(2.0)     # ~103.2789


class GuardError(RuntimeError):
    """Base class of every typed guard failure."""


class NumericalError(GuardError):
    """Sinkhorn output or precompute failed a numeric invariant.

    Carries structured ``context`` (which check fired, lambda, offending
    row/cell counts) for ops triage; deterministic for a given input, so
    NOT retryable."""

    def __init__(self, message: str, **context):
        super().__init__(message)
        self.context = context


class InvalidQueryError(GuardError):
    """A query histogram failed admission validation (wrong shape,
    non-finite, negative, or all-zero mass). Raised before dispatch; the
    serving layer quarantines and counts these, never batching them."""

    def __init__(self, message: str, **context):
        super().__init__(message)
        self.context = context


def validate_query(r, vocab_size: int | None = None) -> np.ndarray:
    """Admission-boundary validation of one query histogram.

    Returns ``r`` as an ndarray when valid; raises `InvalidQueryError` on
    non-array input, wrong rank/length (when ``vocab_size`` is given),
    non-finite entries, negative mass, or an all-zero row (no words ->
    no transport problem)."""
    try:
        arr = np.asarray(r)
    except Exception as e:                                  # ragged/object
        raise InvalidQueryError(f"query is not array-like: {e!r}") from e
    if arr.ndim != 1:
        raise InvalidQueryError(
            f"query must be 1-D, got shape {arr.shape}", shape=arr.shape)
    if not np.issubdtype(arr.dtype, np.number) or \
            np.issubdtype(arr.dtype, np.complexfloating):
        raise InvalidQueryError(
            f"query dtype must be real-numeric, got {arr.dtype}",
            dtype=str(arr.dtype))
    if vocab_size is not None and arr.shape[0] != vocab_size:
        raise InvalidQueryError(
            f"query length {arr.shape[0]} != vocab size {vocab_size}",
            length=int(arr.shape[0]), vocab_size=int(vocab_size))
    if not np.isfinite(arr).all():
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        raise InvalidQueryError(
            f"query has {bad} non-finite entries", nonfinite=bad)
    if np.any(arr < 0):
        raise InvalidQueryError(
            f"query has {int((arr < 0).sum())} negative entries",
            negative=int((arr < 0).sum()))
    if not np.any(arr > 0):
        raise InvalidQueryError("query has zero total mass (all-zero row)")
    return arr


def underflow_possible(lamb: float, max_vec_norm: float) -> bool:
    """A-priori risk gate: can K = exp(-lambda * M) underflow to zero for
    this (lambda, embedding) pair?  Euclidean costs are bounded by
    ``2 * max ||vec||``, so underflow is impossible while
    ``lambda * 2 * max_norm`` stays below the fp32 exp underflow limit.
    False at every shipped config (lambda = 1.0); the expensive zero-cell
    post-check only arms when this is True."""
    return float(lamb) * 2.0 * float(max_vec_norm) >= _FP32_EXP_UNDERFLOW


def check_finite(x, what: str = "array", **context) -> None:
    """Raise `NumericalError` if ``x`` has any NaN/Inf entry. Works on
    numpy arrays and CPU tensors."""
    arr = np.asarray(x)
    if np.isfinite(arr).all():
        return
    nonfinite = int(np.size(arr) - np.isfinite(arr).sum())
    raise NumericalError(
        f"{what} has {nonfinite}/{arr.size} non-finite entries",
        check="finite", what=what, nonfinite=nonfinite, **context)


def check_km_rows(km_stripes, row_mask, *, lamb: float | None = None) -> None:
    """Lambda-underflow pre-check on assembled K*M stripes.

    ``km_stripes``: (S, Q, v_r, Vloc+1) K*M rows from the cache assembly,
    an unsharded (Q, v_r, V) stripe, or an already-reduced (Q, v_r) row-max
    (so callers can do the big reduction on device and ship only Q x v_r
    scalars to host); ``row_mask``: (Q, v_r) with 0 marking pad/filler
    rows. A REAL row whose K*M stripe is identically zero across all
    shards has underflowed (K's self-column is exactly 1 but M's self-cost
    is 0, so K*M keeps no signal to hide behind) -- the solve would return
    silent zeros, so fail fast before paying for it."""
    km = np.asarray(km_stripes)
    mask = np.asarray(row_mask) > 0
    if not mask.any():
        return
    # max |K*M| per (Q, v_r) row, reduced over shard and vocab columns
    rowmax = np.abs(km)
    if rowmax.ndim >= 3:
        rowmax = rowmax.max(axis=-1)              # drop vocab columns
    if rowmax.ndim == 3:
        rowmax = rowmax.max(axis=0)               # drop the shard axis
    dead = mask & (rowmax == 0.0)
    if not dead.any():
        return
    n_dead = int(dead.sum())
    n_real = int(mask.sum())
    q_hit = np.nonzero(dead.any(axis=-1))[0].tolist()
    raise NumericalError(
        f"K*M rows underflowed to zero for {n_dead}/{n_real} real query "
        f"rows (queries {q_hit}): lambda"
        f"{f'={lamb:g} ' if lamb is not None else ' '}is too large for "
        f"fp32 -- exp(-lambda*M) flushed to zero and the Sinkhorn solve "
        f"would silently return zero distances",
        check="km_underflow", dead_rows=n_dead, real_rows=n_real,
        queries=q_hit, lamb=lamb)


def check_distances(d, *, lamb: float | None = None,
                    risk: bool = False,
                    empty_doc_mask: np.ndarray | None = None,
                    what: str = "distances") -> None:
    """Post-check on final (..., N) WMD distances.

    Non-finite entries always raise. Exact-zero (query, doc) cells raise
    only when ``risk`` is set (see `underflow_possible`) -- entropic
    distances of real transport problems are strictly positive, so under
    an armed gate a 0.0 cell is underflow, not similarity. ``empty_doc_mask``
    (N,) marks docs with zero total mass, which legitimately solve to 0 and
    are exempt."""
    arr = np.asarray(d)
    check_finite(arr, what, lamb=lamb)
    if not risk or arr.size == 0:
        return
    zero = arr == 0.0
    if empty_doc_mask is not None and zero.any():
        zero = zero & ~np.asarray(empty_doc_mask, bool)
    if not zero.any():
        return
    n_zero = int(zero.sum())
    raise NumericalError(
        f"{what}: {n_zero}/{arr.size} (query, doc) cells are exactly zero "
        f"under an armed underflow gate (lambda"
        f"{f'={lamb:g}' if lamb is not None else ''} too large for fp32): "
        f"K = exp(-lambda*M) flushed to zero and the solver's "
        f"safe-reciprocal clamps turned the result into silent zeros",
        check="zero_distance", zeros=n_zero, total=int(arr.size), lamb=lamb)
