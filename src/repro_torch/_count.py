"""The hooks through which the hand kernels and the collectives report
their cost to an active count.

The kernel entries (`kernels.ops`: ctypes launches the dispatcher never
sees) and the points where the positions of a mesh meet
(`distributed.spmd`, `core.distributed`) sit below the tool that counts a
run (`launch.costmodel`). They report here, to the innermost active
`Tally`, and know nothing of how a run is counted; the cost model builds
its recording on `Tally` and pushes it with `active`.

* `declared` decorates a kernel entry with its declared cost (the
  formulas of `kernels.costs`): under an active count each call adds it
  once, whichever route runs, and the ops inside the entry are not
  counted. With no count active the entry runs as it is, after one list
  test.
* `collective` reports one collective: its logical bytes a position, the
  size of its groups and the number of positions, with the reference's
  ring factors ((g - 1) / g; 2 (g - 1) / g for an all-reduce). The ops
  run inside it are the collective's own, not counted as compute.
"""
from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# the active tallies, innermost last: the hooks read the last
_ACTIVE: list = []
_NULL = contextlib.nullcontext()


def ring_factor(kind: str, group: int) -> float:
    """The reference's ring-transfer factor of a collective over ``group``
    positions: (g - 1) / g, 2 (g - 1) / g for an all-reduce, 1 for a
    permute, 0 for a group of one."""
    if group <= 1:
        return 0.0
    if kind == "collective-permute":
        return 1.0
    ring = (group - 1) / group
    return 2 * ring if kind == "all-reduce" else ring


class Tally:
    """What the hooks report to one count: ``flops``, ``bytes`` (fused)
    and ``eager_bytes`` (the declared kernels' here; a counting mode adds
    its ops'); ``kernels`` (entry -> calls) and ``kernel_sums`` (entry ->
    [bytes, flops] over its calls); ``collectives`` (name -> [calls, wire
    bytes]) and ``by_kind`` (kind -> [calls, wire bytes])."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.eager_bytes = 0.0
        self.kernels: collections.Counter = collections.Counter()
        self.kernel_sums: dict = {}
        self.collectives: dict = {}
        self.by_kind = {k: [0, 0.0] for k in KINDS}
        self._quiet = 0

    def add_kernel(self, name: str, nbytes: float, flops: float) -> None:
        self.kernels[name] += 1
        got = self.kernel_sums.setdefault(name, [0.0, 0.0])
        got[0] += nbytes
        got[1] += flops
        self.flops += flops
        self.bytes += nbytes
        self.eager_bytes += nbytes

    def add_collective(self, name: str, kind: str, nbytes: float,
                       group: int, positions: int) -> None:
        wire = positions * nbytes * ring_factor(kind, group)
        calls, total = self.collectives.get(name, (0, 0.0))
        self.collectives[name] = [calls + 1, total + wire]
        self.by_kind[kind][0] += 1
        self.by_kind[kind][1] += wire

    @contextlib.contextmanager
    def quiet(self):
        """Ops run inside are not counted (a declared kernel's, a
        collective's)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1


@contextlib.contextmanager
def active(tally: Tally):
    """Make ``tally`` the one the hooks report to while the block runs."""
    _ACTIVE.append(tally)
    try:
        yield tally
    finally:
        _ACTIVE.pop()


def declared(name: str, cost: Callable):
    """Decorate a kernel entry with its declared cost: under an active
    count each call adds ``cost(*args, **kwargs)`` -- (bytes, flops), or
    None where the entry launches nothing -- as one call of ``name``, and
    the ops inside it (its plain twin's, its wrapper's) are not counted.
    With no count active the entry runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            tally = _ACTIVE[-1]
            with tally.quiet():
                got = entry.declared_cost(*args, **kwargs)
                if got is not None:
                    tally.add_kernel(name, *got)
                return fn(*args, **kwargs)
        entry.declared_cost = cost
        return entry
    return wrap


def collective(name: str, kind: str, nbytes, group: int, positions: int):
    """Report one collective to the active count: ``positions`` positions
    in groups of ``group``, each holding ``nbytes`` (a number, or a tensor
    whose bytes they are) after it; the ops run inside the returned
    context are the collective's own, not counted as compute. A null
    context when no count is active, or inside a declared kernel or
    another collective (whose cost covers it)."""
    if not _ACTIVE:
        return _NULL
    tally = _ACTIVE[-1]
    if tally._quiet:
        return _NULL
    if isinstance(nbytes, torch.Tensor):
        nbytes = nbytes.numel() * nbytes.element_size()
    tally.add_collective(name, kind, nbytes, group, positions)
    return tally.quiet()
