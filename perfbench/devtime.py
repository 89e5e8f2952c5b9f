"""Device time on the run's cards: CUDA events behind a spin kernel, and
the reading of a torch.profiler stretch (busy time, the largest device
operations, idle gaps by what the host was doing).

Every reading is taken per card and then combined, so that a cell laid out
on several cards reads what a one-card cell reads: a batch's device time
is its slowest card's, busy time is the mean over the cards (a card with no
event counts as idle the whole stretch), idle gaps are summed over the
cards by label, and device operations are summed over them. On one card
each is the one-card formula on the same events.
"""
from __future__ import annotations

import collections
import pathlib
import re
import time

import torch

# the device spins this many cycles (about 50 ms on an H100) before
# `device_ms`'s calls, so the host queues them all before the first runs
SPIN_CYCLES = 100_000_000


def cards_of(devices) -> list[torch.device]:
    """The distinct devices of ``devices``, in order of first appearance,
    each with its index (``cuda`` is the current card): logical shards of
    one card are one card."""
    out: list[torch.device] = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in out:
            out.append(d)
    return out


def device_ms(fn, reps: int = 3, cards=None) -> float:
    """Device milliseconds a call: on each of ``cards`` (None: the current
    card), CUDA events on its current stream around ``reps`` calls that
    the host queues behind a spin kernel (`torch.cuda._sleep`), so each
    card runs them back to back and the events hold the device's time,
    not the host's. Returns the largest card's time: a call ends when its
    slowest card ends. Profiler sums are not used: traces on the card drop
    a varying share of their device events. Raises if, on any card, the
    host took longer to queue the calls than that card spun (the events
    would then hold host time)."""
    cards = cards_of(["cuda"] if cards is None else cards)
    fn()
    for c in cards:
        torch.cuda.synchronize(c)
    marks = []
    for c in cards:
        with torch.cuda.device(c):
            spin, start, stop = (torch.cuda.Event(enable_timing=True)
                                 for _ in range(3))
            spin.record()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
        marks.append((c, spin, start, stop, time.perf_counter()))
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    for c, _, _, stop, _ in marks:
        with torch.cuda.device(c):
            stop.record()
    for c in cards:
        torch.cuda.synchronize(c)
    out = []
    for c, spin, start, stop, t0 in marks:
        host_ms = (t1 - t0) * 1e3
        spin_ms = spin.elapsed_time(start)
        if host_ms >= spin_ms:
            raise RuntimeError(f"device_ms: the host took {host_ms:.2f} ms "
                               f"to queue {reps} calls, {c} spun "
                               f"{spin_ms:.2f} ms")
        out.append(start.elapsed_time(stop) / reps)
    return max(out)


def kernel_names(csrc: pathlib.Path) -> list[str]:
    """The ``__global__`` function names of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+(?:void\s+)?"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")
    names: set[str] = set()
    for path in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(path.read_text()))
    return sorted(names)


class Stretch:
    """A torch.profiler trace of a stretch of the window on ``cards`` (None:
    the current card), read on the host's monotonic clock so the harness's
    own spans label its gaps."""

    def __init__(self, cards=None):
        from torch.profiler import ProfilerActivity, profile
        self.cards = cards_of(["cuda"] if cards is None else cards)
        self.card_ids = [c.index for c in self.cards]
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self._mark = None

    def sync(self) -> None:
        for c in self.cards:
            torch.cuda.synchronize(c)

    def warm(self) -> float:
        """Trace one tiny call on each card, so the profiler's first-use
        cost (its CUPTI set-up, seconds on the card) falls before the
        window; returns its seconds."""
        from torch.profiler import ProfilerActivity, profile
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for c in self.cards:
                torch.ones(1, device=c).add_(1)
            self.sync()
        return time.monotonic() - t0

    def start(self) -> None:
        from torch.profiler import record_function
        t = time.monotonic()
        self._prof.start()
        self.start_s = time.monotonic() - t
        self._mark = time.monotonic_ns()
        with record_function("perfbench.clock_mark"):
            pass
        self.t0 = time.monotonic()

    def stop(self) -> None:
        self.sync()
        self.t1 = time.monotonic()
        self._prof.stop()

    def device_events(self) -> list[tuple[str, float, float, int]]:
        """(name, start, end, card index) of every device operation in the
        stretch, on the monotonic clock, sorted by start."""
        from torch.autograd import DeviceType
        evs = self._prof.profiler.kineto_results.events()
        mark = next(e for e in evs if e.name() == "perfbench.clock_mark")
        off = mark.start_ns() - self._mark
        out = []
        for e in evs:
            if e.device_type() != DeviceType.CUDA:
                continue
            s = (e.start_ns() - off) / 1e9
            out.append((e.name(), s, s + e.duration_ns() / 1e9,
                        e.device_index()))
        out.sort(key=lambda x: x[1])
        return [x for x in out if x[2] > self.t0 and x[1] < self.t1]


def merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_gaps(evs, card_ids, t0: float, t1: float):
    """Per card of ``card_ids``, in order: its busy seconds (the union of
    its events cut to [t0, t1]); and the idle gaps (start, end) of every
    card, card by card."""
    busy_s, gaps = [], []
    for card in card_ids:
        busy = merge((max(s, t0), min(e, t1))
                     for _, s, e, c in evs if c == card)
        busy_s.append(sum(e - s for s, e in busy))
        prev = t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((prev, t1))
    return busy_s, gaps


def read_stretch(stretch: Stretch, spans, hand_kernels: list[str],
                 top: int = 10) -> dict:
    """Busy seconds (the mean over the stretch's cards, and each card's),
    the device operations that took most time (summed over the cards), and
    the idle gaps of every card summed by the innermost harness span
    (label, t0, t1) that covers each gap's middle ("client" where none
    does). Events on a card outside the stretch's are counted in
    ``events_off_cards`` and in the operations, not in busy time."""
    evs = stretch.device_events()
    t0, t1 = stretch.t0, stretch.t1
    by_card, gaps = busy_and_gaps(evs, stretch.card_ids, t0, t1)
    by_op = collections.Counter()
    for name, s, e, _ in evs:
        by_op[name[:80]] += min(e, t1) - max(s, t0)
    spans = sorted((sp for sp in spans if sp[2] >= t0 and sp[1] <= t1),
                   key=lambda x: x[1])
    by_label = collections.Counter()
    count = collections.Counter()
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        label = "client"
        for lab, s, e in spans:
            if s > mid:
                break
            if e >= mid:
                label = lab          # the latest-starting covering span
        by_label[label] += ge - gs
        count[label] += 1
    held = sum(1 for name, _, _, _ in evs
               if any(k in name for k in hand_kernels))
    return {
        "busy_s": sum(by_card) / len(by_card), "busy_s_by_card": by_card,
        "window_s": t1 - t0, "events": len(evs),
        "events_off_cards": sum(1 for *_, c in evs
                                if c not in stretch.card_ids),
        "hand_kernel_events": held,
        "device_ops": [[n, s] for n, s in by_op.most_common(top)],
        "idle_gaps": [[f"{lab} ({count[lab]} gaps)", s]
                      for lab, s in by_label.most_common(top)],
    }
