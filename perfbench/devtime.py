"""Device time on the card: CUDA events behind a spin kernel, and the
reading of a torch.profiler stretch (busy time, the largest device
operations, idle gaps by what the host was doing)."""
from __future__ import annotations

import collections
import pathlib
import re
import time

import torch

# the device spins this many cycles (about 50 ms on an H100) before
# `device_ms`'s calls, so the host queues them all before the first runs
SPIN_CYCLES = 100_000_000


def device_ms(fn, reps: int = 3) -> float:
    """Device milliseconds a call: CUDA events around ``reps`` calls that
    the host queues behind a spin kernel (`torch.cuda._sleep`), so the
    device runs them back to back and the events hold the device's time,
    not the host's. Profiler sums are not used: traces on the card drop a
    varying share of their device events. Raises if the host took longer
    to queue the calls than the device spun (the events would then hold
    host time)."""
    fn()
    torch.cuda.synchronize()
    spin, start, stop = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    spin_ms = spin.elapsed_time(start)
    if host_ms >= spin_ms:
        raise RuntimeError(f"device_ms: the host took {host_ms:.2f} ms to "
                           f"queue {reps} calls, the device spun "
                           f"{spin_ms:.2f} ms")
    return start.elapsed_time(stop) / reps


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
    """A torch.profiler trace of a stretch of the window, read on the
    host's monotonic clock so the harness's own spans label its gaps."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self._mark = None

    @staticmethod
    def warm() -> float:
        """Trace one tiny device call, so the profiler's first-use cost (its
        CUPTI set-up, seconds on the card) falls before the window; returns
        its seconds."""
        from torch.profiler import ProfilerActivity, profile
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
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
        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self._prof.stop()

    def device_events(self) -> list[tuple[str, float, float]]:
        """(name, start, end) of every device operation in the stretch, on
        the monotonic clock, sorted by start."""
        from torch.autograd import DeviceType
        evs = self._prof.profiler.kineto_results.events()
        mark = next(e for e in evs if e.name() == "perfbench.clock_mark")
        off = mark.start_ns() - self._mark
        out = []
        for e in evs:
            if e.device_type() != DeviceType.CUDA:
                continue
            s = (e.start_ns() - off) / 1e9
            out.append((e.name(), s, s + e.duration_ns() / 1e9))
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


def read_stretch(stretch: Stretch, spans, hand_kernels: list[str],
                 top: int = 10) -> dict:
    """Busy seconds, the device operations that took most time, and the
    idle gaps summed by the innermost harness span (label, t0, t1) that
    covers each gap's middle ("client" where none does)."""
    evs = stretch.device_events()
    t0, t1 = stretch.t0, stretch.t1
    busy = merge((max(s, t0), min(e, t1)) for _, s, e in evs)
    busy_s = sum(e - s for s, e in busy)
    by_op = collections.Counter()
    for name, s, e in evs:
        by_op[name[:80]] += min(e, t1) - max(s, t0)
    gaps = []
    prev = t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
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
    held = sum(1 for name, _, _ in evs
               if any(k in name for k in hand_kernels))
    return {
        "busy_s": busy_s, "window_s": t1 - t0, "events": len(evs),
        "hand_kernel_events": held,
        "device_ops": [[n, s] for n, s in by_op.most_common(top)],
        "idle_gaps": [[f"{lab} ({count[lab]} gaps)", s]
                      for lab, s in by_label.most_common(top)],
    }
