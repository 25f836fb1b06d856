"""The device trace of a measured window, and the arithmetic over it.

A ``torch.profiler`` session with CUDA activity only, opened when the
window opens and closed when it closes; its device events (kernels,
copies, memsets) are read straight from the profiler's result as
``(name, start_us, end_us)``, without building the profiler's per-event
Python objects. A process's first session can miss kernels queued while
it starts, so :meth:`Tracer.warm` opens and discards one in set-up.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

Event = Tuple[str, float, float]


class Tracer:
    """Events are kept where they overlap the span between :meth:`start`
    and the call of :meth:`stop`, clipped to it (the profiler stamps
    device events on the host's wall clock); :attr:`window_s` is that
    span's length."""

    def __init__(self):
        self._prof = None
        self.window_s = None

    def warm(self, torch) -> None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.time_ns() / 1e3

    def stop(self, torch) -> List[Event]:
        from torch.autograd import DeviceType

        t1 = time.time_ns() / 1e3
        torch.cuda.synchronize()
        self._prof.stop()
        self.window_s = (t1 - self._t0) / 1e6
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            if end > self._t0 and start < t1:
                events.append((e.name(), max(start, self._t0), min(end, t1)))
        self._prof = None
        return events


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def busy_us(events: Sequence[Event], kernels_only: bool = False) -> float:
    """Microseconds in which some device operation (or, with
    ``kernels_only``, some kernel) ran: the union of their intervals."""
    return sum(b - a for a, b in union(
        [(s, e) for n, s, e in events if not (kernels_only and is_copy(n))]))


def top_ops(events: Sequence[Event], n: int = 10) -> List[list]:
    """The ``n`` device operations with the most time, seconds each, by
    name (names cut to 160 characters)."""
    total: dict = {}
    for name, s, e in events:
        total[name] = total.get(name, 0.0) + (e - s) / 1e6
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], secs] for name, secs in ranked]


def idle_gaps(events: Sequence[Event], n: int = 10) -> List[list]:
    """The ``n`` longest spans in which no kernel ran, each named by the
    kernel the card then waited to start (names cut to 160 characters),
    in seconds."""
    kernels = sorted((s, e, name) for name, s, e in events
                     if not is_copy(name))
    gaps, reach = [], None
    for s, e, name in kernels:
        if reach is not None and s > reach:
            gaps.append((s - reach, name))
        reach = e if reach is None else max(reach, e)
    gaps.sort(key=lambda g: -g[0])
    return [[f"before {name}"[:160], us / 1e6] for us, name in gaps[:n]]


def kernel_time(events: Sequence[Event], needle: str) -> Tuple[int, float]:
    """(launches, summed seconds) of the kernels whose name holds
    ``needle``."""
    times = [(e - s) / 1e6 for name, s, e in events if needle in name]
    return len(times), sum(times)


def roofline_share(events: Sequence[Event], kernel: str,
                   per_chunk: dict) -> Optional[float]:
    """A hand-written kernel's share of its roofline over the traced
    window, in percent: the least time its traced launches could take
    (``per_chunk``: ``reference/counts.chunk_costs``'s entry, whose
    bound is bytes at 3.35 TB/s or operations at 67 TFLOP/s, whichever
    is longer, for each launch) over the device time they took."""
    launches, seconds = kernel_time(events, f"{kernel}_kernel")
    if not launches or seconds <= 0:
        return None
    bound = per_chunk["bound_s"] / per_chunk["launches"] * launches
    return 100.0 * bound / seconds
