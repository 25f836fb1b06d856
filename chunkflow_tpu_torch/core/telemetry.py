"""In-process telemetry: counters, gauges, span histograms and events.

The counterpart of ``chunkflow_tpu/core/telemetry.py``, cut to what the
streaming executors and their depth controller read and write
(``flow/pipeline.py``, ``flow/scheduler.py``, ``flow/runtime.py``): the
same names (``span`` with ``.duration``, ``inc``, ``gauge``, ``observe``,
``event``, ``hist_totals``, ``enabled``, ``task_context``, ``snapshot``,
``reset``), the same ``CHUNKFLOW_TELEMETRY`` kill switch, and one
process-wide registry behind one lock, so executor threads and pool
workers may report concurrently. There is no JSONL sink, exporter or
fleet identity: events are kept in memory (the newest
:data:`MAX_EVENTS`) and read back through :func:`snapshot`.

Span names follow ``<layer>/<phase>``: ``pipeline/stage``,
``pipeline/dispatch``, ``pipeline/compute``, ``pipeline/drain``,
``scheduler/load``, ``scheduler/post``, ``scheduler/write``,
``op/<operator>``. The depth controller sums the first six (and
``scheduler/write``) through :func:`hist_totals`.
"""
from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = [
    "enabled", "inc", "gauge", "observe", "event", "span", "hist_totals",
    "task_context", "current_trace_id", "snapshot", "reset", "MAX_EVENTS",
]

_OFF_VALUES = ("0", "off", "false", "no")

#: events kept in memory (oldest dropped first)
MAX_EVENTS = 1024


def enabled() -> bool:
    """The kill switch, re-read per call so tests (and long-lived workers)
    can flip it at run time."""
    return os.environ.get("CHUNKFLOW_TELEMETRY", "1").lower() \
        not in _OFF_VALUES


_TASK_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "chunkflow_trace_id", default=None)


def current_trace_id() -> Optional[str]:
    """The trace id bound by the innermost :func:`task_context`, or None."""
    return _TASK_CTX.get()


class _TaskContext:
    """Scoped trace-id binding; ``trace_id=None`` is a no-op so an
    un-traced task never clobbers an enclosing context."""

    __slots__ = ("trace_id", "_token")

    def __init__(self, trace_id: Optional[str]):
        self.trace_id = trace_id
        self._token = None

    def __enter__(self):
        if self.trace_id is not None:
            self._token = _TASK_CTX.set(self.trace_id)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _TASK_CTX.reset(self._token)
            self._token = None
        return False


def task_context(trace_id: Optional[str]):
    """Bind ``trace_id`` for a ``with`` block: events emitted inside carry
    it."""
    return _TaskContext(trace_id)


class _Registry:
    """Process-wide metric state; all mutation under one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # name -> [count, total, min, max]
        self.hists: Dict[str, list] = {}
        self.events: deque = deque(maxlen=MAX_EVENTS)

    def add_hist(self, name: str, value: float) -> None:
        with self.lock:
            h = self.hists.get(name)
            if h is None:
                self.hists[name] = [1, value, value, value]
            else:
                h[0] += 1
                h[1] += value
                h[2] = min(h[2], value)
                h[3] = max(h[3], value)


_REG = _Registry()


def inc(name: str, n: float = 1) -> None:
    """Add ``n`` to a counter."""
    if not enabled():
        return
    with _REG.lock:
        _REG.counters[name] = _REG.counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Record a level (ring occupancy, depth): kept as the last value and
    folded into the histogram of the same name, so its mean is readable."""
    if not enabled():
        return
    with _REG.lock:
        _REG.gauges[name] = value
    _REG.add_hist(name, value)


def observe(name: str, value: float) -> None:
    """Fold a sample into a histogram."""
    if not enabled():
        return
    _REG.add_hist(name, value)


def event(kind: str, name: str, **attrs) -> None:
    """Record a free-form event (a depth change, say) in memory."""
    if not enabled():
        return
    payload = {"kind": kind, "name": name, "t": time.time(), **attrs}
    trace_id = _TASK_CTX.get()
    if trace_id is not None:
        payload["trace_id"] = trace_id
    with _REG.lock:
        _REG.events.append(payload)


class _NullSpan:
    """The disabled span: a shared, stateless context manager."""

    __slots__ = ()
    duration = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "t0", "duration")

    def __init__(self, name: str):
        self.name = name
        self.duration = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self.t0
        _REG.add_hist(self.name, self.duration)
        return False


def span(name: str):
    """Time a block into the histogram ``name`` (seconds); the span
    exposes ``.duration`` after exit."""
    if not enabled():
        return _NULL_SPAN
    return _Span(name)


def hist_totals(names) -> Dict[str, float]:
    """Cumulative histogram totals for ``names`` (seconds for spans); 0.0
    for a name with no samples, and for every name when telemetry is off
    (the depth controller then reads no stall signal and stands pat)."""
    if not enabled():
        return {name: 0.0 for name in names}
    with _REG.lock:
        return {name: (_REG.hists[name][1] if name in _REG.hists else 0.0)
                for name in names}


def snapshot() -> dict:
    """A copy of everything recorded: ``{"counters", "gauges", "hists":
    {name: {count, total, min, max, mean}}, "events": [...]}``."""
    with _REG.lock:
        return {
            "counters": dict(_REG.counters),
            "gauges": dict(_REG.gauges),
            "hists": {
                name: {"count": h[0], "total": h[1], "min": h[2],
                       "max": h[3], "mean": h[1] / h[0] if h[0] else 0.0}
                for name, h in _REG.hists.items()
            },
            "events": list(_REG.events),
        }


def reset() -> None:
    """Clear every metric and event (tests; each CLI run starts here)."""
    with _REG.lock:
        _REG.counters.clear()
        _REG.gauges.clear()
        _REG.hists.clear()
        _REG.events.clear()
