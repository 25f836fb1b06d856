"""In-process telemetry: counters, gauges, histograms, spans and events.

The counterpart of ``chunkflow_tpu/core/telemetry.py``: the same names
(``span`` with ``.duration``, ``inc``, ``gauge``, ``chip_gauge``,
``observe``, ``observe_quantile``, ``quantile``, ``event``,
``hist_totals``, ``enabled``, ``worker_id``, ``task_context``,
``snapshot``, ``flush``, ``reset``, ``configure``, ``configured_path``,
``summary_table``), the same ``CHUNKFLOW_TELEMETRY`` kill switch, and
one process-wide registry behind one lock, so executor threads, pool
workers and HTTP handler threads may report concurrently. Events are
kept in memory (the newest :data:`MAX_EVENTS`) and, after
:func:`configure` (the CLI's ``--metrics-dir``), appended to
``telemetry-<worker>.jsonl``, one line each as it happens, so a worker
killed mid-run leaves what it did; spans and gauges are written there
too (``span`` events with their attributes, ``gauge`` events), as the
JAX package writes them. The file rotates past
``CHUNKFLOW_TELEMETRY_MAX_MB`` (default 256) to ``.1``, ``.2``, ...,
keeping ``CHUNKFLOW_TELEMETRY_KEEP`` generations (default 2); the
supervised claim loop writes a ``snapshot`` event every
``CHUNKFLOW_TELEMETRY_SNAPSHOT_EVERY`` claimed tasks (default 8). Every
event carries the :func:`worker_id` and, inside a :func:`task_context`,
the task's ``trace_id``.

Quantile histograms (:func:`observe_quantile`) count samples into the
fixed :data:`QUANTILE_BOUNDS` buckets, so bucket counts add up across
workers and render as a Prometheus histogram (``parallel/restapi.py``);
``serving/latency`` is one. The time-series sampler
(:func:`start_timeseries`, every ``CHUNKFLOW_TS_INTERVAL`` seconds into
rings of ``CHUNKFLOW_TS_POINTS``) derives counter rates, copies gauges
and estimates p50/p99, writes one ``timeseries`` event, then runs the
tick hooks (the SLO evaluator, ``core/slo.py``). Flush and reset hooks
let other planes (``core/profiling.py``, ``core/slo.py``) ride the
run's lifecycle without this module importing them.

Span names follow ``<layer>/<phase>``: ``pipeline/stage``,
``pipeline/dispatch``, ``pipeline/compute``, ``pipeline/drain``,
``scheduler/load``, ``scheduler/post``, ``scheduler/write``,
``op/<operator>``, ``storage/read``, ``storage/write``,
``lifecycle/claim``, ``lifecycle/commit``, ``lifecycle/release``,
``inference/infer``, ``serving/request``, ``serving/forward``,
``serving/scatter``, ``segment/label``, ``segment/merge``,
``segment/relabel``, and in the executors' dispatch path
``inference/prepare`` (a dispatch's set-up before its launch loop) and
``scheduler/wait_result`` (the dispatching thread waiting for the oldest
result). The depth controller sums the first six (and
``scheduler/write``) through :func:`hist_totals`. Besides its histogram,
each span appends one record to a bounded ring (:data:`MAX_SPAN_RECORDS`,
:func:`recorded_spans`): its name, start and end on ``time.time_ns()``
(the clock ``torch.profiler`` stamps device events on), its thread, the
enclosing span on that thread and the chunk it worked on, so that a
device trace and the host threads read on one timeline. Histograms
without a span of their own: ``pipeline/queue_wait`` (a chunk's seconds
from its staging to its dispatch) and ``inference/forward_device`` (a
chunk's forward timed on the card).
Counters of the worker loop: ``pipeline/tasks``,
``pipeline/chain_rebuilds``, ``inference/chunks``, ``storage/*``
(``volume/storage.py``), ``queue/sent``, ``queue/receives``,
``tasks/committed``, ``tasks/retried``, ``tasks/dead_lettered``,
``tasks/preempted``, ``tasks/surrendered``, ``lease/renewals``,
``ledger/skips`` (``parallel/lifecycle.py``), ``chaos/injected``, the
``serving/*`` counters of ``serve/frontend.py`` and the ``segment/*``
counters of ``segment/stages.py``.
"""
from __future__ import annotations

import contextvars
import json
import os
import re
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = [
    "enabled", "inc", "gauge", "chip_gauge", "observe", "observe_quantile",
    "quantile", "quantile_from_buckets", "QUANTILE_BOUNDS", "event", "span",
    "hist_totals", "worker_id", "task_context", "current_trace_id",
    "snapshot", "flush", "reset", "configure", "configured_path",
    "summary_table", "add_flush_hook", "add_reset_hook", "timeseries",
    "start_timeseries", "stop_timeseries", "timeseries_running",
    "add_tick_hook", "remove_tick_hook", "ts_interval", "ts_points",
    "snapshot_interval", "recorded_spans",
    "CHIP_METRIC_RE", "MAX_EVENTS", "MAX_SPAN_RECORDS",
]

#: per-chip metric names, ``<plane>/chip/<i>/<metric>``: the ``/metrics``
#: renderer folds the chip index into a ``chip`` label
CHIP_METRIC_RE = re.compile(
    r"^(?P<plane>[^/]+(?:/[^/]+)*)/chip/(?P<chip>\d+)/(?P<metric>.+)$")

_OFF_VALUES = ("0", "off", "false", "no")

#: events kept in memory (oldest dropped first)
MAX_EVENTS = 1024

#: span records kept in memory (oldest dropped first): the stream
#: executor's 45 s window, about seven spans a chunk every 0.4 s, fits
#: twenty times over
MAX_SPAN_RECORDS = 16384

#: upper bucket bounds (seconds) of the quantile histograms, 1 ms to
#: 2 min, with an implicit +inf overflow bucket
QUANTILE_BOUNDS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def enabled() -> bool:
    """The kill switch, re-read per call so tests (and long-lived workers)
    can flip it at run time."""
    return os.environ.get("CHUNKFLOW_TELEMETRY", "1").lower() \
        not in _OFF_VALUES


_WORKER_ID: Optional[str] = None
_WORKER_ID_LOCK = threading.Lock()


def worker_id() -> str:
    """This process's identity: ``CHUNKFLOW_WORKER_ID``, else
    ``<hostname>-<pid>``; cached until :func:`reset`."""
    global _WORKER_ID
    wid = _WORKER_ID
    if wid is None:
        with _WORKER_ID_LOCK:
            if _WORKER_ID is None:
                _WORKER_ID = (os.environ.get("CHUNKFLOW_WORKER_ID")
                              or f"{socket.gethostname()}-{os.getpid()}")
            wid = _WORKER_ID
    return wid


def _safe(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "._-" else "_"
                   for ch in name)


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


def quantile_from_buckets(qhist: dict, q: float) -> Optional[float]:
    """The ``q``-quantile (0..1) of a snapshot-form quantile histogram
    ``{"count": n, "buckets": [...per bound..., overflow]}``, interpolated
    linearly inside the covering bucket; None when empty, the largest
    bound when the rank falls in the overflow bucket."""
    count = qhist.get("count", 0)
    buckets = qhist.get("buckets") or []
    if not count or not buckets:
        return None
    rank = q * count
    seen = 0.0
    lower = 0.0
    for i, n in enumerate(buckets):
        upper = (QUANTILE_BOUNDS[i] if i < len(QUANTILE_BOUNDS)
                 else QUANTILE_BOUNDS[-1])
        if n and seen + n >= rank:
            if i >= len(QUANTILE_BOUNDS):
                return QUANTILE_BOUNDS[-1]
            return lower + (rank - seen) / n * (upper - lower)
        seen += n
        lower = upper
    return QUANTILE_BOUNDS[-1]


class _Registry:
    """Process-wide metric state; all mutation under one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # name -> [count, total, min, max]
        self.hists: Dict[str, list] = {}
        # name -> [count, total, min, max, [bucket counts..., overflow]]
        self.qhists: Dict[str, list] = {}
        self.events: deque = deque(maxlen=MAX_EVENTS)
        # (name, start_ns, end_ns, thread, parent, chunk) per span
        self.spans: deque = deque(maxlen=MAX_SPAN_RECORDS)
        self.sink = None  # the open JSONL file of :func:`configure`
        self.sink_path: Optional[str] = None
        self.sink_bytes = 0
        self.max_sink_bytes = 0

    def add_counter(self, name: str, n: float) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self.lock:
            self.gauges[name] = value

    def emit(self, payload: dict) -> None:
        """Append ``payload`` to the sink (:meth:`write`, under the
        lock)."""
        with self.lock:
            self.write(payload)

    def add_hist(self, name: str, value: float) -> None:
        with self.lock:
            self._hist_locked(name, value)

    def add_span(self, name: str, value: float, record: tuple) -> None:
        """A span's histogram sample and its ring record, under one
        acquisition of the lock."""
        with self.lock:
            self._hist_locked(name, value)
            self.spans.append(record)

    def _hist_locked(self, name: str, value: float) -> None:
        h = self.hists.get(name)
        if h is None:
            self.hists[name] = [1, value, value, value]
        else:
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)

    def add_qhist(self, name: str, value: float) -> None:
        with self.lock:
            h = self.qhists.get(name)
            if h is None:
                h = self.qhists[name] = [
                    0, 0.0, value, value, [0] * (len(QUANTILE_BOUNDS) + 1)]
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)
            for i, bound in enumerate(QUANTILE_BOUNDS):
                if value <= bound:
                    h[4][i] += 1
                    break
            else:
                h[4][-1] += 1

    def write(self, payload: dict) -> None:
        """Append to the sink (caller holds the lock); a full disk or a
        closed file drops the sink, never the pipeline. Past
        ``CHUNKFLOW_TELEMETRY_MAX_MB`` the file rotates."""
        if self.sink is None:
            return
        line = json.dumps(payload, default=str) + "\n"
        try:
            self.sink.write(line)
        except (OSError, ValueError):
            self.sink = None
            return
        self.sink_bytes += len(line)
        if 0 < self.max_sink_bytes < self.sink_bytes:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Shift the generations up one suffix (``<path>.1`` the youngest
        rotation, ``<path>.N`` the oldest), sweep the consecutive ones
        beyond ``CHUNKFLOW_TELEMETRY_KEEP`` (stale ones of a higher KEEP)
        and open a fresh ``<path>`` (caller holds the lock). KEEP=1
        truncates. A sink that cannot rotate stops; the pipeline goes
        on."""
        try:
            self.sink.close()
        except OSError:
            pass
        base = self.sink_path
        rotations = _keep_generations() - 1
        try:
            for n in range(rotations, 1, -1):
                if os.path.exists(f"{base}.{n - 1}"):
                    os.replace(f"{base}.{n - 1}", f"{base}.{n}")
            if rotations >= 1:
                os.replace(base, base + ".1")
            else:
                os.remove(base)
            n = rotations + 1
            while os.path.exists(f"{base}.{n}"):
                os.remove(f"{base}.{n}")
                n += 1
            self.sink = open(base, "a", buffering=1)
            self.sink_bytes = 0
        except OSError:
            self.sink = None


_REG = _Registry()


def _stamp(payload: dict) -> dict:
    """The worker id and, inside a :func:`task_context`, the trace id on
    an outgoing event."""
    payload["worker"] = worker_id()
    trace_id = _TASK_CTX.get()
    if trace_id is not None:
        payload["trace_id"] = trace_id
    return payload


def _env_number(name: str, default, cast):
    raw = os.environ.get(name, "")
    try:
        return cast(raw) if raw else default
    except ValueError:
        return default


def snapshot_interval() -> int:
    """Claimed tasks between the supervised claim loop's ``snapshot``
    events (``CHUNKFLOW_TELEMETRY_SNAPSHOT_EVERY``, default 8; 0 turns
    them off), so a killed worker leaves its counters behind."""
    return max(0, _env_number("CHUNKFLOW_TELEMETRY_SNAPSHOT_EVERY", 8, int))


def _max_sink_bytes() -> int:
    """The JSONL file's rotation size (``CHUNKFLOW_TELEMETRY_MAX_MB``,
    default 256; <= 0 never rotates)."""
    return int(_env_number("CHUNKFLOW_TELEMETRY_MAX_MB", 256.0, float)
               * (1 << 20))


def _keep_generations() -> int:
    """JSONL generations kept per worker, the live file included
    (``CHUNKFLOW_TELEMETRY_KEEP``, default 2: the file and its ``.1``;
    at least 1, which truncates at rotation)."""
    return max(1, _env_number("CHUNKFLOW_TELEMETRY_KEEP", 2, int))


def inc(name: str, n: float = 1) -> None:
    """Add ``n`` to a counter."""
    if not enabled():
        return
    _REG.add_counter(name, n)


def gauge(name: str, value: float) -> None:
    """Record a level (ring occupancy, depth): kept as the last value and
    folded into the histogram of the same name, so its mean is readable;
    with a file configured, one ``gauge`` event is written (not kept in
    memory, as spans)."""
    if not enabled():
        return
    _REG.set_gauge(name, value)
    _REG.add_hist(name, value)
    if _REG.sink is not None:
        _REG.emit(_stamp({"kind": "gauge", "name": name, "t": time.time(),
                          "value": value}))


def chip_gauge(plane: str, chip: int, metric: str, value: float) -> None:
    """A per-chip gauge named ``<plane>/chip/<i>/<metric>``
    (:data:`CHIP_METRIC_RE`)."""
    gauge(f"{plane}/chip/{int(chip)}/{metric}", value)


def observe(name: str, value: float) -> None:
    """Fold a sample into a histogram."""
    if not enabled():
        return
    _REG.add_hist(name, value)


def observe_quantile(name: str, value: float) -> None:
    """Fold a sample (seconds) into the fixed-bound quantile histogram
    ``name``."""
    if not enabled():
        return
    _REG.add_qhist(name, value)


def quantile(name: str, q: float) -> Optional[float]:
    """The live ``q``-quantile of a quantile histogram; None when it has
    no samples (or telemetry is off)."""
    if not enabled():
        return None
    with _REG.lock:
        h = _REG.qhists.get(name)
        if h is None:
            return None
        snap = {"count": h[0], "buckets": list(h[4])}
    return quantile_from_buckets(snap, q)


def event(kind: str, name: str, **attrs) -> None:
    """Record a free-form event (a depth change, an alert) in memory and,
    once configured, in the JSONL file."""
    if not enabled():
        return
    payload = _stamp({"kind": kind, "name": name, "t": time.time(),
                      **attrs})
    with _REG.lock:
        _REG.events.append(payload)
        _REG.write(payload)


def configure(metrics_dir: Optional[str]) -> Optional[str]:
    """Append every later event to
    ``<metrics_dir>/telemetry-<worker>.jsonl`` (line-buffered: each line
    reaches the operating system as it is written); None closes the file.
    The file rotates to ``.1`` past ``CHUNKFLOW_TELEMETRY_MAX_MB``.
    Returns the path, or None when off (nothing is created under
    ``CHUNKFLOW_TELEMETRY=0``)."""
    with _REG.lock:
        if _REG.sink is not None:
            _REG.sink.close()
        _REG.sink, _REG.sink_path = None, None
    if metrics_dir is None or not enabled():
        return None
    os.makedirs(metrics_dir, exist_ok=True)
    path = os.path.join(metrics_dir, f"telemetry-{_safe(worker_id())}.jsonl")
    sink = open(path, "a", buffering=1)
    with _REG.lock:
        _REG.sink, _REG.sink_path = sink, path
        _REG.sink_bytes = os.path.getsize(path)
        _REG.max_sink_bytes = _max_sink_bytes()
    return path


def configured_path() -> Optional[str]:
    """The JSONL file of :func:`configure`, or None."""
    return _REG.sink_path


class _NullSpan:
    """The disabled span: a shared, stateless context manager."""

    __slots__ = ()
    duration = 0.0
    start_ns = end_ns = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()

#: the spans open on this thread (each thread starts with an empty
#: context), innermost last
_OPEN_SPANS: contextvars.ContextVar = contextvars.ContextVar(
    "chunkflow_open_spans", default=())


class _Span:
    __slots__ = ("name", "attrs", "t0", "duration", "start_ns", "end_ns",
                 "_outer")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.duration = 0.0
        self.start_ns = self.end_ns = None

    def set(self, **attrs) -> None:
        """Add attributes before the span ends (a load's chunk, once it
        has its item)."""
        self.attrs.update(attrs)

    def chunk(self):
        """The chunk this span worked on: its own ``chunk`` attribute,
        else the enclosing span's, else the bound task's trace id."""
        chunk = self.attrs.get("chunk")
        if chunk is None and self._outer:
            return self._outer[-1].chunk()
        return chunk if chunk is not None else _TASK_CTX.get()

    def __enter__(self):
        self._outer = _OPEN_SPANS.get()
        _OPEN_SPANS.set(self._outer + (self,))
        self.start_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self.t0
        self.end_ns = time.time_ns()
        _OPEN_SPANS.set(self._outer)
        outer = self._outer[-1].name if self._outer else None
        _REG.add_span(self.name, self.duration, (
            self.name, self.start_ns, self.end_ns, threading.get_ident(),
            outer, self.chunk()))
        if _REG.sink is not None:
            _REG.emit(_stamp({"kind": "span", "name": self.name,
                              "t": self.end_ns / 1e9,
                              "t0": self.start_ns / 1e9,
                              "dur_s": self.duration,
                              "pid": os.getpid(), **self.attrs}))
        return False


def span(name: str, **attrs):
    """Time a block into the histogram ``name`` (seconds) and the span
    ring (:func:`recorded_spans`); the span exposes ``.duration``,
    ``.start_ns`` and ``.end_ns`` after exit and takes attributes before
    it (``.set``). With a file configured,
    each span writes one ``span`` event carrying ``attrs`` and its start
    ``t0`` (not kept among the events: spans would crowd the other
    events out of :data:`MAX_EVENTS`)."""
    if not enabled():
        return _NULL_SPAN
    return _Span(name, attrs)


def recorded_spans(since_ns: Optional[int] = None) -> List[dict]:
    """A copy of the span ring, oldest first: ``{"name", "start_ns",
    "end_ns", "thread", "parent", "chunk"}`` per span (``time.time_ns()``
    stamps; ``thread`` a ``threading.get_ident()``; ``parent`` the name
    of the enclosing span on that thread, or None). With ``since_ns``,
    only the spans that ended at or after it."""
    with _REG.lock:
        records = list(_REG.spans)
    keys = ("name", "start_ns", "end_ns", "thread", "parent", "chunk")
    return [dict(zip(keys, r)) for r in records
            if since_ns is None or r[2] >= since_ns]


def hist_totals(names) -> Dict[str, float]:
    """Cumulative histogram totals for ``names`` (seconds for spans); 0.0
    for a name with no samples, and for every name when telemetry is off
    (the depth controller then reads no stall signal and stands pat)."""
    if not enabled():
        return {name: 0.0 for name in names}
    with _REG.lock:
        return {name: (_REG.hists[name][1] if name in _REG.hists else 0.0)
                for name in names}


def _metrics_locked() -> dict:
    snap = {
        "counters": dict(_REG.counters),
        "gauges": dict(_REG.gauges),
        "hists": {
            name: {"count": h[0], "total": h[1], "min": h[2], "max": h[3],
                   "mean": h[1] / h[0] if h[0] else 0.0}
            for name, h in _REG.hists.items()
        },
    }
    if _REG.qhists:
        snap["qhists"] = {
            name: {"count": h[0], "total": h[1], "min": h[2], "max": h[3],
                   "buckets": list(h[4])}
            for name, h in _REG.qhists.items()
        }
    return snap


def snapshot() -> dict:
    """A copy of everything recorded: ``{"counters", "gauges", "hists":
    {name: {count, total, min, max, mean}}, "events": [...]}``, and
    ``"qhists": {name: {count, total, min, max, buckets}}`` once a
    quantile histogram has samples."""
    with _REG.lock:
        snap = _metrics_locked()
        snap["events"] = list(_REG.events)
        return snap


# ---------------------------------------------------------------------------
# the time-series sampler
# ---------------------------------------------------------------------------
def ts_interval() -> float:
    """Seconds between samples (``CHUNKFLOW_TS_INTERVAL``, default 10;
    <= 0 disables the sampler)."""
    return _env_number("CHUNKFLOW_TS_INTERVAL", 10.0, float)


def ts_points() -> int:
    """Ring capacity per metric (``CHUNKFLOW_TS_POINTS``, default 360)."""
    return max(2, _env_number("CHUNKFLOW_TS_POINTS", 360, int))


_TICK_HOOKS: list = []
_FLUSH_HOOKS: list = []
_RESET_HOOKS: list = []


def add_tick_hook(fn) -> None:
    """Run ``fn(now)`` after every time-series sample (idempotent); a
    raising hook is skipped for that tick."""
    if fn not in _TICK_HOOKS:
        _TICK_HOOKS.append(fn)


def remove_tick_hook(fn) -> None:
    if fn in _TICK_HOOKS:
        _TICK_HOOKS.remove(fn)


def add_flush_hook(fn) -> None:
    """Run ``fn(metrics_dir or None)`` at every :func:`flush`."""
    if fn not in _FLUSH_HOOKS:
        _FLUSH_HOOKS.append(fn)


def add_reset_hook(fn) -> None:
    """Run ``fn()`` at every :func:`reset`."""
    if fn not in _RESET_HOOKS:
        _RESET_HOOKS.append(fn)


def _run_hooks(hooks, *args) -> None:
    for hook in list(hooks):
        try:
            hook(*args)
        except Exception:
            pass  # an observability plane never takes the pipeline down


class _TimeSeriesSampler:
    """Bounded ``(t, value)`` rings over the registry, fed by one daemon
    thread: ``rate:<counter>`` against the previous tick,
    ``gauge:<name>``, and ``p50:``/``p99:<qhist>``."""

    def __init__(self, interval: float, points: int):
        self.interval = max(0.01, float(interval))
        self.points = int(points)
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {}
        self._prev: Optional[Tuple[float, dict]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # the baseline the first rates are taken against
        self.sample()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chunkflow-timeseries")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if enabled():
                try:
                    self.sample()
                except Exception:
                    pass

    def sample(self, now: Optional[float] = None) -> Dict[str, float]:
        """One tick (the thread's body; :func:`flush` and tests call it):
        returns the sampled ``{name: value}``."""
        if now is None:
            now = time.time()
        with _REG.lock:
            snap = _metrics_locked()
        qhists = snap.get("qhists") or {}
        values: Dict[str, float] = {}
        with self._lock:
            prev = self._prev
            if prev is not None and now > prev[0]:
                dt = now - prev[0]
                for name, value in snap["counters"].items():
                    values[f"rate:{name}"] = round(
                        (value - prev[1].get(name, 0.0)) / dt, 6)
            self._prev = (now, dict(snap["counters"]))
            for name, value in snap["gauges"].items():
                values[f"gauge:{name}"] = value
            for name, h in qhists.items():
                p50 = quantile_from_buckets(h, 0.5)
                if p50 is not None:
                    values[f"p50:{name}"] = p50
                    values[f"p99:{name}"] = quantile_from_buckets(h, 0.99)
            for name, value in values.items():
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = deque(maxlen=self.points)
                ring.append((now, value))
        if values or qhists:
            event("timeseries", "timeseries/sample",
                  interval_s=self.interval, values=values,
                  qhists={name: {"count": h["count"],
                                 "buckets": h["buckets"]}
                          for name, h in qhists.items()})
        _run_hooks(_TICK_HOOKS, now)
        return values

    def series(self) -> Dict[str, List[Tuple[float, float]]]:
        with self._lock:
            return {name: list(ring) for name, ring in self._rings.items()}

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=timeout)


_SAMPLER_LOCK = threading.Lock()
_SAMPLER: Optional[_TimeSeriesSampler] = None


def start_timeseries(interval: Optional[float] = None,
                     points: Optional[int] = None):
    """Start the sampler thread (idempotent: a running sampler is
    returned as it is). None, and no thread, when telemetry is off or the
    interval is <= 0."""
    global _SAMPLER
    if not enabled():
        return None
    if interval is None:
        interval = ts_interval()
    if interval <= 0:
        return None
    with _SAMPLER_LOCK:
        if _SAMPLER is not None:
            return _SAMPLER
        sampler = _SAMPLER = _TimeSeriesSampler(
            interval, ts_points() if points is None else points)
    sampler.start()
    return sampler


def stop_timeseries() -> None:
    """Stop and join the sampler thread."""
    global _SAMPLER
    with _SAMPLER_LOCK:
        sampler, _SAMPLER = _SAMPLER, None
    if sampler is not None:
        sampler.stop()


def timeseries_running() -> bool:
    return _SAMPLER is not None


def timeseries() -> Dict[str, List[Tuple[float, float]]]:
    """Copies of the per-metric ``[(t, value), ...]`` rings, or ``{}``
    when no sampler runs."""
    sampler = _SAMPLER
    return {} if sampler is None else sampler.series()


def flush() -> None:
    """Take a last sample (and SLO tick), run the flush hooks, and write
    the aggregate snapshot as a ``snapshot`` event to the JSONL file."""
    if not enabled():
        return
    sampler = _SAMPLER
    if sampler is not None:
        try:
            sampler.sample()
        except Exception:
            pass
    path = _REG.sink_path
    _run_hooks(_FLUSH_HOOKS, os.path.dirname(path) if path else None)
    with _REG.lock:
        payload = _stamp({"kind": "snapshot", "t": time.time(),
                          "pid": os.getpid(), **_metrics_locked()})
        _REG.write(payload)
        if _REG.sink is not None:
            try:
                _REG.sink.flush()
            except OSError:
                pass


def reset() -> None:
    """Clear every metric, event and span record, close the event file,
    stop the sampler and drop the cached worker id (tests; each CLI run
    starts here)."""
    global _WORKER_ID
    stop_timeseries()
    _TICK_HOOKS.clear()
    configure(None)
    with _REG.lock:
        _REG.counters.clear()
        _REG.gauges.clear()
        _REG.hists.clear()
        _REG.qhists.clear()
        _REG.events.clear()
        _REG.spans.clear()
    with _WORKER_ID_LOCK:
        _WORKER_ID = None
    _run_hooks(_RESET_HOOKS)


def summary_table() -> str:
    """The end-of-run table of spans, latency histograms, counters and
    last-value gauges (the CLI prints it under ``-v``); empty when
    nothing was recorded."""
    snap = snapshot()
    lines = []
    if snap["hists"]:
        lines.append(f"  {'span':<28} {'count':>7} {'total_s':>9} "
                     f"{'mean_s':>9} {'max_s':>9}")
        for name in sorted(snap["hists"]):
            h = snap["hists"][name]
            lines.append(f"  {name:<28} {h['count']:>7} {h['total']:>9.3f} "
                         f"{h['mean']:>9.4f} {h['max']:>9.4f}")
    if snap.get("qhists"):
        lines.append(f"  {'latency hist':<28} {'count':>7} {'p50_s':>9} "
                     f"{'p99_s':>9}")
        for name in sorted(snap["qhists"]):
            h = snap["qhists"][name]
            p50 = quantile_from_buckets(h, 0.5)
            p99 = quantile_from_buckets(h, 0.99)
            lines.append(f"  {name:<28} {h['count']:>7} "
                         f"{p50 if p50 is not None else 0.0:>9.4f} "
                         f"{p99 if p99 is not None else 0.0:>9.4f}")
    if snap["counters"]:
        lines.append(f"  {'counter':<28} {'value':>7}")
        for name in sorted(snap["counters"]):
            lines.append(f"  {name:<28} {snap['counters'][name]:>7g}")
    if snap["gauges"]:
        lines.append(f"  {'gauge (last)':<28} {'value':>7}")
        for name in sorted(snap["gauges"]):
            lines.append(f"  {name:<28} {snap['gauges'][name]:>7g}")
    if not lines:
        return ""
    return "\n".join(["telemetry summary:"] + lines)
