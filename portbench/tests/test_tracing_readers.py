"""The readers of the program's span ring and device-time histograms, on
a synthetic window: ``queue_wait_ms``, ``forward_dev_ms``, ``lead_ms``
(dispatch ends against the downloads on the card, paired in order), and
the three shares that split ``device_idle`` by what the dispatching
thread was doing."""
import statistics
from types import SimpleNamespace

import pytest

import harness
from tiny import BENCH

from chunkflow_tpu_torch.core import telemetry

T0 = 1000.0  # the window's start, microseconds on the trace's clock

# kernels busy 1000-1010, 1020-1050 and 1070-1090 of the 100 us window; a
# copy in a gap counts as idle: 40 us idle, device_idle 40%
EVENTS = [("conv_kernel", 1000.0, 1010.0), ("add_kernel", 1020.0, 1050.0),
          ("Memcpy HtoD (Pinned -> Device)", 1050.0, 1060.0),
          ("gather_kernel", 1070.0, 1090.0)]
DISPATCHER, POOL = 11, 22
# (name, thread, start us, end us): the dispatching thread has the most
# pipeline/dispatch records; the idle gaps are 1010-1020, 1050-1070 and
# 1090-1100
SPANS = [
    ("scheduler/load", DISPATCHER, 990.0, 1003.0),     # no idle: busy
    ("pipeline/dispatch", DISPATCHER, 1005.0, 1015.0),  # 5 us idle
    ("inference/prepare", DISPATCHER, 1005.0, 1012.0),  # within dispatch
    ("scheduler/load", DISPATCHER, 1015.0, 1025.0),    # 5 us idle
    ("scheduler/wait_result", DISPATCHER, 1055.0, 1065.0),  # 10 us
    ("pipeline/dispatch", DISPATCHER, 1092.0, 1096.0),  # 4 us idle
    ("pipeline/dispatch", POOL, 1050.0, 1070.0),       # another thread
    ("pipeline/compute", POOL, 1000.0, 1100.0),
    ("pipeline/stage", POOL, 900.0, 950.0),            # before the window
]


class Ctx:
    span_ms = harness.Run.span_ms

    def __init__(self, spans=None, events=None, window_s=None, t0=None):
        self.spans = spans or {}
        self.events = events
        self.trace_window_s = window_s
        self._tracer = SimpleNamespace(_t0=t0)


def _read(name, ctx):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               "metric").read(ctx)


@pytest.fixture
def ring(monkeypatch):
    records = [{"name": n, "thread": th, "start_ns": int(s * 1e3),
                "end_ns": int(e * 1e3), "parent": None, "chunk": None}
               for n, th, s, e in SPANS]

    def recorded_spans(since_ns=None):
        return [r for r in records
                if since_ns is None or r["end_ns"] >= since_ns]

    monkeypatch.setattr(telemetry, "recorded_spans", recorded_spans,
                        raising=False)
    return records


@pytest.mark.parametrize("name, hist", [
    ("queue_wait_ms", "pipeline/queue_wait"),
    ("forward_dev_ms", "inference/forward_device"),
])
def test_histogram_readers(name, hist):
    ctx = Ctx(spans={hist: {"count": 4, "total": 1.5}})
    assert _read(name, ctx) == pytest.approx(375.0)
    # a program without the histogram (the parent of the change that
    # added it) reads nothing
    assert _read(name, Ctx()) is None


def test_idle_shares_split_device_idle(ring):
    ctx = Ctx(events=EVENTS, window_s=100e-6, t0=T0)
    shares = {name: _read(name, ctx) for name in
              ("idle_in_dispatch", "idle_in_wait", "idle_outside")}
    assert shares["idle_in_dispatch"] == pytest.approx(9.0)
    assert shares["idle_in_wait"] == pytest.approx(15.0)
    assert shares["idle_outside"] == pytest.approx(16.0)
    idle = _read("device_idle", ctx)
    assert idle == pytest.approx(40.0)
    assert sum(shares.values()) == pytest.approx(idle)


@pytest.mark.parametrize("case", ["no_ring", "no_dispatch", "untraced"])
def test_idle_shares_read_nothing_without_what_they_read(ring, monkeypatch,
                                                         case):
    ctx = Ctx(events=EVENTS, window_s=100e-6, t0=T0)
    if case == "no_ring":
        # the program before the span ring
        monkeypatch.delattr(telemetry, "recorded_spans")
    elif case == "no_dispatch":
        ring[:] = [r for r in ring if r["name"] != "pipeline/dispatch"]
    else:
        ctx = Ctx()
    for name in ("idle_in_dispatch", "idle_in_wait", "idle_outside"):
        assert _read(name, ctx) is None


def _lead_window(case):
    """A stream in milliseconds, as ``(ring records, device events,
    window start and end)``: dispatches on one thread, each chunk's
    compute wait and drain in the pool, and the downloads on the card."""
    spans, downloads = [], []

    def add(name, thread, chunk, start, end):
        spans.append({"name": name, "thread": thread, "chunk": chunk,
                      "start_ns": int(start * 1e6), "end_ns": int(end * 1e6),
                      "parent": None})

    if case in ("host_ahead", "stray_copy", "no_download"):
        # 99 ms dispatches; the card finishes each chunk 20 ms after its
        # dispatch ends, and the drain comes after the next dispatch
        t0, t1 = 50.0, 700.0
        for k in range(-1, 7):
            add("pipeline/dispatch", DISPATCHER, k, 100 * k, 100 * k + 99)
            done = 100 * k + 119
            downloads.append((done, done + 5))
            add("pipeline/compute", POOL, k, 100 * k + 199, 100 * k + 199.01)
            add("pipeline/drain", POOL, k, 100 * k + 199.01, 100 * k + 199.5)
        if case == "stray_copy":
            downloads.append((300.5, 300.6))
    else:
        # 1 ms dispatches run the host ten chunks ahead of a card that
        # takes 100 ms a chunk; the drains wait on the card ("waits"), or
        # come too late to see it finish
        t0, t1 = 50.0, 1050.0
        for k in range(15):
            add("pipeline/dispatch", DISPATCHER, k, 10 * k, 10 * k + 1)
            done = 100 * (k + 1)
            downloads.append((done, done + 5))
            woke = done + 0.05 if case == "card_behind_waits" else done + 90
            add("pipeline/compute", POOL, k, woke - 99.9 if
                case == "card_behind_waits" else woke - 0.01, woke)
            add("pipeline/drain", POOL, k, woke, woke + 5.1)
    events = [("Memcpy DtoH (Device -> Pinned)", s * 1e3, e * 1e3)
              for s, e in downloads if s < t1 and case != "no_download"]
    events.append(("conv_kernel", t0 * 1e3, t0 * 1e3 + 1.0))
    return spans, events, t0 * 1e3, t1 * 1e3


@pytest.mark.parametrize("case, expect", [
    ("host_ahead", 20.0),
    ("card_behind_waits", statistics.median(
        100 * (k + 1) - (10 * k + 1) for k in range(10))),
    ("card_behind_late_drains", None),
    ("stray_copy", None),
    ("no_download", None),
])
def test_lead_pairs_each_dispatch_with_its_download(monkeypatch, case,
                                                   expect):
    # downloads pair with dispatches in order; the one offset under which
    # each download keeps its chunk's rules is read, and a window where
    # none or several offsets fit reads nothing
    spans, events, t0, t1 = _lead_window(case)
    monkeypatch.setattr(
        telemetry, "recorded_spans",
        lambda since_ns=None: [r for r in spans if since_ns is None
                               or r["end_ns"] >= since_ns],
        raising=False)
    ctx = Ctx(events=events, window_s=(t1 - t0) / 1e6, t0=t0)
    lead = _read("lead_ms", ctx)
    if expect is None:
        assert lead is None
    else:
        assert lead == pytest.approx(expect)
