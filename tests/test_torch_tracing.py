"""The port's span ring, chunk ids and device-time readings, on the CPU.

Spans record their start and end on ``time.time_ns()``, their thread,
their enclosing span and their chunk in a bounded ring
(``core/telemetry.py``); both executors stamp every span of one chunk
with one id and time its wait between staging and dispatch
(``pipeline/queue_wait``); a dispatched chunk's drain reads the
forward's device time (``inference/forward_device``) from event pairs of
a reused pool that the cost ledger reads its device time from too, by
``query()``. None of it changes what the depth controller reads, and
the kill switch records none of it. The card's side (the clocks, the
event timings against a trace) is in ``tests/test_torch_cuda.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.core import profiling, telemetry
from chunkflow_tpu_torch.flow import log_summary
from chunkflow_tpu_torch.flow.pipeline import (
    _drain_host,
    pipeline_chunks,
    pipelined_inference_stage,
)
from chunkflow_tpu_torch.flow.runtime import new_task
from chunkflow_tpu_torch.flow.scheduler import (
    PHASE_KNOBS,
    DepthController,
    schedule_chunks,
    scheduled_inference_stage,
)
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.volume import storage

torch.set_num_threads(1)

IDENTITY = dict(input_patch_size=(4, 16, 16), output_patch_overlap=(2, 8, 8),
                num_output_channels=3, framework="identity", batch_size=2,
                crop_output_margin=False, device="cpu")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for var in ("CHUNKFLOW_TELEMETRY", "CHUNKFLOW_SCHED",
                "CHUNKFLOW_SCHED_INTERVAL", "CHUNKFLOW_SCHED_MEM_GB"):
        monkeypatch.delenv(var, raising=False)
    telemetry.reset()
    storage.reset_read_concurrency()
    yield monkeypatch
    telemetry.reset()
    storage.reset_read_concurrency()


def _chunks(n=4, shape=(8, 32, 32)):
    rng = np.random.default_rng(5)
    return [Chunk(rng.integers(1, 256, shape).astype(np.uint8),
                  voxel_offset=(shape[0] * i, 0, 0)) for i in range(n)]


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------
def test_ring_records_nested_spans_on_two_threads():
    both = threading.Barrier(2, timeout=10)

    def work(tag):
        with telemetry.span("test/outer", chunk=tag):
            with telemetry.span("test/inner"):
                both.wait()  # both threads alive at once: distinct idents
                time.sleep(0.002)
        return threading.get_ident()

    idents = {}
    threads = [threading.Thread(target=lambda t=t: idents.update(
        {t: work(t)})) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    records = telemetry.recorded_spans()
    assert len(records) == 4
    for tag in ("a", "b"):
        mine = [r for r in records if r["chunk"] == tag]
        assert {r["thread"] for r in mine} == {idents[tag]}
        (outer,) = [r for r in mine if r["name"] == "test/outer"]
        (inner,) = [r for r in mine if r["name"] == "test/inner"]
        assert outer["parent"] is None and inner["parent"] == "test/outer"
        assert outer["start_ns"] <= inner["start_ns"] \
            < inner["end_ns"] <= outer["end_ns"]
        assert inner["end_ns"] - inner["start_ns"] >= 1_000_000
    assert idents["a"] != idents["b"]
    # the histograms read what they read before
    hists = telemetry.snapshot()["hists"]
    assert hists["test/outer"]["count"] == hists["test/inner"]["count"] == 2


def test_ring_is_bounded_and_reset_clears_it():
    n = telemetry.MAX_SPAN_RECORDS + 10
    for i in range(n):
        with telemetry.span("test/s", chunk=i):
            pass
    records = telemetry.recorded_spans()
    assert len(records) == telemetry.MAX_SPAN_RECORDS
    assert [r["chunk"] for r in records[:2]] == [10, 11]
    assert records[-1]["chunk"] == n - 1
    assert telemetry.snapshot()["hists"]["test/s"]["count"] == n
    since = records[-3]["end_ns"]
    assert [r["chunk"] for r in telemetry.recorded_spans(since)] \
        == [n - 3, n - 2, n - 1]
    telemetry.reset()
    assert telemetry.recorded_spans() == []


def test_span_attributes_set_late_and_the_chunk_of_the_enclosing_span():
    with telemetry.task_context("trace-7"):
        with telemetry.span("test/load") as load:
            load.set(chunk=3)
        with telemetry.span("test/task"):
            pass
        with telemetry.span("test/dispatch", chunk=4):
            with telemetry.span("test/prepare") as prepare:
                pass
            with telemetry.span("test/after"):
                pass
    load_r, task_r, prepare_r, after_r, dispatch_r = \
        telemetry.recorded_spans()
    assert load_r["chunk"] == 3
    # no chunk of its own nor of an enclosing span: the task's trace id
    assert task_r["chunk"] == "trace-7"
    # the enclosing span's chunk; a span opened after a sibling ended is
    # the enclosing span's child, not the sibling's
    assert prepare_r["chunk"] == after_r["chunk"] == 4
    assert prepare_r["end_ns"] == prepare.end_ns
    assert prepare_r["parent"] == after_r["parent"] == "test/dispatch"
    assert dispatch_r["parent"] is None
    assert telemetry.snapshot()["hists"]["test/prepare"]["count"] == 1


def test_span_event_carries_its_start(tmp_path):
    telemetry.configure(str(tmp_path))
    with telemetry.span("test/s", chunk=1) as sp:
        pass
    path = telemetry.configured_path()
    telemetry.configure(None)
    import json

    (event,) = [json.loads(line) for line in open(path)]
    assert event["t0"] == sp.start_ns / 1e9 and event["t"] == sp.end_ns / 1e9
    assert event["chunk"] == 1 and event["dur_s"] == sp.duration


def test_kill_switch_records_nothing(clean):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    with telemetry.span("test/s", chunk=1) as sp:
        sp.set(chunk=2)
    assert sp.start_ns is None and sp.end_ns is None
    out = list(schedule_chunks(Inferencer(**IDENTITY), _chunks(2)))
    assert len(out) == 2
    assert telemetry.recorded_spans() == []
    clean.delenv("CHUNKFLOW_TELEMETRY")
    assert telemetry.recorded_spans() == []
    assert telemetry.snapshot()["hists"] == {}


# ---------------------------------------------------------------------------
# the executors: one id per chunk, the queue wait
# ---------------------------------------------------------------------------
def _stream(kind, inferencer, chunks):
    """The outputs and the ids the chunks' spans should carry: sequence
    numbers, or the tasks' trace ids where they have them (the adaptive
    stage's tasks here)."""
    ids = list(range(len(chunks)))
    if kind == "adaptive":
        return list(schedule_chunks(inferencer, chunks,
                                    postprocess=lambda c: c)), ids
    if kind == "static":
        return list(pipeline_chunks(inferencer, chunks, ring=2)), ids
    tasks = []
    for i, chunk in enumerate(chunks):
        tasks.append(dict(new_task(), chunk=chunk))
        if kind == "adaptive-stage":
            tasks[-1]["trace_id"] = ids[i] = f"trace-{i}"
    stage = (scheduled_inference_stage(inferencer) if kind == "adaptive-stage"
             else pipelined_inference_stage(inferencer))
    return [t["chunk"] for t in stage(iter(tasks))], ids


SPANS_OF = {
    "adaptive": {"pipeline/stage", "scheduler/load", "pipeline/dispatch",
                 "inference/prepare", "pipeline/compute", "pipeline/drain",
                 "scheduler/post", "scheduler/wait_result"},
    "static": {"pipeline/stage", "pipeline/dispatch", "inference/prepare",
               "pipeline/compute", "pipeline/drain"},
    "adaptive-stage": {"pipeline/stage", "scheduler/load",
                       "pipeline/dispatch", "inference/prepare",
                       "pipeline/compute", "pipeline/drain",
                       "scheduler/wait_result"},
    "static-stage": {"pipeline/stage", "pipeline/dispatch",
                     "inference/prepare", "pipeline/compute",
                     "pipeline/drain"},
}


@pytest.mark.parametrize("kind", list(SPANS_OF))
def test_every_span_of_a_chunk_carries_one_id(kind):
    chunks = _chunks(5)
    got, ids = _stream(kind, Inferencer(**IDENTITY), chunks)
    assert len(got) == len(chunks)
    records = telemetry.recorded_spans()
    for cid in ids:
        names = [r["name"] for r in records if r["chunk"] == cid]
        assert set(names) == SPANS_OF[kind], cid
        # one of each per chunk (a load may also wait for the stream's end)
        assert all(names.count(n) == 1 for n in SPANS_OF[kind]
                   if n != "scheduler/load"), names
    assert {r["chunk"] for r in records} - set(ids) <= {None}
    for r in records:
        if r["name"] == "inference/prepare":
            assert r["parent"] == "pipeline/dispatch"


@pytest.mark.parametrize("kind", ["adaptive", "static", "adaptive-stage",
                                  "static-stage"])
def test_queue_wait_is_dispatch_start_less_stage_end(kind):
    chunks = _chunks(5)
    _stream(kind, Inferencer(**IDENTITY), chunks)
    spans = _by_name(telemetry.recorded_spans())
    stage_end = {r["chunk"]: r["end_ns"] for r in spans["pipeline/stage"]}
    dispatch_start = {r["chunk"]: r["start_ns"]
                      for r in spans["pipeline/dispatch"]}
    assert set(stage_end) == set(dispatch_start) and len(stage_end) == 5
    waits = [(dispatch_start[c] - stage_end[c]) / 1e9 for c in stage_end]
    assert all(w >= 0 for w in waits)
    h = telemetry.snapshot()["hists"]["pipeline/queue_wait"]
    assert h["count"] == 5
    assert h["total"] == pytest.approx(sum(waits), rel=1e-9, abs=1e-12)
    # on the CPU there are no event pairs, so no device time
    assert "inference/forward_device" not in telemetry.snapshot()["hists"]


def test_depth_controller_reads_the_same_seven_phases():
    assert DepthController.PHASES == (
        "scheduler/load", "pipeline/stage", "pipeline/dispatch",
        "pipeline/compute", "pipeline/drain", "scheduler/post",
        "scheduler/write")
    assert tuple(PHASE_KNOBS) == DepthController.PHASES

    def decisions(extra):
        telemetry.reset()
        storage.reset_read_concurrency()
        ctl = DepthController(interval=1, watermark_bytes=1 << 40)
        out = []
        for step in range(12):
            telemetry.observe("scheduler/load", 0.05 * (step % 3 + 1))
            telemetry.observe("pipeline/compute", 0.02)
            telemetry.observe("pipeline/drain", 0.01 * step)
            if extra:
                for name in ("pipeline/queue_wait",
                             "inference/forward_device", "inference/prepare",
                             "scheduler/wait_result"):
                    telemetry.observe(name, 10.0)
            out.append(ctl.observe_task())
        return out, ctl.depths

    plain = decisions(False)
    assert any(plain[0])
    assert decisions(True) == plain


# ---------------------------------------------------------------------------
# the drain's readings, with stand-in events
# ---------------------------------------------------------------------------
class FakeEvent:
    def __init__(self, done=True, ms=0.0):
        self.done, self.ms, self.waited, self.recorded = done, ms, 0, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True

    def record(self, stream=None):
        self.recorded += 1

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.ms - self.ms


def test_event_pairs_are_read_without_waiting_and_reused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: FakeEvent(done=False))
    pool = profiling.EventPairs()
    pair = pool.take()
    pair[1].ms = 2.5
    assert pool.read(pair) is None  # its end has not fired
    assert pool.take() is not pair  # and it is not handed out again
    pair[0].done = pair[1].done = True
    assert pool.read(pair) == pytest.approx(0.0025)
    assert pool.take() is pair  # read, then reused
    assert pair[1].waited == 0


@pytest.mark.parametrize("finished", [True, False])
def test_drain_folds_the_forward_pairs_once_computed(finished):
    order = []

    class Pair(FakeEvent):
        def query(self):
            order.append("query")
            return self.done

    class Out:
        def wait_computed(self):
            order.append("computed")

        def host(self):
            order.append("host")
            return Chunk(np.zeros((2, 4, 4), np.float32))

    pool = profiling.EventPairs()
    pairs = [(FakeEvent(), Pair(done=finished or i < 2, ms=2.5))
             for i in range(3)]
    out = Out()
    out._forward_pairs = (pool, pairs)
    _drain_host(out, 7)
    assert order[0] == "computed" and order[-1] == "host"
    assert order.count("query") == 3 and out._forward_pairs is None
    h = telemetry.snapshot()["hists"].get("inference/forward_device")
    if finished:
        assert h["count"] == 1 and h["total"] == pytest.approx(0.0075)
    else:  # a pair not finished drops the chunk's sample; nothing waits
        assert h is None
    assert all(end.waited == 0 for _, end in pairs)
    spans = _by_name(telemetry.recorded_spans())
    assert [r["chunk"] for r in spans["pipeline/compute"]] == [7]


def test_cost_ledger_reads_device_time_without_waiting(monkeypatch):
    made = []

    def event(enable_timing=False):
        made.append(FakeEvent(done=False, ms=10.0 * len(made)))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CHUNKFLOW_PEAK_FLOPS", "989e12")
    program = profiling.stamp_cost(lambda: None, flops=989e12 * 0.001)
    program = profiling.instrument_program(program, ("scatter", (8, 8, 8)),
                                           device="cuda")
    for _ in range(4):
        program()  # the first is the compile; three are bracketed
    (entry,) = profiling.catalog()
    assert entry["util_basis"] == "dispatch"
    assert entry["device_pending"] == 3 and entry["device_calls"] == 0
    # the oldest two finish: each pair's end made 10 ms after its start
    for e in made[:4]:
        e.done = True
    (entry,) = profiling.catalog()
    assert entry["device_calls"] == 2 and entry["device_pending"] == 1
    assert entry["device_mean_s"] == pytest.approx(0.01)
    assert entry["util_basis"] == "device"
    assert entry["roofline_util"] == pytest.approx(0.1)
    assert entry["lost_s"] == pytest.approx((0.01 - 0.001) * 3)
    assert entry["exec_mean_s"] is not None and entry["dispatch_total_s"] >= 0
    assert all(e.waited == 0 for e in made)
    # a later call drains what finished and reuses the read pairs
    before = len(made)
    for e in made:
        e.done = True
    program()
    assert len(made) == before
    log_summary.print_program_summary([entry])


def test_device_programs_table_shows_device_beside_dispatch(capsys):
    entries = [{"family": "scatter", "key": "(64, 512, 512)",
                "compile_s": 1.0, "exec_mean_s": 0.396,
                "device_mean_s": 0.38, "roofline_util": 0.04,
                "lost_s": 40.0}]
    log_summary.print_program_summary(entries)
    out = capsys.readouterr().out
    assert "device_ms" in out and "380.00" in out and "396.00" in out
    log_summary.print_program_summary([dict(entries[0], device_mean_s=None)])
    assert "device_ms" not in capsys.readouterr().out
