"""The port's streaming executors and task-stream runtime, on the CPU.

Mirrors ``tests/flow/test_pipeline_executor.py`` and
``tests/flow/test_scheduler.py``: streaming is a pure wall-time
optimization, so every streamed result must be BITWISE the serial one —
static and adaptive, at every ring depth, with and without a post stage,
on ragged chunks of mixed shapes — and, with the identity engine, the
JAX package's ``Inferencer.stream``. Order, skip markers, timers and
failure flushes follow the JAX stages; the depth controller makes the
JAX controller's decisions on the same stall streams; the CLI's
``--async-depth`` runs are the synchronous run's and the JAX CLI's.
"""
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.core import telemetry as jax_telemetry
from chunkflow_tpu.core.bbox import BoundingBoxes as JaxBoxes
from chunkflow_tpu.flow import scheduler as jax_scheduler
from chunkflow_tpu.inference.inferencer import Inferencer as JaxInferencer
from chunkflow_tpu.volume import storage as jax_storage
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.bbox import BoundingBox, BoundingBoxes
from chunkflow_tpu_torch.flow import cli, scheduler
from chunkflow_tpu_torch.flow.pipeline import (
    pipeline_chunks,
    pipelined_inference_stage,
)
from chunkflow_tpu_torch.flow.runtime import (
    drain_pending_writes,
    new_task,
    prefetch_stage,
    process_stream,
)
from chunkflow_tpu_torch.flow.scheduler import (
    DepthController,
    schedule_chunks,
    scheduled_inference_stage,
    scheduler_mode,
    write_behind_stage,
)
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.volume import storage

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

IDENTITY = dict(input_patch_size=(4, 16, 16), output_patch_overlap=(2, 8, 8),
                num_output_channels=3, framework="identity", batch_size=2,
                crop_output_margin=False)
# mixed aligned and ragged shapes: a ragged chunk pads, runs another
# geometry and crops back
RAGGED_SHAPES = [(8, 32, 32), (5, 17, 18), (8, 32, 32), (7, 30, 20)]


@pytest.fixture(autouse=True)
def clean_registry(monkeypatch):
    for var in ("CHUNKFLOW_TELEMETRY", "CHUNKFLOW_SCHED",
                "CHUNKFLOW_SCHED_MEM_GB", "CHUNKFLOW_SCHED_INTERVAL",
                "CHUNKFLOW_BLEND", "CHUNKFLOW_PRECISION"):
        monkeypatch.delenv(var, raising=False)
    telemetry.reset()
    storage.reset_read_concurrency()
    yield
    telemetry.reset()
    storage.reset_read_concurrency()


def _inferencer(**kwargs):
    return Inferencer(device="cpu", **dict(IDENTITY, **kwargs))


def _chunks(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [Chunk(rng.random(s).astype(np.float32), voxel_offset=(8 * i, 0, 0))
            for i, s in enumerate(shapes)]


def _task(chunk, i):
    task = new_task()
    task["chunk"] = chunk
    task["i"] = i
    return task


def _serial(inferencer, chunks):
    return [inferencer(c).host().array for c in chunks]


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Inferencer.stream / pipeline_chunks / schedule_chunks: bitwise serial
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("ring", [1, 2, 3])
def test_stream_bitwise_serial(ring, adaptive):
    inferencer = _inferencer(shape_bucket=(8, 16, 16))
    chunks = _chunks(RAGGED_SHAPES)
    serial = _serial(inferencer, chunks)
    out = list(inferencer.stream(iter(chunks), ring=ring, adaptive=adaptive))
    assert len(out) == len(chunks)
    for src, ref, got in zip(chunks, serial, out):
        assert not got.is_on_device
        assert tuple(got.voxel_offset) == tuple(src.voxel_offset)
        assert _same(got.array, ref)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", ["uint8", "bfloat16", "mixed_shapes",
                                  "postprocess", "crop_margin"])
def test_stream_bitwise_serial_cases(case, adaptive):
    kwargs = {"uint8": dict(output_dtype="uint8"),
              "bfloat16": dict(output_dtype="bfloat16"),
              "crop_margin": dict(output_patch_size=(2, 12, 12),
                                  output_patch_overlap=(1, 4, 4),
                                  crop_output_margin=True)}.get(case, {})
    inferencer = _inferencer(**kwargs)
    chunks = _chunks(RAGGED_SHAPES, seed=3)
    serial = _serial(inferencer, chunks)
    post = None
    if case == "postprocess":
        def post(chunk):
            return ("post", chunk.array)
    out = list(inferencer.stream(iter(chunks), postprocess=post,
                                 adaptive=adaptive))
    for ref, got in zip(serial, out):
        if post is not None:
            assert got[0] == "post"
            got = Chunk(got[1])
        assert _same(got.array, ref)


@pytest.mark.parametrize("adaptive", [True, False])
def test_stream_bitwise_with_telemetry_on_and_off(monkeypatch, adaptive):
    """The spans, their ring, the chunk ids and the waits they time are
    observation only: the streamed results are bitwise the same with
    ``CHUNKFLOW_TELEMETRY=0``, and only the run with telemetry on records
    spans."""
    inferencer = _inferencer(shape_bucket=(8, 16, 16))
    chunks = _chunks(RAGGED_SHAPES, seed=4)
    out = {}
    for switch in ("1", "0"):
        monkeypatch.setenv("CHUNKFLOW_TELEMETRY", switch)
        telemetry.reset()
        out[switch] = list(inferencer.stream(iter(chunks), adaptive=adaptive))
        recorded = telemetry.recorded_spans()
        assert bool(recorded) == (switch == "1")
    assert len(out["1"]) == len(out["0"]) == len(chunks)
    for on, off in zip(out["1"], out["0"]):
        assert tuple(on.voxel_offset) == tuple(off.voxel_offset)
        assert _same(on.array, off.array)


@pytest.mark.parametrize("executor", [pipeline_chunks, schedule_chunks])
def test_explicit_crop_on_the_device(executor):
    """``crop`` cuts the margin before the download: the executors give
    the serial result, cropped."""
    inferencer = _inferencer()
    chunks = _chunks(RAGGED_SHAPES, seed=2)
    serial = [inferencer(c).crop_margin((1, 2, 3)) for c in chunks]
    out = list(executor(inferencer, iter(chunks), crop=(1, 2, 3)))
    for ref, got in zip(serial, out):
        assert got.bbox == ref.bbox
        assert np.array_equal(got.array, ref.host().array)


def test_stream_matches_jax_stream():
    """Port stream vs the JAX package's stream, identity engine: bitwise
    (uint16 input rides raw in both; a padding row in the grid)."""
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 65535, s, endpoint=True).astype(np.uint16)
              for s in RAGGED_SHAPES]
    kwargs = dict(IDENTITY, num_output_channels=2, shape_bucket=(8, 16, 16))
    ref = [np.asarray(o.array) for o in JaxInferencer(**kwargs).stream(
        iter([JaxChunk(a, voxel_offset=(i, 0, 0))
              for i, a in enumerate(arrays)]))]
    got = list(Inferencer(device="cpu", **kwargs).stream(
        iter([Chunk(a, voxel_offset=(i, 0, 0))
              for i, a in enumerate(arrays)])))
    for i, (r, g) in enumerate(zip(ref, got)):
        assert np.array_equal(g.array, r)
        assert tuple(g.voxel_offset) == (i, 0, 0)


def test_caller_tensor_chunk_survives_stream():
    """A chunk the caller already holds as a tensor is not the
    executor's: streaming reads it and never writes it."""
    inferencer = _inferencer()
    host = _chunks([(8, 32, 32)], seed=5)[0]
    payload = torch.from_numpy(host.array.copy())
    caller = Chunk(payload)
    before = payload.clone()
    out = list(inferencer.stream(iter([caller, caller])))
    assert torch.equal(payload, before)
    ref = inferencer(host).host().array
    assert all(np.array_equal(o.array, ref) for o in out)


def test_stage_flags_blank_chunks_on_the_host():
    """The blank-input check is decided at stage time on the host; a blank
    chunk streams to the blank result."""
    inferencer = _inferencer()
    zero = Chunk(np.zeros((8, 32, 32), np.float32))
    staged = inferencer.stage(zero)
    assert staged._all_zero is True and staged is not zero
    assert inferencer.stage(_chunks([(8, 32, 32)])[0])._all_zero is False
    out = list(inferencer.stream(iter([zero])))[0]
    assert _same(out.array, inferencer(zero).host().array)


def test_static_mode_bypasses_scheduler(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_SCHED", "static")

    def boom(*args, **kwargs):
        raise AssertionError("static mode must not touch schedule_chunks")

    monkeypatch.setattr(scheduler, "schedule_chunks", boom)
    out = list(_inferencer().stream(iter(_chunks([(8, 32, 32)]))))
    assert len(out) == 1


# ---------------------------------------------------------------------------
# task-level stages: order, skip markers, timers, failure flushes
# ---------------------------------------------------------------------------
STAGES = {
    "static": pipelined_inference_stage,
    "adaptive": scheduled_inference_stage,
}


@pytest.mark.parametrize("kind", list(STAGES))
def test_stage_order_skip_markers_and_timers(kind):
    inferencer = _inferencer()
    chunks = _chunks(RAGGED_SHAPES, seed=7)
    serial = _serial(inferencer, chunks)
    tasks = [_task(c, i) for i, c in enumerate(chunks)]
    tasks.insert(2, None)  # skip marker mid-stream
    out = list(STAGES[kind](inferencer, depth=2, op_name="inf")(iter(tasks)))
    assert [t["i"] if t else None for t in out] == [0, 1, None, 2, 3]
    for task in out:
        if task is None:
            continue
        assert np.array_equal(task["chunk"].array, serial[task["i"]])
        assert not task["chunk"].is_on_device
        assert task["log"]["timer"]["inf"] >= 0
        assert task["log"]["compute_device"] == "cpu"


@pytest.mark.parametrize("kind", list(STAGES))
def test_stage_flushes_dispatched_on_error(kind):
    inferencer = _inferencer()
    chunks = _chunks([(8, 32, 32)] * 3, seed=9)

    def check(chunk):
        if tuple(chunk.voxel_offset)[0] == 16:  # the third task
            raise RuntimeError("bad grid")

    stage = STAGES[kind](inferencer, depth=2, op_name="inf", check=check)
    got = []
    with pytest.raises(RuntimeError, match="bad grid"):
        for task in stage(iter(_task(c, i) for i, c in enumerate(chunks))):
            got.append(task["i"])
    assert got == [0, 1]


@pytest.mark.parametrize("kind", list(STAGES))
def test_stage_upstream_exception_propagates(kind):
    inferencer = _inferencer()

    def source():
        yield _task(_chunks([(8, 32, 32)])[0], 0)
        raise RuntimeError("upstream boom")

    got = []
    with pytest.raises(RuntimeError, match="upstream boom"):
        for task in STAGES[kind](inferencer, depth=2, op_name="inf")(
                source()):
            got.append(task["i"])
    assert got == [0]


def test_scheduled_stage_failing_post_op_flushes_survivors():
    inferencer = _inferencer()
    chunks = _chunks([(8, 32, 32)] * 4, seed=11)

    def post(chunk):
        if tuple(chunk.voxel_offset)[0] == 8:  # the second task's output
            raise RuntimeError("poisoned post")
        return chunk

    stage = scheduled_inference_stage(inferencer, depth=1, ring=1,
                                      op_name="inf", postprocess=post)
    got = []
    with pytest.raises(RuntimeError, match="poisoned post"):
        for task in stage(iter(_task(c, i) for i, c in enumerate(chunks))):
            got.append(task["i"])
    assert 1 not in got and 0 in got and got == sorted(got)


@pytest.mark.parametrize("kind", list(STAGES))
def test_prefetch_to_device_then_stage_compose(kind):
    inferencer = _inferencer()
    chunks = _chunks(RAGGED_SHAPES, seed=13)
    serial = _serial(inferencer, chunks)
    stream = iter([_task(c, i) for i, c in enumerate(chunks)])
    for s in (prefetch_stage(depth=2, to_device=True, device="cpu"),
              STAGES[kind](inferencer, depth=2, op_name="inf")):
        stream = s(stream)
    out = list(stream)
    assert [t["i"] for t in out] == [0, 1, 2, 3]
    for task in out:
        assert np.array_equal(task["chunk"].array, serial[task["i"]])


def test_full_stage_chain_with_write_behind():
    """Source -> scheduled inference -> attached async writes ->
    write-behind: order, results and durable writes."""
    inferencer = _inferencer()
    chunks = _chunks([(8, 32, 32)] * 3, seed=13)
    serial = _serial(inferencer, chunks)
    committed = []
    pool = ThreadPoolExecutor(max_workers=2)

    def source(stream):
        for _seed in stream:
            for i, c in enumerate(chunks):
                yield _task(c, i)

    def attach_write(stream):
        for task in stream:
            task.setdefault("pending_writes", []).append(
                pool.submit(lambda i=task["i"]: committed.append(i)))
            yield task

    stream = iter([new_task()])
    for s in (source, scheduled_inference_stage(inferencer, op_name="inf"),
              attach_write, write_behind_stage(window=1)):
        stream = s(stream)
    out = list(stream)
    pool.shutdown()
    assert [t["i"] for t in out] == [0, 1, 2]
    for task in out:
        assert not task.get("pending_writes")
        assert np.array_equal(task["chunk"].array, serial[task["i"]])
    assert sorted(committed) == [0, 1, 2]


# ---------------------------------------------------------------------------
# the depth controller: the JAX controller's decisions
# ---------------------------------------------------------------------------
def _balanced(tel, ctl, n):
    for _ in range(n):
        for phase in ("pipeline/stage", "pipeline/compute",
                      "pipeline/drain", "scheduler/post"):
            tel.observe(phase, 0.01)
        ctl.observe_task()


def _dominant(phase, n):
    def drive(tel, ctl, _n=n):
        for _ in range(_n):
            tel.observe(phase, 0.05)
            tel.observe("pipeline/compute", 0.05 / 20)
            ctl.observe_task()
    return drive


CONTROLLER_SCENARIOS = {
    "stage_dominant": (dict(watermark_bytes=1 << 40), 0,
                       _dominant("pipeline/stage", 10)),
    "load_dominant": (dict(watermark_bytes=1 << 40), 0,
                      _dominant("scheduler/load", 10)),
    "drain_dominant": (dict(watermark_bytes=1 << 40), 0,
                       _dominant("pipeline/drain", 10)),
    "post_dominant": (dict(watermark_bytes=1 << 40), 0,
                      _dominant("scheduler/post", 9)),
    "write_dominant": (dict(watermark_bytes=1 << 40), 0,
                       _dominant("scheduler/write", 9)),
    "compute_dominant": (dict(watermark_bytes=1 << 40), 0,
                         _dominant("pipeline/compute", 12)),
    "balanced": (dict(watermark_bytes=1 << 40), 0,
                 lambda tel, ctl: _balanced(tel, ctl, 12)),
    "watermark": (dict(watermark_bytes=1024), 64 << 20,
                  _dominant("pipeline/stage", 20)),
    "tight_watermark": (dict(watermark_bytes=23 << 20), 1 << 20,
                        _dominant("scheduler/load", 20)),
    "ceilings": (dict(interval=1, watermark_bytes=1 << 40), 0,
                 _dominant("pipeline/stage", 50)),
    "raised_initials": (dict(depths={"prefetch": 9, "post": 1},
                             interval=2, watermark_bytes=1 << 40), 0,
                        _dominant("pipeline/drain", 30)),
}


@pytest.mark.parametrize("name", list(CONTROLLER_SCENARIOS))
def test_depth_controller_matches_jax(monkeypatch, name):
    kwargs, slot_bytes, drive = CONTROLLER_SCENARIOS[name]
    jax_telemetry.reset()
    jax_storage._reset_read_concurrency()
    try:
        decisions = []
        for tel, ctl_class in ((jax_telemetry, jax_scheduler.DepthController),
                               (telemetry, DepthController)):
            ctl = ctl_class(**kwargs)
            if slot_bytes:
                ctl.note_slot_bytes(slot_bytes)
            drive(tel, ctl)
            decisions.append((ctl.depths, ctl.initial, ctl.limits,
                              ctl.changes))
        assert decisions[1] == decisions[0]
    finally:
        jax_telemetry.reset()
        jax_storage._reset_read_concurrency()


def test_depth_controller_widens_the_storage_plane():
    """A load-dominant stall raises the storage knob, and the storage
    plane's block reads per wave follow it, as in the JAX package."""
    ctl = DepthController(interval=1, watermark_bytes=1 << 40)
    assert ctl.depths["storage"] == storage.read_concurrency() == 8
    _dominant("scheduler/load", 4)(telemetry, ctl)
    assert ctl.depths["storage"] == storage.read_concurrency() == 12
    assert DepthController().depths["storage"] == 12  # starts from the live value


def test_depth_controller_static_without_telemetry(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_TELEMETRY", "0")
    ctl = DepthController(watermark_bytes=1 << 40)
    _dominant("pipeline/stage", 12)(telemetry, ctl)
    assert ctl.depths == ctl.initial


def test_depth_controller_env_watermark_and_events(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_SCHED_MEM_GB", "0.000001")
    ctl = DepthController()
    assert ctl.watermark_bytes == int(0.000001 * (1 << 30))
    ctl.note_slot_bytes(1 << 20)
    _dominant("pipeline/stage", 8)(telemetry, ctl)
    assert ctl.depths == ctl.initial
    monkeypatch.setenv("CHUNKFLOW_SCHED_MEM_GB", "not-a-number")
    assert scheduler.mem_watermark_bytes() == 4 << 30
    ctl = DepthController(watermark_bytes=1 << 40)
    _dominant("pipeline/stage", 8)(telemetry, ctl)
    snap = telemetry.snapshot()
    change = [e for e in snap["events"] if e["kind"] == "depth_change"][0]
    assert change["name"] == "scheduler/prefetch"
    assert change["new"] == change["old"] + 1
    assert snap["gauges"]["scheduler/depth/prefetch"] >= change["new"]


def test_host_reservations_hold_growth(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_SCHED_MEM_GB", "1")
    assert scheduler.reserve_host_bytes(1 << 30)
    try:
        assert not scheduler.reserve_host_bytes(1)
        ctl = DepthController()
        _dominant("pipeline/stage", 8)(telemetry, ctl)
        assert ctl.depths == ctl.initial
    finally:
        scheduler.release_host_bytes(1 << 30)
    assert scheduler.external_resident_bytes() == 0


def test_queue_capacity_widens_live():
    q = scheduler._AdaptiveQueue(1)
    assert q.put("a")
    q.set_capacity(3)
    assert q.put("b") and q.put("c")
    assert [q.get(), q.get(), q.get()] == ["a", "b", "c"]
    q.close()
    assert not q.put("d")


def test_scheduler_mode_env_values(monkeypatch):
    assert scheduler_mode() == "adaptive"
    for value in ("static", "0", "off", "STATIC"):
        monkeypatch.setenv("CHUNKFLOW_SCHED", value)
        assert scheduler_mode() == "static"
    monkeypatch.setenv("CHUNKFLOW_SCHED", "adaptive")
    assert scheduler_mode() == "adaptive"


def test_sample_device_memory_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scheduler.sample_device_memory()
    assert not telemetry.snapshot()["gauges"]


# ---------------------------------------------------------------------------
# write-behind, drain hardening, process_stream
# ---------------------------------------------------------------------------
class _Write:
    def __init__(self, log, tag, exc=None):
        self.log, self.tag, self.exc = log, tag, exc

    def result(self):
        self.log.append(self.tag)
        if self.exc is not None:
            raise self.exc


def test_drain_pending_writes_drains_every_future():
    drained = []
    task = {"pending_writes": [
        _Write(drained, 0), _Write(drained, 1, RuntimeError("first")),
        _Write(drained, 2, ValueError("second")), _Write(drained, 3)]}
    with pytest.raises(RuntimeError, match="first"):
        drain_pending_writes(task)
    assert drained == [0, 1, 2, 3] and "pending_writes" not in task


def test_write_behind_overlaps_and_preserves_order():
    pool = ThreadPoolExecutor(max_workers=4)
    log = []

    def tasks():
        for i in range(5):
            t = new_task()
            t["i"] = i
            t["pending_writes"] = [pool.submit(time.sleep, 0.01)]
            log.append(("in", i))
            yield t

    out = []
    for task in write_behind_stage(window=2)(tasks()):
        log.append(("out", task["i"]))
        out.append(task["i"])
        assert not task.get("pending_writes")
    pool.shutdown()
    assert out == [0, 1, 2, 3, 4]
    assert log.index(("out", 0)) > log.index(("in", 2))


@pytest.mark.parametrize("ending", ["markers", "abandon", "upstream_error"])
def test_write_behind_commits_on_every_exit(ending):
    committed = []

    def tasks():
        for i in range(3):
            t = new_task()
            t["i"] = i
            t["pending_writes"] = [_Write(committed, i)]
            yield t
        if ending == "markers":
            yield None
        if ending == "upstream_error":
            raise RuntimeError("upstream died")

    gen = write_behind_stage(window=8)(tasks())
    if ending == "markers":
        out = list(gen)
        assert [t["i"] if t else None for t in out] == [0, 1, 2, None]
    elif ending == "abandon":
        gen = write_behind_stage(window=1)(tasks())
        next(gen)
        gen.close()
    else:
        with pytest.raises(RuntimeError, match="upstream died"):
            list(gen)
    assert committed == sorted(committed) and len(committed) >= 2
    if ending != "abandon":
        assert committed == [0, 1, 2]


@pytest.mark.parametrize("mode", ["adaptive", "static"])
def test_process_stream_commits_every_task(monkeypatch, mode):
    monkeypatch.setenv("CHUNKFLOW_SCHED", mode)
    committed = []

    def source(stream):
        for _seed in stream:
            for i in range(3):
                t = new_task()
                t["pending_writes"] = [_Write(committed, i)]
                yield t

    assert process_stream([source]) == 3
    assert committed == [0, 1, 2]


# ---------------------------------------------------------------------------
# telemetry under threads
# ---------------------------------------------------------------------------
def test_telemetry_registry_under_threads():
    """More threads than cores, a short switch interval: no lost update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                telemetry.inc("t/count")
                with telemetry.span("t/span"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = telemetry.snapshot()
    assert snap["counters"]["t/count"] == 32000
    assert snap["hists"]["t/span"]["count"] == 32000
    assert telemetry.hist_totals(["t/span", "t/none"])["t/none"] == 0.0


def test_task_context_binds_trace_ids():
    with telemetry.task_context("a"):
        with telemetry.task_context(None):
            assert telemetry.current_trace_id() == "a"
            telemetry.event("kind", "name", x=1)
    assert telemetry.current_trace_id() is None
    assert telemetry.snapshot()["events"][0]["trace_id"] == "a"


# ---------------------------------------------------------------------------
# the task grid and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(chunk_size=(16, 48, 48), roi_stop=(16, 96, 48)),
    dict(chunk_size=(8, 32, 32), overlap=(2, 8, 8), roi_size=(20, 70, 50)),
    dict(chunk_size=(8, 32, 32), stride=(6, 24, 24), grid_size=(2, 3, 1),
         roi_start=(1, 2, 3)),
    dict(chunk_size=(8, 32, 32), overlap=(2, 8, 8), roi_stop=(20, 70, 50),
         bounded=True),
    dict(chunk_size=(8, 32, 32), roi_start=(3, 5, 7), roi_stop=(30, 90, 50),
         aligned_block_size=(4, 16, 16), block_offset=(1, 1, 1)),
])
def test_task_grid_matches_jax(kwargs):
    ref = JaxBoxes.from_manual_setup(**kwargs)
    got = BoundingBoxes.from_manual_setup(**kwargs)
    assert [b.string for b in got] == [b.string for b in ref]
    assert len(got) == len(ref)
    for attr in ("chunk_size", "overlap", "stride", "grid_size"):
        assert tuple(getattr(got, attr)) == tuple(getattr(ref, attr))
    assert got.roi.string == ref.roi.string
    box = got[0]
    assert BoundingBox.from_string(f"0-3_{box.string}.npy") == box


def _cli_argv(depth, out, extra=()):
    return ["generate-tasks", "-c", "9", "35", "33", "-g", "1", "1", "3",
            "create-chunk", "--size", "9", "35", "33", "--dtype", "uint16",
            "--pattern", "random",
            "inference", "-f", "identity", "-p", "4", "16", "16",
            "-v", "2", "8", "8", "-c", "2", "-b", "2",
            "--async-depth", str(depth), *extra,
            "save-npy", "-f", str(out)]


@pytest.mark.parametrize("blend", ["scatter", "fold"])
def test_cli_async_depth_matches_sync_and_jax(monkeypatch, tmp_path, capsys,
                                              blend):
    from click.testing import CliRunner

    from chunkflow_tpu.flow.cli import main as jax_main

    extra = ("--blend", blend)
    sync = tmp_path / "sync.npy"
    assert cli.main(["--device", "cpu", "-v", *_cli_argv(1, sync, extra)]) \
        == 0
    assert "pipeline drained 3 task(s)" in capsys.readouterr().out
    runs = {}
    for mode in ("adaptive", "static"):
        monkeypatch.setenv("CHUNKFLOW_SCHED", mode)
        out = tmp_path / f"{mode}.npy"
        assert cli.main(["--device", "cpu", "-v",
                         *_cli_argv(3, out, extra)]) == 0
        assert "pipeline drained 3 task(s)" in capsys.readouterr().out
        runs[mode] = np.load(out)
    want = np.load(sync)
    for mode, got in runs.items():
        assert np.array_equal(got, want), mode
    if blend == "fold":
        return  # the compiled JAX fold is held within ulps in test_torch_fold
    jax_out = tmp_path / "jax.npy"
    result = CliRunner().invoke(jax_main, _cli_argv(3, jax_out, extra),
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert np.array_equal(np.load(jax_out), want)


def test_cli_generate_tasks_and_create_bbox(tmp_path, capsys):
    out = tmp_path / "out.npy"
    argv = ["--device", "cpu", "-v", "generate-tasks", "-c", "8", "32", "32",
            "--roi-stop", "8", "64", "32", "--task-index-start", "1",
            "create-bbox", "-s", "0", "0", "0", "--size", "8", "32", "32",
            "create-chunk", "--size", "8", "32", "32",
            "inference", "-f", "identity", "-p", "4", "16", "16",
            "-v", "2", "8", "8", "-c", "1", "--async-depth", "2",
            "save-npy", "-f", str(out)]
    assert cli.main(argv) == 0
    assert "pipeline drained 1 task(s)" in capsys.readouterr().out
    one_task = ["--device", "cpu", "generate-tasks", "-c", "8", "8", "8",
                "-g", "1", "1", "1"]
    # a gs:// volume's bounds are read from its info (a local fake)
    from chunkflow_tpu_torch.testing import cloud_fakes
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    with cloud_fakes.FakeGCS() as gcs, pytest.MonkeyPatch.context() as mp:
        for key, value in cloud_fakes.cloud_env(gcs=gcs.url).items():
            mp.setenv(key, value)
        mp.setenv("HOME", str(tmp_path / "home"))
        mp.delenv("GOOGLE_APPLICATION_CREDENTIALS", raising=False)
        PrecomputedVolume.create("gs://bucket/v", volume_size=(8, 16, 8),
                                 voxel_size=(1, 1, 1), voxel_offset=(0, 8, 0),
                                 block_size=(8, 8, 8))
        gs_file = tmp_path / "gs.txt"
        assert cli.main(["--device", "cpu", "generate-tasks", "-c", "8", "8",
                         "8", "--volume-path", "gs://bucket/v",
                         "--task-file", str(gs_file)]) == 0
        assert gs_file.read_text() == "0-8_8-16_0-8\n0-8_16-24_0-8\n"
    task_file = tmp_path / "t.txt"
    assert cli.main(one_task + ["--task-file", str(task_file)]) == 0
    assert task_file.read_text() == "0-8_0-8_0-8\n"
    queue = f"file://{tmp_path / 'q'}"
    assert cli.main(one_task + ["--queue-name", queue]) == 0
    from chunkflow_tpu_torch.parallel.queues import open_queue

    assert len(open_queue(queue)) == 1


@pytest.mark.parametrize("mode", ["adaptive", "static"])
def test_cli_streamed_usage_error_exits(monkeypatch, tmp_path, mode):
    """A --patch-num mismatch raised inside a streaming stage (an
    Exception, so the stage flushes first) still ends the run with the
    message."""
    monkeypatch.setenv("CHUNKFLOW_SCHED", mode)
    argv = _cli_argv(3, tmp_path / "out.npy", ("--patch-num", "9", "9", "9"))
    with pytest.raises(SystemExit, match="--patch-num"):
        cli.main(["--device", "cpu", *argv])
