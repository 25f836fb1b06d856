"""Double-buffered chunk pipeline: upload / compute / download overlap.

The counterpart of ``chunkflow_tpu/flow/pipeline.py``, the static
executor: fixed depths, chosen by the caller. A worker's loop is load,
infer, save, repeat; run serially, the card idles during every copy.
Here chunk k+1 is staged (``Inferencer.stage``: pinned host copy, then
an asynchronous copy on the inferencer's upload stream) and chunk k-1's
result downloads (started by ``Inferencer.infer_async`` on the download
stream) while chunk k computes on the dispatching thread's stream::

    host:    stage k+1 ──────▶ stage k+2 ─────▶ ...
    device:  compute k ───────▶ compute k+1 ──▶ ...
    D2H:     drain k−1 ───────▶ drain k ──────▶ ...

The host waits only at drain time: ``pipeline/compute`` is the wait on
the result's compute-done event (the device was still busy: a
compute-bound pipeline stalls here), ``pipeline/drain`` the wait on its
download event.

Memory bound: at most ``ring`` staged inputs plus ``ring`` (or
``depth``, for the task stage) dispatched outputs are on the device.

Ownership: a chunk staged by the executor belongs to it and is
dispatched with ``consume=True``; a chunk that arrived already on the
device stays the caller's. The port never writes into an input chunk, so
both survive; the flag records the contract. ``flow/scheduler.py``
builds the adaptive scheduler on the same spans and contract.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterable, Iterator, Optional

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel.lifecycle import tag_culprit
from chunkflow_tpu_torch.testing import chaos


def _drain_host(out):
    """Materialize a dispatched output on the host, attributing the wait:
    ``pipeline/compute`` until the device finished computing it,
    ``pipeline/drain`` until its download landed. Counts the voxels
    (``inference/voxels``) for an achieved-rate reading."""
    with telemetry.span("pipeline/compute"):
        out.wait_computed()
    with telemetry.span("pipeline/drain"):
        host = out.host()
    shape = getattr(getattr(host, "array", None), "shape", None)
    if shape:
        voxels = 1
        for length in shape[-3:]:
            voxels *= int(length)
        telemetry.inc("inference/voxels", float(voxels))
    return host


def _device_pipeline(inferencer, chunks: Iterable, ring: int, crop=None):
    """Yield dispatched output chunks (download started) in input order,
    overlapping stage(k+1) / compute(k) / drain(k-1)."""
    ring = max(1, int(ring))
    staged: deque = deque()    # ring slots: (staged_chunk, pipeline_owned)
    draining: deque = deque()  # dispatched outputs, downloads in flight
    it = iter(chunks)
    exhausted = False
    while True:
        while not exhausted and len(staged) < ring:
            try:
                chunk = next(it)
            except StopIteration:
                exhausted = True
                break
            with telemetry.span("pipeline/stage"):
                slot = inferencer.stage(chunk)
            staged.append((slot, slot is not chunk))
            telemetry.gauge("pipeline/ring_occupancy", len(staged))
        if not staged:
            break
        slot, owned = staged.popleft()
        with telemetry.span("pipeline/dispatch"):
            out = inferencer.infer_async(slot, crop=crop, consume=owned)
        draining.append(out)
        telemetry.gauge("pipeline/inflight", len(draining))
        while len(draining) >= ring:
            yield draining.popleft()
    while draining:
        yield draining.popleft()


def pipeline_chunks(
    inferencer,
    chunks: Iterable,
    ring: int = 2,
    crop=None,
    postprocess: Optional[Callable] = None,
    post_depth: int = 2,
) -> Iterator:
    """Run chunks through the double-buffered executor; yield results in
    input order.

    Without ``postprocess``: host-resident output chunks; the only waits
    are the drain-time ones. With ``postprocess`` (``Chunk -> T``): the
    drain waits and the post-processing move to a worker thread, at most
    ``post_depth`` in flight, overlapping the next chunk's device time;
    abandoning the generator cancels queued (not started) post tasks.
    """
    if postprocess is None:
        for out in _device_pipeline(inferencer, chunks, ring, crop=crop):
            yield _drain_host(out)
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        in_flight: deque = deque()
        try:
            for out in _device_pipeline(inferencer, chunks, ring, crop=crop):
                while len(in_flight) >= post_depth:
                    yield in_flight.popleft().result()
                in_flight.append(
                    pool.submit(lambda c=out: postprocess(_drain_host(c))))
            while in_flight:
                yield in_flight.popleft().result()
        finally:
            # early close / error: do not run abandoned post tasks
            for f in in_flight:
                f.cancel()


def stage_task_chunks(task: dict, device="cuda") -> dict:
    """Start the upload of every host chunk in a task dict to ``device``
    (``prefetch --to-device``)."""
    for key, value in list(task.items()):
        if hasattr(value, "device") and hasattr(value, "is_on_device"):
            if not value.is_on_device:
                task[key] = value.device(device)
    return task


def pipelined_inference_stage(
    inferencer,
    depth: int = 2,
    ring: int = 2,
    input_name: str = "chunk",
    output_name: str = "chunk",
    op_name: str = "inference",
    crop=None,
    check: Optional[Callable] = None,
):
    """A runtime stage (iterator of tasks -> iterator of tasks) that runs
    each task's chunk through the double-buffered executor.

    ``depth`` bounds dispatched-but-undrained outputs (the CLI's
    ``--async-depth``), ``ring`` staged-ahead inputs. ``check`` (the
    --patch-num assertion) runs before a task enters the ring. Results
    yield in input order; a ``None`` skip marker flushes all in-flight
    work first; a mid-stream exception flushes the already-dispatched
    tasks downstream, then re-raises. Per-op timers measure
    stage-to-materialize wall time, which overlaps across tasks. Each
    dispatch is the chaos point ``op/<op_name>``, and a failure is
    charged to its task.
    """
    depth = max(1, int(depth))
    ring = max(1, int(ring))

    def stage_fn(stream):
        staged: deque = deque()   # (task, staged_chunk, owned, t0)
        pending: deque = deque()  # (task, device_out, t0)

        def finalize(entry):
            task, out, t0 = entry
            try:
                task[output_name] = _drain_host(out)
            except BaseException as exc:
                tag_culprit(exc, task)
                raise
            task["log"]["timer"][op_name] = time.time() - t0
            task["log"]["compute_device"] = inferencer.compute_device
            return task

        def dispatch_one():
            task, slot, owned, t0 = staged.popleft()
            try:
                chaos.chaos_point(f"op/{op_name}")
                with telemetry.span("pipeline/dispatch"):
                    out = inferencer.infer_async(slot, crop=crop,
                                                 consume=owned)
            except BaseException as exc:
                tag_culprit(exc, task)
                raise
            pending.append((task, out, t0))
            telemetry.gauge("pipeline/inflight", len(pending))

        try:
            for task in stream:
                if task is None:
                    # preserve order: flush in-flight work first
                    while staged:
                        dispatch_one()
                    while pending:
                        yield finalize(pending.popleft())
                    yield task
                    continue
                chunk = task[input_name]
                try:
                    if check is not None:
                        check(chunk)
                    with telemetry.span("pipeline/stage"):
                        slot = inferencer.stage(chunk)
                except BaseException as exc:
                    tag_culprit(exc, task)
                    raise
                staged.append((task, slot, slot is not chunk, time.time()))
                telemetry.gauge("pipeline/ring_occupancy", len(staged))
                if len(staged) >= ring:
                    # drain BEFORE dispatching: at most `depth` outputs in
                    # flight (the memory bound)
                    while len(pending) >= depth:
                        yield finalize(pending.popleft())
                    dispatch_one()
        except Exception:
            # a mid-stream failure must not drop tasks already dispatched
            # (the serial path would have finished them); except, not
            # finally: a yield in finally breaks generator close()
            while staged:
                dispatch_one()
            while pending:
                yield finalize(pending.popleft())
            raise
        while staged:
            while len(pending) >= depth:
                yield finalize(pending.popleft())
            dispatch_one()
        while pending:
            yield finalize(pending.popleft())

    return stage_fn
