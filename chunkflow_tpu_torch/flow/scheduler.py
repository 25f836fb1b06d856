"""Adaptive pipeline scheduler: bounded queues with telemetry-driven depths.

The counterpart of ``chunkflow_tpu/flow/scheduler.py``::

    upstream (load ops) ──► prefetch queue ──► upload ring ──►
    device compute ──► download + host post-processing (worker pool)
    ──► downstream (save ops) ──► write-behind window

Every arrow is a bounded queue, every bound a depth knob that
:class:`DepthController` widens at run time from the telemetry stall
shares (``core/telemetry.py``) every few tasks:

=====================  =======================  =========================
dominant stall phase   meaning                  knob raised
=====================  =======================  =========================
scheduler/load         upstream IO starves us   ``prefetch``, ``storage``
pipeline/stage         uploads wait             ``prefetch``
pipeline/dispatch      enqueue time             none
pipeline/compute       the card is the limit    none — that's the goal
pipeline/drain         download + host lag      ``post`` and ``write``
scheduler/post         host post ops lag        ``post``
scheduler/write        storage commits lag      ``write``
=====================  =======================  =========================

Growth stops at a host-memory watermark (``CHUNKFLOW_SCHED_MEM_GB``,
default 4): resident bytes are estimated as (sum of depths) x 2 x (the
largest chunk seen), plus what other planes reserved
(:func:`reserve_host_bytes`). With telemetry off there is no stall
signal and the depths stay static. ``CHUNKFLOW_SCHED=static`` takes the
scheduler off the path: ``Inferencer.stream`` and the CLI run the static
executor (``flow/pipeline.py``). Results are bitwise the same either
way; the threads change when work happens, never what is computed.

The ``storage`` knob is the storage plane's block-read parallelism
(``volume/storage.py:set_read_concurrency``): it starts from what the
plane reads per wave and a raise takes effect on the next cutout. Tasks
left in a queue when a stage closes are surrendered
(``lifecycle.surrender_task``): a claimed task hands its lease back
instead of holding it until the visibility timeout. The stages carry the
chaos points ``op/<name>`` and ``scheduler/dispatch`` (at dispatch) and
``scheduler/post`` (in the post pool), and charge a failure to its task.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import torch

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.flow.pipeline import _drain_host
from chunkflow_tpu_torch.parallel.lifecycle import surrender_task, tag_culprit
from chunkflow_tpu_torch.testing import chaos
from chunkflow_tpu_torch.volume import storage

__all__ = [
    "scheduler_mode", "mem_watermark_bytes", "DepthController",
    "schedule_chunks", "scheduled_inference_stage", "write_behind_stage",
    "sample_device_memory", "reserve_host_bytes", "release_host_bytes",
    "external_resident_bytes",
]

_OFF_VALUES = ("static", "0", "off", "false", "no")


def scheduler_mode() -> str:
    """``adaptive`` (default) or ``static`` (``CHUNKFLOW_SCHED=static``),
    re-read per call."""
    value = os.environ.get("CHUNKFLOW_SCHED", "adaptive").lower()
    return "static" if value in _OFF_VALUES else "adaptive"


def mem_watermark_bytes() -> int:
    """The host-memory watermark of depth growth
    (``CHUNKFLOW_SCHED_MEM_GB``, default 4 GB; a malformed value falls
    back to the default rather than disabling backpressure)."""
    raw = os.environ.get("CHUNKFLOW_SCHED_MEM_GB", "")
    try:
        gb = float(raw) if raw else 4.0
    except ValueError:
        gb = 4.0
    return int(gb * (1 << 30))


# ---------------------------------------------------------------------------
# host-memory reservations of planes outside the executor
# ---------------------------------------------------------------------------
_EXT_LOCK = threading.Lock()
_EXT_BYTES = 0


def reserve_host_bytes(nbytes: int) -> bool:
    """Reserve host bytes against the watermark for a plane outside the
    executor; False (nothing reserved) when it would cross it. The depth
    controller counts these reservations too."""
    global _EXT_BYTES
    nbytes = max(0, int(nbytes))
    with _EXT_LOCK:
        if _EXT_BYTES + nbytes > mem_watermark_bytes():
            return False
        _EXT_BYTES += nbytes
        total = _EXT_BYTES
    telemetry.gauge("scheduler/external_bytes", total)
    return True


def release_host_bytes(nbytes: int) -> None:
    """Return a :func:`reserve_host_bytes` reservation."""
    global _EXT_BYTES
    nbytes = max(0, int(nbytes))
    with _EXT_LOCK:
        _EXT_BYTES = max(0, _EXT_BYTES - nbytes)
        total = _EXT_BYTES
    telemetry.gauge("scheduler/external_bytes", total)


def external_resident_bytes() -> int:
    with _EXT_LOCK:
        return _EXT_BYTES


def _controller_interval() -> int:
    """Tasks between controller ticks (``CHUNKFLOW_SCHED_INTERVAL``,
    default 4)."""
    try:
        return max(1, int(os.environ.get("CHUNKFLOW_SCHED_INTERVAL", "4")))
    except ValueError:
        return 4


#: initial depths when the caller does not set them; the CLI passes
#: --prefetch-depth / --async-depth in as initial values
DEFAULT_DEPTHS = {
    "prefetch": 2,  # tasks pulled ahead from upstream
    "ring": 2,      # staged-ahead uploads
    "inflight": 2,  # dispatched-but-undrained outputs
    "post": 2,      # drain + host post-processing tasks in the pool
    "write": 2,     # tasks with storage writes still in flight
    "storage": 8,   # concurrent block reads per cutout
}

#: growth ceilings — past these, more depth is more memory for no overlap
DEPTH_LIMITS = {
    "prefetch": 8, "ring": 4, "inflight": 8, "post": 4, "write": 8,
    "storage": 32,
}

#: stall phase -> knobs the controller widens when that phase dominates
PHASE_KNOBS = {
    "scheduler/load": ("prefetch", "storage"),
    "pipeline/stage": ("prefetch",),
    "pipeline/dispatch": (),
    "pipeline/compute": (),
    "pipeline/drain": ("post", "write"),
    "scheduler/post": ("post",),
    "scheduler/write": ("write",),
}


class DepthController:
    """Widens the dominant stall phase's depths under a memory watermark.

    :meth:`tick` takes *cumulative* per-phase stall totals (seconds) and
    updates :attr:`depths`; :meth:`observe_task` reads the telemetry
    registry every ``interval`` completed tasks and ticks.
    """

    PHASES = tuple(PHASE_KNOBS)

    def __init__(self, depths: Optional[dict] = None,
                 limits: Optional[dict] = None,
                 interval: Optional[int] = None,
                 watermark_bytes: Optional[int] = None,
                 min_share: float = 0.4):
        self.depths = dict(DEFAULT_DEPTHS)
        if depths:
            self.depths.update({k: max(1, int(v)) for k, v in depths.items()})
        # a caller-raised initial depth also raises that knob's ceiling
        self.limits = {
            k: max(v, self.depths.get(k, 0))
            for k, v in dict(DEPTH_LIMITS, **(limits or {})).items()
        }
        # the storage knob starts from the storage plane's live value, so
        # a raise widens it rather than clamping it back
        if not depths or "storage" not in depths:
            self.depths["storage"] = max(self.depths.get("storage", 1),
                                         storage.read_concurrency())
        self.limits["storage"] = max(self.limits.get("storage", 1),
                                     self.depths["storage"])
        self.initial = dict(self.depths)
        self.interval = interval if interval else _controller_interval()
        self.watermark_bytes = (watermark_bytes if watermark_bytes is not None
                                else mem_watermark_bytes())
        self.min_share = min_share
        self.changes: list = []  # (task_index, knob, old, new)
        self._slot_bytes = 0
        self._tasks = 0
        # deltas measure THIS run's stalls, not what the registry held
        self._last_totals = telemetry.hist_totals(self.PHASES)

    def note_slot_bytes(self, nbytes: int) -> None:
        """Feed a chunk's payload size; the watermark uses the largest."""
        self._slot_bytes = max(self._slot_bytes, int(nbytes))

    def resident_slots(self) -> int:
        # storage is block-read parallelism, not a chunk-sized slot
        return sum(v for k, v in self.depths.items() if k != "storage")

    def _would_fit(self) -> bool:
        # 2x: each slot can hold an input and an output chunk at once
        per_slot = 2 * max(self._slot_bytes, 1)
        return ((self.resident_slots() + 1) * per_slot
                + external_resident_bytes() <= self.watermark_bytes)

    def tick(self, totals: dict) -> list:
        """One step over cumulative stall totals; returns the (knob, old,
        new) changes applied (none when nothing dominates, the watermark
        or a ceiling blocks growth, or the phase has no knob)."""
        deltas = {
            phase: max(0.0, float(totals.get(phase, 0.0))
                       - self._last_totals.get(phase, 0.0))
            for phase in self.PHASES
        }
        self._last_totals = {
            phase: float(totals.get(phase, self._last_totals.get(phase, 0.0)))
            for phase in self.PHASES
        }
        window = sum(deltas.values())
        if window <= 0.0:
            return []
        dominant = max(deltas, key=deltas.get)
        share = deltas[dominant] / window
        if share < self.min_share:
            return []  # no clear bottleneck: the depths are matched
        applied = []
        for knob in PHASE_KNOBS[dominant]:
            old = self.depths[knob]
            if old >= self.limits[knob] or not self._would_fit():
                continue
            self.depths[knob] = old + 1
            if knob == "storage":
                storage.set_read_concurrency(old + 1)
            applied.append((knob, old, old + 1))
            self.changes.append((self._tasks, knob, old, old + 1))
            telemetry.event(
                "depth_change", f"scheduler/{knob}", old=old, new=old + 1,
                tasks=self._tasks, dominant=dominant, share=round(share, 3))
            telemetry.gauge(f"scheduler/depth/{knob}", old + 1)
        return applied

    def observe_task(self) -> list:
        """Count one completed task; every ``interval`` tasks, tick on the
        registry's totals."""
        self._tasks += 1
        if self._tasks % self.interval:
            return []
        return self.tick(telemetry.hist_totals(self.PHASES))


# ---------------------------------------------------------------------------
# bounded handoff queue with a live-adjustable capacity
# ---------------------------------------------------------------------------
_END = object()


def _is_end(item) -> bool:
    return isinstance(item, tuple) and len(item) == 2 and item[0] is _END


class _AdaptiveQueue:
    """Producer/consumer handoff whose capacity the controller can raise
    live (``queue.Queue`` fixes ``maxsize`` at construction)."""

    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._items: deque = deque()
        self._capacity = max(1, int(capacity))
        self._closed = False

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._capacity = max(1, int(capacity))
            self._not_full.notify_all()

    def put(self, item) -> bool:
        """Bounded put; False once the consumer closed the queue (the
        producer should stop pulling upstream)."""
        with self._not_full:
            while len(self._items) >= self._capacity and not self._closed:
                self._not_full.wait(0.1)
            if self._closed:
                return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    def get(self):
        with self._not_empty:
            while not self._items:
                self._not_empty.wait()
            item = self._items.popleft()
            self._not_full.notify()
            return item

    def close(self) -> None:
        """Consumer side: retire the producer for good and surrender what
        is buffered (a claimed task hands its lease back)."""
        with self._lock:
            self._closed = True
            leftovers = list(self._items)
            self._items.clear()
            self._not_full.notify_all()
            self._not_empty.notify_all()
        for item in leftovers:
            if not _is_end(item):
                _surrender(item)


def _surrender(item) -> None:
    """Surrender the task of a queue item: a task, or a tuple that starts
    with one (the staged items of the executors)."""
    surrender_task(item[0] if isinstance(item, tuple) and item else item)


def _pump(source: Iterator, q: _AdaptiveQueue) -> None:
    """Producer body: pull upstream (where load IO runs) into the queue;
    end with an (_END, exc) sentinel on every path, so the consumer never
    waits forever. An item the closed queue refuses is surrendered: it may
    be a task claimed after the failure handler settled the in-flight
    set."""
    try:
        for item in source:
            if not q.put(item):
                _surrender(item)
                return  # consumer gone: stop pulling upstream
    except BaseException as exc:  # re-raised in the consumer thread
        q.put((_END, exc))
        return
    q.put((_END, None))


def _start_pump(source: Iterable, capacity: int):
    q = _AdaptiveQueue(capacity)
    thread = threading.Thread(target=_pump, args=(iter(source), q),
                              daemon=True)
    thread.start()
    return q, thread


def _chunk_nbytes(chunk) -> int:
    arr = getattr(chunk, "array", chunk)
    return int(getattr(arr, "nbytes", 0) or 0)


# ---------------------------------------------------------------------------
# device-memory gauges, sampled at drain time
# ---------------------------------------------------------------------------
def sample_device_memory() -> None:
    """Fold each CUDA device's memory into gauges beside the host
    watermark: ``device/chip/<i>/bytes_in_use`` and ``peak_bytes`` (the
    caching allocator's, ``torch.cuda.memory_stats``) and ``hbm_headroom``
    (free device memory, ``torch.cuda.mem_get_info``), plus the sums
    ``device/bytes_in_use`` / ``device/peak_bytes`` and the worst
    device's ``device/hbm_headroom``. Nothing without a card or with
    telemetry off; neither call waits for the device."""
    if not telemetry.enabled() or not torch.cuda.is_available():
        return
    in_use_total = peak_total = 0
    headrooms = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", 0))
        free, _total = torch.cuda.mem_get_info(i)
        in_use_total += in_use
        peak_total += peak
        headrooms.append(int(free))
        telemetry.gauge(f"device/chip/{i}/bytes_in_use", in_use)
        telemetry.gauge(f"device/chip/{i}/peak_bytes", peak)
        telemetry.gauge(f"device/chip/{i}/hbm_headroom", int(free))
    telemetry.gauge("device/bytes_in_use", in_use_total)
    telemetry.gauge("device/peak_bytes", peak_total)
    if headrooms:
        telemetry.gauge("device/hbm_headroom", min(headrooms))


# ---------------------------------------------------------------------------
# chunk-level executor (powers Inferencer.stream)
# ---------------------------------------------------------------------------
def _staged(inferencer, chunks: Iterable, ctl: DepthController):
    """Stage each chunk as it is pulled: run by the prefetch thread, so the
    upload's host work (the blank check, the pinned copy) overlaps the
    dispatching thread's launches, which on the card can take longer
    than the device work they enqueue. Yields (chunk, staged chunk)."""
    for chunk in chunks:
        ctl.note_slot_bytes(_chunk_nbytes(chunk))
        with telemetry.span("pipeline/stage"):
            slot = inferencer.stage(chunk)
        yield chunk, slot


def _adaptive_device_pipeline(inferencer, q: _AdaptiveQueue,
                              ctl: DepthController, crop=None):
    """Yield dispatched outputs in input order, pulling staged inputs from
    the prefetch queue; the ring and inflight bounds are re-read every
    iteration, so a widen takes effect mid-run."""
    staged: deque = deque()    # (slot, pipeline_owned)
    draining: deque = deque()  # dispatched outputs, downloads in flight
    exhausted = False
    while True:
        while not exhausted and len(staged) < ctl.depths["ring"]:
            with telemetry.span("scheduler/load"):
                item = q.get()
            if _is_end(item):
                exhausted = True
                if item[1] is not None:
                    raise item[1]  # upstream failure re-raises here
                break
            chunk, slot = item
            staged.append((slot, slot is not chunk))
            telemetry.gauge("pipeline/ring_occupancy", len(staged))
        if not staged:
            break
        slot, owned = staged.popleft()
        with telemetry.span("pipeline/dispatch"):
            out = inferencer.infer_async(slot, crop=crop, consume=owned)
        draining.append(out)
        telemetry.gauge("pipeline/inflight", len(draining))
        while len(draining) >= ctl.depths["inflight"]:
            yield draining.popleft()
    while draining:
        yield draining.popleft()


def schedule_chunks(
    inferencer,
    chunks: Iterable,
    ring: int = 2,
    crop=None,
    postprocess: Optional[Callable] = None,
    post_depth: int = 2,
    prefetch_depth: int = 2,
    controller: Optional[DepthController] = None,
) -> Iterator:
    """Adaptive drop-in for :func:`flow.pipeline.pipeline_chunks`: same
    inputs, same input-order outputs, bitwise the same results — plus a
    prefetch thread (the ``chunks`` iterable's own IO runs
    ``prefetch_depth`` items ahead) and the drain + ``postprocess`` step
    in a worker pool, every depth under the controller. Abandoning the
    generator cancels queued post tasks and retires the prefetch
    thread."""
    from concurrent.futures import ThreadPoolExecutor

    ctl = controller or DepthController(depths={
        "prefetch": prefetch_depth, "ring": ring, "inflight": ring,
        "post": post_depth,
    })
    q, thread = _start_pump(_staged(inferencer, chunks, ctl),
                            ctl.depths["prefetch"])
    in_flight: deque = deque()
    pool = ThreadPoolExecutor(max_workers=ctl.limits["post"])

    def finalize(out):
        host = _drain_host(out)
        if postprocess is None:
            return host
        with telemetry.span("scheduler/post"):
            return postprocess(host)

    def complete(future):
        result = future.result()
        ctl.observe_task()
        sample_device_memory()
        q.set_capacity(ctl.depths["prefetch"])
        return result

    try:
        for out in _adaptive_device_pipeline(inferencer, q, ctl, crop=crop):
            while len(in_flight) >= ctl.depths["post"]:
                yield complete(in_flight.popleft())
            in_flight.append(pool.submit(finalize, out))
        while in_flight:
            yield complete(in_flight.popleft())
    finally:
        q.close()
        for f in in_flight:
            f.cancel()
        pool.shutdown(wait=False)
        thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# task-level executor (powers the CLI inference stage)
# ---------------------------------------------------------------------------
def scheduled_inference_stage(
    inferencer,
    depth: int = 2,
    ring: int = 2,
    prefetch_depth: int = 2,
    input_name: str = "chunk",
    output_name: str = "chunk",
    op_name: str = "inference",
    crop=None,
    check: Optional[Callable] = None,
    postprocess: Optional[Callable] = None,
    controller: Optional[DepthController] = None,
):
    """The scheduler as a runtime stage: the adaptive superset of
    :func:`flow.pipeline.pipelined_inference_stage`. Upstream stages run
    in a prefetch thread ``prefetch_depth`` tasks ahead, which also runs
    ``check`` and stages each task's chunk; the drain (and
    ``postprocess`` on the output chunk) runs in a worker pool; every
    bound widens under the controller.

    Order and failures as in the static stage: results in input order; a
    ``None`` skip marker flushes in-flight work first; a mid-stream
    exception — upstream, in ``check``, or in a post op — flushes the
    surviving in-flight tasks downstream, then re-raises the first.
    """
    ctl_arg = controller

    def stage_fn(stream):
        from concurrent.futures import ThreadPoolExecutor

        ctl = ctl_arg or DepthController(depths={
            "prefetch": prefetch_depth, "ring": ring, "inflight": depth,
        })
        def staged_tasks():
            # the prefetch thread's side: (task, staged chunk, owned, t0)
            for task in stream:
                if task is None:
                    yield None
                    continue
                t0 = time.time()
                try:
                    chunk = task[input_name]
                    if check is not None:
                        check(chunk)
                    ctl.note_slot_bytes(_chunk_nbytes(chunk))
                    with telemetry.span("pipeline/stage"):
                        slot = inferencer.stage(chunk)
                except BaseException as exc:
                    tag_culprit(exc, task)
                    raise
                yield task, slot, slot is not chunk, t0

        q, thread = _start_pump(staged_tasks(), ctl.depths["prefetch"])
        staged: deque = deque()     # (task, slot, owned, t0)
        pending: deque = deque()    # (task, device_out, t0)
        finishing: deque = deque()  # post-pool futures, input order
        pool = ThreadPoolExecutor(max_workers=ctl.limits["post"])

        def finalize(task, out, t0):
            # runs in the pool; the trace context is rebound from the task
            # (context variables do not follow work into pool threads)
            with telemetry.task_context(task.get("trace_id")):
                try:
                    chaos.chaos_point("scheduler/post")
                    result = _drain_host(out)
                    if postprocess is not None:
                        with telemetry.span("scheduler/post"):
                            result = postprocess(result)
                except BaseException as exc:
                    tag_culprit(exc, task)
                    raise
            task[output_name] = result
            task["log"]["timer"][op_name] = time.time() - t0
            task["log"]["compute_device"] = inferencer.compute_device
            return task

        def dispatch_one():
            task, slot, owned, t0 = staged.popleft()
            with telemetry.task_context(task.get("trace_id")):
                try:
                    chaos.chaos_point(f"op/{op_name}")
                    chaos.chaos_point("scheduler/dispatch")
                    with telemetry.span("pipeline/dispatch"):
                        out = inferencer.infer_async(slot, crop=crop,
                                                     consume=owned)
                except BaseException as exc:
                    tag_culprit(exc, task)
                    raise
            pending.append((task, out, t0))
            telemetry.gauge("pipeline/inflight", len(pending))

        def submit_one():
            task, out, t0 = pending.popleft()
            finishing.append(pool.submit(finalize, task, out, t0))

        def complete():
            task = finishing.popleft().result()
            ctl.observe_task()
            sample_device_memory()
            q.set_capacity(ctl.depths["prefetch"])
            return task

        try:
            try:
                while True:
                    with telemetry.span("scheduler/load"):
                        item = q.get()
                    if _is_end(item):
                        if item[1] is not None:
                            raise item[1]
                        break
                    if item is None:
                        # preserve order: flush in-flight work first
                        while staged:
                            dispatch_one()
                        while pending:
                            submit_one()
                        while finishing:
                            yield complete()
                        yield None
                        continue
                    staged.append(item)
                    telemetry.gauge("pipeline/ring_occupancy", len(staged))
                    if len(staged) >= ctl.depths["ring"]:
                        # drain BEFORE dispatching: at most `inflight`
                        # outputs on the device (the memory bound)
                        while len(pending) >= ctl.depths["inflight"]:
                            submit_one()
                        dispatch_one()
                    while len(finishing) > ctl.depths["post"]:
                        yield complete()
            except Exception:
                # push everything that can still complete downstream (the
                # serial path would have saved it), then re-raise the
                # original; except, not finally: a yield in finally
                # breaks generator close()
                while staged:
                    dispatch_one()
                while pending:
                    submit_one()
                while finishing:
                    try:
                        task = complete()
                    except Exception:
                        continue  # this task failed too; first error wins
                    yield task
                raise
            while staged:
                while len(pending) >= ctl.depths["inflight"]:
                    submit_one()
                dispatch_one()
            while pending:
                submit_one()
            while finishing:
                yield complete()
        finally:
            # a drain already running finishes, queued ones are dropped,
            # before any claim is released; the buffered tasks surrender
            q.close()
            pool.shutdown(wait=True, cancel_futures=True)
            thread.join(timeout=5.0)

    return stage_fn


# ---------------------------------------------------------------------------
# write-behind (terminal stage)
# ---------------------------------------------------------------------------
def write_behind_stage(window: int = 2,
                       controller: Optional[DepthController] = None):
    """Let up to ``window`` (knob ``write``) tasks ride with storage
    writes in flight while newer tasks compute; the oldest task's writes
    are drained (``scheduler/write``) before it flows on, so a task
    leaves this stage only with its writes durable — on every exit path,
    errors and generator close included."""
    from chunkflow_tpu_torch.flow.runtime import drain_pending_writes

    ctl_arg = controller

    def stage_fn(stream):
        ctl = ctl_arg or DepthController(depths={"write": window})
        buffered: deque = deque()

        def drain_oldest():
            task = buffered.popleft()
            with telemetry.task_context(task.get("trace_id")), \
                    telemetry.span("scheduler/write"):
                drain_pending_writes(task)
            ctl.observe_task()
            return task

        try:
            for task in stream:
                if task is None or not task.get("pending_writes"):
                    # preserve order: anything buffered commits first
                    while buffered:
                        yield drain_oldest()
                    yield task
                    continue
                buffered.append(task)
                telemetry.gauge("scheduler/write_window", len(buffered))
                while len(buffered) > ctl.depths["write"]:
                    yield drain_oldest()
            while buffered:
                yield drain_oldest()
        except BaseException:
            # the buffered tasks can no longer flow on, but their writes
            # must still commit; the propagating exception wins
            while buffered:
                task = buffered.popleft()
                try:
                    drain_pending_writes(task)
                except Exception as exc:
                    print(f"write-behind: pending write failed during "
                          f"teardown: {exc!r}", file=sys.stderr)
            raise

    return stage_fn
