"""The pipeline runtime: a lazy chain of task generators.

The counterpart of ``chunkflow_tpu/flow/runtime.py`` (unsupervised mode):
a pipeline is a chain of stages, each mapping an iterator of tasks to an
iterator of tasks, threading a task dict through. A task is a plain
dict::

    {"log": {"timer": {...}, "compute_device": ""}, "bbox": BoundingBox,
     "<chunk name>": Chunk, ...}

A ``None`` task skips all downstream work (every operator passes it
through). ``generate-tasks`` fans the one seed task into a task grid;
the streaming inference stages (``flow/pipeline.py``,
``flow/scheduler.py``) keep several tasks in flight at once.
"""
from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

from chunkflow_tpu_torch.core import telemetry

DEFAULT_CHUNK_NAME = "chunk"


def new_task() -> dict:
    return {"log": {"timer": {}, "compute_device": ""}}


def drain_pending_writes(task: Optional[dict]) -> None:
    """Block until every asynchronous write attached to the task
    (``task["pending_writes"]``, futures) is durable. Every future is
    drained even when one fails; the first exception is re-raised."""
    if not task:
        return
    first_exc: Optional[BaseException] = None
    for future in task.pop("pending_writes", []):
        try:
            future.result()
        except BaseException as exc:
            if first_exc is None:
                first_exc = exc
    if first_exc is not None:
        raise first_exc


def process_stream(stages: Iterable[Callable], verbose: int = 0) -> int:
    """Chain the stages from one seed task and drain the chain; returns
    the number of tasks that reached its end. Under the adaptive
    scheduler a write-behind window is appended as the last stage, so up
    to ``write``-depth tasks ride with their writes in flight while newer
    tasks compute; each task's writes are durable before it is
    counted."""
    from chunkflow_tpu_torch.flow.scheduler import (
        scheduler_mode,
        write_behind_stage,
    )

    stages = list(stages)
    if scheduler_mode() == "adaptive":
        stages.append(write_behind_stage())
    stream: Iterator = iter([new_task()])
    for stage in stages:
        stream = stage(stream)
    count = 0
    for task in stream:
        count += 1
        trace_id = task.get("trace_id") if task else None
        with telemetry.task_context(trace_id), \
                telemetry.span("pipeline/ack_writes"):
            drain_pending_writes(task)
        telemetry.inc("pipeline/tasks")
        if task is None:
            telemetry.inc("pipeline/tasks_skipped")
        if verbose and task is not None and task.get("log"):
            timers = task["log"]["timer"]
            print(f"task complete; time per op (s): {timers} "
                  f"total={sum(timers.values()):.3f}")
    return count


def operator(func: Callable) -> Callable:
    """Decorate a per-task operator ``func(task, **kwargs) -> task``: the
    result takes keyword arguments (and ``_name``, the timer key) and
    returns a stage that applies ``func`` to every task, timing it into
    ``task["log"]["timer"][name]``. ``None`` tasks pass through."""

    @functools.wraps(func)
    def wrapper(**kwargs):
        name = kwargs.pop("_name", func.__name__)

        def stage(stream: Iterator[Optional[dict]]):
            for task in stream:
                if task is not None:
                    original = task
                    sp = telemetry.span(f"op/{name}")
                    start = time.time()
                    with telemetry.task_context(task.get("trace_id")), sp:
                        task = func(task, **kwargs)
                    if task is not None:
                        task["log"]["timer"][name] = (
                            sp.duration if telemetry.enabled()
                            else time.time() - start)
                    else:
                        # a skip: downstream barriers never see the task,
                        # so its writes are made durable here
                        drain_pending_writes(original)
                yield task

        return stage

    return wrapper


def write_operator(func: Callable) -> Callable:
    """An :func:`operator` whose body is a storage write (``save-*``). The
    JAX package skips it on the mirror tasks of a multi-process run; the
    port runs one process, so it is an operator."""
    return operator(func)


def generator(func: Callable) -> Callable:
    """Decorate a task source ``func(task, **kwargs) -> iterator of
    tasks``: it runs once per upstream task (usually the seed) and may
    yield many (``generate-tasks`` fans the seed into a grid)."""

    @functools.wraps(func)
    def wrapper(**kwargs):
        def stage(stream: Iterator[Optional[dict]]):
            for task in stream:
                if task is None:
                    yield task
                    continue
                yield from func(task, **kwargs)

        return stage

    return wrapper


def prefetch_stage(depth: int = 2, to_device: bool = False,
                   device="cuda") -> Callable:
    """Run the upstream stages in a background thread, ``depth`` tasks
    ahead, so the next task's host IO overlaps this task's device work.
    With ``to_device`` the thread also starts the upload of each task's
    chunks to ``device``. Upstream exceptions re-raise in the consumer."""
    from chunkflow_tpu_torch.flow.pipeline import stage_task_chunks

    def stage(stream: Iterator[Optional[dict]]):
        q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for task in stream:
                    if to_device and task is not None:
                        task = stage_task_chunks(task, device)
                    if not put(task):
                        return  # consumer gone mid-pull
            except BaseException as exc:  # re-raised in the consumer
                put((end, exc))
                return
            put((end, None))

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is end:
                    if item[1] is not None:
                        raise item[1]
                    return
                yield item
        finally:
            # early exit: retire the worker so it stops pulling upstream
            # (tasks it buffered are dropped: the port claims no queue
            # tasks yet, so there is no lease to hand back)
            stop.set()
            thread.join(timeout=5.0)

    return stage
