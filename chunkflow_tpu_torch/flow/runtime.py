"""The pipeline runtime: a lazy chain of task generators.

The counterpart of ``chunkflow_tpu/flow/runtime.py``: a pipeline is a
chain of stages, each mapping an iterator of tasks to an iterator of
tasks, threading a task dict through. A task is a plain dict::

    {"log": {"timer": {...}, "compute_device": ""}, "bbox": BoundingBox,
     "<chunk name>": Chunk, ...}

plus, for a task claimed from a queue, ``queue``, ``task_handle``,
``task_body``, ``trace_id`` and (supervised) ``lifecycle``. A ``None``
task skips all downstream work (every operator passes it through).
``generate-tasks`` fans the one seed task into a task grid; the streaming
inference stages (``flow/pipeline.py``, ``flow/scheduler.py``) keep
several tasks in flight at once.

Supervised (``fetch-task-from-queue --max-retries/--ledger/--lease-renew``,
``parallel/lifecycle.py``), a failure anywhere in the chain does not end
the worker: :func:`process_stream` closes the broken chain, the lifecycle
layer settles every claimed task (the culprit retries or is
dead-lettered, the others hand their claims back), and the chain is
built again from the same stage factories, so the inferencer, its
streams, pinned buffers and weights carry over.
"""
from __future__ import annotations

import functools
import queue
import sys
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel import lifecycle
from chunkflow_tpu_torch.testing import chaos

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


def _close_chain(chain) -> None:
    """Close every generator of a broken chain, the last stage first, so
    each stage's ``finally`` runs now: an executor finishes the downloads
    it started or drops them, retires its threads and surrenders the
    tasks it held. A generator another thread is running (upstream of a
    prefetch thread) is left to that thread's own retirement."""
    for gen in reversed(chain):
        if not hasattr(gen, "close"):
            continue  # the seed's list iterator
        try:
            gen.close()
        except ValueError:
            pass  # running in a prefetch thread
        except Exception as exc:
            print(f"runtime: closing a broken stage raised {exc!r}",
                  file=sys.stderr)


def process_stream(stages: Iterable[Callable], verbose: int = 0) -> int:
    """Chain the stages from one seed task and drain the chain; returns
    the number of tasks that reached its end. Under the adaptive
    scheduler a write-behind window is appended as the last stage, so up
    to ``write``-depth tasks ride with their writes in flight while newer
    tasks compute; each task's writes are durable before it is counted.

    When the chain dies with supervised tasks in flight, it is closed,
    :func:`~chunkflow_tpu_torch.parallel.lifecycle.handle_failure`
    settles the claims, and the chain is built again
    (``pipeline/chain_rebuilds``); a preemption (SIGTERM, SIGINT) settles
    them and re-raises. Without supervised tasks a failure re-raises."""
    from chunkflow_tpu_torch.flow.scheduler import (
        scheduler_mode,
        write_behind_stage,
    )

    stages = list(stages)
    if scheduler_mode() == "adaptive":
        stages.append(write_behind_stage())
    count = 0
    while True:
        chain = [iter([new_task()])]
        for stage in stages:
            chain.append(stage(chain[-1]))
        try:
            for task in chain[-1]:
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
        except BaseException as exc:
            # in-flight device work ends (finished or dropped) before any
            # claim is released
            _close_chain(chain)
            if not lifecycle.handle_failure(exc):
                raise
            telemetry.inc("pipeline/chain_rebuilds")
            continue
        return count


def operator(func: Callable) -> Callable:
    """Decorate a per-task operator ``func(task, **kwargs) -> task``: the
    result takes keyword arguments (and ``_name``, the timer key) and
    returns a stage that applies ``func`` to every task, timing it into
    ``task["log"]["timer"][name]``. ``None`` tasks pass through. Each call
    is the chaos point ``op/<name>``, and a failure is charged to the
    task it ran on (``lifecycle.tag_culprit``)."""

    @functools.wraps(func)
    def wrapper(**kwargs):
        name = kwargs.pop("_name", func.__name__)

        def stage(stream: Iterator[Optional[dict]]):
            for task in stream:
                if task is not None:
                    original = task
                    sp = telemetry.span(f"op/{name}")
                    start = time.time()
                    try:
                        with telemetry.task_context(task.get("trace_id")):
                            chaos.chaos_point(f"op/{name}")
                            with sp:
                                task = func(task, **kwargs)
                    except BaseException as exc:
                        lifecycle.tag_culprit(exc, original)
                        raise
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
    """An :func:`operator` whose body is a storage write (``save-*``,
    ``mark-complete``). The JAX package skips it on the mirror tasks of a
    multi-host run; the port runs on one host, so it is an operator."""
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
                        # consumer gone mid-pull: a task claimed after the
                        # failure handler settled the in-flight set is
                        # handed back, not dropped with its lease
                        lifecycle.surrender_task(task)
                        return
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
            # early exit: retire the worker so it stops pulling upstream,
            # then surrender what it had buffered
            stop.set()
            thread.join(timeout=5.0)
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if not (isinstance(item, tuple) and len(item) == 2
                        and item[0] is end):
                    lifecycle.surrender_task(item)

    return stage
