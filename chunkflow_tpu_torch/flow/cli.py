"""The chained-command CLI of the port: a pipeline is a shell command.

A subset of the JAX package's ``chunkflow`` CLI (``chunkflow_tpu/flow/
cli.py``) with the same command and option names for what is ported.
Each command builds a stage over the task stream (``flow/runtime.py``);
the chain runs from one seed task, which a task source (``generate-tasks``,
``fetch-task-from-file``, ``fetch-task-from-queue``) fans into tasks.
Built on ``argparse``.

A fleet's worker (every worker runs the same command; the queue and the
volumes are its only shared state)::

    python -m chunkflow_tpu_torch -v \\
        fetch-task-from-queue -q file:///work/queue --max-retries 3 \\
            --ledger /work/ledger \\
        load-precomputed -v /data/image -e 4 64 64 \\
        inference --framework pytorch --input-patch-size 20 256 256 \\
            --output-patch-overlap 4 64 64 --num-output-channels 3 \\
            --batch-size 2 --output-crop-margin 4 64 64 --async-depth 2 \\
        save-precomputed -v /data/affinity --async-write \\
        delete-task-in-queue

Inference runs on the card; ``--device cpu`` (before the first command)
runs the kernels' plain PyTorch versions on the CPU instead. Volumes are
neuroglancer precomputed volumes (``raw``, ``jpeg``, ``png`` or
``compressed_segmentation`` blocks, unsharded or sharded) in a local
directory, ``gs://bucket/path`` or ``s3://bucket/path``; queues are
``file://`` directories, ``memory://`` names or ``sqs://`` names (the
port's own clients, ``cloud/``, with the usual Google and AWS
credentials and endpoint variables); chunk files are HDF5, TIFF, PNG
sections, NRRD, zarr v2, and (to read) zarr v3 and N5; annotations are
synapse JSON/HDF5, point npy/HDF5 and SWC files. Every command of the JAX
CLI is ported. Chunk operators compute where their chunk lies;
``mask``, ``channel-voting`` and ``connected-components --device``
compute a host chunk on ``--device``, as the JAX package computes them
with ``jnp`` on its default device.

The README's quick start on the card::

    python -m chunkflow_tpu_torch load-h5 -f image.h5 \\
        inference --framework flax --model-variant tpu --dtype bfloat16 \\
            --input-patch-size 20 256 256 --output-patch-overlap 4 64 64 \\
            --batch-size 4 \\
        save-h5 -f affinity.h5
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.bbox import BoundingBox, BoundingBoxes
from chunkflow_tpu_torch.core.cartesian import to_cartesian
from chunkflow_tpu_torch.core.dtypes import numpy_dtype
from chunkflow_tpu_torch.flow.runtime import (
    DEFAULT_CHUNK_NAME,
    drain_pending_writes,
    generator,
    new_task,
    operator,
    prefetch_stage,
    process_stream,
    write_operator,
)

Stage = Callable  # iterator of tasks -> iterator of tasks


def _triple(parser, *names, default=None, required=False, help=""):
    parser.add_argument(*names, type=int, nargs=3, default=default,
                        required=required, help=help)


def _name(parser, default):
    parser.add_argument("--name", dest="op_name", default=default,
                        help="operator name key in the task log timer")


class UsageError(Exception):
    """A command line that cannot run. An Exception, so a streaming stage
    flushes the tasks it already dispatched before it propagates (as
    click's ``UsageError`` does in the JAX CLI); :func:`main` turns it
    into an exit with the message."""


def _on_off(parser, name: str, off: str, default: bool, help: str = ""):
    """A ``--name/--off`` pair of flags on one destination (click's
    two-name boolean options)."""
    dest = name.lstrip("-").replace("-", "_")
    parser.add_argument(name, dest=dest, action="store_true",
                        default=default, help=help)
    parser.add_argument(off, dest=dest, action="store_false")


# ---------------------------------------------------------------------------
# task sources
# ---------------------------------------------------------------------------
def _generate_tasks_options(p):
    p.add_argument("--volume-path", "-v", default=None,
                   help="derive default roi bounds (and block alignment) "
                        "from this precomputed volume at --mip")
    p.add_argument("--mip", "-m", type=int, default=None,
                   help="scale of --volume-path (default: the group --mip)")
    _triple(p, "--chunk-size", "-c", required=True, help="task chunk size")
    _triple(p, "--overlap", default=(0, 0, 0), help="chunk overlap")
    _triple(p, "--roi-start", "-s", default=None)
    _triple(p, "--roi-stop", "-r", default=None)
    _triple(p, "--roi-size", "-z", default=None,
            help="alternative to --roi-stop: start + size")
    p.add_argument("--bounding-box", "-b", default=None,
                   help="roi as a canonical zs-ze_ys-ye_xs-xe string")
    _triple(p, "--grid-size", "-g", default=None)
    _triple(p, "--aligned-block-size", "-a", default=None,
            help="snap the roi to storage block multiples")
    p.add_argument("--bounded", action=argparse.BooleanOptionalAction,
                   default=False, help="shift trailing chunks back inside "
                                       "the roi instead of spilling past it")
    p.add_argument("--task-file", "--file-path", "-f", default=None,
                   help="write the tasks to a .txt/.npy file instead of "
                        "streaming them")
    p.add_argument("--queue-name", "-q", default=None,
                   help="push the tasks to a queue (file://dir, memory://)")
    p.add_argument("--task-index-start", "-i", type=int, default=None)
    p.add_argument("--task-index-stop", "-p", type=int, default=None)
    p.add_argument("--disbatch", action=argparse.BooleanOptionalAction,
                   default=False, help="select the single task at "
                                       "$DISBATCH_REPEAT_INDEX")


def _generate_tasks(args, state) -> Stage:
    start, stop, size = args.roi_start, args.roi_stop, args.roi_size
    block, block_anchor = args.aligned_block_size, None
    if stop is not None and size is not None:
        raise UsageError("give --roi-stop OR --roi-size, not both")
    if args.bounding_box is not None:
        if start is not None or stop is not None or size is not None:
            raise UsageError("--bounding-box replaces --roi-start/"
                             "--roi-stop/--roi-size")
        box = BoundingBox.from_string(args.bounding_box)
        start, stop = tuple(box.start), tuple(box.stop)
    if args.volume_path is not None:
        from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

        vol = PrecomputedVolume(args.volume_path)
        vmip = args.mip if args.mip is not None else state["mip"]
        bounds = vol.bounds(vmip)
        derived = start is None and stop is None and size is None
        if start is None:
            start = tuple(bounds.start)
        if stop is None and size is None:
            stop = tuple(bounds.stop)
        # bounds from the volume align to its blocks; an explicit roi is
        # not expanded unless -a asks
        if block is None and derived:
            block = tuple(vol.block_size(vmip))
        if block is not None:
            block_anchor = tuple(vol.voxel_offset(vmip))
    if start is None:
        start = (0, 0, 0)

    @generator
    def stage(task):
        boxes = list(BoundingBoxes.from_manual_setup(
            chunk_size=args.chunk_size, overlap=args.overlap,
            roi_start=start, roi_stop=stop, roi_size=size,
            grid_size=args.grid_size, aligned_block_size=block,
            block_offset=block_anchor, bounded=args.bounded,
        ))
        if args.task_index_start is not None \
                or args.task_index_stop is not None:
            boxes = boxes[args.task_index_start:args.task_index_stop]
        elif args.disbatch:
            idx = _disbatch_index()
            if idx >= len(boxes):
                raise UsageError(f"DISBATCH_REPEAT_INDEX={idx} exceeds the "
                                 f"{len(boxes)}-task grid")
            boxes = [boxes[idx]]
        if args.task_file is not None:
            BoundingBoxes(boxes).to_file(args.task_file)
            print(f"wrote {len(boxes)} tasks to {args.task_file}")
            return
        if args.queue_name is not None:
            from chunkflow_tpu_torch.parallel.queues import open_queue

            open_queue(args.queue_name).send_messages(
                [b.string for b in boxes])
            print(f"pushed {len(boxes)} tasks to {args.queue_name}")
            return
        for bbox in boxes:
            t = new_task()
            t["bbox"] = bbox
            yield t

    return stage()


def _disbatch_index() -> int:
    if "DISBATCH_REPEAT_INDEX" not in os.environ:
        raise UsageError("--disbatch needs $DISBATCH_REPEAT_INDEX in the "
                         "environment (set by the disBatch launcher)")
    return int(os.environ["DISBATCH_REPEAT_INDEX"])


def _setup_env_options(p):
    _triple(p, "--volume-start", required=True)
    _triple(p, "--volume-stop", default=None)
    _triple(p, "--volume-size", "-s", default=None)
    p.add_argument("--volume-path", "--layer-path", "-l", required=True)
    p.add_argument("--visibility-timeout", type=int, default=None,
                   help="visibility timeout of the queue being filled")
    p.add_argument("--max-ram-size", "-r", type=float, default=15.0,
                   help="RAM budget in GB; half goes to the output buffer")
    _triple(p, "--output-patch-size", "-z", required=True)
    _triple(p, "--input-patch-size", default=None)
    _triple(p, "--output-patch-overlap", default=None)
    _triple(p, "--crop-chunk-margin", default=None)
    p.add_argument("--channel-num", "-c", type=int, default=3)
    p.add_argument("--dtype", choices=["uint8", "float16", "float32"],
                   default="float32")
    p.add_argument("--mip", dest="env_mip", type=int, default=0)
    p.add_argument("--thumbnail-mip", type=int, default=6)
    p.add_argument("--max-mip", type=int, default=5)
    p.add_argument("--thumbnail", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--encoding", default="raw")
    _triple(p, "--voxel-size", default=(40, 4, 4))
    p.add_argument("--overwrite-info", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--queue-name", "-q", default=None,
                   help="also push the task grid to this queue")


def _setup_env(args, state) -> Stage:
    from chunkflow_tpu_torch.flow.setup_env import setup_environment

    def opt(triple):
        return tuple(triple) if triple is not None else None

    @generator
    def stage(task):
        plan = setup_environment(
            dry_run=state["dry_run"], volume_start=tuple(args.volume_start),
            volume_stop=opt(args.volume_stop),
            volume_size=opt(args.volume_size), volume_path=args.volume_path,
            max_ram_size=args.max_ram_size,
            output_patch_size=tuple(args.output_patch_size),
            input_patch_size=opt(args.input_patch_size),
            channel_num=args.channel_num, dtype=args.dtype,
            output_patch_overlap=opt(args.output_patch_overlap),
            crop_chunk_margin=opt(args.crop_chunk_margin), mip=args.env_mip,
            thumbnail_mip=args.thumbnail_mip, max_mip=args.max_mip,
            thumbnail=args.thumbnail, encoding=args.encoding,
            voxel_size=tuple(args.voxel_size),
            overwrite_info=args.overwrite_info,
        )
        if args.queue_name is not None and not state["dry_run"]:
            from chunkflow_tpu_torch.parallel.queues import open_queue

            timeout = ({} if args.visibility_timeout is None
                       else {"visibility_timeout": args.visibility_timeout})
            open_queue(args.queue_name, **timeout).send_messages(
                [b.string for b in plan.bboxes])
            print(f"pushed {len(plan.bboxes)} tasks to {args.queue_name}")
            return
        for bbox in plan.bboxes:
            t = new_task()
            t["bbox"] = bbox
            yield t

    return stage()


def _fetch_task_from_file_options(p):
    p.add_argument("--task-file", "--file-path", "-f", required=True,
                   help=".txt/.npy task list from generate-tasks")
    p.add_argument("--job-index", type=int, default=None,
                   help="index into the task list; default "
                        "$SLURM_ARRAY_TASK_ID")
    p.add_argument("--granularity", "-g", type=int, default=1,
                   help="consecutive tasks per job")
    p.add_argument("--disbatch", action=argparse.BooleanOptionalAction,
                   default=False, help="the job index is "
                                       "$DISBATCH_REPEAT_INDEX")


def _fetch_task_from_file(args, state) -> Stage:
    @generator
    def stage(task):
        index = args.job_index
        if index is None and args.disbatch:
            index = _disbatch_index()
        if index is None:
            index = int(os.environ.get("SLURM_ARRAY_TASK_ID", 0))
        boxes = list(BoundingBoxes.from_file(args.task_file))
        start = index * args.granularity
        if start >= len(boxes):
            if args.disbatch:
                raise UsageError(f"DISBATCH_REPEAT_INDEX={index} x "
                                 f"granularity {args.granularity} exceeds "
                                 f"the {len(boxes)}-task file")
            # the ragged tail of an over-provisioned array job: a no-op
            print(f"job index {index}: no tasks in the {len(boxes)}-task "
                  f"file; exiting cleanly")
        for bbox in boxes[start:start + args.granularity]:
            t = new_task()
            t["bbox"] = bbox
            yield t

    return stage()


def _fetch_task_from_queue_options(p):
    p.add_argument("--queue-name", "-q", required=True)
    p.add_argument("--visibility-timeout", "-v", type=int, default=1800)
    p.add_argument("--retry-times", "-r", type=int, default=30,
                   help="empty-queue polls before the worker stops")
    p.add_argument("--poll-interval", type=float, default=None,
                   help="seconds between empty-queue polls (default: the "
                        "backend's own)")
    p.add_argument("--num", type=int, default=-1,
                   help="most tasks to take in this run (-1: drain)")
    p.add_argument("--max-retries", type=int, default=None,
                   help="supervised: a failed task retries with backoff up "
                        "to this many failed deliveries, then goes to the "
                        "dead-letter store")
    p.add_argument("--lease-renew", type=float, default=0.0,
                   help="seconds between lease renewals of claimed tasks "
                        "(0: none)")
    p.add_argument("--ledger", default=None,
                   help="completion ledger (memory://name or a directory): "
                        "a committed task is skipped when it comes again")
    p.add_argument("--backoff-base", type=float, default=0.5,
                   help="first retry's backoff ceiling in seconds (doubles "
                        "per attempt, full jitter)")
    p.add_argument("--backoff-cap", type=float, default=60.0)


def _fetch_task_from_queue(args, state) -> Stage:
    supervised = (args.max_retries is not None or args.lease_renew > 0
                  or args.ledger is not None)
    # --num counts over the whole run, across chain rebuilds
    budget = {"left": args.num}

    def spent() -> bool:
        """Count one claimed task; True once the run's budget is used."""
        if budget["left"] < 0:
            return False
        budget["left"] -= 1
        return budget["left"] <= 0

    def queue_task(queue, handle, body, trace_id):
        t = new_task()
        t["bbox"] = BoundingBox.from_string(body)
        t.update(queue=queue, task_handle=handle, task_body=body,
                 trace_id=trace_id)
        return t

    @generator
    def stage(task):
        from chunkflow_tpu_torch.parallel import lifecycle, multihost
        from chunkflow_tpu_torch.parallel.queues import open_queue

        # a world of several processes (one inference spanning them): the
        # coordinator alone touches the queue and broadcasts each body;
        # the peers run mirror tasks, which compute but neither write nor
        # ack (runtime.is_mirror_task)
        crosshost = multihost.process_count() > 1
        if crosshost and not multihost.is_coordinator():
            while True:
                body = multihost.broadcast_string(None)
                if body is None:
                    break
                t = new_task()
                t["bbox"] = BoundingBox.from_string(body)
                t["replica_mirror"] = True
                yield t
            return
        if budget["left"] == 0:
            return
        queue = open_queue(args.queue_name,
                           visibility_timeout=args.visibility_timeout)
        queue.max_empty_retries = args.retry_times
        if args.poll_interval is not None:
            queue.retry_sleep = max(0.01, args.poll_interval)
        if supervised and crosshost:
            print("fetch-task-from-queue: lifecycle supervision does not "
                  "compose with multi-host broadcast mode yet; running "
                  "unsupervised", file=sys.stderr)
        if not supervised or crosshost:
            try:
                for handle, body in queue:
                    if crosshost:
                        multihost.broadcast_string(body)
                    yield queue_task(queue, handle, body,
                                     queue.trace_id(handle))
                    if spent():
                        return
            finally:
                # the sentinel on EVERY exit path (drained, --num spent, a
                # downstream exception, the generator closed): a
                # coordinator that ends without it leaves every peer
                # blocked waiting for the next task
                if crosshost:
                    multihost.broadcast_string(None)
            return
        supervisor = lifecycle.LifecycleSupervisor(
            queue,
            ledger=lifecycle.open_ledger(args.ledger) if args.ledger else None,
            max_retries=3 if args.max_retries is None else args.max_retries,
            lease_renew=args.lease_renew, backoff_base=args.backoff_base,
            backoff_cap=args.backoff_cap)
        for lc in supervisor.tasks():
            try:
                # a malformed body is a poison task: charge it alone
                t = queue_task(queue, lc.handle, lc.body, lc.trace_id)
            except BaseException as exc:
                lifecycle.tag_culprit(exc, lc)
                raise
            t["lifecycle"] = lc
            lc.task = t
            yield t
            if spent():
                return

    return stage()


def _delete_task_in_queue_options(p):
    _name(p, "delete-task-in-queue")


def _delete_task_in_queue(args, state) -> Stage:
    @operator
    def stage(task):
        lc = task.get("lifecycle")
        if lc is not None and not state["dry_run"]:
            # drain writes, mark the ledger, ack, stop the lease
            lc.commit(task)
            return task
        # an ack commits the task: every async write is durable first
        drain_pending_writes(task)
        queue = task.get("queue")
        if queue is not None and not state["dry_run"]:
            queue.delete(task["task_handle"])
        return task

    return stage(_name=args.op_name)


def _dead_letter_options(p):
    p.add_argument("--queue-name", "-q", required=True)
    _on_off(p, "--requeue", "--inspect", default=False,
            help="move every dead-letter entry back to pending (default: "
                 "list them)")


def _dead_letter(args, state) -> Stage:
    @generator
    def stage(task):
        from chunkflow_tpu_torch.parallel.queues import open_queue

        queue = open_queue(args.queue_name)
        entries = queue.dead_letters()
        if not entries:
            print(f"dead-letter store of {args.queue_name} is empty")
        else:
            print(f"{len(entries)} dead-letter task(s) in {args.queue_name}:")
            for entry in entries:
                trace = entry.get("trace_id")
                print(f"  {entry.get('body', '')}  "
                      f"receives={entry.get('receives', 0)}  "
                      + (f"trace={trace}  " if trace else "")
                      + f"reason={entry.get('reason', '')}")
        if args.requeue and not state["dry_run"]:
            print(f"requeued {queue.requeue_dead()} task(s)")
        return
        yield  # a generator that yields nothing

    return stage()


def _fleet_status_options(p):
    p.add_argument("--queue-name", "-q", required=True)
    p.add_argument("--workers", "-w", default=None,
                   help="comma-separated worker /metrics endpoints "
                        "(host:port or full URLs) to sample live")
    p.add_argument("--timeout", type=float, default=1.0,
                   help="per-worker scrape timeout in seconds")
    p.add_argument("--fleet-state", default=None,
                   help="a fleet-run state file: its workers are sampled "
                        "too, and dead ones report their last-seen time and "
                        "exit code (default: fleet-state.json beside "
                        "--metrics-dir)")


def _fleet_status(args, state) -> Stage:
    @generator
    def stage(task):
        import time

        from chunkflow_tpu_torch.parallel.queues import open_queue
        from chunkflow_tpu_torch.parallel.restapi import (
            achieved_mvox_s,
            scrape_worker,
        )

        queue = open_queue(args.queue_name)
        stats = queue.stats()

        def show(value):
            return "?" if value is None else f"{value:g}"

        print(
            f"queue {queue.describe()}: "
            f"pending={show(stats.get('pending'))} "
            f"in-flight={show(stats.get('inflight'))} "
            f"dead={show(stats.get('dead'))} "
            f"receives={show(stats.get('receives'))}"
        )
        if stats.get("dead"):
            print(
                "  -> dead-letter tasks pending triage: inspect with "
                f"`chunkflow dead-letter -q {args.queue_name}`"
            )
        # the supervisor's state file: the post-mortem of what a live
        # scrape cannot answer
        state_path = args.fleet_state
        if state_path is None and telemetry.configured_path():
            candidate = os.path.join(
                os.path.dirname(telemetry.configured_path()),
                "fleet-state.json")
            if os.path.exists(candidate):
                state_path = candidate
        records = {}
        if state_path:
            try:
                with open(state_path) as f:
                    fleet = json.load(f)
                for rec in fleet.get("workers", []):
                    if rec.get("endpoint"):
                        records[rec["endpoint"]] = rec
                print(
                    f"fleet {state_path}: target={fleet.get('target')} "
                    f"{'static' if fleet.get('static') else 'elastic'} "
                    f"[{fleet.get('min_workers')}..{fleet.get('max_workers')}]"
                )
            except (OSError, ValueError) as exc:
                print(f"fleet-state {state_path}: unreadable ({exc})",
                      file=sys.stderr)

        def age(t):
            return "never" if not t else f"{time.time() - t:.1f}s ago"

        endpoints = [e.strip() for e in (args.workers or "").split(",")
                     if e.strip()]
        endpoints += [e for e in records if e not in endpoints]
        for endpoint in endpoints:
            rec = records.get(endpoint) or {}
            label = f" [{rec['worker']}]" if rec.get("worker") else ""
            if rec.get("state") == "exited":
                # reaped by the supervisor: its exit code and last-seen time
                code = rec.get("exit_code")
                note = f"exit code {code}"
                if isinstance(code, int) and code < 0:
                    note += f" (signal {-code})"
                print(f"worker {endpoint}{label}: exited, {note}, "
                      f"last seen {age(rec.get('last_seen'))}")
                continue
            sample = scrape_worker(endpoint, timeout=args.timeout)
            if sample["error"] is not None:
                line = (f"worker {sample['endpoint']}{label}: "
                        f"unreachable ({sample['error']})")
                if rec:
                    line += (f", state={rec.get('state', '?')}, "
                             f"last seen {age(rec.get('last_seen'))}")
                print(line)
                continue
            health = sample["healthz"] or {}
            metrics = sample["metrics"] or {}
            committed = metrics.get("chunkflow_tasks_committed_total", 0)
            retried = metrics.get("chunkflow_tasks_retried_total", 0)
            dominant = metrics.get("chunkflow_stall_dominant_share")
            line = (
                f"worker {sample['endpoint']}{label}: "
                f"{health.get('worker', '?')} "
                f"leases={health.get('inflight_leases', '?')} "
                f"committed={committed:g} retried={retried:g}"
            )
            if dominant is not None:
                line += f" dominant-stall-share={dominant:.0%}"
            mvox = achieved_mvox_s(metrics)
            if mvox is not None:
                line += f" achieved={mvox:.2f} Mvox/s"
            if sample.get("slo_firing"):
                line += " SLO-FIRING: " + ",".join(sample["slo_firing"])
            print(line)
            serving = sample.get("serving")
            if serving:
                def ms(value):
                    return ("?" if value is None
                            else f"{value * 1e3:.1f}ms")

                print(
                    f"  serving: in-flight={serving['inflight']:g} "
                    f"requests={serving['requests']:g} "
                    f"completed={serving['completed']:g} "
                    f"p50={ms(serving['p50_s'])} "
                    f"p99={ms(serving['p99_s'])} "
                    f"rejects={serving['rejects']:g} "
                    f"deadline-misses={serving['deadline_missed']:g}"
                )
        return
        yield  # a generator that yields nothing

    return stage()


def _fleet_run_options(p):
    p.add_argument("--queue-name", "-q", required=True)
    p.add_argument("--worker-args", "-w", dest="worker_args_str",
                   required=True,
                   help="the quoted stages each worker runs after its "
                        "supervised fetch stage, ending in "
                        "delete-task-in-queue")
    p.add_argument("--min-workers", type=int, default=1)
    p.add_argument("--max-workers", type=int, default=4)
    p.add_argument("--interval", type=float, default=2.0,
                   help="decision-tick interval in seconds")
    p.add_argument("--scale-up-backlog", type=float, default=4.0,
                   help="pending tasks per active worker above which a "
                        "compute-bound fleet grows by one worker per tick")
    p.add_argument("--idle-ticks", type=int, default=3,
                   help="idle ticks in a row (pending = in-flight = 0) "
                        "before draining back to --min-workers")
    p.add_argument("--probe-misses", type=int, default=3,
                   help="failed /healthz probes in a row before a worker "
                        "is quarantined (SIGKILL, leases force-released)")
    p.add_argument("--term-grace", type=float, default=10.0,
                   help="seconds a SIGTERMed worker gets to nack and flush "
                        "before SIGKILL")
    p.add_argument("--mem-watermark-gb", type=float, default=2.0,
                   help="host MemAvailable floor: no scale-up that would "
                        "go below it")
    p.add_argument("--drill-rate", type=float, default=0.0,
                   help="spot-preemption drill: per-tick probability of "
                        "reclaiming a random live worker through SIGTERM "
                        "(0: off)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the drill's random choices")
    p.add_argument("--max-runtime", type=float, default=86400.0)
    p.add_argument("--state-file", default=None,
                   help="the fleet-state JSON fleet-status reads (default: "
                        "fleet-state.json under --metrics-dir)")
    p.add_argument("--visibility-timeout", "-v", type=int, default=300)
    p.add_argument("--retry-times", "-r", type=int, default=10,
                   help="empty polls before a worker ends its session (the "
                        "supervisor spawns another while it owes the "
                        "target size)")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--max-retries", type=int, default=10,
                   help="failed deliveries per task before it goes to the "
                        "dead-letter store")
    p.add_argument("--lease-renew", type=float, default=None,
                   help="lease heartbeat interval (default: "
                        "visibility-timeout / 3)")
    p.add_argument("--ledger", default=None,
                   help="completion ledger passed to every worker (needed "
                        "for exactly-once effects under kills)")


def _fleet_run(args, state) -> Stage:
    import shlex

    @generator
    def stage(task):
        from chunkflow_tpu_torch.parallel.fleet import FleetSupervisor

        renew = (args.visibility_timeout / 3.0
                 if args.lease_renew is None else args.lease_renew)
        worker_args = [
            "fetch-task-from-queue", "-q", args.queue_name,
            "-v", str(args.visibility_timeout), "-r", str(args.retry_times),
            "--poll-interval", str(args.poll_interval),
            "--max-retries", str(args.max_retries),
            "--lease-renew", str(renew),
        ]
        if args.ledger:
            worker_args += ["--ledger", args.ledger]
        worker_args += shlex.split(args.worker_args_str)
        metrics_dir = (
            os.path.dirname(telemetry.configured_path())
            if telemetry.configured_path() else None
        )
        supervisor = FleetSupervisor(
            args.queue_name, worker_args,
            min_workers=args.min_workers, max_workers=args.max_workers,
            interval=args.interval, scale_up_backlog=args.scale_up_backlog,
            idle_ticks=args.idle_ticks, probe_misses=args.probe_misses,
            term_grace=args.term_grace,
            mem_watermark_gb=args.mem_watermark_gb,
            drill_rate=args.drill_rate, seed=args.seed,
            metrics_dir=metrics_dir, state_path=args.state_file,
            visibility_timeout=args.visibility_timeout,
            device=state["device"], verbose=state["verbose"],
        )
        summary = supervisor.run(max_runtime=args.max_runtime)
        if supervisor.kernel_build_s is not None:
            print(f"fleet: CUDA kernels ready in "
                  f"{supervisor.kernel_build_s:.1f} s before the first "
                  f"spawn")
        print(
            f"fleet drained: {summary['spawned']} worker session(s), "
            f"{summary['scale_ups']:g} scale-up(s), "
            f"{summary['scale_downs']:g} scale-down(s), "
            f"{summary['evictions']:g} eviction(s), "
            f"{summary['worker_deaths']:g} unexpected death(s), "
            f"{summary['drill_preemptions']:g} drill preemption(s)"
            + (" [static]" if summary["static"] else "")
        )
        if supervisor.state_path:
            print(f"fleet state: {supervisor.state_path}")
        return
        yield  # a generator that yields nothing

    return stage()


def _create_bbox_options(p):
    _name(p, "create-bbox")
    _triple(p, "--start", "-s", required=True)
    _triple(p, "--stop", "-e", default=None)
    _triple(p, "--size", default=None)


def _create_bbox(args, state) -> Stage:
    @operator
    def stage(task):
        if args.stop and any(args.stop):
            task["bbox"] = BoundingBox(args.start, args.stop)
        elif args.size and any(args.size):
            task["bbox"] = BoundingBox.from_delta(args.start, args.size)
        else:
            raise UsageError("create-bbox needs --stop or --size")
        return task

    return stage(_name=args.op_name)


def _prefetch_options(p):
    p.add_argument("--depth", "-d", type=int, default=2,
                   help="how many tasks to stage ahead of the consumer")
    p.add_argument("--to-device", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="also start the upload of staged chunks")


def _prefetch(args, state) -> Stage:
    return prefetch_stage(depth=args.depth, to_device=args.to_device,
                          device=state["device"])


# ---------------------------------------------------------------------------
# chunk creation / IO
# ---------------------------------------------------------------------------
def _create_chunk_options(p):
    _name(p, "create-chunk")
    _triple(p, "--size", "-s", default=(64, 64, 64))
    p.add_argument("--dtype", default="uint8")
    p.add_argument("--pattern", choices=["sin", "random", "zero"],
                   default="sin")
    _triple(p, "--voxel-offset", "-t", default=(0, 0, 0))
    _triple(p, "--voxel-size", default=(1, 1, 1))
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)


def _create_chunk(args, state) -> Stage:
    @operator
    def stage(task):
        task[args.output_chunk_name] = Chunk.create(
            size=args.size, dtype=np.dtype(args.dtype), pattern=args.pattern,
            voxel_offset=args.voxel_offset, voxel_size=args.voxel_size,
        )
        return task

    return stage(_name=args.op_name)


def _load_npy_options(p):
    _name(p, "load-npy")
    p.add_argument("--file-name", "--file-path", "-f", required=True)
    _triple(p, "--voxel-offset", default=(0, 0, 0))
    _triple(p, "--voxel-size", "--resolution", default=None)
    p.add_argument("--output-chunk-name", "--output-name", "-o",
                   default=DEFAULT_CHUNK_NAME)


def _load_npy(args, state) -> Stage:
    @operator
    def stage(task):
        chunk = Chunk.from_npy(args.file_name, voxel_offset=args.voxel_offset)
        if args.voxel_size is not None:
            chunk = chunk.with_voxel_size(args.voxel_size)
        task[args.output_chunk_name] = chunk
        return task

    return stage(_name=args.op_name)


def _save_npy_options(p):
    _name(p, "save-npy")
    p.add_argument("--file-name", "-f", required=True)
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _save_npy(args, state) -> Stage:
    @write_operator
    def stage(task):
        task[args.input_chunk_name].to_npy(args.file_name)
        return task

    return stage(_name=args.op_name)


# ---------------------------------------------------------------------------
# chunk files: HDF5, TIFF, PNG sections, NRRD, zarr
# ---------------------------------------------------------------------------
def _h5_task_path(prefix: str, bbox) -> str:
    """A non-.h5 file name is a prefix, completed as <prefix><bbox>.h5."""
    return f"{prefix}{bbox.string}.h5"


def _load_h5_options(p):
    _name(p, "load-h5")
    p.add_argument("--file-name", "-f", required=True,
                   help=".h5 path, or a prefix completed as "
                        "<prefix><bbox>.h5")
    p.add_argument("--dataset-path", "-d", default="main")
    p.add_argument("--dtype", "-e", default=None)
    p.add_argument("--layer-type", "-l", choices=["image", "segmentation"],
                   default=None)
    _triple(p, "--voxel-offset", "-v", default=None)
    _triple(p, "--voxel-size", "-x", default=None)
    p.add_argument("--channels", "-c", default=None,
                   help="comma-separated channel indices to keep")
    _triple(p, "--cutout-start", "-t", default=None)
    _triple(p, "--cutout-stop", "-p", default=None)
    _triple(p, "--cutout-size", "-s", default=None)
    _on_off(p, "--set-bbox", "--no-set-bbox", default=False,
            help="publish the loaded chunk's bbox as the task bbox")
    _on_off(p, "--remove-empty", "--do-not-remove", default=False,
            help="delete the file when the loaded chunk is all zero")
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)


def _load_h5(args, state) -> Stage:
    from chunkflow_tpu_torch.chunk.base import LayerType

    cutout = None
    if args.cutout_start is not None:
        if args.cutout_stop is not None:
            cutout = BoundingBox(args.cutout_start, args.cutout_stop)
        elif args.cutout_size is not None:
            cutout = BoundingBox.from_delta(args.cutout_start,
                                            args.cutout_size)
        else:
            raise UsageError("--cutout-start needs --cutout-stop or "
                             "--cutout-size")

    @operator
    def stage(task):
        # an explicit cutout beats the task bbox
        bbox = cutout if cutout is not None else task.get("bbox")
        path = args.file_name
        if not path.endswith(".h5") and bbox is not None:
            path = _h5_task_path(path, bbox)
        chunk = Chunk.from_h5(
            path, dataset_path=args.dataset_path,
            voxel_offset=args.voxel_offset, voxel_size=args.voxel_size,
            bbox=bbox, dtype=np.dtype(args.dtype) if args.dtype else None,
            channels=args.channels)
        if args.layer_type is not None:
            chunk.layer_type = LayerType(args.layer_type)
        if args.remove_empty and not state["dry_run"] and chunk.all_zero():
            print(f"remove empty {path}")
            os.remove(path)
        task[args.output_chunk_name] = chunk
        if args.set_bbox:
            task["bbox"] = chunk.bbox
        return task

    return stage(_name=args.op_name)


def _save_h5_options(p):
    _name(p, "save-h5")
    p.add_argument("--file-name", "-f", default=None,
                   help=".h5 path, or a prefix completed as "
                        "<prefix><bbox>.h5")
    p.add_argument("--file-name-prefix", default=None,
                   help="write one file per task: <prefix><bbox>.h5")
    _triple(p, "--chunk-size", "-s", default=None,
            help="HDF5 dataset chunking (compression block shape)")
    p.add_argument("--compression", "-c", choices=["gzip", "lzf", "szip"],
                   default="gzip")
    _on_off(p, "--with-offset", "--without-offset", default=True,
            help="write the voxel_offset dataset")
    _triple(p, "--voxel-size", "-v", default=None,
            help="override the chunk's voxel size on write")
    p.add_argument("--dtype", "-d", default=None,
                   help="convert before writing")
    p.add_argument("--input-chunk-name", "--input-name", "-i",
                   default=DEFAULT_CHUNK_NAME)


def _save_h5(args, state) -> Stage:
    if (args.file_name is None) == (args.file_name_prefix is None):
        raise UsageError("save-h5 needs exactly one of --file-name / "
                         "--file-name-prefix")

    @write_operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if args.dtype is not None:
            chunk = chunk.astype(np.dtype(args.dtype))
        if args.voxel_size is not None:
            chunk = chunk.with_voxel_size(args.voxel_size)
        if args.file_name_prefix is not None:
            path = _h5_task_path(args.file_name_prefix,
                                 task.get("bbox") or chunk.bbox)
        elif not args.file_name.endswith(".h5"):
            path = _h5_task_path(args.file_name,
                                 task.get("bbox") or chunk.bbox)
        else:
            path = args.file_name
        chunk.to_h5(path, compression=args.compression,
                    chunk_size=args.chunk_size, with_offset=args.with_offset)
        return task

    return stage(_name=args.op_name)


def _load_tif_options(p):
    _name(p, "load-tif")
    p.add_argument("--file-name", "-f", required=True)
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)
    _triple(p, "--voxel-offset", "-v", default=(0, 0, 0))
    _triple(p, "--voxel-size", "-s", default=None)
    p.add_argument("--layer-type", "-l", choices=["image", "segmentation"],
                   default=None)
    p.add_argument("--dtype", "-d", default=None)


def _load_tif(args, state) -> Stage:
    from chunkflow_tpu_torch.chunk.base import LayerType

    @operator
    def stage(task):
        chunk = Chunk.from_tif(
            args.file_name, voxel_offset=args.voxel_offset,
            voxel_size=args.voxel_size,
            dtype=np.dtype(args.dtype) if args.dtype else None)
        if args.layer_type is not None:
            chunk.layer_type = LayerType(args.layer_type)
        task[args.output_chunk_name] = chunk
        return task

    return stage(_name=args.op_name)


def _save_tif_options(p):
    _name(p, "save-tif")
    p.add_argument("--file-name", "-f", required=True)
    p.add_argument("--dtype", "-d", default=None,
                   help="convert before writing")
    p.add_argument("--compression", default="zlib",
                   help="raw/none, zlib/deflate, lzw or packbits")
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _save_tif(args, state) -> Stage:
    @write_operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if args.dtype is not None:
            chunk = chunk.astype(np.dtype(args.dtype))
        chunk.to_tif(args.file_name, compression=args.compression)
        return task

    return stage(_name=args.op_name)


def _save_pngs_options(p):
    _name(p, "save-pngs")
    p.add_argument("--output-path", "-o", required=True)
    p.add_argument("--dtype", default=None, help="convert before export")
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _save_pngs(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.io_png import save_pngs

    @write_operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if args.dtype is not None:
            chunk = chunk.astype(np.dtype(args.dtype))
        save_pngs(chunk, args.output_path)
        return task

    return stage(_name=args.op_name)


def _load_png_options(p):
    _name(p, "load-png")
    p.add_argument("--path", "-p", required=True,
                   help="directory of z-section pngs")
    _triple(p, "--voxel-offset", "-t", default=(0, 0, 0))
    _triple(p, "--voxel-size", "-x", default=None)
    _triple(p, "--cutout-offset", "-c", default=(0, 0, 0),
            help="with --chunk-size: the cutout window's start")
    _triple(p, "--chunk-size", "-s", default=None,
            help="the cutout window's size (beats the task bbox)")
    p.add_argument("--digit-num", "-d", type=int, default=None,
                   help="accepted for compatibility (section numbers are "
                        "parsed from the file names)")
    p.add_argument("--dtype", default=None)
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)


def _load_png(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.io_png import load_pngs

    @operator
    def stage(task):
        if args.chunk_size is not None:
            bbox = BoundingBox.from_delta(args.cutout_offset, args.chunk_size)
        else:
            bbox = task.get("bbox")
        chunk = load_pngs(args.path, bbox=bbox,
                          voxel_offset=args.voxel_offset,
                          dtype=np.dtype(args.dtype) if args.dtype else None)
        if args.voxel_size is not None:
            chunk = chunk.with_voxel_size(args.voxel_size)
        task[args.output_chunk_name] = chunk
        return task

    return stage(_name=args.op_name)


def _save_nrrd_options(p):
    _name(p, "save-nrrd")
    p.add_argument("--file-name", "-f", required=True)
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _save_nrrd(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.io_nrrd import save_nrrd

    @write_operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        save_nrrd(args.file_name, chunk.array,
                  voxel_size=tuple(chunk.voxel_size),
                  voxel_offset=tuple(chunk.voxel_offset))
        return task

    return stage(_name=args.op_name)


def _load_zarr_options(p):
    _name(p, "load-zarr")
    p.add_argument("--store-path", "--store", "--path", "-p", required=True)
    p.add_argument("--driver", choices=["zarr", "zarr3", "n5"],
                   default="zarr", help="store format: zarr v2, zarr v3 "
                                        "or N5")
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)
    _triple(p, "--voxel-offset", default=(0, 0, 0))
    _triple(p, "--voxel-size", default=None)
    _triple(p, "--chunk-start", default=None,
            help="explicit cutout start (beats the task bbox)")
    _triple(p, "--chunk-size", default=None)


def _load_zarr(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.zarr import open_array

    if (args.chunk_start is None) != (args.chunk_size is None):
        raise UsageError("--chunk-start and --chunk-size must be given "
                         "together")

    @operator
    def stage(task):
        read = open_array(args.store_path, args.driver).read_values
        explicit = (BoundingBox.from_delta(args.chunk_start, args.chunk_size)
                    if args.chunk_start is not None else None)
        if explicit is not None or task.get("bbox") is not None:
            bbox = explicit if explicit is not None else task["bbox"]
            chunk = Chunk(read(bbox.slices), voxel_offset=bbox.start)
        else:
            chunk = Chunk(read(), voxel_offset=args.voxel_offset)
        if args.voxel_size is not None:
            chunk = chunk.with_voxel_size(args.voxel_size)
        task[args.output_chunk_name] = chunk
        return task

    return stage(_name=args.op_name)


def _save_zarr_options(p):
    _name(p, "save-zarr")
    p.add_argument("--store-path", "--store", "-p", required=True)
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)
    _triple(p, "--volume-size", "--shape", default=None,
            help="create the store at this size first")
    _triple(p, "--chunk-size", default=None,
            help="the store's chunk shape on create")
    p.add_argument("--dtype", default=None, help="convert before writing")
    _triple(p, "--resolution", default=None,
            help="voxel size recorded on the chunk before writing")
    p.add_argument("--mip", type=int, default=None,
                   help="accepted for compatibility")
    p.add_argument("--order", default=None,
                   help="accepted for compatibility (always zyx, C order)")


def _save_zarr(args, state) -> Stage:
    """Write the chunk into a zyx zarr v2 array at its voxel offset. A
    store that does not exist is created as the JAX stage's tensorstore
    creates it (``ZarrArray.create``): the chunk's dtype, ``bfloat16``
    too. A bfloat16 chunk goes into an existing store as tensorstore
    writes it: as it is into a ``bfloat16`` store, widened to float32
    into one that float32 casts into safely, and ``TypeError`` for any
    other. ``--dtype`` takes ``bfloat16`` or a name numpy knows: an
    unknown name raises numpy's ``TypeError``, as in the JAX stage, and a
    dtype numpy knows but not as a number (ml_dtypes' ``int4`` and float8
    types, where a library has registered them) ``NotImplementedError``."""
    import torch

    from chunkflow_tpu_torch.chunk.base import as_native_dtype
    from chunkflow_tpu_torch.volume.zarr import ZarrArray

    if args.dtype is None or args.dtype == "bfloat16":
        convert = None if args.dtype is None else torch.bfloat16
    elif np.dtype(args.dtype).kind in "biufc":
        convert = np.dtype(args.dtype)
    else:
        raise NotImplementedError(
            f"save-zarr --dtype {args.dtype}: the port holds numpy dtypes "
            f"and bfloat16 (ROADMAP.md, smaller deviations: zarr dtypes)")

    @write_operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if convert is not None:
            chunk = chunk.astype(convert)
        if args.resolution is not None:
            chunk = chunk.with_voxel_size(args.resolution)
        arr = chunk.array
        bfloat16 = (isinstance(arr, torch.Tensor)
                    and arr.dtype == torch.bfloat16)
        if not bfloat16:
            arr = as_native_dtype(arr)
        try:
            store = ZarrArray(args.store_path)
        except FileNotFoundError:
            # the store must cover the chunk's GLOBAL bbox: it is written
            # at its bbox slices
            size = (tuple(args.volume_size)
                    if args.volume_size and any(args.volume_size)
                    else tuple(int(s) for s in chunk.bbox.stop))
            store = ZarrArray.create(args.store_path, size,
                                     "bfloat16" if bfloat16 else arr.dtype,
                                     chunks=args.chunk_size)
        if bfloat16 and not store.bfloat16:
            # numpy's "safe" rule, which tensorstore applies: bfloat16
            # goes where float32 goes
            if not np.can_cast(np.float32, store.dtype, "safe"):
                raise TypeError(
                    f"save-zarr: a bfloat16 chunk does not cast safely "
                    f"into the {store.dtype} store {args.store_path}, as "
                    f"tensorstore refuses it")
            arr = as_native_dtype(arr)  # widened exactly to float32
        store.write(chunk.bbox.slices, arr)
        return task

    return stage(_name=args.op_name)


# ---------------------------------------------------------------------------
# precomputed volumes
# ---------------------------------------------------------------------------
def _create_info_options(p):
    _name(p, "create-info")
    p.add_argument("--volume-path", "-v", required=True)
    _triple(p, "--volume-size", "-s", default=None)
    _triple(p, "--voxel-size", default=(1, 1, 1))
    _triple(p, "--voxel-offset", default=(0, 0, 0))
    p.add_argument("--num-channels", "--channel-num", "-c", type=int,
                   default=1)
    p.add_argument("--dtype", "--data-type", default="uint8")
    p.add_argument("--encoding", "-e", default="raw",
                   help="block encoding: raw, jpeg, png or "
                        "compressed_segmentation")
    p.add_argument("--input-chunk-name", "-i", default=None,
                   help="take size, offset, dtype and voxel size defaults "
                        "from this chunk of the task")
    p.add_argument("--layer-type", choices=["image", "segmentation"],
                   default="image")
    _triple(p, "--block-size", default=(64, 64, 64))
    p.add_argument("--max-mip", type=int, default=0)
    _triple(p, "--factor", default=(1, 2, 2))


def _create_info(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    @operator
    def stage(task):
        size, vsize, voffset = (args.volume_size, args.voxel_size,
                                args.voxel_offset)
        dt, nchan = args.dtype, args.num_channels
        if args.input_chunk_name is not None:
            # the chunk gives defaults; explicit options win
            chunk = task[args.input_chunk_name]
            if size is None:
                size = tuple(chunk.shape[-3:])
            if tuple(voffset) == (0, 0, 0):
                voffset = tuple(chunk.voxel_offset)
            if tuple(vsize) == (1, 1, 1):
                vsize = tuple(chunk.voxel_size)
            if dt == "uint8":
                dt = str(numpy_dtype(chunk.dtype) or np.dtype(np.float32))
            if nchan == 1:
                nchan = chunk.shape[0] if chunk.ndim == 4 else 1
        if size is None:
            raise UsageError("create-info needs --volume-size or "
                             "--input-chunk-name")
        PrecomputedVolume.create(
            args.volume_path, volume_size=size, voxel_size=vsize,
            voxel_offset=voffset, num_channels=nchan, dtype=dt,
            layer_type=args.layer_type, encoding=args.encoding,
            block_size=args.block_size, num_mips=args.max_mip + 1,
            downsample_factor=args.factor)
        return task

    return stage(_name=args.op_name)


def _load_precomputed_options(p):
    _name(p, "load-precomputed")
    p.add_argument("--volume-path", "-v", required=True)
    p.add_argument("--mip", type=int, default=None,
                   help="default: the group --mip")
    _triple(p, "--expand-margin-size", "-e", default=(0, 0, 0))
    _triple(p, "--chunk-start", "-s", default=None,
            help="cut this box instead of the task bbox")
    _triple(p, "--chunk-size", "-z", default=None,
            help="with --chunk-start: the box extent")
    p.add_argument("--fill-missing", action=argparse.BooleanOptionalAction,
                   default=True, help="read absent blocks as zeros "
                                      "(--no-fill-missing: raise)")
    p.add_argument("--blackout-sections",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="zero the z-sections listed in the volume's "
                        "blackout_section_ids.json")
    p.add_argument("--validate-mip", type=int, default=None,
                   help="cross-check the cutout, mean-pooled, against this "
                        "coarser mip of the volume")
    p.add_argument("--validate-tolerance", type=float, default=0.01)
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)


def _load_precomputed(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    vol = PrecomputedVolume(args.volume_path)
    explicit = args.chunk_start is not None or args.chunk_size is not None

    def explicit_bbox(mip):
        # a missing start or size comes from the volume's bounds
        bounds = vol.bounds(mip)
        start = (args.chunk_start if args.chunk_start is not None
                 else tuple(bounds.start))
        size = (args.chunk_size if args.chunk_size is not None
                else tuple(bounds.stop - to_cartesian(start)))
        return BoundingBox.from_delta(start, size)

    @operator
    def stage(task):
        mip = args.mip if args.mip is not None else state["mip"]
        # the task's own bbox wins; the explicit box serves a chain
        # without a task grid
        if task.get("bbox") is not None:
            bbox = task["bbox"]
        elif explicit:
            bbox = explicit_bbox(mip)
        else:
            raise UsageError("no task bbox: run after generate-tasks or a "
                             "fetch-task command, or give --chunk-start/"
                             "--chunk-size")
        if any(args.expand_margin_size):
            bbox = bbox.adjust(args.expand_margin_size)
        chunk = vol.cutout(bbox, mip=mip, fill_missing=args.fill_missing)
        # validate the raw cutout: blackout zeroes data on purpose
        if args.validate_mip is not None and not state["dry_run"]:
            _validate_cutout(vol, chunk, mip, args.validate_mip,
                             args.validate_tolerance)
        if args.blackout_sections:
            sidecar = vol.read_json("blackout_section_ids.json") or {}
            z0, nz = int(chunk.voxel_offset.z), chunk.shape[-3]
            for z in sidecar.get("section_ids", ()):
                if z0 <= z < z0 + nz:
                    chunk.array[..., z - z0, :, :] = 0
        task[args.output_chunk_name] = chunk
        return task

    return stage(_name=args.op_name)


def _validate_cutout(vol, chunk, mip, validate_mip, tolerance=0.01):
    """Mean-pool the cutout to ``validate_mip`` and compare it with a
    direct read of the same window at that mip; raise on a mismatch.

    The reference asserts exact equality after pooling
    (load_precomputed.py:115-182); the JAX package's small default
    tolerance absorbs pyramid rounding and still catches the corrupted or
    partly black cutouts the check exists for, and so does the port's."""
    import logging

    from chunkflow_tpu_torch.chunk.base import as_native_dtype
    from chunkflow_tpu_torch.ops.downsample import downsample_average

    if not (mip < validate_mip < vol.num_mips):
        raise ValueError(
            f"--validate-mip {validate_mip} must be coarser than the load "
            f"mip {mip} and exist in the volume ({vol.num_mips} mips)")
    factor = tuple(int(c // f) for c, f in zip(vol.voxel_size(validate_mip),
                                              vol.voxel_size(mip)))
    # a window whose offset AND extent are factor-aligned, so the pooled
    # grid coincides with the coarse mip's voxel grid
    offset = tuple(int(o) for o in chunk.voxel_offset)
    skip = tuple((-o) % f for o, f in zip(offset, factor))
    aligned = tuple((s - k) - (s - k) % f
                    for s, k, f in zip(chunk.shape[-3:], skip, factor))
    if any(a < f for a, f in zip(aligned, factor)):
        return  # window too small to compare
    sub = chunk.cutout(BoundingBox(
        tuple(o + k for o, k in zip(offset, skip)),
        tuple(o + k + a for o, k, a in zip(offset, skip, aligned))))
    pooled = downsample_average(sub, factor=factor)
    ref = vol.cutout(pooled.bbox, mip=validate_mip, fill_missing=True)
    a = as_native_dtype(pooled.array).astype(np.float64)
    b = as_native_dtype(ref.array).astype(np.float64)
    err = float(np.abs(a - b).mean())
    scale = max(float(np.abs(b).mean()), 1e-6)
    if err / scale > tolerance:
        msg = (f"cross-mip validation mismatch (mip {mip} vs "
               f"{validate_mip}): mean|diff|={err:.4f} vs "
               f"mean|ref|={scale:.4f} (relative {err / scale:.4f} > "
               f"tolerance {tolerance})")
        logging.warning(msg)
        raise ValueError(msg)


def _save_precomputed_options(p):
    _name(p, "save-precomputed")
    p.add_argument("--volume-path", "-v", required=True)
    p.add_argument("--mip", type=int, default=None)
    p.add_argument("--upload-log", action=argparse.BooleanOptionalAction,
                   default=True, help="write the task's timers to "
                                      "<volume>/log/<bbox>.json")
    p.add_argument("--create-thumbnail",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="also write the chunk's pyramid into the volume's "
                        "coarser mips")
    p.add_argument("--intensity-threshold", type=float, default=None,
                   help="skip the write when the chunk's max is below this")
    p.add_argument("--parallel", type=int, default=1,
                   help="accepted for compatibility; blocks are written "
                        "concurrently anyway")
    _on_off(p, "--async-write", "--sync-write", default=False,
            help="do not wait for the write: it is drained before the "
                 "task's ack (delete-task-in-queue, mark-complete, the "
                 "end of the pipeline)")
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _save_precomputed(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.precomputed import (
        PrecomputedVolume,
        _local_root,
    )

    vol = PrecomputedVolume(args.volume_path)

    @write_operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if state["dry_run"]:
            return task
        thr = args.intensity_threshold
        if thr is not None and thr < 1.0 \
                and numpy_dtype(chunk.dtype) == np.uint8:
            # a probability threshold on 0-255 data
            thr = thr * 255.0
            print(f"intensity threshold rescaled to {thr} for uint8 chunk")
        if thr is not None and float(chunk.array.max()) < thr:
            print(f"skip save: max intensity below {thr}")
            return task
        future = vol.save(chunk,
                          mip=args.mip if args.mip is not None
                          else state["mip"],
                          wait=not args.async_write)
        if future is not None:
            task.setdefault("pending_writes", []).append(future)
        if args.create_thumbnail:
            _write_thumbnails(vol, chunk)
        local = _local_root(args.volume_path)
        if args.upload_log and local is not None:  # a cloud volume: none
            log_dir = os.path.join(local, "log")
            os.makedirs(log_dir, exist_ok=True)
            record = {"timer": task["log"]["timer"],
                      "compute_device": task["log"].get("compute_device", ""),
                      "bbox": chunk.bbox.string}
            with open(os.path.join(log_dir, f"{chunk.bbox.string}.json"),
                      "w") as f:
                json.dump(record, f)
        return task

    return stage(_name=args.op_name)


def _write_thumbnails(vol, chunk) -> None:
    """The chunk's pyramid into the volume's mips 1..n-1; a 4D chunk is
    first quantized to a uint8 image, as an affinity map."""
    from chunkflow_tpu_torch.chunk import AffinityMap
    from chunkflow_tpu_torch.ops.downsample import pyramid

    thumb = chunk
    if thumb.ndim == 4:
        thumb = AffinityMap(thumb.array, voxel_offset=thumb.voxel_offset,
                            voxel_size=thumb.voxel_size).quantize()
    for level, down in enumerate(pyramid(thumb, num_mips=vol.num_mips - 1),
                                 start=1):
        vol.save(down, mip=level)


def _skip_task_by_blocks_options(p):
    _name(p, "skip-task-by-blocks-in-volume")
    p.add_argument("--volume-path", "-v", required=True)
    p.add_argument("--mip", type=int, default=None)


def _skip_task_by_blocks(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    vol = PrecomputedVolume(args.volume_path)

    @operator
    def stage(task):
        mip = args.mip if args.mip is not None else state["mip"]
        return None if vol.has_all_blocks(task["bbox"], mip=mip) else task

    return stage(_name=args.op_name)


def _mark_complete_options(p):
    _name(p, "mark-complete")
    p.add_argument("--prefix", "-p", required=True)
    p.add_argument("--suffix", "-s", default=".done")


def _mark_complete(args, state) -> Stage:
    @write_operator
    def stage(task):
        # the marker claims completion: async writes are durable first
        drain_pending_writes(task)
        if not state["dry_run"]:
            os.makedirs(os.path.dirname(args.prefix) or ".", exist_ok=True)
            with open(f"{args.prefix}{task['bbox'].string}{args.suffix}",
                      "w"):
                pass
        return task

    return stage(_name=args.op_name)


# ---------------------------------------------------------------------------
# flow control and task variables
# ---------------------------------------------------------------------------
def _touch_marker(prefix, bbox, suffix, state):
    """Touch <prefix><bbox><suffix> as a skip/resume marker (never under
    --dry-run: a dry preview must not fabricate resume state)."""
    if state["dry_run"]:
        return
    fname = f"{prefix}{bbox.string}{suffix}"
    if not os.path.exists(fname):
        open(fname, "a").close()


def _names(text: Optional[str]) -> List[str]:
    return [n.strip() for n in (text or "").split(",") if n.strip()]


def _cleanup_options(p):
    _name(p, "cleanup")
    p.add_argument("--dir", "-d", dest="directory", required=True)
    p.add_argument("--mode", "-m", choices=["exist", "empty", "not-empty"],
                   default="exist",
                   help="remove only files meeting this condition")
    p.add_argument("--suffix", default=".h5")


def _cleanup(args, state) -> Stage:
    def removable(path):
        if not os.path.exists(path):
            return False
        if args.mode == "empty":
            return os.path.getsize(path) == 0
        if args.mode == "not-empty":
            return os.path.getsize(path) > 0
        return True

    @operator
    def stage(task):
        if task.get("bbox") is not None:
            paths = [os.path.join(args.directory,
                                  f"{task['bbox'].string}{args.suffix}")]
        else:
            # a bare seed task sweeps the whole directory
            paths = [
                os.path.join(args.directory, f)
                for f in os.listdir(args.directory)
                if (not args.suffix or f.endswith(args.suffix))
                and os.path.isfile(os.path.join(args.directory, f))
            ]
        for path in paths:
            if removable(path) and not state["dry_run"]:
                os.remove(path)
        return task

    return stage(_name=args.op_name)


def _skip_all_zero_options(p):
    _name(p, "skip-all-zero")
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)
    p.add_argument("--prefix", "-p", default=None,
                   help="touch <prefix><bbox><suffix> as a completion "
                        "marker when skipping")
    p.add_argument("--suffix", "-s", default="")
    p.add_argument("--adjust-size", "-a", type=int, default=None,
                   help="grow/shrink the marker bbox to match result "
                        "filenames")
    _on_off(p, "--chunk-bbox", "--task-bbox", default=True,
            help="name the marker after the chunk bbox or the task bbox")


def _skip_all_zero(args, state) -> Stage:
    @operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if not chunk.all_zero():
            return task
        if args.prefix is not None:
            bbox = chunk.bbox if args.chunk_bbox else task.get("bbox")
            if bbox is not None:
                if args.adjust_size is not None:
                    bbox = bbox.adjust(args.adjust_size)
                _touch_marker(args.prefix, bbox, args.suffix, state)
        return None

    return stage(_name=args.op_name)


def _skip_none_options(p):
    _name(p, "skip-none")
    p.add_argument("--input-chunk-name", "--input-name", "-i",
                   default=DEFAULT_CHUNK_NAME)
    p.add_argument("--prefix", "-p", default=None,
                   help="touch <prefix><bbox><suffix> as a marker when "
                        "skipping")
    p.add_argument("--suffix", "-s", default="")


def _skip_none(args, state) -> Stage:
    @operator
    def stage(task):
        if task.get(args.input_chunk_name) is None:
            if args.prefix is not None and task.get("bbox") is not None:
                _touch_marker(args.prefix, task["bbox"], args.suffix, state)
            return None
        return task

    return stage(_name=args.op_name)


def _skip_task_by_file_options(p):
    _name(p, "skip-task-by-file")
    p.add_argument("--prefix", "-p", required=True, help="marker path prefix")
    p.add_argument("--suffix", "-s", default=".h5")
    p.add_argument("--mode", "-m", choices=["missing", "empty", "exist"],
                   default="exist",
                   help="skip when the file is missing / missing-or-empty / "
                        "exists")
    p.add_argument("--adjust-size", "-a", type=int, default=None,
                   help="grow/shrink the bbox used in the file name")


def _skip_task_by_file(args, state) -> Stage:
    @operator
    def stage(task):
        bbox = task["bbox"]
        if args.adjust_size is not None:
            bbox = bbox.adjust(args.adjust_size)
        path = f"{args.prefix}{bbox.string}{args.suffix}"
        if args.mode == "exist":
            skip = os.path.exists(path)
        elif args.mode == "missing":
            skip = not os.path.exists(path)
        else:  # empty
            skip = not os.path.exists(path) or os.path.getsize(path) == 0
        return None if skip else task

    return stage(_name=args.op_name)


def _adjust_bbox_options(p):
    _name(p, "adjust-bbox")
    _triple(p, "--corner-offset", required=True,
            help="grow(+)/shrink(-) both corners")


def _adjust_bbox(args, state) -> Stage:
    @operator
    def stage(task):
        task["bbox"] = task["bbox"].adjust(args.corner_offset)
        return task

    return stage(_name=args.op_name)


def _delete_var_options(p):
    _name(p, "delete-var")
    p.add_argument("--var-names", "-v", required=True,
                   help="comma-separated task keys")


def _delete_var(args, state) -> Stage:
    @operator
    def stage(task):
        for name in args.var_names.split(","):
            task.pop(name.strip(), None)
        return task

    return stage(_name=args.op_name)


def _copy_var_options(p):
    _name(p, "copy-var")
    p.add_argument("--from-name", "-f", required=True)
    p.add_argument("--to-name", "-t", required=True)


def _copy_var(args, state) -> Stage:
    @operator
    def stage(task):
        task[args.to_name] = task[args.from_name]
        return task

    return stage(_name=args.op_name)


def _load_json_options(p):
    _name(p, "load-json")
    p.add_argument("--file-name", "--file-path", "-f", required=True)
    p.add_argument("--output-name", "-o", default="json")


def _load_json(args, state) -> Stage:
    @operator
    def stage(task):
        with open(args.file_name) as f:
            task[args.output_name] = json.load(f)
        return task

    return stage(_name=args.op_name)


def _debug_options(p):
    _name(p, "debug")


def _debug(args, state) -> Stage:
    @operator
    def stage(task):
        breakpoint()  # noqa: T100 - the command's purpose
        return task

    return stage(_name=args.op_name)


# ---------------------------------------------------------------------------
# chunk operators
# ---------------------------------------------------------------------------
def _in_out(p, in_names=("--input-chunk-name", "-i"),
            out_names=("--output-chunk-name", "-o"),
            out_default=DEFAULT_CHUNK_NAME):
    p.add_argument(*in_names, dest="input_chunk_name",
                   default=DEFAULT_CHUNK_NAME)
    p.add_argument(*out_names, dest="output_chunk_name", default=out_default)


def _crop_margin_options(p):
    _name(p, "crop-margin")
    _triple(p, "--margin-size", "-m", default=None)
    _in_out(p)


def _crop_margin(args, state) -> Stage:
    @operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if args.margin_size and any(args.margin_size):
            cropped = chunk.crop_margin(args.margin_size)
        elif task.get("bbox") is not None:
            cropped = chunk.cutout(task["bbox"])
        else:
            raise UsageError("need --margin-size or a task bbox")
        task[args.output_chunk_name] = cropped
        return task

    return stage(_name=args.op_name)


def _threshold_options(p):
    _name(p, "threshold")
    p.add_argument("--threshold", "-t", type=float, default=0.5)
    _in_out(p)


def _threshold(args, state) -> Stage:
    @operator
    def stage(task):
        task[args.output_chunk_name] = task[args.input_chunk_name].threshold(
            args.threshold)
        return task

    return stage(_name=args.op_name)


def _channel_voting_options(p):
    _name(p, "channel-voting")
    _in_out(p)


def _channel_voting(args, state) -> Stage:
    @operator
    def stage(task):
        task[args.output_chunk_name] = \
            task[args.input_chunk_name].channel_voting(
                device=state["device"])
        return task

    return stage(_name=args.op_name)


def _normalize_contrast_options(p):
    _name(p, "normalize-contrast")
    p.add_argument("--lower-clip-fraction", "-l", type=float, default=0.01)
    p.add_argument("--upper-clip-fraction", "-u", type=float, default=0.01)
    p.add_argument("--minval", type=int, default=1,
                   help="minimum intensity of the transformed chunk")
    p.add_argument("--maxval", type=int, default=255,
                   help="maximum intensity of the transformed chunk")
    _on_off(p, "--per-section", "--whole", default=True,
            help="normalize each z-section independently or the whole "
                 "chunk")
    _in_out(p)


def _normalize_contrast(args, state) -> Stage:
    from chunkflow_tpu_torch.chunk import Image

    @operator
    def stage(task):
        img = task[args.input_chunk_name]
        if not isinstance(img, Image):
            img = Image(img.array, voxel_offset=img.voxel_offset,
                        voxel_size=img.voxel_size)
        task[args.output_chunk_name] = img.normalize_contrast(
            lower_clip_fraction=args.lower_clip_fraction,
            upper_clip_fraction=args.upper_clip_fraction,
            minval=args.minval,
            maxval=args.maxval,
            per_section=args.per_section,
        )
        return task

    return stage(_name=args.op_name)


def _normalize_intensity_options(p):
    _name(p, "normalize-intensity")
    _in_out(p)


def _normalize_intensity(args, state) -> Stage:
    """uint8 grey image -> float32 in (-1, 1): x/127.5 - 1."""
    @operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if numpy_dtype(chunk.dtype) != np.uint8:
            raise UsageError("normalize-intensity expects a uint8 image "
                             "chunk")
        out = chunk.astype(np.float32)
        task[args.output_chunk_name] = out / 127.5 - 1.0
        return task

    return stage(_name=args.op_name)


def _click_bool(text: str) -> bool:
    """click's BOOL parameter type."""
    value = text.strip().lower()
    if value in ("1", "true", "t", "yes", "y", "on"):
        return True
    if value in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"{text!r} is not a valid boolean")


def _normalize_section_shang_options(p):
    _name(p, "normalize-section-shang")
    p.add_argument("--nominalmin", type=float, default=None,
                   help="targeted minimum of the transformed chunk")
    p.add_argument("--nominalmax", type=float, default=None,
                   help="targeted maximum of the transformed chunk")
    p.add_argument("--clipvalues", type=_click_bool, default=False,
                   help="clip transformed values to the target range")
    _in_out(p)


def _normalize_section_shang(args, state) -> Stage:
    from chunkflow_tpu_torch.chunk import Image

    @operator
    def stage(task):
        img = task[args.input_chunk_name]
        if not isinstance(img, Image):
            img = Image.from_chunk(img)
        task[args.output_chunk_name] = img.normalize_shang(
            nominalmin=args.nominalmin, nominalmax=args.nominalmax,
            clipvalues=args.clipvalues)
        return task

    return stage(_name=args.op_name)


def _mask_options(p):
    _name(p, "mask")
    p.add_argument("--volume-path", "-v", required=True,
                   help="mask volume (its voxel size may be any integer "
                        "multiple of the chunk's)")
    p.add_argument("--mip", type=int, default=0,
                   help="scale index within the mask volume")
    _on_off(p, "--inverse", "--no-inverse", default=False)
    _on_off(p, "--fill-missing", "--no-fill-missing", default=True)
    _in_out(p, in_names=("--input-chunk-name", "--input-names", "-i"),
            out_names=("--output-chunk-name", "--output-names", "-o"),
            out_default=None)


def _mask(args, state) -> Stage:
    import math

    from chunkflow_tpu_torch.core.cartesian import Cartesian
    from chunkflow_tpu_torch.ops.mask import maskout
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    vol = PrecomputedVolume(args.volume_path)
    in_names = _names(args.input_chunk_name)
    out_names = _names(args.output_chunk_name) or in_names
    if len(in_names) != len(out_names):
        raise UsageError("input/output name counts must match")

    @operator
    def stage(task):
        first = task[in_names[0]]
        factor = vol.voxel_size(args.mip) / first.voxel_size
        start = Cartesian(*(int(math.floor(s / f))
                            for s, f in zip(first.bbox.start, factor)))
        stop = Cartesian(*(int(math.ceil(e / f))
                           for e, f in zip(first.bbox.stop, factor)))
        mask_chunk = vol.cutout(BoundingBox(start, stop), mip=args.mip,
                                fill_missing=args.fill_missing)
        # one mask cutout masks every listed chunk
        for in_name, out_name in zip(in_names, out_names):
            task[out_name] = maskout(task[in_name], mask_chunk,
                                     inverse=args.inverse,
                                     device=state["device"])
        return task

    return stage(_name=args.op_name)


def _multiply_options(p):
    _name(p, "multiply")
    p.add_argument("--input-names", "-i", default=DEFAULT_CHUNK_NAME,
                   help="comma-separated chunk names")
    p.add_argument("--multiplier-name", "-m", default=None,
                   help="multiply every input by this chunk; without it, "
                        "exactly two input names multiply together")
    p.add_argument("--output-names", "--output-chunk-name", "-o",
                   default=None, help="defaults to the input names")


def _multiply(args, state) -> Stage:
    in_names = _names(args.input_names)
    outs = _names(args.output_names) or None
    # fail at pipeline assembly, before any task has done real work
    if args.multiplier_name is not None:
        outs = outs if outs is not None else in_names
        if len(outs) != len(in_names):
            raise UsageError("input/output name counts must match")
    else:
        if len(in_names) != 2:
            raise UsageError("without --multiplier-name, give exactly two "
                             "--input-names to multiply together")
        outs = outs if outs is not None else [DEFAULT_CHUNK_NAME]
        if len(outs) != 1:
            raise UsageError("two-input multiply writes one output name")

    @operator
    def stage(task):
        if args.multiplier_name is not None:
            for in_name, out_name in zip(in_names, outs):
                task[out_name] = task[in_name] * task[args.multiplier_name]
        else:
            task[outs[0]] = task[in_names[0]] * task[in_names[1]]
        return task

    return stage(_name=args.op_name)


def _mask_out_objects_options(p):
    _name(p, "mask-out-objects")
    p.add_argument("--dust-size-threshold", "-d", type=int, default=0)
    p.add_argument("--selected-obj-ids", "-s", default=None,
                   help="comma-separated keep list")
    _in_out(p)


def _mask_out_objects(args, state) -> Stage:
    from chunkflow_tpu_torch.chunk import Segmentation

    @operator
    def stage(task):
        seg = task[args.input_chunk_name]
        if not isinstance(seg, Segmentation):
            seg = Segmentation.from_chunk(seg)
        if args.dust_size_threshold:
            seg = seg.mask_fragments(args.dust_size_threshold)
        if args.selected_obj_ids:
            seg = seg.mask_except(
                [int(x) for x in args.selected_obj_ids.split(",")])
        task[args.output_chunk_name] = seg
        return task

    return stage(_name=args.op_name)


def _quantize_options(p):
    _name(p, "quantize")
    p.add_argument("--mode", choices=["xy", "z"], default="xy")
    _in_out(p)


def _quantize(args, state) -> Stage:
    """Compress an affinity map into a uint8 thumbnail image."""
    from chunkflow_tpu_torch.chunk import AffinityMap

    @operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        aff = AffinityMap(chunk.array, voxel_offset=chunk.voxel_offset,
                          voxel_size=chunk.voxel_size)
        task[args.output_chunk_name] = aff.quantize(mode=args.mode)
        return task

    return stage(_name=args.op_name)


def _connected_components_options(p):
    _name(p, "connected-components")
    p.add_argument("--threshold", "-t", type=float, default=0.5)
    p.add_argument("--connectivity", "-c", choices=["6", "18", "26"],
                   default="26")
    _on_off(p, "--device", "--host", default=False,
            help="label by iterative propagation where the chunk lies (a "
                 "host chunk: on the group --device) instead of the host "
                 "union-find; device labels are non-consecutive uint32 "
                 "(linear-index seeds), the host's consecutive")
    _in_out(p)


def _connected_components(args, state) -> Stage:
    device = state["device"] if args.device else False

    @operator
    def stage(task):
        task[args.output_chunk_name] = \
            task[args.input_chunk_name].connected_component(
                threshold=args.threshold,
                connectivity=int(args.connectivity), device=device)
        return task

    return stage(_name=args.op_name)


def _downsample_options(p):
    _name(p, "downsample")
    _triple(p, "--factor", "-f", default=(1, 2, 2))
    _in_out(p)


def _downsample(args, state) -> Stage:
    from chunkflow_tpu_torch.ops.downsample import downsample

    @operator
    def stage(task):
        task[args.output_chunk_name] = downsample(task[args.input_chunk_name],
                                                  args.factor)
        return task

    return stage(_name=args.op_name)


def _downsample_upload_options(p):
    _name(p, "downsample-upload")
    p.add_argument("--volume-path", "-v", required=True)
    _triple(p, "--factor", "-f", default=(1, 2, 2))
    p.add_argument("--chunk-mip", type=int, default=None,
                   help="mip of the incoming chunk (default: the group "
                        "--mip); pyramid levels count from here")
    p.add_argument("--start-mip", type=int, default=None,
                   help="first level written (default: chunk mip + 1)")
    p.add_argument("--stop-mip", type=int, default=None,
                   help="exclusive; default: the volume's mip count")
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _downsample_upload(args, state) -> Stage:
    """Build a mip pyramid of the chunk and write every level."""
    from chunkflow_tpu_torch.ops.downsample import downsample
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    vol = PrecomputedVolume(args.volume_path)

    @operator
    def stage(task):
        base = args.chunk_mip if args.chunk_mip is not None else state["mip"]
        first = args.start_mip if args.start_mip is not None else base + 1
        if first <= base:
            raise UsageError(f"--start-mip ({first}) must be above the chunk "
                             f"mip ({base})")
        stop = args.stop_mip if args.stop_mip is not None else vol.num_mips
        current = task[args.input_chunk_name]
        for level in range(base + 1, stop):
            current = downsample(current, args.factor)
            if level >= first and not state["dry_run"]:
                vol.save(current, mip=level)
        return task

    return stage(_name=args.op_name)


def _gaussian_filter_options(p):
    _name(p, "gaussian-filter")
    p.add_argument("--sigma", "-s", type=float, default=1.0)
    _in_out(p)


def _gaussian_filter(args, state) -> Stage:
    @operator
    def stage(task):
        task[args.output_chunk_name] = \
            task[args.input_chunk_name].gaussian_filter_2d(args.sigma)
        return task

    return stage(_name=args.op_name)


def _evaluate_segmentation_options(p):
    _name(p, "evaluate-segmentation")
    p.add_argument("--segmentation-chunk-name", "-s",
                   default=DEFAULT_CHUNK_NAME)
    p.add_argument("--groundtruth-chunk-name", "-g", required=True)
    p.add_argument("--output", "-o", default=None,
                   help="append per-task scores to this JSON-lines file")


def _evaluate_segmentation(args, state) -> Stage:
    from chunkflow_tpu_torch.chunk import Segmentation

    @operator
    def stage(task):
        seg = task[args.segmentation_chunk_name]
        if not isinstance(seg, Segmentation):
            seg = Segmentation.from_chunk(seg)
        scores = seg.evaluate(task[args.groundtruth_chunk_name])
        print("segmentation evaluation:", scores)
        task["evaluation"] = scores
        if args.output:
            record = dict(scores)
            if task.get("bbox") is not None:
                record["bbox"] = task["bbox"].string
            with open(args.output, "a") as f:
                f.write(json.dumps(record) + "\n")
        return task

    return stage(_name=args.op_name)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------
def _inference_options(p):
    _name(p, "inference")
    _triple(p, "--input-patch-size", "-p", "-s", required=True)
    _triple(p, "--output-patch-size", "-z", default=None)
    _triple(p, "--output-patch-overlap", "-v", default=(0, 0, 0))
    _triple(p, "--output-crop-margin", default=None,
            help="explicit output crop margin; default: (input-output)//2 "
                 "patch margin when cropping is on")
    _triple(p, "--patch-num", "-n", default=None,
            help="expected patch grid in z,y,x; errors if the chunk's "
                 "grid differs")
    p.add_argument("--num-output-channels", "-c", type=int, default=3)
    p.add_argument("--num-input-channels", type=int, default=1)
    p.add_argument("--framework", "-f",
                   choices=["identity", "flax", "jax", "pytorch", "universal"],
                   default="flax")
    p.add_argument("--model-path", "--convnet-model", "-m", default="")
    p.add_argument("--weight-path", "--convnet-weight-path", "-w",
                   default=None,
                   help="weights: a .pt/.pth state dict (by name, BatchNorm "
                        "folded) or a flax .msgpack file; none: a seeded "
                        "init")
    p.add_argument("--batch-size", "-b", type=int, default=1)
    p.add_argument("--bump", choices=["wu", "zung"], default="wu")
    p.add_argument("--augment", action=argparse.BooleanOptionalAction,
                   default=False, help="8x test-time augmentation")
    p.add_argument("--crop-output-margin",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--mask-myelin-threshold", "-y", type=float, default=None)
    p.add_argument("--dtype", "-d", choices=["float32", "bfloat16", "float16"],
                   default="float32")
    p.add_argument("--output-dtype", choices=["float32", "bfloat16", "uint8"],
                   default="float32")
    p.add_argument("--model-variant",
                   choices=["parity", "rsunet", "tpu", "tpu_mxu", "tpu_s2d4"],
                   default="parity")
    p.add_argument("--sharding",
                   choices=["none", "patch", "spatial", "spatial2d"],
                   default="none",
                   help="legacy multi-device layout names over all local "
                        "devices; aliases for the mesh engine (patch -> "
                        "data=N, spatial -> y=N, spatial2d -> near-square "
                        "y,x). Prefer --mesh / CHUNKFLOW_MESH")
    p.add_argument("--mesh", default=None,
                   help="mesh spec: 1 (one device), auto, data=N "
                        "(patch-parallel over N devices), y=A or y=A,x=B "
                        "(the chunk sharded in slabs with halo exchange), "
                        "pipeline=N (layer-parallel stages over engines "
                        "declaring the stage protocol). Every shape is "
                        "bitwise the one-device path. Overrides "
                        "CHUNKFLOW_MESH; does not compose with the legacy "
                        "--sharding names")
    _triple(p, "--shape-bucket", default=None,
            help="pad chunk shapes up to multiples of this zyx quantum")
    p.add_argument("--blend", choices=["auto", "scatter", "fold"],
                   default="auto",
                   help="overlap-add strategy: scatter (the kernels), fold "
                        "(parity-class dense adds; pads the chunk to a "
                        "uniform patch grid), auto (CHUNKFLOW_BLEND or "
                        "scatter)")
    p.add_argument("--async-depth", type=int, default=1,
                   help="pipeline up to N tasks through the card: task i+1 "
                        "uploads and task i-1 downloads while task i "
                        "computes. 1 = synchronous. Under the adaptive "
                        "scheduler (default; CHUNKFLOW_SCHED=static "
                        "disables) the initial depth, widened up to the "
                        "memory watermark (CHUNKFLOW_SCHED_MEM_GB)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="adaptive scheduler with --async-depth > 1: initial "
                        "number of upstream tasks pulled ahead in the "
                        "scheduler's load thread")
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)


def _inference(args, state) -> Stage:
    from chunkflow_tpu_torch.flow.scheduler import scheduler_mode
    from chunkflow_tpu_torch.inference.inferencer import Inferencer

    if args.bump != "wu":
        raise UsageError(f"bump '{args.bump}' is not implemented; only 'wu' "
                         f"is (matching the reference)")
    dtype = "bfloat16" if args.dtype == "float16" else args.dtype
    explicit_crop = args.output_crop_margin
    out_patch = args.output_patch_size
    # one Inferencer shared across the stream's tasks
    inferencer = Inferencer(
        input_patch_size=args.input_patch_size,
        output_patch_size=out_patch if out_patch and any(out_patch) else None,
        output_patch_overlap=args.output_patch_overlap,
        num_output_channels=args.num_output_channels,
        num_input_channels=args.num_input_channels,
        framework=args.framework,
        model_path=args.model_path,
        weight_path=args.weight_path,
        batch_size=args.batch_size,
        augment=args.augment,
        bump=args.bump,
        crop_output_margin=args.crop_output_margin and explicit_crop is None,
        mask_myelin_threshold=args.mask_myelin_threshold,
        dtype=dtype,
        output_dtype=args.output_dtype,
        model_variant=args.model_variant,
        shape_bucket=args.shape_bucket,
        sharding=args.sharding,
        mesh=args.mesh,
        blend=args.blend,
        dry_run=state["dry_run"],
        device=state["device"],
    )
    expected = tuple(args.patch_num) if args.patch_num is not None else None

    def check_grid(chunk):
        if expected is not None:
            got = inferencer.patch_grid_shape(chunk.shape)
            if got != expected:
                raise UsageError(f"--patch-num {expected} but chunk "
                                 f"{chunk.shape} decomposes into {got} "
                                 f"patches")

    if args.async_depth <= 1:
        @operator
        def stage(task):
            chunk = task[args.input_chunk_name]
            check_grid(chunk)
            out = inferencer(chunk)
            if explicit_crop is not None:
                out = out.crop_margin(explicit_crop)
            task[args.output_chunk_name] = out
            task["log"]["compute_device"] = inferencer.compute_device
            return task

        return stage(_name=args.op_name)

    kwargs = dict(depth=args.async_depth, input_name=args.input_chunk_name,
                  output_name=args.output_chunk_name, op_name=args.op_name,
                  crop=explicit_crop, check=check_grid)
    if scheduler_mode() == "static":
        from chunkflow_tpu_torch.flow.pipeline import pipelined_inference_stage

        return pipelined_inference_stage(inferencer, **kwargs)
    from chunkflow_tpu_torch.flow.scheduler import scheduled_inference_stage

    return scheduled_inference_stage(
        inferencer, prefetch_depth=args.prefetch_depth, **kwargs)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _serve_options(p):
    p.add_argument("--port", type=int, default=0,
                   help="HTTP listener port; 0 (default) binds an ephemeral "
                        "port and prints it")
    p.add_argument("--host", default="0.0.0.0")
    _triple(p, "--input-patch-size", "-p", "-s", default=None,
            help="required unless --spool (external workers own the "
                 "model there)")
    _triple(p, "--output-patch-size", "-z", default=None)
    _triple(p, "--output-patch-overlap", default=(0, 0, 0))
    p.add_argument("--num-output-channels", "-c", type=int, default=3)
    p.add_argument("--num-input-channels", type=int, default=1)
    p.add_argument("--framework", "-f",
                   choices=["identity", "flax", "jax", "pytorch", "universal"],
                   default="flax")
    p.add_argument("--model-path", "-m", default="")
    p.add_argument("--weight-path", "-w", default=None)
    p.add_argument("--batch-size", "-b", type=int, default=4)
    p.add_argument("--output-dtype", choices=["float32", "bfloat16", "uint8"],
                   default="float32")
    p.add_argument("--crop-output-margin",
                   action=argparse.BooleanOptionalAction, default=True)
    _triple(p, "--shape-bucket", default=None,
            help="pad request shapes up to multiples of this zyx quantum")
    p.add_argument("--serve-workers", type=int, default=2,
                   help="in-process lifecycle worker threads claiming "
                        "requests (local mode)")
    p.add_argument("--max-inflight", type=int, default=8,
                   help="admission control: concurrent requests past this "
                        "are rejected 429")
    p.add_argument("--default-deadline-s", type=float, default=30.0,
                   help="per-request deadline when the request carries "
                        "none; a miss is a 504")
    p.add_argument("--max-retries", type=int, default=2,
                   help="lifecycle retry budget per request")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="how long a partial device batch waits for more "
                        "patches before it is dispatched underfull")
    p.add_argument("--spool", default=None,
                   help="spool mode: requests land in <dir>/in and a file "
                        "queue, and external supervised workers complete "
                        "them; this process serves HTTP only")
    p.add_argument("--visibility-timeout", "-v", type=int, default=30,
                   help="request lease timeout: a worker that dies "
                        "mid-request loses the lease and the request is "
                        "redelivered")
    p.add_argument("--max-runtime", type=float, default=None,
                   help="exit after this many seconds; default: run until "
                        "SIGTERM or SIGINT")


def _serve(args, state) -> Stage:
    """``POST /infer`` over HTTP, each request a supervised task whose
    patches share the packer's device batches (``serve/frontend.py``);
    drains on SIGTERM, SIGINT or at ``--max-runtime``."""
    if args.spool is None and (args.input_patch_size is None
                               or not any(args.input_patch_size)):
        raise UsageError("serve needs --input-patch-size (or --spool for "
                         "external-worker mode)")

    @generator
    def stage(task):
        import time

        from chunkflow_tpu_torch.parallel import lifecycle
        from chunkflow_tpu_torch.parallel.restapi import (
            bound_port,
            shutdown_server,
            write_endpoint_file,
        )
        from chunkflow_tpu_torch.serve.frontend import (
            AdmissionController,
            LocalBackend,
            ServingService,
            SpoolBackend,
            start_serving,
        )

        if args.spool is None:
            from chunkflow_tpu_torch.inference.inferencer import Inferencer

            out_patch = args.output_patch_size
            inferencer = Inferencer(
                input_patch_size=args.input_patch_size,
                output_patch_size=(out_patch if out_patch and any(out_patch)
                                   else None),
                output_patch_overlap=args.output_patch_overlap,
                num_output_channels=args.num_output_channels,
                num_input_channels=args.num_input_channels,
                framework=args.framework,
                model_path=args.model_path,
                weight_path=args.weight_path,
                batch_size=args.batch_size,
                output_dtype=args.output_dtype,
                crop_output_margin=args.crop_output_margin,
                shape_bucket=args.shape_bucket,
                dry_run=state["dry_run"],
                device=state["device"],
            )
            backend = LocalBackend(
                inferencer, workers=args.serve_workers,
                max_retries=args.max_retries, max_wait_ms=args.max_wait_ms,
                visibility_timeout=args.visibility_timeout)
        else:
            backend = SpoolBackend(args.spool,
                                   visibility_timeout=args.visibility_timeout)
        admission = AdmissionController(max_inflight=args.max_inflight)
        service = ServingService(backend, admission=admission,
                                 default_deadline_s=args.default_deadline_s)
        server = start_serving(service, host=args.host, port=args.port)
        actual = bound_port(server)
        # port 0 is the default: always say where the listener landed
        print(f"serving: http://{args.host}:{actual}/infer "
              f"(mode={'spool' if args.spool else 'local'})", flush=True)
        if telemetry.configured_path():
            write_endpoint_file(os.path.dirname(telemetry.configured_path()),
                                serving_port=actual)
        deadline = (time.time() + args.max_runtime
                    if args.max_runtime is not None else None)
        restore = lifecycle.install_preemption_handler()
        try:
            while deadline is None or time.time() < deadline:
                time.sleep(0.2)
        except (KeyboardInterrupt, SystemExit):
            print("serve: draining on preemption signal", flush=True)
        finally:
            restore()
            # stop admitting, finish what is in flight, close the listener
            admission.drain()
            shutdown_server(server)
            backend.close()
            stats = service.serving_stats()
            print(f"serve drained: {stats['requests']:g} request(s), "
                  f"{stats['completed']:g} completed, "
                  f"{stats['rejected_admission'] + stats['rejected_memory']:g}"
                  f" rejected, {stats['deadline_missed']:g} deadline "
                  f"miss(es), {stats['errors']:g} error(s)", flush=True)
        return
        yield

    return stage()


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def _mesh_options(p):
    _name(p, "mesh")
    p.add_argument("--output-path", "-o", required=True)
    p.add_argument("--output-format", "-t",
                   choices=["precomputed", "obj", "ply"],
                   default="precomputed")
    p.add_argument("--ids", default=None,
                   help="comma-separated object ids (default: all)")
    p.add_argument("--skip-ids", default=None)
    _on_off(p, "--manifest", "--no-manifest", default=False)
    p.add_argument("--simplification-error", "--max-simplification-error",
                   type=float, default=0.0,
                   help="max geometric error in nm for vertex-clustering "
                        "simplification (0 = off)")
    p.add_argument("--simplification-factor", type=int, default=None,
                   help="accepted for reference compatibility; the error "
                        "bound above drives vertex clustering")
    p.add_argument("--mip", type=int, default=None,
                   help="accepted for reference compatibility (chunks "
                        "carry their own voxel size)")
    _triple(p, "--voxel-size", help="override the chunk's voxel size (nm) "
                                    "for meshing")
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _mesh(args, state) -> Stage:
    from chunkflow_tpu_torch.flow.mesh import MeshOperator

    op = MeshOperator(
        args.output_path, output_format=args.output_format,
        ids=[int(x) for x in args.ids.split(",")] if args.ids else None,
        skip_ids=(tuple(int(x) for x in args.skip_ids.split(","))
                  if args.skip_ids else ()),
        manifest=args.manifest,
        simplification_error_nm=args.simplification_error)

    @operator
    def stage(task):
        chunk = task[args.input_chunk_name]
        if args.voxel_size is not None:
            chunk = chunk.with_voxel_size(args.voxel_size)
        count = op(chunk)
        if state["verbose"]:
            print(f"meshed {count} objects")
        return task

    return stage(_name=args.op_name)


def _mesh_manifest_options(p):
    p.add_argument("--mesh-dir", "--volume-path", "-d", "-v", required=True)
    p.add_argument("--prefix", "-p", default=None,
                   help="only aggregate object ids starting with this "
                        "prefix (one job per prefix)")
    p.add_argument("--digits", type=int, default=None,
                   help="accepted for reference compatibility")


def _mesh_manifest(args, state) -> Stage:
    from chunkflow_tpu_torch.flow.mesh import write_manifests

    @generator
    def stage(task):
        count = write_manifests(args.mesh_dir, id_prefix=args.prefix)
        print(f"wrote {count} mesh manifests")
        return
        yield

    return stage()


def _download_mesh_options(p):
    _name(p, "download-mesh")
    p.add_argument("--mesh-dir", "--volume-path", "-v", required=True,
                   help="directory holding mesh fragments and manifests")
    p.add_argument("--ids", "-i", default=None,
                   help="comma-separated object ids, or a text file of them")
    p.add_argument("--input-chunk-name", "--input", default=None,
                   help="rank objects by voxel count from this "
                        "segmentation chunk")
    p.add_argument("--start-rank", "-s", type=int, default=0)
    p.add_argument("--stop-rank", "-p", type=int, default=None)
    p.add_argument("--out-pre", "-o", default="./")
    p.add_argument("--output-format", "--out-format", "-f",
                   choices=["ply", "obj"], default="ply")


def _download_mesh(args, state) -> Stage:
    import re

    from chunkflow_tpu_torch.chunk.base import as_native_dtype
    from chunkflow_tpu_torch.flow.mesh import download_mesh, to_obj, to_ply

    @operator
    def stage(task):
        if args.input_chunk_name is not None:
            seg = as_native_dtype(task[args.input_chunk_name].array)
            unique, count = np.unique(seg, return_counts=True)
            fg = unique != 0
            unique, count = unique[fg], count[fg]
            order = np.argsort(count)[::-1]
            obj_ids = unique[order][args.start_rank:args.stop_rank].tolist()
        else:
            text = args.ids
            if text is not None and os.path.isfile(text):
                with open(text) as f:
                    text = f.read()
            if text is None:
                raise UsageError("need --ids or --input-chunk-name")
            obj_ids = [int(x) for x in re.split(r"[\s,]+", text) if x]
        for obj_id in obj_ids:
            fused = download_mesh(args.mesh_dir, int(obj_id))
            if fused is None:
                print(f"object {obj_id}: no mesh manifest found")
                continue
            vertices, faces = fused
            out = f"{args.out_pre}{obj_id}.{args.output_format}"
            with open(out, "w") as f:
                f.write((to_ply if args.output_format == "ply" else to_obj)(
                    vertices, faces))
            print(f"wrote {out} ({vertices.shape[0]} vertices)")
        return task

    return stage(_name=args.op_name)


# ---------------------------------------------------------------------------
# the segmentation plane
# ---------------------------------------------------------------------------
def _segment_stage_options(name: str):
    def options(p):
        _name(p, name)
        p.add_argument("--seg-dir", "-d", required=True,
                       help="segmentation job directory (written by "
                            "segment-volume)")

    return options


def _segment_stage(kind: str):
    """One worker stage of the stitching job: run the queue bodies of
    ``kind`` against the job directory's store (opened once per process,
    labelling on the group ``--device`` when the job asks for the device
    leg), pass every other task through, so one worker chains all three
    stages."""

    def build(args, state) -> Stage:
        from chunkflow_tpu_torch.segment.driver import open_store
        from chunkflow_tpu_torch.segment.plan import SegmentPlan
        from chunkflow_tpu_torch.segment.stages import execute_body

        cache = {}

        @operator
        def stage(task):
            body = task.get("task_body")
            if body is None:
                return task
            parsed = SegmentPlan.parse_body(body)
            if parsed is None or parsed[0] != kind:
                return task
            if "store" not in cache:
                cache["store"] = open_store(args.seg_dir,
                                            device=state["device"])
            execute_body(cache["store"], body)
            return task

        return stage(_name=args.op_name)

    return build


def _segment_volume_options(p):
    p.add_argument("--input-npy", "-i", required=True,
                   help="source volume (.npy): probability map, binary mask "
                        "or multi-valued ids")
    p.add_argument("--seg-dir", "-d", required=True,
                   help="job directory: spec.json, the label volume and the "
                        "face, merge and remap sidecars")
    _triple(p, "--chunk-size", "-c", required=True,
            help="grid chunk size (zyx)")
    p.add_argument("--threshold", "-t", type=float, default=0.5)
    p.add_argument("--connectivity", choices=["6", "18", "26"], default="26")
    _on_off(p, "--multivalue", "--binary", default=False,
            help="treat the input as multi-valued ids (equal-value "
                 "connectivity) instead of thresholded/binary")
    _on_off(p, "--device", "--host", default=False,
            help="label chunks by propagation on the group --device (the "
                 "card unless --device cpu) instead of the host union-find")
    p.add_argument("--workers", "-w", type=int, default=4,
                   help="local mode: labelling and relabel threads")
    p.add_argument("--mesh-output", default=None,
                   help="also mesh the merged labels into this directory")
    p.add_argument("--queue-name", "-q", default=None,
                   help="coordinator mode: pump the task tree into this "
                        "queue instead of running it here (needs --ledger)")
    p.add_argument("--ledger", default=None,
                   help="coordinator mode: the ledger the workers commit to "
                        "(children's commits unlock parent merges)")
    p.add_argument("--timeout", type=float, default=None,
                   help="coordinator mode: give up after this many seconds")


def _segment_volume(args, state) -> Stage:
    from chunkflow_tpu_torch.parallel.lifecycle import open_ledger
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.segment.driver import (
        init_store,
        run_coordinator,
        run_local,
    )

    if args.queue_name is not None and args.ledger is None:
        raise UsageError("coordinator mode needs --ledger: children's "
                         "ledger commits are what unlock the parent merges")

    @generator
    def stage(task):
        store = init_store(
            args.seg_dir, args.input_npy, args.chunk_size,
            threshold=args.threshold, connectivity=int(args.connectivity),
            multivalue=args.multivalue,
            device=state["device"] if args.device else False,
            mesh_dir=args.mesh_output)
        if args.queue_name is not None:
            summary = run_coordinator(store, open_queue(args.queue_name),
                                      open_ledger(args.ledger),
                                      timeout=args.timeout)
            print(f"segment-volume: coordinated {summary['tree_tasks']} "
                  f"tree task(s) + {summary['relabel_tasks']} relabel "
                  f"task(s) over {len(store.plan.chunks)} chunk(s)")
        else:
            summary = run_local(store, workers=args.workers)
            print(f"segment-volume: {summary['chunks']} chunk(s) labeled, "
                  f"{summary['merge_nodes']} merge node(s), relabeled in "
                  f"place under {args.seg_dir}")
        if args.mesh_output is not None:
            from chunkflow_tpu_torch.flow.mesh import write_manifests

            write_manifests(args.mesh_output)
        return
        yield

    return stage()


def _log_summary_options(p):
    p.add_argument("--log-dir", "-l", default=None,
                   help="per-task JSON timing logs")
    p.add_argument("--metrics-dir", dest="summary_metrics_dir", default=None,
                   help="the telemetry JSONL directory of a run (its "
                        "--metrics-dir): stall attribution, fault tolerance, "
                        "spans, the fleet's counters")
    _on_off(p, "--fleet", "--no-fleet", default=False,
            help="merge the workers' JSONL by worker: per-worker dominant "
                 "stall, retries, ledger skips, cache hit rates")
    p.add_argument("--trace-id", default=None,
                   help="with --fleet: this task's timeline across workers "
                        "(submit, claims, retries, commit or dead letter)")
    p.add_argument("--slo", dest="slo_view", action="store_true",
                   default=False,
                   help="the SLO block: alerts with their burn rates and "
                        "budgets, each objective's state, fleet-merged "
                        "sparklines")
    p.add_argument("--no-slo", dest="slo_view", action="store_false")
    p.add_argument("--export-trace", default=None, metavar="OUT.JSON",
                   help="write the merged JSONL as a Chrome/Perfetto trace: "
                        "workers as processes, spans as slices, gauges and "
                        "counters as tracks, task hops between workers as "
                        "flows")
    _triple(p, "--output-size", default=None)


def _log_summary(args, state) -> Stage:
    from chunkflow_tpu_torch.flow.log_summary import (
        print_fleet_summary,
        print_slo_summary,
        print_summary,
        print_telemetry_summary,
    )

    if args.log_dir is None and args.summary_metrics_dir is None:
        raise UsageError("log-summary needs --log-dir and/or --metrics-dir")
    if (args.fleet or args.trace_id or args.slo_view or args.export_trace) \
            and args.summary_metrics_dir is None:
        raise UsageError("log-summary --fleet/--trace-id/--slo/"
                         "--export-trace needs --metrics-dir")
    output_size = args.output_size

    @generator
    def stage(task):
        metrics_dir = args.summary_metrics_dir
        if args.log_dir is not None:
            print_summary(args.log_dir, output_size=output_size
                          if output_size and any(output_size) else None)
        if metrics_dir is not None:
            if args.fleet or args.trace_id:
                print_fleet_summary(metrics_dir, trace_id=args.trace_id)
            elif not args.slo_view and not args.export_trace:
                print_telemetry_summary(metrics_dir)
            if args.slo_view:
                print_slo_summary(metrics_dir)
            if args.export_trace:
                from chunkflow_tpu_torch.flow.trace_export import (
                    export_metrics_dir,
                )

                stats = export_metrics_dir(metrics_dir, args.export_trace)
                print(
                    f"exported {stats['trace_events']} trace event(s) "
                    f"({stats['workers']} worker process(es), "
                    f"{stats['flow_pairs']} cross-worker flow(s)) to "
                    f"{args.export_trace}"
                )
                for problem in stats["problems"]:
                    print(f"trace validation: {problem}")
        return
        yield  # a generator that yields nothing

    return stage()


# ---------------------------------------------------------------------------
# annotations: synapses, points, skeletons
# ---------------------------------------------------------------------------
def _load_synapses_options(p):
    _name(p, "load-synapses")
    p.add_argument("--file-name", "--file-path", "-f", required=True,
                   help=".json/.h5 file, or a directory with --suffix")
    p.add_argument("--suffix", "-s", default=".h5",
                   help="with a directory --file-path: load "
                        "<dir>/<bbox><suffix>")
    _triple(p, "--resolution", default=None,
            help="override the synapses' voxel size (nm)")
    p.add_argument("--output-name", "-o", default="synapses")


def _load_synapses(args, state) -> Stage:
    from chunkflow_tpu_torch.annotations.synapses import Synapses

    @operator
    def stage(task):
        path = args.file_name
        if os.path.isdir(path):
            if task.get("bbox") is None:
                raise UsageError("directory --file-path needs a task bbox")
            path = os.path.join(path, f"{task['bbox'].string}{args.suffix}")
        synapses = Synapses.from_file(path)
        if args.resolution is not None:
            synapses.resolution = to_cartesian(args.resolution)
        if task.get("bbox") is not None:
            synapses = synapses.filter_by_bbox(task["bbox"])
        task[args.output_name] = synapses
        return task

    return stage(_name=args.op_name)


def _save_synapses_options(p):
    _name(p, "save-synapses")
    p.add_argument("--file-name", "--file-path", "-f", required=True)
    p.add_argument("--input-name", "-i", default="synapses")


def _save_synapses(args, state) -> Stage:
    @write_operator
    def stage(task):
        task[args.input_name].to_file(args.file_name)
        return task

    return stage(_name=args.op_name)


def _save_points_options(p):
    _name(p, "save-points")
    p.add_argument("--file-name", "--file-path", "-f", required=True,
                   help=".h5 or .npy")
    p.add_argument("--input-name", "-i", default="points")


def _save_points(args, state) -> Stage:
    from chunkflow_tpu_torch.annotations.point_cloud import PointCloud

    @write_operator
    def stage(task):
        points = task[args.input_name]
        if not isinstance(points, PointCloud):
            points = PointCloud(np.asarray(points))
        if args.file_name.endswith(".npy"):
            points.to_npy(args.file_name)
        else:
            points.to_h5(args.file_name)
        return task

    return stage(_name=args.op_name)


def _load_skeleton_options(p):
    _name(p, "load-skeleton")
    p.add_argument("--file-name", "--path", "-f", required=True,
                   help=".swc file")
    _triple(p, "--voxel-offset", "--offset", default=None,
            help="shift node coordinates by this voxel offset")
    _triple(p, "--voxel-size", default=None,
            help="scale voxel-offset shifts into nm (default 1nm)")
    p.add_argument("--output-name", "-o", default="skeleton")


def _load_skeleton(args, state) -> Stage:
    from chunkflow_tpu_torch.annotations.skeleton import Skeleton

    @operator
    def stage(task):
        skel = Skeleton.from_swc(args.file_name)
        if args.voxel_offset is not None:
            vs = np.asarray(args.voxel_size if args.voxel_size is not None
                            else (1, 1, 1))
            skel.nodes += np.asarray(args.voxel_offset) * vs
        task[args.output_name] = skel
        return task

    return stage(_name=args.op_name)


def _save_swc_options(p):
    _name(p, "save-swc")
    p.add_argument("--file-name", "--output-prefix", "-f", required=True,
                   help=".swc path, or a prefix completed per skeleton id")
    p.add_argument("--input-name", "-i", default="skeleton")


def _save_swc(args, state) -> Stage:
    file_name = args.file_name

    @write_operator
    def stage(task):
        value = task[args.input_name]
        if isinstance(value, dict):
            # skeletonize's output, {obj_id: Skeleton}: a file per id
            if file_name.endswith(".swc") and len(value) > 1:
                raise UsageError(
                    "multiple skeletons need a prefix (non-.swc "
                    "--output-prefix), not a single .swc path"
                )
            for obj_id, skel in value.items():
                path = (file_name if file_name.endswith(".swc")
                        else f"{file_name}{obj_id}.swc")
                skel.to_swc(path)
        else:
            path = (file_name if file_name.endswith(".swc")
                    else f"{file_name}.swc")
            value.to_swc(path)
        return task

    return stage(_name=args.op_name)


def _aggregate_skeleton_fragments_options(p):
    p.add_argument("--fragments-path", "--input-name", "-f", required=True)
    p.add_argument("--prefix", "-p", default=None,
                   help="only aggregate fragment files starting with this "
                        "id prefix (one job per prefix)")
    p.add_argument("--output-path", "-o", default=None)


def _aggregate_skeleton_fragments(args, state) -> Stage:
    from chunkflow_tpu_torch.plugins.aggregate_skeleton_fragments import (
        execute,
    )

    @generator
    def stage(task):
        execute(args.fragments_path, args.output_path, id_prefix=args.prefix)
        return
        yield

    return stage()


# ---------------------------------------------------------------------------
# viewers
# ---------------------------------------------------------------------------
def _view_options(p):
    _name(p, "view")
    p.add_argument("--image-chunk-name", default=DEFAULT_CHUNK_NAME)
    p.add_argument("--segmentation-chunk-name", default=None)
    p.add_argument("--screenshot", default=None,
                   help="save a middle-section png instead of opening a "
                        "window")


def _view(args, state) -> Stage:
    @operator
    def stage(task):
        import matplotlib

        if args.screenshot:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        arr = np.asarray(task[args.image_chunk_name].host())
        if arr.ndim == 4:
            arr = arr[0]
        mid = arr[arr.shape[0] // 2]
        ncols = 2 if args.segmentation_chunk_name else 1
        fig, axes = plt.subplots(1, ncols, squeeze=False)
        axes[0][0].imshow(mid, cmap="gray")
        axes[0][0].set_title(args.image_chunk_name)
        if args.segmentation_chunk_name:
            seg = np.asarray(task[args.segmentation_chunk_name].host())
            if seg.ndim == 4:
                seg = seg[0]
            axes[0][1].imshow(seg[seg.shape[0] // 2] % 251, cmap="tab20")
            axes[0][1].set_title(args.segmentation_chunk_name)
        if args.screenshot:
            fig.savefig(args.screenshot, dpi=120)
            print(f"wrote {args.screenshot}")
        else:  # pragma: no cover - interactive
            plt.show()
        plt.close(fig)
        return task

    return stage(_name=args.op_name)


def _viewer_options(name: str):
    def options(p):
        _name(p, name)
        p.add_argument("--chunk-names", "--inputs", "-c",
                       default=DEFAULT_CHUNK_NAME,
                       help="comma-separated task keys to show as layers")
        if name == "neuroglancer":
            p.add_argument("--port", "-p", type=int, default=0)
            _triple(p, "--voxel-size", default=None)
        else:
            _triple(p, "--voxel-size", default=None,
                    help="accepted for reference compatibility (chunks "
                         "carry their own)")

    return options


def _neuroglancer(args, state) -> Stage:
    @operator
    def stage(task):
        try:
            import neuroglancer  # noqa: F401
        except ImportError as exc:
            raise UsageError(
                "the neuroglancer package is not installed in this "
                "environment; install it to use this operator") from exc
        from chunkflow_tpu_torch.flow.viewers import serve_neuroglancer

        serve_neuroglancer(
            {name: task[name] for name in args.chunk_names.split(",")
             if name in task},
            port=args.port, voxel_size=args.voxel_size)
        return task

    return stage(_name=args.op_name)


def _napari(args, state) -> Stage:
    @operator
    def stage(task):
        try:
            import napari
        except ImportError as exc:
            raise UsageError("the napari package is not installed in this "
                             "environment") from exc
        from chunkflow_tpu_torch.flow.viewers import add_napari_layers

        viewer = napari.Viewer()
        add_napari_layers(
            viewer,
            {name: task[name] for name in args.chunk_names.split(",")
             if name in task})
        napari.run()  # pragma: no cover - interactive
        return task

    return stage(_name=args.op_name)


def _plugin_options(p):
    p.add_argument("--name", "-n", "--file", "-f", required=True)
    p.add_argument("--input-names", "-i", default=DEFAULT_CHUNK_NAME,
                   help="comma-separated task keys")
    p.add_argument("--output-names", "-o", default=DEFAULT_CHUNK_NAME,
                   help="comma-separated task keys")
    p.add_argument("--args", "-a", default=None,
                   help="plugin arguments: k=v;k2=(1,2)")


def _plugin(args, state) -> Stage:
    from chunkflow_tpu_torch.flow.plugin import (
        load_plugin,
        str_to_dict,
        wrap_outputs,
    )

    execute = load_plugin(args.name)
    kwargs = str_to_dict(args.args)
    in_keys = [k.strip() for k in args.input_names.split(",") if k.strip()]
    out_keys = [k.strip() for k in args.output_names.split(",")
                if k.strip()]

    @operator
    def stage(task):
        inputs = [task[k] for k in in_keys]
        wrapped = wrap_outputs(execute(*inputs, **kwargs), inputs)
        for key, value in zip(out_keys, wrapped):
            task[key] = value
        return task

    return stage(_name=f"plugin-{args.name}")


COMMANDS: Dict[str, tuple] = {
    "generate-tasks": (_generate_tasks_options, _generate_tasks,
                       "Fan the seed task into a grid of bbox tasks, or "
                       "write them to a task file or a queue."),
    "setup-env": (_setup_env_options, _setup_env,
                  "Plan chunk and block geometry, create the output "
                  "volume, emit or queue the task grid."),
    "fetch-task-from-file": (_fetch_task_from_file_options,
                             _fetch_task_from_file,
                             "Take this job's slice of a task file."),
    "fetch-task-from-queue": (_fetch_task_from_queue_options,
                              _fetch_task_from_queue,
                              "Take tasks from a queue, supervised with "
                              "--max-retries/--lease-renew/--ledger."),
    "delete-task-in-queue": (_delete_task_in_queue_options,
                             _delete_task_in_queue,
                             "Ack the task after its writes are durable."),
    "dead-letter": (_dead_letter_options, _dead_letter,
                    "List or requeue a queue's dead-letter tasks."),
    "fleet-status": (_fleet_status_options, _fleet_status,
                     "The queue's depth, leases and dead letters, and each "
                     "worker's health and headline metrics."),
    "fleet-run": (_fleet_run_options, _fleet_run,
                  "Run an elastic, preemption-native fleet of queue-fed "
                  "workers."),
    "create-bbox": (_create_bbox_options, _create_bbox,
                    "Set the task bbox explicitly."),
    "prefetch": (_prefetch_options, _prefetch,
                 "Run the upstream stages in a background thread."),
    "create-chunk": (_create_chunk_options, _create_chunk,
                     "Create a synthetic chunk (sin/random/zero pattern)."),
    "load-npy": (_load_npy_options, _load_npy, "Load a chunk from .npy."),
    "save-npy": (_save_npy_options, _save_npy, "Save a chunk to .npy."),
    "load-h5": (_load_h5_options, _load_h5,
                "Read an HDF5 chunk (a cutout, channels, a dtype)."),
    "save-h5": (_save_h5_options, _save_h5,
                "Write the chunk to an HDF5 file with its offset, voxel "
                "size and layer type."),
    "load-tif": (_load_tif_options, _load_tif,
                 "Read a multi-page TIFF, one page per z-section."),
    "save-tif": (_save_tif_options, _save_tif,
                 "Write the chunk as a multi-page TIFF."),
    "save-pngs": (_save_pngs_options, _save_pngs,
                  "Write one PNG per z-section."),
    "load-png": (_load_png_options, _load_png,
                 "Read a directory of z-section PNGs."),
    "save-nrrd": (_save_nrrd_options, _save_nrrd,
                  "Write the chunk as an NRRD file."),
    "load-zarr": (_load_zarr_options, _load_zarr,
                  "Read a zyx zarr v2, zarr v3 or N5 array (the task bbox "
                  "or an explicit box)."),
    "save-zarr": (_save_zarr_options, _save_zarr,
                  "Write the chunk into a zyx zarr v2 array at its offset."),
    "create-info": (_create_info_options, _create_info,
                    "Create a precomputed volume's info file."),
    "load-precomputed": (_load_precomputed_options, _load_precomputed,
                         "Cut the task bbox (plus margins) out of a "
                         "precomputed volume."),
    "save-precomputed": (_save_precomputed_options, _save_precomputed,
                         "Write the chunk to a precomputed volume."),
    "skip-task-by-blocks-in-volume": (
        _skip_task_by_blocks_options, _skip_task_by_blocks,
        "Skip a task whose output blocks all exist."),
    "mark-complete": (_mark_complete_options, _mark_complete,
                      "Touch a completion marker for the task bbox."),
    "inference": (_inference_options, _inference,
                  "Patch-wise convnet inference with bump-weighted overlap "
                  "blending."),
    "crop-margin": (_crop_margin_options, _crop_margin,
                    "Crop the chunk by a margin, or to the task bbox."),
    "threshold": (_threshold_options, _threshold,
                  "Binarize the chunk at a threshold (uint8)."),
    "channel-voting": (_channel_voting_options, _channel_voting,
                       "Argmax over channels + 1 (uint8 labels)."),
    "normalize-contrast": (_normalize_contrast_options, _normalize_contrast,
                           "Percentile contrast stretch, per section or "
                           "whole."),
    "normalize-intensity": (_normalize_intensity_options,
                            _normalize_intensity,
                            "uint8 image to float32 in (-1, 1)."),
    "normalize-section-shang": (_normalize_section_shang_options,
                                _normalize_section_shang,
                                "Slice-wise min/max normalization, Shang's "
                                "method."),
    "mask": (_mask_options, _mask,
             "Multiply the chunk(s) by a (coarser) mask volume."),
    "multiply": (_multiply_options, _multiply,
                 "Multiply chunks elementwise."),
    "mask-out-objects": (_mask_out_objects_options, _mask_out_objects,
                         "Remove small or unlisted segmentation objects."),
    "quantize": (_quantize_options, _quantize,
                 "Affinity map to a uint8 thumbnail image."),
    "skip-all-zero": (_skip_all_zero_options, _skip_all_zero,
                      "Drop the task if its chunk is all zero."),
    "skip-none": (_skip_none_options, _skip_none,
                  "Drop the task if a chunk is missing."),
    "skip-task-by-file": (_skip_task_by_file_options, _skip_task_by_file,
                          "Skip a task by the state of its marker file."),
    "adjust-bbox": (_adjust_bbox_options, _adjust_bbox,
                    "Grow or shrink the task bbox."),
    "delete-var": (_delete_var_options, _delete_var,
                   "Drop task variables to bound memory."),
    "copy-var": (_copy_var_options, _copy_var, "Copy a task variable."),
    "cleanup": (_cleanup_options, _cleanup,
                "Remove the task's intermediate files."),
    "load-json": (_load_json_options, _load_json,
                  "Load a JSON file into the task."),
    "connected-components": (_connected_components_options,
                             _connected_components,
                             "Label connected components (a float chunk "
                             "thresholded first), on the host or where "
                             "the chunk lies."),
    "downsample": (_downsample_options, _downsample,
                   "Average-pool an image, mode-pool a segmentation."),
    "downsample-upload": (_downsample_upload_options, _downsample_upload,
                          "Write the chunk's mip pyramid into a "
                          "precomputed volume."),
    "gaussian-filter": (_gaussian_filter_options, _gaussian_filter,
                        "Per-section 2D gaussian blur."),
    "evaluate-segmentation": (_evaluate_segmentation_options,
                              _evaluate_segmentation,
                              "Rand/VOI scores against a ground truth."),
    "debug": (_debug_options, _debug,
              "Drop into a debugger with the task bound to ``task``."),
    "log-summary": (_log_summary_options, _log_summary,
                    "Timing logs and telemetry JSONL as throughput, stall, "
                    "fleet, SLO and trace reports."),
    "plugin": (_plugin_options, _plugin,
               "Run a plugin file: execute(*inputs, **args)."),
    "serve": (_serve_options, _serve,
              "Serve POST /infer with cross-request patch batching, "
              "admission control and per-request deadlines."),
    "mesh": (_mesh_options, _mesh,
             "Mesh every object of a segmentation chunk (surface nets)."),
    "mesh-manifest": (_mesh_manifest_options, _mesh_manifest,
                      "Aggregate per-chunk mesh fragments into object "
                      "manifests."),
    "download-mesh": (_download_mesh_options, _download_mesh,
                      "Fuse an object's mesh fragments into a ply/obj "
                      "file."),
    "label-chunk": (_segment_stage_options("label-chunk"),
                    _segment_stage("label"),
                    "Stitching map 1: run seg-label_<bbox> tasks (label a "
                    "chunk into the global ids, write its faces)."),
    "merge-seg": (_segment_stage_options("merge-seg"),
                  _segment_stage("merge"),
                  "Stitching reduce: run seg-merge_<bbox> tasks (one tree "
                  "node's cross-chunk merge)."),
    "relabel": (_segment_stage_options("relabel"), _segment_stage("relabel"),
                "Stitching map 2: run seg-relabel_<bbox> tasks (apply the "
                "global remap to a chunk, mesh if asked)."),
    "segment-volume": (_segment_volume_options, _segment_volume,
                       "Whole-volume segmentation with exact cross-chunk "
                       "stitching, in process or through a queue."),
    "load-synapses": (_load_synapses_options, _load_synapses,
                      "Load synapses (.json/.h5), filtered by the task "
                      "bbox."),
    "save-synapses": (_save_synapses_options, _save_synapses,
                      "Save synapses to .json or .h5."),
    "save-points": (_save_points_options, _save_points,
                    "Save a point cloud to .npy or .h5."),
    "load-skeleton": (_load_skeleton_options, _load_skeleton,
                      "Load an SWC skeleton."),
    "save-swc": (_save_swc_options, _save_swc,
                 "Save a skeleton, or one per id of a skeleton dict, as "
                 "SWC."),
    "aggregate-skeleton-fragments": (
        _aggregate_skeleton_fragments_options, _aggregate_skeleton_fragments,
        "Merge per-chunk skeleton fragments into whole skeletons."),
    "view": (_view_options, _view,
             "Quick look at the middle section (matplotlib; --screenshot "
             "writes a png)."),
    "neuroglancer": (_viewer_options("neuroglancer"), _neuroglancer,
                     "Serve task entries in an in-process neuroglancer "
                     "viewer (needs the neuroglancer package)."),
    "napari": (_viewer_options("napari"), _napari,
               "Open chunks in napari (needs the napari package)."),
}

#: the JAX CLI's commands that are not ported yet, by the ROADMAP item
#: (queue 1) that ports them: none, every command is
NOT_PORTED: Dict[str, Tuple[str, ...]] = {}


def _group_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m chunkflow_tpu_torch",
        description="Compose chunk operators into a pipeline: "
                    "[options] COMMAND [args] [COMMAND [args] ...]. "
                    f"Commands: {', '.join(COMMANDS)}. Environment: "
                    "CHUNKFLOW_SCHED=static (the static executor), "
                    "CHUNKFLOW_SCHED_MEM_GB, CHUNKFLOW_SCHED_INTERVAL, "
                    "CHUNKFLOW_BLEND, CHUNKFLOW_BLEND_STACK_MAX_GB, "
                    "CHUNKFLOW_PRECISION, CHUNKFLOW_INT8, "
                    "CHUNKFLOW_SERVE, CHUNKFLOW_TELEMETRY, "
                    "CHUNKFLOW_TELEMETRY_SNAPSHOT_EVERY, "
                    "CHUNKFLOW_TELEMETRY_MAX_MB, CHUNKFLOW_TELEMETRY_KEEP, "
                    "CHUNKFLOW_WORKER_ID, CHUNKFLOW_METRICS_PORT, "
                    "CHUNKFLOW_SLO, CHUNKFLOW_TS_INTERVAL, "
                    "CHUNKFLOW_TS_POINTS, CHUNKFLOW_PROFILE_DIR, "
                    "CHUNKFLOW_PROFILE_TASKS, CHUNKFLOW_PROFILE_SECONDS, "
                    "CHUNKFLOW_PROFILE_MAX_SECONDS, "
                    "CHUNKFLOW_PROFILE_COOLDOWN, "
                    "CHUNKFLOW_PROFILE_ON_ANOMALY, "
                    "CHUNKFLOW_PROFILE_STALL_SHARE, "
                    "CHUNKFLOW_PROFILE_STALL_TICKS, "
                    "CHUNKFLOW_CHAOS, CHUNKFLOW_STORAGE, "
                    "CHUNKFLOW_STORAGE_CACHE_MB, "
                    "CHUNKFLOW_STORAGE_CONCURRENCY.",
    )
    p.add_argument("--mip", type=int, default=0,
                   help="storage hierarchy level")
    p.add_argument("--metrics-dir", default=None,
                   help="append the run's telemetry events (task claims, "
                        "commits, retries, ledger skips, depth changes, "
                        "time-series samples, alerts) to a JSONL file of "
                        "this process here, and at the end of the run the "
                        "program cost ledger (programs.json, and a "
                        "programs event log-summary reads)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve live /metrics (Prometheus text), /healthz, "
                        "/alerts and POST /profile from this worker for the "
                        "run (0 binds an ephemeral port and prints it; "
                        "CHUNKFLOW_METRICS_PORT is the env equivalent). "
                        "CHUNKFLOW_TELEMETRY=0 creates no listener")
    p.add_argument("--slo-config", default=None,
                   help="TOML file overriding the SLO objectives and "
                        "burn-rate rules (its top level is the "
                        "[tool.chunkflow.slo] table); CHUNKFLOW_SLO=0 "
                        "disables the evaluator")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run's first "
                        "--profile-tasks tasks here (trace.json)")
    p.add_argument("--profile-tasks", type=int, default=None,
                   help="tasks covered by the --profile-dir window "
                        "(CHUNKFLOW_PROFILE_TASKS, default 4; <= 0 traces "
                        "the whole run)")
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   default=False)
    p.add_argument("--real-run", dest="dry_run", action="store_false")
    p.add_argument("--verbose", "-v", action="count", default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: fails without a card) or cpu")
    return p


def _value_counts(parser: argparse.ArgumentParser) -> Dict[str, int]:
    """How many values follow each option string of ``parser``."""
    counts = {}
    for action in parser._actions:
        n = action.nargs
        count = n if isinstance(n, int) else (0 if n == 0 else 1)
        for option in action.option_strings:
            counts[option] = count
    return counts


def _split(argv: List[str]):
    """(group args, [(command, its args), ...]): a token naming a command
    starts a new segment, unless it is the value of the option before it
    (``mask -v mask``, ``multiply -m mask``), as click's parser reads
    it."""
    head, segments = [], []
    expect, pending = _value_counts(_group_parser()), 0
    for token in argv:
        if token in COMMANDS and not pending:
            segments.append((token, []))
            parser = argparse.ArgumentParser(add_help=False)
            COMMANDS[token][0](parser)
            expect = _value_counts(parser)
            continue
        (segments[-1][1] if segments else head).append(token)
        pending = pending - 1 if pending else expect.get(token, 0)
    return head, segments


def build_stages(argv: List[str], group: Optional[argparse.Namespace] = None
                 ) -> Tuple[argparse.Namespace, List[Stage]]:
    """Parse a command line into (group options, one stage per command);
    ``group`` is the group options when they were parsed already."""
    head, segments = _split(argv)
    if group is None:
        group = _group_parser().parse_args(head)
    state = {"dry_run": group.dry_run, "device": group.device,
             "mip": group.mip, "verbose": group.verbose}
    stages = []
    for command, tokens in segments:
        add_options, build, help_text = COMMANDS[command]
        parser = argparse.ArgumentParser(prog=command, description=help_text)
        add_options(parser)
        stages.append(build(parser.parse_args(tokens), state))
    return group, stages


def _start_observability(group) -> Optional[object]:
    """The run's observability plane, in the JAX CLI's order: the
    telemetry file, then the time-series sampler and the SLO evaluator,
    then the metrics exporter (its bound port printed, and published in
    the endpoint file). Returns the exporter's server, or None."""
    from chunkflow_tpu_torch.parallel.restapi import (
        bound_port,
        exporter_port_from_env,
        start_metrics_exporter,
        write_endpoint_file,
    )

    if group.metrics_dir:
        telemetry.configure(group.metrics_dir)
    if group.metrics_dir or group.slo_config:
        from chunkflow_tpu_torch.core import slo

        telemetry.start_timeseries()
        slo.start_slo(group.slo_config)
    port = (group.metrics_port if group.metrics_port is not None
            else exporter_port_from_env())
    server = start_metrics_exporter(port) if port is not None else None
    if server is not None:
        bound = bound_port(server)
        if group.metrics_dir:
            write_endpoint_file(group.metrics_dir, metrics_port=bound)
        if group.verbose or port == 0:
            # a requested port 0 must be reported: nothing else says
            # where the listener landed
            print(f"metrics exporter: http://{server.server_address[0]}:"
                  f"{bound}/metrics", flush=True)
    return server


def main(argv: Optional[List[str]] = None) -> int:
    from chunkflow_tpu_torch.core import profiling
    from chunkflow_tpu_torch.parallel.restapi import shutdown_server

    argv = list(sys.argv[1:] if argv is None else argv)
    head, segments = _split(argv)
    if not segments:
        _group_parser().print_help()
        return 2
    group = _group_parser().parse_args(head)
    # one CLI run = one telemetry run
    telemetry.reset()
    server = window = None
    try:
        server = _start_observability(group)
        group, stages = build_stages(argv, group)
        if group.profile_dir:
            window = profiling.start_task_window(group.profile_dir,
                                                 tasks=group.profile_tasks)
            if window is None:
                print("profiler window not started (telemetry disabled or "
                      "another profiler session active)", file=sys.stderr)
        count = process_stream(stages, verbose=group.verbose)
    except UsageError as exc:
        raise SystemExit(str(exc)) from exc
    except SystemExit as exc:
        if group.verbose and exc.code == 143:
            # a drained worker (SIGTERM) still says what it did
            print(f"run counters: {json.dumps(_run_counters())}", flush=True)
        raise
    finally:
        if window is not None:
            window.close()
        if group.verbose and telemetry.enabled():
            table = telemetry.summary_table()
            if table:
                print(table)
        if telemetry.configured_path():
            telemetry.flush()
        telemetry.stop_timeseries()
        # a scraper of a finished worker sees connection refused
        shutdown_server(server)
        telemetry.configure(None)
    if group.verbose:
        print(f"pipeline drained {count} task(s)")
        print(f"run counters: {json.dumps(_run_counters())}")
    return 0


def _run_counters() -> dict:
    """The run's telemetry counters and each kernel's launches."""
    from chunkflow_tpu_torch.ops import accumulate, gather, int8_conv

    counters = telemetry.snapshot()["counters"]
    counters["kernels/gather"] = gather.launches
    counters["kernels/accumulate"] = accumulate.launches
    counters["kernels/conv3d_int8"] = int8_conv.launches
    for path, n in int8_conv.path_launches.items():
        counters[f"kernels/conv3d_int8/{path}"] = n
    return counters
