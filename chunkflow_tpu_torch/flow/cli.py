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
local neuroglancer precomputed directories in the raw encoding; queues
are ``file://`` directories or ``memory://`` names. Cloud URLs
(``gs://``, ``s3://``, ``sqs://``), other encodings, ``--validate-mip``,
``--create-thumbnail``, ``fleet-run`` and ``fleet-status`` raise
``NotImplementedError`` naming their ROADMAP item.
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


def _not_ported(option: str, item: str):
    raise NotImplementedError(f"{option} is not ported yet (ROADMAP, queue "
                              f"1: {item})")


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
        from chunkflow_tpu_torch.parallel import lifecycle
        from chunkflow_tpu_torch.parallel.queues import open_queue

        if budget["left"] == 0:
            return
        queue = open_queue(args.queue_name,
                           visibility_timeout=args.visibility_timeout)
        queue.max_empty_retries = args.retry_times
        if args.poll_interval is not None:
            queue.retry_sleep = max(0.01, args.poll_interval)
        if not supervised:
            for handle, body in queue:
                yield queue_task(queue, handle, body, queue.trace_id(handle))
                if spent():
                    return
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


def _fleet(args, state) -> Stage:
    _not_ported("fleet-run and fleet-status", "fleet supervisor")


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
                   help="block encoding (the port writes raw)")
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
                   help="cross-check against a coarser mip (not ported)")
    p.add_argument("--validate-tolerance", type=float, default=0.01)
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)


def _load_precomputed(args, state) -> Stage:
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    if args.validate_mip is not None:
        _not_ported("load-precomputed --validate-mip",
                    "segmentation device legs")
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
        if args.blackout_sections:
            sidecar = vol.read_json("blackout_section_ids.json") or {}
            z0, nz = int(chunk.voxel_offset.z), chunk.shape[-3]
            for z in sidecar.get("section_ids", ()):
                if z0 <= z < z0 + nz:
                    chunk.array[..., z - z0, :, :] = 0
        task[args.output_chunk_name] = chunk
        return task

    return stage(_name=args.op_name)


def _save_precomputed_options(p):
    _name(p, "save-precomputed")
    p.add_argument("--volume-path", "-v", required=True)
    p.add_argument("--mip", type=int, default=None)
    p.add_argument("--upload-log", action=argparse.BooleanOptionalAction,
                   default=True, help="write the task's timers to "
                                      "<volume>/log/<bbox>.json")
    p.add_argument("--create-thumbnail",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="not ported")
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

    if args.create_thumbnail:
        _not_ported("save-precomputed --create-thumbnail",
                    "segmentation device legs")
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
        if args.upload_log:
            log_dir = os.path.join(_local_root(args.volume_path), "log")
            os.makedirs(log_dir, exist_ok=True)
            record = {"timer": task["log"]["timer"],
                      "compute_device": task["log"].get("compute_device", ""),
                      "bbox": chunk.bbox.string}
            with open(os.path.join(log_dir, f"{chunk.bbox.string}.json"),
                      "w") as f:
                json.dump(record, f)
        return task

    return stage(_name=args.op_name)


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
    "fleet-run": (None, _fleet, "Not ported."),
    "fleet-status": (None, _fleet, "Not ported."),
    "create-bbox": (_create_bbox_options, _create_bbox,
                    "Set the task bbox explicitly."),
    "prefetch": (_prefetch_options, _prefetch,
                 "Run the upstream stages in a background thread."),
    "create-chunk": (_create_chunk_options, _create_chunk,
                     "Create a synthetic chunk (sin/random/zero pattern)."),
    "load-npy": (_load_npy_options, _load_npy, "Load a chunk from .npy."),
    "save-npy": (_save_npy_options, _save_npy, "Save a chunk to .npy."),
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
}


def _group_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m chunkflow_tpu_torch",
        description="Compose chunk operators into a pipeline: "
                    "[options] COMMAND [args] [COMMAND [args] ...]. "
                    f"Commands: {', '.join(COMMANDS)}. Environment: "
                    "CHUNKFLOW_SCHED=static (the static executor), "
                    "CHUNKFLOW_SCHED_MEM_GB, CHUNKFLOW_SCHED_INTERVAL, "
                    "CHUNKFLOW_BLEND, CHUNKFLOW_BLEND_STACK_MAX_GB, "
                    "CHUNKFLOW_PRECISION, CHUNKFLOW_TELEMETRY, "
                    "CHUNKFLOW_CHAOS, CHUNKFLOW_STORAGE, "
                    "CHUNKFLOW_STORAGE_CACHE_MB, "
                    "CHUNKFLOW_STORAGE_CONCURRENCY.",
    )
    p.add_argument("--mip", type=int, default=0,
                   help="storage hierarchy level")
    p.add_argument("--metrics-dir", default=None,
                   help="append the run's telemetry events (task claims, "
                        "commits, retries, ledger skips, depth changes) to "
                        "a JSONL file of this process here")
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   default=False)
    p.add_argument("--real-run", dest="dry_run", action="store_false")
    p.add_argument("--verbose", "-v", action="count", default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: fails without a card) or cpu")
    return p


def _split(argv: List[str]):
    """(group args, [(command, its args), ...]): a token naming a command
    starts a new segment."""
    head, segments = [], []
    for token in argv:
        if token in COMMANDS:
            segments.append((token, []))
        elif segments:
            segments[-1][1].append(token)
        else:
            head.append(token)
    return head, segments


def build_stages(argv: List[str]) -> Tuple[argparse.Namespace, List[Stage]]:
    """Parse a command line into (group options, one stage per command)."""
    head, segments = _split(argv)
    group = _group_parser().parse_args(head)
    state = {"dry_run": group.dry_run, "device": group.device,
             "mip": group.mip}
    stages = []
    for command, tokens in segments:
        add_options, build, help_text = COMMANDS[command]
        if add_options is None:  # not ported: raises whatever its options
            build(tokens, state)
        parser = argparse.ArgumentParser(prog=command, description=help_text)
        add_options(parser)
        stages.append(build(parser.parse_args(tokens), state))
    return group, stages


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not _split(argv)[1]:
        _group_parser().print_help()
        return 2
    # one CLI run = one telemetry run
    telemetry.reset()
    try:
        group, stages = build_stages(argv)
        telemetry.configure(group.metrics_dir)
        count = process_stream(stages, verbose=group.verbose)
    except UsageError as exc:
        raise SystemExit(str(exc)) from exc
    finally:
        telemetry.configure(None)
    if group.verbose:
        print(f"pipeline drained {count} task(s)")
        print(f"run counters: {json.dumps(_run_counters())}")
    return 0


def _run_counters() -> dict:
    """The run's telemetry counters and each kernel's launches."""
    from chunkflow_tpu_torch.ops import accumulate, gather

    counters = telemetry.snapshot()["counters"]
    counters["kernels/gather"] = gather.launches
    counters["kernels/accumulate"] = accumulate.launches
    return counters
