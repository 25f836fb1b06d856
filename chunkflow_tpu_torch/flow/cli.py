"""The chained-command CLI of the port: a pipeline is a shell command.

A subset of the JAX package's ``chunkflow`` CLI (``chunkflow_tpu/flow/
cli.py``) with the same command and option names for what is ported:
``generate-tasks``, ``create-bbox``, ``create-chunk``, ``load-npy``,
``save-npy``, ``prefetch`` and ``inference``. Each command builds a stage
over the task stream (``flow/runtime.py``); the chain runs from one seed
task, which ``generate-tasks`` fans into a task grid. Built on
``argparse``.

Example (four tasks, the inference of one overlapping the upload of the
next and the download of the last)::

    python -m chunkflow_tpu_torch generate-tasks -c 64 512 512 -g 1 1 4 \\
        create-chunk --size 64 512 512 \\
        inference --framework identity --input-patch-size 20 256 256 \\
            --output-patch-overlap 4 64 64 --num-output-channels 3 \\
            --async-depth 2 \\
        save-npy --file-name out.npy

Inference runs on the card; ``--device cpu`` (before the first command)
runs the kernels' plain PyTorch versions on the CPU instead.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.bbox import BoundingBox, BoundingBoxes
from chunkflow_tpu_torch.flow.runtime import (
    DEFAULT_CHUNK_NAME,
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


def _not_ported(option: str):
    raise NotImplementedError(f"{option} is not ported yet (ROADMAP, queue "
                              f"1: volume IO and task queues)")


# ---------------------------------------------------------------------------
# task sources
# ---------------------------------------------------------------------------
def _generate_tasks_options(p):
    p.add_argument("--volume-path", "-v", default=None,
                   help="roi bounds from a volume's metadata (not ported)")
    p.add_argument("--mip", "-m", type=int, default=None)
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
                   help="write tasks to a file (not ported)")
    p.add_argument("--queue-name", "-q", default=None,
                   help="push tasks to a queue (not ported)")
    p.add_argument("--task-index-start", "-i", type=int, default=None)
    p.add_argument("--task-index-stop", "-p", type=int, default=None)
    p.add_argument("--disbatch", action=argparse.BooleanOptionalAction,
                   default=False, help="select the single task at "
                                       "$DISBATCH_REPEAT_INDEX")


def _generate_tasks(args, state) -> Stage:
    for option, value in (("--volume-path", args.volume_path),
                          ("--task-file", args.task_file),
                          ("--queue-name", args.queue_name)):
        if value is not None:
            _not_ported(f"generate-tasks {option}")
    start, stop, size = args.roi_start, args.roi_stop, args.roi_size
    if stop is not None and size is not None:
        raise UsageError("give --roi-stop OR --roi-size, not both")
    if args.bounding_box is not None:
        if start is not None or stop is not None or size is not None:
            raise UsageError("--bounding-box replaces --roi-start/"
                             "--roi-stop/--roi-size")
        box = BoundingBox.from_string(args.bounding_box)
        start, stop = tuple(box.start), tuple(box.stop)
    if start is None:
        start = (0, 0, 0)

    @generator
    def stage(task):
        boxes = list(BoundingBoxes.from_manual_setup(
            chunk_size=args.chunk_size, overlap=args.overlap,
            roi_start=start, roi_stop=stop, roi_size=size,
            grid_size=args.grid_size,
            aligned_block_size=args.aligned_block_size,
            bounded=args.bounded,
        ))
        if args.task_index_start is not None \
                or args.task_index_stop is not None:
            boxes = boxes[args.task_index_start:args.task_index_stop]
        elif args.disbatch:
            if "DISBATCH_REPEAT_INDEX" not in os.environ:
                raise UsageError("--disbatch needs $DISBATCH_REPEAT_INDEX in "
                                 "the environment (set by the disBatch "
                                 "launcher)")
            idx = int(os.environ["DISBATCH_REPEAT_INDEX"])
            if idx >= len(boxes):
                raise UsageError(f"DISBATCH_REPEAT_INDEX={idx} exceeds the "
                                 f"{len(boxes)}-task grid")
            boxes = [boxes[idx]]
        for bbox in boxes:
            t = new_task()
            t["bbox"] = bbox
            yield t

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
                       "Fan the seed task into a grid of bbox tasks."),
    "create-bbox": (_create_bbox_options, _create_bbox,
                    "Set the task bbox explicitly."),
    "prefetch": (_prefetch_options, _prefetch,
                 "Run the upstream stages in a background thread."),
    "create-chunk": (_create_chunk_options, _create_chunk,
                     "Create a synthetic chunk (sin/random/zero pattern)."),
    "load-npy": (_load_npy_options, _load_npy, "Load a chunk from .npy."),
    "save-npy": (_save_npy_options, _save_npy, "Save a chunk to .npy."),
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
                    "CHUNKFLOW_PRECISION, CHUNKFLOW_TELEMETRY.",
    )
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
    state = {"dry_run": group.dry_run, "device": group.device}
    stages = []
    for command, tokens in segments:
        add_options, build, help_text = COMMANDS[command]
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
        count = process_stream(stages, verbose=group.verbose)
    except UsageError as exc:
        raise SystemExit(str(exc)) from exc
    if group.verbose:
        print(f"pipeline drained {count} task(s)")
    return 0
