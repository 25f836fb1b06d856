"""The chained-command CLI of the port: a pipeline is a shell command.

A subset of the JAX package's ``chunkflow`` CLI (``chunkflow_tpu/flow/
cli.py``) with the same command and option names for what is ported:
``create-chunk``, ``load-npy``, ``save-npy`` and ``inference``. Commands
chain: each one maps the task dict (chunks by name) to the next.
Built on ``argparse``.

Example::

    python -m chunkflow_tpu_torch create-chunk --size 64 512 512 \\
        inference --framework identity --input-patch-size 20 256 256 \\
            --output-patch-overlap 4 64 64 --num-output-channels 3 \\
        save-npy --file-name out.npy

Inference runs on the card; ``--device cpu`` (before the first command)
runs the kernels' plain PyTorch versions on the CPU instead.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk

DEFAULT_CHUNK_NAME = "chunk"

Stage = Callable[[dict], dict]


def _triple(parser, *names, default=None, required=False, help=""):
    parser.add_argument(*names, type=int, nargs=3, default=default,
                        required=required, help=help)


def _name(parser, default):
    parser.add_argument("--name", dest="op_name", default=default,
                        help="operator name key in the task log timer")


# ---------------------------------------------------------------------------
# commands: each adds its options and builds its stage
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
    def stage(task):
        task[args.output_chunk_name] = Chunk.create(
            size=args.size, dtype=np.dtype(args.dtype), pattern=args.pattern,
            voxel_offset=args.voxel_offset, voxel_size=args.voxel_size,
        )
        return task

    return stage


def _load_npy_options(p):
    _name(p, "load-npy")
    p.add_argument("--file-name", "--file-path", "-f", required=True)
    _triple(p, "--voxel-offset", default=(0, 0, 0))
    _triple(p, "--voxel-size", "--resolution", default=None)
    p.add_argument("--output-chunk-name", "--output-name", "-o",
                   default=DEFAULT_CHUNK_NAME)


def _load_npy(args, state) -> Stage:
    def stage(task):
        chunk = Chunk.from_npy(args.file_name, voxel_offset=args.voxel_offset)
        if args.voxel_size is not None:
            chunk = chunk.with_voxel_size(args.voxel_size)
        task[args.output_chunk_name] = chunk
        return task

    return stage


def _save_npy_options(p):
    _name(p, "save-npy")
    p.add_argument("--file-name", "-f", required=True)
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)


def _save_npy(args, state) -> Stage:
    def stage(task):
        task[args.input_chunk_name].to_npy(args.file_name)
        return task

    return stage


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
    p.add_argument("--input-chunk-name", "-i", default=DEFAULT_CHUNK_NAME)
    p.add_argument("--output-chunk-name", "-o", default=DEFAULT_CHUNK_NAME)


def _inference(args, state) -> Stage:
    from chunkflow_tpu_torch.inference.inferencer import Inferencer

    if args.bump != "wu":
        raise SystemExit(f"bump '{args.bump}' is not implemented; only 'wu' "
                         f"is (matching the reference)")
    dtype = "bfloat16" if args.dtype == "float16" else args.dtype
    explicit_crop = args.output_crop_margin
    out_patch = args.output_patch_size
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
        dry_run=state["dry_run"],
        device=state["device"],
    )
    expected = tuple(args.patch_num) if args.patch_num is not None else None

    def stage(task):
        chunk = task[args.input_chunk_name]
        if expected is not None:
            got = inferencer.patch_grid_shape(chunk.shape)
            if got != expected:
                raise SystemExit(f"--patch-num {expected} but chunk "
                                 f"{chunk.shape} decomposes into {got} "
                                 f"patches")
        out = inferencer(chunk)
        if explicit_crop is not None:
            out = out.crop_margin(explicit_crop)
        task[args.output_chunk_name] = out
        task["log"]["compute_device"] = inferencer.compute_device
        return task

    return stage


COMMANDS: Dict[str, tuple] = {
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
                    f"Commands: {', '.join(COMMANDS)}.",
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


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    head, segments = _split(argv)
    group = _group_parser().parse_args(head)
    if not segments:
        _group_parser().print_help()
        return 2
    state = {"dry_run": group.dry_run, "device": group.device}
    stages = []
    for command, tokens in segments:
        add_options, build, help_text = COMMANDS[command]
        parser = argparse.ArgumentParser(prog=command, description=help_text)
        add_options(parser)
        args = parser.parse_args(tokens)
        stages.append((args.op_name, build(args, state)))
    task = {"log": {"timer": {}, "compute_device": ""}}
    for name, stage in stages:
        start = time.perf_counter()
        task = stage(task)
        task["log"]["timer"][name] = time.perf_counter() - start
    if group.verbose:
        timers = task["log"]["timer"]
        print(f"task complete; time per op (s): {timers} "
              f"total={sum(timers.values()):.3f}")
    return 0
