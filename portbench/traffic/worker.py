"""The fleet worker: tasks claimed from a ``file://`` queue, cut out of a
precomputed volume on disk, inferred, saved and acked, in process.

The chain is the production worker's command line, built by the
program's own CLI (``flow.cli.build_stages``) and drained by
``flow.runtime.process_stream``::

    fetch-task-from-queue -q <queue> --max-retries 3 --ledger <dir>
    load-precomputed -v <input> -e <margin>
    inference --framework pytorch --model-path <model.py>
        --weight-path <weights.pt>
        --input-patch-size ... --output-patch-overlap ...
        --output-crop-margin <margin> --num-output-channels ...
        --batch-size ... --async-depth <async_depth>
        --output-dtype <output_dtype>
    save-precomputed -v <output> --async-write
    delete-task-in-queue

Set-up draws a ``volume`` of uint8 from the seed on the device and writes
it as raw precomputed blocks of ``volume_block`` under the run's
temporary directory; the volume the worker reads repeats those blocks
along x by hard links. So the queue can hold distinct tasks of ``task``
voxels, ``claims_per_second`` for each second of the window and twice
``warmup`` more, whose output boxes tile the output volume (each written
once, as a fleet writes a volume), at one volume's bytes on disk. The
queue holds them in an order drawn from the seed. A task enters when it
is claimed and finishes when it is acked; the window opens at the
``warmup``-th ack and closes at the first ack once ``--seconds`` have
passed, and the worker claims no more once the window is over and
drains what it holds.

The check draws ``sample`` tasks from the seed among those acked in the
window, reads each back from the output volume on disk and holds it
against the plain reference on the same cutout and weights, quantized
as the output volume stores it.
"""
from __future__ import annotations

import math
import os
import random
import time

import numpy as np
import torch

import modelfile
import weights
from reference import blend, compare, models, volume


def _nums(values):
    return [str(int(v)) for v in values]


class QueueDry(RuntimeError):
    pass


class Traffic:
    def __init__(self, run, tmp: str):
        self.run = run
        self.tmp = tmp
        self.program = None

    def setup(self) -> None:
        from chunkflow_tpu_torch.flow import cli
        from chunkflow_tpu_torch.parallel.queues import open_queue

        run, cfg, tr = self.run, self.run.config, self.run.traffic
        dev = run.device
        self.params = weights.make(cfg, run.seed, dev)
        wpath = os.path.join(self.tmp, "weights.pt")
        torch.save({k: v.cpu() for k, v in self.params.items()}, wpath)
        gen = torch.Generator(device=dev)
        gen.manual_seed((run.seed + 1) % 2**63)
        self.base = torch.randint(0, 256, tuple(tr["volume"]),
                                  dtype=torch.uint8, device=dev,
                                  generator=gen).cpu().numpy()
        task, margin = tr["task"], tr["margin"]
        start = tr["roi_start"]
        # task grid: z and y as the roi gives them, as many x columns as
        # the queue needs
        per_column = math.prod(tr["roi_tasks_zy"])
        n_tasks = math.ceil(run.seconds * tr["claims_per_second"]) \
            + 2 * tr["warmup"]
        columns = -(-n_tasks // per_column)
        roi = (tr["roi_tasks_zy"][0] * task[0],
               tr["roi_tasks_zy"][1] * task[1], columns * task[2])
        vol_x = self.base.shape[2]
        tiles = -(-(start[2] + roi[2] + margin[2]) // vol_x)
        self.input = os.path.join(self.tmp, "image")
        volume.write_info(self.input, (*self.base.shape[:2], vol_x * tiles),
                          tr["voxel_size"], (0, 0, 0), tr["volume_block"], 1,
                          "uint8")
        volume.write_tiled(self.input, self.base, tiles)
        out_dtype = tr["output_dtype"]
        self.output = os.path.join(self.tmp, "affinity")
        volume.write_info(self.output, roi, tr["voxel_size"], start,
                          tr["output_block"], cfg["out_channels"], out_dtype)
        boxes = []
        for iz in range(tr["roi_tasks_zy"][0]):
            for iy in range(tr["roi_tasks_zy"][1]):
                for ix in range(columns):
                    lo = (start[0] + iz * task[0], start[1] + iy * task[1],
                          start[2] + ix * task[2])
                    boxes.append(lo)
        random.Random(run.seed).shuffle(boxes)
        queue = f"file://{os.path.join(self.tmp, 'queue')}"
        open_queue(queue).send_messages([
            "_".join(f"{a}-{a + t}" for a, t in zip(lo, task))
            for lo in boxes])
        run.chunk = tuple(t + 2 * m for t, m in zip(task, margin))
        run.output = tuple(task)
        argv = ([] if dev == "cuda" else ["--device", dev]) + [
            "fetch-task-from-queue", "-q", queue, "--max-retries", "3",
            "--ledger", os.path.join(self.tmp, "ledger"),
            "load-precomputed", "-v", self.input, "-e", *_nums(margin),
            "inference", "--framework", "pytorch",
            "--model-path", modelfile.write(cfg, self.tmp),
            "--weight-path", wpath,
            "--input-patch-size", *_nums(cfg["input_patch"]),
            "--output-patch-overlap", *_nums(cfg["overlap"]),
            "--output-crop-margin", *_nums(margin),
            "--num-output-channels", str(cfg["out_channels"]),
            "--num-input-channels", str(cfg["in_channels"]),
            "--batch-size", str(cfg["batch"]),
            "--async-depth", str(tr["async_depth"]),
            "--output-dtype", out_dtype,
            "save-precomputed", "-v", self.output, "--async-write",
            "delete-task-in-queue"]
        _, self.program = cli.build_stages(argv)

    def drive(self) -> None:
        from chunkflow_tpu_torch.flow.runtime import process_stream

        run, tr = self.run, self.run.traffic
        self.acked = []
        claimed = {"dry": True}

        def gate(stream):
            """Stamps each claim; claims no more once the window is
            over."""
            for task in stream:
                if task is not None:
                    task["portbench_entered"] = time.perf_counter()
                yield task
                if run.over():
                    claimed["dry"] = False
                    return

        def sink(stream):
            """Stamps each ack; the warmup-th opens the window."""
            acks = 0
            for task in stream:
                if task is not None:
                    t = time.perf_counter()
                    acks += 1
                    if acks == tr["warmup"]:
                        run.open()
                    elif run.done(task["portbench_entered"], t):
                        self.acked.append(task["bbox"])
                        if run.over():
                            run.close()
                yield task

        fetch, *rest = self.program
        process_stream([fetch, gate, *rest, sink])
        run.close()
        run.failed = int(run.counters.get("tasks/retried", 0)
                         + run.counters.get("tasks/dead_lettered", 0))
        if claimed["dry"]:
            raise QueueDry("the queue ran dry before the window closed: "
                           "give the traffic more tasks")

    def release(self) -> None:
        self.program = None

    def check(self) -> dict:
        run, cfg, tr = self.run, self.run.config, self.run.traffic
        margin = tr["margin"]
        chosen = random.Random(run.seed).sample(
            self.acked, min(run.cell.check["sample"], len(self.acked)))
        gaps = compare.Gaps()
        with torch.no_grad(), models.exact_float32():
            for bbox in chosen:
                start = tuple(int(v) for v in bbox.start)
                size = tuple(int(v) for v in bbox.shape)
                lo = [a - m for a, m in zip(start, margin)]
                hi = [a + s + m for a, s, m in zip(start, size, margin)]
                # the input volume is the base volume repeated along x
                xs = np.arange(lo[2], hi[2]) % self.base.shape[2]
                raw = self.base[lo[0]:hi[0], lo[1]:hi[1]][:, :, xs]
                ref = blend.infer_chunk(
                    lambda x: models.forward(cfg, self.params, x),
                    torch.from_numpy(np.ascontiguousarray(raw)).to(
                        run.device),
                    cfg["input_patch"], cfg["overlap"], cfg["out_channels"],
                    cfg["batch"])
                ref = ref[(slice(None),) + tuple(
                    slice(m, m + s) for m, s in zip(margin, size))]
                if tr["output_dtype"] == "uint8":
                    ref = blend.to_uint8(ref)
                got = volume.read(self.output, start, size)
                gaps.add(torch.from_numpy(got).to(run.device), ref)
        return gaps.numbers()
