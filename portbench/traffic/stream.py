"""Chunks streamed from host memory through ``Inferencer.stream``.

A closed loop, as a worker with its input prefetched runs it: an endless
source yields chunks of ``chunk`` voxels, uint8, drawn from the seed on
the device into a pool of ``pool`` distinct chunks kept in host memory
(chunk ``i`` is pool entry ``i mod pool``); ``Inferencer.stream`` (the
adaptive scheduler, the program's default) pulls them as it has room,
and each result arrives on the host and is dropped. A task enters when
the source yields its chunk and finishes when its result is on the host.
The first ``warmup`` results are set-up: they build every shape the
window uses; the window opens at the last of them and closes at the
first result once ``--seconds`` have passed.

The check keeps ``sample`` results drawn from the seed among those
finished in the window (a reservoir) and, once the program is freed,
holds each against the plain reference on the same chunk and weights.
"""
from __future__ import annotations

import itertools
import os
import random
import time

import numpy as np
import torch

import modelfile
import weights
from reference import blend, compare, models


class Traffic:
    def __init__(self, run, tmp: str):
        self.run = run
        self.tmp = tmp
        self.program = None

    def setup(self) -> None:
        from chunkflow_tpu_torch.inference.inferencer import Inferencer

        run, cfg, tr = self.run, self.run.config, self.run.traffic
        dev = run.device
        self.params = weights.make(cfg, run.seed, dev)
        path = os.path.join(self.tmp, "weights.pt")
        torch.save({k: v.cpu() for k, v in self.params.items()}, path)
        gen = torch.Generator(device=dev)
        gen.manual_seed((run.seed + 1) % 2**63)
        self.pool = torch.randint(0, 256, (tr["pool"],) + tuple(tr["chunk"]),
                                  dtype=torch.uint8, device=dev,
                                  generator=gen).cpu().numpy()
        run.chunk = run.output = tuple(tr["chunk"])
        self.out_dtype = tr.get("output_dtype", cfg["output_dtype"])
        self.program = Inferencer(
            input_patch_size=cfg["input_patch"],
            output_patch_overlap=cfg["overlap"],
            num_output_channels=cfg["out_channels"],
            num_input_channels=cfg["in_channels"],
            batch_size=cfg["batch"], framework="pytorch",
            model_path=modelfile.write(cfg, self.tmp), weight_path=path,
            output_dtype=self.out_dtype, device=dev)

    def drive(self) -> None:
        from chunkflow_tpu_torch import Chunk

        run, tr = self.run, self.run.traffic
        pool = self.pool
        entered = {}
        z = tr["chunk"][0]

        def source():
            for i in itertools.count():
                entered[i] = time.perf_counter()
                yield Chunk(pool[i % len(pool)], voxel_offset=(z * i, 0, 0))

        rng = random.Random(run.seed)
        k = run.cell.check["sample"]
        self.kept = {}  # index -> output array, a reservoir of k
        finished = 0
        stream = self.program.stream(source())
        try:
            for i, out in enumerate(stream):
                t = time.perf_counter()
                if i + 1 < tr["warmup"]:
                    continue
                if i + 1 == tr["warmup"]:
                    run.open()
                    continue
                run.done(entered.pop(i), t)
                finished += 1
                if len(self.kept) < k:
                    self.kept[i] = out.array
                else:
                    j = rng.randrange(finished)
                    if j < k:
                        del self.kept[sorted(self.kept)[j]]
                        self.kept[i] = out.array
                if run.over():
                    break
        finally:
            run.close()
            stream.close()
            if run.device == "cuda":
                torch.cuda.synchronize()

    def release(self) -> None:
        self.program = None

    def check(self) -> dict:
        run, cfg = self.run, self.run.config
        gaps = compare.Gaps()
        with torch.no_grad(), models.exact_float32():
            for i, got in sorted(self.kept.items()):
                raw = torch.from_numpy(self.pool[i % len(self.pool)]).to(
                    run.device)
                ref = blend.infer_chunk(
                    lambda x: models.forward(cfg, self.params, x), raw,
                    cfg["input_patch"], cfg["overlap"], cfg["out_channels"],
                    cfg["batch"])
                if self.out_dtype == "uint8":
                    ref = blend.to_uint8(ref)
                gaps.add(torch.from_numpy(np.asarray(got)).to(run.device),
                         ref)
        return gaps.numbers()
