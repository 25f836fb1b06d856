#!/usr/bin/env python3
"""Host dispatch time and streamed s/chunk of ``tpu_s2d4`` bfloat16 on one
card, for the checkout this script sits in.

To compare two commits on one card, unpack each into its own directory
with this script beside it and run them in turns on the same card
(parent, change, change, parent):

    cd <tree> && python3 stream_ab.py <label>

Each run builds the gather and accumulate kernels, streams four seeded
64x512x512 uint8 chunks through ``Inferencer`` (20x256x256 patches,
4x64x64 overlap, three channels, batch 2) and prints one JSON line: the
median host time of ``infer_async`` on a staged chunk (ms, the card idle
before each), three streamed and two serial passes (s/chunk, the card
synchronized around each pass). The first streamed pass includes the
stream's own start-up.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHUNK = (64, 512, 512)
CHUNKS = 4
REPS = 3


def main(label: str) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chunkflow_tpu_torch import Chunk, _build
    from chunkflow_tpu_torch.inference.inferencer import Inferencer

    _build.build_all(("gather", "accumulate"))
    rng = np.random.default_rng(8)
    chunks = [Chunk(rng.integers(0, 256, CHUNK, dtype=np.uint8))
              for _ in range(CHUNKS)]
    inf = Inferencer(input_patch_size=(20, 256, 256),
                     output_patch_overlap=(4, 64, 64), num_output_channels=3,
                     batch_size=2, framework="pytorch",
                     model_variant="tpu_s2d4", dtype="bfloat16")
    inf(chunks[0]).host()
    dispatch = []
    for _ in range(REPS):
        for c in chunks:
            torch.cuda.synchronize()
            staged = inf.stage(c)
            t = time.perf_counter()
            out = inf.infer_async(staged, consume=True)
            dispatch.append((time.perf_counter() - t) * 1e3)
            out.host()

    def per_chunk(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return round((time.perf_counter() - t) / CHUNKS, 4)

    stream = [per_chunk(lambda: [None for _ in inf.stream(iter(chunks))])
              for _ in range(REPS)]
    serial = [per_chunk(lambda: [inf(c).host() for c in chunks])
              for _ in range(2)]
    print(json.dumps({"tree": label,
                      "dispatch_ms_median": round(
                          sorted(dispatch)[len(dispatch) // 2], 2),
                      "stream_s": stream, "serial_s": serial}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else str(ROOT))
