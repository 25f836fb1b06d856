#!/usr/bin/env python3
"""What the serving front end's wire costs, on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 serve_wire.py

It serves ``chip_smoke.py`` phase 15's model (the full-width parity
UNet3D, seeded flax-layout weights, float32, batch 4) on a real listener
in process and sends phase 15's 12 requests (one 20x256x256 patch to
64x512x512, uint8 in, float32 out) from the 4 threads of a client
process (``chip_smoke.http_clients``), four times in turns: with the
responses' ``Content-Length`` header as the port sends it, and without
it, as the JAX package's server sends them (the client then reads each
body until the connection closes), in the order without, with, with,
without. Each run is held bitwise against ``Inferencer.__call__``
(SHA-256 of each answer's bytes) and prints its wall time, requests/s,
client latency p50 and p99, and the host seconds to decode requests and
encode answers on the server and to decode answers in the client; then
one JSON line with every run. Needs about two minutes of the card.
"""
from __future__ import annotations

import hashlib
import http.server
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("serve_wire: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.models.convert import state_from_flax
    from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init
    from chunkflow_tpu_torch.parallel.restapi import (
        bound_port,
        shutdown_server,
    )
    from chunkflow_tpu_torch.serve.frontend import (
        AdmissionController,
        LocalBackend,
        ServingService,
        start_serving,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    seeded = seeded_init(UNet3D(in_channels=1, out_channels=cs.CHANNELS),
                         torch.Generator().manual_seed(0))
    weights = cs.OUT_DIR / "serve_wire_seed0.pt"
    torch.save(state_from_flax(cs._flax_layout(seeded.state_dict())),
               weights)
    inf = Inferencer(input_patch_size=cs.PIN, output_patch_overlap=cs.OVERLAP,
                     num_output_channels=cs.CHANNELS, framework="flax",
                     weight_path=str(weights), batch_size=cs.PACK_BATCH)
    rng = np.random.default_rng(cs.SERVE_SEED)
    raws = [rng.integers(0, 256, s, dtype=np.uint8) for s in cs.PACK_SHAPES]
    refs = [hashlib.sha256(inf(Chunk(r, voxel_offset=(100 * i, 0, 0)))
                           .host().array.tobytes()).hexdigest()
            for i, r in enumerate(raws)]
    backend = LocalBackend(inf, workers=cs.SERVE_WORKERS, max_wait_ms=2.0)
    service = ServingService(
        backend, admission=AdmissionController(cs.SERVE_MAX_INFLIGHT),
        default_deadline_s=600.0)
    server = start_serving(service, host="127.0.0.1", port=0)
    port = bound_port(server)
    send_header = http.server.BaseHTTPRequestHandler.send_header

    def without_length(handler, key, value):
        if key != "Content-Length":
            send_header(handler, key, value)

    runs = []
    try:
        cs.http_clients(port)  # the dispatcher's start, cuDNN's plans
        for label in ("without", "with", "with", "without"):
            with mock.patch.object(
                    http.server.BaseHTTPRequestHandler, "send_header",
                    without_length if label == "without" else send_header):
                telemetry.reset()
                report = cs.http_clients(port)
            got = [r["sha256"] for r in report["requests"]]
            if got != refs:
                raise SystemExit(f"serve_wire: an answer {label} "
                                 f"Content-Length differs from its "
                                 f"Inferencer.__call__")
            hists = telemetry.snapshot()["hists"]
            send = [r["send_s"] for r in report["requests"]]
            run = {
                "content_length": label, "wall_s": report["wall_s"],
                "requests_per_s": len(raws) / report["wall_s"],
                "client_p50_s": float(np.percentile(send, 50)),
                "client_p99_s": float(np.percentile(send, 99)),
                "client_decode_s": sum(r["decode_s"]
                                       for r in report["requests"]),
                **{f"server_{k}_s": hists.get(f"serving/{k}",
                                              {"total": 0.0})["total"]
                   for k in ("decode", "encode")},
            }
            runs.append(run)
            print(f"[wire] {label} Content-Length: {run['wall_s']:.4f} s = "
                  f"{run['requests_per_s']:.3f} requests/s, bitwise; client "
                  f"p50 {run['client_p50_s']:.4f} s, p99 "
                  f"{run['client_p99_s']:.4f} s; host s: server decode "
                  f"{run['server_decode_s']:.3f}, encode "
                  f"{run['server_encode_s']:.3f}, client decode "
                  f"{run['client_decode_s']:.3f}", flush=True)
    finally:
        shutdown_server(server)
        backend.close()
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
