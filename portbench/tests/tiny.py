"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, with each configuration's patch and each traffic's shapes cut
down and the cells kept for later added, for the tests to drive whole
runs on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

PATCH = {"input_patch": [4, 32, 32], "overlap": [2, 8, 8]}
TRAFFIC = {
    "stream": {"chunk": [8, 64, 64], "pool": 2, "warmup": 2},
    "worker": {"volume": [16, 128, 128], "volume_block": [8, 32, 32],
               "task": [8, 48, 48], "margin": [2, 8, 8],
               "roi_start": [2, 8, 8], "roi_tasks_zy": [1, 2],
               "output_block": [4, 16, 16], "claims_per_second": 30,
               "warmup": 2},
}

# the cells kept for later (PERF.md, Open questions): their files are in
# portbench/, their entries not yet in BENCHMARK.json; the copy gets them,
# so that their generators, readers and checks stay tested
WORKER = "rsunet-bf16.worker"
LATER = {
    "configs": [{
        "name": "tpu_s2d4-bf16", "source": "https://arxiv.org/abs/1606.06650",
        "file": "portbench/configs/tpu_s2d4-bf16.json", "reduced": [],
        "why": "the port's fastest family"}],
    "workloads": [
        {"name": WORKER, "config": "rsunet-bf16", "traffic": "worker",
         "chips": 1, "why": "the fleet worker"},
        {"name": "tpu_s2d4-bf16.stream", "config": "tpu_s2d4-bf16",
         "traffic": "stream", "chips": 1, "why": "host dispatch"}],
    "per_layer": [
        {"name": name, "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "storage plane",
         "moves": "mvox_s", "workloads": [WORKER]}
        for name in ("commit_ms", "cutout_ms", "save_ms")],
}


def make(dest: Path, sample: int = 2) -> Path:
    """A benchmark root under ``dest``: ``BENCHMARK.json`` and a copy of
    ``portbench/`` with the tiny sizes. Returns the copy's root."""
    bench = dest / "portbench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in LATER.items():
        manifest[key] += entries
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    for c in manifest["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(PATCH)
        path.write_text(json.dumps(cfg))
    for name, sizes in TRAFFIC.items():
        path = bench / "traffic" / f"{name}.json"
        tr = json.loads(path.read_text())
        tr.update(sizes)
        path.write_text(json.dumps(tr))
    for path in (bench / "workloads").glob("*.json"):
        cell = json.loads(path.read_text())
        cell["sample"] = sample
        path.write_text(json.dumps(cell))
    return dest
