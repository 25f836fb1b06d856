"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it (see ``README.md``):

- ``configs/<config>.json``: the model's sizes and dtypes (the file
  ``BENCHMARK.json`` names for the configuration);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the generator ``traffic/<kind>.py`` that drives the program with them;
- ``workloads/<cell>.json``: what the cell's check compares and its
  limits;
- ``metrics/<metric>.py``: one reader per metric, ``read(ctx)`` returning
  the number or ``None`` when there is nothing to read.

A traffic generator is a class ``Traffic(run, tmp)`` with ``setup()``
(weights, data, the program; it sets ``run.chunk`` and ``run.output``,
one task's input and output shapes), ``drive()`` (warm-up, then the window:
it calls ``run.open()`` at the finish of the last warm-up task, reports
each task that finishes after it through ``run.done(entered,
finished)`` and returns once ``run.over()``), ``release()`` (frees the
program's state) and ``check()`` (the compared numbers, from the plain
reference).

The window opens at a task's finish and closes at the first finish once
``--seconds`` have passed: it holds whole tasks from end to end, so a
rate over it counts every task it holds and all of its time, and does
not jump by a task with the phase of the last one.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may load: the JAX stack and the
# JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "chunkflow_tpu")


class NoDevice(RuntimeError):
    pass


def load_module(path: Path, prefix: str):
    name = f"portbench_{prefix}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with the files its names lead to."""

    def __init__(self, name: str, root: Path = ROOT, bench: Path = BENCH):
        manifest = _json(root / "BENCHMARK.json")
        entries = [w for w in manifest["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        entry = entries[0]
        self.name = name
        self.chips = int(entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = _json(root / configs[entry["config"]]["file"])
        self.traffic = _json(bench / "traffic" / f"{entry['traffic']}.json")
        self.kind = bench / "traffic" / f"{self.traffic['kind']}.py"
        self.check = _json(bench / "workloads" / f"{name}.json")

        def ours(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if ours(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
        self.metrics_dir = bench / "metrics"


def process_start() -> Optional[float]:
    """The process's start on the ``time.monotonic`` clock (boot time
    on Linux), from ``/proc``; None where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Run:
    """The state of one run, handed to the traffic generator and then, as
    ``ctx``, to the metric readers (with ``costs``, the shapes'
    arithmetic of :func:`costs_of`)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, started: float):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.started = started  # time.monotonic() at the process's start
        self.wall_started = time.time()
        # one task's input chunk and output shapes (zyx), set by the
        # traffic in set-up
        self.chunk = self.output = None
        self.t_open: Optional[float] = None
        self.t_end: Optional[float] = None
        self.t_close: Optional[float] = None
        self.setup_s: Optional[float] = None
        self.tasks: List[tuple] = []
        self.failed = 0
        self.spans: Dict[str, dict] = {}
        self.counters: Dict[str, float] = {}
        self.events = None
        self.trace_window_s: Optional[float] = None
        self.peak_window = 0
        self.peak_before = 0
        self.costs: Dict = {}
        self._tracer = None
        self._snap = None

    # ---- the window ----------------------------------------------------
    def open(self) -> None:
        import torch

        from chunkflow_tpu_torch.core import telemetry

        self.t_open = time.perf_counter()
        self.setup_s = time.monotonic() - self.started
        self._snap = telemetry.snapshot()
        if self.device == "cuda":
            self.peak_before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if self._tracer is not None:
            self._tracer.start()

    def over(self) -> bool:
        return self.t_end is not None

    @property
    def window_s(self) -> float:
        """The window's length: from its opening finish to its last."""
        return self.t_end - self.t_open

    def done(self, entered: float, finished: float) -> bool:
        """A task finished: counted, and True, where it finished inside
        the window; the first finish once ``seconds`` have passed is the
        window's last."""
        if self.t_open is None or self.over() or finished <= self.t_open:
            return False
        self.tasks.append((entered, finished))
        if finished >= self.t_open + self.seconds:
            self.t_end = finished
        return True

    def close(self) -> None:
        """Ends the window's bookkeeping (once; later calls do nothing)."""
        import torch

        from chunkflow_tpu_torch.core import telemetry

        if self.t_close is not None or self.t_open is None:
            return
        if self._tracer is not None:
            self.events = self._tracer.stop(torch)
            self.trace_window_s = self._tracer.window_s
        self.t_close = time.perf_counter()
        if self.device == "cuda":
            torch.cuda.synchronize()
            self.peak_window = torch.cuda.max_memory_allocated()
        after = telemetry.snapshot()
        for name, h in after["hists"].items():
            b = self._snap["hists"].get(name, {"count": 0, "total": 0.0})
            if h["count"] > b["count"]:
                self.spans[name] = {"count": h["count"] - b["count"],
                                    "total": h["total"] - b["total"]}
        for name, v in after["counters"].items():
            self.counters[name] = v - self._snap["counters"].get(name, 0)

    # ---- what readers use ----------------------------------------------
    def span_ms(self, name: str) -> Optional[float]:
        """Mean milliseconds of a span over the window."""
        h = self.spans.get(name)
        return h["total"] / h["count"] * 1e3 if h else None


def _reader_values(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        reader = load_module(run.cell.metrics_dir / f"{m['name']}.py",
                             "metric")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def costs_of(config: dict, chunk, output) -> dict:
    """Per task: conv FLOPs of the patches its ``chunk`` needs, per kernel
    its launches, bytes and bound over that chunk (``reference/
    counts.py``), and the voxels of its ``output``."""
    from reference import counts

    patch = config["input_patch"]
    overlap = config["overlap"]
    kernels = counts.chunk_costs(chunk, patch, overlap, config["batch"],
                                 config["in_channels"],
                                 config["out_channels"])
    return {
        "flops_per_task": counts.patches_per_chunk(chunk, patch, overlap)
        * counts.conv_flops(config, patch),
        "kernels": kernels,
        "output_voxels": math.prod(output),
        "peak_flops": counts.PEAK_BF16_FLOPS
        if config["compute_dtype"] == "bfloat16" else counts.PEAK_F32_FLOPS,
    }


def _diagnose(run: Run, started, t_setup, t_built, t_drained, log) -> None:
    """Where the set-up went, the window's tasks, the scheduler's depth
    changes and the trace's size, on ``log``."""
    from chunkflow_tpu_torch.core import telemetry

    print(f"portbench: set-up {run.setup_s:.3f} s: to the traffic "
          f"{t_setup - started:.3f} s, weights, data and program "
          f"{t_built - t_setup:.3f} s, warm-up "
          f"{run.setup_s - (t_built - started):.3f} s", file=log)
    window = run.window_s if run.over() else float("nan")
    print(f"portbench: window {window:.3f} s with {len(run.tasks)} "
          f"tasks, drained {t_drained - run.t_close:.3f} s after it, check "
          f"{time.perf_counter() - t_drained:.3f} s", file=log)
    changes = [(e["tasks"], e["name"].split("/")[-1], e["new"])
               for e in telemetry.snapshot()["events"]
               if e.get("kind") == "depth_change"
               and e.get("t", 0) >= run.wall_started]
    print(f"portbench: the scheduler's depth changes (tasks, knob, depth): "
          f"{changes}", file=log)
    if run.events is not None:
        print(f"portbench: traced {len(run.events)} device events in "
              f"{run.trace_window_s:.3f} s", file=log)


def power_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read: {exc!r}"


def forbidden_modules() -> List[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", started: Optional[float] = None,
            tmp_root: Optional[str] = None, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result object: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
    when traced, and ``checked`` last."""
    import tempfile

    import torch

    import devtrace

    if started is None:
        started = time.monotonic()
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device: this benchmark measures the "
                           "card and never falls back to the CPU")
        if torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA device(s), "
                           f"the cell asks for {cell.chips}")
    run = Run(cell, seed, seconds, trace, device, started)
    if trace and device == "cuda":
        run._tracer = devtrace.Tracer()
        run._tracer.warm(torch)
    kind = load_module(cell.kind, "traffic")
    with tempfile.TemporaryDirectory(prefix="portbench-",
                                     dir=tmp_root) as tmp:
        traffic = kind.Traffic(run, tmp)
        t_setup = time.monotonic()
        traffic.setup()
        t_built = time.monotonic()
        traffic.drive()
        run.close()
        t_drained = time.perf_counter()
        memory_peak = max(run.peak_before, run.peak_window)
        traffic.release()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        checked = traffic.check()
        del traffic
        gc.collect()
        _diagnose(run, started, t_setup, t_built, t_drained, log)
    # what the run wrote and did not delete reaches the disk now, so that
    # no run's writeback falls into the next run
    os.sync()
    run.costs = costs_of(cell.config, run.chunk, run.output)
    metrics = _reader_values(run, cell.per_layer if trace
                             else cell.end_to_end)
    limits = cell.check["limits"]
    compared = {name: {"value": checked[name], "limit": limits[name]}
                for name in limits}
    compared["tasks_compared"] = {"value": checked["tasks_compared"],
                                  "limit": cell.check["sample"]}
    correct = (bool(run.tasks) and run.failed == 0
               and checked["tasks_compared"] == cell.check["sample"]
               and all(c["value"] <= c["limit"]
                       for name, c in compared.items()
                       if name != "tasks_compared"))
    result = {
        "correct": correct,
        "attempted": len(run.tasks) + run.failed,
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": torch.cuda.get_device_name(0) if device == "cuda"
            else device,
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace and run.events is not None:
        result["device"]["busy_s"] = devtrace.busy_us(run.events) / 1e6
        result["device"]["window_s"] = run.trace_window_s
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(run.events),
            "idle_gaps": devtrace.idle_gaps(run.events),
        }
    result["checked"] = compared
    return result
