"""The port's ``log-summary`` against the JAX package's, on the CPU.

The same directories go through both CLIs' ``log-summary``: one written
by a JAX worker run, one by a port worker run, and a seeded one with
rotated generations, several workers with skewed clocks, a task that
hopped between them, serving, segment, storage, fleet, mesh, program,
SLO and timeseries events. Standard output is byte for byte the JAX
package's for ``--metrics-dir``, ``--fleet``, ``--fleet --trace-id`` and
``--slo``, and the ``--export-trace`` files are equal. For ``--log-dir``
the numbers of the per-device table (the port prints no pandas frame)
and the ``device ...: X Mvoxel/s`` lines are the JAX package's. Also the
JAX cases ``test_log_summary_serving_block`` and
``test_alert_survives_worker_sigkill_via_log_summary``, and the summary
of a ``torch.profiler`` capture.
"""
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from chunkflow_tpu.core import telemetry as jtel
from chunkflow_tpu.flow import log_summary as jls
from chunkflow_tpu.flow.cli import main as jax_main
from chunkflow_tpu.parallel import queues as jqueues
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.flow import cli, log_summary, profile_summary
from chunkflow_tpu_torch.flow import trace_export
from chunkflow_tpu_torch.parallel import queues

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_ENV = ("CHUNKFLOW_TELEMETRY", "CHUNKFLOW_SERVE", "CHUNKFLOW_SLO",
        "CHUNKFLOW_TS_INTERVAL", "CHUNKFLOW_CHAOS", "CHUNKFLOW_WORKER_ID",
        "CHUNKFLOW_METRICS_PORT", "CHUNKFLOW_PROFILE_DIR",
        "CHUNKFLOW_SCHED_MEM_GB")


@pytest.fixture
def clean(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    telemetry.reset()
    jtel.reset()
    yield monkeypatch
    telemetry.reset()
    jtel.reset()


# ---------------------------------------------------------------------------
# the directories
# ---------------------------------------------------------------------------
WORKER_CHAIN = ["fetch-task-from-queue", "-q", None, "--max-retries", "3",
                "-r", "0", "create-chunk", "--size", "8", "32", "32",
                "inference", "-f", "identity", "-p", "4", "16", "16", "-v",
                "2", "8", "8", "-c", "3", "-b", "2", "--async-depth", "2",
                "save-npy", "-f", None, "delete-task-in-queue"]
BODIES = ["0-8_0-32_0-32", "0-8_32-64_0-32", "8-16_0-32_0-32"]


def _chain(queue, out):
    args = list(WORKER_CHAIN)
    args[2], args[args.index(None)] = queue, out
    return args


def jax_run_dir(tmp_path, monkeypatch):
    """A JAX worker's metrics directory (its own XLA compile records
    included)."""
    mdir = tmp_path / "jax-run"
    monkeypatch.setenv("CHUNKFLOW_WORKER_ID", "jax-worker")
    jqueues.MemoryQueue._registry.pop("ls-jax", None)
    jqueues.open_queue("memory://ls-jax").send_messages(BODIES)
    result = CliRunner().invoke(
        jax_main, ["--metrics-dir", str(mdir)]
        + _chain("memory://ls-jax", str(tmp_path / "jax.npy")),
        catch_exceptions=False)
    assert result.exit_code == 0, result.output
    monkeypatch.delenv("CHUNKFLOW_WORKER_ID")
    jtel.reset()
    return mdir


def port_run_dir(tmp_path, monkeypatch):
    mdir = tmp_path / "port-run"
    monkeypatch.setenv("CHUNKFLOW_WORKER_ID", "port-worker")
    queues.MemoryQueue._registry.pop("ls-port", None)
    queues.open_queue("memory://ls-port").send_messages(BODIES)
    assert cli.main(["--device", "cpu", "--metrics-dir", str(mdir)]
                    + _chain("memory://ls-port",
                             str(tmp_path / "port.npy"))) == 0
    monkeypatch.delenv("CHUNKFLOW_WORKER_ID")
    telemetry.reset()
    return mdir


def _qhist(rng, n):
    counts = np.bincount(rng.integers(2, 12, n), minlength=17)
    return {"count": int(n), "total": float(rng.random() * n),
            "buckets": [int(c) for c in counts]}


TRACE = "a" * 32


def seeded_dir(tmp_path):
    """Three workers' JSONL written by hand: a submitter, two claimers
    (one clock 2.5 s behind), rotated generations, and every block's
    events."""
    rng = np.random.default_rng(7)
    mdir = tmp_path / "seeded"
    mdir.mkdir()
    t0 = 1.79e9

    def ev(worker, t, kind, name="", **attrs):
        return dict(kind=kind, name=name, t=t, pid=100, worker=worker,
                    **attrs)

    streams = {"submitter": [], "w-a": [], "w-b": []}
    streams["submitter"] += [
        ev("submitter", t0, "task", "queue/submit", queue="q",
           body="0-8_0-16_0-16", trace_id=TRACE),
        ev("submitter", t0 + 0.1, "task", "queue/submit", queue="q",
           body="8-16_0-16_0-16", trace_id="b" * 32),
        ev("submitter", t0 + 0.2, "fleet", "fleet/scale", direction="up",
           target=2, reason="deep-queue", pending=8,
           dominant="pipeline/compute"),
        ev("submitter", t0 + 0.3, "gauge", "fleet/workers", value=2.0),
        ev("submitter", t0 + 0.3, "gauge", "fleet/target", value=2.0),
        ev("submitter", t0 + 9, "snapshot", counters={
            "queue/sent": 2, "fleet/spawns": 3, "fleet/scale_up": 1,
            "fleet/worker_deaths": 1, "fleet/leases_nacked": 1,
            "fleet/holds": 2}, gauges={"fleet/workers": 1.0}),
    ]
    for worker, skew in (("w-a", -2.5), ("w-b", 0.0)):
        s = streams[worker]
        base = t0 + 1 + skew
        for i, phase in enumerate(log_summary.STALL_PHASES):
            s.append(ev(worker, base + i * 0.01, "span", phase,
                        dur_s=float(rng.random())))
        s.append(ev(worker, base + 0.2, "span", "storage/read",
                    dur_s=0.25, mode="blockwise", blocks=4))
        s.append(ev(worker, base + 0.3, "span", "storage/write",
                    dur_s=0.125, mode="aligned"))
        for name, value in (("pipeline/ring_occupancy", 1.5),
                            ("device/bytes_in_use", 3 * 2 ** 30),
                            ("device/peak_bytes", 5 * 2 ** 30),
                            ("device/hbm_headroom", 70 * 2 ** 30),
                            ("storage/cache_bytes", 2 ** 27),
                            ("serving/inflight", 2.0),
                            ("serving/occupancy", 0.75),
                            ("scheduler/depth/dispatch", 3.0),
                            ("slo/availability/burn_rate", 4.0),
                            ("slo/availability/budget_remaining", 0.5),
                            ("slo/availability/firing", 1.0)):
            s.append(ev(worker, base + 0.4, "gauge", name,
                        value=float(value) * (1.5 if worker == "w-b"
                                              else 1.0)))
        s.append(ev(worker, base + 0.45, "depth_change", "dispatch",
                    old=2, new=3, phase="pipeline/compute", share=0.7))
        s.append(ev(worker, base + 0.5, "alert",
                    alert="availability:fast", state="firing",
                    severity="page", burn_short=4.0, burn_long=3.0,
                    budget_remaining=0.5))
        for k in range(5):
            s.append(ev(worker, base + k, "timeseries", "timeseries/sample",
                        interval_s=1.0, values={
                            "rate:serving/requests": float(k + 1),
                            "gauge:serving/inflight": float(k % 3),
                            "gauge:slo/availability/burn_rate": 2.0 + k},
                        qhists={"serving/latency": _qhist(rng, 10 * k)}))
        s.append(ev(worker, base + 5, "snapshot", counters={
            "tasks/committed": 3, "tasks/retried": 1, "ledger/skips": 1,
            "tasks/dead_lettered": 1, "lease/renewals": 4,
            "storage/hits": 30, "storage/misses": 10,
            "storage/bytes_read": 2 ** 20, "segment/chunks_labeled": 2,
            "segment/edges_found": 5, "segment/voxels_relabeled": 4096,
            "serving/requests": 9, "serving/completed": 8,
            "serving/deadline_missed": 1, "compile_cache/builds": 2,
            "compile_cache/hits": 5, "shard/chunks": 4,
            "shard/halo_bytes": 2 ** 21},
            gauges={"shard/mesh_devices": 2.0},
            qhists={"serving/latency": _qhist(rng, 40)},
            hists={"op/inference": {"count": 3, "total": 1.5,
                                    "max": 0.75}}))
    # the hop: claimed by w-a (clock behind), retried, claimed and
    # committed by w-b
    streams["w-a"] += [
        ev("w-a", t0 - 1.0, "task", "lifecycle/claimed",
           body="0-8_0-16_0-16", trace_id=TRACE),
        ev("w-a", t0 - 0.5, "task_retry", "lifecycle/retry",
           body="0-8_0-16_0-16", trace_id=TRACE, reason="ValueError: x"),
    ]
    streams["w-b"] += [
        ev("w-b", t0 + 2.0, "task", "lifecycle/claimed",
           body="0-8_0-16_0-16", trace_id=TRACE),
        ev("w-b", t0 + 2.5, "task", "lifecycle/committed",
           body="0-8_0-16_0-16", trace_id=TRACE),
        ev("w-b", t0 + 3.0, "task", "lifecycle/claimed",
           body="8-16_0-16_0-16", trace_id="b" * 32),
        ev("w-b", t0 + 3.5, "alert", alert="availability:fast",
           state="resolved", severity="page"),
    ]
    # the JAX package's own records: programs and per-chip mesh gauges
    streams["w-b"] += [
        ev("w-b", t0 + 4, "compile", family="blend", key="k1",
           build_s=0.5, compile_s=0.25, flops=1e9, bytes_accessed=2e6,
           device="cpu"),
        ev("w-b", t0 + 4.1, "programs", programs=[
            {"family": "forward", "key": "k2", "lost_s": 1.25,
             "compile_s": 0.5, "flops": 3e9, "bytes_accessed": 4e6,
             "vmem_bytes": 2 ** 20, "exec_mean_s": 0.01,
             "roofline_util": 0.25}]),
    ]
    for chip in (0, 1):
        for name, value in (("shard/chip/{}/voxels", 4096),
                            ("shard/chip/{}/ready_s", 0.125 * (chip + 1)),
                            ("device/chip/{}/bytes_in_use", 2 ** 30),
                            ("device/chip/{}/hbm_headroom", 2 ** 29)):
            streams["w-a"].append(ev("w-a", t0 + 4, "gauge",
                                     name.format(chip), value=float(value)))
    for name, value in (("shard/mesh_devices", 2.0), ("shard/mesh_y", 2.0),
                        ("shard/chip_skew_s", 0.125),
                        ("shard/collective_share_est", 0.75),
                        ("shard/compute_s_est", 0.01),
                        ("shard/collective_s_est", 0.03)):
        streams["w-a"].append(ev("w-a", t0 + 4.2, "gauge", name,
                                 value=value))
    # w-a's stream in three generations (.2 oldest), a torn last line
    a = streams.pop("w-a")
    parts = (a[:10], a[10:25], a[25:])
    for path, part in zip(("telemetry-w-a.jsonl.2", "telemetry-w-a.jsonl.1",
                           "telemetry-w-a.jsonl"), parts):
        with open(mdir / path, "w") as f:
            for record in part:
                f.write(json.dumps(record) + "\n")
    with open(mdir / "telemetry-w-a.jsonl", "a") as f:
        f.write('{"kind": "span", "name": "torn')
    for worker, stream in streams.items():
        with open(mdir / f"telemetry-{worker}.jsonl", "w") as f:
            for record in stream:
                f.write(json.dumps(record) + "\n")
    return mdir


def _jax_out(args):
    result = CliRunner().invoke(jax_main, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    jtel.reset()
    return result.output


def _port_out(args, capsys):
    capsys.readouterr()
    assert cli.main(["--device", "cpu", *args]) == 0
    telemetry.reset()
    return capsys.readouterr().out


def _trace_id(mdir):
    events = log_summary.load_telemetry_dir(str(mdir))
    return next(e["trace_id"] for e in events
                if e.get("name") == "lifecycle/committed")


VIEWS = {
    "metrics-dir": [],
    "fleet": ["--fleet"],
    "trace-id": ["--fleet", "--trace-id", None],
    "slo": ["--slo"],
}


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("source", ["jax-run", "port-run", "seeded"])
def test_log_summary_prints_the_jax_bytes(source, view, clean, tmp_path,
                                          capsys):
    mdir = {"jax-run": jax_run_dir, "port-run": port_run_dir,
            "seeded": lambda p, m: seeded_dir(p)}[source](tmp_path, clean)
    extra = [(_trace_id(mdir) if a is None else a) for a in VIEWS[view]]
    args = ["log-summary", "--metrics-dir", str(mdir), *extra]
    jax_out = _jax_out(args)
    port_out = _port_out(args, capsys)
    assert port_out == jax_out
    assert "telemetry" in port_out or "fleet:" in port_out
    if source == "seeded" and view == "metrics-dir":
        for block in ("pipeline stall attribution", "fault tolerance",
                      "segment (", "storage (", "serving (",
                      "fleet supervisor", "ring occupancy",
                      "adaptive scheduler", "program cache",
                      "device programs", "mesh (", "device memory"):
            assert block in port_out, block
    if source == "seeded" and view == "trace-id":
        assert f"trace {TRACE}: 5 event(s)" in port_out
    if source == "seeded" and view == "slo":
        assert "alerts fired: 2 (1 resolved)" in port_out
        assert "FIRING (w-a, w-b)" in port_out


def _without_t0(mdir, dest):
    """A copy of a metrics directory whose span events carry no start
    ``t0``: files as the JAX package and the port before it write them."""
    dest.mkdir()
    for path in Path(mdir).iterdir():
        text = path.read_text()
        if ".jsonl" in path.name:
            records = [json.loads(line) for line in text.splitlines()
                       if line.strip()]
            for record in records:
                record.pop("t0", None)
            text = "".join(json.dumps(r) + "\n" for r in records)
        (dest / path.name).write_text(text)
    return dest


@pytest.mark.parametrize("source", ["port-run", "seeded"])
def test_export_trace_is_the_jax_tools(source, clean, tmp_path, capsys):
    mdir = {"port-run": port_run_dir,
            "seeded": lambda p, m: seeded_dir(p)}[source](tmp_path, clean)
    if source == "port-run":
        # the port's spans carry their start, which the JAX tool reads as
        # an argument and the port's places them at
        # (test_export_places_spans_at_their_start): on the same files
        # without it, the two tools write the same trace
        mdir = _without_t0(mdir, tmp_path / "port-run-older")
    jax_file, port_file = tmp_path / "jax.json", tmp_path / "port.json"
    jax_out = _jax_out(["log-summary", "--metrics-dir", str(mdir),
                        "--export-trace", str(jax_file)])
    port_out = _port_out(["log-summary", "--metrics-dir", str(mdir),
                          "--export-trace", str(port_file)], capsys)
    assert port_out == jax_out.replace(str(jax_file), str(port_file))
    trace = json.loads(port_file.read_text())
    assert trace == json.loads(jax_file.read_text())
    assert trace_export.validate_chrome_trace(trace) == []
    if source == "seeded":
        # three worker processes; each task's hops as one flow
        assert trace["otherData"]["workers"] == 3
        assert trace["otherData"]["flow_pairs"] == 2
        flows = {}
        for e in trace["traceEvents"]:
            if e.get("cat") == "task_flow":
                flows.setdefault(e["args"]["trace_id"], []).append(e["ph"])
        assert flows == {TRACE: ["s", "t", "f"], "b" * 32: ["s", "f"]}


@pytest.mark.parametrize("stamped", [True, False])
def test_export_places_spans_at_their_start(stamped):
    """A span event with ``t0`` starts there; one of an older file, with
    only its end ``t`` and ``dur_s``, at ``t - dur_s``."""
    span = {"kind": "span", "name": "pipeline/dispatch", "worker": "w",
            "t": 100.5, "dur_s": 0.25, "chunk": 3}
    if stamped:
        # the duration is perf_counter's, the stamps the wall clock's:
        # they need not agree to the microsecond
        span["t0"] = 100.2499
    gauge = {"kind": "gauge", "name": "pipeline/inflight", "worker": "w",
             "t": 100.0, "value": 2}
    trace = trace_export.export_chrome_trace([gauge, span])
    assert trace_export.validate_chrome_trace(trace) == []
    (x,) = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    (c,) = [e for e in trace["traceEvents"] if e.get("ph") == "C"]
    start = 100.2499 if stamped else 100.25
    assert x["ts"] - c["ts"] == pytest.approx((start - 100.0) * 1e6)
    assert x["dur"] == 250000.0
    assert x["args"] == {"chunk": 3}


def test_clock_offsets_and_timelines_are_the_jax_packages(tmp_path):
    events = log_summary.load_telemetry_dir(str(seeded_dir(tmp_path)))
    assert events == jls.load_telemetry_dir(str(tmp_path / "seeded"))
    assert log_summary.worker_clock_offsets(events) == \
        jls.worker_clock_offsets(events) == {"w-a": pytest.approx(1.0)}
    assert log_summary.trace_timeline(events, TRACE) == \
        jls.trace_timeline(events, TRACE)
    assert log_summary.summarize_fleet(events) == jls.summarize_fleet(events)
    assert log_summary.summarize_timeseries(events) == \
        jls.summarize_timeseries(events)
    for points in ([], [(0, 1.0)] * 3, [(i, float(i % 7)) for i in range(100)]):
        assert log_summary.sparkline(points) == jls.sparkline(points)


# ---------------------------------------------------------------------------
# --log-dir: the numbers, and the Mvoxel/s lines byte for byte
# ---------------------------------------------------------------------------
def _log_dir(tmp_path):
    rng = np.random.default_rng(3)
    log_dir = tmp_path / "logs"
    log_dir.mkdir()
    for i in range(7):
        timer = {"load": float(rng.random()), "inference": float(rng.random())}
        if i % 3:
            timer["save"] = float(rng.random())
        record = {"timer": timer,
                  "compute_device": ("cpu", "cuda:0")[i % 2]}
        name = f"{i * 8}-{i * 8 + 8}_0-64_0-64.json"
        if i == 6:  # no bbox in the name: the record's own
            record = {"log": {"timer": timer, "compute_device": "cuda:0"},
                      "bbox": "0-4_0-8_0-8"}
            name = "task-six.json"
        (log_dir / name).write_text(json.dumps(record))
    return log_dir


def test_log_dir_numbers_are_the_jax_packages(tmp_path, capsys):
    log_dir = _log_dir(tmp_path)
    for output_size in (None, (4, 8, 8)):
        records = log_summary.load_log_dir(str(log_dir))
        got = log_summary.summarize(records, output_size=output_size)
        ref = jls.summarize(jls.load_log_dir(str(log_dir)),
                            output_size=output_size)
        assert sorted(got) == sorted(ref.index)
        for device, columns in got.items():
            assert list(columns) == list(dict.fromkeys(
                c for c, _ in ref.columns))
            for column, stats in columns.items():
                for stat, value in stats.items():
                    want = ref.loc[device, (column, stat)]
                    if stat == "count" or np.isnan(want):
                        assert value == want or (np.isnan(value)
                                                 and np.isnan(want))
                    elif stat in ("max", "min"):
                        assert value == want
                    else:  # pandas sums a group with compensation
                        assert value == pytest.approx(want, rel=1e-12)
    jax_out = _jax_out(["log-summary", "--log-dir", str(log_dir),
                        "--output-size", "4", "8", "8"])
    port_out = _port_out(["log-summary", "--log-dir", str(log_dir),
                          "--output-size", "4", "8", "8"], capsys)

    def mvox(text):
        return [ln for ln in text.splitlines() if ln.startswith("device ")]

    assert mvox(port_out) == mvox(jax_out)
    assert len(mvox(port_out)) == 2
    assert "compute_device cpu:" in port_out
    assert log_summary.load_log(str(log_dir)) == records
    log_summary.print_log_statistics([])
    assert capsys.readouterr().out == "no log records\n"


def test_log_summary_usage_errors(capsys):
    with pytest.raises(SystemExit, match="needs --log-dir"):
        cli.main(["--device", "cpu", "log-summary"])
    with pytest.raises(SystemExit, match="needs --metrics-dir"):
        cli.main(["--device", "cpu", "log-summary", "--log-dir", "x",
                  "--fleet"])


# ---------------------------------------------------------------------------
# the JAX package's cases
# ---------------------------------------------------------------------------
def test_log_summary_serving_block(clean, tmp_path, capsys):
    """``tests/serve/test_frontend.py``'s case through the port."""
    import base64

    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.serve import LocalBackend, ServingService

    telemetry.configure(str(tmp_path))
    inferencer = Inferencer(input_patch_size=(4, 16, 16),
                            output_patch_overlap=(2, 8, 8),
                            num_output_channels=3, framework="identity",
                            batch_size=4, crop_output_margin=False,
                            device="cpu")
    backend = LocalBackend(inferencer, workers=1)
    service = ServingService(backend)
    try:
        rng = np.random.default_rng(2)
        for _ in range(3):
            arr = rng.random((6, 20, 28)).astype(np.float32)
            body = json.dumps({
                "shape": list(arr.shape), "dtype": "float32",
                "data_b64": base64.b64encode(arr.tobytes()).decode(),
                "deadline_s": 20.0}).encode()
            status, _ = service.handle("POST", "/infer", body)
            assert status == 200
    finally:
        backend.close()
    telemetry.flush()
    telemetry.configure(None)
    agg = log_summary.print_telemetry_summary(str(tmp_path))
    out = capsys.readouterr().out
    assert "serving (docs/serving.md):" in out
    assert "serving/requests" in out
    assert "latency p50" in out
    assert agg["counters"]["serving/completed"] == 3
    assert agg["qhists"]["serving/latency"]["count"] == 3
    log_summary.print_fleet_summary(str(tmp_path))
    assert "serving: requests=3" in capsys.readouterr().out
    # and the JAX package reads the port's directory the same way
    jls.print_telemetry_summary(str(tmp_path))
    jax_out = capsys.readouterr().out
    log_summary.print_telemetry_summary(str(tmp_path))
    assert capsys.readouterr().out == jax_out


SLO_TOML = """
period_s = 600
[objective.availability]
target = 0.9
[objective.deadline]
target = 0.9
[objective.latency]
enabled = false
[objective.dead_letter]
enabled = false
[objective.storage_hit]
enabled = false
[rule.fast]
short_s = 0.4
long_s = 1.6
burn = 2.0
severity = "page"
[rule.slow]
enabled = false
"""

_VICTIM_SCRIPT = r"""
import base64, json, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from chunkflow_tpu_torch.core import slo, telemetry
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.serve import LocalBackend, ServingService
from chunkflow_tpu_torch.testing import chaos

metrics_dir, cfg = sys.argv[1], sys.argv[2]
telemetry.configure(metrics_dir)
evaluator = slo.start_slo(cfg, pyproject="/nonexistent")
inferencer = Inferencer(
    input_patch_size=(4, 16, 16), output_patch_overlap=(2, 8, 8),
    num_output_channels=3, framework="identity", batch_size=4,
    crop_output_margin=False, device="cpu")
backend = LocalBackend(inferencer, workers=1, max_retries=0,
                       backoff_base=0.01)
service = ServingService(backend, default_deadline_s=10.0)
chaos.configure("seed=1:rate=1.0:points=serving/compute")
rng = np.random.default_rng(0)
arr = (rng.random((4, 16, 16)) * 255).astype(np.uint8)
body = json.dumps({
    "shape": list(arr.shape), "dtype": "uint8",
    "data_b64": base64.b64encode(arr.tobytes()).decode(),
    "deadline_s": 10.0,
}).encode()
deadline = time.time() + 30
while time.time() < deadline and not evaluator.firing():
    service.handle("POST", "/infer", body)
    time.sleep(0.04)
print("ALERTED" if evaluator.firing() else "NOALERT", flush=True)
time.sleep(600)  # hold the sink open until the SIGKILL lands
"""


def test_alert_survives_worker_sigkill_via_log_summary(clean, tmp_path,
                                                       capsys):
    """``tests/serve/test_slo_acceptance.py``'s case through the port: a
    serving worker that alerted is SIGKILLed (nothing flushes), and
    ``log-summary --slo`` rebuilds the report from its JSONL alone, as
    the JAX CLI does from the same directory."""
    metrics_dir = tmp_path / "metrics"
    metrics_dir.mkdir()
    script = tmp_path / "victim.py"
    script.write_text(_VICTIM_SCRIPT)
    config = tmp_path / "slo.toml"
    config.write_text(SLO_TOML)
    env = dict(os.environ, CHUNKFLOW_WORKER_ID="slo-victim",
               CHUNKFLOW_TS_INTERVAL="0.05",
               CHUNKFLOW_PROFILE_ON_ANOMALY="0", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                   if p))
    proc = subprocess.Popen([sys.executable, str(script), str(metrics_dir),
                             str(config)], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        timer = threading.Timer(120.0, proc.kill)
        timer.start()
        try:
            line = proc.stdout.readline().strip()
        finally:
            timer.cancel()
        assert line == "ALERTED", f"victim said {line!r}"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    args = ["log-summary", "--metrics-dir", str(metrics_dir), "--slo"]
    out = _port_out(args, capsys)
    assert "alerts fired: 1" in out
    assert "availability:fast page" in out
    assert "FIRING (slo-victim)" in out
    assert "rate:serving/requests" in out
    assert out == _jax_out(args)


# ---------------------------------------------------------------------------
# profiler captures
# ---------------------------------------------------------------------------
def test_profile_summary_of_a_torch_profiler_capture(clean, tmp_path,
                                                     capsys):
    """A real ``torch.profiler`` trace of a CPU convolution (no device
    events: its outermost operators count), and a trace with the card's
    event kinds: every kernel of the port by name, cuDNN, copies."""
    from torch.profiler import ProfilerActivity, profile

    capture = tmp_path / "profile-operator-1"
    capture.mkdir()
    x = torch.rand(1, 1, 8, 32, 32)
    w = torch.rand(4, 1, 3, 3, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.nn.functional.conv3d(x, w).sum()
    prof.export_chrome_trace(str(capture / "trace.json"))
    summary = profile_summary.summarize_trace_dir(str(capture))
    events = json.loads((capture / "trace.json").read_text())["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def inside(e, o):
        return (o is not e and o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                and o["ts"] + o["dur"] >= e["ts"] + e["dur"])

    top = [e for e in ops if not any(inside(e, o) for o in ops)]
    assert {e["name"] for e in top} == {"aten::conv3d", "aten::sum"}
    assert summary["files"] == 1
    assert summary["total_device_us"] == pytest.approx(
        sum(float(e["dur"]) for e in top))
    cats = {row["category"]: row for row in summary["categories"]}
    assert cats["convolution"]["share"] > 0.5
    assert sum(row["share"] for row in summary["categories"]) == \
        pytest.approx(1.0)

    card = tmp_path / "profile-slo-latency-2"
    card.mkdir()
    kernels = [
        ("kernel", "void gather_kernel<unsigned char>(unsigned char "
                   "const*, Starts, float*)", 6.0),
        ("kernel", "accumulate_kernel(float*, float*, float const*)", 58.0),
        ("kernel", "void conv3d_int8_hopper_kernel<64, 2>(CUtensorMap)",
         320.0),
        ("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32",
         500.0),
        ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 100.0),
        ("gpu_memset", "Memset (Device)", 16.0),
        ("kernel", "void at::native::vectorized_elementwise_kernel", 0.0),
        ("cpu_op", "aten::conv3d", 9999.0),
    ]
    trace = {"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
         "ts": 10.0 * i, "dur": dur} for i, (cat, name, dur)
        in enumerate(kernels)]}
    (card / "trace.json").write_text(json.dumps(trace))
    summary = profile_summary.summarize_trace_dir(str(card))
    assert summary["total_device_us"] == 1000.0
    assert {row["category"]: row["us"] for row in summary["categories"]} \
        == {"convolution": 500.0, "conv3d_int8": 320.0, "copy": 116.0,
            "accumulate": 58.0, "gather": 6.0, "other": 0.0}
    (tmp_path / "profile-empty-3").mkdir()
    log_summary.print_profile_summaries(str(tmp_path))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("profiler capture profile-empty-3: no trace")
    assert out[1].startswith("profiler capture profile-operator-1: 1 "
                             "file(s), ")
    assert out[2] == ("profiler capture profile-slo-latency-2: 1 file(s), "
                      "1.00 ms device time [convolution 50%, conv3d_int8 "
                      "32%, copy 12%]")
