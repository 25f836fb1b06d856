"""The port's serving front end against the JAX package, on the CPU.

The cases of ``tests/serve/test_frontend.py`` through the port (the
fleet supervisor's endpoint discovery and the log-summary SERVING block
are in ``tests/test_torch_fleet.py`` and ``test_torch_log_summary.py``):
``POST /infer`` over real HTTP, admission and memory rejects, 400s,
deadlines, lifecycle retries and dead letters, volume-reference
requests, and the ``serve`` command.
The same request bodies go through the port's and the JAX package's
``ServingService.handle`` and the decoded responses are bitwise equal,
and so are the two CLIs' ``serve`` answers to one request. Spool mode
runs external port workers (``python -m chunkflow_tpu_torch
fetch-task-from-queue ... delete-task-in-queue``); the first is killed by
``CHUNKFLOW_CHAOS="once=lifecycle/pre_ledger:action=kill"`` after it
wrote the output but before the ledger marked it, and the request is
redelivered on lease expiry and answered once. The cases of
``tests/serve/test_slo_acceptance.py`` (the log-summary one is in
``tests/test_torch_log_summary.py``) tick the SLO evaluator with an
explicit clock.
"""
import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from chunkflow_tpu.core import telemetry as jtel
from chunkflow_tpu.inference import Inferencer as JaxInferencer
from chunkflow_tpu.serve.frontend import LocalBackend as JaxLocalBackend
from chunkflow_tpu.serve.frontend import ServingService as JaxServingService
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.core import profiling, slo, telemetry
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.parallel import restapi
from chunkflow_tpu_torch.serve import (
    AdmissionController,
    AdmissionRejected,
    LocalBackend,
    RequestExpired,
    ServingRequest,
    ServingService,
    SpoolBackend,
    start_serving,
)
from chunkflow_tpu_torch.testing import chaos

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PIN = (4, 16, 16)
_ENV = ("CHUNKFLOW_TELEMETRY", "CHUNKFLOW_SERVE", "CHUNKFLOW_SCHED_MEM_GB",
        "CHUNKFLOW_SLO", "CHUNKFLOW_TS_INTERVAL", "CHUNKFLOW_CHAOS",
        "CHUNKFLOW_WORKER_ID", "CHUNKFLOW_METRICS_PORT",
        "CHUNKFLOW_PROFILE_DIR", "CHUNKFLOW_STORAGE_CACHE_MB")


@pytest.fixture
def clean(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    # an automatic capture (a page alert's) lasts a tenth of a second
    monkeypatch.setenv("CHUNKFLOW_PROFILE_SECONDS", "0.1")
    telemetry.reset()
    jtel.reset()
    chaos.reset()
    yield monkeypatch
    chaos.reset()
    profiling.wait_for_captures()
    telemetry.reset()
    jtel.reset()


def make_inferencer(**kwargs):
    defaults = dict(input_patch_size=PIN, output_patch_overlap=(2, 8, 8),
                    num_output_channels=3, framework="identity",
                    batch_size=4, crop_output_margin=False)
    defaults.update(kwargs)
    return Inferencer(device="cpu", **defaults)


def make_jax_inferencer(**kwargs):
    defaults = dict(input_patch_size=PIN, output_patch_overlap=(2, 8, 8),
                    num_output_channels=3, framework="identity",
                    batch_size=4, crop_output_margin=False)
    defaults.update(kwargs)
    return JaxInferencer(**defaults)


def infer_body(arr, deadline_s=20.0, **extra):
    payload = {"shape": list(arr.shape), "dtype": arr.dtype.name,
               "data_b64": base64.b64encode(
                   np.ascontiguousarray(arr).tobytes()).decode(),
               "deadline_s": deadline_s}
    payload.update(extra)
    return json.dumps(payload).encode()


def decode_response(payload):
    return np.frombuffer(base64.b64decode(payload["data_b64"]),
                         dtype=payload["dtype"]).reshape(payload["shape"])


def _ref(inferencer, arr, **kwargs):
    return np.asarray(inferencer(Chunk(arr, **kwargs)).host().array)


def _http_infer(port, body, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/infer",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


# ---------------------------------------------------------------------------
# the full HTTP path
# ---------------------------------------------------------------------------
def test_post_infer_end_to_end_http(clean):
    """Port 0 binds ephemeral; POST /infer returns the bitwise per-chunk
    result with a trace id; /serving reports the latency quantiles;
    /metrics renders the histogram; the request commits once."""
    inferencer = make_inferencer()
    backend = LocalBackend(inferencer, workers=2)
    service = ServingService(backend, default_deadline_s=30.0)
    server = start_serving(service, host="127.0.0.1", port=0)
    port = restapi.bound_port(server)
    assert port > 0
    try:
        arr = np.random.default_rng(0).random((6, 20, 28)).astype(np.float32)
        ref = _ref(inferencer, arr)
        status, payload = _http_infer(port, infer_body(arr))
        assert status == 200
        assert np.array_equal(decode_response(payload), ref)
        assert payload["trace_id"] and payload["latency_s"] > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/serving",
                                    timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["requests"] == 1 and stats["completed"] == 1
        assert stats["latency_p50_s"] > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert "chunkflow_serving_latency_bucket" in text
        parsed = restapi.serving_stats(text)
        assert parsed["completed"] == 1 and parsed["p50_s"] is not None
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        counters = telemetry.snapshot()["counters"]
        assert counters.get("tasks/committed") == 1
        assert len(backend.ledger) == 1
    finally:
        backend.close()
        restapi.shutdown_server(server)


def test_uint8_request_round_trip(clean):
    inferencer = make_inferencer()
    backend = LocalBackend(inferencer, workers=1)
    service = ServingService(backend)
    try:
        arr = (np.random.default_rng(4).random((8, 32, 32)) * 255).astype(
            np.uint8)
        status, payload = service.handle("POST", "/infer", infer_body(arr))
        assert status == 200
        assert np.array_equal(decode_response(payload),
                              _ref(inferencer, arr))
    finally:
        backend.close()


# the same bodies through both packages: dtypes, a channel axis, an
# offset, a ragged shape and the packer's fallbacks
PARITY_REQUESTS = {
    "float32": ((6, 20, 28), "float32", {}),
    "uint8": ((8, 32, 32), "uint8", {}),
    "uint16": ((5, 17, 30), "uint16", {}),
    "offset": ((4, 16, 16), "uint8", {"voxel_offset": [3, -5, 7]}),
    "channels": ((1, 9, 33, 35), "float32", {}),
    "zeros": ((4, 16, 16), "zeros", {}),
}


@pytest.mark.parametrize("output_dtype", ["float32", "uint8", "bfloat16"])
def test_responses_match_jax_bitwise(clean, output_dtype):
    kwargs = dict(output_dtype=output_dtype)
    port_backend = LocalBackend(make_inferencer(**kwargs), workers=1)
    jax_backend = JaxLocalBackend(make_jax_inferencer(**kwargs), workers=1)
    port = ServingService(port_backend)
    jax_ = JaxServingService(jax_backend)
    rng = np.random.default_rng(7)
    try:
        for name, (shape, dtype, extra) in PARITY_REQUESTS.items():
            if dtype == "zeros":
                arr = np.zeros(shape, np.uint8)
            elif dtype == "float32":
                arr = rng.random(shape).astype(np.float32)
            else:
                arr = rng.integers(0, np.iinfo(dtype).max, shape).astype(
                    dtype)
            body = infer_body(arr, **extra)
            (s1, p1), (s2, p2) = (port.handle("POST", "/infer", body),
                                  jax_.handle("POST", "/infer", body))
            assert s1 == s2 == 200, (name, p1, p2)
            assert p1["dtype"] == p2["dtype"] and p1["shape"] == p2["shape"]
            assert p1["voxel_offset"] == p2["voxel_offset"]
            assert np.array_equal(decode_response(p1), decode_response(p2)), \
                name
        for body in (b"not json", json.dumps({"shape": [4, 16, 16]}).encode()):
            s1, p1 = port.handle("POST", "/infer", body)
            s2, p2 = jax_.handle("POST", "/infer", body)
            assert (s1, p1) == (s2, p2)
    finally:
        port_backend.close()
        jax_backend.close()


# ---------------------------------------------------------------------------
# admission control and backpressure
# ---------------------------------------------------------------------------
def test_admission_rejects_past_max_inflight(clean):
    admission = AdmissionController(max_inflight=0)
    with pytest.raises(AdmissionRejected) as err:
        admission.admit(1024)
    assert err.value.reason == "inflight"
    assert telemetry.snapshot()["counters"]["serving/rejected_admission"] == 1
    admission = AdmissionController(max_inflight=2)
    reserved = admission.admit(1024)
    assert admission.inflight == 1
    admission.release(reserved)
    admission.drain()
    with pytest.raises(AdmissionRejected) as err:
        admission.admit(1024)
    assert err.value.reason == "draining"


def test_admission_reject_is_clean_429_not_worker_death(clean):
    inferencer = make_inferencer()
    backend = LocalBackend(inferencer, workers=1)
    service = ServingService(backend,
                             admission=AdmissionController(max_inflight=0))
    try:
        arr = np.zeros((4, 16, 16), dtype=np.float32)
        status, payload = service.handle("POST", "/infer", infer_body(arr))
        assert status == 429 and payload["reason"] == "inflight"
        service.admission.max_inflight = 4
        arr = np.random.default_rng(1).random((8, 32, 32)).astype(np.float32)
        status, _ = service.handle("POST", "/infer", infer_body(arr))
        assert status == 200
    finally:
        backend.close()


def test_burst_past_max_inflight_gets_429s(clean):
    """Concurrent requests over HTTP past --max-inflight: the overflow is
    answered 429 ``inflight`` while the admitted ones complete."""
    gate = threading.Event()
    inferencer = make_inferencer()
    backend = LocalBackend(inferencer, workers=2)
    submit = backend.submit

    def held(record):
        gate.wait(30)
        submit(record)

    backend.submit = held
    service = ServingService(backend,
                             admission=AdmissionController(max_inflight=2))
    server = start_serving(service, host="127.0.0.1", port=0)
    port = restapi.bound_port(server)
    arr = np.random.default_rng(2).random((4, 16, 16)).astype(np.float32)
    results = []

    def client():
        try:
            results.append(_http_infer(port, infer_body(arr)))
        except urllib.error.HTTPError as exc:
            results.append((exc.code, json.loads(exc.read())))

    threads = [threading.Thread(target=client) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 30
        while len(results) < 4 and time.time() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(60)
    finally:
        gate.set()
        backend.close()
        restapi.shutdown_server(server)
    codes = sorted(status for status, _ in results)
    assert codes == [200, 200, 429, 429, 429, 429]
    assert all(p["reason"] == "inflight" for s, p in results if s == 429)
    assert telemetry.snapshot()["counters"]["serving/rejected_admission"] == 4


def test_memory_watermark_backpressure(clean):
    from chunkflow_tpu_torch.flow.scheduler import (
        DepthController,
        release_host_bytes,
        reserve_host_bytes,
    )

    clean.setenv("CHUNKFLOW_SCHED_MEM_GB", "0.000001")  # ~1 KB
    admission = AdmissionController(max_inflight=8)
    with pytest.raises(AdmissionRejected) as err:
        admission.admit(1 << 20)
    assert err.value.reason == "memory"
    assert telemetry.snapshot()["counters"]["serving/rejected_memory"] == 1
    clean.setenv("CHUNKFLOW_SCHED_MEM_GB", "4")
    ctl = DepthController(watermark_bytes=1 << 20)
    ctl.note_slot_bytes(1 << 10)
    assert ctl._would_fit()
    assert reserve_host_bytes(1 << 20)
    try:
        assert not ctl._would_fit()
    finally:
        release_host_bytes(1 << 20)
    assert ctl._would_fit()


def test_malformed_requests_get_400(clean):
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend)
    try:
        for body in (
                None, b"not json", b"[1, 2]",
                json.dumps({"shape": [4, 16, 16]}).encode(),
                json.dumps({"shape": [0, 16, 16], "dtype": "uint8",
                            "data_b64": ""}).encode(),
                json.dumps({"shape": [4, 16, 16], "dtype": "float64",
                            "data_b64": ""}).encode(),
                json.dumps({"shape": [4, 16, 16], "dtype": "uint8",
                            "data_b64": "AAAA"}).encode(),
                json.dumps({"shape": [1, 1, 1], "dtype": "uint8",
                            "data_b64": "!!"}).encode(),
                infer_body(np.zeros((4, 16, 16), np.uint8),
                           voxel_offset=[1, 2]),
                infer_body(np.zeros((4, 16, 16), np.uint8),
                           deadline_s="soon")):
            status, payload = service.handle("POST", "/infer", body)
            assert status == 400, body
            assert "error" in payload
    finally:
        backend.close()


def test_body_bound_is_400(clean):
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend, max_body_mb=0.001)
    try:
        status, payload = service.handle(
            "POST", "/infer", infer_body(np.zeros((8, 32, 32), np.float32)))
        assert status == 400 and "max body" in payload["error"]
    finally:
        backend.close()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
class _StallBackend:
    """Completes nothing: the deadline clock is the only way out."""

    def submit(self, record):
        pass

    def wait(self, record, timeout):
        return record.wait(timeout)

    def close(self):
        pass


def test_deadline_miss_is_clean_504(clean):
    service = ServingService(_StallBackend(), default_deadline_s=0.2)
    t0 = time.time()
    status, _ = service.handle("POST", "/infer", infer_body(
        np.zeros((4, 16, 16), np.float32), deadline_s=0.2))
    assert status == 504 and time.time() - t0 < 5.0
    counters = telemetry.snapshot()["counters"]
    assert counters["serving/deadline_missed"] == 1
    assert counters.get("serving/errors", 0) == 0
    assert telemetry.snapshot()["qhists"]["serving/latency"]["count"] == 1


def test_tiny_deadline_through_the_packer_is_504(clean):
    """A request whose deadline (0.001 s) passes before compute: 504,
    counted once, and the server keeps serving."""
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend)
    arr = np.random.default_rng(3).random((8, 32, 32)).astype(np.float32)
    try:
        status, payload = service.handle(
            "POST", "/infer", infer_body(arr, deadline_s=0.001))
        assert status == 504 and "error" in payload
        status, _ = service.handle("POST", "/infer", infer_body(arr))
        assert status == 200
    finally:
        backend.close()
    counters = telemetry.snapshot()["counters"]
    assert counters["serving/deadline_missed"] == 1
    assert counters["serving/completed"] == 1


def test_serving_request_outcome_is_first_wins_and_counted_once(clean):
    record = ServingRequest(None, deadline=time.time() + 10)
    assert record.fail(RequestExpired("late"))
    assert not record.fail(RequestExpired("later"))
    assert not record.complete("result")
    assert record.done and not record.expired
    counters = telemetry.snapshot()["counters"]
    assert counters["serving/deadline_missed"] == 1
    assert counters.get("serving/completed", 0) == 0
    other = ServingRequest(None, deadline=time.time() + 10)
    assert other.complete("result") and not other.fail(RuntimeError("x"))
    assert other.wait(0) == "result"
    assert telemetry.snapshot()["counters"]["serving/completed"] == 1


# ---------------------------------------------------------------------------
# lifecycle containment
# ---------------------------------------------------------------------------
def test_transient_compute_failure_retries_via_lifecycle(clean):
    chaos.configure("once=serving/compute")
    inferencer = make_inferencer()
    backend = LocalBackend(inferencer, workers=1, max_retries=3,
                           backoff_base=0.01, backoff_cap=0.05)
    service = ServingService(backend, default_deadline_s=30.0)
    try:
        arr = np.random.default_rng(8).random((8, 32, 32)).astype(np.float32)
        status, payload = service.handle("POST", "/infer", infer_body(arr))
        assert status == 200
        assert np.array_equal(decode_response(payload), _ref(inferencer, arr))
        counters = telemetry.snapshot()["counters"]
        assert counters.get("chaos/injected", 0) == 1
        assert counters.get("tasks/retried", 0) == 1
        assert counters.get("serving/completed") == 1
        assert counters.get("tasks/committed") == 1
        assert len(backend.ledger) == 1
    finally:
        backend.close()


def test_poison_request_dead_letters_and_fails_cleanly(clean):
    chaos.configure("seed=1:rate=1.0:points=serving/compute")
    backend = LocalBackend(make_inferencer(), workers=1, max_retries=1,
                           backoff_base=0.01, backoff_cap=0.02)
    service = ServingService(backend, default_deadline_s=15.0)
    try:
        arr = np.random.default_rng(0).random((4, 16, 16)).astype(np.float32)
        status, _ = service.handle("POST", "/infer", infer_body(arr))
        assert status in (500, 504)
        assert backend.queue.dead_letters()
        chaos.reset()
        status, _ = service.handle("POST", "/infer", infer_body(arr))
        assert status == 200
    finally:
        backend.close()


def test_close_fails_queued_requests_cleanly(clean):
    backend = LocalBackend(make_inferencer(), workers=1)
    record = ServingRequest(Chunk(np.zeros((4, 16, 16), np.float32)),
                            deadline=time.time() + 30)
    with backend._table_lock:
        backend._table[record.req_id] = record
    backend.close()
    with pytest.raises(AdmissionRejected):
        record.wait(0)


# ---------------------------------------------------------------------------
# listeners and the CLI
# ---------------------------------------------------------------------------
def test_metrics_exporter_port0_reports_bound_port(clean):
    server = restapi.start_metrics_exporter(0, host="127.0.0.1")
    try:
        port = restapi.bound_port(server)
        assert port and port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        restapi.shutdown_server(server)
    assert restapi.bound_port(None) is None


def _wait_endpoint(metrics_dir, worker, key, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        record = restapi.read_endpoint_file(str(metrics_dir), worker)
        if record and record.get(key):
            return record[key]
        time.sleep(0.1)
    raise AssertionError(f"{worker} never published {key}")


SERVE_ARGS = ["serve", "--port", "0", "--host", "127.0.0.1", "-p", "4", "16",
              "16", "--output-patch-overlap", "2", "8", "8",
              "--framework", "identity", "-c", "3", "--batch-size", "2",
              "--serve-workers", "1", "--no-crop-output-margin"]


def test_cli_serve_end_to_end(clean, tmp_path, capsys):
    """The port's ``serve`` command: the bound port published in the
    endpoint file, a live POST /infer answered bitwise, a drain at
    --max-runtime with its summary line, and the run counters."""
    from chunkflow_tpu_torch.flow import cli

    clean.setenv("CHUNKFLOW_WORKER_ID", "serve-cli-test")
    metrics_dir = tmp_path / "metrics"
    result = {}

    def run():
        result["rc"] = cli.main(["--device", "cpu", "-v", "--metrics-dir",
                                 str(metrics_dir), "--metrics-port", "0"]
                                + SERVE_ARGS + ["--max-runtime", "8"])

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    port = _wait_endpoint(metrics_dir, "serve-cli-test", "serving_port")
    metrics_port = _wait_endpoint(metrics_dir, "serve-cli-test",
                                  "metrics_port")
    arr = np.random.default_rng(0).random((8, 32, 32)).astype(np.float32)
    status, payload = _http_infer(port, infer_body(arr, deadline_s=10.0))
    assert status == 200 and payload["shape"] == [3, 8, 32, 32]
    ref = _ref(make_inferencer(batch_size=2), arr)
    assert np.array_equal(decode_response(payload), ref)
    with urllib.request.urlopen(
            f"http://127.0.0.1:{metrics_port}/metrics", timeout=10) as resp:
        assert "chunkflow_serving_latency_bucket" in resp.read().decode()
    thread.join(timeout=60)
    assert not thread.is_alive(), "serve did not exit at --max-runtime"
    out = capsys.readouterr().out
    assert result["rc"] == 0
    assert "serving: http://127.0.0.1:" in out
    assert "metrics exporter: http://" in out
    assert "serve drained: 1 request(s), 1 completed" in out
    counters = json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("run counters: "))[14:])
    assert counters["serving/completed"] == 1
    for key in ("kernels/gather", "kernels/accumulate", "kernels/conv3d_int8",
                "kernels/conv3d_int8/hopper", "kernels/conv3d_int8/generic"):
        assert key in counters
    assert "telemetry summary:" in out
    events = [json.loads(line) for name in os.listdir(metrics_dir)
              if name.endswith(".jsonl")
              for line in open(metrics_dir / name)]
    assert any(e["kind"] == "snapshot" for e in events)
    # the listeners are gone with the run
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/serving", timeout=2)


def test_cli_serve_answers_as_the_jax_cli(clean, tmp_path):
    """Both CLIs' ``serve`` with the same options answer one request with
    the same bytes."""
    from click.testing import CliRunner

    from chunkflow_tpu.flow.cli import main as jax_main
    from chunkflow_tpu_torch.flow import cli

    clean.setenv("CHUNKFLOW_WORKER_ID", "serve-both")
    runs = {}

    def run_port():
        runs["port"] = cli.main(["--device", "cpu", "--metrics-dir",
                                 str(tmp_path / "port")] + SERVE_ARGS
                                + ["--max-runtime", "10"])

    def run_jax():
        runs["jax"] = CliRunner().invoke(
            jax_main, ["--metrics-dir", str(tmp_path / "jax")] + SERVE_ARGS
            + ["--max-runtime", "10"], catch_exceptions=False)

    threads = [threading.Thread(target=fn, daemon=True)
               for fn in (run_port, run_jax)]
    for t in threads:
        t.start()
    ports = [_wait_endpoint(tmp_path / name, "serve-both", "serving_port")
             for name in ("port", "jax")]
    arr = (np.random.default_rng(5).random((6, 20, 28)) * 255).astype(
        np.uint8)
    body = infer_body(arr, deadline_s=20.0, voxel_offset=[1, 2, 3])
    answers = [_http_infer(port, body) for port in ports]
    for t in threads:
        t.join(60)
    assert runs["port"] == 0 and runs["jax"].exit_code == 0
    (s1, p1), (s2, p2) = answers
    assert s1 == s2 == 200
    assert p1["voxel_offset"] == p2["voxel_offset"] == [1, 2, 3]
    assert np.array_equal(decode_response(p1), decode_response(p2))
    assert "serve drained: 1 request(s), 1 completed" in \
        runs["jax"].output


def test_cli_serve_needs_a_patch_size_and_stays_registered(clean):
    from chunkflow_tpu_torch.flow import cli

    with pytest.raises(SystemExit, match="input-patch-size"):
        cli.main(["--device", "cpu", "serve", "--max-runtime", "0"])
    assert "serve" not in [c for cs in cli.NOT_PORTED.values() for c in cs]
    assert "serving packer" not in cli.NOT_PORTED
    assert "fleet supervisor" not in cli.NOT_PORTED
    for command in ("fleet-run", "fleet-status", "log-summary"):
        # ported: without their required options they are usage errors
        with pytest.raises(SystemExit):
            cli.main(["--device", "cpu", command])


def test_cli_kill_switch_opens_no_socket(clean, tmp_path, capsys):
    from chunkflow_tpu_torch.flow import cli

    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    clean.setenv("CHUNKFLOW_METRICS_PORT", "0")
    before = {t.name for t in threading.enumerate()}
    cli.main(["--device", "cpu", "--metrics-dir", str(tmp_path / "m"),
              "--slo-config", str(tmp_path / "none.toml"), "create-chunk",
              "--size", "4", "16", "16"])
    out = capsys.readouterr().out
    assert "metrics exporter" not in out
    assert not (tmp_path / "m").exists()
    assert {t.name for t in threading.enumerate()} <= before


def test_cli_metrics_port_from_env_serves_for_the_run(clean, tmp_path,
                                                      capsys):
    from chunkflow_tpu_torch.flow import cli

    clean.setenv("CHUNKFLOW_METRICS_PORT", "0")
    cli.main(["--device", "cpu", "--metrics-dir", str(tmp_path),
              "create-chunk", "--size", "4", "16", "16"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("metrics exporter: "))
    port = int(line.rsplit(":", 1)[1].split("/")[0])
    record = restapi.read_endpoint_file(str(tmp_path), telemetry.worker_id())
    assert record["metrics_port"] == port
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


# ---------------------------------------------------------------------------
# volume-reference requests
# ---------------------------------------------------------------------------
def _volume(tmp_path, **kwargs):
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    path = str(tmp_path / "vol")
    vol = PrecomputedVolume.create(path, volume_size=(16, 48, 48),
                                   voxel_size=(40, 4, 4),
                                   voxel_offset=(0, 0, 0), dtype="uint8",
                                   block_size=(8, 16, 16), **kwargs)
    return path, vol


def test_volume_reference_request_rides_block_cache(clean, tmp_path):
    from chunkflow_tpu_torch.volume.storage import reset_shared_cache

    reset_shared_cache()
    path, vol = _volume(tmp_path)
    source = (np.random.default_rng(9).random((16, 48, 48)) * 255).astype(
        np.uint8)
    vol.save(Chunk(source, voxel_size=(40, 4, 4)))
    reset_shared_cache()
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend)
    try:
        body = json.dumps({"volume_path": path, "bbox_start": [0, 0, 0],
                           "bbox_size": [8, 32, 48],
                           "deadline_s": 30.0}).encode()
        status, payload = service.handle("POST", "/infer", body)
        assert status == 200, payload
        ref_status, ref_payload = service.handle(
            "POST", "/infer", infer_body(source[:8, :32, :48]))
        assert ref_status == 200
        assert np.array_equal(decode_response(payload),
                              decode_response(ref_payload))
        misses = telemetry.snapshot()["counters"].get("storage/misses", 0)
        assert misses > 0
        status, _ = service.handle("POST", "/infer", body)
        assert status == 200
        counters = telemetry.snapshot()["counters"]
        assert counters.get("storage/hits", 0) > 0
        assert counters.get("storage/misses", 0) == misses
        assert len(service._volumes) == 1
    finally:
        backend.close()
        reset_shared_cache()


def test_volume_reference_request_validation(clean, tmp_path):
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend, max_body_mb=1.0)
    try:
        def post(payload):
            return service.handle("POST", "/infer",
                                  json.dumps(payload).encode())

        status, payload = post({"volume_path": str(tmp_path / "nope"),
                                "bbox_start": [0, 0, 0],
                                "bbox_size": [8, 16, 16]})
        assert status == 400 and "cannot open volume" in payload["error"]
        status, payload = post({"volume_path": "x", "bbox_start": [0, 0],
                                "bbox_size": [8, 16, 16]})
        assert status == 400 and "bbox_start" in payload["error"]
        status, payload = post({"volume_path": "x", "bbox_start": [0, 0, 0],
                                "bbox_size": [8, 16, 0]})
        assert status == 400 and "bbox_size" in payload["error"]
        status, payload = post({"volume_path": "x", "bbox_start": [0, 0, 0],
                                "bbox_size": [8, 16, 16],
                                "data_b64": "AAAA"})
        assert status == 400 and "mutually exclusive" in payload["error"]
        status, payload = post({"volume_path": "x", "bbox_start": [0, 0, 0],
                                "bbox_size": [8, 16, 16], "mip": -1})
        assert status == 400 and "mip" in payload["error"]
        status, payload = post({"volume_path": "", "bbox_start": [0, 0, 0],
                                "bbox_size": [8, 16, 16]})
        assert status == 400 and "volume_path" in payload["error"]
    finally:
        backend.close()


def test_volume_reference_over_bound_bbox_rejected(clean, tmp_path):
    path, _ = _volume(tmp_path)
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend, max_body_mb=0.00001)
    try:
        status, payload = service.handle("POST", "/infer", json.dumps({
            "volume_path": path, "bbox_start": [0, 0, 0],
            "bbox_size": [8, 32, 48]}).encode())
        assert status == 400 and "over the" in payload["error"]
    finally:
        backend.close()


def test_volume_reference_other_encoding_is_refused(clean, tmp_path):
    """A volume whose info says jpeg over raw blocks: the blocks do not
    decode, and the request is a 400 naming the corrupt block (every
    encoding is served: tests/test_torch_encodings.py)."""
    path, vol = _volume(tmp_path)
    vol.save(Chunk(np.full((16, 48, 48), 7, np.uint8)))
    info_path = os.path.join(path, "info")
    info = json.load(open(info_path))
    info["scales"][0]["encoding"] = "jpeg"
    json.dump(info, open(info_path, "w"))
    from chunkflow_tpu_torch.volume.storage import reset_shared_cache

    reset_shared_cache()
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend)
    try:
        status, payload = service.handle("POST", "/infer", json.dumps({
            "volume_path": path, "bbox_start": [0, 0, 0],
            "bbox_size": [8, 16, 16]}).encode())
        assert status == 400
        assert "corrupt block" in payload["error"]
    finally:
        backend.close()


# ---------------------------------------------------------------------------
# spool mode: external port workers, a kill between output and ledger
# ---------------------------------------------------------------------------
def _spawn_worker(spool, log_path, chaos_plan=None):
    """One external worker: the supervised fetch / load / compute / save /
    ack chain over the spool queue."""
    cmd = [sys.executable, "-m", "chunkflow_tpu_torch", "--device", "cpu",
           "fetch-task-from-queue", "-q", os.path.join(spool, "queue"),
           "-v", "3", "-r", "120", "--poll-interval", "0.25",
           "--max-retries", "20", "--lease-renew", "1.0",
           "--backoff-base", "0.01", "--backoff-cap", "0.1",
           "--ledger", os.path.join(spool, "ledger"),
           "load-h5", "-f", os.path.join(spool, "in") + os.sep,
           "inference", "-s", "4", "8", "8", "-v", "1", "2", "2", "-c", "1",
           "-f", "identity", "--no-crop-output-margin",
           "save-h5", "--file-name", os.path.join(spool, "out") + os.sep,
           "delete-task-in-queue"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("CHUNKFLOW_CHAOS", None)
    if chaos_plan:
        env["CHUNKFLOW_CHAOS"] = chaos_plan
    with open(log_path, "ab") as log:
        return subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _spool_request(rng):
    arr = rng.random((8, 16, 16)).astype(np.float32)
    reference = Inferencer(input_patch_size=(4, 8, 8),
                           output_patch_overlap=(1, 2, 2),
                           num_output_channels=1, framework="identity",
                           crop_output_margin=False, batch_size=1,
                           device="cpu")
    body = json.dumps({"shape": list(arr.shape), "dtype": "float32",
                       "data_b64": base64.b64encode(arr.tobytes()).decode(),
                       "deadline_s": 110.0}).encode()
    return body, _ref(reference, arr)


def _kill(*procs):
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_spool_mode_with_an_external_worker(clean, tmp_path):
    pytest.importorskip("h5py")
    spool = str(tmp_path / "spool")
    backend = SpoolBackend(spool, visibility_timeout=30.0, poll_s=0.05)
    service = ServingService(backend, default_deadline_s=120.0)
    body, ref = _spool_request(np.random.default_rng(5))
    worker = _spawn_worker(spool, str(tmp_path / "worker.log"))
    try:
        status, payload = service.handle("POST", "/infer", body)
        assert status == 200, (payload, open(tmp_path / "worker.log").read())
        assert np.array_equal(decode_response(payload), ref)
        # an in-flight duplicate bbox is refused up front
        record = ServingRequest(Chunk(np.zeros((8, 16, 16), np.float32)),
                                deadline=time.time() + 5)
        backend._inflight[record.chunk.bbox.string] = record
        status, payload = service.handle("POST", "/infer", body)
        assert status == 429 and payload["reason"] == "duplicate"
    finally:
        _kill(worker)
        backend.close()
    assert not os.listdir(os.path.join(spool, "in"))


def test_worker_killed_mid_request_completes_exactly_once(clean, tmp_path):
    """Worker A claims the request, writes its output and is SIGKILLed by
    the chaos plan before the ledger marks it; the lease expires, worker
    B computes the redelivery and commits; the front end answers 200
    bitwise with one ledger marker, one output file and a clean queue."""
    pytest.importorskip("h5py")
    spool = str(tmp_path / "spool")
    backend = SpoolBackend(spool, visibility_timeout=3.0, poll_s=0.05)
    service = ServingService(
        backend, admission=AdmissionController(max_inflight=4),
        default_deadline_s=120.0)
    body, ref = _spool_request(np.random.default_rng(6))
    response = {}

    def post():
        response["status"], response["payload"] = service.handle(
            "POST", "/infer", body)

    worker_a = _spawn_worker(spool, str(tmp_path / "worker-a.log"),
                             "once=lifecycle/pre_ledger:action=kill")
    worker_b = None
    client = threading.Thread(target=post, daemon=True)
    try:
        client.start()
        assert worker_a.wait(timeout=90) == -signal.SIGKILL, \
            open(tmp_path / "worker-a.log").read()
        assert os.listdir(os.path.join(spool, "out"))  # written...
        assert not [n for n in os.listdir(os.path.join(spool, "ledger"))
                    if n.endswith(".done")]  # ...but not marked
        assert client.is_alive()  # the front end still waits
        worker_b = _spawn_worker(spool, str(tmp_path / "worker-b.log"))
        client.join(timeout=120)
        assert not client.is_alive(), "request never completed"
        assert response["status"] == 200, response
        assert np.array_equal(decode_response(response["payload"]), ref)
        marks = [n for n in os.listdir(os.path.join(spool, "ledger"))
                 if n.endswith(".done")]
        assert len(marks) == 1, marks
        outs = [n for n in os.listdir(os.path.join(spool, "out"))
                if n.endswith(".h5")]
        assert len(outs) == 1, outs
        for _ in range(100):
            stats = backend.queue.stats()
            if not stats.get("pending") and not stats.get("inflight"):
                break
            time.sleep(0.1)
        assert not stats.get("pending") and not stats.get("inflight"), stats
        assert not backend.queue.dead_letters()
    finally:
        _kill(worker_a, worker_b)
        backend.close()


# ---------------------------------------------------------------------------
# SLO acceptance, ticked with an explicit clock
# ---------------------------------------------------------------------------
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


def _slo_service(clean, tmp_path, max_retries=0):
    clean.setenv("CHUNKFLOW_TS_INTERVAL", "3600")  # ticks by hand
    config = tmp_path / "slo.toml"
    config.write_text(SLO_TOML)
    metrics_dir = tmp_path / "metrics"
    telemetry.configure(str(metrics_dir))
    evaluator = slo.start_slo(str(config), pyproject="/nonexistent")
    assert evaluator is not None
    backend = LocalBackend(make_inferencer(), workers=1,
                           max_retries=max_retries, backoff_base=0.01)
    service = ServingService(backend, default_deadline_s=10.0,
                             max_body_mb=16)
    return evaluator, backend, service, metrics_dir


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def step(self, dt=0.04):
        self.t += dt
        return self.t


def test_regression_fires_one_alert_one_capture_cooldown_blocks_second(
        clean, tmp_path):
    clean.setenv("CHUNKFLOW_PROFILE_ON_ANOMALY", "1")
    clean.setenv("CHUNKFLOW_PROFILE_SECONDS", "0.1")
    clean.setenv("CHUNKFLOW_PROFILE_COOLDOWN", "600")
    evaluator, backend, service, metrics_dir = _slo_service(clean, tmp_path)
    clock = _Clock()
    arr = (np.random.default_rng(0).random((4, 16, 16)) * 255).astype(
        np.uint8)
    try:
        chaos.configure("seed=1:rate=1.0:points=serving/compute")
        for _ in range(200):
            if evaluator.firing():
                break
            status, _ = service.handle("POST", "/infer", infer_body(arr))
            assert status in (500, 504)
            evaluator.tick(clock.step())
        assert evaluator.firing() == ["availability:fast"]
        status, payload = service.handle("GET", "/alerts")
        assert status == 200 and payload["firing"] == ["availability:fast"]
        avail = next(o for o in payload["objectives"]
                     if o["name"] == "availability")
        assert avail["burn_rate"] >= 2.0 and avail["budget_remaining"] < 1.0
        assert service.serving_stats()["slo_firing"] == ["availability:fast"]
        profiling.wait_for_captures(30)
        captures = [p.name for p in metrics_dir.iterdir()
                    if p.name.startswith("profile-slo-")]
        assert len(captures) == 1, captures
        assert captures[0].startswith("profile-slo-availability-")
        assert (metrics_dir / captures[0] / profiling.TRACE_FILE).exists()

        chaos.reset()
        for _ in range(200):
            if "deadline:fast" in evaluator.firing():
                break
            status, _ = service.handle(
                "POST", "/infer", infer_body(arr, deadline_s=0.001))
            assert status == 504
            evaluator.tick(clock.step())
        assert "deadline:fast" in evaluator.firing()
        profiling.wait_for_captures(30)
        captures = [p.name for p in metrics_dir.iterdir()
                    if p.name.startswith("profile-slo-")]
        assert len(captures) == 1, captures
        assert telemetry.snapshot()["counters"]["profile/captures"] == 1
    finally:
        chaos.reset()
        backend.close()
    telemetry.flush()
    events = [json.loads(line) for line in open(telemetry.configured_path())]
    fired = [e for e in events if e.get("kind") == "alert"
             and e.get("state") == "firing"]
    by_alert = {}
    for e in fired:
        by_alert.setdefault(e["alert"], []).append(e)
    assert sorted(by_alert) == ["availability:fast", "deadline:fast"]
    assert all(len(v) == 1 for v in by_alert.values())
    first = by_alert["availability:fast"][0]
    assert first["severity"] == "page" and first["target"] == 0.9
    assert first["burn_short"] >= 2.0 and first["burn_long"] >= 2.0
    assert first["budget_remaining"] < 1.0


def test_healthy_run_of_same_workload_fires_nothing(clean, tmp_path):
    evaluator, backend, service, _ = _slo_service(clean, tmp_path,
                                                  max_retries=2)
    clock = _Clock()
    arr = (np.random.default_rng(0).random((4, 16, 16)) * 255).astype(
        np.uint8)
    try:
        for _ in range(8):
            status, _ = service.handle("POST", "/infer", infer_body(arr))
            assert status == 200
            evaluator.tick(clock.step())
        for _ in range(20):  # ticks past both windows
            evaluator.tick(clock.step(0.1))
        assert evaluator.firing() == []
        status, payload = service.handle("GET", "/alerts")
        assert status == 200 and payload["firing"] == []
    finally:
        backend.close()
    telemetry.flush()
    events = [json.loads(line) for line in open(telemetry.configured_path())]
    assert not [e for e in events if e.get("kind") == "alert"]
    assert [e for e in events if e.get("kind") == "timeseries"]


def test_kill_switch_no_sampler_no_events_no_alerts_route(clean, tmp_path):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    clean.setenv("CHUNKFLOW_TS_INTERVAL", "0.05")
    config = tmp_path / "slo.toml"
    config.write_text(SLO_TOML)
    metrics_dir = tmp_path / "off"
    assert telemetry.configure(str(metrics_dir)) is None
    assert telemetry.start_timeseries() is None
    assert slo.start_slo(str(config), pyproject="/nonexistent") is None
    assert not any(t.name == "chunkflow-timeseries"
                   for t in threading.enumerate())
    backend = LocalBackend(make_inferencer(), workers=1)
    service = ServingService(backend, max_body_mb=16)
    try:
        assert service.handle("GET", "/alerts")[0] == 404
        assert service.handle("POST", "/profile?seconds=0.1")[0] == 404
        arr = (np.random.default_rng(0).random((4, 16, 16)) * 255).astype(
            np.uint8)
        status, _ = service.handle("POST", "/infer", infer_body(arr))
        assert status == 200
    finally:
        backend.close()
    assert not metrics_dir.exists()
    assert telemetry.snapshot()["events"] == []
