"""Coordination HTTP service: global ids, task scheduling, live metrics.

The counterpart of ``chunkflow_tpu/parallel/restapi.py``, on the
standard library's ``http.server``, with the same routes:

- ``GET /objids/<count>``       -> base id of a reserved range (JSON int)
- ``GET /task``                 -> next runnable task bbox string, or 204
- ``POST /task/<bbox>/done``    -> mark a claimed task done
- ``GET /state``                -> full task-tree JSON
- ``GET /metrics``              -> Prometheus text exposition of the live
  telemetry registry (counters, gauges, span summaries, quantile
  histograms, derived stall shares)
- ``GET /healthz``              -> worker identity and in-flight leases
- ``GET /alerts``               -> live SLO state (``core/slo.py``)
- ``POST /profile?seconds=N``   -> one bounded ``torch.profiler`` capture
  (``core/profiling.py``)

A worker runs :func:`start_metrics_exporter` (``--metrics-port`` /
``CHUNKFLOW_METRICS_PORT``) to serve the observability routes; under
``CHUNKFLOW_TELEMETRY=0`` it creates no socket at all. The serving front
end (``serve/frontend.py``) adds ``POST /infer`` to the same handler.
The scrape helpers at the end (:func:`scrape_worker`,
:func:`serving_stats`, :func:`dominant_stall`, :func:`firing_alerts`)
read one worker's exposition for a fleet view.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel.task_tree import (
    GlobalIdAllocator,
    SpatialTaskTree,
)

#: the stall phases whose shares ride /metrics as labeled gauges: the
#: depth controller's phases (``flow/scheduler.DepthController.PHASES``,
#: repeated here to keep this module import-light)
_STALL_PHASES = (
    "scheduler/load", "pipeline/stage", "pipeline/dispatch",
    "pipeline/compute", "pipeline/drain", "scheduler/post",
    "scheduler/write",
)


# ---------------------------------------------------------------------------
# Prometheus text exposition (zero-dependency rendering + parsing)
# ---------------------------------------------------------------------------
def prometheus_name(name: str) -> str:
    """Registry metric name -> Prometheus metric name: ``chunkflow_``
    prefix, every character outside ``[a-zA-Z0-9_:]`` becomes ``_``
    (``pipeline/ring_occupancy`` -> ``chunkflow_pipeline_ring_occupancy``)."""
    return "chunkflow_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def render_prometheus(snap: Optional[dict] = None,
                      worker: Optional[str] = None) -> str:
    """The telemetry registry snapshot as Prometheus text exposition
    (format 0.0.4). Counters render as ``<name>_total`` counters, gauges
    as gauges, histograms as ``summary`` count/sum pairs, plus derived
    per-phase stall-share gauges and the dominant share — the exact
    signal the future autoscaling supervisor polls. Every sample carries
    a ``worker`` label so a fleet scrape stays attributable; per-chip
    metrics (``<plane>/chip/<i>/<metric>``, telemetry.CHIP_METRIC_RE)
    fold the chip index out of the name into a ``chip`` label, so one
    PromQL selector sweeps a mesh (``chunkflow_device_chip_bytes_in_use``
    by ``chip``) instead of N name-mangled series."""
    if snap is None:
        snap = telemetry.snapshot()
    if worker is None:
        worker = telemetry.worker_id()
    label = f'{{worker="{_escape_label(worker)}"}}'

    def _folded(names):
        """Ordered ``{prom_metric: [(label_str, registry_name)]}`` with
        chip-indexed names folded onto one metric — grouping keeps every
        sample of a metric contiguous under its single TYPE line, which
        strict exposition parsers require."""
        groups: Dict[str, list] = {}
        for name in sorted(names):
            m = telemetry.CHIP_METRIC_RE.match(name)
            if m:
                prom = prometheus_name(
                    f"{m.group('plane')}/chip/{m.group('metric')}")
                sample_label = (f'{{worker="{_escape_label(worker)}",'
                                f'chip="{m.group("chip")}"}}')
            else:
                prom = prometheus_name(name)
                sample_label = label
            groups.setdefault(prom, []).append((sample_label, name))
        return groups

    lines = []
    for metric, samples in _folded(snap.get("counters", {})).items():
        lines.append(f"# TYPE {metric}_total counter")
        for sample_label, name in samples:
            lines.append(
                f"{metric}_total{sample_label} {snap['counters'][name]:g}")
    for metric, samples in _folded(snap.get("gauges", {})).items():
        lines.append(f"# TYPE {metric} gauge")
        for sample_label, name in samples:
            lines.append(f"{metric}{sample_label} {snap['gauges'][name]:g}")
    for metric, samples in _folded(snap.get("hists", {})).items():
        lines.append(f"# TYPE {metric} summary")
        for sample_label, name in samples:
            h = snap["hists"][name]
            lines.append(f"{metric}_count{sample_label} {h['count']:g}")
            lines.append(f"{metric}_sum{sample_label} {h['total']:g}")
    # quantile histograms (serving latency etc.) render as real
    # Prometheus histograms: cumulative le-labeled buckets, so any
    # scraper (or fleet-status via serving_stats) can compute p50/p99
    for name in sorted(snap.get("qhists", {})):
        h = snap["qhists"][name]
        metric = prometheus_name(name)
        lines.append(f"# TYPE {metric} histogram")
        cumulative = 0
        worker_esc = _escape_label(worker)
        for bound, count in zip(telemetry.QUANTILE_BOUNDS, h["buckets"]):
            cumulative += count
            lines.append(
                f'{metric}_bucket{{worker="{worker_esc}",le="{bound:g}"}} '
                f"{cumulative:g}"
            )
        overflow = (h["buckets"][len(telemetry.QUANTILE_BOUNDS)]
                    if len(h["buckets"]) > len(telemetry.QUANTILE_BOUNDS)
                    else 0)
        lines.append(
            f'{metric}_bucket{{worker="{worker_esc}",le="+Inf"}} '
            f"{cumulative + overflow:g}"
        )
        lines.append(f"{metric}_count{label} {h['count']:g}")
        lines.append(f"{metric}_sum{label} {h['total']:g}")
    # derived: per-phase stall shares + the dominant share, so the
    # scraper reads "what is this worker waiting on" without re-deriving
    hists = snap.get("hists", {})
    totals = {p: hists[p]["total"] for p in _STALL_PHASES if p in hists}
    window = sum(totals.values())
    if window > 0:
        lines.append("# TYPE chunkflow_stall_share gauge")
        for phase in _STALL_PHASES:
            if phase in totals:
                lines.append(
                    f'chunkflow_stall_share{{worker="'
                    f'{_escape_label(worker)}",phase="'
                    f'{_escape_label(phase)}"}} {totals[phase] / window:.6f}'
                )
        dominant = max(totals, key=totals.get)
        lines.append("# TYPE chunkflow_stall_dominant_share gauge")
        lines.append(
            f'chunkflow_stall_dominant_share{{worker="'
            f'{_escape_label(worker)}",phase="{_escape_label(dominant)}"}} '
            f"{totals[dominant] / window:.6f}"
        )
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(-?[0-9.eE+-]+|NaN)$"
)


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal exposition parser (labels dropped): ``{name: value}``.
    Shared by the fleet-status scraper and the rendering golden test;
    raises ValueError on a malformed sample line."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed Prometheus sample line: {line!r}")
        out[m.group(1)] = float(m.group(3))
    return out


_STARTED = time.time()


def worker_health() -> dict:
    """The /healthz payload: worker identity + live lease state. The
    lease HANDLES ride along (capped) so a fleet supervisor that has to
    SIGKILL this worker can force-nack exactly the claims it was
    holding (``QueueBase.force_release``) instead of waiting out the
    visibility timeout."""
    from chunkflow_tpu_torch.parallel import lifecycle

    leases = lifecycle.inflight()
    handles = [lc.handle for lc in leases[:64]]
    return {
        "status": "ok",
        "worker": telemetry.worker_id(),
        "pid": os.getpid(),
        "inflight_leases": len(leases),
        "inflight_handles": handles,
        # the cap keeps the payload bounded at huge --async-depth; when
        # it bites, the supervisor must know the excess leases will
        # ride out the visibility timeout instead of being force-nacked
        "inflight_handles_truncated": len(leases) > len(handles),
        "uptime_s": time.time() - _STARTED,
        "telemetry_enabled": telemetry.enabled(),
        "metrics_path": telemetry.configured_path(),
        "t": time.time(),
    }


class CoordinationService:
    def __init__(
        self,
        id_start: int = 0,
        task_tree: Optional[SpatialTaskTree] = None,
    ):
        self.ids = GlobalIdAllocator(id_start)
        self.tree = task_tree
        self._claimed: dict = {}

    # ---- request handling (transport-independent) ----------------------
    def handle(self, method: str, path: str, body: Optional[bytes] = None):
        """Returns (status, payload): a dict serves as JSON, a str as
        ``text/plain`` (the Prometheus exposition), None as empty.
        ``body`` carries the raw POST payload (None for GET); the
        serving front end's ``POST /infer`` route consumes it
        (``serve/frontend.py``)."""
        if method == "GET" and path == "/metrics":
            return 200, render_prometheus()
        if method == "GET" and path == "/healthz":
            return 200, worker_health()
        if method == "GET" and path == "/alerts":
            return self._handle_alerts()
        if method == "POST" and path.split("?", 1)[0] == "/profile":
            return self._handle_profile(path)
        m = re.fullmatch(r"/objids/(\d+)", path)
        if method == "GET" and m:
            return 200, {"base_id": self.ids.allocate(int(m.group(1)))}
        if method == "GET" and path == "/task":
            if self.tree is None:
                return 404, {"error": "no task tree configured"}
            node = self.tree.next_ready_task()
            if node is None:
                return 204, None
            self._claimed[node.bbox.string] = node
            return 200, {"bbox": node.bbox.string, "is_leaf": node.is_leaf}
        m = re.fullmatch(r"/task/([-\d_]+)/done", path)
        if method == "POST" and m:
            node = self._claimed.pop(m.group(1), None)
            if node is None:
                return 404, {"error": f"task {m.group(1)} not claimed"}
            node.set_state_done()
            return 200, {"all_done": self.tree.all_done}
        if method == "GET" and path == "/state":
            if self.tree is None:
                return 404, {"error": "no task tree configured"}
            return 200, self.tree.to_dict()
        return 404, {"error": f"unknown endpoint {method} {path}"}

    @staticmethod
    def _handle_alerts():
        """``GET /alerts``: this worker's live SLO state — per-objective
        burn rates, error budget remaining, and the currently-firing
        alert list the fleet supervisor annotates its decisions with. Under
        ``CHUNKFLOW_TELEMETRY=0`` the route does not exist (404, and
        the exporter never opened a socket anyway); a worker running
        without an SLO evaluator answers ``enabled: false`` rather
        than erroring — dashboards must render around it."""
        if not telemetry.enabled():
            return 404, {"error": "telemetry disabled "
                                  "(CHUNKFLOW_TELEMETRY=0)"}
        from chunkflow_tpu_torch.core import slo

        evaluator = slo.current()
        if evaluator is None:
            return 200, {"enabled": False, "worker": telemetry.worker_id(),
                         "firing": [], "objectives": []}
        payload = evaluator.status()
        payload["enabled"] = True
        payload["worker"] = telemetry.worker_id()
        return 200, payload

    @staticmethod
    def _handle_profile(path: str):
        """``POST /profile?seconds=N``: capture one bounded
        ``torch.profiler`` window on this live worker. Blocks the
        request for the window's duration (each request has its own
        server thread) and returns the trace dir, which holds
        ``trace.json`` (Chrome trace format). Operator-requested,
        so the automatic-capture cooldown does not apply; the
        one-session-at-a-time exclusion does (409). Under
        ``CHUNKFLOW_TELEMETRY=0`` the route does not exist (404) — and
        the exporter never even opened a socket."""
        if not telemetry.enabled():
            return 404, {"error": "telemetry disabled "
                                  "(CHUNKFLOW_TELEMETRY=0)"}
        from urllib.parse import parse_qs, urlsplit

        from chunkflow_tpu_torch.core import profiling

        query = parse_qs(urlsplit(path).query)
        try:
            seconds = float(query.get("seconds", ["2.0"])[0])
        except ValueError:
            return 400, {"error": "seconds must be a number"}
        trace_dir, err = profiling.capture(
            seconds, reason="operator", force=True, background=False,
        )
        if trace_dir is None:
            status = 409 if "already active" in (err or "") else 503
            return status, {"error": err}
        return 200, {"trace_dir": trace_dir, "seconds": seconds,
                     "worker": telemetry.worker_id()}


def serve(
    service: CoordinationService,
    host: str = "0.0.0.0",
    port: int = 8000,
    background: bool = False,
):
    """Run the HTTP server; with ``background=True`` returns (server,
    thread) for tests."""

    class Handler(BaseHTTPRequestHandler):
        def _respond(self, body: Optional[bytes] = None):
            status, payload = service.handle(self.command, self.path,
                                             body)
            if isinstance(payload, str):
                # raw text route (/metrics: Prometheus exposition 0.0.4)
                kind, data = "text/plain; version=0.0.4", payload.encode()
            else:
                kind = "application/json"
                data = b"" if payload is None else json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", kind)
            # with a length the client reads the body in large blocks,
            # not in small reads until the connection closes (a /infer
            # answer runs to hundreds of MB)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            if data:
                self.wfile.write(data)

        def do_GET(self):
            self._respond()

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            self._respond(self.rfile.read(length) if length else None)

        def log_message(self, *args):  # quiet
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    if background:
        thread = threading.Thread(target=server.serve_forever, daemon=True,
                                  name=f"http-{server.server_address[1]}")
        # keep the handle ON the server: every caller that only holds
        # the server (start_serving, start_metrics_exporter) can still
        # join the listener thread at shutdown instead of dropping it
        server._serve_thread = thread
        thread.start()
        return server, thread
    server.serve_forever()  # pragma: no cover


def shutdown_server(server, timeout: float = 5.0) -> None:
    """Tear down a background listener from :func:`serve`/
    :func:`start_metrics_exporter`/``start_serving``: stop
    ``serve_forever``, close the listening socket, and JOIN the server
    thread. ``server.shutdown()`` alone leaves the daemon thread handle
    dropped — harmless for one server, a thread leak for every
    start/stop cycle a test suite or an elastic fleet performs. None is
    accepted (the telemetry-disabled exporter returns no server)."""
    if server is None:
        return
    server.shutdown()
    server.server_close()
    thread = getattr(server, "_serve_thread", None)
    if thread is not None and thread.is_alive():
        thread.join(timeout=timeout)


# ---------------------------------------------------------------------------
# per-worker metrics exporter + fleet-status scraping
# ---------------------------------------------------------------------------
def start_metrics_exporter(port: int, host: str = "0.0.0.0"):
    """Serve ``/metrics`` + ``/healthz`` from a daemon thread for the
    lifetime of a worker run (CLI ``--metrics-port`` /
    ``CHUNKFLOW_METRICS_PORT``; port 0 binds an ephemeral port — read it
    back from ``server.server_address``). Returns the live
    ``ThreadingHTTPServer``, or **None without creating any socket**
    when telemetry is disabled — ``CHUNKFLOW_TELEMETRY=0`` means no
    files, no listener, nothing."""
    if not telemetry.enabled():
        return None
    service = CoordinationService()  # no task tree: observability routes only
    server, _thread = serve(service, host=host, port=int(port),
                            background=True)
    return server


def bound_port(server) -> Optional[int]:
    """The port a listener actually bound (differs from the requested
    one when it was 0 — the ephemeral-port path that lets many workers
    share one host without colliding on a fixed ``--metrics-port``)."""
    if server is None:
        return None
    return int(server.server_address[1])


def write_endpoint_file(metrics_dir: str, **ports) -> Optional[str]:
    """Publish this worker's actually-bound listener port(s) as
    ``<metrics_dir>/endpoint-<worker>.json`` (atomic replace; repeated
    calls merge, so the metrics exporter and the serving listener each
    add their port). This is how a supervisor that spawned a worker
    with ``--metrics-port 0`` learns where to probe it. No-op (None) when telemetry is
    off or the dir is unwritable; ports passed as None are skipped."""
    if not telemetry.enabled() or not metrics_dir:
        return None
    worker = telemetry.worker_id()
    safe = "".join(
        ch if ch.isalnum() or ch in "._-" else "_" for ch in worker
    )
    path = os.path.join(metrics_dir, f"endpoint-{safe}.json")
    payload = {"worker": worker, "pid": os.getpid(), "t": time.time()}
    try:
        with open(path) as f:
            previous = json.load(f)
        if isinstance(previous, dict) and previous.get("pid") == os.getpid():
            payload = {**previous, **payload}
    except (OSError, ValueError):
        pass
    for name, port in ports.items():
        if port is not None:
            payload[name] = int(port)
    try:
        os.makedirs(metrics_dir, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def read_endpoint_file(metrics_dir: str, worker: str) -> Optional[dict]:
    """The endpoint record a worker published (None when absent or
    torn) — keyed by the ``CHUNKFLOW_WORKER_ID`` the spawner assigned."""
    safe = "".join(
        ch if ch.isalnum() or ch in "._-" else "_" for ch in worker
    )
    path = os.path.join(metrics_dir, f"endpoint-{safe}.json")
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


def exporter_port_from_env() -> Optional[int]:
    """``CHUNKFLOW_METRICS_PORT`` as an int, or None when unset/empty/
    malformed (the exporter stays off rather than crashing a worker)."""
    raw = os.environ.get("CHUNKFLOW_METRICS_PORT", "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


_DOMINANT_RE = re.compile(
    r'^chunkflow_stall_dominant_share\{[^}]*phase="([^"]*)"[^}]*\}\s+'
    r"(-?[0-9.eE+-]+)$", re.MULTILINE,
)


def dominant_stall(text: str) -> Optional[dict]:
    """``{"phase", "share"}`` from an exposition's labeled
    ``chunkflow_stall_dominant_share`` sample (None when the worker has
    no stall window yet). :func:`parse_prometheus` drops labels, but the
    *phase* is the payload here — it is what tells the fleet supervisor
    whether a deep queue means compute-bound (add workers) or
    storage-bound (adding workers just thrashes the volume store)."""
    m = _DOMINANT_RE.search(text)
    if m is None:
        return None
    return {"phase": m.group(1), "share": float(m.group(2))}


#: the span summaries whose ``_sum`` samples cover device inference
#: time: ``inference/infer`` on the serial path, dispatch/compute/drain
#: on the pipelined paths — disjoint by construction, so the sum is the
#: denominator of the achieved-throughput figure either way
_INFER_TIME_SUMS = (
    "chunkflow_inference_infer_sum", "chunkflow_pipeline_dispatch_sum",
    "chunkflow_pipeline_compute_sum", "chunkflow_pipeline_drain_sum",
)


def achieved_mvox_s(metrics: Dict[str, float]) -> Optional[float]:
    """Achieved inference throughput in Mvox/s from one worker's parsed
    ``/metrics`` sample: output voxels counted at the host sink
    (``inference/voxels``) over the inference-side span seconds. None
    when the worker has no voxel count yet (non-inference pipeline, or
    just started) — fleet-status then simply omits the figure."""
    voxels = metrics.get("chunkflow_inference_voxels_total", 0.0)
    seconds = sum(metrics.get(name, 0.0) for name in _INFER_TIME_SUMS)
    if voxels <= 0 or seconds <= 0:
        return None
    return voxels / seconds / 1e6


_LATENCY_BUCKET_RE = re.compile(
    r'^chunkflow_serving_latency_bucket\{[^}]*le="([^"]*)"[^}]*\}\s+'
    r"(-?[0-9.eE+-]+)$", re.MULTILINE,
)


def serving_stats(text: str) -> Optional[dict]:
    """The SERVING view of one worker's exposition: ``{"inflight",
    "requests", "completed", "rejects", "deadline_missed", "p50_s",
    "p99_s"}`` — None when the worker serves no requests (no serving
    samples at all). The latency quantiles come from the le-labeled
    ``chunkflow_serving_latency`` histogram buckets; the generic
    :func:`parse_prometheus` drops labels, so the buckets are re-parsed
    here and fed through the one shared quantile estimator
    (``telemetry.quantile_from_buckets``)."""
    flat = parse_prometheus(text)
    requests = flat.get("chunkflow_serving_requests_total")
    if requests is None:
        return None
    out = {
        "requests": requests,
        "inflight": flat.get("chunkflow_serving_inflight", 0.0),
        "completed": flat.get("chunkflow_serving_completed_total", 0.0),
        "rejects": (flat.get("chunkflow_serving_rejected_admission_total",
                             0.0)
                    + flat.get("chunkflow_serving_rejected_memory_total",
                               0.0)),
        "deadline_missed": flat.get(
            "chunkflow_serving_deadline_missed_total", 0.0),
        "p50_s": None, "p99_s": None,
    }
    cumulative = {}
    for match in _LATENCY_BUCKET_RE.finditer(text):
        le, value = match.group(1), float(match.group(2))
        cumulative[le] = value
    if cumulative:
        # cumulative le counts -> per-bucket counts in bound order
        buckets, prev = [], 0.0
        for bound in telemetry.QUANTILE_BOUNDS:
            cum = cumulative.get(f"{bound:g}", prev)
            buckets.append(max(0.0, cum - prev))
            prev = cum
        inf_cum = cumulative.get("+Inf", prev)
        buckets.append(max(0.0, inf_cum - prev))
        qhist = {"count": inf_cum, "buckets": buckets}
        out["p50_s"] = telemetry.quantile_from_buckets(qhist, 0.5)
        out["p99_s"] = telemetry.quantile_from_buckets(qhist, 0.99)
    return out


_SLO_FIRING_PREFIX = "chunkflow_slo_"
_SLO_FIRING_SUFFIX = "_firing"


def firing_alerts(metrics: Dict[str, float]) -> List[str]:
    """Objective names whose SLO alert is firing, from one worker's
    parsed ``/metrics`` sample: every ``chunkflow_slo_<objective>_firing``
    gauge at 1. The flat-name form (vs. the richer ``/alerts`` JSON) is
    what the fleet supervisor reads during its normal scrape — no extra
    round trip on the decision tick."""
    return sorted(
        name[len(_SLO_FIRING_PREFIX):-len(_SLO_FIRING_SUFFIX)]
        for name, value in (metrics or {}).items()
        if name.startswith(_SLO_FIRING_PREFIX)
        and name.endswith(_SLO_FIRING_SUFFIX) and value >= 1.0
    )


def scrape_worker(endpoint: str, timeout: float = 1.0) -> dict:
    """Sample one worker's observability endpoints for ``fleet-status``
    and the fleet supervisor: ``{"endpoint", "healthz": dict|None,
    "metrics": {name: value}|None, "dominant_stall": dict|None,
    "slo_firing": [objective, ...], "error": str|None}``. ``endpoint``
    is ``host:port`` or a full URL; unreachable workers report the
    error instead of raising — a fleet dashboard must render around
    dead workers."""
    base = endpoint if "://" in endpoint else f"http://{endpoint}"
    base = base.rstrip("/")
    out = {"endpoint": base, "healthz": None, "metrics": None,
           "dominant_stall": None, "serving": None, "slo_firing": [],
           "error": None}
    try:
        with urllib.request.urlopen(f"{base}/healthz",
                                    timeout=timeout) as resp:
            out["healthz"] = json.loads(resp.read())
        with urllib.request.urlopen(f"{base}/metrics",
                                    timeout=timeout) as resp:
            text = resp.read().decode()
        out["metrics"] = parse_prometheus(text)
        out["dominant_stall"] = dominant_stall(text)
        out["serving"] = serving_stats(text)
        out["slo_firing"] = firing_alerts(out["metrics"])
    except Exception as exc:  # noqa: BLE001 — any failure = unreachable
        out["error"] = f"{type(exc).__name__}: {exc}"
    return out
