"""The port's observability plane against the JAX package, on the CPU.

Telemetry (worker id, quantile histograms, the time-series sampler, tick,
flush and reset hooks, the summary table), the task tree, the
coordination service (``render_prometheus``, ``/metrics``, ``/healthz``,
``/alerts``, ``/profile``, endpoint files, the scrape helpers), the
bounded ``torch.profiler`` capture and the SLO evaluator. Where both
packages compute the same thing, the same inputs go through both:
``quantile_from_buckets`` and the time series on the same samples and
clock, ``render_prometheus`` on one snapshot, ``SpatialTaskTree.to_dict``
on one box, and two evaluators on the same counters and ``now``
sequence, with the same status and firing. SLO tests drive ``tick`` with
an explicit clock; every listener binds ``127.0.0.1`` on port 0 and is
torn down with ``shutdown_server``.
"""
import json
import os
import re
import threading
import urllib.error
import urllib.request

import pytest
import torch

from chunkflow_tpu.core import slo as jslo
from chunkflow_tpu.core import telemetry as jtel
from chunkflow_tpu.core.bbox import BoundingBox as JaxBoundingBox
from chunkflow_tpu.parallel import restapi as jrest
from chunkflow_tpu.parallel.task_tree import SpatialTaskTree as JaxTree
from chunkflow_tpu_torch.core import profiling, slo, telemetry
from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.parallel import restapi
from chunkflow_tpu_torch.parallel.restapi import (
    CoordinationService,
    parse_prometheus,
    render_prometheus,
    scrape_worker,
    serve,
    shutdown_server,
    start_metrics_exporter,
)
from chunkflow_tpu_torch.parallel.task_tree import (
    GlobalIdAllocator,
    SpatialTaskTree,
)

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

_ENV = ("CHUNKFLOW_TELEMETRY", "CHUNKFLOW_SLO", "CHUNKFLOW_TS_INTERVAL",
        "CHUNKFLOW_TS_POINTS", "CHUNKFLOW_WORKER_ID", "CHUNKFLOW_METRICS_PORT",
        "CHUNKFLOW_PROFILE_DIR", "CHUNKFLOW_PROFILE_ON_ANOMALY",
        "CHUNKFLOW_PROFILE_SECONDS", "CHUNKFLOW_PROFILE_COOLDOWN",
        "CHUNKFLOW_PROFILE_STALL_SHARE", "CHUNKFLOW_PROFILE_STALL_TICKS",
        "CHUNKFLOW_PROFILE_TASKS")


@pytest.fixture
def clean(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    # an automatic capture (a page alert's) lasts a tenth of a second
    monkeypatch.setenv("CHUNKFLOW_PROFILE_SECONDS", "0.1")
    telemetry.reset()
    jtel.reset()
    yield monkeypatch
    profiling.wait_for_captures()
    telemetry.reset()
    jtel.reset()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, resp.headers, resp.read()


def _post(port, path, body=b""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def test_worker_id_stable_and_overridable(clean):
    first = telemetry.worker_id()
    assert str(os.getpid()) in first
    assert telemetry.worker_id() == first
    clean.setenv("CHUNKFLOW_WORKER_ID", "fleet-worker-7")
    assert telemetry.worker_id() == first  # read at first use...
    telemetry.reset()
    assert telemetry.worker_id() == "fleet-worker-7"  # ...or after reset
    jtel.reset()
    assert jtel.worker_id() == telemetry.worker_id()


def test_sink_named_by_worker_and_events_stamped(clean, tmp_path):
    clean.setenv("CHUNKFLOW_WORKER_ID", "worker a/b")
    telemetry.reset()
    path = telemetry.configure(str(tmp_path))
    assert os.path.basename(path) == "telemetry-worker_a_b.jsonl"
    assert telemetry.configured_path() == path
    with telemetry.task_context("trace-123"):
        telemetry.event("task", "lifecycle/claimed", body="b")
    telemetry.event("task", "outside")
    telemetry.flush()
    events = [json.loads(line) for line in open(path)]
    assert all(e["worker"] == "worker a/b" for e in events)
    assert events[0]["trace_id"] == "trace-123"
    assert "trace_id" not in events[1]
    snap = next(e for e in events if e["kind"] == "snapshot")
    assert "events" not in snap and snap["counters"] == {}
    # the in-memory events keep their meaning
    assert telemetry.snapshot()["events"][0]["name"] == "lifecycle/claimed"


QUANTILE_CASES = {
    "empty": {},
    "zero": {"count": 0, "buckets": []},
    "none_buckets": {"count": 5, "buckets": None},
    "torn": {"count": 5, "buckets": []},
    "one_bucket": {"count": 10, "buckets": [0, 0, 0, 10] + [0] * 13},
    "first": {"count": 7, "buckets": [7] + [0] * 16},
    "overflow": {"count": 3, "buckets": [0] * 16 + [3]},
    "short": {"count": 4, "buckets": [4]},
    "spread": {"count": 100, "buckets": [0, 0, 50, 0, 40, 0, 0, 0, 0, 10]
               + [0] * 7},
    "tail": {"count": 9, "buckets": [1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3,
                                     0, 0, 2, 1]},
}


@pytest.mark.parametrize("case", sorted(QUANTILE_CASES))
def test_quantile_from_buckets_matches_jax(case):
    h = QUANTILE_CASES[case]
    assert telemetry.QUANTILE_BOUNDS == jtel.QUANTILE_BOUNDS
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert telemetry.quantile_from_buckets(h, q) == \
            jtel.quantile_from_buckets(h, q), (case, q)


def test_quantile_histograms_match_jax(clean):
    values = [0.004] * 50 + [0.02] * 40 + [0.8] * 10 + [0.0, 9999.0]
    for v in values:
        telemetry.observe_quantile("serving/latency", v)
        jtel.observe_quantile("serving/latency", v)
    assert telemetry.snapshot()["qhists"] == jtel.snapshot()["qhists"]
    for q in (0.5, 0.99):
        assert telemetry.quantile("serving/latency", q) == \
            jtel.quantile("serving/latency", q)
    assert 0.0025 <= telemetry.quantile("serving/latency", 0.5) <= 0.005
    assert telemetry.quantile("missing", 0.5) is None


def test_quantile_histogram_respects_kill_switch(clean):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    telemetry.observe_quantile("serving/latency", 0.1)
    assert telemetry.quantile("serving/latency", 0.5) is None
    clean.delenv("CHUNKFLOW_TELEMETRY")
    assert "qhists" not in telemetry.snapshot()


def test_chip_gauge_names_match_jax(clean):
    telemetry.chip_gauge("device", 3, "bytes_in_use", 7.0)
    jtel.chip_gauge("device", 3, "bytes_in_use", 7.0)
    assert telemetry.snapshot()["gauges"] == jtel.snapshot()["gauges"]
    m = telemetry.CHIP_METRIC_RE.match("device/chip/3/bytes_in_use")
    assert m.group("chip") == "3" and m.group("plane") == "device"
    assert telemetry.CHIP_METRIC_RE.pattern == jtel.CHIP_METRIC_RE.pattern


def _drive_both(fn):
    """Run ``fn(module)`` on the port's telemetry and the JAX package's."""
    return fn(telemetry), fn(jtel)


def test_timeseries_matches_jax_on_one_clock(clean):
    def run(tel):
        sampler = tel.start_timeseries(interval=3600.0)  # manual ticks
        assert tel.start_timeseries() is sampler
        out = []
        tel.inc("serving/requests", 10)
        tel.gauge("serving/inflight", 3)
        tel.observe_quantile("serving/latency", 0.01)
        out.append(sampler.sample(now=1000.0))
        tel.inc("serving/requests", 20)
        tel.inc("serving/errors", 1)
        tel.observe_quantile("serving/latency", 0.3)
        out.append(sampler.sample(now=1002.0))
        tel.gauge("serving/inflight", 1)
        out.append(sampler.sample(now=1002.5))
        return out, tel.timeseries()

    port, jax_ = _drive_both(run)
    assert port == jax_
    assert port[1]["rate:serving/requests"][-1] == (1002.5, 0.0)
    assert port[1]["rate:serving/errors"][0] == (1002.0, 0.5)


def test_timeseries_ring_is_bounded(clean):
    sampler = telemetry.start_timeseries(interval=3600.0, points=5)
    telemetry.inc("x/count")
    for i in range(20):
        sampler.sample(now=1000.0 + i)
    series = telemetry.timeseries()
    assert len(series["rate:x/count"]) == 5
    assert series["rate:x/count"][-1][0] == 1019.0


def test_timeseries_knobs_and_kill_switch(clean):
    clean.setenv("CHUNKFLOW_TS_INTERVAL", "0")
    assert telemetry.start_timeseries() is None
    clean.setenv("CHUNKFLOW_TS_INTERVAL", "2.5")
    clean.setenv("CHUNKFLOW_TS_POINTS", "77")
    assert telemetry.ts_interval() == 2.5 and telemetry.ts_points() == 77
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    assert telemetry.start_timeseries() is None
    assert not telemetry.timeseries_running()
    assert telemetry.timeseries() == {}
    assert not any(t.name == "chunkflow-timeseries"
                   for t in threading.enumerate())


def test_tick_hooks_run_and_clear_on_reset(clean):
    ticks = []
    sampler = telemetry.start_timeseries(interval=3600.0)
    telemetry.add_tick_hook(ticks.append)
    telemetry.add_tick_hook(ticks.append)  # idempotent by identity
    sampler.sample(now=1000.0)
    assert ticks == [1000.0]

    def explode(now):
        raise RuntimeError("hook down")

    telemetry.add_tick_hook(explode)  # a raising hook never kills a tick
    sampler.sample(now=1001.0)
    assert ticks == [1000.0, 1001.0]
    telemetry.remove_tick_hook(explode)
    telemetry.reset()
    assert not telemetry.timeseries_running()
    sampler2 = telemetry.start_timeseries(interval=3600.0)
    sampler2.sample(now=2000.0)
    assert ticks == [1000.0, 1001.0]


def test_flush_takes_a_final_sample_and_runs_hooks(clean, tmp_path):
    seen = []
    telemetry.add_flush_hook(seen.append)
    path = telemetry.configure(str(tmp_path))
    telemetry.start_timeseries(interval=3600.0)  # would never self-tick
    telemetry.inc("serving/requests", 4)
    telemetry.observe_quantile("serving/latency", 0.01)
    telemetry.flush()
    events = [json.loads(line) for line in open(path)]
    ts = [e for e in events if e["kind"] == "timeseries"]
    assert ts and ts[-1]["qhists"]["serving/latency"]["count"] == 1
    assert events[-1]["kind"] == "snapshot"
    assert events[-1]["qhists"]["serving/latency"]["count"] == 1
    assert seen == [str(tmp_path)]


def test_reset_hooks_run(clean):
    seen = []
    telemetry.add_reset_hook(lambda: seen.append(1))
    telemetry.reset()
    telemetry.reset()
    assert len(seen) >= 2


def test_summary_table_matches_jax(clean):
    def run(tel):
        with tel.span("pipeline/drain"):
            pass
        tel.observe("pipeline/compute", 0.25)
        tel.inc("tasks/committed", 3)
        tel.gauge("serving/inflight", 2)
        for v in (0.004, 0.02, 0.8):
            tel.observe_quantile("serving/latency", v)
        return tel.summary_table()

    port, jax_ = _drive_both(run)
    # span durations differ between the two runs: compare the rest
    strip = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                       if "pipeline/drain" not in ln]
    assert strip(port) == strip(jax_)
    for word in ("telemetry summary:", "latency hist", "serving/latency",
                 "tasks/committed", "gauge (last)"):
        assert word in port
    telemetry.reset()
    assert telemetry.summary_table() == ""


# ---------------------------------------------------------------------------
# the task tree
# ---------------------------------------------------------------------------
TREE_CASES = [((0, 0, 0), (4, 8, 8), (4, 4, 4)),
              ((0, 0, 0), (16, 64, 48), (8, 16, 16)),
              ((3, 5, 7), (20, 33, 17), (4, 8, 5))]


@pytest.mark.parametrize("start,stop,block", TREE_CASES)
def test_task_tree_to_dict_matches_jax(start, stop, block):
    port = SpatialTaskTree(BoundingBox(start, stop), block)
    jax_ = JaxTree(JaxBoundingBox(start, stop), block)
    assert port.to_dict() == jax_.to_dict()
    # the same claim / done sequence keeps them equal
    for _ in range(3):
        a, b = port.next_ready_task(), jax_.next_ready_task()
        assert a.bbox.string == b.bbox.string
        a.set_state_done(auto_propagate=True)
        b.set_state_done(auto_propagate=True)
        assert port.to_dict() == jax_.to_dict()
    assert SpatialTaskTree.from_json(port.json).to_dict() == port.to_dict()


def test_task_tree_decomposition_and_merge_order():
    tree = SpatialTaskTree(BoundingBox((0, 0, 0), (16, 64, 64)), (8, 32, 32))
    leaves = tree.leaf_list
    assert len(leaves) == 8
    assert sum(int(v) for leaf in leaves
               for v in [leaf.bbox.shape[0] * leaf.bbox.shape[1]
                         * leaf.bbox.shape[2]]) == 16 * 64 * 64
    order = []
    while True:
        node = tree.next_ready_task()
        if node is None:
            break
        order.append(node)
        node.set_state_done()
    # children before parents; every node runs once
    assert order[-1] is tree and tree.all_done
    assert len(order) == len(list(tree.walk()))
    assert tree.find(leaves[0].bbox.string) is leaves[0]
    post = list(tree.post_order())
    assert post[-1] is tree and len(post) == len(order)


def test_global_id_allocator_disjoint_ranges():
    ids = GlobalIdAllocator(100)
    bases = []
    threads = [threading.Thread(target=lambda: bases.append(ids.allocate(10)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(bases) == list(range(100, 180, 10))
    assert ids.watermark == 180


# ---------------------------------------------------------------------------
# the coordination service and the Prometheus exposition
# ---------------------------------------------------------------------------
def _make_tree():
    return SpatialTaskTree(BoundingBox((0, 0, 0), (4, 8, 8)), (4, 4, 4))


def test_handle_objids_and_tasks():
    svc = CoordinationService(id_start=100, task_tree=_make_tree())
    assert svc.handle("GET", "/objids/10") == (200, {"base_id": 100})
    assert svc.handle("GET", "/objids/5")[1]["base_id"] == 110
    done = 0
    while True:
        status, payload = svc.handle("GET", "/task")
        if status == 204:
            break
        status, result = svc.handle("POST", f"/task/{payload['bbox']}/done")
        assert status == 200
        done += 1
        if result["all_done"]:
            break
    assert done >= 4
    assert svc.handle("GET", "/state")[1]["state"] == "done"
    assert svc.handle("GET", "/nope")[0] == 404
    assert svc.handle("POST", "/task/0-4_0-4_0-4/done")[0] == 404
    assert CoordinationService().handle("GET", "/task")[0] == 404


SNAPSHOTS = {
    "golden": {
        "counters": {"tasks/committed": 3},
        "gauges": {"scheduler/depth/prefetch": 4},
        "hists": {
            "pipeline/drain": {"count": 2, "total": 1.5, "min": 0.5,
                               "max": 1.0, "mean": 0.75},
            "pipeline/compute": {"count": 2, "total": 0.5, "min": 0.1,
                                 "max": 0.4, "mean": 0.25},
        },
    },
    "chips": {
        "counters": {},
        "gauges": {"device/chip/0/bytes_in_use": 100.0,
                   "device/chip/1/bytes_in_use": 700.0,
                   "device/chip/0/hbm_headroom": 900.0,
                   "shard/chip/0/voxels": 2048.0,
                   "device/bytes_in_use": 800.0},
        "hists": {},
    },
    "serving": {
        "counters": {"serving/requests": 5, "serving/completed": 4,
                     "serving/rejected_admission": 1,
                     "serving/deadline_missed": 0},
        "gauges": {"serving/inflight": 0, "slo/availability/firing": 1.0,
                   "slo/latency/firing": 0.0},
        "hists": {"serving/request": {"count": 4, "total": 0.25,
                                      "min": 0.05, "max": 0.1,
                                      "mean": 0.0625},
                  "scheduler/load": {"count": 1, "total": 0.5, "min": 0.5,
                                     "max": 0.5, "mean": 0.5}},
        "qhists": {"serving/latency": {
            "count": 5, "total": 0.5, "min": 0.004, "max": 0.3,
            "buckets": [0, 0, 2, 0, 1, 0, 0, 2] + [0] * 9}},
    },
    "empty": {"counters": {}, "gauges": {}, "hists": {}},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_render_prometheus_matches_jax(name):
    snap = SNAPSHOTS[name]
    for worker in ("w1", 'host"1\\a\nb'):
        text = render_prometheus(snap, worker=worker)
        assert text == jrest.render_prometheus(snap, worker=worker)
        assert parse_prometheus(text) == jrest.parse_prometheus(text)
    stats = restapi.serving_stats(text)
    assert stats == jrest.serving_stats(text)
    assert restapi.dominant_stall(text) == jrest.dominant_stall(text)
    flat = parse_prometheus(text)
    assert restapi.firing_alerts(flat) == jrest.firing_alerts(flat)
    assert restapi.achieved_mvox_s(flat) == jrest.achieved_mvox_s(flat)
    if name == "serving":
        assert stats["requests"] == 5 and stats["rejects"] == 1
        assert stats["p50_s"] is not None
        assert restapi.firing_alerts(flat) == ["availability"]


def test_render_prometheus_golden_text():
    text = render_prometheus(SNAPSHOTS["golden"], worker="w")
    assert text.startswith(
        "# TYPE chunkflow_tasks_committed_total counter\n"
        'chunkflow_tasks_committed_total{worker="w"} 3\n')
    assert ('chunkflow_stall_dominant_share{worker="w",'
            'phase="pipeline/drain"} 0.750000\n') in text
    assert restapi.prometheus_name("op/save-h5") == "chunkflow_op_save_h5"
    with pytest.raises(ValueError):
        parse_prometheus("not a sample line at all{")


def test_rendered_live_exposition_parses(clean):
    telemetry.inc("tasks/committed", 5)
    telemetry.gauge("pipeline/ring_occupancy", 2)
    telemetry.observe_quantile("serving/latency", 0.02)
    with telemetry.span("pipeline/drain"):
        pass
    text = render_prometheus()
    parsed = parse_prometheus(text)
    assert parsed["chunkflow_tasks_committed_total"] == 5
    assert parsed["chunkflow_pipeline_ring_occupancy"] == 2
    assert parsed["chunkflow_pipeline_drain_count"] == 1
    assert parsed["chunkflow_serving_latency_count"] == 1
    for line in text.splitlines():
        if line.startswith("#"):
            assert re.fullmatch(r"# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                                r"(counter|gauge|summary|histogram)", line)
        else:
            assert re.fullmatch(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? '
                                r'-?[0-9.eE+na-]+', line), line


def test_metrics_and_healthz_roundtrip(clean):
    telemetry.inc("tasks/committed", 2)
    server = start_metrics_exporter(0, host="127.0.0.1")
    try:
        port = restapi.bound_port(server)
        status, headers, body = _get(port, "/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        assert parse_prometheus(body.decode())[
            "chunkflow_tasks_committed_total"] == 2
        health = json.loads(_get(port, "/healthz")[2])
        assert health["status"] == "ok"
        assert health["worker"] == telemetry.worker_id()
        assert health["inflight_leases"] == 0
        sample = scrape_worker(f"127.0.0.1:{port}")
        assert sample["error"] is None
        assert sample["metrics"]["chunkflow_tasks_committed_total"] == 2
        assert sample["serving"] is None
    finally:
        shutdown_server(server)


def test_responses_carry_their_length(clean):
    """Every answer says its length, so a client reads a large body in
    large blocks; 204 and 404 too."""
    telemetry.inc("tasks/committed")
    server, _thread = serve(CoordinationService(task_tree=_make_tree()),
                            host="127.0.0.1", port=0, background=True)
    port = server.server_address[1]
    try:
        for path in ("/metrics", "/healthz", "/state", "/objids/3"):
            _, headers, body = _get(port, path)
            assert int(headers["Content-Length"]) == len(body) > 0
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/nope")
        assert int(err.value.headers["Content-Length"]) == len(
            err.value.read())
    finally:
        shutdown_server(server)


def test_worker_health_marks_truncated_handle_list(clean):
    from chunkflow_tpu_torch.parallel import lifecycle

    class Lease:
        def __init__(self, i):
            self.handle = f"h{i}"

    clean.setattr(lifecycle, "inflight", lambda: [Lease(i) for i in range(70)])
    health = restapi.worker_health()
    assert health["inflight_leases"] == 70
    assert len(health["inflight_handles"]) == 64
    assert health["inflight_handles_truncated"] is True
    clean.setattr(lifecycle, "inflight", lambda: [Lease(0)])
    health = restapi.worker_health()
    assert health["inflight_handles"] == ["h0"]
    assert health["inflight_handles_truncated"] is False
    assert set(health) == set(jrest.worker_health())


def test_kill_switch_creates_no_listener(clean):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    before = {t.name for t in threading.enumerate()}
    assert start_metrics_exporter(0) is None
    assert {t.name for t in threading.enumerate()} == before
    shutdown_server(None)  # the disabled exporter's None is accepted


def test_scrape_worker_reports_unreachable():
    sample = scrape_worker("127.0.0.1:1", timeout=0.2)
    assert sample["error"] is not None
    assert sample["healthz"] is None and sample["metrics"] is None


def test_http_server_roundtrip(clean):
    server, thread = serve(CoordinationService(task_tree=_make_tree()),
                           host="127.0.0.1", port=0, background=True)
    try:
        port = server.server_address[1]
        assert json.loads(_get(port, "/objids/7")[2])["base_id"] == 0
        body = json.loads(_get(port, "/task")[2])
        status, _ = _post(port, f"/task/{body['bbox']}/done")
        assert status == 200
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/nope")
        assert err.value.code == 404
    finally:
        shutdown_server(server)
    assert not thread.is_alive()


def test_endpoint_file_write_read_merge(clean, tmp_path):
    clean.setenv("CHUNKFLOW_WORKER_ID", "fleet-w007")
    telemetry.reset()
    path = restapi.write_endpoint_file(str(tmp_path), metrics_port=18080)
    assert path is not None
    record = restapi.read_endpoint_file(str(tmp_path), "fleet-w007")
    assert record["metrics_port"] == 18080
    assert record["worker"] == "fleet-w007"
    restapi.write_endpoint_file(str(tmp_path), serving_port=18081,
                                other=None)
    record = restapi.read_endpoint_file(str(tmp_path), "fleet-w007")
    assert record["metrics_port"] == 18080
    assert record["serving_port"] == 18081 and "other" not in record
    # the JAX package's reader reads the port's file
    assert jrest.read_endpoint_file(str(tmp_path), "fleet-w007") == record
    assert restapi.read_endpoint_file(str(tmp_path), "nobody") is None


def test_endpoint_file_respects_kill_switch(clean, tmp_path):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    assert restapi.write_endpoint_file(str(tmp_path), metrics_port=1) is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("raw,want", [("", None), ("  ", None), ("0", 0),
                                      ("9100", 9100), ("x", None)])
def test_exporter_port_from_env(clean, raw, want):
    clean.setenv("CHUNKFLOW_METRICS_PORT", raw)
    assert restapi.exporter_port_from_env() == want
    assert jrest.exporter_port_from_env() == want


def test_shutdown_server_joins_listener_thread(clean):
    server = start_metrics_exporter(0, host="127.0.0.1")
    thread = server._serve_thread
    assert thread.is_alive()
    shutdown_server(server)
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# the profiler capture and POST /profile
# ---------------------------------------------------------------------------
def test_profile_route_captures_bounded_window(clean, tmp_path):
    telemetry.configure(str(tmp_path))
    status, payload = CoordinationService().handle(
        "POST", "/profile?seconds=0.1")
    assert status == 200, payload
    assert payload["trace_dir"].startswith(str(tmp_path))
    assert payload["seconds"] == 0.1
    trace = os.path.join(payload["trace_dir"], profiling.TRACE_FILE)
    assert "traceEvents" in json.load(open(trace))
    assert telemetry.snapshot()["counters"]["profile/captures"] == 1
    assert profiling._TRACE_ACTIVE is False


def test_profile_route_rejects_malformed_seconds(clean, tmp_path):
    telemetry.configure(str(tmp_path))
    status, _ = CoordinationService().handle("POST", "/profile?seconds=soon")
    assert status == 400


def test_profile_route_refuses_concurrent_session(clean, tmp_path):
    telemetry.configure(str(tmp_path))
    clean.setattr(profiling, "_TRACE_ACTIVE", True)
    status, payload = CoordinationService().handle(
        "POST", "/profile?seconds=0.1")
    assert status == 409 and "already active" in payload["error"]


def test_profile_route_gone_under_kill_switch(clean):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    status, _ = CoordinationService().handle("POST", "/profile?seconds=1")
    assert status == 404


def test_profile_route_without_destination_is_503(clean):
    status, payload = CoordinationService().handle(
        "POST", "/profile?seconds=0.1")
    assert status == 503 and "no capture dir" in payload["error"]


def test_profile_route_over_http(clean, tmp_path):
    telemetry.configure(str(tmp_path))
    server, _thread = serve(CoordinationService(), host="127.0.0.1", port=0,
                            background=True)
    try:
        status, payload = _post(server.server_address[1],
                                "/profile?seconds=0.1")
        assert status == 200
        assert payload["trace_dir"].startswith(str(tmp_path))
        assert payload["worker"] == telemetry.worker_id()
    finally:
        shutdown_server(server)


def test_stall_streak_triggers_capture(clean):
    captured = []
    clean.setattr(profiling, "maybe_capture",
                  lambda reason: captured.append(reason) or True)
    clean.setenv("CHUNKFLOW_PROFILE_STALL_SHARE", "0.8")
    clean.setenv("CHUNKFLOW_PROFILE_STALL_TICKS", "3")
    profiling.note_stall("scheduler/load", 0.9)
    profiling.note_stall("scheduler/load", 0.5)  # a dip resets
    profiling.note_stall("scheduler/load", 0.9)
    profiling.note_stall("pipeline/drain", 0.9)  # a phase switch resets
    profiling.note_stall("pipeline/drain", 0.9)
    assert captured == []
    profiling.note_stall("pipeline/drain", 0.9)
    assert captured == ["stall-pipeline-drain"]
    profiling.note_stall("pipeline/drain", 0.9)
    profiling.note_stall("pipeline/drain", 0.9)
    assert len(captured) == 1


def test_scheduler_tick_feeds_stall_anomaly(clean):
    from chunkflow_tpu_torch.flow.scheduler import DepthController

    seen = []
    clean.setattr(profiling, "note_stall",
                  lambda phase, share: seen.append((phase, share)))
    ctl = DepthController(interval=1, watermark_bytes=1 << 40)
    ctl.tick({"scheduler/load": 10.0})
    assert seen == [("scheduler/load", 1.0)]


def test_automatic_capture_cooldown_and_switch(clean, tmp_path):
    telemetry.configure(str(tmp_path))
    clean.setenv("CHUNKFLOW_PROFILE_SECONDS", "0.05")
    clean.setenv("CHUNKFLOW_PROFILE_COOLDOWN", "600")
    assert profiling.maybe_capture("retrace-a") is True
    profiling.wait_for_captures(30)
    assert profiling.maybe_capture("retrace-b") is False  # cooldown
    clean.setenv("CHUNKFLOW_PROFILE_ON_ANOMALY", "0")
    telemetry.reset()
    telemetry.configure(str(tmp_path))
    assert profiling.maybe_capture("retrace-c") is False
    dirs = [p.name for p in tmp_path.iterdir() if p.name.startswith("prof")]
    assert dirs == ["profile-retrace-a-" + dirs[0].rsplit("-", 1)[1]]


def test_kill_switch_captures_nothing(clean, tmp_path):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    clean.setenv("CHUNKFLOW_PROFILE_DIR", str(tmp_path))
    assert profiling.maybe_capture("retrace-x") is False
    target, err = profiling.capture(0.1, "operator", force=True)
    assert target is None and "disabled" in err
    assert profiling.start_task_window(str(tmp_path / "w")) is None
    assert list(tmp_path.iterdir()) == []


def test_capture_requires_a_destination(clean):
    target, err = profiling.capture(0.1, "operator", force=True)
    assert target is None and "no capture dir" in err


def test_task_window_stops_after_n_tasks(clean, tmp_path):
    trace_dir = tmp_path / "win"
    window = profiling.start_task_window(str(trace_dir), tasks=2)
    assert window is not None and window.active
    assert profiling.start_task_window(str(tmp_path / "x")) is None
    torch.ones(8).sum()
    profiling.note_task_done()
    assert window.active
    profiling.note_task_done()
    assert not window.active
    assert (trace_dir / profiling.TRACE_FILE).exists()
    assert profiling._TRACE_ACTIVE is False
    profiling.note_task_done()
    window.close()


def test_cli_profile_dir_traces_the_first_tasks(clean, tmp_path):
    from chunkflow_tpu_torch.flow import cli

    out = tmp_path / "out.npy"
    cli.main(["--device", "cpu", "--profile-dir", str(tmp_path / "prof"),
              "--profile-tasks", "1", "create-chunk", "--size", "4", "16",
              "16", "save-npy", "-f", str(out)])
    assert (tmp_path / "prof" / profiling.TRACE_FILE).exists()
    assert out.exists()


# ---------------------------------------------------------------------------
# the SLO evaluator
# ---------------------------------------------------------------------------
class Traffic:
    """A hand-driven clock and registry source."""

    def __init__(self):
        self.t = 1000.0
        self.counters = {}
        self.qhists = {}

    def clock(self):
        return self.t

    def source(self):
        return {"counters": dict(self.counters),
                "qhists": {k: dict(v) for k, v in self.qhists.items()}}

    def advance(self, dt, **deltas):
        self.t += dt
        for name, n in deltas.items():
            key = name.replace("__", "/")
            self.counters[key] = self.counters.get(key, 0) + n

    def observe(self, n_fast, n_slow):
        h = self.qhists.setdefault("serving/latency", {
            "count": 0, "buckets": [0] * (len(telemetry.QUANTILE_BOUNDS) + 1)})
        h["count"] += n_fast + n_slow
        buckets = list(h["buckets"])
        buckets[3] += n_fast  # 0.01 s: within a 0.05 s threshold
        buckets[9] += n_slow  # 1 s: past it, and past 0.5 s
        h["buckets"] = buckets


def _evaluator(mod, traffic, target=0.9, short_s=2.0, long_s=10.0, burn=2.0,
               severity="page", period_s=120.0):
    obj = mod.Objective("availability", target=target,
                        total=("serving/requests",), bad=("serving/errors",))
    rule = mod.BurnRule("fast", short_s=short_s, long_s=long_s, burn=burn,
                        severity=severity)
    return mod.SLOEvaluator(objectives=[obj], rules=[rule],
                            period_s=period_s, clock=traffic.clock,
                            source=traffic.source)


def test_healthy_traffic_never_fires(clean):
    traffic = Traffic()
    ev = _evaluator(slo, traffic)
    alerts = []
    for _ in range(30):
        traffic.advance(1.0, serving__requests=10)
        alerts += ev.tick()
    assert alerts == [] and ev.firing() == []
    status = ev.status()["objectives"][0]
    assert status["burn_rate"] == 0.0 and status["budget_remaining"] == 1.0


def test_regression_fires_exactly_once_with_attributes(clean):
    traffic = Traffic()
    ev = _evaluator(slo, traffic)
    for _ in range(15):
        traffic.advance(1.0, serving__requests=10)
        ev.tick()
    alerts = []
    for _ in range(10):
        traffic.advance(1.0, serving__requests=10, serving__errors=5)
        alerts += ev.tick()
    assert len(alerts) == 1
    alert = alerts[0]
    assert alert["alert"] == "availability:fast"
    assert alert["severity"] == "page"
    assert alert["burn_short"] >= 2.0 and alert["burn_long"] >= 2.0
    assert alert["budget_remaining"] < 1.0
    assert ev.firing() == ["availability:fast"]
    snap = telemetry.snapshot()
    assert snap["counters"]["slo/alerts"] == 1
    assert snap["gauges"]["slo/availability/firing"] == 1.0


def test_alert_resolves_and_rearms(clean):
    traffic = Traffic()
    ev = _evaluator(slo, traffic, long_s=6.0)
    for _ in range(10):
        traffic.advance(1.0, serving__requests=10)
        ev.tick()
    fired = []
    for _ in range(6):
        traffic.advance(1.0, serving__requests=10, serving__errors=5)
        fired += ev.tick()
    assert len(fired) == 1
    for _ in range(10):
        traffic.advance(1.0, serving__requests=10)
        ev.tick()
    assert ev.firing() == []
    assert telemetry.snapshot()["counters"]["slo/alerts_resolved"] == 1
    again = []
    for _ in range(6):
        traffic.advance(1.0, serving__requests=10, serving__errors=5)
        again += ev.tick()
    assert len(again) == 1


def test_short_window_gates_stale_regressions(clean):
    traffic = Traffic()
    ev = _evaluator(slo, traffic, long_s=30.0)
    traffic.advance(1.0, serving__requests=10)
    ev.tick()
    fired = []
    for _ in range(2):
        traffic.advance(1.0, serving__requests=10, serving__errors=8)
        fired += ev.tick()
    assert fired
    for _ in range(10):
        traffic.advance(1.0, serving__requests=10)
        ev.tick()
    assert ev.firing() == []
    assert ev.status()["objectives"][0]["rules"][0]["burn_long"] > 0


def test_no_traffic_burns_nothing(clean):
    traffic = Traffic()
    ev = _evaluator(slo, traffic)
    for _ in range(20):
        traffic.advance(1.0)
        assert ev.tick() == []
    assert ev.status()["objectives"][0]["budget_remaining"] == 1.0


def _scenario(kind):
    """(per-tick counter deltas, per-tick latency observations)."""
    steps = []
    if kind == "burst":
        steps = ([dict(serving__requests=10)] * 8
                 + [dict(serving__requests=10, serving__errors=6)] * 6
                 + [dict(serving__requests=10)] * 12
                 + [dict(serving__requests=10, serving__errors=9)] * 4)
    elif kind == "deadline":
        steps = ([dict(serving__requests=10)] * 5
                 + [dict(serving__requests=10,
                         serving__deadline_missed=7)] * 8
                 + [dict()] * 5)
    elif kind == "latency":
        steps = [dict(serving__requests=10)] * 20
    return steps


@pytest.mark.parametrize("kind", ["burst", "deadline", "latency"])
def test_evaluators_agree_with_jax_on_one_clock(clean, kind):
    """Both packages' default objectives under a compressed config, fed
    the same counters at the same ``now``: the same new alerts, status
    and firing after every tick."""
    config = {"period_s": 600.0, "scale": 0.001,
              "objective": {"storage_hit": {"enabled": False}}}
    traffic = Traffic()
    port = slo.evaluator_from_config(config, clock=traffic.clock,
                                     source=traffic.source)
    jax_ = jslo.evaluator_from_config(config, clock=traffic.clock,
                                      source=traffic.source)
    fired = []
    for i, deltas in enumerate(_scenario(kind)):
        traffic.advance(1.0, **deltas)
        if kind == "latency":
            traffic.observe(10 - i // 2, i // 2)
        a, b = port.tick(), jax_.tick()
        assert a == b
        fired += a
        assert port.status() == jax_.status()
        assert port.firing() == jax_.firing()
    assert fired  # every scenario pages at least once
    assert telemetry.snapshot()["gauges"] == jtel.snapshot()["gauges"]


def test_latency_objective_counts_buckets_above_threshold(clean):
    traffic = Traffic()
    obj = slo.Objective("latency", target=0.9, kind="latency",
                        qhist="serving/latency", threshold_s=0.05)
    ev = slo.SLOEvaluator(objectives=[obj],
                          rules=[slo.BurnRule("fast", short_s=2.0,
                                              long_s=6.0, burn=2.0)],
                          period_s=120.0, clock=traffic.clock,
                          source=traffic.source)
    for _ in range(5):
        traffic.advance(1.0)
        traffic.observe(10, 0)
        assert ev.tick() == []
    fired = []
    for _ in range(6):
        traffic.advance(1.0)
        traffic.observe(5, 5)
        fired += ev.tick()
    assert len(fired) == 1 and fired[0]["objective"] == "latency"


def test_page_alert_triggers_one_capture_cooldown_blocks_second(
        clean, tmp_path):
    clean.setenv("CHUNKFLOW_PROFILE_ON_ANOMALY", "1")
    clean.setenv("CHUNKFLOW_PROFILE_SECONDS", "0.1")
    clean.setenv("CHUNKFLOW_PROFILE_COOLDOWN", "600")
    telemetry.configure(str(tmp_path))
    traffic = Traffic()
    objectives = [
        slo.Objective("availability", target=0.9,
                      total=("serving/requests",), bad=("serving/errors",)),
        slo.Objective("deadline", target=0.9, total=("serving/requests",),
                      bad=("serving/deadline_missed",))]
    ev = slo.SLOEvaluator(objectives=objectives,
                          rules=[slo.BurnRule("fast", short_s=2.0,
                                              long_s=6.0, burn=2.0,
                                              severity="page")],
                          period_s=120.0, clock=traffic.clock,
                          source=traffic.source)
    traffic.advance(1.0, serving__requests=10)
    ev.tick()
    for _ in range(4):
        traffic.advance(1.0, serving__requests=10, serving__errors=8)
        ev.tick()
    profiling.wait_for_captures(30)
    captures = [p.name for p in tmp_path.iterdir()
                if p.name.startswith("profile-slo-")]
    assert len(captures) == 1 and "availability" in captures[0]
    assert (tmp_path / captures[0] / profiling.TRACE_FILE).exists()
    for _ in range(4):
        traffic.advance(1.0, serving__requests=10,
                        serving__deadline_missed=8)
        ev.tick()
    profiling.wait_for_captures(30)
    assert "deadline:fast" in ev.firing()
    assert len([p for p in tmp_path.iterdir()
                if p.name.startswith("profile-slo-")]) == 1
    assert telemetry.snapshot()["counters"]["profile/captures"] == 1


SLO_TOML = """
period_s = 240
scale = 0.5
[objective.availability]
target = 0.95
[objective.storage_hit]
enabled = false
[objective.custom]
total = ["serving/requests"]
bad = ["serving/oom"]
target = 0.99
[rule.fast]
short_s = 4
long_s = 16
burn = 3.0
severity = "page"
[rule.slow]
enabled = false
"""


def test_minimal_toml_parser_matches_jax():
    text = ('a = 1\nb = 2.5\nc = "x"  # comment\nd = true\n'
            "[s.t]\ne = [\"p\", \"q\"]\n" + SLO_TOML)
    parsed = slo._parse_toml_minimal(text)
    assert parsed == jslo._parse_toml_minimal(text)
    assert parsed["s"]["t"]["e"] == ["p", "q"] and parsed["d"] is True
    with pytest.raises(ValueError):
        slo._parse_toml_minimal("not a key value line\n")
    assert slo._parse_toml_minimal("junk\n[a]\nb = 1\n",
                                   lenient=True) == {"a": {"b": 1}}


def test_config_file_overrides_defaults_as_in_jax(clean, tmp_path):
    path = tmp_path / "slo.toml"
    path.write_text(SLO_TOML)
    config = slo.load_slo_config(str(path), pyproject="/nonexistent")
    assert config == jslo.load_slo_config(str(path), pyproject="/nonexistent")
    ev = slo.evaluator_from_config(config)
    jev = jslo.evaluator_from_config(config)
    assert [o.describe() for o in ev.objectives] == \
        [o.describe() for o in jev.objectives]
    assert [(r.name, r.short_s, r.long_s, r.burn, r.severity)
            for r in ev.rules] == [(r.name, r.short_s, r.long_s, r.burn,
                                    r.severity) for r in jev.rules]
    names = [o.name for o in ev.objectives]
    assert "storage_hit" not in names and "custom" in names
    assert ev.rules[0].short_s == pytest.approx(2.0)
    assert ev.period_s == pytest.approx(120.0)


def test_pyproject_section_applies_and_file_wins(clean, tmp_path):
    pyproject = tmp_path / "pyproject.toml"
    pyproject.write_text(
        "[tool.chunkflow.slo]\nperiod_s = 100\n"
        "[tool.chunkflow.slo.objective.availability]\ntarget = 0.5\n")
    config = slo.load_slo_config(None, pyproject=str(pyproject))
    assert config["period_s"] == 100
    assert config["objective"]["availability"]["target"] == 0.5
    override = tmp_path / "slo.toml"
    override.write_text("[objective.availability]\ntarget = 0.75\n")
    config = slo.load_slo_config(str(override), pyproject=str(pyproject))
    assert config["period_s"] == 100
    assert config["objective"]["availability"]["target"] == 0.75


def test_malformed_config_raises(clean, tmp_path):
    bad = tmp_path / "bad.toml"
    bad.write_text("this is not toml at all\n")
    with pytest.raises(ValueError):
        slo.load_slo_config(str(bad), pyproject="/nonexistent")


def test_objective_validation():
    with pytest.raises(ValueError):
        slo.Objective("x", target=1.5)
    with pytest.raises(ValueError):
        slo.Objective("x", target=0.9, kind="latency")
    with pytest.raises(ValueError):
        slo.Objective("x", target=0.9, kind="histogram")
    with pytest.raises(ValueError):
        slo.BurnRule("x", short_s=10.0, long_s=5.0, burn=1.0)
    with pytest.raises(ValueError):
        slo.SLOEvaluator(scale=0.0)


def test_start_slo_rides_the_timeseries_tick(clean, tmp_path):
    clean.setenv("CHUNKFLOW_TS_INTERVAL", "3600")  # ticks by hand
    telemetry.configure(str(tmp_path))
    ev = slo.start_slo(pyproject="/nonexistent")
    assert ev is not None and slo.current() is ev
    assert slo.start_slo() is ev
    assert telemetry.timeseries_running()
    telemetry.inc("serving/requests")
    telemetry.flush()  # the final sample ticks the evaluator
    assert len(ev._samples) >= 1 and ev.status()["t"] is not None
    telemetry.reset()  # the reset hook tears the evaluator down
    assert slo.current() is None and not telemetry.timeseries_running()


def test_kill_switches_create_nothing(clean):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    assert not slo.slo_enabled()
    assert slo.start_slo() is None
    assert telemetry.start_timeseries() is None
    assert not any(t.name == "chunkflow-timeseries"
                   for t in threading.enumerate())
    clean.delenv("CHUNKFLOW_TELEMETRY")
    clean.setenv("CHUNKFLOW_SLO", "0")
    assert slo.start_slo() is None


def test_alert_events_reach_the_jsonl_stream(clean, tmp_path):
    telemetry.configure(str(tmp_path))
    traffic = Traffic()
    ev = _evaluator(slo, traffic, long_s=6.0)
    traffic.advance(1.0, serving__requests=10)
    ev.tick()
    for _ in range(6):
        traffic.advance(1.0, serving__requests=10, serving__errors=8)
        ev.tick()
    for _ in range(10):
        traffic.advance(1.0, serving__requests=10)
        ev.tick()
    telemetry.flush()
    events = [json.loads(line) for line in open(telemetry.configured_path())]
    alerts = [e for e in events if e.get("kind") == "alert"]
    assert [e["state"] for e in alerts] == ["firing", "resolved"]
    assert alerts[0]["alert"] == "availability:fast"
    assert alerts[0]["burn_short"] >= 2.0 and "worker" in alerts[0]


def test_alerts_route_without_evaluator(clean):
    status, payload = CoordinationService().handle("GET", "/alerts")
    assert status == 200 and payload["enabled"] is False
    assert payload["firing"] == [] and payload["objectives"] == []


def test_alerts_route_reports_burn_and_firing(clean):
    traffic = Traffic()
    ev = _evaluator(slo, traffic, long_s=6.0)
    clean.setattr(slo, "_EVALUATOR", ev)
    for _ in range(8):
        traffic.advance(1.0, serving__requests=10, serving__errors=8)
        ev.tick()
    status, payload = CoordinationService().handle("GET", "/alerts")
    assert status == 200 and payload["enabled"] is True
    assert payload["firing"] == ["availability:fast"]
    obj = payload["objectives"][0]
    assert obj["burn_rate"] >= 2.0 and obj["budget_remaining"] < 1.0
    assert obj["rules"][0]["firing"] is True
    metrics = parse_prometheus(render_prometheus())
    assert metrics["chunkflow_slo_availability_firing"] == 1.0
    assert restapi.firing_alerts(metrics) == ["availability"]


def test_alerts_route_gone_under_kill_switch(clean):
    clean.setenv("CHUNKFLOW_TELEMETRY", "0")
    assert CoordinationService().handle("GET", "/alerts")[0] == 404
