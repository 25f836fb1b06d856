"""The port's fleet supervisor against the JAX package's, on the CPU.

Decisions: the cases of ``tests/parallel/test_fleet_supervisor.py``
drive both packages' ``FleetSupervisor`` with the same scripted fakes
(a launcher of stub processes, a scraper, a memory probe, queue stats,
the seed, and a clock that advances one interval a tick), and the two
must write the same ``fleet`` events (names and attributes, less pids,
ports and times), the same ``fleet/*`` counters and the same state-file
records, and leave their queues in the same state.

Real processes: ``python -m chunkflow_tpu_torch --device cpu fleet-run``
drains a tiny ``file://`` volume (identity engine, a slow plugin) with
two workers, one SIGKILLed while it holds a lease; the output is
bitwise the JAX package's in-process reference, the ledger full, each
trace committed once, and ``fleet-status`` reports the dead worker.
"""
import itertools
import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from chunkflow_tpu.core import telemetry as jtel
from chunkflow_tpu.parallel import fleet as jfleet
from chunkflow_tpu.parallel import queues as jqueues
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.parallel import fleet, queues, restapi
from chunkflow_tpu_torch.parallel.lifecycle import FileLedger

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (jfleet, jqueues, jtel), "port": (fleet, queues, telemetry)}
#: event and record keys that differ between two runs by nature
VOLATILE = ("worker_pid", "port", "uptime_s", "pid", "endpoint", "started",
            "last_seen", "t", "supervisor_pid")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("CHUNKFLOW_FLEET", "CHUNKFLOW_TELEMETRY", "CHUNKFLOW_CHAOS",
                "CHUNKFLOW_WORKER_ID"):
        monkeypatch.delenv(var, raising=False)
    telemetry.reset()
    jtel.reset()
    yield
    telemetry.reset()
    jtel.reset()


# ---------------------------------------------------------------------------
# fakes, one set per package run
# ---------------------------------------------------------------------------
class StubProc:
    """A Popen-alike: SIGTERM exits 143 (the drain contract), kill() -9."""

    def __init__(self, pid, die_immediately=False):
        self.pid = pid
        self.returncode = -9 if die_immediately else None
        self.signals = []

    def poll(self):
        return self.returncode

    def send_signal(self, sig):
        self.signals.append(sig)
        if sig == signal.SIGTERM and self.returncode is None:
            self.returncode = 143

    def kill(self):
        self.signals.append(signal.SIGKILL)
        if self.returncode is None:
            self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode


def scripted_queue(base, script):
    """A queue of ``base``'s package whose stats play ``script`` back (the
    last entry repeats) and whose nacks are recorded."""
    class Scripted(base):
        def __init__(self):
            self.i = 0
            self.nacked = []

        def stats(self):
            stats = script[min(self.i, len(script) - 1)]
            self.i += 1
            return dict(stats)

        def nack(self, handle, refund=True):
            self.nacked.append(handle)
            return True

    return Scripted()


class Clock:
    """time.time and time.sleep of a fleet module: a tick is one
    interval, whatever the machine's load."""

    def __init__(self):
        self.now = 1.0e9

    def time(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def drive(which, tmp_path, monkeypatch, case):
    """One case on one package: ``case`` gives the supervisor's keyword
    arguments, the queue (a stats script or a function making a memory
    queue and its claimed handles), the scrape (a function of the call
    count and the handles), the processes, and actions between ticks.
    Returns what the two packages must agree on."""
    fleet_mod, queue_mod, tel = PACKAGES[which]
    events = []
    real_event = tel.event

    def recording_event(kind, name, **attrs):
        if kind == "fleet":
            events.append(dict(attrs, name=name))
        return real_event(kind, name, **attrs)

    monkeypatch.setattr(tel, "event", recording_event)
    clock = Clock()
    monkeypatch.setattr(fleet_mod, "time", types.SimpleNamespace(
        time=clock.time, sleep=clock.sleep))
    pids = itertools.count(10 ** 9)  # no such process: no RSS to read
    dying = list(case.get("dying", ()))

    def launcher(cmd, env):
        return StubProc(next(pids), die_immediately=(
            dying.pop(0) if dying else False))

    handles = []
    calls = {"n": 0}

    def scraper(endpoint, timeout=1.0):
        calls["n"] += 1
        scrape = case.get("scrape")
        if scrape is None:
            return {"endpoint": endpoint,
                    "healthz": {"inflight_leases": 0},
                    "metrics": {}, "dominant_stall": None, "error": None}
        return dict(scrape(calls["n"], handles), endpoint=endpoint)

    kw = dict(min_workers=1, max_workers=3, interval=0.05,
              startup_grace=0.0, mem_probe=lambda: None,
              state_path=str(tmp_path / f"{which}-state.json"))
    kw.update(case.get("kw", {}))
    if which == "port":
        kw["device"] = "cpu"
    sup = fleet_mod.FleetSupervisor(
        "memory://fleet-stub", ["fetch-task-from-queue", "-q", "x",
                                "delete-task-in-queue"],
        launcher=launcher, scraper=scraper, **kw)
    if "script" in case:
        sup.queue = scripted_queue(queue_mod.QueueBase, case["script"])
    else:
        sup.queue, got = case["queue"](queue_mod, which)
        handles.extend(got)
    targets = []
    for tick in range(case["ticks"]):
        for action in case.get("actions", {}).get(tick, ()):
            action(sup)
        sup.step()
        clock.sleep(sup.interval)
        targets.append((sup.target, sum(1 for w in sup.workers if w.active)))
    state = json.loads(Path(kw["state_path"]).read_text())
    counters = {k: v for k, v in tel.snapshot()["counters"].items()
                if k.startswith("fleet/")}
    queue_after = None
    if "queue" in case:
        stats = sup.queue.stats()
        item = sup.queue.receive()
        queue_after = (stats["pending"], stats["inflight"],
                       sup.queue.receive_count(item[0]) if item else None)
    return {
        "events": [{k: v for k, v in e.items() if k not in VOLATILE}
                   for e in events],
        "records": [{k: v for k, v in r.items() if k not in VOLATILE}
                    for r in state["workers"]],
        "state": {k: v for k, v in state.items()
                  if k not in VOLATILE and k != "workers"},
        "counters": counters,
        "targets": targets,
        "signals": [[int(s) for s in w.proc.signals] for w in sup.workers],
        "queue": queue_after,
        "nacked": len(getattr(sup.queue, "nacked", ())),
        "drilled": [w.drill for w in sup.workers],
    }


DEEP = {"pending": 20, "inflight": 0, "dead": 0, "receives": 0}
IDLE = {"pending": 0, "inflight": 0, "dead": 0, "receives": 0}


def _stall(phase, share, metrics=None, firing=()):
    def scrape(n, handles):
        return {"healthz": {"inflight_leases": 1},
                "metrics": dict(metrics or {}),
                "dominant_stall": {"phase": phase, "share": share},
                "slo_firing": sorted(firing), "error": None}
    return scrape


def _memory_queue(name, bodies, claims):
    def make(queue_mod, which):
        full = f"{name}-{which}"
        queue_mod.MemoryQueue._registry.pop(full, None)
        queue = queue_mod.MemoryQueue.open(full, visibility_timeout=600)
        queue.send_messages(bodies)
        return queue, [queue.receive()[0] for _ in range(claims)]
    return make


def _wedged_after_one(n, handles):
    if n == 1:  # one healthy probe reporting the leases
        return {"healthz": {"inflight_leases": len(handles),
                            "inflight_handles": list(handles)},
                "metrics": {}, "dominant_stall": None, "error": None}
    return {"healthz": None, "metrics": None, "dominant_stall": None,
            "error": "URLError: wedged"}


def _truncated(n, handles):
    return {"healthz": {"inflight_leases": 65,
                        "inflight_handles": list(handles),
                        "inflight_handles_truncated": True},
            "metrics": {}, "dominant_stall": None, "error": None}


def _kill(index):
    def act(sup):
        sup.workers[index].proc.kill()
    return act


CASES = {
    "deep-queue-scale-up": dict(script=[DEEP], ticks=3,
                                kw=dict(scale_up_backlog=4.0)),
    "idle-drain": dict(script=[DEEP, DEEP, DEEP, IDLE], ticks=5,
                       kw=dict(idle_ticks=2)),
    "memory-watermark": dict(script=[DEEP], ticks=3,
                             kw=dict(mem_probe=lambda: 1.5,
                                     mem_watermark_gb=2.0)),
    "storage-bound": dict(script=[IDLE, DEEP], ticks=3,
                          scrape=_stall("scheduler/write", 0.8)),
    "storage-cold-cache": dict(script=[IDLE, DEEP], ticks=3, scrape=_stall(
        "scheduler/load", 0.8, {"chunkflow_storage_hits_total": 5,
                                "chunkflow_storage_misses_total": 95})),
    "storage-warm-cache": dict(script=[IDLE, DEEP], ticks=3, scrape=_stall(
        "scheduler/load", 0.8, {"chunkflow_storage_hits_total": 90,
                                "chunkflow_storage_misses_total": 10})),
    "compute-bound-scales": dict(script=[IDLE, DEEP], ticks=2,
                                 scrape=_stall("pipeline/compute", 0.9)),
    "dead-letter-surge": dict(
        script=[dict(DEEP, dead=0), dict(DEEP, dead=3), dict(DEEP, dead=6),
                dict(DEEP, dead=9)], ticks=4, kw=dict(dead_letter_surge=3)),
    "probe-miss-quarantine": dict(
        queue=_memory_queue("fleet-evict", ["t1", "t2"], 2), ticks=5,
        scrape=_wedged_after_one, kw=dict(probe_misses=2, max_workers=2)),
    "truncated-handles": dict(
        queue=_memory_queue("fleet-trunc", ["t1"], 1), ticks=3,
        scrape=_truncated, actions={2: [_kill(0)]}),
    "crash-loop-backoff": dict(
        script=[DEEP], ticks=8, dying=[True] * 10,
        kw=dict(max_workers=2, crash_limit=3, crash_window=60.0,
                crash_backoff=3600.0)),
    "crash-backoff-holds-scale-up": dict(
        script=[DEEP], ticks=10, dying=[True] * 10,
        kw=dict(max_workers=4, crash_limit=3, crash_window=60.0,
                crash_backoff=3600.0)),
    "spot-drill": dict(
        script=[DEEP], ticks=4, kw=dict(min_workers=2, seed=7),
        actions={2: [lambda sup: sup.request_drill()]}),
    "seeded-drill-rate": dict(
        script=[DEEP], ticks=8, kw=dict(min_workers=2, drill_rate=0.5,
                                        seed=11)),
    "static-mode": dict(
        script=[DEEP], ticks=6, static=True,
        kw=dict(min_workers=2, max_workers=4), actions={4: [_kill(0)]}),
    "slo-annotated-hold": dict(
        script=[IDLE, DEEP], ticks=3, scrape=_stall(
            "scheduler/write", 0.8,
            {"chunkflow_slo_availability_firing": 1.0},
            firing={"availability", "latency"})),
    "slo-annotated-scale": dict(
        script=[IDLE, DEEP], ticks=2, scrape=_stall(
            "pipeline/compute", 0.9, firing={"latency"})),
    "exit-code-and-last-seen": dict(
        script=[IDLE], ticks=3, kw=dict(max_workers=2),
        actions={2: [_kill(0)]}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decisions_match_the_jax_supervisor(name, tmp_path, monkeypatch):
    case = CASES[name]
    if case.get("static"):
        monkeypatch.setenv("CHUNKFLOW_FLEET", "0")
        assert fleet.fleet_disabled() and jfleet.fleet_disabled()
    runs = {}
    for which in PACKAGES:
        with monkeypatch.context() as mp:
            runs[which] = drive(which, tmp_path, mp, case)
    assert runs["port"] == runs["jax"]
    # the case decided something
    assert runs["port"]["events"] or case.get("static")


def test_the_cases_reach_every_decision(tmp_path, monkeypatch):
    """The cases above cover every fleet event, hold reason and counter
    the JAX supervisor writes."""
    names, reasons, counters = set(), set(), set()
    for case in CASES.values():
        with monkeypatch.context() as mp:
            if case.get("static"):
                mp.setenv("CHUNKFLOW_FLEET", "0")
            run = drive("port", tmp_path, mp, case)
        telemetry.reset()
        names |= {e["name"] for e in run["events"]}
        reasons |= {e.get("reason") for e in run["events"]
                    if e["name"] == "fleet/hold"}
        counters |= set(run["counters"])
    assert names >= {"fleet/spawn", "fleet/scale", "fleet/hold",
                     "fleet/evict", "fleet/drill", "fleet/exit",
                     "fleet/handles_truncated", "fleet/crash_backoff"}
    assert reasons >= {"memory-watermark", "dead-letter-surge",
                       "storage-bound:scheduler/write",
                       "storage-bound:scheduler/load:cold-cache",
                       "storage-bound:scheduler/load:load-bound",
                       "crash-backoff"}
    assert counters >= {"fleet/spawns", "fleet/scale_up", "fleet/scale_down",
                        "fleet/scale_down_drains", "fleet/evictions",
                        "fleet/worker_deaths", "fleet/drill_preemptions",
                        "fleet/probe_failures", "fleet/leases_nacked",
                        "fleet/handles_truncated", "fleet/holds",
                        "fleet/crash_backoffs"}


def test_force_release_keeps_the_receive_count_as_the_jax_queue():
    """A third-party release hands the claims back now without a refund,
    counts only real releases and skips bad handles, in both packages."""
    got = {}
    for which, (_, queue_mod, _) in PACKAGES.items():
        name = f"fleet-force-{which}"
        queue_mod.MemoryQueue._registry.pop(name, None)
        q = queue_mod.MemoryQueue.open(name, visibility_timeout=600)
        q.send_messages(["a", "b"])
        h1, _ = q.receive()
        h2, _ = q.receive()
        released = q.force_release([h1, "no-such-handle", h2, h1])
        h, _ = q.receive()
        got[which] = (released, q.stats()["pending"], q.receive_count(h),
                      len(queue_mod.new_trace_id()))
    assert got["port"] == got["jax"] == (2, 1, 2, 32)


@pytest.mark.parametrize("exit_code", [0, 143])
def test_a_clean_exit_keeps_a_claim_taken_since(exit_code, tmp_path,
                                                monkeypatch):
    """A worker that exits 0 or 143 handed its claims back itself; when
    another worker has claimed the task again before the reap (the
    handle names the task), the port's supervisor leaves that claim
    alone. The JAX supervisor releases the reported handle again and so
    takes the task from its new holder (a fault of the reference, not
    followed: the task would be computed and committed twice)."""
    got = {}
    for which, (fleet_mod, queue_mod, tel) in PACKAGES.items():
        name = f"fleet-steal-{which}-{exit_code}"
        queue_mod.MemoryQueue._registry.pop(name, None)
        queue = queue_mod.MemoryQueue.open(name, visibility_timeout=600)
        queue.send_messages(["t1"])
        handle, _ = queue.receive()
        proc = StubProc(10 ** 9)

        def scraper(endpoint, timeout=1.0):
            return {"endpoint": endpoint,
                    "healthz": {"inflight_leases": 1,
                                "inflight_handles": [handle]},
                    "metrics": {}, "dominant_stall": None, "error": None}

        kw = {"device": "cpu"} if which == "port" else {}
        sup = fleet_mod.FleetSupervisor(
            f"memory://{name}", ["delete-task-in-queue"],
            launcher=lambda cmd, env: proc, scraper=scraper,
            startup_grace=0.0, mem_probe=lambda: None, max_workers=1,
            state_path=str(tmp_path / f"{which}.json"), **kw)
        sup.queue = queue
        sup.step()  # spawn
        sup.step()  # the probe reports the claim
        assert sup.workers[0].handles == [handle]
        # the worker hands the task back and exits; another claims it
        assert queue.nack(handle)
        proc.returncode = exit_code
        assert queue.receive()[0] == handle
        sup.step()  # the reap
        got[which] = queue.stats()["inflight"]
        tel.reset()
    assert got == {"port": 1, "jax": 0}


def test_the_worker_command_names_the_port_and_its_device(tmp_path):
    spawned = []

    def launcher(cmd, env):
        spawned.append((cmd, env))
        return StubProc(10 ** 9)

    sup = fleet.FleetSupervisor(
        "memory://fleet-cmd", ["fetch-task-from-queue", "-q", "x",
                               "delete-task-in-queue"],
        launcher=launcher, metrics_dir=str(tmp_path), device="cpu")
    sup.spawn_worker()
    (cmd, env), = spawned
    assert cmd[1:5] == ["-m", "chunkflow_tpu_torch", "--device", "cpu"]
    assert "chunkflow_tpu.flow.cli" not in cmd
    assert env["CHUNKFLOW_WORKER_ID"] == "fleet-w001"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    # a supervisor of card workers builds nothing for an injected launcher
    assert fleet.FleetSupervisor(
        "memory://fleet-cmd", ["delete-task-in-queue"],
        launcher=launcher).build_kernels() is None


def test_fleet_discovers_port_from_endpoint_file(tmp_path, monkeypatch):
    """The supervisor reads an ephemeral-spawned worker's bound port from
    its endpoint file (``tests/serve/test_frontend.py``'s case)."""
    monkeypatch.setenv("CHUNKFLOW_WORKER_ID", "fleet-w001")
    telemetry.reset()
    restapi.write_endpoint_file(str(tmp_path), metrics_port=23456)
    monkeypatch.delenv("CHUNKFLOW_WORKER_ID")
    telemetry.reset()

    supervisor = fleet.FleetSupervisor.__new__(fleet.FleetSupervisor)
    supervisor.metrics_dir = str(tmp_path)

    class _Proc:
        pid = 4242

        def poll(self):
            return None

    worker = fleet.WorkerHandle("fleet-w001", None, _Proc(), [])
    assert worker.to_record()["endpoint"] is None
    assert supervisor._discover_port(worker) == 23456
    assert worker.port == 23456
    assert worker.to_record()["endpoint"] == "127.0.0.1:23456"
    # an unknown worker stays undiscovered (probation handles it)
    other = fleet.WorkerHandle("fleet-w999", None, _Proc(), [])
    assert supervisor._discover_port(other) is None


def test_bounds_and_host_memory():
    with pytest.raises(ValueError, match="min_workers"):
        fleet.FleetSupervisor("memory://x", ["delete-task-in-queue"],
                              min_workers=3, max_workers=2)
    assert fleet.host_available_gb() > 0 and jfleet.host_available_gb() > 0
    assert fleet._proc_rss_gb(os.getpid()) > 0
    assert fleet._proc_rss_gb(10 ** 9) is None


# ---------------------------------------------------------------------------
# a real fleet through the port CLI
# ---------------------------------------------------------------------------
GRID = (3, 2, 2)


def _seed(tmp_path, tag, queue_mod):
    """12 random 8x16x16 chunks as h5 files and a file queue of their
    boxes (the JAX test's ``_seed_volume``)."""
    from chunkflow_tpu_torch import Chunk

    in_dir = tmp_path / f"in-{tag}"
    in_dir.mkdir()
    rng = np.random.default_rng(11)
    bodies = []
    for zi, yi, xi in itertools.product(*(range(g) for g in GRID)):
        c = Chunk(rng.random((8, 16, 16)).astype(np.float32),
                  voxel_offset=(zi * 8, yi * 16, xi * 16))
        c.to_h5(str(in_dir) + "/")
        bodies.append(c.bbox.string)
    qdir = f"file://{tmp_path / f'q-{tag}'}"
    queue_mod.open_queue(qdir).send_messages(bodies)
    return qdir, in_dir, bodies


def _pipeline(in_dir, out_dir, plugin=None):
    return (["load-h5", "-f", f"{in_dir}/"]
            + (["plugin", "--name", str(plugin)] if plugin else [])
            + ["inference", "-s", "4", "8", "8", "-v", "1", "2", "2", "-c",
               "1", "-f", "identity", "--no-crop-output-margin",
               "--async-depth", "2", "save-h5", "--file-name",
               f"{out_dir}/", "delete-task-in-queue"])


def _outputs(out_dir):
    import h5py

    outputs = {}
    for path in sorted(out_dir.iterdir()):
        with h5py.File(path, "r") as f:
            outputs[path.name] = np.asarray(f["main"][:])
    return outputs


def _jax_reference(tmp_path):
    """The JAX CLI's in-process, fault-free run of the same volume."""
    from click.testing import CliRunner

    from chunkflow_tpu.flow.cli import main as jax_main

    qdir, in_dir, _ = _seed(tmp_path, "ref", jqueues)
    out_dir = tmp_path / "out-ref"
    out_dir.mkdir()
    result = CliRunner().invoke(
        jax_main, ["fetch-task-from-queue", "-q", qdir, "-r", "2"]
        + _pipeline(in_dir, out_dir), catch_exceptions=False)
    assert result.exit_code == 0, result.output
    jtel.reset()
    return _outputs(out_dir)


def _wait_for(cond, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        found = cond()
        if found:
            return found
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def test_fleet_run_survives_a_sigkill_and_a_drain_bitwise(tmp_path):
    """``fleet-run`` (two workers on the CPU) drains the volume while the
    test SIGKILLs a worker holding a lease (the supervisor reaps it and
    force-releases its leases) and then SIGTERMs another with a task in
    flight (it hands its tasks back and exits 143): the output is bitwise
    the JAX package's in-process run, each trace is committed once, and
    ``fleet-status`` reports the dead worker's exit."""
    reference = _jax_reference(tmp_path)
    qdir, in_dir, bodies = _seed(tmp_path, "fleet", queues)
    out_dir = tmp_path / "out-fleet"
    out_dir.mkdir()
    mdir = tmp_path / "metrics"
    ledger = tmp_path / "ledger"
    slow = tmp_path / "slow_identity.py"
    slow.write_text("import time\n\n\ndef execute(chunk):\n"
                    "    time.sleep(1.0)\n    return chunk\n")
    visibility = 120  # only a force-release brings a task back in time
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                   if p))
    env.pop("CHUNKFLOW_CHAOS", None)
    started = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "chunkflow_tpu_torch", "--device", "cpu",
         "--metrics-dir", str(mdir), "fleet-run", "-q", qdir,
         "--min-workers", "2", "--max-workers", "2", "--interval", "0.25",
         # probation of 3 s: a drained worker's listener closes before
         # it exits
         "--probe-misses", "12", "--idle-ticks", "2", "-v", str(visibility),
         "-r", "4", "--poll-interval", "0.25", "--max-retries", "5",
         "--lease-renew", "1", "--ledger", str(ledger),
         "--max-runtime", "100", "-w",
         " ".join(_pipeline(in_dir, out_dir, plugin=slow))],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        def handles(record):
            sample = restapi.scrape_worker(
                f"127.0.0.1:{record['metrics_port']}", timeout=1.0)
            return (sample.get("healthz") or {}).get("inflight_handles")

        def steady_leased_worker():
            """A worker whose leases stayed the same over more than a
            supervisor tick: the supervisor's last probe saw them."""
            for path in mdir.glob("endpoint-fleet-w*.json"):
                try:
                    record = json.loads(path.read_text())
                except ValueError:
                    continue
                held = handles(record)
                if held:
                    time.sleep(0.6)  # two supervisor ticks
                    if handles(record) == held:
                        return record
            return None

        victim = _wait_for(steady_leased_worker, 60,
                           "a worker holding a lease")
        os.kill(victim["pid"], signal.SIGKILL)
        killed_at = time.time()

        def busy_other():
            for path in mdir.glob("endpoint-fleet-w*.json"):
                try:
                    record = json.loads(path.read_text())
                except ValueError:
                    continue
                if record["worker"] != victim["worker"] and handles(record):
                    return record
            return None

        # a preemption notice to a worker with a task in flight
        drained = _wait_for(busy_other, 60, "another worker holding a lease")
        os.kill(drained["pid"], signal.SIGTERM)
        out, _ = proc.communicate(timeout=100)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "fleet drained:" in out and "fleet state:" in out
    assert time.time() - killed_at < visibility / 2, \
        "the killed worker's tasks waited out the visibility timeout"

    outputs = _outputs(out_dir)
    assert sorted(outputs) == sorted(reference)
    for name in reference:
        assert np.array_equal(outputs[name], reference[name]), name
    assert sorted(FileLedger(str(ledger)).keys()) == sorted(bodies)
    queue = queues.open_queue(qdir)
    assert queue.stats()["pending"] == queue.stats()["inflight"] == 0
    assert queue.dead_letters() == []

    from chunkflow_tpu_torch.flow.log_summary import load_telemetry_dir

    events = load_telemetry_dir(str(mdir))
    commits = {}
    for e in events:
        if e.get("name") == "lifecycle/committed":
            commits[e["trace_id"]] = commits.get(e["trace_id"], 0) + 1
    assert len(commits) == len(bodies) and set(commits.values()) == {1}
    victim_id = victim["worker"]
    held = {e["trace_id"] for e in events
            if e.get("worker") == victim_id
            and e.get("name") == "lifecycle/claimed"}
    done = {e["trace_id"] for e in events
            if e.get("worker") == victim_id
            and e.get("name") == "lifecycle/committed"}
    assert held - done, "the killed worker held no unfinished task"
    exits = [e for e in events if e.get("name") == "fleet/exit"
             and e.get("fleet_worker") == victim_id]
    assert exits and exits[0]["exit_code"] == -signal.SIGKILL
    assert not exits[0]["expected"]
    # the drained worker handed its tasks back (preempted in compute, or
    # surrendered from the scheduler's queue) and exited 143
    exits = [e for e in events if e.get("name") == "fleet/exit"
             and e.get("fleet_worker") == drained["worker"]]
    assert exits and exits[0]["exit_code"] == 143
    assert any(e.get("name") in ("lifecycle/preempted",
                                 "lifecycle/surrendered")
               and e.get("worker") == drained["worker"] for e in events)
    counters = {}
    for e in events:  # the supervisor's last snapshot
        if e.get("kind") == "snapshot" \
                and not str(e.get("worker")).startswith("fleet-w"):
            counters = e.get("counters") or {}
    assert counters.get("fleet/worker_deaths", 0) >= 1
    assert counters.get("fleet/leases_nacked", 0) >= 1
    assert time.time() - started < visibility

    status = subprocess.run(
        [sys.executable, "-m", "chunkflow_tpu_torch", "--device", "cpu",
         "--metrics-dir", str(mdir), "fleet-status", "-q", qdir],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert status.returncode == 0, status.stderr
    assert "pending=0" in status.stdout
    assert (f"[{victim_id}]: exited, exit code -9 (signal 9)"
            in status.stdout)
    assert "last seen" in status.stdout


def test_fleet_status_enriches_unreachable_from_state(tmp_path, capsys):
    """An unreachable worker the state file calls live reports its state
    and last-seen age; a reaped one its exit code, as in the JAX CLI."""
    queues.MemoryQueue._registry.pop("fs-enrich", None)
    queues.MemoryQueue.open("fs-enrich")
    state = {
        "t": time.time(), "queue": "memory://fs-enrich", "static": False,
        "target": 2, "min_workers": 1, "max_workers": 3,
        "workers": [
            {"worker": "fleet-w001", "pid": 1, "port": 1,
             "endpoint": "127.0.0.1:1", "state": "live",
             "started": time.time() - 60,
             "last_seen": time.time() - 12.5, "exit_code": None,
             "inflight_leases": 1},
            {"worker": "fleet-w002", "pid": 2, "port": 2,
             "endpoint": "127.0.0.1:2", "state": "exited",
             "started": time.time() - 60,
             "last_seen": time.time() - 30.0, "exit_code": -9,
             "inflight_leases": 0},
        ],
    }
    state_path = tmp_path / "fleet-state.json"
    state_path.write_text(json.dumps(state))
    assert cli.main(["--device", "cpu", "fleet-status", "-q",
                     "memory://fs-enrich", "--fleet-state", str(state_path),
                     "--timeout", "0.2"]) == 0
    out = capsys.readouterr().out
    assert "target=2 elastic [1..3]" in out
    assert "[fleet-w001]: unreachable" in out
    assert "state=live" in out and "s ago" in out
    assert "[fleet-w002]: exited, exit code -9 (signal 9)" in out
