"""The fleet supervisor: spawn, probe, scale and evict queue-fed workers.

The counterpart of ``chunkflow_tpu/parallel/fleet.py``, with the same
decisions, counters, gauges and events (``fleet/*``):

* **Spawn and probe.** Each worker is a subprocess running ``python -m
  chunkflow_tpu_torch --device <device> fetch-task-from-queue ...`` with
  its own metrics exporter. With a metrics directory the worker binds an
  ephemeral port (``--metrics-port 0``) and publishes it in its endpoint
  file; the supervisor reads it there and probes ``/healthz`` and
  ``/metrics`` every tick (``restapi.scrape_worker``): leases and their
  handles, the dominant stall phase, storage cache counters, firing SLO
  objectives.
* **Scale from telemetry.** A deep queue whose workers are compute-bound
  grows by one worker a tick up to ``max_workers``; a storage-bound fleet
  holds (qualified by the block cache's hit rate), and so do a host memory
  watermark, a dead-letter surge and a crash-loop back-off; an idle queue
  drains back to ``min_workers``. Every scale or hold event carries the
  firing SLO objectives.
* **Preemption.** A worker that misses ``probe_misses`` probes is
  SIGKILLed and the lease handles it last reported are force-released,
  so its tasks come back now; so are those of any worker that died. A
  scale-down is a drain: SIGTERM (the worker's preemption handler nacks
  and flushes, exit 143), SIGKILL past ``term_grace``. A seeded spot
  drill reclaims live workers through the same drain. Unlike the JAX
  supervisor, the port releases nothing for a worker that exited 0 or
  143: it handed its claims back itself, and a ``file://`` or
  ``memory://`` handle names the task, so a second release could take it
  from the worker that claimed it since (the task would be computed and
  committed twice).
* **Drain sessions.** A worker ends its session when its queue stays
  empty (``--retry-times``); exit 0 is a finished session, not a death,
  and the supervisor spawns another while it owes the target size.
* ``CHUNKFLOW_FLEET=0`` holds a static size: the dead are still replaced.

The workers run on ``device`` (the card unless the caller asks for the
CPU): it is passed to each as the group option ``--device``, and so is
``verbose`` as ``-v`` (a worker's log then ends with its run counters,
kernel launches included, also after a drain). On the card
the supervisor builds the CUDA kernels once before its first spawn, so no
worker compiles them while its first probes are due. Host memory gates a
scale-up (``worker_mem_est_gb`` or the workers' mean resident set, as in
the JAX package); device memory does not.

Injection points for tests: ``launcher(cmd, env)`` (a Popen-like),
``scraper(endpoint, timeout=...)`` and ``mem_probe()``.
"""
from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel.queues import QueueBase, open_queue
from chunkflow_tpu_torch.parallel.restapi import (
    read_endpoint_file,
    scrape_worker,
)

__all__ = [
    "WorkerHandle", "FleetSupervisor", "fleet_disabled",
    "host_available_gb", "COMPUTE_BOUND_PHASES", "STORAGE_BOUND_PHASES",
]

_OFF_VALUES = ("0", "off", "false", "no")

#: dominant stall phases of a fleet limited by its workers' compute: more
#: workers add throughput
COMPUTE_BOUND_PHASES = (
    "pipeline/stage", "pipeline/dispatch", "pipeline/compute",
    "pipeline/drain", "scheduler/post",
)
#: phases of a fleet limited by shared storage: more workers only add
#: pressure on the same volume store
STORAGE_BOUND_PHASES = ("scheduler/load", "scheduler/write")


def fleet_disabled() -> bool:
    """``CHUNKFLOW_FLEET=0`` (or off/false/no): a static-size fleet that
    never consults telemetry, but still replaces its dead."""
    return os.environ.get(
        "CHUNKFLOW_FLEET", "1").strip().lower() in _OFF_VALUES


def host_available_gb() -> Optional[float]:
    """``MemAvailable`` from /proc/meminfo in GiB; None where procfs lacks
    it (the watermark then does not gate)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / (1 << 20)
    except (OSError, ValueError, IndexError):
        pass
    return None


def _proc_rss_gb(pid: int) -> Optional[float]:
    """A process's resident set in GiB (procfs; None elsewhere)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 30)
    except (OSError, ValueError, IndexError):
        return None


def _free_port(host: str) -> int:
    """An ephemeral port for a worker without a metrics directory (bind
    and release: racy, and a worker that loses the race dies and is
    replaced). With a metrics directory workers bind port 0 and publish
    the port they got."""
    with socket.socket() as s:
        s.bind((host if host != "0.0.0.0" else "", 0))
        return s.getsockname()[1]


class WorkerHandle:
    """One supervised worker process. ``state``: starting (until its
    first answered probe), live, draining (SIGTERM sent), quarantined
    (SIGKILLed after missed probes), exited."""

    def __init__(self, ident: str, port: Optional[int], proc,
                 cmd: List[str]):
        self.ident = ident
        # None until read from the worker's endpoint file
        self.port = port
        self.proc = proc
        self.cmd = cmd
        self.state = "starting"
        self.started = time.time()
        self.last_seen: Optional[float] = None
        self.misses = 0
        self.exit_code: Optional[int] = None
        self.exited_at: Optional[float] = None
        self.handles: List[str] = []
        self.handles_truncated = False
        self.inflight_leases = 0
        self.dominant_stall: Optional[dict] = None
        # the last scrape's storage block cache counters ({"hits",
        # "misses"}), None until the worker reports any
        self.storage_cache: Optional[dict] = None
        # the last scrape's firing SLO objectives
        self.slo_firing: List[str] = []
        self.drill = False
        self.drain_deadline: Optional[float] = None

    @property
    def running(self) -> bool:
        return self.exit_code is None and self.proc.poll() is None

    @property
    def active(self) -> bool:
        """Counts toward the fleet's size: running and not on its way out."""
        return self.running and self.state in ("starting", "live")

    def to_record(self) -> dict:
        """The worker's record in the fleet-state file ``fleet-status``
        reads; a dead worker keeps its last-seen time and exit code."""
        return {
            "worker": self.ident,
            "pid": getattr(self.proc, "pid", None),
            "port": self.port,
            "endpoint": (f"127.0.0.1:{self.port}"
                         if self.port is not None else None),
            "state": self.state,
            "started": self.started,
            "last_seen": self.last_seen,
            "exit_code": self.exit_code,
            "inflight_leases": self.inflight_leases,
        }


class FleetSupervisor:
    """Spawn, monitor, scale and evict a fleet of queue-fed workers.

    ``worker_args`` is one worker's command line after the group options
    (``["fetch-task-from-queue", "-q", queue, ..., "delete-task-in-
    queue"]``); the supervisor puts the interpreter, ``--device`` and the
    metrics options in front."""

    def __init__(
        self,
        queue_spec: str,
        worker_args: List[str],
        *,
        min_workers: int = 1,
        max_workers: int = 4,
        interval: float = 2.0,
        scale_up_backlog: float = 4.0,
        idle_ticks: int = 2,
        probe_misses: int = 3,
        probe_timeout: float = 1.0,
        startup_grace: float = 30.0,
        term_grace: float = 10.0,
        mem_watermark_gb: float = 2.0,
        worker_mem_est_gb: float = 0.5,
        storage_hold_share: float = 0.5,
        cache_warm_share: float = 0.5,
        dead_letter_surge: int = 3,
        crash_limit: int = 3,
        crash_window: float = 60.0,
        crash_backoff: float = 10.0,
        drill_rate: float = 0.0,
        seed: Optional[int] = None,
        metrics_dir: Optional[str] = None,
        state_path: Optional[str] = None,
        host: str = "127.0.0.1",
        python: Optional[str] = None,
        worker_env: Optional[Dict[str, str]] = None,
        static: Optional[bool] = None,
        launcher: Optional[Callable] = None,
        scraper: Optional[Callable] = None,
        mem_probe: Optional[Callable] = None,
        visibility_timeout: float = 1800.0,
        device: str = "cuda",
        verbose: int = 0,
    ):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}..{max_workers}"
            )
        self.queue_spec = queue_spec
        self.queue: QueueBase = open_queue(
            queue_spec, visibility_timeout=visibility_timeout)
        self.worker_args = list(worker_args)
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.interval = max(0.05, float(interval))
        self.scale_up_backlog = float(scale_up_backlog)
        self.idle_ticks = int(idle_ticks)
        self.probe_misses = int(probe_misses)
        self.probe_timeout = float(probe_timeout)
        self.startup_grace = float(startup_grace)
        self.term_grace = float(term_grace)
        self.mem_watermark_gb = float(mem_watermark_gb)
        self.worker_mem_est_gb = float(worker_mem_est_gb)
        self.storage_hold_share = float(storage_hold_share)
        self.cache_warm_share = float(cache_warm_share)
        self.dead_letter_surge = int(dead_letter_surge)
        self.crash_limit = int(crash_limit)
        self.crash_window = float(crash_window)
        self.crash_backoff = float(crash_backoff)
        self.drill_rate = float(drill_rate)
        self.rng = random.Random(seed)
        self.metrics_dir = metrics_dir
        self.state_path = state_path or (
            os.path.join(metrics_dir, "fleet-state.json")
            if metrics_dir else None
        )
        self.host = host
        self.python = python or sys.executable
        self.worker_env = dict(worker_env or {})
        self.device = device
        self.verbose = int(verbose)
        self.static = fleet_disabled() if static is None else bool(static)
        self.launcher = launcher or self._spawn_process
        self.scraper = scraper or scrape_worker
        self.mem_probe = mem_probe or host_available_gb
        # probes need the workers' listeners, which CHUNKFLOW_TELEMETRY=0
        # (inherited) suppresses: supervision is then process liveness
        self.probing = telemetry.enabled()
        # seconds the CUDA kernels took to build before the first spawn
        # (None: not built here)
        self.kernel_build_s: Optional[float] = None

        self.workers: List[WorkerHandle] = []
        self.target = min_workers
        self._seq = 0
        self._idle_count = 0
        self._last_dead: Optional[int] = None
        self._recent_dead: List[tuple] = []  # (t, delta) dead-letter rises
        self._deaths: List[float] = []       # unexpected-death times
        self._backoff_until = 0.0
        self._drill_requested = 0
        self._stop = threading.Event()
        if "delete-task-in-queue" not in self.worker_args:
            print(
                "fleet: worker_args has no delete-task-in-queue stage — "
                "workers will never ack, the queue will never drain",
                file=sys.stderr,
            )

    # -- spawning -------------------------------------------------------
    def _spawn_process(self, cmd: List[str], env: Dict[str, str]):
        log = subprocess.DEVNULL
        if self.metrics_dir:
            os.makedirs(self.metrics_dir, exist_ok=True)
            log = open(
                os.path.join(
                    self.metrics_dir,
                    f"worker-{env['CHUNKFLOW_WORKER_ID']}.log"),
                "ab",
            )
        try:
            return subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True,  # our SIGINT is not theirs
            )
        finally:
            if log is not subprocess.DEVNULL:
                log.close()  # the child holds its own descriptor

    def spawn_worker(self) -> WorkerHandle:
        self._seq += 1
        ident = f"fleet-w{self._seq:03d}"
        # a real spawn with a metrics directory binds port 0 and publishes
        # the port in its endpoint file; an injected launcher or a fleet
        # without a directory gets a port picked here
        discover = (self.metrics_dir is not None
                    and self.launcher == self._spawn_process)
        port = None if discover else _free_port(self.host)
        cmd = [self.python, "-m", "chunkflow_tpu_torch",
               "--device", self.device] + ["-v"] * self.verbose
        if self.metrics_dir:
            cmd += ["--metrics-dir", self.metrics_dir]
        cmd += ["--metrics-port", "0" if discover else str(port)]
        cmd += self.worker_args
        env = dict(os.environ)
        env.update(self.worker_env)
        env["CHUNKFLOW_WORKER_ID"] = ident
        env.pop("CHUNKFLOW_METRICS_PORT", None)  # --metrics-port wins
        # the worker imports the package from where this process did,
        # whatever its working directory
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        worker = WorkerHandle(ident, port, self.launcher(cmd, env), cmd)
        self.workers.append(worker)
        telemetry.inc("fleet/spawns")
        telemetry.event(
            "fleet", "fleet/spawn", fleet_worker=ident,
            worker_pid=getattr(worker.proc, "pid", None), port=port,
        )
        return worker

    def build_kernels(self) -> Optional[float]:
        """Build the CUDA kernels once, before the first spawn, when the
        workers run on a card and this supervisor spawns them itself:
        workers starting together would otherwise wait on one build
        while their first probes fall due. Returns the seconds taken."""
        if self.device == "cpu" or self.launcher != self._spawn_process \
                or self.kernel_build_s is not None:
            return self.kernel_build_s
        from chunkflow_tpu_torch import _build

        t = time.perf_counter()
        _build.build_all(_build.KERNELS)
        self.kernel_build_s = time.perf_counter() - t
        return self.kernel_build_s

    # -- probing + eviction ---------------------------------------------
    def _discover_port(self, worker: WorkerHandle) -> Optional[int]:
        """The bound metrics port of a worker spawned with port 0, from
        the endpoint file it publishes once its exporter is up."""
        if worker.port is not None:
            return worker.port
        if not self.metrics_dir:
            return None
        record = read_endpoint_file(self.metrics_dir, worker.ident)
        if record and record.get("metrics_port"):
            worker.port = int(record["metrics_port"])
        return worker.port

    def _probe(self, worker: WorkerHandle, now: float) -> None:
        if not worker.running or worker.state not in ("starting", "live"):
            return
        if not self.probing:
            worker.state = "live"  # liveness only: running == healthy
            worker.last_seen = now
            return
        if self._discover_port(worker) is None:
            # no port published yet: as a worker whose exporter is not up,
            # the startup grace, then probation
            if now - worker.started < self.startup_grace:
                return
            worker.misses += 1
            telemetry.inc("fleet/probe_failures")
            if worker.misses >= self.probe_misses:
                self._evict(
                    worker, f"no endpoint published after "
                            f"{now - worker.started:.0f}s")
            return
        sample = self.scraper(
            f"{self.host}:{worker.port}", timeout=self.probe_timeout)
        if sample.get("error") is None:
            health = sample.get("healthz") or {}
            worker.state = "live"
            worker.last_seen = now
            worker.misses = 0
            worker.inflight_leases = int(health.get("inflight_leases", 0))
            worker.handles = list(health.get("inflight_handles") or [])
            worker.handles_truncated = bool(
                health.get("inflight_handles_truncated"))
            worker.dominant_stall = sample.get("dominant_stall")
            metrics = sample.get("metrics") or {}
            hits = metrics.get("chunkflow_storage_hits_total")
            misses = metrics.get("chunkflow_storage_misses_total")
            worker.storage_cache = (
                {"hits": float(hits or 0), "misses": float(misses or 0)}
                if (hits is not None or misses is not None) else None
            )
            worker.slo_firing = list(sample.get("slo_firing") or [])
            return
        if worker.state == "starting" and \
                now - worker.started < self.startup_grace:
            return  # the exporter may not be up yet
        worker.misses += 1
        telemetry.inc("fleet/probe_failures")
        if worker.misses >= self.probe_misses:
            self._evict(worker, f"missed {worker.misses} health probes")

    def _evict(self, worker: WorkerHandle, reason: str) -> None:
        """Quarantine a worker that stopped answering: SIGKILL (it cannot
        be trusted to honour SIGTERM); its reported leases are
        force-released when it is reaped."""
        worker.state = "quarantined"
        telemetry.inc("fleet/evictions")
        telemetry.event(
            "fleet", "fleet/evict", fleet_worker=worker.ident,
            reason=reason, leases=len(worker.handles),
        )
        try:
            worker.proc.kill()
        except OSError:
            pass

    # -- graceful drain + spot drill ------------------------------------
    def _drain(self, worker: WorkerHandle, now: float,
               drill: bool = False) -> None:
        worker.state = "draining"
        worker.drill = drill
        worker.drain_deadline = now + self.term_grace
        try:
            worker.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass  # already gone: the reap notices

    def request_drill(self) -> None:
        """One spot-drill preemption on the next tick, whatever
        ``drill_rate`` says."""
        self._drill_requested += 1

    def _maybe_drill(self, now: float) -> None:
        due = self._drill_requested > 0 or (
            self.drill_rate > 0 and self.rng.random() < self.drill_rate
        )
        if not due:
            return
        victims = [w for w in self.workers if w.running and w.state == "live"]
        if not victims:
            return
        if self._drill_requested:
            self._drill_requested -= 1
        victim = self.rng.choice(victims)
        telemetry.inc("fleet/drill_preemptions")
        telemetry.event(
            "fleet", "fleet/drill", fleet_worker=victim.ident,
        )
        # a spot reclaim: a notice (SIGTERM), then the plug (SIGKILL past
        # the drain deadline)
        self._drain(victim, now, drill=True)

    def _enforce_drain_deadlines(self, now: float) -> None:
        for worker in self.workers:
            if (worker.state == "draining" and worker.running
                    and worker.drain_deadline is not None
                    and now > worker.drain_deadline):
                try:
                    worker.proc.kill()
                except OSError:
                    pass

    # -- reaping --------------------------------------------------------
    def _reap(self, now: float) -> None:
        for worker in self.workers:
            if worker.exit_code is not None:
                continue
            code = worker.proc.poll()
            if code is None:
                continue
            worker.exit_code = code
            worker.exited_at = now
            # exit 0 is a session that drained the queue
            expected = code == 0 or worker.state in (
                "draining", "quarantined")
            worker.state = "exited"
            # a crashed or killed worker's claims come back now; no refund:
            # a crash-shaped delivery keeps counting toward --max-retries.
            # A finished session (0) or a drain (143) handed its own back,
            # and a handle names the task, not the claim: releasing it
            # again would take the task from a worker that claimed it since
            released = 0
            if code not in (0, 143):
                released = self.queue.force_release(worker.handles)
            if released:
                telemetry.inc("fleet/leases_nacked", released)
            if worker.handles_truncated and code not in (0, 143):
                # /healthz capped the handle list: the leases past the cap
                # ride out the visibility timeout
                telemetry.inc("fleet/handles_truncated")
                telemetry.event(
                    "fleet", "fleet/handles_truncated",
                    fleet_worker=worker.ident, released=released,
                    inflight_leases=worker.inflight_leases,
                )
            worker.handles = []
            worker.handles_truncated = False
            worker.inflight_leases = 0
            telemetry.event(
                "fleet", "fleet/exit", fleet_worker=worker.ident,
                exit_code=code, uptime_s=round(now - worker.started, 3),
                expected=expected,
            )
            if not expected:
                telemetry.inc("fleet/worker_deaths")
                self._deaths.append(now)
        # a crash loop (crash_limit deaths inside crash_window) backs
        # respawning off
        self._deaths = [t for t in self._deaths
                        if now - t <= self.crash_window]
        if len(self._deaths) >= self.crash_limit \
                and now >= self._backoff_until:
            self._backoff_until = now + self.crash_backoff
            telemetry.inc("fleet/crash_backoffs")
            telemetry.event(
                "fleet", "fleet/crash_backoff",
                deaths=len(self._deaths), backoff_s=self.crash_backoff,
            )

    # -- the controller -------------------------------------------------
    def _fleet_dominant(self) -> Optional[dict]:
        """The share-weighted dominant stall phase over the active
        workers' last probes (None until one reports)."""
        totals: Dict[str, float] = {}
        for worker in self.workers:
            if worker.active and worker.dominant_stall:
                phase = worker.dominant_stall.get("phase")
                share = float(worker.dominant_stall.get("share", 0.0))
                if phase:
                    totals[phase] = totals.get(phase, 0.0) + share
        if not totals:
            return None
        phase = max(totals, key=totals.get)
        n = sum(1 for w in self.workers
                if w.active and w.dominant_stall)
        return {"phase": phase, "share": totals[phase] / n}

    def _storage_hit_rate(self) -> Optional[float]:
        """The fleet's storage block cache hit rate from the last scrapes;
        None when no active worker reports the counters."""
        hits = misses = 0.0
        seen = False
        for worker in self.workers:
            if worker.active and worker.storage_cache is not None:
                seen = True
                hits += worker.storage_cache.get("hits", 0.0)
                misses += worker.storage_cache.get("misses", 0.0)
        if not seen or hits + misses <= 0:
            return None
        return hits / (hits + misses)

    def _mem_ok(self) -> bool:
        available = self.mem_probe()
        if available is None:
            return True  # no procfs: the watermark cannot gate
        telemetry.gauge("fleet/host_available_gb", round(available, 3))
        est = self.worker_mem_est_gb
        rss = [r for r in (_proc_rss_gb(getattr(w.proc, "pid", -1))
                           for w in self.workers if w.active)
               if r is not None]
        if rss:
            est = max(est, sum(rss) / len(rss))
        return available - est >= self.mem_watermark_gb

    def _dead_letter_surging(self, stats: dict, now: float) -> bool:
        dead = stats.get("dead")
        if dead is None:
            return False
        if self._last_dead is not None and dead > self._last_dead:
            self._recent_dead.append((now, dead - self._last_dead))
        self._last_dead = dead
        window = self.interval * 5
        self._recent_dead = [(t, d) for t, d in self._recent_dead
                             if now - t <= window]
        return sum(d for _, d in self._recent_dead) >= self.dead_letter_surge

    def _fleet_slo_firing(self) -> List[str]:
        """The firing SLO objectives over the active workers' last
        scrapes: what every scale or hold event carries (an annotation;
        the controller does not act on it)."""
        firing: set = set()
        for worker in self.workers:
            if worker.active:
                firing.update(worker.slo_firing)
        return sorted(firing)

    def _slo_attrs(self) -> dict:
        firing = self._fleet_slo_firing()
        return {"slo_firing": firing} if firing else {}

    def _hold(self, reason: str) -> None:
        telemetry.inc("fleet/holds")
        telemetry.event("fleet", "fleet/hold", reason=reason,
                        **self._slo_attrs())

    def _decide(self, stats: dict, now: float) -> None:
        """One controller tick: move ``self.target`` by at most one."""
        if self.static:
            self.target = self.min_workers
            return
        active = sum(1 for w in self.workers if w.active)
        pending = stats.get("pending")
        inflight = stats.get("inflight")
        dead_surge = self._dead_letter_surging(stats, now)

        # down: idle for idle_ticks straight
        if pending == 0 and inflight == 0:
            self._idle_count += 1
        else:
            self._idle_count = 0
        if self._idle_count >= self.idle_ticks \
                and self.target > self.min_workers:
            telemetry.inc("fleet/scale_down")
            telemetry.event(
                "fleet", "fleet/scale", direction="down",
                target=self.min_workers, reason="idle-queue",
                **self._slo_attrs(),
            )
            self.target = self.min_workers
            return

        # up: a deep queue, one worker a tick, unless held
        if pending is None or self.target >= self.max_workers:
            return
        if pending <= self.scale_up_backlog * max(1, active):
            return
        if dead_surge:
            self._hold("dead-letter-surge")
            return
        dominant = self._fleet_dominant()
        if dominant and dominant["phase"] in STORAGE_BOUND_PHASES \
                and dominant["share"] >= self.storage_hold_share:
            # a cold block cache is re-fetch traffic the cache absorbs; a
            # warm one still storage-bound means the store is the limit
            reason = f"storage-bound:{dominant['phase']}"
            hit_rate = self._storage_hit_rate()
            if hit_rate is not None:
                reason += (":cold-cache"
                           if hit_rate < self.cache_warm_share
                           else ":load-bound")
            self._hold(reason)
            return
        if not self._mem_ok():
            self._hold("memory-watermark")
            return
        if now < self._backoff_until:
            self._hold("crash-backoff")
            return
        self.target += 1
        telemetry.inc("fleet/scale_up")
        telemetry.event(
            "fleet", "fleet/scale", direction="up", target=self.target,
            reason="deep-queue", pending=pending,
            dominant=(dominant or {}).get("phase"),
            **self._slo_attrs(),
        )

    def _enact(self, now: float) -> None:
        active = [w for w in self.workers if w.active]
        if len(active) > self.target:
            # drain the newest first: the eldest keep their warm caches
            for worker in sorted(active, key=lambda w: w.started,
                                 reverse=True)[: len(active) - self.target]:
                telemetry.inc("fleet/scale_down_drains")
                self._drain(worker, now)
        elif len(active) < self.target and now >= self._backoff_until:
            for _ in range(self.target - len(active)):
                self.spawn_worker()

    # -- state + the loop -----------------------------------------------
    def write_state(self) -> Optional[str]:
        """The fleet-state JSON ``fleet-status`` reads, written
        atomically: every worker this supervisor owned."""
        if self.state_path is None:
            return None
        payload = {
            "t": time.time(),
            "queue": self.queue_spec,
            "static": self.static,
            "target": self.target,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "supervisor_pid": os.getpid(),
            "workers": [w.to_record() for w in self.workers],
        }
        os.makedirs(os.path.dirname(self.state_path) or ".", exist_ok=True)
        tmp = f"{self.state_path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, self.state_path)
        return self.state_path

    def step(self) -> dict:
        """One decision interval: reap, probe, drill, decide, enact,
        publish. Returns the queue stats the decision used."""
        now = time.time()
        self._reap(now)
        self._enforce_drain_deadlines(now)
        for worker in self.workers:
            self._probe(worker, now)
        self._maybe_drill(now)
        try:
            stats = self.queue.stats()
        except Exception:  # a flaky queue tick must not kill the fleet
            stats = {"pending": None, "inflight": None, "dead": None,
                     "receives": None}
        self._decide(stats, now)
        self._enact(now)
        active = sum(1 for w in self.workers if w.active)
        telemetry.gauge("fleet/workers", active)
        telemetry.gauge("fleet/target", self.target)
        if stats.get("pending") is not None:
            telemetry.gauge("fleet/pending", stats["pending"])
        if stats.get("inflight") is not None:
            telemetry.gauge("fleet/inflight", stats["inflight"])
        self.write_state()
        return stats

    def _drained(self, stats: dict) -> bool:
        pending = stats.get("pending")
        inflight = stats.get("inflight")
        if inflight is None:  # the backend cannot say: the probed leases
            if not self.probing:
                # blind: pending == 0 is a guess, which _settle_target
                # makes persist longer
                return pending == 0
            # a draining or quarantined worker keeps its last leases until
            # it is reaped: sum over every running worker
            inflight = sum(w.inflight_leases for w in self.workers
                           if w.running)
        return pending == 0 and inflight == 0

    def _settle_target(self, stats: dict, settle_ticks: int) -> int:
        """Drained ticks in a row that end the run: longer when neither
        the backend nor probes can see claimed tasks."""
        if stats.get("inflight") is not None or self.probing:
            return settle_ticks
        return max(3 * settle_ticks, settle_ticks + 3)

    def run(self, max_runtime: float = 3600.0, settle_ticks: int = 2,
            shutdown_on_drain: bool = True) -> dict:
        """Supervise until the queue drains (``pending == inflight == 0``
        for ``settle_ticks`` ticks), :meth:`stop`, or ``max_runtime``.
        With ``shutdown_on_drain=False`` the fleet is left running at its
        target size; call :meth:`shutdown` after."""
        self.build_kernels()
        deadline = time.time() + max_runtime
        settled = 0
        telemetry.event(
            "fleet", "fleet/start", queue=self.queue_spec,
            static=self.static, min=self.min_workers, max=self.max_workers,
        )
        try:
            while not self._stop.is_set() and time.time() < deadline:
                stats = self.step()
                settled = settled + 1 if self._drained(stats) else 0
                if settled >= self._settle_target(stats, settle_ticks):
                    break
                self._stop.wait(self.interval)
        except BaseException:
            self.shutdown()  # never leave orphan workers behind
            raise
        if shutdown_on_drain:
            self.shutdown()
        else:
            self.write_state()
        return self.summary()

    def stop(self) -> None:
        self._stop.set()

    def shutdown(self) -> None:
        """SIGTERM every worker (each nacks and flushes), SIGKILL those
        past ``term_grace``, reap, write the final state file."""
        now = time.time()
        for worker in self.workers:
            if worker.running and worker.state != "draining":
                self._drain(worker, now)
        deadline = now + self.term_grace
        while time.time() < deadline and any(
                w.running for w in self.workers):
            time.sleep(0.05)
        for worker in self.workers:
            if worker.running:
                try:
                    worker.proc.kill()
                except OSError:
                    pass
        for worker in self.workers:
            if worker.exit_code is None:
                try:
                    worker.proc.wait(timeout=5.0)
                except Exception:
                    pass
        self._reap(time.time())
        self.write_state()
        telemetry.event("fleet", "fleet/stop")

    def summary(self) -> dict:
        counters = telemetry.snapshot()["counters"]
        return {
            "target": self.target,
            "alive": sum(1 for w in self.workers if w.active),
            "spawned": self._seq,
            "scale_ups": counters.get("fleet/scale_up", 0),
            "scale_downs": counters.get("fleet/scale_down", 0),
            "evictions": counters.get("fleet/evictions", 0),
            "worker_deaths": counters.get("fleet/worker_deaths", 0),
            "drill_preemptions": counters.get("fleet/drill_preemptions", 0),
            "leases_nacked": counters.get("fleet/leases_nacked", 0),
            "holds": counters.get("fleet/holds", 0),
            "static": self.static,
        }
