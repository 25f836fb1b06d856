"""The task lifecycle: leases, retries, dead-letter, ledger, preemption.

The counterpart of ``chunkflow_tpu/parallel/lifecycle.py``. The queue
delivers each task at least once; this layer makes its effects exactly
once:

* a **completion ledger** (:func:`open_ledger`): one done-marker per bbox
  string, ``memory://`` or a directory of ``<bbox>.done`` files (the JAX
  package's layout). A redelivered task whose bbox is marked is acked and
  skipped, so a run resumes by replaying its queue;
* **lease heartbeats**: a thread renews the visibility of every claimed
  task while it computes, so a slow task is not claimed twice;
* **retries and dead-letter**: a failed task's receive count bounds its
  retries; :func:`classify_error` splits transient from permanent errors;
  a retry waits a full-jitter exponential backoff on the visibility
  clock; a task past ``max_retries`` (or with a permanent error) moves to
  the dead-letter store with its reason;
* **preemption**: SIGTERM and SIGINT unwind into :func:`handle_failure`,
  which hands every claimed task back at once and flushes its writes.

``fetch-task-from-queue --max-retries/--lease-renew/--ledger`` builds a
:class:`LifecycleSupervisor`; ``delete-task-in-queue`` calls
:meth:`TaskLifecycle.commit`; ``flow/runtime.process_stream`` calls
:func:`handle_failure` when the stage chain dies and rebuilds the chain.
Counters: ``tasks/committed``, ``tasks/retried``, ``tasks/dead_lettered``,
``tasks/preempted``, ``tasks/surrendered``, ``lease/renewals``,
``lease/renew_failures``, ``lifecycle/renew_errors``,
``lifecycle/flush_failures``, ``ledger/skips``.
"""
from __future__ import annotations

import os
import random
import signal
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel.queues import QueueBase
from chunkflow_tpu_torch.testing import chaos

__all__ = [
    "TransientTaskError", "PermanentTaskError", "classify_error",
    "backoff_delay", "LedgerBase", "MemoryLedger", "FileLedger",
    "open_ledger", "LeaseRenewer", "TaskLifecycle", "LifecycleSupervisor",
    "inflight", "handle_failure", "tag_culprit", "surrender_task",
    "install_preemption_handler",
]


# ---------------------------------------------------------------------------
# error classification
# ---------------------------------------------------------------------------
class TransientTaskError(RuntimeError):
    """Raise to force a retry whatever the default classification."""


class PermanentTaskError(RuntimeError):
    """Raise to force a dead-letter whatever the retry budget."""


#: bad input or a programming error: the same on every retry, so the task
#: is dead-lettered at once. Everything else (IO, chaos) is transient.
_PERMANENT_TYPES = (
    PermanentTaskError, ValueError, TypeError, KeyError, IndexError,
    AttributeError, AssertionError, ZeroDivisionError, NotImplementedError,
)


def classify_error(exc: BaseException) -> str:
    """``"transient"`` (retry with backoff) or ``"permanent"``."""
    if isinstance(exc, (TransientTaskError, chaos.ChaosError)):
        return "transient"
    if isinstance(exc, _PERMANENT_TYPES):
        return "permanent"
    return "transient"


def backoff_delay(attempt: int, base: float = 0.5, cap: float = 60.0,
                  rng: Optional[random.Random] = None) -> float:
    """Exponential backoff with full jitter: uniform in
    ``[0, min(cap, base * 2**(attempt-1))]``."""
    ceiling = min(cap, base * (2 ** max(0, attempt - 1)))
    draw = rng.random() if rng is not None else random.random()
    return draw * ceiling


# ---------------------------------------------------------------------------
# completion ledger
# ---------------------------------------------------------------------------
class LedgerBase:
    """Done-markers keyed by task body (the bbox string); ``mark_done`` is
    idempotent: one marker per key however often a task commits."""

    def is_done(self, key: str) -> bool:
        raise NotImplementedError

    def mark_done(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> List[str]:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        return self.is_done(key)

    def __len__(self) -> int:
        return len(self.keys())


class MemoryLedger(LedgerBase):
    """An in-process ledger, shared by name."""

    _registry: Dict[str, "MemoryLedger"] = {}

    def __init__(self, name: str = ""):
        self.name = name
        self._done: Dict[str, float] = {}
        self._lock = threading.Lock()

    @classmethod
    def open(cls, name: str) -> "MemoryLedger":
        if name not in cls._registry:
            cls._registry[name] = cls(name)
        return cls._registry[name]

    def is_done(self, key: str) -> bool:
        with self._lock:
            return key in self._done

    def mark_done(self, key: str) -> None:
        with self._lock:
            self._done.setdefault(key, time.time())

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._done)


class FileLedger(LedgerBase):
    """One ``<dir>/<key>.done`` file per committed task, written through a
    temporary and a rename, so a marker is never torn."""

    SUFFIX = ".done"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key.replace(os.sep, "_") + self.SUFFIX)

    def is_done(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def mark_done(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            return
        tmp = os.path.join(self.dir, f".tmp-{os.getpid()}-{id(self)}")
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, path)

    def keys(self) -> List[str]:
        return sorted(name[:-len(self.SUFFIX)]
                      for name in os.listdir(self.dir)
                      if name.endswith(self.SUFFIX))


def open_ledger(spec: str) -> LedgerBase:
    """``memory://name`` or ``file:///dir`` (a bare path is a directory)."""
    if spec.startswith("memory://"):
        return MemoryLedger.open(spec[len("memory://"):])
    if spec.startswith("file://"):
        spec = spec[len("file://"):]
    return FileLedger(spec)


# ---------------------------------------------------------------------------
# lease heartbeats
# ---------------------------------------------------------------------------
def _renew_with_retry(queue: QueueBase, handle: str,
                      timeout: Optional[float] = None, attempts: int = 3,
                      base: float = 0.05) -> bool:
    """One renewal, retried in place on a raised error; a renewal that
    gives up is counted (the lease may be lost; the ledger makes the
    duplicate effect-free), never fatal."""
    for attempt in range(1, attempts + 1):
        try:
            with telemetry.span("lifecycle/renew"):
                queue.renew(handle, timeout)
            telemetry.inc("lease/renewals")
            return True
        except Exception:
            telemetry.inc("lifecycle/renew_errors")
            if attempt < attempts:
                time.sleep(base * (2 ** (attempt - 1)))
    telemetry.inc("lease/renew_failures")
    return False


class LeaseRenewer:
    """A daemon thread that renews one claim every ``interval`` seconds."""

    def __init__(self, queue: QueueBase, handle: str, interval: float,
                 timeout: Optional[float] = None):
        self.queue = queue
        self.handle = handle
        self.interval = max(0.05, float(interval))
        self.timeout = timeout
        self.renewals = 0
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"lease-renewer-{handle[:8]}")

    def start(self) -> "LeaseRenewer":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if _renew_with_retry(self.queue, self.handle, self.timeout):
                with self._count_lock:
                    self.renewals += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)


class _Heartbeat:
    """One renewal thread per supervisor: every ``interval`` seconds it
    renews each of the supervisor's in-flight claims (several ride
    between claim and ack in a streamed worker)."""

    def __init__(self, supervisor: "LifecycleSupervisor", interval: float):
        self.supervisor = supervisor
        self.interval = max(0.05, float(interval))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lease-heartbeat")

    def start(self) -> "_Heartbeat":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                for lc in inflight():
                    if lc.supervisor is self.supervisor and not lc.done:
                        _renew_with_retry(self.supervisor.queue, lc.handle)
            except Exception:
                # nothing may end the only renewal thread
                telemetry.inc("lifecycle/renew_errors")

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# in-flight registry: process_stream consults it when the chain dies
# ---------------------------------------------------------------------------
_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT: Dict[int, "TaskLifecycle"] = {}


def inflight() -> List["TaskLifecycle"]:
    """Claimed, unacked supervised tasks, oldest first."""
    with _INFLIGHT_LOCK:
        return list(_INFLIGHT.values())


def _register(lc: "TaskLifecycle") -> None:
    with _INFLIGHT_LOCK:
        _INFLIGHT[id(lc)] = lc


def _unregister(lc: "TaskLifecycle") -> None:
    with _INFLIGHT_LOCK:
        _INFLIGHT.pop(id(lc), None)


# ---------------------------------------------------------------------------
# one claimed task
# ---------------------------------------------------------------------------
class TaskLifecycle:
    """One claim's state, attached to its task as ``task["lifecycle"]``.
    Exactly one terminal transition per claim: :meth:`commit`,
    :meth:`release` or :meth:`surrender`."""

    def __init__(self, supervisor: "LifecycleSupervisor", handle: str,
                 body: str, receives: int):
        self.supervisor = supervisor
        self.queue = supervisor.queue
        self.handle = handle
        self.body = body
        self.receives = receives
        self.trace_id = self.queue.trace_id(handle)
        self.task: Optional[dict] = None
        self.renewer: Optional[LeaseRenewer] = None
        self.done = False

    def _finish(self) -> None:
        self.done = True
        if self.renewer is not None:
            self.renewer.stop()
        _unregister(self)

    def commit(self, task: Optional[dict] = None) -> None:
        """The commit point, ack after durable write: drain the task's
        writes, mark the ledger, then ack. A crash before the marker
        recomputes the task (the writes are idempotent); a crash after it
        redelivers it once and skips it."""
        if self.done:
            return
        from chunkflow_tpu_torch.flow.runtime import drain_pending_writes

        with telemetry.task_context(self.trace_id):
            with telemetry.span("lifecycle/commit"):
                drain_pending_writes(task if task is not None else self.task)
                chaos.chaos_point("lifecycle/pre_ledger")
                if self.supervisor.ledger is not None:
                    self.supervisor.ledger.mark_done(self.body)
                chaos.chaos_point("lifecycle/pre_ack")
                self.queue.delete(self.handle)
            telemetry.inc("tasks/committed")
            telemetry.event("task", "lifecycle/committed", body=self.body,
                            receives=self.receives)
        self._finish()

    def _flush_writes(self) -> None:
        """Drain the task's pending writes on a failure path; a failed
        write is counted, not raised (the task retries anyway)."""
        from chunkflow_tpu_torch.flow.runtime import drain_pending_writes

        try:
            drain_pending_writes(self.task)
        except Exception:
            telemetry.inc("lifecycle/flush_failures")

    def release(self, exc: BaseException) -> str:
        """The failure transition: ``"preempted"`` (nacked, the worker is
        exiting), ``"retried"`` (backoff on the visibility clock) or
        ``"dead"`` (dead-lettered)."""
        if self.done:
            return "done"
        self._finish()
        with telemetry.task_context(self.trace_id), \
                telemetry.span("lifecycle/release"):
            if isinstance(exc, (KeyboardInterrupt, SystemExit,
                                GeneratorExit)):
                self.queue.nack(self.handle)
                telemetry.inc("tasks/preempted")
                telemetry.event("task", "lifecycle/preempted",
                                body=self.body, receives=self.receives)
                self._flush_writes()
                return "preempted"
            self._flush_writes()
            reason = f"{type(exc).__name__}: {exc}"
            kind = classify_error(exc)
            if kind == "permanent" or (
                    0 <= self.supervisor.max_retries <= self.receives):
                self.queue.dead_letter(
                    self.handle, reason=f"{reason} (receives={self.receives}, "
                                        f"classified {kind})")
                telemetry.inc("tasks/dead_lettered")
                telemetry.event("task", "lifecycle/dead_letter",
                                body=self.body, receives=self.receives,
                                reason=reason[:200])
                return "dead"
            delay = backoff_delay(self.receives,
                                  base=self.supervisor.backoff_base,
                                  cap=self.supervisor.backoff_cap,
                                  rng=self.supervisor.rng)
            # the claim stays, invisible for the backoff: the task
            # reappears by itself, whatever happens to this worker
            self.queue.renew(self.handle, delay)
            telemetry.inc("tasks/retried")
            telemetry.event("task_retry", "lifecycle/retry", body=self.body,
                            receives=self.receives, backoff_s=round(delay, 3),
                            error=reason[:200])
            return "retried"

    def surrender(self) -> str:
        """A bystander's transition: another task's failure tore down the
        shared chain. Hand the claim back now, with no failure recorded
        and the receive refunded."""
        if self.done:
            return "done"
        self._finish()
        self.queue.nack(self.handle)
        self._flush_writes()
        with telemetry.task_context(self.trace_id):
            telemetry.inc("tasks/surrendered")
            telemetry.event("task", "lifecycle/surrendered", body=self.body,
                            receives=self.receives)
        return "surrendered"


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------
class LifecycleSupervisor:
    """Policy and claim loop: each queue delivery becomes a supervised
    :class:`TaskLifecycle`. ``max_retries``: failed deliveries before the
    dead-letter store (negative: no bound); ``lease_renew``: heartbeat
    interval in seconds (0: none); ``ledger``: a :class:`LedgerBase` or
    None."""

    def __init__(self, queue: QueueBase, ledger: Optional[LedgerBase] = None,
                 max_retries: int = 3, lease_renew: float = 0.0,
                 backoff_base: float = 0.5, backoff_cap: float = 60.0,
                 seed: Optional[int] = None):
        self.queue = queue
        self.ledger = ledger
        self.max_retries = int(max_retries)
        self.lease_renew = float(lease_renew)
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.rng = random.Random(seed)

    def claim(self, handle: str, body: str) -> Optional[TaskLifecycle]:
        """One delivery as a lifecycle, or None when it is settled at
        claim time (a ledger skip, a crash-loop dead-letter)."""
        with telemetry.task_context(self.queue.trace_id(handle)), \
                telemetry.span("lifecycle/claim"):
            if self.ledger is not None and self.ledger.is_done(body):
                self.queue.delete(handle)
                telemetry.inc("ledger/skips")
                telemetry.event("task", "lifecycle/ledger_skip", body=body)
                return None
            receives = self.queue.receive_count(handle) or 1
            if self.max_retries >= 0 and receives > max(self.max_retries, 1):
                # redelivered past the budget with no recorded failure:
                # every earlier attempt died mid-task (a crash loop)
                reason = (f"receive count {receives} exceeds max retries "
                          f"{self.max_retries} with no recorded failure "
                          f"(worker crash loop)")
                self.queue.dead_letter(handle, reason=reason)
                telemetry.inc("tasks/dead_lettered")
                telemetry.event("task", "lifecycle/dead_letter", body=body,
                                receives=receives, reason=reason)
                return None
            lc = TaskLifecycle(self, handle, body, receives)
            _register(lc)
            telemetry.event("task", "lifecycle/claimed", body=body,
                            receives=receives)
            # after registration: a fault injected here is released (a
            # fast retry), not leaked to the visibility timeout, and it is
            # charged to this claim alone
            try:
                chaos.chaos_point("lifecycle/claim")
            except BaseException as exc:
                tag_culprit(exc, lc)
                raise
            return lc

    def tasks(self, num: int = -1) -> Iterator[TaskLifecycle]:
        """The claim loop: at most ``num`` lifecycles (< 0: drain), with
        the SIGTERM handler installed and the heartbeat running."""
        restore = install_preemption_handler()
        heartbeat = (_Heartbeat(self, self.lease_renew).start()
                     if self.lease_renew > 0 else None)
        count = 0
        try:
            for handle, body in self.queue:
                lc = self.claim(handle, body)
                if lc is None:
                    continue
                yield lc
                count += 1
                if 0 <= num <= count:
                    return
        finally:
            if heartbeat is not None:
                heartbeat.stop()
            restore()


# ---------------------------------------------------------------------------
# chain failure and preemption
# ---------------------------------------------------------------------------
def tag_culprit(exc: BaseException, owner) -> None:
    """Attach the task (dict) or lifecycle whose processing raised
    ``exc``; the first tag wins. Only the culprit is charged when the
    shared chain dies; the other in-flight tasks surrender."""
    if getattr(exc, "_chunkflow_culprit", None) is None:
        try:
            exc._chunkflow_culprit = owner
        except Exception:
            pass  # an exception type that refuses attributes


def _resolve_culprit(exc: BaseException,
                     lcs: List[TaskLifecycle]) -> Optional[TaskLifecycle]:
    owner = getattr(exc, "_chunkflow_culprit", None)
    if owner is None:
        return None
    for lc in lcs:
        if lc is owner or (lc.task is not None and lc.task is owner):
            return lc
    if isinstance(owner, dict) and owner.get("lifecycle") in lcs:
        return owner["lifecycle"]
    return None


def handle_failure(exc: BaseException) -> bool:
    """Settle every in-flight supervised task after the chain died with
    ``exc``. Preemption nacks them all and the worker exits; a task
    failure charges the tagged culprit (retry or dead-letter) and the
    others surrender; a failure with no culprit charges them all.

    True when the caller should rebuild the chain and go on; False when
    the failure must re-raise (nothing supervised in flight, or a
    preemption)."""
    lcs = inflight()
    if not lcs:
        return False
    preempt = isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit))
    culprit = None if preempt else _resolve_culprit(exc, lcs)
    for lc in lcs:
        try:
            if preempt or culprit is None or lc is culprit:
                lc.release(exc)
            else:
                lc.surrender()
        except Exception as release_exc:
            # a broken queue must not hide the original failure
            print(f"lifecycle: releasing task {lc.body!r} failed: "
                  f"{release_exc!r}", file=sys.stderr)
    return not preempt


def surrender_task(item) -> None:
    """Hand back the claim of a task dropped between stages at teardown
    (a prefetch thread can claim one more task after the failure handler
    settled the in-flight set). A no-op for anything that is not a
    supervised task, and for settled ones; never raises."""
    lc = item.get("lifecycle") if isinstance(item, dict) else None
    if lc is not None:
        try:
            lc.surrender()
        except Exception:
            pass


def install_preemption_handler():
    """Route SIGTERM into the supervision path as ``SystemExit(143)`` in
    the main thread (SIGINT already arrives as KeyboardInterrupt). Returns
    a callable that restores the previous handler; a no-op off the main
    thread."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    previous = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        raise SystemExit(143)

    try:
        signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):
        return lambda: None

    def restore():
        try:
            signal.signal(signal.SIGTERM, previous)
        except (ValueError, OSError, TypeError):
            pass

    return restore
