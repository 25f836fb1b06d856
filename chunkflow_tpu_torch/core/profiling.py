"""Bounded profiler capture: anomaly-triggered, operator-requested, windowed.

The counterpart of the capture half of ``chunkflow_tpu/core/profiling.py``
(its program cost ledger and roofline read XLA's cost analysis and stay
unported). Each capture is one ``torch.profiler`` session with CPU
activities, and CUDA activities where a card is present (CUPTI traces
the device work of every thread of the process), written as Chrome-format
``trace.json`` into ``profile-<reason>-<n>/`` under the metrics dir
(else ``CHUNKFLOW_PROFILE_DIR``). One session runs at a time.

* :func:`capture`: one bounded window; ``POST /profile?seconds=N``
  (``parallel/restapi.py``) calls it with ``force=True``.
* :func:`maybe_capture`: an automatic capture in a background thread,
  behind a cooldown (``CHUNKFLOW_PROFILE_COOLDOWN``, default 300 s) and
  the anomaly switch (``CHUNKFLOW_PROFILE_ON_ANOMALY``); fed by
  :func:`note_slo_page` (a page-severity SLO alert, ``core/slo.py``) and
  :func:`note_stall` (the depth controller's dominant stall at or above
  ``CHUNKFLOW_PROFILE_STALL_SHARE`` for ``CHUNKFLOW_PROFILE_STALL_TICKS``
  ticks on one phase, ``flow/scheduler.py``).
* :func:`start_task_window`: the CLI's ``--profile-dir`` session over
  the run's first ``--profile-tasks`` tasks (``CHUNKFLOW_PROFILE_TASKS``,
  default 4; <= 0 the whole run), closed by :func:`note_task_done`.

Window lengths: ``CHUNKFLOW_PROFILE_SECONDS`` (automatic, default 3)
and ``CHUNKFLOW_PROFILE_MAX_SECONDS`` (the cap, default 60).
``CHUNKFLOW_TELEMETRY=0`` captures nothing and creates nothing.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple

from chunkflow_tpu_torch.core import telemetry

__all__ = [
    "capture", "maybe_capture", "note_slo_page", "note_stall",
    "start_task_window", "note_task_done", "wait_for_captures",
    "capture_base_dir", "TRACE_FILE",
]

#: the Chrome-format trace each session writes into its directory
TRACE_FILE = "trace.json"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


_STATE_LOCK = threading.Lock()
_TRACE_ACTIVE = False  # one profiler session at a time, window or capture
_LAST_CAPTURE_T: Optional[float] = None  # monotonic, automatic cooldown
_CAPTURE_SEQ = 0
_CAPTURE_THREADS: list = []
_STALL_PHASE: Optional[str] = None
_STALL_TICKS = 0
_WINDOW = None


def capture_base_dir() -> Optional[str]:
    """Where captures land: the telemetry file's directory, else
    ``CHUNKFLOW_PROFILE_DIR``, else None (captures off)."""
    path = telemetry.configured_path()
    if path:
        return os.path.dirname(path)
    return os.environ.get("CHUNKFLOW_PROFILE_DIR") or None


def _anomaly_capture_enabled() -> bool:
    return os.environ.get("CHUNKFLOW_PROFILE_ON_ANOMALY", "1").lower() \
        not in ("0", "off", "false", "no")


def _acquire_trace() -> bool:
    global _TRACE_ACTIVE
    with _STATE_LOCK:
        if _TRACE_ACTIVE:
            return False
        _TRACE_ACTIVE = True
        return True


def _release_trace() -> None:
    global _TRACE_ACTIVE
    with _STATE_LOCK:
        _TRACE_ACTIVE = False


def _safe_name(reason: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "._-" else "-"
                   for ch in reason)[:48]


def _session():
    """A new, unstarted profiler session: CPU, and CUDA where a card is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _finish(session, target: str) -> None:
    """Stop ``session`` and write its trace into ``target``."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    session.stop()
    session.export_chrome_trace(os.path.join(target, TRACE_FILE))


def _run_capture(target: str, seconds: float, reason: str) -> bool:
    """One bounded profiler window into ``target``; the caller holds the
    trace flag. Never raises: a failed capture is an event."""
    try:
        os.makedirs(target, exist_ok=True)
        session = _session()
        session.start()
        try:
            time.sleep(seconds)
        finally:
            _finish(session, target)
    except Exception as exc:
        telemetry.inc("profile/capture_errors")
        telemetry.event("profile", "profile/capture_error", reason=reason,
                        error=str(exc)[:300])
        return False
    finally:
        _release_trace()
    telemetry.inc("profile/captures")
    telemetry.event("profile", "profile/capture", dir=target,
                    seconds=seconds, reason=reason)
    return True


def capture(seconds: float, reason: str, force: bool = False,
            background: bool = False) -> Tuple[Optional[str], Optional[str]]:
    """One bounded profiler window; returns ``(trace_dir, error)``.

    ``force=True`` (the ``/profile`` route) skips the automatic cooldown
    but never the one-session exclusion. ``background=True`` runs the
    window in a daemon thread. Telemetry off or no capture directory:
    ``(None, why)``."""
    global _TRACE_ACTIVE, _LAST_CAPTURE_T, _CAPTURE_SEQ
    if not telemetry.enabled():
        return None, "telemetry disabled (CHUNKFLOW_TELEMETRY=0)"
    base = capture_base_dir()
    if base is None:
        return None, ("no capture dir: run with --metrics-dir or set "
                      "CHUNKFLOW_PROFILE_DIR")
    seconds = min(max(float(seconds), 0.05),
                  _env_float("CHUNKFLOW_PROFILE_MAX_SECONDS", 60.0))
    cooldown = _env_float("CHUNKFLOW_PROFILE_COOLDOWN", 300.0)
    with _STATE_LOCK:
        if _TRACE_ACTIVE:
            return None, "a profiler session is already active"
        if (not force and _LAST_CAPTURE_T is not None
                and time.monotonic() - _LAST_CAPTURE_T < cooldown):
            return None, "capture cooldown in effect"
        _TRACE_ACTIVE = True
        _LAST_CAPTURE_T = time.monotonic()
        _CAPTURE_SEQ += 1
        seq = _CAPTURE_SEQ
    target = os.path.join(base, f"profile-{_safe_name(reason)}-{seq}")
    if background:
        thread = threading.Thread(target=_run_capture,
                                  args=(target, seconds, reason),
                                  name=f"chunkflow-profile-{seq}",
                                  daemon=True)
        _CAPTURE_THREADS.append(thread)
        thread.start()
        return target, None
    ok = _run_capture(target, seconds, reason)
    return (target, None) if ok else (None, "capture failed (see events)")


def maybe_capture(reason: str) -> bool:
    """An automatic capture in a background thread, behind the cooldown
    and ``CHUNKFLOW_PROFILE_ON_ANOMALY``; True when one started."""
    if not telemetry.enabled() or not _anomaly_capture_enabled():
        return False
    seconds = _env_float("CHUNKFLOW_PROFILE_SECONDS", 3.0)
    target, err = capture(seconds, reason, force=False, background=True)
    if target is None:
        if err != "capture cooldown in effect":
            telemetry.event("profile", "profile/capture_skipped",
                            reason=reason, why=err)
        return False
    return True


def note_slo_page(objective: str) -> None:
    """A page-severity SLO alert fired (``core/slo.py``): capture one
    window while the regression is live."""
    maybe_capture(f"slo-{_safe_name(objective)}")


def note_stall(phase: str, share: float) -> None:
    """One depth-controller tick's dominant stall (``flow/scheduler.py``):
    a share at or above ``CHUNKFLOW_PROFILE_STALL_SHARE`` (0.8) on the
    same phase for ``CHUNKFLOW_PROFILE_STALL_TICKS`` (3) consecutive
    ticks triggers one capture."""
    global _STALL_PHASE, _STALL_TICKS
    threshold = _env_float("CHUNKFLOW_PROFILE_STALL_SHARE", 0.8)
    need = _env_int("CHUNKFLOW_PROFILE_STALL_TICKS", 3)
    with _STATE_LOCK:
        if share < threshold:
            _STALL_PHASE, _STALL_TICKS = None, 0
            return
        if phase != _STALL_PHASE:
            _STALL_PHASE, _STALL_TICKS = phase, 1
        else:
            _STALL_TICKS += 1
        if _STALL_TICKS < need:
            return
        _STALL_PHASE, _STALL_TICKS = None, 0
    maybe_capture(f"stall-{_safe_name(phase)}")


def wait_for_captures(timeout: float = 10.0) -> None:
    """Join the background capture threads."""
    deadline = time.monotonic() + timeout
    for thread in list(_CAPTURE_THREADS):
        thread.join(timeout=max(0.0, deadline - time.monotonic()))
    _CAPTURE_THREADS[:] = [t for t in _CAPTURE_THREADS if t.is_alive()]


class _TaskWindow:
    """A profiler session over the first N pipeline tasks (N <= 0: the
    whole run, until :meth:`close`)."""

    def __init__(self, trace_dir: str, tasks: int):
        self.trace_dir = trace_dir
        self.remaining = tasks
        self.active = False
        self._session = None
        self._lock = threading.Lock()

    def _start(self) -> bool:
        if not _acquire_trace():
            return False
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._session = _session()
            self._session.start()
        except Exception as exc:
            _release_trace()
            telemetry.event("profile", "profile/window_error",
                            error=str(exc)[:300])
            return False
        self.active = True
        telemetry.event("profile", "profile/window_start",
                        dir=self.trace_dir, tasks=self.remaining)
        return True

    def note_task(self) -> None:
        with self._lock:
            if not self.active or self.remaining <= 0:
                return
            self.remaining -= 1
            if self.remaining <= 0:
                self._stop()

    def close(self) -> None:
        with self._lock:
            if self.active:
                self._stop()

    def _stop(self) -> None:
        """The caller holds ``self._lock``."""
        self.active = False
        try:
            _finish(self._session, self.trace_dir)
        except Exception as exc:
            telemetry.event("profile", "profile/window_error",
                            error=str(exc)[:300])
        finally:
            self._session = None
            _release_trace()
        telemetry.inc("profile/windows")
        telemetry.event("profile", "profile/window_stop",
                        dir=self.trace_dir)


def start_task_window(trace_dir: str,
                      tasks: Optional[int] = None) -> Optional[_TaskWindow]:
    """Start the ``--profile-dir`` session over the first ``tasks``
    tasks; None, creating nothing, when telemetry is off or another
    session is active."""
    global _WINDOW
    if not telemetry.enabled():
        return None
    if tasks is None:
        tasks = _env_int("CHUNKFLOW_PROFILE_TASKS", 4)
    window = _TaskWindow(trace_dir, tasks)
    if not window._start():
        return None
    _WINDOW = window
    return window


def note_task_done() -> None:
    """One pipeline task finished (``flow/runtime.process_stream``)."""
    window = _WINDOW
    if window is not None:
        window.note_task()


def _on_reset() -> None:
    global _LAST_CAPTURE_T, _STALL_PHASE, _STALL_TICKS, _WINDOW
    window = _WINDOW
    if window is not None:
        window.close()
    _WINDOW = None
    with _STATE_LOCK:
        _LAST_CAPTURE_T = None
        _STALL_PHASE, _STALL_TICKS = None, 0


telemetry.add_reset_hook(_on_reset)
