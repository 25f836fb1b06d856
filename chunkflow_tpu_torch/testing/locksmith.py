"""Locksmith: an opt-in runtime lock-order/deadlock sanitizer.

The counterpart of ``chunkflow_tpu/testing/locksmith.py``, with its
names and behaviour. Real deadlocks are usually CROSS-module: the serving
front end holding its admission lock into the scheduler's watermark
lock, a heartbeat thread renewing into a queue another thread drains.
With ``CHUNKFLOW_LOCKSMITH=1``, :func:`install` replaces
``threading.Lock``/``RLock``/``Condition`` construction with
instrumented proxies (scoped to this codebase's frames,
``CHUNKFLOW_LOCKSMITH_SCOPE``, default ``"chunkflow_tpu_torch,tests"``,
so torch and stdlib internals stay untouched), records which locks each
thread holds at every acquisition, and maintains a process-global
lock-order graph:

* an acquisition that would close a CYCLE in the graph (the classic
  AB/BA inversion, directly or through intermediate locks) raises
  :class:`LockOrderError` *before* acquiring (``CHUNKFLOW_LOCKSMITH_MODE``
  ``raise``, the default) or records it (``log``), provided the
  conflicting orders were observed from at least two distinct threads
  (a single thread running both orders sequentially cannot deadlock
  against itself);
* a plain ``Lock`` re-acquired by its owning thread with an unbounded
  blocking acquire is a guaranteed self-deadlock and raises
  immediately;
* a hold time over ``CHUNKFLOW_LOCKSMITH_HOLD_MS`` (off by default:
  wall-clock ceilings flake on loaded machines) is recorded and
  counted.

The proxies wrap the interpreter's own locks (``_thread.allocate_lock``,
``_thread.RLock``, and the ``threading.Condition`` class taken from a
``threading.Event``'s condition), never whatever ``threading.Lock`` is
at import: another sanitizer installed first (the JAX package's, in a
process that runs both packages) is not nested inside this one.
:func:`uninstall` restores the constructors :func:`install` replaced.
Install it before importing the rest of the port, so module-level locks
(the telemetry registry, the profiling state, the scheduler) are
covered too.

The kill switch is absolute: with ``CHUNKFLOW_LOCKSMITH`` unset or 0,
:func:`install` is a no-op: no proxies, no graph, no files (locksmith
never writes files in any mode; :func:`report` returns the graph, and
the ``locksmith/*`` telemetry counters are published by :func:`publish`
and on violations only, keeping the per-acquire path free of telemetry
traffic). Imports nothing of torch; the port's telemetry is imported
lazily, on the rare violation path.
"""
from __future__ import annotations

import _thread
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderError", "enabled", "install", "uninstall", "installed",
    "report", "publish", "reset_state",
]

_OFF_VALUES = ("", "0", "off", "false", "no")

#: the interpreter's own constructors, whatever ``threading`` holds now:
#: a ``threading.Event``'s condition is a real ``Condition`` whichever
#: factory made it
_ORIG_LOCK = _thread.allocate_lock
_ORIG_RLOCK = _thread.RLock
_ORIG_CONDITION = type(threading.Event()._cond)

#: the constructors :func:`install` replaced, restored by :func:`uninstall`
_saved: Optional[tuple] = None
_installed = False
_active = False  # proxies record only while True (survives uninstall)


class LockOrderError(RuntimeError):
    """A lock acquisition that closes a cycle in the observed
    lock-order graph (potential deadlock), or a plain-lock
    self-deadlock. Raised BEFORE the offending acquire, so the program
    is left in a consistent state."""


def enabled() -> bool:
    """The master switch (``CHUNKFLOW_LOCKSMITH``), re-read per call."""
    return os.environ.get(
        "CHUNKFLOW_LOCKSMITH", "").lower() not in _OFF_VALUES


def _mode() -> str:
    return os.environ.get("CHUNKFLOW_LOCKSMITH_MODE", "raise")


def _hold_ceiling_s() -> float:
    """Hold-time ceiling in seconds; 0 disables the clock entirely."""
    raw = os.environ.get("CHUNKFLOW_LOCKSMITH_HOLD_MS", "").strip()
    try:
        return max(0.0, float(raw)) / 1e3 if raw else 0.0
    except ValueError:
        return 0.0


def _scope() -> Tuple[str, ...]:
    raw = os.environ.get("CHUNKFLOW_LOCKSMITH_SCOPE",
                         "chunkflow_tpu_torch,tests")
    return tuple(s.strip() for s in raw.split(",") if s.strip())


def _creation_site() -> Optional[str]:
    """``file:line`` of the frame constructing the lock, or None when
    the construction is outside the instrumented scope (stdlib, torch,
    site-packages): out-of-scope constructions get real locks."""
    frame = sys._getframe(2)
    filename = frame.f_code.co_filename
    if not any(part in filename for part in _scope()):
        return None
    return f"{filename}:{frame.f_lineno}"


# ---------------------------------------------------------------------------
# the registry: per-thread held stacks + the global order graph
# ---------------------------------------------------------------------------
class _Held:
    __slots__ = ("lock_id", "site", "count", "t0", "where")

    def __init__(self, lock_id: int, site: str, t0: float, where: str):
        self.lock_id = lock_id
        self.site = site
        self.count = 1
        self.t0 = t0
        self.where = where


class _Registry:
    def __init__(self):
        self._graph_lock = _ORIG_LOCK()  # never a proxy
        self._tls = threading.local()
        self._next_id = 0
        self._next_thread = 0
        #: lock id -> creation site
        self.lock_sites: Dict[int, str] = {}
        #: (a_id, b_id) -> {"threads": set, "where": str}  — "b acquired
        #: while holding a", first occurrence wins the location
        self.edges: Dict[Tuple[int, int], dict] = {}
        self.adj: Dict[int, Set[int]] = {}
        self.cycles: List[dict] = []
        self.hold_violations: List[dict] = []
        self.acquires = 0

    # -- bookkeeping ---------------------------------------------------
    def new_lock(self, site: str) -> int:
        with self._graph_lock:
            self._next_id += 1
            self.lock_sites[self._next_id] = site
            return self._next_id

    def _held(self) -> List[_Held]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _thread_token(self) -> int:
        """A never-reused per-thread identity. ``threading.get_ident()``
        is RECYCLED after a thread exits — under a long test suite a new
        thread routinely inherits a dead thread's ident, which would
        make two genuinely different threads look like one to the
        diversity check and silently suppress real inversions."""
        token = getattr(self._tls, "token", None)
        if token is None:
            with self._graph_lock:
                self._next_thread += 1
                token = self._next_thread
            self._tls.token = token
        return token

    @staticmethod
    def _call_site() -> str:
        """file:line of the first frame outside this module (skips the
        proxy's acquire/__enter__ plumbing)."""
        frame = sys._getframe(2)
        while frame is not None and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:
            return "<unknown>"
        return f"{frame.f_code.co_filename}:{frame.f_lineno}"

    # -- the checks ----------------------------------------------------
    def before_acquire(self, proxy, blocking: bool,
                       timeout: float) -> None:
        """Order-graph update + cycle check, BEFORE the real acquire."""
        if not _active:
            return
        held = self._held()
        self.acquires += 1
        for rec in held:
            if rec.lock_id == proxy._ls_id:
                if not proxy._ls_reentrant and blocking and timeout < 0:
                    self._violation(
                        kind="self-deadlock",
                        detail=(
                            f"thread {threading.current_thread().name!r} "
                            f"re-acquires non-reentrant lock "
                            f"{proxy._ls_site} it already holds — "
                            f"guaranteed deadlock"
                        ),
                        path=[proxy._ls_id],
                    )
                return  # reentrant: no new edges
        if not held:
            return
        new_id = proxy._ls_id
        where = self._call_site()
        ident = self._thread_token()
        pending = None
        # the violation itself (telemetry, raise) must run OUTSIDE the
        # graph lock: telemetry's registry lock is a proxy, and raising
        # through an acquired plain lock would wedge the registry
        with self._graph_lock:
            for rec in held:
                edge = (rec.lock_id, new_id)
                if rec.lock_id == new_id:
                    continue
                info = self.edges.get(edge)
                if info is None:
                    self.edges[edge] = {"threads": {ident},
                                        "where": where}
                    self.adj.setdefault(rec.lock_id, set()).add(new_id)
                else:
                    info["threads"].add(ident)
                if pending is not None:
                    continue
                path = self._find_path(new_id, rec.lock_id)
                if path is not None:
                    cycle = path + [new_id]
                    if self._thread_diverse(cycle, ident):
                        names = " -> ".join(
                            self.lock_sites.get(i, f"lock#{i}")
                            for i in cycle
                        )
                        pending = (cycle, names)
        if pending is not None:
            cycle, names = pending
            self._violation(
                kind="lock-order-cycle",
                detail=(
                    f"acquiring would close a lock-order cycle: {names} "
                    f"(at {where}) — two threads taking their first "
                    f"lock each can deadlock; pick one global order"
                ),
                path=cycle,
            )

    def note_acquired(self, proxy) -> None:
        if not _active:
            return
        held = self._held()
        for rec in held:
            if rec.lock_id == proxy._ls_id:
                rec.count += 1
                return
        t0 = time.perf_counter() if _hold_ceiling_s() else 0.0
        held.append(_Held(proxy._ls_id, proxy._ls_site, t0,
                          self._call_site()))

    def note_released(self, proxy, full: bool = False) -> None:
        if not _active:
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            rec = held[i]
            if rec.lock_id != proxy._ls_id:
                continue
            rec.count -= 1
            if full or rec.count <= 0:
                held.pop(i)
                ceiling = _hold_ceiling_s()
                if ceiling and rec.t0:
                    dt = time.perf_counter() - rec.t0
                    if dt > ceiling:
                        self._hold_violation(rec, dt)
            return

    # -- graph ---------------------------------------------------------
    def _find_path(self, start: int, goal: int) -> Optional[List[int]]:
        """A path start -> ... -> goal in the edge graph (caller holds
        the graph lock); None when unreachable."""
        stack = [(start, [start])]
        seen: Set[int] = set()
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self.adj.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _thread_diverse(self, cycle: List[int], ident: int) -> bool:
        """A cycle is a deadlock candidate only if its edges were
        observed from >= 2 distinct threads — one thread running both
        orders sequentially cannot deadlock against itself."""
        threads: Set[int] = {ident}
        for a, b in zip(cycle, cycle[1:]):
            info = self.edges.get((a, b))
            if info is not None:
                threads |= info["threads"]
        return len(threads) >= 2

    # -- violations ----------------------------------------------------
    def _violation(self, kind: str, detail: str, path: List[int]) -> None:
        record = {
            "kind": kind,
            "detail": detail,
            "path": path,
            "thread": threading.current_thread().name,
            "stack": "".join(traceback.format_stack(limit=12)),
        }
        self.cycles.append(record)
        try:
            from chunkflow_tpu_torch.core import telemetry

            telemetry.inc("locksmith/violations")
        except Exception:
            pass
        if _mode() == "raise":
            raise LockOrderError(detail)

    def _hold_violation(self, rec: _Held, dt: float) -> None:
        self.hold_violations.append({
            "lock": rec.site,
            "held_s": round(dt, 6),
            "acquired_at": rec.where,
            "thread": threading.current_thread().name,
        })
        try:
            from chunkflow_tpu_torch.core import telemetry

            telemetry.inc("locksmith/hold_violations")
        except Exception:
            pass


_registry = _Registry()


# ---------------------------------------------------------------------------
# proxies
# ---------------------------------------------------------------------------
class _ProxyBase:
    _ls_reentrant = False

    def __init__(self, inner, site: str):
        self._inner = inner
        self._ls_site = site
        self._ls_id = _registry.new_lock(site)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _registry.before_acquire(self, blocking, timeout)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _registry.note_acquired(self)
        return ok

    def release(self):
        self._inner.release()
        _registry.note_released(self)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<locksmith {type(self).__name__} of {self._inner!r}>"


class _LockProxy(_ProxyBase):
    """Instrumented ``threading.Lock``. Deliberately does NOT define
    ``_release_save``/``_acquire_restore``/``_is_owned``: Condition
    probes for them with try/except and falls back to its plain-lock
    protocol, which routes through ``acquire``/``release`` above."""


class _RLockProxy(_ProxyBase):
    """Instrumented ``threading.RLock``, including the private protocol
    Condition uses so ``Condition(rlock_proxy)`` works unchanged —
    ``wait`` shows up as a full release + re-acquire, which is exactly
    the lock-order semantics of waiting."""

    _ls_reentrant = True

    # Condition's RLock fast path ------------------------------------
    def _release_save(self):
        state = self._inner._release_save()
        _registry.note_released(self, full=True)
        return state

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        _registry.note_acquired(self)

    def _is_owned(self):
        return self._inner._is_owned()


# ---------------------------------------------------------------------------
# install / uninstall
# ---------------------------------------------------------------------------
def _make_lock():
    site = _creation_site()
    if site is None:
        return _ORIG_LOCK()
    return _LockProxy(_ORIG_LOCK(), site)


def _make_rlock():
    site = _creation_site()
    if site is None:
        return _ORIG_RLOCK()
    return _RLockProxy(_ORIG_RLOCK(), site)


def _make_condition(lock=None):
    if lock is None:
        site = _creation_site()
        if site is not None:
            lock = _RLockProxy(_ORIG_RLOCK(), site)
    return _ORIG_CONDITION(lock) if lock is not None \
        else _ORIG_CONDITION()


def install() -> bool:
    """Patch ``threading.Lock/RLock/Condition`` with proxy factories
    when :func:`enabled`; returns whether the sanitizer is live. A
    disabled install is a strict no-op: no proxies, no state, no files.
    Idempotent."""
    global _installed, _active, _saved
    if not enabled():
        return False
    if _installed:
        _active = True
        return True
    _saved = (threading.Lock, threading.RLock, threading.Condition)
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition
    _installed = True
    _active = True
    return True


def uninstall() -> None:
    """Restore the constructors :func:`install` replaced (a no-op when
    it is not installed). Already-created proxies keep working but stop
    recording."""
    global _installed, _active, _saved
    if _installed and _saved is not None:
        threading.Lock, threading.RLock, threading.Condition = _saved
    _saved = None
    _installed = False
    _active = False


def installed() -> bool:
    return _installed and _active


def reset_state() -> None:
    """Drop the recorded order graph and violations (tests). Existing
    proxies stay valid — their ids and creation sites persist; only the
    edges/cycles/hold records are cleared."""
    with _registry._graph_lock:
        _registry.edges.clear()
        _registry.adj.clear()
        _registry.cycles.clear()
        _registry.hold_violations.clear()
        _registry.acquires = 0


def report() -> dict:
    """Snapshot of the sanitizer's state: lock/edge/violation counts and
    the recorded violations (for tests, debugging, and end-of-run
    summaries). Never touches disk."""
    with _registry._graph_lock:
        return {
            "enabled": installed(),
            "locks": len(_registry.lock_sites),
            "acquires": _registry.acquires,
            "edges": len(_registry.edges),
            "violations": list(_registry.cycles),
            "hold_violations": list(_registry.hold_violations),
        }


def publish() -> None:
    """Fold the counts into the ``locksmith/*`` telemetry gauges. Done
    on demand, never per acquire, so the hot path stays free of telemetry
    traffic."""
    if not installed():
        return
    from chunkflow_tpu_torch.core import telemetry

    snap = report()
    telemetry.gauge("locksmith/locks", snap["locks"])
    telemetry.gauge("locksmith/acquires", snap["acquires"])
    telemetry.gauge("locksmith/edges", snap["edges"])
    telemetry.gauge("locksmith/violations", len(snap["violations"]))
    telemetry.gauge("locksmith/hold_violations",
                    len(snap["hold_violations"]))
