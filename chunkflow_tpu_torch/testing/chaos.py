"""Deterministic fault injection at the worker loop's stage boundaries.

The counterpart of ``chunkflow_tpu/testing/chaos.py``, with the same
``CHUNKFLOW_CHAOS`` grammar and the same points. Production code calls
:func:`chaos_point` at its stage boundaries; a seeded plan decides which
calls raise :class:`ChaosError`. Without a plan the call is a cheap
no-op, so the hooks stay in the code paths that ship.

Configuration (``CHUNKFLOW_CHAOS`` or :func:`configure`): fields
separated by ``:``, lists by ``,``, ``fnmatch`` patterns in point names::

    once=lifecycle/claim,op/inference,lifecycle/pre_ack
        kill each listed point exactly once (its first hit)
    seed=42:rate=0.25:points=op/*,scheduler/dispatch
        a seeded Bernoulli kill at every matching hit
    seed=7:rate=0.5:points=lifecycle/claim:max=3
        stop after 3 kills in all
    once=op/save-precomputed:action=kill
        SIGKILL the process on the spot instead of raising: nothing
        unwinds, no nack, no flush, as when a machine is preempted

Points: ``lifecycle/claim`` (claimed, before compute), ``op/<operator>``
(every runtime operator body, and the streamed inference stages at
dispatch), ``scheduler/dispatch`` / ``scheduler/post`` (the adaptive
scheduler), ``lifecycle/pre_ledger`` (writes durable, ledger not yet
marked), ``lifecycle/pre_ack`` (ledger marked, queue not yet acked).
:class:`ChaosError` is transient to the lifecycle supervisor: the task
retries, and the drained output must equal a fault-free run's.
"""
from __future__ import annotations

import os
import random
import signal
import threading
from fnmatch import fnmatchcase
from typing import Dict, List, Optional

from chunkflow_tpu_torch.core import telemetry

__all__ = ["ChaosError", "configure", "reset", "active", "chaos_point",
           "injections"]


class ChaosError(RuntimeError):
    """An injected fault. Transient by lifecycle classification."""


class _Plan:
    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        self.rate = 1.0
        self.points: List[str] = []
        self.once: List[str] = []
        self.max_kills: Optional[int] = None
        self.action = "raise"
        for field in spec.split(":"):
            field = field.strip()
            if not field:
                continue
            key, _, value = field.partition("=")
            key, value = key.strip(), value.strip()
            if key == "seed":
                self.seed = int(value)
            elif key == "rate":
                self.rate = float(value)
            elif key == "points":
                self.points = [p for p in value.split(",") if p]
            elif key == "once":
                self.once = [p for p in value.split(",") if p]
            elif key == "max":
                self.max_kills = int(value)
            elif key == "action":
                if value not in ("raise", "kill"):
                    raise ValueError(f"bad CHUNKFLOW_CHAOS action {value!r} "
                                     f"(want raise or kill)")
                self.action = value
            else:
                raise ValueError(f"bad CHUNKFLOW_CHAOS field {field!r} (want "
                                 f"seed=/rate=/points=/once=/max=/action=)")
        self.rng = random.Random(self.seed)
        self.fired_once: set = set()
        self.kills: Dict[str, int] = {}
        self.lock = threading.Lock()

    def strike(self, name: str) -> bool:
        with self.lock:
            if (self.max_kills is not None
                    and sum(self.kills.values()) >= self.max_kills):
                return False
            for pattern in self.once:
                if fnmatchcase(name, pattern) \
                        and pattern not in self.fired_once:
                    self.fired_once.add(pattern)
                    self.kills[name] = self.kills.get(name, 0) + 1
                    return True
            for pattern in self.points:
                if fnmatchcase(name, pattern):
                    # one draw per matching hit: the kill sequence is a
                    # function of (seed, hit order)
                    if self.rng.random() < self.rate:
                        self.kills[name] = self.kills.get(name, 0) + 1
                        return True
                    return False
            return False


_plan: Optional[_Plan] = None
_env_seen: Optional[str] = None
_state_lock = threading.Lock()


def configure(spec: Optional[str]) -> None:
    """Install a plan in code (tests). ``None`` or empty disables
    injection and detaches from the environment until :func:`reset`."""
    global _plan, _env_seen
    with _state_lock:
        _plan = _Plan(spec) if spec else None
        _env_seen = "<configured>"


def reset() -> None:
    """Drop any plan and read ``CHUNKFLOW_CHAOS`` again."""
    global _plan, _env_seen
    with _state_lock:
        _plan = None
        _env_seen = None


def _current_plan() -> Optional[_Plan]:
    global _plan, _env_seen
    env = os.environ.get("CHUNKFLOW_CHAOS", "")
    with _state_lock:
        if _env_seen == "<configured>":
            return _plan
        if env != _env_seen:
            _env_seen = env
            _plan = _Plan(env) if env else None
        return _plan


def active() -> bool:
    return _current_plan() is not None


def _die() -> None:  # pragma: no cover - the process is gone
    """``action=kill``: die now, as a preempted machine does."""
    try:
        os.kill(os.getpid(), signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    os._exit(137)


def chaos_point(name: str) -> None:
    """A kill-able stage boundary: a no-op without a plan; raises
    :class:`ChaosError` (or SIGKILLs the process under ``action=kill``)
    when the plan strikes."""
    plan = _current_plan()
    if plan is None or not plan.strike(name):
        return
    telemetry.inc("chaos/injected")
    if plan.action == "kill":
        _die()
    raise ChaosError(f"chaos injected at {name} (kill "
                     f"#{sum(plan.kills.values())}, spec {plan.spec!r})")


def injections() -> Dict[str, int]:
    """Kills per point under the current plan (empty when inactive)."""
    plan = _current_plan()
    return dict(plan.kills) if plan else {}
