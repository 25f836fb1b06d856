"""SLO plane: declarative objectives, error budgets, burn-rate alerting.

The counterpart of ``chunkflow_tpu/core/slo.py``, with the same
objectives, rules, configuration and outputs:

* **Objectives**: a name, a target share of good events, and where the
  events come from: summed registry counters (``kind="ratio"``:
  availability, deadline misses, dead letters, storage hits) or a
  quantile histogram and a latency threshold (``kind="latency"``: "99%
  of requests within 500 ms"). :data:`DEFAULT_OBJECTIVES` cover the
  serving plane; a ``[tool.chunkflow.slo]`` pyproject table or a
  ``--slo-config`` TOML file overrides targets, thresholds and windows,
  or disables objectives.
* **Error budgets**: ``1 - target`` of the events over a rolling period
  (30 days, times the config's ``scale``); ``budget_remaining`` is 1.0
  untouched, 0.0 spent, negative when blown.
* **Burn-rate alerts**, multi-window: an alert fires when the burn rate
  (bad share over budget share) exceeds a rule's threshold over both its
  long and its short window. ``fast``: 14.4x over 1 h and 5 min (page);
  ``slow``: 1x over 3 d and 6 h (ticket).
* **Outputs**: one ``alert`` event per rising edge and one
  ``state="resolved"`` per falling edge; ``slo/<objective>/burn_rate``,
  ``budget_remaining`` and ``firing`` gauges (``chunkflow_slo_*`` on
  ``/metrics``); the ``/alerts`` route (``parallel/restapi.py``); and, at
  page severity, one bounded profiler capture
  (:func:`chunkflow_tpu_torch.core.profiling.note_slo_page`).

The evaluator samples the registry on the telemetry time-series tick
(:func:`chunkflow_tpu_torch.core.telemetry.add_tick_hook`) into a
bounded ring; window deltas are differences of cumulative counts, so
the burn arithmetic does not depend on tick jitter. ``CHUNKFLOW_TELEMETRY=0``
or ``CHUNKFLOW_SLO=0`` creates no evaluator, no thread, no events and no
route.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from chunkflow_tpu_torch.core import telemetry

__all__ = [
    "Objective", "BurnRule", "SLOEvaluator", "DEFAULT_OBJECTIVES",
    "DEFAULT_RULES", "DEFAULT_PERIOD_S", "load_slo_config",
    "evaluator_from_config", "start_slo", "stop_slo", "current",
    "slo_enabled",
]

_OFF_VALUES = ("0", "off", "false", "no")

#: 30 days — the canonical SRE budget period; ``scale`` compresses it
DEFAULT_PERIOD_S = 30 * 86400.0


def slo_enabled() -> bool:
    """The SLO plane runs only when telemetry does; ``CHUNKFLOW_SLO=0``
    additionally disables just this plane (timeseries history stays)."""
    if not telemetry.enabled():
        return False
    return os.environ.get(
        "CHUNKFLOW_SLO", "1").strip().lower() not in _OFF_VALUES


# ---------------------------------------------------------------------------
# objectives + burn rules
# ---------------------------------------------------------------------------
class Objective:
    """One service-level objective: ``target`` fraction of events must
    be good. ``kind="ratio"``: good/bad derive from summed registry
    counters (``total`` minus ``bad`` is good). ``kind="latency"``:
    events are qhist samples; bad = samples above ``threshold_s``
    (snapped up to the nearest histogram bound, so bucket math is
    exact and fleet-summable)."""

    __slots__ = ("name", "target", "kind", "total", "bad", "qhist",
                 "threshold_s", "_bound_index", "description")

    def __init__(self, name: str, target: float, kind: str = "ratio",
                 total: Tuple[str, ...] = (), bad: Tuple[str, ...] = (),
                 qhist: Optional[str] = None,
                 threshold_s: Optional[float] = None,
                 description: str = ""):
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"objective {name!r}: target must be in (0, 1), "
                f"got {target!r}")
        if kind not in ("ratio", "latency"):
            raise ValueError(
                f"objective {name!r}: kind must be ratio|latency, "
                f"got {kind!r}")
        if kind == "latency" and (qhist is None or threshold_s is None):
            raise ValueError(
                f"objective {name!r}: latency kind needs qhist + "
                f"threshold_s")
        self.name = name
        self.target = float(target)
        self.kind = kind
        self.total = tuple(total)
        self.bad = tuple(bad)
        self.qhist = qhist
        self.description = description
        self.threshold_s = None
        self._bound_index = None
        if threshold_s is not None:
            self.threshold_s = float(threshold_s)
            # snap the threshold UP to a bucket bound: everything at or
            # below that bound counts good, everything above counts bad
            idx = len(telemetry.QUANTILE_BOUNDS) - 1
            for i, bound in enumerate(telemetry.QUANTILE_BOUNDS):
                if bound >= self.threshold_s:
                    idx = i
                    break
            self._bound_index = idx

    def counts(self, counters: dict, qhists: dict) -> Tuple[float, float]:
        """Cumulative ``(total, bad)`` event counts right now."""
        if self.kind == "ratio":
            total = sum(counters.get(name, 0.0) for name in self.total)
            bad = sum(counters.get(name, 0.0) for name in self.bad)
            return float(total), float(bad)
        h = qhists.get(self.qhist) or {}
        buckets = h.get("buckets") or []
        total = float(h.get("count", 0))
        good = float(sum(buckets[: self._bound_index + 1]))
        return total, max(0.0, total - good)

    def describe(self) -> dict:
        out = {"name": self.name, "kind": self.kind, "target": self.target}
        if self.kind == "latency":
            out["qhist"] = self.qhist
            out["threshold_s"] = self.threshold_s
        else:
            out["total"] = list(self.total)
            out["bad"] = list(self.bad)
        return out


class BurnRule:
    """One multi-window burn-rate alert rule: fire when the burn rate
    exceeds ``burn`` over BOTH ``long_s`` and ``short_s``."""

    __slots__ = ("name", "short_s", "long_s", "burn", "severity")

    def __init__(self, name: str, short_s: float, long_s: float,
                 burn: float, severity: str = "ticket"):
        if short_s <= 0 or long_s <= 0 or short_s > long_s:
            raise ValueError(
                f"rule {name!r}: need 0 < short_s <= long_s, got "
                f"{short_s}/{long_s}")
        self.name = name
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.burn = float(burn)
        self.severity = severity


def default_objectives() -> List[Objective]:
    return [
        Objective(
            "availability", target=0.999,
            total=("serving/requests",), bad=("serving/errors",),
            description="non-error share of serving requests",
        ),
        Objective(
            "latency", target=0.99, kind="latency",
            qhist="serving/latency", threshold_s=0.5,
            description="share of requests answered within threshold_s "
                        "(p99 <= threshold)",
        ),
        Objective(
            "deadline", target=0.99,
            total=("serving/requests",), bad=("serving/deadline_missed",),
            description="share of requests meeting their deadline",
        ),
        Objective(
            "dead_letter", target=0.999,
            total=("tasks/committed", "tasks/dead_lettered"),
            bad=("tasks/dead_lettered",),
            description="share of finished tasks not dead-lettered",
        ),
        Objective(
            "storage_hit", target=0.5,
            total=("storage/hits", "storage/misses"),
            bad=("storage/misses",),
            description="block-cache hit share (advisory: a cold cache "
                        "burns this budget by design while warming)",
        ),
    ]


def default_rules() -> List[BurnRule]:
    return [
        BurnRule("fast", short_s=300.0, long_s=3600.0, burn=14.4,
                 severity="page"),
        BurnRule("slow", short_s=6 * 3600.0, long_s=3 * 86400.0, burn=1.0,
                 severity="ticket"),
    ]


DEFAULT_OBJECTIVES = default_objectives()
DEFAULT_RULES = default_rules()


# ---------------------------------------------------------------------------
# configuration: [tool.chunkflow.slo] / --slo-config TOML
# ---------------------------------------------------------------------------
def _parse_scalar(raw: str):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    if raw.startswith("'") and raw.endswith("'") and len(raw) >= 2:
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(part) for part in inner.split(",")]
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"unparseable TOML value {raw!r}") from None


def _parse_toml_minimal(text: str, lenient: bool = False) -> dict:
    """A TOML subset parser, for an interpreter with neither tomllib
    nor tomli: ``[dotted.section]`` headers and ``key = value`` pairs with
    strings, numbers, booleans and flat arrays — exactly the shapes the
    SLO config uses. Full TOML files that stay inside the subset parse
    identically; exotica (multiline strings/arrays, inline tables)
    raise in strict mode. ``lenient=True`` skips unparseable lines
    instead — the pyproject.toml scan, whose unrelated sections
    legitimately use full TOML the subset cannot read."""
    root: dict = {}
    table = root
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            table = root
            for part in line[1:-1].strip().split("."):
                part = part.strip().strip('"').strip("'")
                table = table.setdefault(part, {})
            continue
        if "=" not in line:
            if lenient:
                continue
            raise ValueError(f"slo config line {lineno}: not key=value: "
                             f"{line!r}")
        key, _, raw = line.partition("=")
        # strip a trailing comment outside quotes (good enough for the
        # subset: values containing '#' must be quoted, and quoted
        # values must not contain the quote character itself)
        stripped = raw.strip()
        if stripped[:1] in ('"', "'"):
            close = stripped.find(stripped[0], 1)
            if close > 0:
                raw = stripped[: close + 1]
        elif "#" in raw:
            raw = raw.split("#", 1)[0]
        try:
            value = _parse_scalar(raw)
        except ValueError:
            if lenient:
                continue
            raise
        table[key.strip().strip('"').strip("'")] = value
    return root


def _load_toml(path: str, lenient: bool = False) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    try:
        import tomllib  # Python >= 3.11
    except ImportError:
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ImportError:
            return _parse_toml_minimal(data.decode(), lenient=lenient)
    import io

    return tomllib.load(io.BytesIO(data))


def load_slo_config(path: Optional[str] = None,
                    pyproject: Optional[str] = None) -> dict:
    """The merged SLO config table: ``[tool.chunkflow.slo]`` from
    ``pyproject`` (default: ``./pyproject.toml`` when present), then —
    overriding it key-by-key at the objective/rule level — the
    ``--slo-config`` file, whose top level IS the slo table. Missing
    files are empty config, a malformed file raises (a typo'd alerting
    config must fail loudly, not silently alert on defaults)."""
    merged: dict = {}

    def fold(table: dict) -> None:
        for key, value in table.items():
            if key in ("objective", "rule") and isinstance(value, dict):
                dest = merged.setdefault(key, {})
                for name, sub in value.items():
                    dest.setdefault(name, {}).update(
                        sub if isinstance(sub, dict) else {})
            else:
                merged[key] = value

    if pyproject is None and os.path.exists("pyproject.toml"):
        pyproject = "pyproject.toml"
    if pyproject and os.path.exists(pyproject):
        # lenient: a pyproject's unrelated sections legitimately use
        # TOML shapes the fallback subset parser cannot read
        data = _load_toml(pyproject, lenient=True)
        fold(data.get("tool", {}).get("chunkflow", {}).get("slo", {}))
    if path:
        fold(_load_toml(path))
    return merged


def _as_tuple(value) -> Tuple[str, ...]:
    if isinstance(value, str):
        return tuple(s.strip() for s in value.split(",") if s.strip())
    return tuple(value or ())


def evaluator_from_config(config: Optional[dict] = None,
                          clock: Callable[[], float] = time.time,
                          source: Optional[Callable[[], dict]] = None,
                          ) -> "SLOEvaluator":
    """Build an evaluator from a merged config table: defaults, with
    per-objective / per-rule overrides (``enabled = false`` drops one,
    unknown names add one) and global ``period_s`` / ``scale`` /
    ``points`` knobs."""
    config = config or {}
    scale = float(config.get("scale", 1.0))
    period_s = float(config.get("period_s", DEFAULT_PERIOD_S))
    objectives: List[Objective] = []
    obj_cfg = dict(config.get("objective") or {})
    for obj in default_objectives():
        over = obj_cfg.pop(obj.name, None)
        if over is None:
            objectives.append(obj)
            continue
        if not over.get("enabled", True):
            continue
        objectives.append(Objective(
            obj.name,
            target=float(over.get("target", obj.target)),
            kind=over.get("kind", obj.kind),
            total=_as_tuple(over.get("total", obj.total)),
            bad=_as_tuple(over.get("bad", obj.bad)),
            qhist=over.get("qhist", obj.qhist),
            threshold_s=over.get("threshold_s", obj.threshold_s),
            description=over.get("description", obj.description),
        ))
    for name, over in sorted(obj_cfg.items()):  # config-only objectives
        if not over.get("enabled", True):
            continue
        objectives.append(Objective(
            name, target=float(over.get("target", 0.999)),
            kind=over.get("kind", "ratio"),
            total=_as_tuple(over.get("total")),
            bad=_as_tuple(over.get("bad")),
            qhist=over.get("qhist"), threshold_s=over.get("threshold_s"),
            description=over.get("description", ""),
        ))
    rules: List[BurnRule] = []
    rule_cfg = dict(config.get("rule") or {})
    for rule in default_rules():
        over = rule_cfg.pop(rule.name, None)
        if over is None:
            rules.append(rule)
            continue
        if not over.get("enabled", True):
            continue
        rules.append(BurnRule(
            rule.name,
            short_s=float(over.get("short_s", rule.short_s)),
            long_s=float(over.get("long_s", rule.long_s)),
            burn=float(over.get("burn", rule.burn)),
            severity=over.get("severity", rule.severity),
        ))
    for name, over in sorted(rule_cfg.items()):  # config-only rules
        if not over.get("enabled", True):
            continue
        rules.append(BurnRule(
            name, short_s=float(over["short_s"]),
            long_s=float(over["long_s"]), burn=float(over["burn"]),
            severity=over.get("severity", "ticket"),
        ))
    return SLOEvaluator(
        objectives=objectives, rules=rules, period_s=period_s,
        scale=scale, points=int(config.get("points", 2048)),
        clock=clock, source=source,
    )


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------
def _slug(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch == "_" else "_"
                   for ch in name)


class SLOEvaluator:
    """Samples cumulative good/bad counts into a bounded ring and runs
    multi-window burn-rate evaluation on every :meth:`tick`. Alert
    state is edge-triggered: one ``alert`` event when a (objective,
    rule) pair starts firing, one ``resolved`` event when it stops —
    never one per tick. Thread-safety: ``tick`` is expected from one
    clock (the telemetry sampler thread), readers (``/alerts``, the
    serving stats payload) may call :meth:`status`/:meth:`firing`
    from any thread; all shared state sits behind one lock and no
    telemetry emission happens under it."""

    def __init__(self, objectives: Optional[List[Objective]] = None,
                 rules: Optional[List[BurnRule]] = None,
                 period_s: float = DEFAULT_PERIOD_S, scale: float = 1.0,
                 points: int = 2048,
                 clock: Callable[[], float] = time.time,
                 source: Optional[Callable[[], dict]] = None):
        if scale <= 0:
            raise ValueError(f"scale must be > 0, got {scale}")
        self.objectives = list(DEFAULT_OBJECTIVES if objectives is None
                               else objectives)
        self.rules = [
            BurnRule(r.name, short_s=r.short_s * scale,
                     long_s=r.long_s * scale, burn=r.burn,
                     severity=r.severity)
            for r in (DEFAULT_RULES if rules is None else rules)
        ]
        self.period_s = float(period_s) * scale
        self.scale = float(scale)
        self._clock = clock
        self._source = source or telemetry.snapshot
        self._lock = threading.Lock()
        # ring of (t, {objective: (total, bad)}) cumulative samples
        self._samples: deque = deque(maxlen=max(8, int(points)))
        self._firing: Dict[Tuple[str, str], dict] = {}
        self._status: dict = {"t": None, "objectives": [], "firing": []}

    # -- sampling -------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Record one sample and evaluate every (objective, rule) pair;
        returns the alerts that newly fired this tick. This is the
        telemetry tick hook's body (and the test entry point, with an
        injected clock/source)."""
        if now is None:
            now = self._clock()
        snap = self._source()
        counters = snap.get("counters") or {}
        qhists = snap.get("qhists") or {}
        counts = {
            obj.name: obj.counts(counters, qhists)
            for obj in self.objectives
        }
        with self._lock:
            self._samples.append((now, counts))
        return self._evaluate(now, counts)

    def _baseline(self, samples: list, now: float, window_s: float,
                  name: str) -> Tuple[float, float]:
        """Cumulative (total, bad) at the start of the window: the
        newest sample at or before ``now - window_s``, else the oldest
        available (a not-yet-covered window evaluates over the data it
        has — standard Prometheus ``increase`` behavior; a healthy
        service reads 0 bad either way)."""
        cutoff = now - window_s
        chosen = None
        for t, counts in samples:
            if t > cutoff:
                break
            chosen = counts
        if chosen is None:
            chosen = samples[0][1] if samples else {}
        return chosen.get(name, (0.0, 0.0))

    def _burn(self, samples: list, now: float, window_s: float,
              obj: Objective, cur: Tuple[float, float]) -> float:
        """Budget burn rate over one window: bad-share / budget-share.
        1.0 = exactly on budget pace, 0.0 = clean (or no traffic)."""
        base = self._baseline(samples, now, window_s, obj.name)
        d_total = cur[0] - base[0]
        if d_total <= 0:
            return 0.0
        frac = min(1.0, max(0.0, (cur[1] - base[1]) / d_total))
        return frac / (1.0 - obj.target)

    # -- evaluation -----------------------------------------------------
    def _evaluate(self, now: float, counts: dict) -> List[dict]:
        with self._lock:
            samples = list(self._samples)
        from chunkflow_tpu_torch.core import profiling

        new_alerts: List[dict] = []
        emissions: List[Tuple[str, dict]] = []
        status_objs: List[dict] = []
        gauges: List[Tuple[str, float]] = []
        with self._lock:
            for obj in self.objectives:
                cur = counts[obj.name]
                period_burn = self._burn(samples, now, self.period_s,
                                         obj, cur)
                budget_remaining = round(1.0 - period_burn, 6)
                firing_rules = []
                rule_rows = []
                for rule in self.rules:
                    burn_long = self._burn(samples, now, rule.long_s,
                                           obj, cur)
                    burn_short = self._burn(samples, now, rule.short_s,
                                            obj, cur)
                    firing = (burn_long >= rule.burn
                              and burn_short >= rule.burn)
                    key = (obj.name, rule.name)
                    alert = {
                        "alert": f"{obj.name}:{rule.name}",
                        "objective": obj.name,
                        "rule": rule.name,
                        "severity": rule.severity,
                        "target": obj.target,
                        "burn_threshold": rule.burn,
                        "burn_short": round(burn_short, 4),
                        "burn_long": round(burn_long, 4),
                        "short_s": rule.short_s,
                        "long_s": rule.long_s,
                        "budget_remaining": budget_remaining,
                    }
                    if firing and key not in self._firing:
                        self._firing[key] = alert
                        new_alerts.append(alert)
                        emissions.append(("firing", alert))
                    elif not firing and key in self._firing:
                        self._firing.pop(key)
                        emissions.append(("resolved", alert))
                    if firing:
                        firing_rules.append(rule.name)
                    rule_rows.append({
                        "rule": rule.name, "severity": rule.severity,
                        "burn_short": round(burn_short, 4),
                        "burn_long": round(burn_long, 4),
                        "threshold": rule.burn, "firing": firing,
                    })
                # headline burn: the fastest rule's long window — "how
                # fast is the budget going, smoothed past blips"
                headline = rule_rows[0]["burn_long"] if rule_rows else 0.0
                slug = _slug(obj.name)
                gauges.append((f"slo/{slug}/burn_rate", headline))
                gauges.append((f"slo/{slug}/budget_remaining",
                               budget_remaining))
                gauges.append((f"slo/{slug}/firing",
                               1.0 if firing_rules else 0.0))
                status_objs.append({
                    **obj.describe(),
                    "burn_rate": headline,
                    "budget_remaining": budget_remaining,
                    "rules": rule_rows,
                    "firing": firing_rules,
                })
            self._status = {
                "t": now,
                "period_s": self.period_s,
                "objectives": status_objs,
                "firing": sorted(a["alert"]
                                 for a in self._firing.values()),
            }
        # emissions AFTER the lock: telemetry takes its own lock, and a
        # page capture spawns a thread — neither belongs under ours
        for name, value in gauges:
            telemetry.gauge(name, value)
        for state, alert in emissions:
            if state == "firing":
                telemetry.inc("slo/alerts")
                telemetry.event("alert", f"slo/{alert['objective']}",
                                state="firing", **alert)
                if alert["severity"] == "page":
                    profiling.note_slo_page(alert["objective"])
            else:
                telemetry.inc("slo/alerts_resolved")
                telemetry.event("alert", f"slo/{alert['objective']}",
                                state="resolved", alert=alert["alert"],
                                objective=alert["objective"],
                                rule=alert["rule"],
                                severity=alert["severity"])
        return new_alerts

    # -- readers --------------------------------------------------------
    def status(self) -> dict:
        """The ``/alerts`` payload: per-objective burn rates, budget
        remaining, rule states, and the flat firing list."""
        with self._lock:
            status = dict(self._status)
            status["objectives"] = [dict(o) for o in status["objectives"]]
            status["firing"] = list(status["firing"])
        return status

    def firing(self) -> List[str]:
        """Currently-firing alert names (``objective:rule``), sorted."""
        with self._lock:
            return sorted(a["alert"] for a in self._firing.values())


# ---------------------------------------------------------------------------
# process-global lifecycle (rides telemetry's tick/reset hooks)
# ---------------------------------------------------------------------------
_EVALUATOR_LOCK = threading.Lock()
_EVALUATOR: Optional[SLOEvaluator] = None


def _tick(now: float) -> None:
    evaluator = _EVALUATOR
    if evaluator is not None:
        evaluator.tick(now)


def start_slo(config_path: Optional[str] = None,
              pyproject: Optional[str] = None) -> Optional[SLOEvaluator]:
    """Start the process-global SLO evaluator on the telemetry
    time-series tick (idempotent). Returns None — creating no evaluator,
    no hook, no thread — when telemetry or the plane is disabled. The
    CLI calls this for every instrumented run; a malformed config
    raises (fail loudly, not alert on defaults)."""
    global _EVALUATOR
    if not slo_enabled():
        return None
    with _EVALUATOR_LOCK:
        if _EVALUATOR is not None:
            return _EVALUATOR
        config = load_slo_config(config_path, pyproject=pyproject)
        _EVALUATOR = evaluator_from_config(config)
    telemetry.add_tick_hook(_tick)
    # the evaluator's clock is the sampler thread; make sure one runs
    telemetry.start_timeseries()
    return _EVALUATOR


def current() -> Optional[SLOEvaluator]:
    """The live evaluator (``/alerts``, serving stats), or None."""
    return _EVALUATOR


def stop_slo() -> None:
    global _EVALUATOR
    telemetry.remove_tick_hook(_tick)
    with _EVALUATOR_LOCK:
        _EVALUATOR = None


telemetry.add_reset_hook(stop_slo)
