"""Perfetto / Chrome trace export of a fleet's merged telemetry.

The port's copy of the JAX repository's ``tools/trace_export.py``
(``log-summary --export-trace``): the JSONL of every worker under a
metrics directory becomes one Chrome trace-event file that
``chrome://tracing`` and https://ui.perfetto.dev load:

* each worker is a process (``process_name``; pid: the worker's rank);
* each plane (a span or event name's ``<plane>/`` prefix) is a thread;
* spans are complete (``X``) events at their start ``t0`` (the port's
  JSONL carries it; older files stamp only the end, so there ``ts = t -
  dur_s``);
* gauges and snapshot counters are counter (``C``) tracks, counters with
  ``cat: "cumulative"``; per-chip gauges (``<plane>/chip/<i>/<metric>``)
  get a ``chip <i>`` track each;
* lifecycle, alert, depth-change, fleet and compile events are instants;
* a task that hopped between workers is one flow (``s`` at its
  ``queue/submit``, ``t`` over intermediate claims, ``f`` at its last
  ``lifecycle/claimed``) per ``trace_id``.

Worker clocks are aligned first (``log_summary.worker_clock_offsets``)
and flow steps clamped monotone, so no flow ends before it starts.

    python -m chunkflow_tpu_torch.flow.trace_export <metrics_dir> -o out.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from chunkflow_tpu_torch.core.telemetry import CHIP_METRIC_RE
from chunkflow_tpu_torch.flow.log_summary import (
    _event_worker,
    load_telemetry_dir,
    worker_clock_offsets,
)

#: JSONL event kinds that render as instant markers on their plane track
_INSTANT_KINDS = (
    "task", "task_retry", "alert", "depth_change", "fleet", "compile",
)

#: payload keys that are structural, not event arguments
_STRUCTURAL_KEYS = ("kind", "name", "t", "t0", "dur_s", "pid", "worker")


def _plane(name: str) -> str:
    """The track a span/instant renders on: the name's top-level plane
    (``pipeline/stage`` -> ``pipeline``)."""
    return str(name).split("/", 1)[0] or "events"


def _args_of(record: dict) -> dict:
    return {
        k: v for k, v in record.items()
        if k not in _STRUCTURAL_KEYS and v is not None
        and not isinstance(v, (dict, list))
    }


def export_chrome_trace(events: List[dict]) -> dict:
    """The merged JSONL stream as one Chrome trace-event object
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``). Timestamps
    are microseconds relative to the earliest (skew-normalized) event,
    every emitted event carries ``pid``/``tid``/``ts``, and every flow
    id is paired (one ``s``, a final ``f``)."""
    offsets = worker_clock_offsets(events)

    def t_adj(record: dict) -> float:
        return (float(record.get("t", 0.0))
                + offsets.get(_event_worker(record), 0.0))

    def start_adj(record: dict) -> float:
        """An event's start: a span's ``t0``, else its stamp less its
        duration."""
        if record.get("t0") is not None:
            return (float(record["t0"])
                    + offsets.get(_event_worker(record), 0.0))
        return t_adj(record) - float(record.get("dur_s", 0.0) or 0.0)

    # stable pid per worker, tid per (worker, plane)
    workers = sorted({_event_worker(e) for e in events})
    pids = {worker: i + 1 for i, worker in enumerate(workers)}
    tids: Dict[Tuple[str, str], int] = {}

    def tid_of(worker: str, plane: str) -> int:
        key = (worker, plane)
        if key not in tids:
            tids[key] = 1 + sum(1 for w, _ in tids if w == worker)
        return tids[key]

    # pass 1: the time base (span starts reach earlier than their stamp)
    base: Optional[float] = None
    for record in events:
        if record.get("kind") == "timeseries":
            continue
        start = start_adj(record)
        base = start if base is None else min(base, start)
    if base is None:
        base = 0.0

    def ts_us(record: dict) -> float:
        return round((t_adj(record) - base) * 1e6, 3)

    out: List[dict] = []
    # pass 2: spans, counters, instants (+ flow anchors collected)
    flows: Dict[str, List[dict]] = {}  # trace_id -> anchor events
    for record in events:
        kind = record.get("kind")
        worker = _event_worker(record)
        pid = pids[worker]
        name = str(record.get("name", "") or kind)
        if kind == "span":
            dur_s = float(record.get("dur_s", 0.0) or 0.0)
            ts = (round((start_adj(record) - base) * 1e6, 3)
                  if record.get("t0") is not None
                  else round(ts_us(record) - dur_s * 1e6, 3))
            out.append({
                "ph": "X", "name": name, "cat": "span",
                "pid": pid, "tid": tid_of(worker, _plane(name)),
                "ts": ts,
                "dur": round(dur_s * 1e6, 3),
                "args": _args_of(record),
            })
        elif kind == "gauge":
            chip_match = CHIP_METRIC_RE.match(name)
            if chip_match:
                # per-chip gauges (``<plane>/chip/<i>/<metric>``) render on a ``chip <i>`` thread track inside their
                # worker, one counter per metric — so a mesh run shows
                # replay-buffer bytes / HBM watermarks side by side per
                # chip instead of interleaved on the global gauge track
                chip = int(chip_match.group("chip"))
                out.append({
                    "ph": "C",
                    "name": (f"{chip_match.group('plane')}/"
                             f"{chip_match.group('metric')}"),
                    "cat": "chip_gauge",
                    "pid": pid,
                    "tid": tid_of(worker, f"chip {chip}"),
                    "ts": ts_us(record),
                    "args": {"value": float(record.get("value", 0.0)),
                             "chip": chip},
                })
            else:
                out.append({
                    "ph": "C", "name": name, "cat": "gauge",
                    "pid": pid, "tid": 0, "ts": ts_us(record),
                    "args": {"value": float(record.get("value", 0.0))},
                })
        elif kind == "snapshot":
            for cname, value in (record.get("counters") or {}).items():
                out.append({
                    "ph": "C", "name": cname, "cat": "cumulative",
                    "pid": pid, "tid": 0, "ts": ts_us(record),
                    "args": {"value": float(value)},
                })
        elif kind in _INSTANT_KINDS:
            anchor = {
                "ph": "i", "name": name, "cat": kind,
                "pid": pid, "tid": tid_of(worker, _plane(name)),
                "ts": ts_us(record), "s": "t",
                "args": _args_of(record),
            }
            out.append(anchor)
            trace_id = record.get("trace_id")
            if trace_id and name in ("queue/submit", "lifecycle/claimed"):
                flows.setdefault(str(trace_id), []).append(
                    {"anchor": anchor, "worker": worker, "name": name})
    # pass 3: flow chains for tasks that hopped between workers
    flow_pairs = 0
    for seq, (trace_id, anchors) in enumerate(sorted(flows.items())):
        if len({a["worker"] for a in anchors}) < 2:
            continue  # a single worker's task needs no arrow
        anchors.sort(key=lambda a: a["anchor"]["ts"])
        submits = [a for a in anchors if a["name"] == "queue/submit"]
        claims = [a for a in anchors if a["name"] == "lifecycle/claimed"]
        if not submits or not claims:
            continue
        chain = [submits[0]] + claims
        flow_pairs += 1
        prev_ts = chain[0]["anchor"]["ts"]
        for i, entry in enumerate(chain):
            anchor = entry["anchor"]
            # belt and braces on top of the offset normalization: a flow
            # step can never precede the step before it
            prev_ts = max(prev_ts, anchor["ts"])
            ph = ("s" if i == 0
                  else "f" if i == len(chain) - 1 else "t")
            flow_event = {
                "ph": ph, "name": "task-hop", "cat": "task_flow",
                "id": seq + 1, "pid": anchor["pid"],
                "tid": anchor["tid"], "ts": prev_ts,
                "args": {"trace_id": trace_id},
            }
            if ph == "f":
                flow_event["bp"] = "e"
            out.append(flow_event)
    # metadata: worker names on processes, plane names on threads
    for worker, pid in pids.items():
        out.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": f"worker {worker}"},
        })
    for (worker, plane), tid in tids.items():
        out.append({
            "ph": "M", "name": "thread_name", "pid": pids[worker],
            "tid": tid, "ts": 0, "args": {"name": plane},
        })
    out.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "workers": len(workers),
            "flow_pairs": flow_pairs,
            "source": "chunkflow telemetry JSONL",
        },
    }


def validate_chrome_trace(trace: dict) -> List[str]:
    """Schema checks on an exported trace; returns a list of problems
    (empty = valid):

    * every event carries numeric ``pid``/``tid``/``ts`` (and ``X``
      events a non-negative ``dur``);
    * every flow id is paired — exactly one ``s``, at least one ``f``,
      and no step/finish earlier than its start (monotone chains);
    * ``cumulative`` counter tracks are monotone non-decreasing per
      (pid, name);
    * ``chip_gauge`` counters (per-chip tracks) carry a
      non-negative integer ``chip`` arg, and one thread track never
      mixes samples from two different chips."""
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    flows: Dict[object, Dict[str, list]] = {}
    counters: Dict[Tuple[object, str], List[Tuple[float, float]]] = {}
    chip_tracks: Dict[Tuple[object, object], int] = {}
    for i, event in enumerate(events):
        for field in ("pid", "tid", "ts"):
            if not isinstance(event.get(field), (int, float)):
                problems.append(f"event {i} ({event.get('ph')}"
                                f" {event.get('name')!r}): bad {field}")
        ph = event.get("ph")
        if ph == "X" and float(event.get("dur", -1.0)) < 0:
            problems.append(f"event {i}: X without non-negative dur")
        elif ph in ("s", "t", "f"):
            entry = flows.setdefault(
                event.get("id"), {"s": [], "t": [], "f": []})
            entry[ph].append(float(event.get("ts", 0.0)))
        elif ph == "C":
            key = (event.get("pid"), str(event.get("name")))
            value = (event.get("args") or {}).get("value")
            if not isinstance(value, (int, float)):
                problems.append(f"event {i}: counter without value")
            elif event.get("cat") == "cumulative":
                counters.setdefault(key, []).append(
                    (float(event.get("ts", 0.0)), float(value)))
            if event.get("cat") == "chip_gauge":
                chip = (event.get("args") or {}).get("chip")
                if not isinstance(chip, int) or chip < 0:
                    problems.append(
                        f"event {i}: chip_gauge counter "
                        f"{event.get('name')!r} without a non-negative "
                        f"integer chip arg")
                    continue
                track = (event.get("pid"), event.get("tid"))
                seen = chip_tracks.setdefault(track, chip)
                if seen != chip:
                    problems.append(
                        f"chip track pid={track[0]} tid={track[1]} "
                        f"mixes chips {seen} and {chip}")
    for flow_id, entry in flows.items():
        if len(entry["s"]) != 1 or not entry["f"]:
            problems.append(
                f"flow {flow_id}: {len(entry['s'])} start(s), "
                f"{len(entry['f'])} finish(es) — must be 1 and >=1")
            continue
        start = entry["s"][0]
        for ts in entry["t"] + entry["f"]:
            if ts < start:
                problems.append(
                    f"flow {flow_id}: step/finish at {ts} before "
                    f"start {start}")
    for (pid, name), samples in counters.items():
        samples.sort(key=lambda s: s[0])
        last = None
        for ts, value in samples:
            if last is not None and value < last:
                problems.append(
                    f"cumulative counter {name!r} (pid {pid}) "
                    f"decreases at ts {ts}: {last} -> {value}")
                break
            last = value
    return problems


def export_metrics_dir(metrics_dir: str, out_path: str) -> dict:
    """Load a metrics dir, export it, validate, write ``out_path``.
    Returns ``{"events", "trace_events", "workers", "flow_pairs",
    "problems"}`` — writing happens even when validation flags
    problems, so a broken trace can be inspected."""
    events = load_telemetry_dir(metrics_dir)
    trace = export_chrome_trace(events)
    problems = validate_chrome_trace(trace)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return {
        "events": len(events),
        "trace_events": len(trace["traceEvents"]),
        "workers": trace["otherData"]["workers"],
        "flow_pairs": trace["otherData"]["flow_pairs"],
        "problems": problems,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Export merged telemetry JSONL as a Chrome trace")
    parser.add_argument("metrics_dir")
    parser.add_argument("-o", "--output", default="trace.json")
    args = parser.parse_args(argv)
    stats = export_metrics_dir(args.metrics_dir, args.output)
    print(
        f"trace_export: {stats['events']} telemetry event(s) -> "
        f"{stats['trace_events']} trace event(s), "
        f"{stats['workers']} worker process(es), "
        f"{stats['flow_pairs']} cross-worker flow(s) -> {args.output}"
    )
    for problem in stats["problems"]:
        print(f"trace_export: INVALID: {problem}", file=sys.stderr)
    return 1 if stats["problems"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
