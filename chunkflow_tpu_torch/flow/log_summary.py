"""log-summary: what a run or a fleet did, from its files alone.

The counterpart of ``chunkflow_tpu/flow/log_summary.py``, printing the
same lines:

* ``--log-dir``: per-task JSON timing logs, per compute device the mean,
  max, min, sum and count of every timer column and the throughput in
  Mvoxel/s. The JAX package builds pandas frames and prints their table;
  the port computes the same numbers with numpy (the card machine has no
  pandas) and prints its own table, and the ``device ...: X Mvoxel/s``
  lines as the JAX package does.
* ``--metrics-dir``: the telemetry JSONL of every worker (rotated
  generations included): stall attribution, fault tolerance, segment,
  storage, serving and fleet blocks, the span table, device memory, the
  program and mesh blocks (the port writes neither XLA compile nor
  per-chip mesh records, so these read a JAX-written directory and stay
  quiet on the port's), and a summary of each ``profile-*`` capture (the
  port's are ``torch.profiler`` traces: ``flow/profile_summary.py``).
* ``--slo``: alerts, objectives and fleet-merged sparklines.
* ``--fleet`` and ``--trace-id``: per-worker blocks and one task's
  timeline across workers, clock skew corrected.
"""
from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List, Optional

import numpy as np

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.bbox import BoundingBox

#: the pipeline phases whose spans make up the stall breakdown, in
#: pipeline order (flow/pipeline.py + flow/scheduler.py span names):
#: upstream load wait, H2D staging, dispatch, device compute, D2H drain,
#: host post-processing, storage-write drain — the same totals the
#: adaptive depth controller consumes (docs/observability.md)
STALL_PHASES = (
    "scheduler/load", "pipeline/stage", "pipeline/dispatch",
    "pipeline/compute", "pipeline/drain", "scheduler/post",
    "scheduler/write",
)

#: fault-tolerance counters (parallel/lifecycle.py + testing/chaos.py),
#: reported as their own block: on a preemptible fleet, "how many tasks
#: retried / died / were ledger-skipped" is the convergence story
LIFECYCLE_COUNTERS = (
    "tasks/committed", "tasks/retried", "tasks/surrendered",
    "tasks/dead_lettered", "tasks/preempted", "ledger/skips",
    "lease/renewals", "lease/renew_failures", "lifecycle/renew_errors",
    "pipeline/chain_rebuilds", "chaos/injected",
)

#: fleet-supervisor counters (parallel/fleet.py), reported as their own
#: block: on an elastic fleet, "how many workers were spawned / evicted
#: / drill-preempted and why scale-up was held" is the ops story
FLEET_COUNTERS = (
    "fleet/spawns", "fleet/scale_up", "fleet/scale_down",
    "fleet/scale_down_drains", "fleet/evictions", "fleet/worker_deaths",
    "fleet/drill_preemptions", "fleet/probe_failures",
    "fleet/leases_nacked", "fleet/handles_truncated", "fleet/holds",
    "fleet/crash_backoffs",
)

#: storage-plane counters (volume/storage.py, docs/storage.md),
#: reported as their own block: on an overlapping task grid, "how many
#: block reads the hot cache absorbed and how many bytes actually moved"
#: is the storage story — the same signal the fleet supervisor uses to
#: tell cache-cold network-bound from genuinely load-bound
STORAGE_COUNTERS = (
    "storage/hits", "storage/misses", "storage/block_reads",
    "storage/bytes_read", "storage/bytes_written",
    "storage/aligned_writes", "storage/unaligned_writes",
    "storage/evictions",
)

#: segmentation-plane counters (segment/,
#: docs/segmentation.md), reported as their own block: for a stitching
#: job, "how many chunks labeled, faces moved, equivalence edges found
#: and voxels rewritten" is the whole map -> reduce -> map story in five
#: numbers — a run whose edges_found is zero on a connected volume has
#: a face-exchange bug, not a labeling bug
SEGMENT_COUNTERS = (
    "segment/chunks_labeled", "segment/faces_written",
    "segment/faces_exchanged", "segment/edges_found",
    "segment/merges_applied", "segment/voxels_relabeled",
)

#: serving-plane counters (serve/, docs/serving.md),
#: reported as their own block: under request traffic, "how many
#: requests were admitted / shed / late and how full the device batches
#: ran" is the serving story
SERVING_COUNTERS = (
    "serving/requests", "serving/admitted", "serving/completed",
    "serving/rejected_admission", "serving/rejected_memory",
    "serving/rejected_duplicate", "serving/deadline_missed",
    "serving/errors", "serving/packer_errors", "serving/fallbacks",
    "serving/batches", "serving/packed_patches", "serving/filler_slots",
)


def load_log_dir(log_dir: str) -> List[dict]:
    records = []
    if not os.path.isdir(log_dir):
        print(f"log-summary: no such log dir {log_dir}", file=sys.stderr)
        return records
    for name in sorted(os.listdir(log_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(log_dir, name)) as f:
            record = json.load(f)
        record.setdefault("_file", name)
        try:
            record["_bbox"] = BoundingBox.from_string(name)
        except ValueError:
            bbox_str = record.get("bbox")
            record["_bbox"] = (
                BoundingBox.from_string(bbox_str) if bbox_str else None
            )
        records.append(record)
    return records


#: the per-column statistics of the ``--log-dir`` summary, in order
_LOG_STATS = ("mean", "max", "min", "sum", "count")


def _record_device(record: dict):
    return record.get(
        "compute_device", record.get("log", {}).get("compute_device", ""))


def _record_timer(record: dict) -> dict:
    return record.get("timer", record.get("log", {}).get("timer", {}))


def _group_by_device(rows: List[dict]) -> Dict[str, List[dict]]:
    """Rows by compute device, devices sorted; a row whose device is
    None is left out (pandas' ``groupby`` drops missing keys)."""
    groups: Dict[str, List[dict]] = {}
    for row in rows:
        if row["compute_device"] is not None:
            groups.setdefault(row["compute_device"], []).append(row)
    return dict(sorted(groups.items()))


def summarize(records: List[dict], output_size=None) -> dict:
    """Per compute device, the mean, max, min, sum and count of every
    timer column (and of ``_total``, ``_voxels`` and ``_mvoxel_per_s``,
    the canonical metric) over the tasks that have it::

        {device: {column: {"mean", "max", "min", "sum", "count"}}}

    The numbers of the JAX package's pandas aggregation (its sums and
    means within float64 rounding: pandas sums groups compensated);
    ``{}`` when no record is usable."""
    rows, columns = [], {}
    for record in records:
        timer = _record_timer(record)
        row = dict(timer)
        row["compute_device"] = _record_device(record)
        row["_total"] = sum(timer.values())
        if record.get("_bbox") is not None:
            row["_voxels"] = record["_bbox"].voxel_count
        elif output_size is not None:
            row["_voxels"] = int(np.prod(output_size))
        if row.get("_voxels") and row["_total"] > 0:
            # the canonical metric: voxels per task-second
            row["_mvoxel_per_s"] = row["_voxels"] / row["_total"] / 1e6
        rows.append(row)
        columns.update(dict.fromkeys(row))
    if not rows:
        print(
            "log-summary: no usable task records "
            f"({len(records)} loaded); returning an empty summary",
            file=sys.stderr,
        )
        return {}
    columns.pop("compute_device")
    summary: dict = {}
    for device, group in _group_by_device(rows).items():
        stats = summary.setdefault(device, {})
        for column in columns:
            values = np.array([row[column] for row in group
                               if row.get(column) is not None],
                              dtype=np.float64)
            stats[column] = {
                "mean": float(values.mean()) if len(values) else np.nan,
                "max": float(values.max()) if len(values) else np.nan,
                "min": float(values.min()) if len(values) else np.nan,
                "sum": float(values.sum()),
                "count": len(values),
            }
    return summary


def print_log_table(summary: dict) -> None:
    """The ``--log-dir`` table: one block per compute device, one row per
    column (the JAX package prints its pandas frame instead)."""
    for device, stats in summary.items():
        print(f"compute_device {device or '<unknown>'}:")
        print(f"  {'column':<28} " + " ".join(
            f"{name:>12}" for name in _LOG_STATS))
        for column, values in stats.items():
            print(f"  {column:<28} " + " ".join(
                f"{values[name]:>12.6g}" for name in _LOG_STATS))


def print_summary(log_dir: str, output_size=None) -> None:
    records = load_log_dir(log_dir)
    if not records:
        print(f"no task logs found in {log_dir}")
        return
    print_log_table(summarize(records, output_size=output_size))
    # canonical throughput: voxels per mean total task time
    rows = [
        {
            "compute_device": _record_device(r),
            "total": sum(_record_timer(r).values()),
            "voxels": (
                r["_bbox"].voxel_count
                if r.get("_bbox") is not None
                else (int(np.prod(output_size)) if output_size else 0)
            ),
        }
        for r in records
    ]
    for device, group in _group_by_device(rows).items():
        mean_time = np.mean([row["total"] for row in group])
        voxels = np.mean([row["voxels"] for row in group])
        if mean_time > 0 and voxels:
            print(
                f"device {device or '<unknown>'}: "
                f"{voxels / mean_time / 1e6:.2f} Mvoxel/s "
                f"({len(group)} tasks)"
            )


# ---------------------------------------------------------------------------
# telemetry JSONL aggregation (core/telemetry.py event stream)
# ---------------------------------------------------------------------------
_ROTATION_RE = re.compile(r"^(?P<base>.+\.jsonl)(?:\.(?P<gen>\d+))?$")


def load_telemetry_dir(metrics_dir: str) -> List[dict]:
    """Parse every ``telemetry-*.jsonl`` (plus every size-capped
    ``.jsonl.<N>`` rotation generation — ``CHUNKFLOW_TELEMETRY_KEEP``
    controls how many survive — read oldest-first so a worker's stream
    stays in order) under ``metrics_dir`` into a flat event list — one
    file per worker; the aggregate is the fleet view. Torn trailing
    lines (a worker killed mid-write) are skipped, not fatal."""
    events: List[dict] = []
    if not os.path.isdir(metrics_dir):
        return events
    matches = {
        name: m for name in os.listdir(metrics_dir)
        if (m := _ROTATION_RE.match(name)) is not None
    }
    # "<base>.jsonl.N" holds OLDER events than ".jsonl.N-1" holds OLDER
    # events than the live "<base>.jsonl": sort each base's generations
    # highest-suffix-first, immediately before their live file
    names = sorted(
        matches,
        key=lambda n: (matches[n].group("base"),
                       -int(matches[n].group("gen") or 0)),
    )
    for name in names:
        with open(os.path.join(metrics_dir, name)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue
                if isinstance(record, dict):
                    events.append(record)
    return events


def _event_worker(record: dict) -> str:
    """Worker identity of one event: the ``worker`` stamp, with a
    pid-based fallback for pre-fleet streams."""
    return str(record.get("worker") or f"pid-{record.get('pid', 0)}")


def summarize_telemetry(events: List[dict]) -> dict:
    """Aggregate a telemetry event stream into::

        {"spans":    {name: {count, total_s, mean_s, max_s}},
         "counters": {name: value},          # summed over snapshots/pids
         "gauges":   {name: {last, mean}},   # ring occupancy etc.
         "stall":    {phase: {total_s, share}},  # load/stage/.../write
         "depth_changes": [event, ...]}  # adaptive scheduler widenings

    ``stall`` shares are fractions of the summed pipeline-phase time, so
    "drain-bound" is literally ``stall['pipeline/drain']['share'] >
    0.5``. Span events are the ground truth; per-pid snapshot events
    contribute counters (each pid's final snapshot only) and fill in
    span stats for streams recorded without span-level events.
    ``depth_changes`` preserves the scheduler's ``depth_change`` events
    in stream order (final depths also ride the ``scheduler/depth/*``
    gauges)."""
    spans: dict = {}
    gauge_stats: dict = {}
    gauge_last: dict = {}
    snapshots_by_pid: dict = {}
    depth_changes: list = []
    for record in events:
        kind = record.get("kind")
        if kind == "depth_change":
            depth_changes.append(record)
        elif kind == "span":
            name = record.get("name", "")
            dur = float(record.get("dur_s", 0.0))
            s = spans.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            s["count"] += 1
            s["total_s"] += dur
            s["max_s"] = max(s["max_s"], dur)
        elif kind == "gauge":
            name = record.get("name", "")
            value = float(record.get("value", 0.0))
            g = gauge_stats.setdefault(name, [0, 0.0])
            g[0] += 1
            g[1] += value
            gauge_last[name] = value
        elif kind == "snapshot":
            # last snapshot per worker wins (a run may flush more than
            # once: the supervised claim loop emits periodic snapshots
            # so killed workers still leave a counter record)
            snapshots_by_pid[_event_worker(record)] = record

    counters: dict = {}
    qhists: dict = {}
    for snap in snapshots_by_pid.values():
        for name, value in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + value
        for name, h in (snap.get("qhists") or {}).items():
            # fixed-bound bucket counts sum exactly across workers —
            # the property that makes fleet-wide p50/p99 well-defined
            agg_h = qhists.setdefault(
                name, {"count": 0, "total": 0.0,
                       "buckets": [0] * len(h.get("buckets") or [])})
            agg_h["count"] += h.get("count", 0)
            agg_h["total"] += h.get("total", 0.0)
            for i, n in enumerate(h.get("buckets") or []):
                if i < len(agg_h["buckets"]):
                    agg_h["buckets"][i] += n
                else:
                    agg_h["buckets"].append(n)
        for name, value in (snap.get("gauges") or {}).items():
            # snapshot gauges fill holes for streams with no gauge-level
            # events (a worker killed before any sink was configured, or
            # counters-only periodic snapshots)
            if name not in gauge_stats:
                gauge_stats[name] = [1, float(value)]
                gauge_last[name] = float(value)
        for name, h in (snap.get("hists") or {}).items():
            # snapshot hists cover spans recorded while no sink was
            # configured yet; only fill holes, never double-count (and a
            # gauge's histogram is occupancy, not a span)
            if name not in spans and name not in gauge_stats \
                    and name not in (snap.get("gauges") or {}):
                spans[name] = {
                    "count": h.get("count", 0),
                    "total_s": h.get("total", 0.0),
                    "max_s": h.get("max", 0.0),
                }
    for s in spans.values():
        s["mean_s"] = s["total_s"] / s["count"] if s["count"] else 0.0

    gauges = {
        name: {"last": gauge_last.get(name, 0.0),
               "mean": g[1] / g[0] if g[0] else 0.0}
        for name, g in gauge_stats.items()
    }

    programs = summarize_programs(events)
    stall_total = sum(
        spans[p]["total_s"] for p in STALL_PHASES if p in spans
    )
    stall = {
        p: {
            "total_s": spans[p]["total_s"],
            "share": (spans[p]["total_s"] / stall_total
                      if stall_total > 0 else 0.0),
        }
        for p in STALL_PHASES if p in spans
    }
    return {"spans": spans, "counters": counters, "gauges": gauges,
            "stall": stall, "depth_changes": depth_changes,
            "programs": programs, "qhists": qhists}


# ---------------------------------------------------------------------------
# device program view (core/profiling.py cost ledger)
# ---------------------------------------------------------------------------
def summarize_programs(events: List[dict]) -> List[dict]:
    """Per-program cost entries from the telemetry stream: the LAST
    ``programs``-kind catalog event per worker wins (it carries the
    roofline derivations); workers that died before a catalog flush
    fall back to their raw per-build ``compile`` events. Entries are
    stamped with their worker and ranked by LOST SECONDS —
    ``(dispatch_wall − roofline_s) × calls``, the total wall a program
    spent above its cost-model floor — so "what do I fuse next" is one
    command; entries without a roofline figure (died-early workers'
    compile events) fall back behind them, by compile seconds."""
    catalogs: dict = {}
    compiles: dict = {}
    for record in events:
        kind = record.get("kind")
        worker = _event_worker(record)
        if kind == "programs":
            catalogs[worker] = record.get("programs") or []
        elif kind == "compile":
            compiles.setdefault(worker, []).append({
                "family": record.get("family", ""),
                "key": record.get("key", ""),
                "build_s": record.get("build_s"),
                "compile_s": record.get("compile_s"),
                "flops": record.get("flops"),
                "bytes_accessed": record.get("bytes_accessed"),
                "device_kind": record.get("device", ""),
            })
    entries: List[dict] = []
    for worker in sorted(set(catalogs) | set(compiles)):
        source = catalogs.get(worker) or compiles.get(worker) or []
        for entry in source:
            row = dict(entry)
            row["worker"] = worker
            entries.append(row)
    entries.sort(key=lambda e: (
        -(e.get("lost_s") or 0.0), -(e.get("compile_s") or 0.0)
    ))
    return entries


def _fmt_quantity(value, scale: float, suffix: str) -> str:
    if value is None:
        return "-"
    return f"{value / scale:.2f}{suffix}"


def print_program_summary(programs: List[dict], top: int = 10,
                          headroom_bytes: Optional[float] = None) -> None:
    """The DEVICE PROGRAMS table: top program families by LOST SECONDS
    ((mean time − roofline) × calls — the fusion-target ranking; the
    port's catalog takes device time where its card read it, else the
    dispatch wall, and the table then shows both),
    with the catalog's cost figures (the JAX package's XLA cost
    analysis, the port's analytic stamp: ``core/profiling.py``) and the
    achieved-vs-roofline figure when the catalog carried one.
    ``headroom_bytes`` (the live ``device/hbm_headroom`` gauge — the
    worst chip's free HBM) prints next to the table so the ``vmem`` /
    ``hbm_i`` budget columns read against what is actually left."""
    if not programs:
        return
    # a port catalog from a card carries device time beside the dispatch
    # wall: both columns then, and util on the entry's ``util_basis``
    timed = any(e.get("device_mean_s") for e in programs[:top])
    if timed:
        print("device programs (top by lost seconds = (device − roofline) "
              "× calls; util on device time where read, else an upper "
              "bound on the dispatch wall):")
    else:
        print("device programs (top by lost seconds = (dispatch − "
              "roofline) × calls; util is an upper bound under async "
              "dispatch):")
    if headroom_bytes is not None:
        print(f"  live hbm headroom: {headroom_bytes / 2**20:.1f} MiB "
              f"(min across chips) — the budget the vmem/hbm_i columns "
              f"spend from")
    print(
        f"  {'family':<14} {'key':<12} {'lost_s':>8} {'compile_s':>9} "
        f"{'flops':>9} {'bytes':>9} {'vmem':>8} {'h2d':>9} "
        f"{'hbm_i':>8} {'exec_ms':>8} "
        + (f"{'device_ms':>9} " if timed else "") + f"{'roofline':>8}"
    )
    for entry in programs[:top]:
        exec_s = entry.get("exec_mean_s")
        device_s = entry.get("device_mean_s")
        util = entry.get("roofline_util")
        lost = entry.get("lost_s")
        device_col = (f"{device_s * 1e3 if device_s else 0.0:>9.2f} "
                      if timed else "")
        print(
            f"  {str(entry.get('family', ''))[:14]:<14} "
            f"{str(entry.get('key', ''))[:12]:<12} "
            f"{(f'{lost:.3f}' if lost is not None else '-'):>8} "
            f"{entry.get('compile_s') or 0.0:>9.3f} "
            f"{_fmt_quantity(entry.get('flops'), 1e9, 'G'):>9} "
            f"{_fmt_quantity(entry.get('bytes_accessed'), 2**20, 'M'):>9} "
            f"{_fmt_quantity(entry.get('vmem_bytes'), 2**20, 'M'):>8} "
            f"{_fmt_quantity(entry.get('h2d_bytes'), 2**20, 'M'):>9} "
            # inter-stage stack traffic: the separate-programs
            # legs' gathered/weighted stack bytes; ~0/- for the fused
            # pipeline — the fusion's prize, in bytes
            f"{_fmt_quantity(entry.get('hbm_intermediate_bytes'), 2**20, 'M'):>8} "
            f"{exec_s * 1e3 if exec_s else 0.0:>8.2f} "
            f"{device_col}"
            f"{(f'{util:.1%}' if util is not None else '-'):>8}"
        )


def print_mesh_block(agg: dict, indent: str = "") -> bool:
    """The MESH block (docs/multichip.md "Reading chip skew",
    docs/observability.md "Timeline view"): mesh shape, a per-chip table
    folding the ``shard/chip/<i>/*`` load/readiness gauges with the
    ``device/chip/<i>/*`` HBM watermarks, the dispatch skew, the
    analytic halo/gather byte planes, and the collective-vs-compute
    split estimate — the evidence for choosing a scaling shape. Quiet
    (returns False) for runs that never built a sharded engine."""
    gauges = agg["gauges"]
    devices = gauges.get("shard/mesh_devices")
    if not devices or devices.get("last", 0) <= 0:
        return False
    # fold <plane>/chip/<i>/<metric> gauges into {chip: {metric: stats}}
    chips: dict = {}
    for name, g in gauges.items():
        m = telemetry.CHIP_METRIC_RE.match(name)
        if m and m.group("plane") in ("shard", "device"):
            chips.setdefault(int(m.group("chip")), {})[
                m.group("metric")] = g
    ny = gauges.get("shard/mesh_y", {}).get("last", 1)
    nx = gauges.get("shard/mesh_x", {}).get("last", 1)
    npipe = gauges.get("shard/mesh_pipeline", {}).get("last", 0)
    shape = (f"pipeline={npipe:g}" if npipe > 1
             else f"y={ny:g},x={nx:g}" if ny > 1 or nx > 1
             else f"data={devices['last']:g}")
    chunks = agg["counters"].get("shard/chunks", 0)
    print(f"{indent}mesh (docs/multichip.md):")
    print(f"{indent}  shape {shape} ({devices['last']:g} chip(s)), "
          f"{chunks:g} sharded dispatch(es)")
    if chips:
        print(f"{indent}  {'chip':<5} {'voxels':>10} {'ready_s':>10} "
              f"{'hbm_mib':>9} {'headroom_mib':>13}")
        for chip in sorted(chips):
            metrics = chips[chip]
            vox = metrics.get("voxels")
            ready = metrics.get("ready_s")
            hbm = metrics.get("bytes_in_use")
            head = metrics.get("hbm_headroom")
            vox_s = f"{vox['last']:g}" if vox else "-"
            ready_s = f"{ready['last']:.6f}" if ready else "-"
            hbm_s = f"{hbm['last'] / 2**20:.1f}" if hbm else "-"
            head_s = f"{head['last'] / 2**20:.1f}" if head else "-"
            print(f"{indent}  {chip:<5} {vox_s:>10} {ready_s:>10} "
                  f"{hbm_s:>9} {head_s:>13}")
    skew = gauges.get("shard/chip_skew_s")
    if skew:
        print(f"{indent}  chip skew (last ready − first ready): last "
              f"{skew['last']:.6f}s mean {skew['mean']:.6f}s")
    halo = agg["counters"].get("shard/halo_bytes", 0)
    gather = agg["counters"].get("shard/gather_bytes", 0)
    strips = agg["counters"].get("shard/replay_strip_bytes", 0)
    handoff = agg["counters"].get("shard/handoff_bytes", 0)
    if halo or gather or strips or handoff:
        parts = [f"halo {halo / 2**20:.2f} MiB",
                 f"gather {gather / 2**20:.2f} MiB"]
        if strips:
            parts.append(f"replay strips {strips / 2**20:.2f} MiB")
        if handoff:
            parts.append(f"stage handoffs {handoff / 2**20:.2f} MiB")
        print(f"{indent}  analytic collective traffic: "
              f"{', '.join(parts)} (cumulative)")
    share = gauges.get("shard/collective_share_est")
    if share:
        compute = gauges.get("shard/compute_s_est", {}).get("last", 0.0)
        coll = gauges.get("shard/collective_s_est", {}).get("last", 0.0)
        verdict = ("collective-bound" if share["last"] > 0.5
                   else "compute-bound")
        print(f"{indent}  split estimate per dispatch: compute "
              f"{compute:.6f}s vs collective {coll:.6f}s "
              f"(share {share['last']:.0%} — {verdict}; HBM-bandwidth "
              f"proxy, a lower bound on interconnect pressure)")
        # collective verdict -> shape hint (docs/multichip.md "Choosing
        # a scaling shape"): collective-bound meshes should trade the
        # interconnect plane that dominates; a compute-bound mesh is
        # already using the right shape, scale it instead
        if share["last"] > 0.5:
            if gather and not strips:
                hint = ("replicated replay dominates — flip "
                        "CHUNKFLOW_SHARD_REPLAY=sharded (the default) "
                        "to drop the weighted-stack all_gather")
            elif handoff:
                hint = ("stage handoffs dominate — fewer pipeline "
                        "stages, or a data/spatial mesh if the model "
                        "fits per chip")
            else:
                hint = ("halo/fringe exchange dominates — coarser "
                        "slabs (fewer chips per axis) or a data mesh")
            print(f"{indent}  shape hint: {hint}")
        elif tight_chips := [
            chip for chip, m in chips.items()
            if m.get("hbm_headroom", {}).get("last", float("inf"))
            < 2**30
        ]:
            print(f"{indent}  shape hint: compute-bound but chip(s) "
                  f"{tight_chips} have <1 GiB HBM headroom — a spatial "
                  f"mesh (sharded replay) shrinks per-chip blend "
                  f"buffers; pipeline=N shrinks per-chip parameters")
    return True


def print_profile_summaries(metrics_dir: str, top: int = 3) -> None:
    """Summarize every profiler capture under ``metrics_dir``
    (``profile-*`` directories: anomaly captures, the ``/profile`` route,
    ``--profile-dir`` windows pointed here): files, device time and the
    ``top`` categories by share (``flow/profile_summary.py``)."""
    import glob as _glob

    from chunkflow_tpu_torch.flow.profile_summary import summarize_trace_dir

    capture_dirs = sorted(
        d for d in _glob.glob(os.path.join(metrics_dir, "profile-*"))
        if os.path.isdir(d)
    )
    for capture_dir in capture_dirs:
        summary = summarize_trace_dir(capture_dir, top=top)
        name = os.path.basename(capture_dir)
        if summary["files"] == 0:
            print(f"profiler capture {name}: no trace files")
            continue
        cats = ", ".join(
            f"{row['category']} {row['share']:.0%}"
            for row in summary["categories"][:top]
        )
        print(
            f"profiler capture {name}: {summary['files']} file(s), "
            f"{summary['total_device_us'] / 1e3:.2f} ms device time"
            + (f" [{cats}]" if cats else "")
        )


def print_serving_block(agg: dict, indent: str = "") -> bool:
    """The SERVING block (docs/serving.md): request counters, in-flight
    level, mean device-batch occupancy and the p50/p99 request latency
    from the fleet-summed quantile-histogram buckets. Fed purely from
    the existing JSONL/registry plumbing; quiet (returns False) for
    runs that served no requests."""
    serving = {
        name: agg["counters"][name]
        for name in SERVING_COUNTERS if agg["counters"].get(name)
    }
    if not serving:
        return False
    print(f"{indent}serving (docs/serving.md):")
    for name in SERVING_COUNTERS:
        if name in serving:
            print(f"{indent}  {name:<28} {serving[name]:>7g}")
    inflight = agg["gauges"].get("serving/inflight")
    occupancy = agg["gauges"].get("serving/occupancy")
    parts = []
    if inflight is not None:
        parts.append(f"in-flight last {inflight['last']:g}")
    if occupancy is not None:
        parts.append(f"batch occupancy mean {occupancy['mean']:.0%}")
    latency = (agg.get("qhists") or {}).get("serving/latency")
    if latency:
        p50 = telemetry.quantile_from_buckets(latency, 0.5)
        p99 = telemetry.quantile_from_buckets(latency, 0.99)
        if p50 is not None:
            parts.append(f"latency p50 {p50 * 1e3:.1f}ms "
                         f"p99 {p99 * 1e3:.1f}ms")
    if parts:
        print(f"{indent}  -> " + ", ".join(parts))
    if serving.get("serving/deadline_missed") or (
            serving.get("serving/rejected_admission")
            or serving.get("serving/rejected_memory")):
        print(f"{indent}  -> shedding load: raise --max-inflight / the "
              f"memory watermark, or add serving workers")
    return True


def print_segment_block(agg: dict, indent: str = "") -> bool:
    """The SEGMENT block (docs/segmentation.md): the map -> reduce ->
    map counters of a whole-volume stitching job. Quiet (returns False)
    for runs that never labeled a chunk."""
    segment = {
        name: agg["counters"][name]
        for name in SEGMENT_COUNTERS if agg["counters"].get(name)
    }
    if not segment:
        return False
    print(f"{indent}segment (docs/segmentation.md):")
    for name in SEGMENT_COUNTERS:
        if name in segment:
            print(f"{indent}  {name:<28} {segment[name]:>7g}")
    labeled = segment.get("segment/chunks_labeled", 0)
    relabeled = segment.get("segment/voxels_relabeled", 0)
    parts = []
    if labeled:
        parts.append(f"{labeled:g} chunk(s) labeled")
    if segment.get("segment/edges_found"):
        parts.append(
            f"{segment['segment/edges_found']:g} cross-chunk edge(s)"
        )
    if relabeled:
        parts.append(f"{relabeled:g} voxel(s) rewritten")
    if parts:
        print(f"{indent}  -> " + ", ".join(parts))
    return True


def print_storage_block(agg: dict, indent: str = "") -> bool:
    """The STORAGE block (docs/storage.md): block cache hit rate, bytes
    moved, and the aligned/unaligned write split. Quiet (returns False)
    for runs that never touched the storage plane."""
    storage = {
        name: agg["counters"][name]
        for name in STORAGE_COUNTERS if agg["counters"].get(name)
    }
    if not storage:
        return False
    print(f"{indent}storage (docs/storage.md):")
    for name in STORAGE_COUNTERS:
        if name in storage:
            print(f"{indent}  {name:<28} {storage[name]:>7g}")
    hits = storage.get("storage/hits", 0)
    misses = storage.get("storage/misses", 0)
    parts = []
    if hits + misses:
        parts.append(f"block cache hit rate {hits / (hits + misses):.0%}")
    cache_bytes = agg["gauges"].get("storage/cache_bytes")
    if cache_bytes is not None:
        parts.append(f"cache {cache_bytes['last'] / 2**20:.1f} MiB")
    read_span = agg["spans"].get("storage/read")
    write_span = agg["spans"].get("storage/write")
    if read_span:
        parts.append(f"read {read_span['total_s']:.3f}s")
    if write_span:
        parts.append(f"write {write_span['total_s']:.3f}s")
    if parts:
        print(f"{indent}  -> " + ", ".join(parts))
    if hits + misses and hits / (hits + misses) < 0.25 and misses > 16:
        print(f"{indent}  -> cache-cold: overlapping reads mostly miss "
              f"— raise CHUNKFLOW_STORAGE_CACHE_MB or check the task "
              f"grid ordering (docs/storage.md)")
    return True


# ---------------------------------------------------------------------------
# SLO view: fleet-merged time series, sparklines, alert timeline
# ---------------------------------------------------------------------------
#: sparkline glyphs, lowest to highest (an empty bin renders as space)
_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(points: List[tuple], width: int = 48) -> str:
    """A one-line timeline of ``[(t, value), ...]``: values resampled
    to at most ``width`` buckets (bucket mean), scaled min→max across
    the 8 block glyphs. Constant series render mid-scale; empty series
    render empty."""
    values = [float(v) for _, v in points if v is not None]
    if not values:
        return ""
    if len(values) > width:
        step = len(values) / width
        values = [
            float(np.mean(values[int(i * step):max(int(i * step) + 1,
                                                   int((i + 1) * step))]))
            for i in range(width)
        ]
    lo, hi = min(values), max(values)
    if hi <= lo:
        return _SPARK_BLOCKS[3] * len(values)
    scale = (len(_SPARK_BLOCKS) - 1) / (hi - lo)
    return "".join(
        _SPARK_BLOCKS[int(round((v - lo) * scale))] for v in values
    )


def summarize_timeseries(events: List[dict]) -> dict:
    """Fleet-merge the ``timeseries``-kind sampler events
    (core/telemetry.py) into per-metric timelines::

        {"series": {name: [(bin_t, value), ...]}, "bin_s": float}

    Binned to the sampler interval; within a bin, ``rate:*`` series SUM
    across workers (a fleet serves the sum of its workers' request
    rates) while ``gauge:``/``p50:``/``p99:`` series average. Per-worker
    latency quantiles do not merge, so fleet quantiles are rebuilt the
    only correct way: each event carries its worker's raw cumulative
    qhist buckets, consecutive events difference into per-bin bucket
    deltas, deltas sum across workers (fixed bounds!), and the summed
    delta histogram yields a ``fleet_p99:<qhist>``/``fleet_p50:<qhist>``
    point per bin — the fleet's latency distribution in that window."""
    ts_events = [e for e in events if e.get("kind") == "timeseries"]
    if not ts_events:
        return {"series": {}, "bin_s": None}
    intervals = sorted(
        float(e.get("interval_s") or 0) for e in ts_events
        if e.get("interval_s")
    )
    bin_s = max(intervals[len(intervals) // 2], 1e-3) if intervals else 10.0

    # worker -> [(t, values, qhists)] in time order
    by_worker: dict = {}
    for e in ts_events:
        by_worker.setdefault(_event_worker(e), []).append(e)
    # bin -> name -> worker -> [values]  (then mean per worker, merge)
    bins: dict = {}
    qbins: dict = {}  # bin -> qname -> summed delta {"count", "buckets"}
    for worker, stream in by_worker.items():
        stream.sort(key=lambda e: e.get("t", 0.0))
        prev_qh: dict = {}
        for e in stream:
            t = float(e.get("t", 0.0))
            b = int(t // bin_s)
            for name, value in (e.get("values") or {}).items():
                if value is None:
                    continue
                bins.setdefault(b, {}).setdefault(
                    name, {}).setdefault(worker, []).append(float(value))
            for qname, h in (e.get("qhists") or {}).items():
                buckets = list(h.get("buckets") or [])
                count = float(h.get("count", 0))
                prev = prev_qh.get(qname)
                if prev is not None:
                    d_count = count - prev[0]
                    d_buckets = [
                        cur - old for cur, old in zip(
                            buckets, prev[1] + [0] * len(buckets))
                    ]
                    if d_count > 0:
                        agg = qbins.setdefault(b, {}).setdefault(
                            qname, {"count": 0.0,
                                    "buckets": [0.0] * len(d_buckets)})
                        agg["count"] += d_count
                        for i, d in enumerate(d_buckets):
                            if i < len(agg["buckets"]):
                                agg["buckets"][i] += max(0.0, d)
                            else:
                                agg["buckets"].append(max(0.0, d))
                prev_qh[qname] = (count, buckets)

    series: dict = {}
    for b in sorted(bins):
        bin_t = (b + 0.5) * bin_s
        for name, per_worker in bins[b].items():
            worker_means = [sum(vs) / len(vs)
                            for vs in per_worker.values()]
            if name.startswith("rate:"):
                value = sum(worker_means)  # fleet rate = sum of workers
            else:
                value = sum(worker_means) / len(worker_means)
            series.setdefault(name, []).append((bin_t, value))
    for b in sorted(qbins):
        bin_t = (b + 0.5) * bin_s
        for qname, agg in qbins[b].items():
            for q, label in ((0.5, "fleet_p50"), (0.99, "fleet_p99")):
                value = telemetry.quantile_from_buckets(agg, q)
                if value is not None:
                    series.setdefault(
                        f"{label}:{qname}", []).append((bin_t, value))
    return {"series": series, "bin_s": bin_s}


#: merged series worth a timeline in the SLO block, in display order
#: (prefix match); everything else stays queryable via the returned agg
_SLO_TIMELINE_PREFIXES = (
    "rate:serving/requests", "rate:serving/errors",
    "rate:serving/deadline_missed", "rate:tasks/dead_lettered",
    "fleet_p99:", "fleet_p50:", "gauge:serving/inflight",
    "gauge:slo/",
)


def _slo_gauge_state(events: List[dict]) -> dict:
    """Last-seen ``slo/*`` gauge values per worker, from gauge events
    (stream order) with snapshot-gauge hole-filling — the same recovery
    contract as the rest of the summary: a SIGKILLed worker's final
    periodic snapshot still tells us whether it was firing."""
    state: dict = {}  # worker -> {gauge_name: value}
    for record in events:
        worker = _event_worker(record)
        if record.get("kind") == "gauge" and \
                str(record.get("name", "")).startswith("slo/"):
            state.setdefault(worker, {})[record["name"]] = float(
                record.get("value", 0.0))
        elif record.get("kind") == "snapshot":
            for name, value in (record.get("gauges") or {}).items():
                if name.startswith("slo/"):
                    state.setdefault(worker, {}).setdefault(
                        name, float(value))
    return state


def print_slo_block(events: List[dict], indent: str = "",
                    width: int = 48) -> bool:
    """The SLO block (docs/observability.md "SLO view"): every alert
    event in the merged stream (fired and resolved, with burn-rate and
    budget attributes), per-objective fleet state from the ``slo/*``
    gauges, and fleet-merged sparkline timelines from the timeseries
    events — all reconstructed from JSONL alone, so it works on the
    metrics dir of a fleet that is already dead. Quiet (returns False)
    when the stream carries no SLO plane at all."""
    fired = [e for e in events if e.get("kind") == "alert"
             and e.get("state", "firing") == "firing"]
    resolved = [e for e in events if e.get("kind") == "alert"
                and e.get("state") == "resolved"]
    gauge_state = _slo_gauge_state(events)
    ts = summarize_timeseries(events)
    if not fired and not resolved and not gauge_state and not ts["series"]:
        return False
    print(f"{indent}slo (docs/observability.md \"SLO view\"):")
    print(f"{indent}  alerts fired: {len(fired)} "
          f"({len(resolved)} resolved)")
    for e in sorted(fired, key=lambda e: e.get("t", 0.0)):
        print(
            f"{indent}    [{_event_worker(e)}] {e.get('alert', '?')} "
            f"{e.get('severity', '?')} "
            f"burn_short={e.get('burn_short', 0):g} "
            f"burn_long={e.get('burn_long', 0):g} "
            f"budget_remaining={e.get('budget_remaining', 0):g}"
        )
    # per-objective fleet state: a worker is firing if its last gauge
    # said so; budget is the worst (minimum) across workers
    objectives: dict = {}
    for worker, gauges in gauge_state.items():
        for name, value in gauges.items():
            parts = name.split("/")
            if len(parts) != 3:
                continue
            _, obj, field = parts
            entry = objectives.setdefault(
                obj, {"firing": [], "budget": None, "burn": None})
            if field == "firing" and value >= 1.0:
                entry["firing"].append(worker)
            elif field == "budget_remaining":
                entry["budget"] = (value if entry["budget"] is None
                                   else min(entry["budget"], value))
            elif field == "burn_rate":
                entry["burn"] = (value if entry["burn"] is None
                                 else max(entry["burn"], value))
    for obj in sorted(objectives):
        entry = objectives[obj]
        line = f"{indent}  objective {obj}:"
        if entry["budget"] is not None:
            line += f" budget remaining {entry['budget']:.1%}"
        if entry["burn"] is not None:
            line += f" burn {entry['burn']:g}x"
        if entry["firing"]:
            line += f" FIRING ({', '.join(sorted(entry['firing']))})"
        print(line)
    if ts["series"]:
        shown = []
        for prefix in _SLO_TIMELINE_PREFIXES:
            shown += sorted(
                name for name in ts["series"]
                if name.startswith(prefix) and name not in shown
            )
        if shown:
            print(f"{indent}  timelines (fleet-merged, "
                  f"~{ts['bin_s']:g}s bins):")
        for name in shown[:12]:
            points = ts["series"][name]
            line = sparkline(points, width=width)
            last = points[-1][1]
            print(f"{indent}    {name:<32} {line} last={last:g}")
    return True


def print_slo_summary(metrics_dir: str, width: int = 48) -> Optional[dict]:
    """The ``log-summary --slo`` report over a metrics dir; returns the
    merged timeseries aggregate (None when the dir has no events)."""
    events = load_telemetry_dir(metrics_dir)
    if not events:
        print(f"no telemetry events found in {metrics_dir}")
        return None
    print(f"telemetry: {len(events)} events from {metrics_dir}")
    if not print_slo_block(events, width=width):
        print("no SLO events in this stream (run with --metrics-dir and "
              "the SLO plane enabled; docs/observability.md \"SLO view\")")
    return summarize_timeseries(events)


def print_telemetry_summary(metrics_dir: str) -> Optional[dict]:
    """Human report over a metrics dir; returns the aggregate (None when
    the dir holds no events — e.g. the run had CHUNKFLOW_TELEMETRY=0)."""
    events = load_telemetry_dir(metrics_dir)
    if not events:
        print(f"no telemetry events found in {metrics_dir}")
        return None
    agg = summarize_telemetry(events)
    print(f"telemetry: {len(events)} events from {metrics_dir}")
    if agg["stall"]:
        print("pipeline stall attribution (host wall-clock per phase):")
        for phase in STALL_PHASES:
            if phase in agg["stall"]:
                s = agg["stall"][phase]
                print(
                    f"  {phase:<20} {s['total_s']:>9.3f}s "
                    f"{100 * s['share']:>5.1f}%"
                )
        bound = max(agg["stall"], key=lambda p: agg["stall"][p]["share"])
        print(f"  -> dominant phase: {bound}")
    fault = {
        name: agg["counters"][name]
        for name in LIFECYCLE_COUNTERS if agg["counters"].get(name)
    }
    if fault:
        print("fault tolerance (docs/fault_tolerance.md):")
        for name in LIFECYCLE_COUNTERS:
            if name in fault:
                print(f"  {name:<24} {fault[name]:>7g}")
        if fault.get("tasks/dead_lettered"):
            print(
                "  -> dead-lettered tasks pending triage: inspect with "
                "`chunkflow dead-letter -q <queue>`"
            )
    print_segment_block(agg)
    print_storage_block(agg)
    print_serving_block(agg)
    fleet = {
        name: agg["counters"][name]
        for name in FLEET_COUNTERS if agg["counters"].get(name)
    }
    if fleet:
        print('fleet supervisor (docs/fault_tolerance.md "Running a '
              'fleet"):')
        for name in FLEET_COUNTERS:
            if name in fleet:
                print(f"  {name:<24} {fleet[name]:>7g}")
        workers_gauge = agg["gauges"].get("fleet/workers")
        target_gauge = agg["gauges"].get("fleet/target")
        if workers_gauge or target_gauge:
            print(
                f"  final size: {(workers_gauge or {}).get('last', 0):g}"
                f" worker(s), target "
                f"{(target_gauge or {}).get('last', 0):g}"
            )
    occupancy = agg["gauges"].get("pipeline/ring_occupancy")
    if occupancy:
        print(
            f"ring occupancy: mean {occupancy['mean']:.2f}, "
            f"last {occupancy['last']:g}"
        )
    depth_gauges = {
        name.rsplit("/", 1)[-1]: g["last"]
        for name, g in agg["gauges"].items()
        if name.startswith("scheduler/depth/")
    }
    if depth_gauges or agg.get("depth_changes"):
        changes = agg.get("depth_changes") or []
        final = ", ".join(
            f"{k}={v:g}" for k, v in sorted(depth_gauges.items())
        )
        print(
            f"adaptive scheduler: {len(changes)} depth change(s)"
            + (f"; final adapted depths: {final}" if final else "")
        )
    builds = agg["counters"].get("compile_cache/builds")
    hits = agg["counters"].get("compile_cache/hits")
    if builds is not None or hits is not None:
        print(
            f"program cache: {builds or 0:g} build(s), {hits or 0:g} "
            f"hit(s)"
        )
    print_program_summary(
        agg.get("programs") or [],
        headroom_bytes=(agg["gauges"].get("device/hbm_headroom")
                        or {}).get("last"),
    )
    if agg["counters"].get("compile_cache/retrace_warnings"):
        print(
            f"RETRACE WARNINGS: "
            f"{agg['counters']['compile_cache/retrace_warnings']:g} "
            f"(builds exceeded the expected bucket count)"
        )
    print_mesh_block(agg)
    if agg["gauges"].get("device/bytes_in_use"):
        mem = agg["gauges"]["device/bytes_in_use"]
        peak = agg["gauges"].get("device/peak_bytes", {})
        head = agg["gauges"].get("device/hbm_headroom")
        line = (
            f"device memory: {mem['last'] / 2**20:.1f} MiB in use (last), "
            f"peak {peak.get('last', 0) / 2**20:.1f} MiB"
        )
        if head:
            line += (f", headroom {head['last'] / 2**20:.1f} MiB "
                     f"(worst chip)")
        print(line)
    if agg["spans"]:
        print(f"  {'span':<28} {'count':>7} {'total_s':>9} {'mean_s':>9}")
        for name in sorted(agg["spans"]):
            s = agg["spans"][name]
            print(
                f"  {name:<28} {s['count']:>7} {s['total_s']:>9.3f} "
                f"{s['mean_s']:>9.4f}"
            )
    print_profile_summaries(metrics_dir)
    return agg


# ---------------------------------------------------------------------------
# fleet view: per-worker aggregation + per-trace timelines
# ---------------------------------------------------------------------------
def summarize_fleet(events: List[dict]) -> dict:
    """Merge a multi-worker event stream by worker identity::

        {worker: {"spans": {...}, "counters": {...}, "stall": {...},
                  "dominant": phase|None, "retries": n, "ledger_skips": n,
                  "committed": n, "dead_lettered": n,
                  "cache_hit_rate": float|None,
                  "device_bytes_in_use": float|None}}

    Each worker's sub-stream goes through :func:`summarize_telemetry`,
    so per-worker stall shares and counters agree with the single-worker
    report (and with the live registry each worker exported)."""
    by_worker: dict = {}
    for record in events:
        by_worker.setdefault(_event_worker(record), []).append(record)
    fleet = {}
    for worker, stream in sorted(by_worker.items()):
        agg = summarize_telemetry(stream)
        counters = agg["counters"]
        builds = counters.get("compile_cache/builds", 0)
        hits = counters.get("compile_cache/hits", 0)
        dominant = (
            max(agg["stall"], key=lambda p: agg["stall"][p]["share"])
            if agg["stall"] else None
        )
        device_mem = agg["gauges"].get("device/bytes_in_use")
        latency = (agg.get("qhists") or {}).get("serving/latency")
        fleet[worker] = {
            "spans": agg["spans"],
            "counters": counters,
            "stall": agg["stall"],
            "dominant": dominant,
            "retries": counters.get("tasks/retried", 0),
            "ledger_skips": counters.get("ledger/skips", 0),
            "committed": counters.get("tasks/committed", 0),
            "dead_lettered": counters.get("tasks/dead_lettered", 0),
            "cache_hit_rate": (
                hits / (hits + builds) if (hits + builds) else None
            ),
            "storage_hit_rate": (
                counters.get("storage/hits", 0)
                / (counters.get("storage/hits", 0)
                   + counters.get("storage/misses", 0))
                if (counters.get("storage/hits", 0)
                    + counters.get("storage/misses", 0)) else None
            ),
            "device_bytes_in_use": (
                device_mem["last"] if device_mem else None
            ),
            "serving_requests": counters.get("serving/requests", 0),
            "serving_completed": counters.get("serving/completed", 0),
            "serving_deadline_missed": counters.get(
                "serving/deadline_missed", 0),
            "serving_latency": latency,
        }
    return fleet


def worker_clock_offsets(events: List[dict]) -> dict:
    """Per-worker clock corrections (seconds to ADD to that worker's
    ``t`` stamps) from the queue send/receive pairs in a merged stream.

    Two workers' ``time.time()`` bases can disagree, which makes a
    cross-worker hop appear to be claimed *before* it was submitted —
    and a trace flow that ends before it starts. But causality gives us
    a bound per pair: for every ``queue/submit`` (submitter's clock) and
    ``lifecycle/claimed`` (claimer's clock) sharing a ``trace_id``, the
    claim physically happened after the submit. Whenever a claim's raw
    stamp lands *earlier* than its submit, the gap is pure skew, and the
    claimer's clock gets shifted forward by the largest such gap
    observed (the minimal correction that makes every pair monotone;
    workers with no evidence of skew keep offset 0). The submitter's
    clock is the reference — offsets are never negative."""
    submits: dict = {}  # trace_id -> (worker, t) of the FIRST submit
    for record in events:
        if record.get("name") == "queue/submit" and record.get("trace_id"):
            submits.setdefault(
                record["trace_id"],
                (_event_worker(record), float(record.get("t", 0.0))),
            )
    offsets: dict = {}
    for record in events:
        if record.get("name") != "lifecycle/claimed":
            continue
        sub = submits.get(record.get("trace_id"))
        if sub is None:
            continue
        sub_worker, sub_t = sub
        claimer = _event_worker(record)
        if claimer == sub_worker:
            continue  # same clock: the pair carries no skew information
        lag = sub_t - float(record.get("t", 0.0))
        if lag > 0:
            offsets[claimer] = max(offsets.get(claimer, 0.0), lag)
    return offsets


def trace_timeline(events: List[dict], trace_id: str) -> List[dict]:
    """Every event stamped with ``trace_id`` (plus the queue/submit
    event that minted it), in time order — one task's full history
    across submit, claim(s), retry/requeue hops between workers, and
    commit or dead-letter, reconstructed from merged JSONL alone.
    Ordering uses skew-normalized stamps (:func:`worker_clock_offsets`
    over the WHOLE stream, so every hop pair contributes evidence): a
    claimer whose clock runs behind its submitter no longer sorts the
    claim before the submit."""
    offsets = worker_clock_offsets(events)
    hits = [
        record for record in events
        if record.get("trace_id") == trace_id
    ]
    hits.sort(key=lambda record: (
        record.get("t", 0.0) + offsets.get(_event_worker(record), 0.0)
    ))
    return hits


def print_fleet_summary(metrics_dir: str,
                        trace_id: Optional[str] = None) -> Optional[dict]:
    """The ``log-summary --fleet`` report: one block per worker (task
    outcomes, dominant stall share, cache hit rate, device memory) and,
    with ``--trace-id``, that task's merged cross-worker timeline.
    Returns the fleet aggregate (None when the dir holds no events)."""
    events = load_telemetry_dir(metrics_dir)
    if not events:
        print(f"no telemetry events found in {metrics_dir}")
        return None
    fleet = summarize_fleet(events)
    print(f"fleet: {len(fleet)} worker(s), {len(events)} events "
          f"from {metrics_dir}")
    for worker, info in fleet.items():
        print(f"worker {worker}:")
        print(
            f"  committed={info['committed']:g} retries={info['retries']:g} "
            f"ledger_skips={info['ledger_skips']:g} "
            f"dead_lettered={info['dead_lettered']:g}"
        )
        if info["stall"]:
            for phase in STALL_PHASES:
                if phase in info["stall"]:
                    s = info["stall"][phase]
                    print(
                        f"    {phase:<20} {s['total_s']:>9.3f}s "
                        f"{100 * s['share']:>5.1f}%"
                    )
            print(f"    -> dominant phase: {info['dominant']}")
        if info["cache_hit_rate"] is not None:
            print(f"  cache hit rate: {100 * info['cache_hit_rate']:.1f}%")
        if info.get("storage_hit_rate") is not None:
            print(f"  storage block cache hit rate: "
                  f"{100 * info['storage_hit_rate']:.1f}%")
        if info.get("serving_requests"):
            line = (f"  serving: requests={info['serving_requests']:g} "
                    f"completed={info['serving_completed']:g} "
                    f"deadline-misses={info['serving_deadline_missed']:g}")
            latency = info.get("serving_latency")
            if latency:
                p50 = telemetry.quantile_from_buckets(latency, 0.5)
                p99 = telemetry.quantile_from_buckets(latency, 0.99)
                if p50 is not None:
                    line += (f" p50={p50 * 1e3:.1f}ms "
                             f"p99={p99 * 1e3:.1f}ms")
            print(line)
        if info["device_bytes_in_use"] is not None:
            print(
                f"  device memory in use: "
                f"{info['device_bytes_in_use'] / 2**20:.1f} MiB"
            )
    if trace_id is not None:
        timeline = trace_timeline(events, trace_id)
        print(f"trace {trace_id}: {len(timeline)} event(s)")
        for record in timeline:
            kind = record.get("kind", "?")
            name = record.get("name", "")
            worker = _event_worker(record)
            extra = ""
            if kind == "span":
                extra = f" dur={record.get('dur_s', 0.0):.4f}s"
            elif record.get("body"):
                extra = f" body={record['body']}"
            if record.get("reason"):
                extra += f" reason={record['reason']}"
            print(f"  t={record.get('t', 0.0):.6f} [{worker}] "
                  f"{kind}:{name}{extra}")
    return fleet


# the reference's spellings
def load_log(log_dir: str) -> List[dict]:
    """The per-task records of a log directory (the JAX package returns
    them as a pandas frame)."""
    return load_log_dir(log_dir)


def print_log_statistics(records: List[dict], output_size=None) -> None:
    """The per-device table of already-loaded records."""
    if len(records) == 0:
        print("no log records")
        return
    print_log_table(summarize(records, output_size=output_size))
