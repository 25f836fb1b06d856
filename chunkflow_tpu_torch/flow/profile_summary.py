"""Where a ``torch.profiler`` capture's device time went.

The port's bounded captures (``core/profiling.py``: ``--profile-dir``
windows, anomaly captures, ``POST /profile``) are Chrome traces
(``trace.json``) that ``torch.profiler`` writes. The JAX package reads
its XLA traces with ``tools/analyze_trace.py``; this module is the
port's reader, with the same result: the device time of every capture
under a directory and its split by category, largest first.

Device time is the duration of the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. A capture with none (a CPU-only run) falls back
to its outermost ``cpu_op`` events on each thread, so nested operators
are counted once. Categories, by event name: the port's kernels
(``conv3d_int8`` for both int8 convolutions, ``gather``,
``accumulate``), then ``convolution`` (cuDNN), ``matmul``, ``copy``
(copies and fills), ``other``.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import re
from typing import List, Tuple

#: (category, name pattern), first match wins
CATEGORY_RULES = (
    ("conv3d_int8", re.compile(r"conv3d_int8", re.I)),
    ("gather", re.compile(r"\bgather_kernel\b")),
    ("accumulate", re.compile(r"\baccumulate_kernel\b")),
    ("convolution", re.compile(
        r"conv|fprop|dgrad|wgrad|cudnn|implicit_gemm|winograd", re.I)),
    ("matmul", re.compile(r"gemm|matmul|\bmm\b|addmm|\bdot\b", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy|fill", re.I)),
)

#: the trace event categories that are device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def categorize(name: str, cat: str = "") -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    for category, rx in CATEGORY_RULES:
        if rx.search(name):
            return category
    return "other"


def find_trace_files(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*trace.json"),
                            recursive=True))


def _outermost(events: List[dict]) -> List[dict]:
    """The events no other event of their thread encloses."""
    out = []
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for thread in by_thread.values():
        thread.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        end = None
        for e in thread:
            # an event that ends inside the last outermost one is nested
            # (rounded stamps can start the next one a hair before it ends)
            stop = float(e["ts"]) + float(e["dur"])
            if end is None or stop > end + 1e-3:
                out.append(e)
                end = stop
    return out


def device_op_durations(events) -> Tuple[collections.Counter,
                                         collections.Counter, dict]:
    """(name -> microseconds, name -> count, name -> category) of a
    trace's device events, or of its outermost CPU operators when it has
    none."""
    timed = [e for e in events
             if e.get("ph") == "X" and "dur" in e and "ts" in e]
    chosen = [e for e in timed if e.get("cat") in DEVICE_CATS]
    if not chosen:
        chosen = _outermost([e for e in timed if e.get("cat") == "cpu_op"])
    durations, counts, cats = (collections.Counter(),
                               collections.Counter(), {})
    for e in chosen:
        name = str(e.get("name", "?"))
        durations[name] += float(e["dur"])
        counts[name] += 1
        cats.setdefault(name, categorize(name, e.get("cat", "")))
    return durations, counts, cats


def summarize_trace_dir(trace_dir: str, top: int = 25) -> dict:
    """Every trace under ``trace_dir`` (none, or a missing directory,
    gives ``files == 0``)::

        {"trace_dir", "files", "total_device_us",
         "categories": [{"category", "us", "share"}, ...],   # sorted
         "top_ops": [{"name", "us", "share", "count"}, ...]}
    """
    files = find_trace_files(trace_dir)
    durations, counts, cats = (collections.Counter(),
                               collections.Counter(), {})
    for path in files:
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        except (OSError, ValueError, AttributeError):
            continue  # a torn trace is skipped
        d, c, k = device_op_durations(events)
        durations.update(d)
        counts.update(c)
        for name, category in k.items():
            cats.setdefault(name, category)
    total_us = sum(durations.values())
    by_cat = collections.Counter()
    for name, dur in durations.items():
        by_cat[cats[name]] += dur
    return {
        "trace_dir": trace_dir,
        "files": len(files),
        "total_device_us": total_us,
        "categories": [
            {"category": cat, "us": dur,
             "share": dur / total_us if total_us else 0.0}
            for cat, dur in by_cat.most_common()
        ],
        "top_ops": [
            {"name": name, "us": dur,
             "share": dur / total_us if total_us else 0.0,
             "count": counts[name]}
            for name, dur in durations.most_common(top)
        ],
    }
