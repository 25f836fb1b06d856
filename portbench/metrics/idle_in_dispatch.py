"""Percent of the traced window in which no kernel ran on the card while
the dispatching thread was inside ``pipeline/dispatch`` (or a span
within it): the card waited on the launch path.

With ``idle_in_wait`` and ``idle_outside`` it splits ``device_idle`` by
what the dispatching thread was doing: the same idle time (kernels
only, copies and memsets not counted as work, over the same traced
window), cut by the program's span records (``telemetry.
recorded_spans()``, stamped on the clock the profiler stamps device
events on) clipped to the window as its device events are. The
dispatching thread is the one with the most ``pipeline/dispatch``
records in the window. Nothing to read in a program without the span
ring."""
import devtrace

DISPATCH = ("pipeline/dispatch",)
WAIT = ("scheduler/load", "scheduler/wait_result")


def _complement(intervals, lo, hi):
    out, at = [], lo
    for start, end in intervals:
        if start > at:
            out.append([at, min(start, hi)])
        at = max(at, end)
    if at < hi:
        out.append([at, hi])
    return out


def _intersect(a, b):
    """The overlap of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        start, end = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if start < end:
            out.append([start, end])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals):
    return sum(end - start for start, end in intervals)


def window_spans(ctx):
    """``(t0, t1, spans, thread)``: the traced window (microseconds on the
    trace's clock), the program's span records clipped to it as
    ``(name, thread, start, end)``, and the dispatching thread; None
    where there is nothing to read."""
    t0 = getattr(getattr(ctx, "_tracer", None), "_t0", None)
    if not ctx.events or not ctx.trace_window_s or t0 is None:
        return None
    from chunkflow_tpu_torch.core import telemetry

    recorded = getattr(telemetry, "recorded_spans", None)
    if recorded is None:
        return None
    t1 = t0 + ctx.trace_window_s * 1e6
    spans = [(s["name"], s["thread"], max(s["start_ns"] / 1e3, t0),
              min(s["end_ns"] / 1e3, t1))
             for s in recorded(since_ns=int(t0 * 1e3))]
    spans = [s for s in spans if s[2] < s[3]]
    counts = {}
    for name, thread, _, _ in spans:
        if name in DISPATCH:
            counts[thread] = counts.get(thread, 0) + 1
    if not counts:
        return None
    return t0, t1, spans, max(counts, key=counts.get)


def shares(ctx):
    """``{"dispatch", "wait", "outside"}``: percent of the traced window
    idle on the card with the dispatching thread in ``pipeline/dispatch``,
    in ``scheduler/load`` or ``scheduler/wait_result``, or in neither;
    None where there is nothing to read."""
    found = window_spans(ctx)
    if found is None:
        return None
    t0, t1, spans, thread = found

    def on_thread(names):
        return devtrace.union([(s, e) for n, th, s, e in spans
                               if th == thread and n in names])

    busy = devtrace.union([(s, e) for n, s, e in ctx.events
                           if not devtrace.is_copy(n)])
    idle = _complement(busy, t0, t1)
    dispatch = on_thread(DISPATCH)
    in_dispatch = _intersect(idle, dispatch)
    in_wait = _intersect(_intersect(idle, _complement(dispatch, t0, t1)),
                         on_thread(WAIT))
    window = t1 - t0
    d, w = _length(in_dispatch), _length(in_wait)
    return {"dispatch": 100.0 * d / window, "wait": 100.0 * w / window,
            "outside": 100.0 * (_length(idle) - d - w) / window}


def read(ctx):
    split = shares(ctx)
    return None if split is None else split["dispatch"]
