"""Milliseconds by which the card finishes a chunk after the host has
enqueued it: from the end of each ``pipeline/dispatch`` span of the
dispatching thread (the program's span ring) to the start of that
chunk's download on the card (its ``Memcpy DtoH``, which waits on the
chunk's compute-done event), the median over the traced window's
downloads. Large where the card sets the pace (the host runs a launch
queue ahead), near zero where the launch path does; slightly negative
where the card finished while the host was still closing the dispatch.

Downloads run in order on the one download stream, so the window's k-th
download belongs to the (a + k)-th dispatch for one offset ``a``. The
reader takes the one offset under which every download keeps what the
program guarantees of its chunk, and reads nothing where none or several
do. A chunk's download starts after the middle of its dispatch (it is
enqueued after the launch loop), and has landed before the chunk's
``pipeline/drain`` span (same chunk id) ends. Where the drain's
``pipeline/compute`` span waited more than :data:`WOKE_US` for the
compute-done event, the download started at most :data:`WOKE_US` before
that span ended. The first rule and the second tell the chunks apart
while the card trails the host by less than half a dispatch; the third,
where it trails by more and the drains wait on the card. So a stray
device-to-host copy in the window, or a card that trails by more than
half a dispatch while the drains come late, reads nothing.
"""
import statistics
from pathlib import Path

import harness

#: the most by which the drain's wake-up may trail the start of the
#: download that the same compute-done event releases, microseconds
WOKE_US = 20e3


def _first_after(records, name, dispatches):
    """``{(chunk, dispatch start): (start, end)}`` of each dispatch's first
    ``name`` span of its chunk that starts after the dispatch does."""
    spans = sorted((r["start_ns"] / 1e3, r["end_ns"] / 1e3, r["chunk"])
                   for r in records if r["name"] == name)
    found = {}
    for s, _, c in dispatches:
        hit = next(((ss, se) for ss, se, sc in spans
                    if sc == c and ss >= s), None)
        if hit is not None:
            found[(c, s)] = hit
    return found


def _fits(dispatch, download, compute, drain) -> bool:
    s, e, c = dispatch
    start, end = download
    if start < (s + e) / 2:
        return False
    if (c, s) in drain and end > drain[(c, s)][1]:
        return False
    waited = compute.get((c, s))
    return not (waited and waited[1] - waited[0] > WOKE_US
                and start < waited[1] - WOKE_US)


def _offset(dispatches, downloads, compute, drain):
    """The one offset ``a`` under which download k may be dispatch
    a + k's, or None."""
    fits = [a for a in range(len(dispatches) - len(downloads) + 1)
            if all(_fits(d, m, compute, drain)
                   for d, m in zip(dispatches[a:], downloads))]
    return fits[0] if len(fits) == 1 else None


def read(ctx):
    idle = harness.load_module(
        Path(__file__).with_name("idle_in_dispatch.py"), "metric")
    found = idle.window_spans(ctx)
    if found is None:
        return None
    t0, t1, _, thread = found
    from chunkflow_tpu_torch.core import telemetry

    records = telemetry.recorded_spans()
    dispatches = sorted((r["start_ns"] / 1e3, r["end_ns"] / 1e3, r["chunk"])
                        for r in records if r["thread"] == thread
                        and r["name"] in idle.DISPATCH
                        and r["start_ns"] / 1e3 < t1)
    downloads = sorted((s, e) for n, s, e in ctx.events
                       if n.startswith("Memcpy DtoH") and s > t0)
    if not downloads:
        return None
    a = _offset(dispatches, downloads,
                _first_after(records, "pipeline/compute", dispatches),
                _first_after(records, "pipeline/drain", dispatches))
    if a is None:
        return None
    leads = [start - e for (_, e, _), (start, _)
             in zip(dispatches[a:], downloads)]
    return statistics.median(leads) / 1e3
