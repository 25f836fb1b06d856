"""Device-performance plane: program cost ledger, roofline accounting,
and bounded profiler capture.

The counterpart of ``chunkflow_tpu/core/profiling.py``, with its names
and its catalog's fields, so either package's ``log-summary`` reads the
other's ``programs`` event and ``programs.json``. Everything rides the
telemetry registry and its kill switch: ``CHUNKFLOW_TELEMETRY=0`` means
no ledger, no counters, no files, no capture threads.

1. **Program cost ledger.** The port has no compiled programs and no
   program cache: each program family's step (``scatter``, ``fold``,
   ``serve_forward``, ``serve_gather``, ``serve_overlay``,
   ``serve_scatter``, the mesh engine's ``shard`` programs and the psum
   program) is wrapped once per key by :func:`instrument_program` where
   its owner first builds or runs it (:func:`cached_program`); the key's
   first element is the family, as the JAX keys', and a new key (a new
   chunk shape) makes a new record, as a new JAX program would. The
   first call is timed as ``compile_s``: it includes a kernel's build at
   first use and cuDNN's first plan. Later calls add to the dispatch
   wall. There is no XLA cost analysis, so every record carries an
   ANALYTIC stamp, counted during the first call (:func:`count_work`):
   the FLOPs and bytes of every convolution layer the forward runs
   (``nn.Conv*`` and ``nn.ConvTranspose*``, the mxu layers and the int8
   ``real`` leg's among them; a global forward hook, on the calling
   thread only, with no second forward and no sync), plus each kernel
   wrapper's analytic cost (``ops/gather.gather_kernel_cost``,
   ``ops/accumulate.fused_kernel_cost``, whichever of the kernel or its
   plain version runs). :func:`stamp_cost` fields win over the count.
   Results land in ``program/*`` counters, one ``compile`` event per
   record, and the ``programs.json`` catalog written at flush.

2. **Roofline accounting.** :func:`catalog` scores each record against
   :data:`DEVICE_PEAKS`, keyed on the device's name:
   ``roofline_s = max(flops / peak_flops, bytes / peak_bw)`` and
   ``roofline_util = roofline_s / device_mean_s``. On a CUDA device each
   call after the first is bracketed by a pair of timing events on the
   current stream; finished pairs are read by ``query()`` at the next
   call and in :func:`catalog`, never by waiting, into ``device_mean_s``
   (``device_calls`` read, ``device_pending`` not yet finished). Where
   no pair has been read (the CPU, or a card whose pairs are all
   pending) the utilisation falls back to ``exec_mean_s``, the mean
   dispatch wall, as in the JAX package: under CUDA's asynchronous
   launches that lies between host dispatch time and device time, so the
   utilisation is then an upper bound; ``util_basis`` says which
   (``device`` or ``dispatch``), and ``lost_s`` and the achieved FLOP/s
   use the same time. The dispatch wall stays as ``dispatch_total_s``
   and ``exec_mean_s``. The notes :func:`note_h2d`,
   :func:`note_hbm_intermediate` and :func:`note_collective` add the
   staged, inter-stage and cross-device bytes per family.

3. **Bounded profiler capture.** Each capture is one ``torch.profiler``
   session with CPU activities, and CUDA activities where a card is
   present (CUPTI traces the device work of every thread of the
   process), written as Chrome-format ``trace.json`` into
   ``profile-<reason>-<n>/`` under the metrics dir (else
   ``CHUNKFLOW_PROFILE_DIR``). One session runs at a time.

   * :func:`capture`: one bounded window; ``POST /profile?seconds=N``
     (``parallel/restapi.py``) calls it with ``force=True``.
   * :func:`maybe_capture`: an automatic capture in a background thread,
     behind a cooldown (``CHUNKFLOW_PROFILE_COOLDOWN``, default 300 s)
     and the anomaly switch (``CHUNKFLOW_PROFILE_ON_ANOMALY``); fed by
     :func:`note_slo_page` (a page-severity SLO alert, ``core/slo.py``)
     and :func:`note_stall` (the depth controller's dominant stall at or
     above ``CHUNKFLOW_PROFILE_STALL_SHARE`` for
     ``CHUNKFLOW_PROFILE_STALL_TICKS`` ticks on one phase,
     ``flow/scheduler.py``).
   * :func:`start_task_window`: the CLI's ``--profile-dir`` session over
     the run's first ``--profile-tasks`` tasks (``CHUNKFLOW_PROFILE_TASKS``,
     default 4; <= 0 the whole run), closed by :func:`note_task_done`.

   Window lengths: ``CHUNKFLOW_PROFILE_SECONDS`` (automatic, default 3)
   and ``CHUNKFLOW_PROFILE_MAX_SECONDS`` (the cap, default 60).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional, Tuple

from chunkflow_tpu_torch.core import telemetry

__all__ = [
    "instrument_program", "cached_program", "run_program", "EventPairs",
    "program_flops", "stamp_cost", "catalog",
    "write_catalog", "device_peaks", "DEVICE_PEAKS",
    "device_identity", "estimate_collective_split", "count_work",
    "counting", "note_work",
    "note_h2d", "h2d_by_family",
    "note_hbm_intermediate", "hbm_intermediate_by_family",
    "note_collective", "collective_by_family",
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


# ---------------------------------------------------------------------------
# roofline peak table
# ---------------------------------------------------------------------------
#: (device-name substring, (peak FLOP/s, peak device-memory bytes/s)),
#: matched case-insensitively against ``torch.cuda.get_device_name()``
#: (``"NVIDIA H100 80GB HBM3"``), first hit wins. ``h100``: NVIDIA's
#: published data-sheet figures for the H100 SXM5 80GB (700 W): dense
#: bf16 tensor-core peak and HBM3 bandwidth. ``cpu``: a deliberately
#: conservative host fallback, so the roofline math stays defined in
#: CPU runs (override with CHUNKFLOW_PEAK_FLOPS / CHUNKFLOW_PEAK_BW for
#: a calibrated host).
DEVICE_PEAKS = (
    ("h100", (989e12, 3.35e12)),
    ("cpu", (1e11, 5e10)),
)

_CPU_FALLBACK = (1e11, 5e10)


def device_peaks(device_kind: str) -> dict:
    """Peak FLOP/s + bytes/s for a device kind: env overrides first
    (``CHUNKFLOW_PEAK_FLOPS`` / ``CHUNKFLOW_PEAK_BW``), then the
    substring table, then the CPU fallback. ``source`` says which."""
    env_flops = _env_float("CHUNKFLOW_PEAK_FLOPS", 0.0)
    env_bw = _env_float("CHUNKFLOW_PEAK_BW", 0.0)
    kind = (device_kind or "").lower()
    flops, bw, source = None, None, "fallback"
    for needle, (f, b) in DEVICE_PEAKS:
        if needle in kind:
            flops, bw, source = f, b, f"table:{needle}"
            break
    if flops is None:
        flops, bw = _CPU_FALLBACK
    if env_flops > 0:
        flops, source = env_flops, "env"
    if env_bw > 0:
        bw, source = env_bw, "env"
    return {"flops_per_s": flops, "bytes_per_s": bw, "source": source}


def device_identity(device=None) -> Tuple[str, str]:
    """``(platform, device kind)``: ``("gpu", <card name>)`` for a CUDA
    device (``None``: card 0 when there is one), else ``("cpu",
    "cpu")``."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return "cpu", "cpu"
            device = torch.device("cuda", 0)
        device = torch.device(device)
        if device.type == "cuda":
            return "gpu", torch.cuda.get_device_name(device)
        return "cpu", "cpu"
    except Exception:
        return "unknown", "unknown"


def estimate_collective_split(flops: float, collective_bytes: float,
                              device_kind: Optional[str] = None) -> dict:
    """Analytic collective-vs-compute split of one sharded dispatch
    against the roofline peak table: ``compute_s = flops / peak_flops``
    and ``collective_s = collective_bytes / peak_bytes`` for the mesh's
    device kind. The bytes/s figure is the card's memory row, a proxy
    that flatters the interconnect (NVLink and PCIe are slower), so
    ``collective_share`` is a LOWER bound on how communication-dominated
    the mesh shape is. ``device_kind=None`` probes card 0 (the CPU when
    there is none)."""
    if device_kind is None:
        _, device_kind = device_identity()
    peaks = device_peaks(device_kind)
    compute_s = max(0.0, float(flops)) / peaks["flops_per_s"]
    collective_s = max(0.0, float(collective_bytes)) / peaks["bytes_per_s"]
    total = compute_s + collective_s
    return {
        "compute_s": compute_s,
        "collective_s": collective_s,
        "collective_share": (collective_s / total) if total > 0 else 0.0,
        "device_kind": device_kind,
        "peak_source": peaks["source"],
    }


# ---------------------------------------------------------------------------
# the analytic count: layers' shapes and kernels' arithmetic
# ---------------------------------------------------------------------------
class _Work:
    __slots__ = ("flops", "bytes")

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0


_TLS = threading.local()
_HOOK_LOCK = threading.Lock()
_HOOK = None
_HOOK_USERS = 0


def counting() -> bool:
    """Whether the calling thread is inside a :func:`count_work` scope
    (the kernel wrappers note their cost only then)."""
    return bool(getattr(_TLS, "stack", None))


def note_work(flops: float, nbytes: float) -> None:
    """Add analytic work to every :func:`count_work` scope open on the
    calling thread (a no-op outside one)."""
    for work in getattr(_TLS, "stack", None) or ():
        work.flops += float(flops)
        work.bytes += float(nbytes)


def _conv_hook(module, inputs, output) -> None:
    """The global forward hook: a convolution layer's multiply-adds (x2)
    and the bytes of its input, weight and output, from their shapes."""
    if not getattr(_TLS, "stack", None):
        return
    import torch

    conv = isinstance(module, (torch.nn.Conv1d, torch.nn.Conv2d,
                               torch.nn.Conv3d))
    transpose = isinstance(module, (torch.nn.ConvTranspose1d,
                                    torch.nn.ConvTranspose2d,
                                    torch.nn.ConvTranspose3d))
    if not (conv or transpose) or not inputs:
        return
    x = inputs[0]
    if not isinstance(x, torch.Tensor) or not isinstance(output,
                                                         torch.Tensor):
        return
    kvol = 1
    for k in module.kernel_size:
        kvol *= int(k)
    if transpose:
        macs = x.numel() * (module.out_channels // module.groups) * kvol
    else:
        macs = output.numel() * (module.in_channels // module.groups) * kvol
    w = module.weight
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + output.numel() * output.element_size())
    note_work(2 * macs, nbytes)


class count_work:
    """``with count_work() as work:`` counts, on the calling thread, the
    analytic FLOPs and bytes of every convolution layer run (a global
    forward hook, registered while any scope is open) and every kernel
    wrapper's noted cost; scopes nest, and an inner scope's work counts
    in the outer ones too."""

    def __enter__(self) -> _Work:
        global _HOOK, _HOOK_USERS
        from torch.nn.modules.module import register_module_forward_hook

        with _HOOK_LOCK:
            if _HOOK_USERS == 0:
                _HOOK = register_module_forward_hook(_conv_hook)
            _HOOK_USERS += 1
        self.work = _Work()
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self.work)
        return self.work

    def __exit__(self, *exc) -> bool:
        global _HOOK, _HOOK_USERS
        _TLS.stack.remove(self.work)
        with _HOOK_LOCK:
            _HOOK_USERS -= 1
            if _HOOK_USERS == 0 and _HOOK is not None:
                _HOOK.remove()
                _HOOK = None
        return False


# ---------------------------------------------------------------------------
# program cost ledger
# ---------------------------------------------------------------------------
class EventPairs:
    """A reused pool of timing CUDA event pairs: :meth:`take` hands out a
    pair (a new one only when none is free), :meth:`read` gives a pair's
    device seconds and takes it back once its end has fired, else None.
    Nothing here waits on an event. The cost ledger brackets its program
    calls with one pool per record, the inferencer its forwards with one
    of its own (``ops/blend.build_local_blend``)."""

    def __init__(self):
        self._free: deque = deque()
        self._lock = threading.Lock()

    def take(self) -> tuple:
        with self._lock:
            if self._free:
                return self._free.pop()
        import torch

        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def read(self, pair: tuple) -> Optional[float]:
        start, end = pair
        if not end.query():
            return None
        seconds = start.elapsed_time(end) / 1e3
        with self._lock:
            self._free.append(pair)
        return seconds


class _ProgramRecord:
    """One program family key's cost story. ``compile_s`` is None until
    the program's first call. On a CUDA device (``events``) later calls
    leave timing event pairs in ``pending`` until they are read into
    ``device_s`` and ``device_calls``."""

    __slots__ = (
        "family", "key", "label", "build_s", "compile_s", "flops",
        "bytes_accessed", "vmem_bytes", "hbm_intermediate", "optimal_s",
        "calls", "dispatch_s", "platform", "device_kind", "device", "lock",
        "events", "pending", "device_s", "device_calls",
    )

    def __init__(self, family: str, key: str, label: str, build_s: float,
                 device=None):
        self.family = family
        self.key = key
        self.label = label
        self.build_s = build_s
        self.compile_s: Optional[float] = None
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.vmem_bytes: Optional[float] = None
        self.hbm_intermediate: Optional[float] = None
        self.optimal_s: Optional[float] = None
        self.calls = 0
        self.dispatch_s = 0.0  # post-first-call dispatch wall, cumulative
        self.platform = ""
        self.device_kind = ""
        self.device = device
        self.lock = threading.Lock()
        self.events = EventPairs() if _on_card(device) else None
        self.pending: deque = deque()
        self.device_s = 0.0
        self.device_calls = 0

    def drain_locked(self) -> None:
        """Read the finished pairs, oldest first (caller holds the
        lock)."""
        while self.pending:
            seconds = self.events.read(self.pending[0])
            if seconds is None:
                return
            self.pending.popleft()
            self.device_s += seconds
            self.device_calls += 1


def _on_card(device) -> bool:
    """Whether ``device`` names a CUDA device of a process that has one."""
    if device is None:
        return False
    import torch

    return (torch.device(device).type == "cuda"
            and torch.cuda.is_available())


_LEDGER_LOCK = threading.Lock()
_LEDGER: dict = {}  # (family, key, id) -> _ProgramRecord


class _InstrumentedProgram:
    """Transparent wrapper around one program: the first call counted
    (:func:`count_work`) and timed as compile, later calls accumulate
    dispatch wall; attribute access forwards to the program."""

    __slots__ = ("_fn", "_rec")

    def __init__(self, fn, rec: _ProgramRecord):
        self._fn = fn
        self._rec = rec

    def __call__(self, *args, **kwargs):
        rec = self._rec
        if rec.compile_s is None:
            return self._first_call(args, kwargs)
        pair = None
        if rec.events is not None:
            with rec.lock:
                rec.drain_locked()
            pair = rec.events.take()
            pair[0].record()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        if pair is not None:
            pair[1].record()
        with rec.lock:
            rec.calls += 1
            rec.dispatch_s += dt
            if pair is not None:
                rec.pending.append(pair)
        return out

    def _first_call(self, args, kwargs):
        rec = self._rec
        stamp = getattr(self._fn, "_chunkflow_cost", None) or {}
        with count_work() as work:
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            dt = time.perf_counter() - t0
        # a stamp's fields win over the count
        cost = {"flops": work.flops, "bytes accessed": work.bytes}
        cost.update(stamp)
        first = False
        with rec.lock:
            if rec.compile_s is None:
                first = True
                rec.compile_s = dt
                rec.platform, rec.device_kind = device_identity(rec.device)
                flops = cost.get("flops")
                nbytes = cost.get("bytes accessed")
                vmem = cost.get("vmem_bytes")
                hbm_i = cost.get("hbm_intermediate_bytes")
                optimal = cost.get("optimal_seconds")
                rec.flops = float(flops) if flops is not None else None
                rec.bytes_accessed = (
                    float(nbytes) if nbytes is not None else None
                )
                rec.vmem_bytes = float(vmem) if vmem is not None else None
                rec.hbm_intermediate = (
                    float(hbm_i) if hbm_i is not None else None
                )
                rec.optimal_s = (
                    float(optimal) if optimal is not None else None
                )
            else:  # raced: the other thread's call was the first
                rec.calls += 1
                rec.dispatch_s += dt
        if first:
            telemetry.inc("program/builds")
            telemetry.inc("program/compile_seconds", dt)
            if rec.flops:
                telemetry.inc("program/flops_total", rec.flops)
            if rec.bytes_accessed:
                telemetry.inc("program/bytes_total", rec.bytes_accessed)
            telemetry.event(
                "compile", f"program/{rec.family}",
                family=rec.family, key=rec.key, label=rec.label,
                build_s=round(rec.build_s, 4),
                compile_s=round(dt, 4),
                flops=rec.flops, bytes_accessed=rec.bytes_accessed,
                device=rec.device_kind, platform=rec.platform,
            )
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


class _CostStamped:
    """A program carrying an analytic cost model. Transparent:
    ``__call__`` and attribute access forward to the program;
    :func:`instrument_program`'s wrapper reads the stamp."""

    __slots__ = ("_fn", "_chunkflow_cost")

    def __init__(self, fn, cost: dict):
        self._fn = fn
        self._chunkflow_cost = cost

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def stamp_cost(program, flops: Optional[float] = None,
               bytes_accessed: Optional[float] = None,
               vmem_bytes: Optional[float] = None,
               hbm_intermediate_bytes: Optional[float] = None):
    """Attach an ANALYTIC cost model to a program before it is
    instrumented: the ledger scores its roofline against these numbers
    instead of its first call's count. The stamp is the owner's
    arithmetic, so it must state what the program actually moves and
    computes. ``hbm_intermediate_bytes`` is the inter-stage stack traffic
    the program materializes in device memory between its stages per
    call (the catalog's ``hbm_intermediate_bytes`` column);
    ``vmem_bytes`` stays in the signature for the JAX schema and is None
    on the card."""
    cost: dict = {}
    if flops is not None:
        cost["flops"] = float(flops)
    if bytes_accessed is not None:
        cost["bytes accessed"] = float(bytes_accessed)
    if vmem_bytes is not None:
        cost["vmem_bytes"] = float(vmem_bytes)
    if hbm_intermediate_bytes is not None:
        cost["hbm_intermediate_bytes"] = float(hbm_intermediate_bytes)
    return _CostStamped(program, cost)


_H2D_LOCK = threading.Lock()
_H2D: dict = {}  # program family -> staged H2D bytes


def note_h2d(nbytes, key=None, label: str = "") -> None:
    """Count one host->device staging transfer at the staging seam: the
    ``transfer/h2d_bytes`` / ``transfer/h2d_chunks`` counters, and with
    ``key`` (a program key) the family that consumes the bytes, the
    catalog's ``h2d_bytes`` column. No-op under the telemetry kill
    switch."""
    if not telemetry.enabled():
        return
    telemetry.inc("transfer/h2d_bytes", float(nbytes))
    telemetry.inc("transfer/h2d_chunks")
    if key is not None:
        family, _ = _family_of(key, label)
        with _H2D_LOCK:
            _H2D[family] = _H2D.get(family, 0.0) + float(nbytes)


def h2d_by_family() -> dict:
    """Staged H2D bytes per program family (a copy)."""
    with _H2D_LOCK:
        return dict(_H2D)


_HBM_I_LOCK = threading.Lock()
_HBM_I: dict = {}  # program family -> inter-stage stack bytes


def note_hbm_intermediate(nbytes, key=None, label: str = "") -> None:
    """Count inter-stage stack traffic between separate steps: a stack
    one step writes to device memory and the next re-reads (the serving
    packer's weighted stack). The ``transfer/hbm_intermediate_bytes``
    counter and the per-family bucket (the catalog's
    ``hbm_intermediate_bytes`` when no stamp carries it). No-op under the
    telemetry kill switch."""
    if not telemetry.enabled():
        return
    telemetry.inc("transfer/hbm_intermediate_bytes", float(nbytes))
    if key is not None:
        family, _ = _family_of(key, label)
        with _HBM_I_LOCK:
            _HBM_I[family] = _HBM_I.get(family, 0.0) + float(nbytes)


def hbm_intermediate_by_family() -> dict:
    """Inter-stage stack bytes per program family (a copy)."""
    with _HBM_I_LOCK:
        return dict(_HBM_I)


_COLLECTIVE_LOCK = threading.Lock()
_COLLECTIVE: dict = {}  # program family -> analytic collective bytes


def note_collective(nbytes, key=None, label: str = "") -> None:
    """Count ANALYTIC cross-device traffic for one sharded dispatch
    (halo copies, the weighted-stack gathers, fringe strips, stage
    handoffs, the psum all-reduce), computed by the engine from shapes
    and dtypes: the ``shard/collective_bytes`` counter and a per-family
    bucket (the catalog's ``collective_bytes`` column). No-op under the
    telemetry kill switch."""
    if not telemetry.enabled():
        return
    telemetry.inc("shard/collective_bytes", float(nbytes))
    if key is not None:
        family, _ = _family_of(key, label)
        with _COLLECTIVE_LOCK:
            _COLLECTIVE[family] = _COLLECTIVE.get(family, 0.0) \
                + float(nbytes)


def collective_by_family() -> dict:
    """Analytic collective bytes per program family (a copy)."""
    with _COLLECTIVE_LOCK:
        return dict(_COLLECTIVE)


def _family_of(key, label: str) -> Tuple[str, str]:
    """(family, shape-ish remainder) from a program key. Keys are tuples
    like ``("scatter", (64, 512, 512))`` / ``("fold", (8, 32, 32))``;
    anything else falls back to the label."""
    if isinstance(key, tuple) and key:
        family = str(key[0])
        rest = ",".join(str(part) for part in key[1:])
    else:
        family = label or str(key)
        rest = "" if isinstance(key, tuple) else str(key)
    return family, rest


def instrument_program(program, key, label: str = "",
                       build_s: float = 0.0, device=None):
    """Wrap a freshly built program into the cost ledger; returns the
    program untouched when telemetry is off (kill switch: the plane does
    not exist) or when it is not callable. ``device`` is where it runs
    (the catalog's ``platform`` and ``device_kind``)."""
    if not telemetry.enabled():
        return program
    if not callable(program):
        return program
    family, rest = _family_of(key, label)
    rec = _ProgramRecord(family=family, key=rest, label=label,
                         build_s=build_s, device=device)
    with _LEDGER_LOCK:
        _LEDGER[(family, rest, id(rec))] = rec
    return _InstrumentedProgram(program, rec)


def cached_program(cache: dict, key, build, label: str = "", device=None,
                   maxsize: int = 16):
    """``cache[key]``, else ``build()`` timed as ``build_s``, instrumented
    (:func:`instrument_program`) and kept, the oldest entry dropped past
    ``maxsize``: the port's stand-in for the JAX ``ProgramCache.get``."""
    program = cache.get(key)
    if program is None:
        t0 = time.perf_counter()
        built = build()
        program = cache[key] = instrument_program(
            built, key, label=label, build_s=time.perf_counter() - t0,
            device=device)
        while len(cache) > maxsize:
            cache.pop(next(iter(cache)))
    return program


def _run_body(body):
    return body()


def run_program(cache: dict, key, body, label: str = "", device=None,
                stamp=None):
    """Run ``body()`` as one call of the program ``key``: its record is
    kept in ``cache`` (:func:`cached_program`), so the first call of a
    key is counted and timed as compile and later ones add to its
    dispatch wall. ``stamp`` (a callable returning :func:`stamp_cost`
    keywords, called once per key) adds the owner's arithmetic. The
    per-call closure carries the call's arguments, so an owner wraps an
    existing step without restructuring it."""
    def build():
        return stamp_cost(_run_body, **stamp()) if stamp else _run_body

    return cached_program(cache, key, build, label=label,
                          device=device)(body)


def program_flops(cache: dict, key) -> Optional[float]:
    """The FLOPs the ledger counted for ``key``'s program (None when
    telemetry is off, the key was never run, or it counted nothing): the
    compute side of the mesh engine's collective-vs-compute split."""
    rec = getattr(cache.get(key), "_rec", None)
    return getattr(rec, "flops", None)


def catalog() -> list:
    """The cost ledger with roofline derivations, one dict per program:
    compile seconds, FLOPs / bytes accessed (the analytic stamp), the
    dispatch stats, the device time read so far (``device_mean_s``,
    ``device_calls``, ``device_pending``), and against
    :func:`device_peaks` ``roofline_s`` (the cost-model floor per call)
    and ``roofline_util`` (floor / mean device time, else floor / mean
    dispatch wall, an upper bound under asynchronous launches:
    ``util_basis``; see the module docstring)."""
    with _LEDGER_LOCK:
        records = list(_LEDGER.values())
    h2d = h2d_by_family()
    hbm_i = hbm_intermediate_by_family()
    coll = collective_by_family()
    out = []
    for rec in records:
        with rec.lock:
            rec.drain_locked()
            entry = {
                "family": rec.family,
                "key": rec.key,
                "label": rec.label,
                "build_s": round(rec.build_s, 4),
                "compile_s": (
                    round(rec.compile_s, 4)
                    if rec.compile_s is not None else None
                ),
                "flops": rec.flops,
                "bytes_accessed": rec.bytes_accessed,
                "vmem_bytes": rec.vmem_bytes,
                "optimal_s": rec.optimal_s,
                "calls": rec.calls + (1 if rec.compile_s is not None else 0),
                "dispatch_total_s": round(rec.dispatch_s, 4),
                "device_total_s": round(rec.device_s, 6),
                "device_calls": rec.device_calls,
                "device_pending": len(rec.pending),
                "platform": rec.platform,
                "device_kind": rec.device_kind,
            }
            calls, dispatch_s = rec.calls, rec.dispatch_s
            flops, nbytes = rec.flops, rec.bytes_accessed
            kind = rec.device_kind
            device_mean = (rec.device_s / rec.device_calls
                           if rec.device_calls else None)
        peaks = device_peaks(kind)
        entry["peak_flops_per_s"] = peaks["flops_per_s"]
        entry["peak_bytes_per_s"] = peaks["bytes_per_s"]
        entry["peak_source"] = peaks["source"]
        roofline_s = None
        if flops is not None or nbytes is not None:
            roofline_s = max(
                (flops or 0.0) / peaks["flops_per_s"],
                (nbytes or 0.0) / peaks["bytes_per_s"],
            )
        entry["roofline_s"] = roofline_s
        exec_s = dispatch_s / calls if calls else None
        entry["exec_mean_s"] = round(exec_s, 6) if exec_s else None
        entry["device_mean_s"] = (round(device_mean, 6) if device_mean
                                  else None)
        # the time the utilisation, the lost seconds and the achieved
        # rate are taken on: the device's where read, else the dispatch
        # wall's
        basis_s = device_mean or exec_s
        entry["util_basis"] = "device" if device_mean else "dispatch"
        entry["roofline_util"] = (
            round(roofline_s / basis_s, 4)
            if roofline_s and basis_s else None
        )
        # lost seconds: (mean time - roofline_s) x calls, the time spent
        # above the cost-model floor: the "what next" ranking key of
        # log-summary's DEVICE PROGRAMS table, clamped at zero
        entry["lost_s"] = (
            round(max(0.0, basis_s - roofline_s) * calls, 6)
            if roofline_s is not None and basis_s else None
        )
        entry["achieved_flops_per_s"] = (
            round(flops / basis_s, 2) if flops and basis_s else None
        )
        entry["h2d_bytes"] = h2d.get(rec.family)
        # a stamp on the program wins; else the family's noted bytes
        entry["hbm_intermediate_bytes"] = (
            rec.hbm_intermediate
            if rec.hbm_intermediate is not None
            else hbm_i.get(rec.family)
        )
        entry["collective_bytes"] = coll.get(rec.family)
        out.append(entry)
    out.sort(key=lambda e: -(e["compile_s"] or 0.0))
    return out


def write_catalog(metrics_dir: Optional[str] = None) -> Optional[str]:
    """Write the per-run ``programs.json`` catalog (and emit a
    ``programs`` event carrying the same entries) under ``metrics_dir``,
    default the telemetry file's directory. No-op (returns None) with
    telemetry off, an empty ledger, or nowhere to write. Registered as a
    telemetry flush hook, so every run that flushes a sink gets its
    catalog."""
    if not telemetry.enabled():
        return None
    entries = catalog()
    if not entries:
        return None
    if metrics_dir is None:
        path = telemetry.configured_path()
        metrics_dir = os.path.dirname(path) if path else None
    if metrics_dir is None:
        return None
    telemetry.event("programs", "program/catalog", programs=entries)
    payload = {
        "worker": telemetry.worker_id(),
        "t": time.time(),
        "programs": entries,
    }
    target = os.path.join(metrics_dir, "programs.json")
    try:
        os.makedirs(metrics_dir, exist_ok=True)
        tmp = target + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, target)
    except OSError:
        return None
    return target


# ---------------------------------------------------------------------------
# bounded profiler capture (anomaly-triggered + operator-requested)
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# per-run lifecycle: ride telemetry's flush/reset
# ---------------------------------------------------------------------------
def _on_reset() -> None:
    global _LAST_CAPTURE_T, _STALL_PHASE, _STALL_TICKS, _WINDOW
    window = _WINDOW
    if window is not None:
        window.close()
    _WINDOW = None
    with _LEDGER_LOCK:
        _LEDGER.clear()
    with _H2D_LOCK:
        _H2D.clear()
    with _HBM_I_LOCK:
        _HBM_I.clear()
    with _COLLECTIVE_LOCK:
        _COLLECTIVE.clear()
    with _STATE_LOCK:
        _LAST_CAPTURE_T = None
        _STALL_PHASE, _STALL_TICKS = None, 0


telemetry.add_flush_hook(write_catalog)
telemetry.add_reset_hook(_on_reset)
