"""Cross-request patch packer: fixed device batches from ragged traffic.

The counterpart of ``chunkflow_tpu/serve/packer.py``. The per-chunk path
pads every request's patch list to a multiple of ``batch_size``, so under
many small concurrent requests the card spends its forward on padding.
The packer drains patches from every request in flight into one queue
and dispatches fixed ``[B, ci, *pin]`` batches that mix requests, on one
dispatcher thread.

Bitwise contract: a packed result equals ``Inferencer.__call__`` on the
same chunk, bit for bit, at every precision. The per-chunk path is
``gather -> forward -> (pred * bump) * valid accumulated in ascending
patch order -> normalize``; the packer runs the same operations:

1. *front half*: each request's chunk goes to the device once, in its
   raw dtype (``Inferencer._upload``, edge-padded to the bucket shape
   like the per-chunk path), and each packed batch gathers its rows with
   the gather kernel, once per request's share of the batch, on that
   request's starts table, into that share's rows. Filler rows are
   zeros;
2. *forward*: the inferencer's wrapped ``_forward`` (its precision) on
   the fixed batch shape, then ``forward * bump * valid``: the
   accumulate kernel's weighting, in its order. Every operation of the
   forward is per row (convolutions, instance norm, per-row int8
   scales), so a row's result does not depend on its neighbours;
3. *back half*: each request's weighted stack (padding rows exact
   zeros) is replayed through ``fused_accumulate_patches(pre_weighted=
   True)`` batch by batch in ascending order with the request's own
   validity, then ``normalize_blend`` and the inferencer's crop.

Under a mesh (``CHUNKFLOW_MESH``, ``mesh=``; ``parallel/engine.py``) the
packer stays eligible: a dispatch packs ``batch_size`` rows for each
device of the mesh and forwards through the engine's
``serve_forward_program``, each device on its ``[B, ...]`` share, so
results stay bitwise. Fold blend, a legacy ``sharding=`` inferencer, a
dry run and ``CHUNKFLOW_SERVE=0`` fall back to ``inferencer(...)``
(bitwise by construction) and count ``serving/fallbacks``.
Telemetry: ``serving/occupancy`` (gauge and histogram),
``serving/chips``, ``serving/queue_age``, ``serving/patch_queue``, the
counters ``serving/batches``, ``serving/packed_patches``,
``serving/filler_slots``, ``serving/fallbacks``,
``serving/packer_errors``, and the spans ``serving/forward``,
``serving/scatter``. The program cost ledger (``core/profiling.py``)
keeps the JAX families: ``serve_gather`` (a share's gather, and the
request's upload as its H2D bytes), ``serve_forward``, ``serve_overlay``
(the rows written into a request's device-resident weighted stack, noted
as ``serve_forward``'s inter-stage bytes) and ``serve_scatter`` per chunk
shape (the replay, which re-reads the stack: ``serve_scatter``'s).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, edge_pad
from chunkflow_tpu_torch.core import profiling, telemetry
from chunkflow_tpu_torch.inference.patching import (
    enumerate_patches,
    pad_to_batch,
)
from chunkflow_tpu_torch.ops import accumulate, gather
from chunkflow_tpu_torch.ops.blend import device_valid, normalize_blend

__all__ = ["serve_enabled", "RequestExpired", "PackerClosed",
           "PendingResult", "PatchPacker"]

_OFF_VALUES = ("0", "off", "false", "no")


def serve_enabled() -> bool:
    """The serving kill switch (``CHUNKFLOW_SERVE``, default on), read
    per request: off sends every request through the per-chunk path."""
    return os.environ.get("CHUNKFLOW_SERVE", "1").lower() not in _OFF_VALUES


class RequestExpired(RuntimeError):
    """The request's deadline passed before its patches completed."""


class PackerClosed(RuntimeError):
    """The packer was shut down while the request was still queued."""


class PendingResult:
    """One request's completion handle: ``result(timeout)`` blocks until
    the output chunk (or the failure) is ready."""

    __slots__ = ("_event", "_result", "_error", "trace_id")

    def __init__(self, trace_id: Optional[str] = None):
        self._event = threading.Event()
        self._result: Optional[Chunk] = None
        self._error: Optional[BaseException] = None
        self.trace_id = trace_id

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, chunk: Chunk) -> None:
        self._result = chunk
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        if not self._event.is_set():
            self._error = exc
            self._event.set()

    def result(self, timeout: Optional[float] = None) -> Chunk:
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    """One request's patch grid, its device-resident chunk and its
    weighted stack."""

    __slots__ = (
        "chunk", "handle", "deadline", "trace_id", "orig_zyx", "run_zyx",
        "n", "n_pad", "in_starts", "out_starts", "valid", "device_chunk",
        "ready", "weighted", "remaining", "enqueued_t",
    )

    def __init__(self, chunk, handle, deadline, trace_id):
        self.chunk = chunk
        self.handle = handle
        self.deadline = deadline
        self.trace_id = trace_id
        self.enqueued_t = time.time()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.time() > self.deadline


class PatchPacker:
    """Continuous cross-request patch batching around one
    :class:`~chunkflow_tpu_torch.inference.inferencer.Inferencer`.

    ``submit`` is thread-safe; all batch work runs on one dispatcher
    thread. ``max_wait_ms`` bounds how long a partial batch waits for
    more traffic before it is dispatched underfull;
    ``max_queue_patches`` bounds the queue (submission waits while it is
    full; a request larger than the bound is admitted once the queue has
    drained).
    """

    def __init__(self, inferencer, max_wait_ms: float = 2.0,
                 max_queue_patches: int = 4096):
        self.inferencer = inferencer
        self.batch_size = int(inferencer.batch_size)
        self.max_wait_s = max(0.0, float(max_wait_ms) / 1e3)
        self.max_queue_patches = int(max_queue_patches)
        self._cv = threading.Condition()
        self._items: deque = deque()  # (request, patch index, enqueue time)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # the cost ledger's records of the packer's steps (dispatcher
        # thread only)
        self._programs: dict = {}

    # -- eligibility ----------------------------------------------------
    def _eligible(self) -> bool:
        """Packed execution covers the scatter path, on one device or a
        mesh; fold blend, a legacy ``sharding=`` inferencer, a dry run
        and the kill switch take the per-chunk path."""
        inf = self.inferencer
        return (serve_enabled() and inf.sharding == "none"
                and inf.blend_mode == "scatter" and not inf.dry_run)

    def _shard_engine(self):
        """The mesh engine behind the inferencer, or None for one device;
        re-resolved per batch, so ``CHUNKFLOW_MESH=1`` takes serving back
        to one device mid-stream."""
        return self.inferencer.shard_engine()

    def _slots(self) -> int:
        """Patch slots of a dispatch: the batch times the mesh's
        devices."""
        engine = self._shard_engine()
        chips = engine.spec.n_devices if engine is not None else 1
        return self.batch_size * chips

    # -- submission -----------------------------------------------------
    def submit(self, chunk: Chunk, deadline: Optional[float] = None,
               trace_id: Optional[str] = None) -> PendingResult:
        """Queue one request's patches; returns its
        :class:`PendingResult`. ``deadline`` is an absolute ``time.time``:
        patches still queued past it are dropped and the request fails
        with :class:`RequestExpired`. Ineligible requests complete here,
        through the per-chunk path."""
        handle = PendingResult(trace_id)
        if not self._eligible():
            telemetry.inc("serving/fallbacks")
            try:
                handle._complete(self.inferencer(chunk))
            except BaseException as exc:  # noqa: BLE001 — the caller's
                handle._fail(exc)
            return handle
        if chunk.all_zero():
            # the per-chunk path's blank result
            try:
                handle._complete(self.inferencer._blank_output(chunk))
            except BaseException as exc:  # noqa: BLE001
                handle._fail(exc)
            return handle
        req = _Request(chunk, handle, deadline, trace_id)
        try:
            self._prepare(req)
        except BaseException as exc:  # noqa: BLE001
            handle._fail(exc)
            return handle
        with self._cv:
            if self._stop:
                handle._fail(PackerClosed("packer is shut down"))
                return handle
            while (len(self._items) + req.n > self.max_queue_patches
                   and self._items and not self._stop):
                self._cv.wait(0.05)
            if self._stop:
                handle._fail(PackerClosed("packer is shut down"))
                return handle
            now = time.time()
            for i in range(req.n):
                self._items.append((req, i, now))
            telemetry.gauge("serving/patch_queue", len(self._items))
            self._ensure_thread()
            self._cv.notify_all()
        return handle

    def infer(self, chunk: Chunk, deadline: Optional[float] = None,
              timeout: Optional[float] = None) -> Chunk:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(chunk, deadline=deadline).result(timeout)

    def _prepare(self, req: _Request) -> None:
        """The request's grid and its chunk's one trip to the device (raw
        dtype, edge-padded to the bucket shape as the per-chunk path
        pads it), and its zeroed weighted stack."""
        inf = self.inferencer
        chunk = req.chunk
        req.orig_zyx = tuple(chunk.shape[-3:])
        req.run_zyx = inf._run_shape(req.orig_zyx)
        grid = enumerate_patches(req.run_zyx, inf.input_patch_size,
                                 inf.output_patch_size,
                                 inf.output_patch_overlap)
        in_starts, out_starts, valid = pad_to_batch(grid, self.batch_size)
        req.n = grid.num_patches
        req.n_pad = len(valid)
        req.in_starts = in_starts
        req.out_starts = out_starts
        device = inf.device
        with torch.no_grad():
            arr = inf._upload(chunk, ("serve_gather",))
            if req.run_zyx != req.orig_zyx:
                arr = edge_pad(arr, req.run_zyx)
            req.device_chunk = arr
            req.valid = torch.from_numpy(valid).to(device)
            req.weighted = torch.zeros(
                (req.n_pad, inf.num_output_channels)
                + tuple(inf.output_patch_size),
                dtype=torch.float32, device=device)
        req.ready = None
        if device.type == "cuda":
            # the dispatcher's stream waits for this thread's uploads
            req.ready = torch.cuda.Event()
            req.ready.record(torch.cuda.current_stream(device))
        req.remaining = req.n

    # -- dispatcher -----------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="patch-packer")
            self._thread.start()

    def _next_batch(self):
        """Up to :meth:`_slots` queued patches; a partial batch waits
        ``max_wait_s`` from its oldest item for more traffic."""
        with self._cv:
            while True:
                if self._items:
                    slots = self._slots()
                    oldest_t = self._items[0][2]
                    if (len(self._items) >= slots or self._stop
                            or time.time() - oldest_t >= self.max_wait_s):
                        batch = [self._items.popleft() for _ in range(
                            min(slots, len(self._items)))]
                        telemetry.gauge("serving/patch_queue",
                                        len(self._items))
                        self._cv.notify_all()
                        return batch
                    self._cv.wait(max(
                        0.0005, self.max_wait_s - (time.time() - oldest_t)))
                    continue
                if self._stop:
                    return None
                self._cv.wait(0.1)

    def _loop(self) -> None:
        with torch.no_grad():
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                try:
                    self._run_batch(batch)
                except BaseException as exc:  # noqa: BLE001 — fail, don't die
                    for req, _, _ in batch:
                        req.handle._fail(exc)
                    telemetry.inc("serving/packer_errors")

    def _run_batch(self, batch) -> None:
        inf = self.inferencer
        now = time.time()
        live = []
        for item in batch:
            req, _, enq_t = item
            if req.handle.done:
                continue  # failed or expired already: drop its patches
            if req.expired:
                req.handle._fail(RequestExpired(
                    f"deadline passed {now - req.deadline:.3f}s ago with "
                    f"patches still queued"))
                continue
            telemetry.observe("serving/queue_age", now - enq_t)
            live.append(item)
        if not live:
            return
        engine = self._shard_engine()
        chips = engine.spec.n_devices if engine is not None else 1
        slots = self.batch_size * chips
        if len(live) > slots:
            # collected under a wider mesh than the one in effect now (a
            # kill-switch race): widen this dispatch to the next multiple
            # the mesh splits, rather than drop rows
            slots = -(-len(live) // slots) * slots
        pin = tuple(inf.input_patch_size)
        device = inf.device
        shares: dict = {}  # id(req) -> (req, [batch row], [patch index])
        for row, (req, idx, _) in enumerate(live):
            share = shares.setdefault(id(req), (req, [], []))
            share[1].append(row)
            share[2].append(idx)
        occupancy = len(live) / slots
        telemetry.gauge("serving/occupancy", occupancy)
        telemetry.gauge("serving/chips", float(chips))
        telemetry.inc("serving/batches")
        telemetry.inc("serving/packed_patches", len(live))
        telemetry.inc("serving/filler_slots", slots - len(live))

        patches = torch.zeros((slots, inf.num_input_channels) + pin,
                              dtype=torch.float32, device=device)
        for req, rows, idxs in shares.values():
            if req.ready is not None:
                torch.cuda.current_stream(device).wait_event(req.ready)
            starts = torch.from_numpy(req.in_starts[idxs])
            patches[_rows(rows, device)] = profiling.run_program(
                self._programs, ("serve_gather",),
                lambda: gather.gather_patches(req.device_chunk, starts,
                                              pin),
                label="packer", device=device)
        valid = np.zeros(slots, dtype=np.float32)
        valid[:len(live)] = 1.0
        with telemetry.span("serving/forward", occupancy=round(occupancy, 3)):
            if engine is not None:
                weighted = engine.serve_forward_program()(patches, valid)
            else:
                def forward():
                    preds = inf._forward(patches)
                    # the accumulate kernel's weighting, in its order
                    return (preds * inf._bump * device_valid(
                        valid, device)[:, None, None, None, None])

                weighted = profiling.run_program(
                    self._programs, ("serve_forward",), forward,
                    label="packer", device=device)
        done = []
        for req, rows, idxs in shares.values():
            profiling.run_program(
                self._programs, ("serve_overlay",),
                lambda: _overlay(req.weighted, weighted, idxs, rows,
                                 device),
                label="packer", device=device)
            req.remaining -= len(rows)
            if req.remaining == 0:
                done.append(req)
        for req in done:
            try:
                self._finalize(req)
            except BaseException as exc:  # noqa: BLE001
                req.handle._fail(exc)
                telemetry.inc("serving/packer_errors")

    def _finalize(self, req: _Request) -> None:
        """All the request's patches are forwarded: replay the per-chunk
        accumulation batch by batch, normalize, crop."""
        if req.expired:
            req.handle._fail(RequestExpired("deadline passed at finalize"))
            return
        inf = self.inferencer
        device = inf.device
        B = self.batch_size
        # the replay re-reads the weighted stack the overlays wrote
        profiling.note_hbm_intermediate(
            req.weighted.numel() * req.weighted.element_size(),
            key=("serve_scatter",))

        def scatter():
            out = torch.zeros((inf.num_output_channels,) + req.run_zyx,
                              dtype=torch.float32, device=device)
            weight = torch.zeros(req.run_zyx, dtype=torch.float32,
                                 device=device)
            for i0 in range(0, req.n_pad, B):
                rows = slice(i0, i0 + B)
                accumulate.fused_accumulate_patches(
                    out, weight, req.weighted[rows], req.valid[rows],
                    inf._bump, torch.from_numpy(req.out_starts[rows]),
                    pre_weighted=True)
            return normalize_blend(out, weight, inf.output_dtype)

        with telemetry.span("serving/scatter"):
            result = profiling.run_program(
                self._programs, ("serve_scatter", req.run_zyx), scatter,
                label="packer", device=device)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        req.weighted = req.device_chunk = None
        chunk = inf._postprocess_result(result, req.chunk, req.orig_zyx,
                                        req.run_zyx)
        voxels = 1
        for length in chunk.shape[-3:]:
            voxels *= int(length)
        telemetry.inc("inference/voxels", float(voxels))
        req.handle._complete(chunk)

    # -- teardown -------------------------------------------------------
    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the dispatcher. ``drain=True`` lets queued patches finish
        first; ``drain=False`` fails still-queued requests with
        :class:`PackerClosed`."""
        with self._cv:
            if not drain:
                while self._items:
                    req, _, _ = self._items.popleft()
                    req.handle._fail(PackerClosed("packer closed"))
            self._stop = True
            self._cv.notify_all()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)


def _overlay(stack, weighted, idxs, rows, device) -> None:
    """Write a request's share of a batch's weighted rows into its
    device-resident stack: the JAX ``serve_overlay`` step. The rows are
    read once and written once; the write is the stack's inter-stage
    traffic, which the replay re-reads."""
    src = weighted[_rows(rows, device)]
    stack[_rows(idxs, device)] = src
    nbytes = src.numel() * src.element_size()
    profiling.note_work(0, 2 * nbytes)
    profiling.note_hbm_intermediate(nbytes, key=("serve_forward",))


def _rows(indices, device):
    """Rows ``indices`` as a slice when they are consecutive (a request's
    share of a batch is), else an index tensor on ``device``."""
    first = indices[0]
    if indices == list(range(first, first + len(indices))):
        return slice(first, first + len(indices))
    return torch.tensor(indices, device=device)
