"""The serving front end: ``POST /infer`` with admission, deadlines, leases.

The counterpart of ``chunkflow_tpu/serve/frontend.py``, with the same
wire protocol, backends and counters. A :class:`ServingService` extends
the coordination service (``parallel/restapi.py``), so one listener
serves ``/infer`` and ``/serving`` beside ``/metrics``, ``/healthz``,
``/alerts`` and ``/profile``::

    POST /infer ──► admission control ──► request = a task on a queue
      (in-flight bound and the         (lease, retry budget, dead
       scheduler's memory watermark)    letter, exactly-once commit)
          │ 429 on reject                    │
          ▼                                  ▼
      deadline clock            worker claims ──► PatchPacker (patches of
          │ 504 on a miss        every request in shared device batches)
          ▼                                  │
      response JSON ◄────────────────────────┘

Two backends, one wire protocol:

* :class:`LocalBackend`: worker threads of this process claim requests
  from a private ``MemoryQueue`` under a ``LifecycleSupervisor`` (lease
  heartbeats, retries with backoff for transient errors, dead letters
  past the budget, a ``MemoryLedger`` for exactly-once commit) and
  compute through one shared :class:`~chunkflow_tpu_torch.serve.packer.
  PatchPacker`, whose gather and pre-weighted accumulate kernels batch
  the patches of concurrent requests together.
* :class:`SpoolBackend`: requests spool to ``<dir>/in/<bbox>.h5`` and a
  ``file://`` queue; external worker processes running the supervised
  ``fetch-task-from-queue ... delete-task-in-queue`` chain complete
  them, and the front end answers when the completion ledger marks the
  request done. A worker killed mid-request loses its lease; the request
  is redelivered and completes once.

The wire: a request is JSON with ``shape`` ([z, y, x] or [c, z, y, x]),
``dtype`` (uint8, uint16 or float32), ``data_b64`` (base64 of the C-order
bytes), optional ``voxel_offset`` and ``deadline_s``; or, instead of the
data, ``volume_path``, ``bbox_start``, ``bbox_size`` and ``mip`` of a
local precomputed volume (any encoding, sharded or not). The response
carries the result the same way (bfloat16 widened to float32), its ``trace_id`` and
``latency_s``.

Backpressure is the adaptive scheduler's memory watermark
(``CHUNKFLOW_SCHED_MEM_GB``): every admitted request reserves its working
set through :func:`~chunkflow_tpu_torch.flow.scheduler.reserve_host_bytes`.

Telemetry: the counters ``serving/requests``, ``admitted``,
``completed``, ``rejected_admission``, ``rejected_memory``,
``rejected_duplicate``, ``deadline_missed``, ``errors``, the gauge
``serving/inflight``, the quantile histogram ``serving/latency``, and the
spans ``serving/decode`` (JSON and base64 to a host chunk),
``serving/request`` (submission to completion: queueing, the packer's
``serving/forward`` and ``serving/scatter``) and ``serving/encode`` (the
result's download and its JSON and base64), so wire time and compute
time read apart.
"""
from __future__ import annotations

import base64
import binascii
import json
import os
import threading
import time
import uuid
from typing import Dict, Optional

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk, as_native_dtype
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel.restapi import CoordinationService, serve
from chunkflow_tpu_torch.serve.packer import PatchPacker, RequestExpired
from chunkflow_tpu_torch.testing import chaos

__all__ = [
    "AdmissionRejected", "AdmissionController", "ServingRequest",
    "LocalBackend", "SpoolBackend", "ServingService", "start_serving",
]

#: dtypes accepted on the wire; uint8 is the EM-image fast path (4x
#: fewer bytes than float32 per request, normalized on the way in
#: exactly like the batch path)
_WIRE_DTYPES = ("uint8", "uint16", "float32")


class AdmissionRejected(RuntimeError):
    """Request refused at the door; ``reason`` is one of ``inflight``,
    ``memory``, ``duplicate``, ``draining``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


class AdmissionController:
    """The door: a hard in-flight bound plus the scheduler's host-memory
    watermark. Rejections are clean 429s with counters
    (``serving/rejected_admission`` / ``serving/rejected_memory``), not
    worker death — shedding is the contract under overload."""

    #: admitted working-set estimate per request byte: the float32 copy
    #: plus gathered patch stacks plus the weighted output stack, all
    #: transiently host-resident (serve/packer.py)
    MEM_FACTOR = 3.0

    def __init__(self, max_inflight: int = 8):
        self.max_inflight = int(max_inflight)
        self._lock = threading.Lock()
        self._inflight = 0
        self._draining = False

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def drain(self) -> None:
        """Stop admitting (graceful shutdown); in-flight requests finish."""
        with self._lock:
            self._draining = True

    def admit(self, nbytes: int) -> int:
        """Admit a request with an ``nbytes`` float32 working set or
        raise :class:`AdmissionRejected`. Returns the reserved byte
        count to pass back to :meth:`release`."""
        from chunkflow_tpu_torch.flow.scheduler import reserve_host_bytes

        reserve = int(nbytes * self.MEM_FACTOR)
        with self._lock:
            if self._draining:
                telemetry.inc("serving/rejected_admission")
                raise AdmissionRejected("draining", "server is draining")
            if self._inflight >= self.max_inflight:
                telemetry.inc("serving/rejected_admission")
                raise AdmissionRejected(
                    "inflight",
                    f"{self._inflight} requests in flight (max "
                    f"{self.max_inflight})",
                )
            if not reserve_host_bytes(reserve):
                telemetry.inc("serving/rejected_memory")
                raise AdmissionRejected(
                    "memory",
                    "admitting this request would cross the scheduler "
                    "memory watermark (CHUNKFLOW_SCHED_MEM_GB)",
                )
            self._inflight += 1
            inflight = self._inflight
        telemetry.inc("serving/admitted")
        telemetry.gauge("serving/inflight", inflight)
        return reserve

    def release(self, reserved: int) -> None:
        from chunkflow_tpu_torch.flow.scheduler import release_host_bytes

        release_host_bytes(reserved)
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            inflight = self._inflight
        telemetry.gauge("serving/inflight", inflight)


class ServingRequest:
    """One admitted request's state, shared between the HTTP handler
    thread and whichever worker (thread or process) completes it.
    Completion/failure is first-wins and counts each outcome exactly
    once no matter how many parties race to report it."""

    def __init__(self, chunk: Chunk, deadline: float,
                 req_id: Optional[str] = None):
        self.chunk = chunk
        self.deadline = deadline
        self.req_id = req_id or uuid.uuid4().hex
        self.trace_id: Optional[str] = None
        self.submitted_t = time.time()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[Chunk] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def expired(self) -> bool:
        return time.time() > self.deadline

    def complete(self, result: Chunk) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self._event.set()
        telemetry.inc("serving/completed")
        return True

    def fail(self, exc: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = exc
            self._event.set()
        if isinstance(exc, RequestExpired):
            telemetry.inc("serving/deadline_missed")
        else:
            telemetry.inc("serving/errors")
        return True

    def wait(self, timeout: Optional[float]) -> Chunk:
        """Block for the outcome; a wait that outlives the deadline
        fails the request with :class:`RequestExpired` (first-wins, so
        a worker finishing a hair later changes nothing)."""
        if not self._event.wait(timeout):
            self.fail(RequestExpired(
                f"request {self.req_id} missed its deadline"))
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._result


# ---------------------------------------------------------------------------
# local backend: worker threads + MemoryQueue lifecycle
# ---------------------------------------------------------------------------
class LocalBackend:
    """In-process execution: every admitted request is a supervised task
    on a private ``MemoryQueue`` — claimed under a lease, retried with
    backoff on transient errors, dead-lettered past the budget,
    committed exactly once through a ``MemoryLedger`` — and computed
    through ONE shared :class:`PatchPacker`, so concurrent requests'
    patches pack into shared device batches."""

    def __init__(self, inferencer, workers: int = 2, max_retries: int = 2,
                 max_wait_ms: float = 2.0, visibility_timeout: float = 30.0,
                 backoff_base: float = 0.05, backoff_cap: float = 1.0):
        from chunkflow_tpu_torch.parallel.lifecycle import (
            LifecycleSupervisor,
            MemoryLedger,
        )
        from chunkflow_tpu_torch.parallel.queues import MemoryQueue

        name = f"serve-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.queue = MemoryQueue.open(name, visibility_timeout)
        # idle workers re-enter the claim loop instead of exiting with it
        self.queue.max_empty_retries = 5
        self.queue.retry_sleep = 0.02
        self.ledger = MemoryLedger.open(name)
        self.packer = PatchPacker(inferencer, max_wait_ms=max_wait_ms)
        self._supervisor_factory = lambda: LifecycleSupervisor(
            self.queue, ledger=self.ledger, max_retries=max_retries,
            lease_renew=max(0.5, visibility_timeout / 3.0),
            backoff_base=backoff_base, backoff_cap=backoff_cap,
        )
        self._table: Dict[str, ServingRequest] = {}
        self._table_lock = threading.Lock()
        self._closed = False
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"serve-worker-{i}")
            for i in range(max(1, int(workers)))
        ]
        for t in self._threads:
            t.start()

    # -- front-end side -------------------------------------------------
    def submit(self, record: ServingRequest) -> None:
        with self._table_lock:
            self._table[record.req_id] = record
        self.queue.send_messages([record.req_id])

    def wait(self, record: ServingRequest, timeout: float) -> Chunk:
        try:
            return record.wait(timeout)
        finally:
            with self._table_lock:
                self._table.pop(record.req_id, None)

    # -- worker side ----------------------------------------------------
    def _work(self) -> None:
        supervisor = self._supervisor_factory()
        while not self._closed:
            # the claim loop ends after a short idle streak (bounded
            # empty polls); re-enter until the backend closes, so an
            # idle server keeps serving
            for lc in supervisor.tasks():
                try:
                    self._run_one(lc)
                except BaseException as exc:  # noqa: BLE001 — charge task
                    try:
                        lc.release(exc)
                    except Exception:
                        pass
                if self._closed:
                    break

    def _run_one(self, lc) -> None:
        with self._table_lock:
            record = self._table.get(lc.body)
        if record is None or record.done:
            # answered/expired/stale request (e.g. committed by a prior
            # attempt a hair before this redelivery): ack and move on
            lc.commit()
            return
        record.trace_id = lc.trace_id
        with telemetry.task_context(lc.trace_id):
            try:
                # fault-injection boundary: a seeded chaos kill here is
                # a transient failure; the lifecycle retries the request
                chaos.chaos_point("serving/compute")
                if record.expired:
                    raise RequestExpired(
                        f"request {record.req_id} expired before compute")
                out = self.packer.infer(
                    record.chunk, deadline=record.deadline,
                    timeout=max(0.05, record.deadline - time.time()) + 5.0,
                )
            except RequestExpired as exc:
                # not a compute failure: drop the claim cleanly (ack —
                # retrying an already-late request burns device time)
                record.fail(exc)
                lc.commit()
                return
            except BaseException as exc:
                outcome = lc.release(exc)
                if outcome in ("dead", "preempted"):
                    record.fail(exc)
                return
            record.complete(out)
            lc.commit()

    def close(self, timeout: float = 10.0) -> None:
        self._closed = True
        self.packer.close(drain=False)
        for t in self._threads:
            t.join(timeout=timeout / max(1, len(self._threads)))
        with self._table_lock:
            for record in self._table.values():
                record.fail(AdmissionRejected("draining", "server closed"))
            self._table.clear()


# ---------------------------------------------------------------------------
# spool backend: file queue + h5 spool, external worker processes
# ---------------------------------------------------------------------------
class SpoolBackend:
    """Cross-process execution: requests spool to ``<dir>/in/<bbox>.h5``
    and a ``file://`` queue; external workers run the standard
    supervised chain::

        python -m chunkflow_tpu_torch fetch-task-from-queue \\
            -q <dir>/queue --max-retries N --lease-renew S \\
            --ledger <dir>/ledger \\
          load-h5 -f <dir>/in/  inference ... --no-crop-output-margin \\
          save-h5 --file-name <dir>/out/  delete-task-in-queue

    The front-end answers when the completion ledger marks the request's
    bbox done and the output file lands. Workers are preemptible by
    construction: a SIGKILL mid-request surfaces as a lease expiry, the
    queue redelivers, and the ledger keeps the effect exactly-once.
    Requests must carry unique
    bboxes (the spool's task identity); a duplicate in-flight bbox is
    rejected up front rather than silently merged."""

    def __init__(self, spool_dir: str, visibility_timeout: float = 30.0,
                 poll_s: float = 0.05):
        from chunkflow_tpu_torch.parallel.lifecycle import FileLedger
        from chunkflow_tpu_torch.parallel.queues import open_queue

        self.dir = spool_dir
        self.in_dir = os.path.join(spool_dir, "in")
        self.out_dir = os.path.join(spool_dir, "out")
        self.queue_dir = os.path.join(spool_dir, "queue")
        self.ledger_dir = os.path.join(spool_dir, "ledger")
        for d in (self.in_dir, self.out_dir, self.ledger_dir):
            os.makedirs(d, exist_ok=True)
        self.queue = open_queue(self.queue_dir,
                                visibility_timeout=visibility_timeout)
        self.ledger = FileLedger(self.ledger_dir)
        self.poll_s = max(0.01, float(poll_s))
        self._inflight: Dict[str, ServingRequest] = {}
        self._lock = threading.Lock()

    def submit(self, record: ServingRequest) -> None:
        body = record.chunk.bbox.string
        with self._lock:
            if body in self._inflight:
                telemetry.inc("serving/rejected_duplicate")
                raise AdmissionRejected(
                    "duplicate", f"request bbox {body} already in flight")
            self._inflight[body] = record
        record.req_id = body
        record.chunk.to_h5(self.in_dir + os.sep)
        self.queue.send_messages([body])

    def wait(self, record: ServingRequest, timeout: float) -> Chunk:
        body = record.req_id
        out_path = os.path.join(self.out_dir, f"{body}.h5")
        deadline = time.time() + timeout
        try:
            while time.time() < deadline and not record.done:
                if self.ledger.is_done(body) and os.path.exists(out_path):
                    try:
                        record.complete(Chunk.from_h5(out_path))
                    except OSError:
                        pass  # torn read: the writer is mid-replace
                    else:
                        break
                time.sleep(self.poll_s)
            if not record.done:
                record.fail(RequestExpired(
                    f"request {body} missed its deadline"))
            return record.wait(0.0)
        finally:
            with self._lock:
                self._inflight.pop(body, None)
            # spool hygiene: the input file is consumed; output + ledger
            # marker stay (they ARE the exactly-once record)
            try:
                os.remove(os.path.join(self.in_dir, f"{body}.h5"))
            except OSError:
                pass

    def close(self, timeout: float = 0.0) -> None:
        with self._lock:
            for record in self._inflight.values():
                record.fail(AdmissionRejected("draining", "server closed"))
            self._inflight.clear()


# ---------------------------------------------------------------------------
# HTTP service
# ---------------------------------------------------------------------------
class ServingService(CoordinationService):
    """``POST /infer`` + ``GET /serving`` riding the coordination
    service's handler (so ``/metrics``, ``/healthz`` and ``/profile``
    share the listener). Transport-independent like its parent: tests
    drive :meth:`handle` directly, the CLI serves it over
    ``ThreadingHTTPServer``."""

    def __init__(self, backend, admission: Optional[AdmissionController]
                 = None, default_deadline_s: float = 30.0,
                 max_body_mb: float = 256.0):
        super().__init__()
        self.backend = backend
        self.admission = admission or AdmissionController()
        self.default_deadline_s = float(default_deadline_s)
        self.max_body_bytes = int(max_body_mb * (1 << 20))
        # volume-reference requests: one PrecomputedVolume handle per
        # path for the process lifetime; their cutouts ride the shared
        # hot-block LRU (volume/storage.py), so repeated serving loads
        # of overlapping regions hit host memory, not the disk
        self._volumes: dict = {}
        self._volumes_lock = threading.Lock()

    def handle(self, method: str, path: str, body: Optional[bytes] = None):
        if method == "POST" and path == "/infer":
            return self._handle_infer(body)
        if method == "GET" and path == "/serving":
            return 200, self.serving_stats()
        return super().handle(method, path, body)

    def serving_stats(self) -> dict:
        snap = telemetry.snapshot()
        counters = snap.get("counters", {})
        stats = {
            "inflight": self.admission.inflight,
            "max_inflight": self.admission.max_inflight,
            "requests": counters.get("serving/requests", 0),
            "completed": counters.get("serving/completed", 0),
            "rejected_admission": counters.get(
                "serving/rejected_admission", 0),
            "rejected_memory": counters.get("serving/rejected_memory", 0),
            "deadline_missed": counters.get("serving/deadline_missed", 0),
            "errors": counters.get("serving/errors", 0),
        }
        qhists = snap.get("qhists", {})
        latency = qhists.get("serving/latency")
        if latency:
            stats["latency_p50_s"] = telemetry.quantile_from_buckets(
                latency, 0.5)
            stats["latency_p99_s"] = telemetry.quantile_from_buckets(
                latency, 0.99)
        # the SLO view of the same traffic (core/slo.py): firing alert
        # names ride the /serving payload so a serving dashboard shows
        # "out of spec" next to the raw counters; full burn-rate /
        # budget detail lives on the sibling /alerts route
        from chunkflow_tpu_torch.core import slo

        evaluator = slo.current()
        if evaluator is not None:
            stats["slo_firing"] = evaluator.firing()
        return stats

    # -- the request path ----------------------------------------------
    @staticmethod
    def _parse_request(body: Optional[bytes]) -> dict:
        if not body:
            raise ValueError("empty request body")
        try:
            payload = json.loads(body)
        except ValueError as exc:
            raise ValueError(f"request body is not JSON: {exc}") from None
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        return payload

    def _volume(self, path: str):
        """The cached PrecomputedVolume handle for one dataset path."""
        with self._volumes_lock:
            vol = self._volumes.get(path)
        if vol is not None:
            return vol
        from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

        vol = PrecomputedVolume(path)
        with self._volumes_lock:
            # benign race: last writer wins, both handles share the
            # process-wide block cache anyway
            self._volumes[path] = vol
        return vol

    def _load_volume_chunk(self, payload: dict) -> Chunk:
        """A volume-reference request: instead of inline ``data_b64``
        the body names a precomputed volume and a bbox, and the serving
        plane cuts the chunk out itself — through
        :meth:`PrecomputedVolume.cutout`, i.e. block-decomposed
        concurrent reads riding the shared hot-block LRU
        (``volume/storage.py``), so overlapping serving loads hit host
        memory instead of re-reading the disk; blocks are decoded by the
        volume's codec, as tensorstore decodes them for the JAX server. A
        scale the codecs refuse or a block that does not decode is a 400."""
        path = payload.get("volume_path")
        if not isinstance(path, str) or not path:
            raise ValueError("volume_path must be a non-empty string")
        if payload.get("data_b64") is not None:
            raise ValueError(
                "volume_path and data_b64 are mutually exclusive")
        start = payload.get("bbox_start")
        size = payload.get("bbox_size")
        if (not isinstance(start, (list, tuple)) or len(start) != 3
                or not all(isinstance(v, int) for v in start)):
            raise ValueError("bbox_start must be three ints (zyx voxels)")
        if (not isinstance(size, (list, tuple)) or len(size) != 3
                or not all(isinstance(v, int) and v > 0 for v in size)):
            raise ValueError(
                "bbox_size must be three positive ints (zyx voxels)")
        mip = payload.get("mip", 0)
        if not isinstance(mip, int) or mip < 0:
            raise ValueError("mip must be a non-negative int")
        try:
            vol = self._volume(path)
            nchan = vol.num_channels
            itemsize = np.dtype(vol.dtype).itemsize
        except ValueError:
            raise
        except Exception as exc:  # noqa: BLE001 — bad dataset = client error
            raise ValueError(
                f"cannot open volume {path!r}: "
                f"{type(exc).__name__}: {exc}") from None
        est = int(np.prod(size)) * nchan * itemsize
        if est > self.max_body_bytes:
            raise ValueError(
                f"bbox implies {est} bytes, over the "
                f"{self.max_body_bytes >> 20} MiB request bound")
        from chunkflow_tpu_torch.core.bbox import BoundingBox

        bbox = BoundingBox.from_delta(tuple(start), tuple(size))
        try:
            return vol.cutout(bbox, mip=mip)
        except ValueError:
            raise
        except Exception as exc:  # noqa: BLE001 — unreadable region
            raise ValueError(
                f"cutout {tuple(start)}+{tuple(size)} failed: "
                f"{type(exc).__name__}: {exc}") from None

    def _decode_chunk(self, payload: dict) -> Chunk:
        if payload.get("volume_path") is not None:
            return self._load_volume_chunk(payload)
        shape = payload.get("shape")
        if (not isinstance(shape, (list, tuple)) or len(shape) not in (3, 4)
                or not all(isinstance(s, int) and s > 0 for s in shape)):
            raise ValueError(
                "shape must be a [z,y,x] or [c,z,y,x] list of positive ints")
        dtype = payload.get("dtype", "uint8")
        if dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"dtype must be one of {_WIRE_DTYPES}, got {dtype!r}")
        data_b64 = payload.get("data_b64")
        if not isinstance(data_b64, str):
            raise ValueError("data_b64 (base64 of C-order raw bytes) "
                             "is required")
        try:
            raw = base64.b64decode(data_b64, validate=True)
        except (binascii.Error, ValueError) as exc:
            raise ValueError(f"data_b64 is not valid base64: {exc}") \
                from None
        expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if len(raw) != expected:
            raise ValueError(
                f"payload is {len(raw)} bytes but shape/dtype imply "
                f"{expected}")
        if expected > self.max_body_bytes:
            raise ValueError(
                f"request exceeds max body size "
                f"({self.max_body_bytes >> 20} MiB)")
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        voxel_offset = tuple(payload.get("voxel_offset") or (0, 0, 0))
        if len(voxel_offset) != 3 or not all(
                isinstance(v, int) for v in voxel_offset):
            raise ValueError("voxel_offset must be three ints")
        return Chunk(arr.copy(), voxel_offset=voxel_offset)

    @staticmethod
    def _encode_chunk(chunk: Chunk) -> dict:
        # bfloat16 has no portable wire representation: widen to f32
        arr = as_native_dtype(chunk.host().array)
        if arr.dtype.name not in _WIRE_DTYPES:
            arr = arr.astype(np.float32)
        return {
            "shape": list(arr.shape),
            "dtype": arr.dtype.name,
            "data_b64": base64.b64encode(
                np.ascontiguousarray(arr).tobytes()).decode(),
            "voxel_offset": [int(v) for v in chunk.voxel_offset],
        }

    def _handle_infer(self, body: Optional[bytes]):
        telemetry.inc("serving/requests")
        t0 = time.time()
        try:
            with telemetry.span("serving/decode"):
                payload = self._parse_request(body)
                chunk = self._decode_chunk(payload)
        except ValueError as exc:
            telemetry.inc("serving/errors")
            return 400, {"error": str(exc)}
        deadline_s = payload.get("deadline_s")
        try:
            deadline_s = (self.default_deadline_s if deadline_s is None
                          else max(0.001, float(deadline_s)))
        except (TypeError, ValueError):
            telemetry.inc("serving/errors")
            return 400, {"error": "deadline_s must be a number"}

        # float32 working-set estimate for admission: the request rides
        # the packer as f32 regardless of wire dtype
        f32_bytes = int(np.prod(chunk.shape)) * 4
        try:
            reserved = self.admission.admit(f32_bytes)
        except AdmissionRejected as exc:
            return 429, {"error": str(exc), "reason": exc.reason,
                         "retry_after_s": 0.5}
        record = ServingRequest(chunk, deadline=t0 + deadline_s)
        try:
            with telemetry.span("serving/request"):
                try:
                    self.backend.submit(record)
                except AdmissionRejected as exc:
                    return 429, {"error": str(exc), "reason": exc.reason}
                try:
                    result = self.backend.wait(
                        record, timeout=record.deadline - time.time())
                except RequestExpired as exc:
                    telemetry.observe_quantile(
                        "serving/latency", time.time() - t0)
                    return 504, {"error": str(exc),
                                 "trace_id": record.trace_id}
                except BaseException as exc:  # noqa: BLE001 — clean 500
                    return 500, {"error": f"{type(exc).__name__}: {exc}",
                                 "trace_id": record.trace_id}
            latency = time.time() - t0
            telemetry.observe_quantile("serving/latency", latency)
            with telemetry.span("serving/encode"):
                response = self._encode_chunk(result)
            response["trace_id"] = record.trace_id
            response["latency_s"] = round(latency, 6)
            return 200, response
        finally:
            self.admission.release(reserved)


def start_serving(service: ServingService, host: str = "0.0.0.0",
                  port: int = 0):
    """Serve a :class:`ServingService` in the background; returns the
    live server — read the ACTUALLY-bound port from
    ``server.server_address`` (port 0 binds ephemeral, the
    multiple-workers-per-host case)."""
    server, _thread = serve(service, host=host, port=int(port),
                            background=True)
    return server
