"""Task queues: the workers' only means of coordination.

The counterpart of ``chunkflow_tpu/parallel/queues.py``: a queue of bbox
strings with a visibility timeout and ack-after-write commits, plus the
lifecycle protocol ``parallel/lifecycle.py`` drives: :meth:`renew` (the
lease heartbeat), :meth:`nack` (hand a claim back now), per-task
:meth:`receive_count`, and a dead-letter store
(:meth:`dead_letter` / :meth:`dead_letters` / :meth:`requeue_dead`);
:meth:`force_release` hands back a dead worker's claims for the fleet
supervisor (``parallel/fleet.py``).

Backends: ``memory://name`` (in-process), ``file:///dir`` (a directory
of task files, claimed by atomic rename, safe across processes on one
filesystem), with the JAX package's on-disk layout, so a queue that
either package filled drains in the other, and ``sqs://name``
(:class:`SQSQueue`, the JAX class over the port's own SQS client,
``cloud/sqs.py``, where the JAX package needs boto3).

Every task sent is wrapped in a JSON envelope carrying a fresh trace id;
:meth:`receive` unwraps it, so consumers see the plain body, and a body
without an envelope unwraps to itself.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

from chunkflow_tpu_torch.core import telemetry

__all__ = ["new_trace_id", "pack_task", "unpack_task", "QueueBase",
           "MemoryQueue", "FileQueue", "SQSQueue", "open_queue"]

_ENVELOPE_PREFIX = '{"chunkflow"'


def new_trace_id() -> str:
    """A fresh 32-hex trace id, minted once per task submission."""
    return uuid.uuid4().hex


def pack_task(body: str, trace_id: Optional[str] = None) -> str:
    """The wire envelope of a task body. Idempotent: an envelope comes
    back unchanged, so a requeued task keeps its trace id."""
    if unpack_task(body)[1] is not None:
        return body
    if trace_id is None:
        trace_id = new_trace_id()
    return json.dumps({"chunkflow": 1, "body": body, "trace_id": trace_id})


def unpack_task(raw: str) -> Tuple[str, Optional[str]]:
    """``(body, trace_id)`` of a wire payload; a payload that is no
    envelope unwraps to ``(raw, None)``."""
    if raw.startswith(_ENVELOPE_PREFIX):
        try:
            env = json.loads(raw)
        except ValueError:
            return raw, None
        if isinstance(env, dict) and "body" in env:
            return str(env["body"]), env.get("trace_id")
    return raw, None


class QueueBase:
    """(handle, body) iteration and the ack / lease / dead-letter protocol
    every backend speaks."""

    visibility_timeout: float = 1800.0
    # polling iteration: empty receives tolerated before the iteration
    # ends, and the sleep between them
    max_empty_retries = 3
    retry_sleep = 1.0

    def send_messages(self, bodies: List[str]) -> None:
        raise NotImplementedError

    def receive(self) -> Optional[Tuple[str, str]]:
        """One (handle, body), or None when nothing is visible."""
        raise NotImplementedError

    def delete(self, handle: str) -> None:
        """Ack: remove a claimed task for good (the commit point)."""
        raise NotImplementedError

    def renew(self, handle: str, timeout: Optional[float] = None) -> None:
        """Keep the claim invisible for ``timeout`` more seconds (default:
        the visibility timeout) from now."""
        raise NotImplementedError

    def nack(self, handle: str, refund: bool = True) -> bool:
        """Make a claimed task visible now. With ``refund`` the delivery
        is a hand-back, not a failure: the receive count goes down by
        one. False when there was no claim to release."""
        raise NotImplementedError

    def force_release(self, handles, refund: bool = False) -> int:
        """Third-party nack: hand back the claims a dead or evicted worker
        still holds (the handles it last reported over ``/healthz``), so
        its tasks come back now, not after the visibility timeout. No
        refund by default: a crash-shaped delivery keeps counting toward
        ``--max-retries``, or a task that kills every worker it lands on
        would come back forever. An error on one handle (expired, acked,
        claimed again) is skipped; returns how many claims were really
        released."""
        released = 0
        for handle in handles or ():
            try:
                if self.nack(handle, refund=refund):
                    released += 1
            except Exception:
                continue
        return released

    def receive_count(self, handle: str) -> int:
        """Deliveries of the claimed task, this one included."""
        return 0

    def dead_letter(self, handle: str, reason: str = "") -> None:
        """Move a claimed task to the dead-letter store with its reason."""
        raise NotImplementedError

    def dead_letters(self) -> List[dict]:
        """The dead-letter entries, ``{"body", "reason", "receives", "t"}``."""
        raise NotImplementedError

    def requeue_dead(self) -> int:
        """Move every dead-letter entry back to pending; how many moved."""
        raise NotImplementedError

    def _pack_bodies(self, bodies: List[str]) -> List[str]:
        packed = []
        for body in bodies:
            wire = pack_task(body)
            packed.append(wire)
            plain, trace_id = unpack_task(wire)
            telemetry.inc("queue/sent")
            telemetry.event("task", "queue/submit", queue=self.describe(),
                            body=plain, trace_id=trace_id)
        return packed

    def _note_receive(self, handle: str, trace_id: Optional[str]) -> None:
        if not hasattr(self, "_traces"):
            self._traces: Dict[str, Optional[str]] = {}
        self._traces[handle] = trace_id
        telemetry.inc("queue/receives")

    def trace_id(self, handle: str) -> Optional[str]:
        """The trace id of a claimed task (None without an envelope)."""
        return getattr(self, "_traces", {}).get(handle)

    @staticmethod
    def _present(entry: dict) -> dict:
        """A dead-letter entry as listed: the plain body and its trace id
        (the stored body stays an envelope, so a requeue keeps it)."""
        body, trace_id = unpack_task(entry.get("body", ""))
        shown = dict(entry)
        shown["body"] = body
        if trace_id is not None:
            shown.setdefault("trace_id", trace_id)
        return shown

    def describe(self) -> str:
        return getattr(self, "name", None) or getattr(self, "dir", "") \
            or type(self).__name__

    def stats(self) -> dict:
        """``{"pending", "inflight", "dead", "receives"}``."""
        raise NotImplementedError

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        empty = 0
        while True:
            item = self.receive()
            if item is None:
                empty += 1
                if empty > self.max_empty_retries:
                    return
                time.sleep(self.retry_sleep)
                continue
            empty = 0
            yield item


class MemoryQueue(QueueBase):
    """In-process queue with visibility-timeout semantics; every compound
    transition holds one lock (worker threads and the lease heartbeat
    share it)."""

    _registry: Dict[str, "MemoryQueue"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, name: str, visibility_timeout: float = 1800.0):
        self.name = name
        self.visibility_timeout = visibility_timeout
        self.pending: Dict[str, str] = {}
        # handle -> (wire body, visibility deadline)
        self.invisible: Dict[str, Tuple[str, float]] = {}
        self.receives: Dict[str, int] = {}
        self.dead: Dict[str, dict] = {}
        self.retry_sleep = 0.01
        self._lock = threading.Lock()

    @classmethod
    def open(cls, name: str,
             visibility_timeout: float = 1800.0) -> "MemoryQueue":
        with cls._registry_lock:
            if name not in cls._registry:
                cls._registry[name] = cls(name, visibility_timeout)
            else:
                cls._registry[name].visibility_timeout = visibility_timeout
            return cls._registry[name]

    def send_messages(self, bodies: List[str]) -> None:
        packed = self._pack_bodies(bodies)
        with self._lock:
            for body in packed:
                self.pending[uuid.uuid4().hex] = body

    def _requeue_expired(self) -> None:
        """Caller holds ``_lock``."""
        now = time.time()
        for handle in [h for h, (_, deadline) in self.invisible.items()
                       if now > deadline]:
            self.pending[handle] = self.invisible.pop(handle)[0]

    def receive(self) -> Optional[Tuple[str, str]]:
        with self._lock:
            self._requeue_expired()
            if not self.pending:
                return None
            handle, wire = next(iter(self.pending.items()))
            del self.pending[handle]
            self.invisible[handle] = (wire,
                                      time.time() + self.visibility_timeout)
            self.receives[handle] = self.receives.get(handle, 0) + 1
        body, trace_id = unpack_task(wire)
        self._note_receive(handle, trace_id)
        return handle, body

    def delete(self, handle: str) -> None:
        with self._lock:
            self.invisible.pop(handle, None)
            self.pending.pop(handle, None)
            self.receives.pop(handle, None)
            getattr(self, "_traces", {}).pop(handle, None)

    def renew(self, handle: str, timeout: Optional[float] = None) -> None:
        with self._lock:
            entry = self.invisible.get(handle)
            if entry is None:
                return  # expired or acked: nothing to extend
            timeout = self.visibility_timeout if timeout is None else timeout
            self.invisible[handle] = (entry[0], time.time() + timeout)

    def nack(self, handle: str, refund: bool = True) -> bool:
        with self._lock:
            entry = self.invisible.pop(handle, None)
            if entry is None:
                return False
            self.pending[handle] = entry[0]
            if refund and self.receives.get(handle, 0) > 0:
                self.receives[handle] -= 1
            return True

    def receive_count(self, handle: str) -> int:
        with self._lock:
            return self.receives.get(handle, 0)

    def dead_letter(self, handle: str, reason: str = "") -> None:
        with self._lock:
            entry = self.invisible.pop(handle, None)
            body = entry[0] if entry else self.pending.pop(handle, None)
            if body is None:
                return
            self.dead[handle] = {"body": body, "reason": reason,
                                 "receives": self.receives.pop(handle, 0),
                                 "t": time.time()}

    def dead_letters(self) -> List[dict]:
        with self._lock:
            return [self._present(entry) for entry in self.dead.values()]

    def requeue_dead(self) -> int:
        with self._lock:
            count = len(self.dead)
            for handle, entry in list(self.dead.items()):
                del self.dead[handle]
                self.pending[handle] = entry["body"]
            return count

    def stats(self) -> dict:
        with self._lock:
            self._requeue_expired()
            return {"pending": len(self.pending),
                    "inflight": len(self.invisible),
                    "dead": len(self.dead),
                    "receives": sum(self.receives.values())}

    def __len__(self) -> int:
        with self._lock:
            self._requeue_expired()
            return len(self.pending)


class FileQueue(QueueBase):
    """A directory of task files; an atomic rename is the claim.

    Layout (the JAX package's): ``pending/<id>`` holds the wire body, a
    claim renames it to ``claimed/<id>``, an ack removes it. A claim whose
    mtime is older than the visibility timeout returns to ``pending`` on
    the next receive, so a dead worker's task reappears. ``counts/<id>``
    holds the delivery count (it survives such requeues), ``dead/<id>``
    a dead-lettered task as JSON ``{body, reason, receives, t}``.
    """

    def __init__(self, directory: str, visibility_timeout: float = 1800.0):
        self.dir = directory
        self.pending_dir = os.path.join(directory, "pending")
        self.claimed_dir = os.path.join(directory, "claimed")
        self.counts_dir = os.path.join(directory, "counts")
        self.dead_dir = os.path.join(directory, "dead")
        for d in (self.pending_dir, self.claimed_dir, self.counts_dir,
                  self.dead_dir):
            os.makedirs(d, exist_ok=True)
        self.visibility_timeout = visibility_timeout

    def send_messages(self, bodies: List[str]) -> None:
        for body in self._pack_bodies(bodies):
            name = uuid.uuid4().hex
            tmp = os.path.join(self.dir, f".tmp-{name}")
            with open(tmp, "w") as f:
                f.write(body)
            os.rename(tmp, os.path.join(self.pending_dir, name))

    def _requeue_expired(self) -> None:
        now = time.time()
        for name in os.listdir(self.claimed_dir):
            path = os.path.join(self.claimed_dir, name)
            try:
                if now - os.path.getmtime(path) > self.visibility_timeout:
                    os.rename(path, os.path.join(self.pending_dir, name))
            except OSError:
                pass  # another worker won the race
        # a writer that died mid-write leaves a .tmp-* file: sweep the
        # stale ones (older than the timeout, so a live write is safe)
        for d in (self.dir, self.counts_dir):
            for name in os.listdir(d):
                if not name.startswith(".tmp-"):
                    continue
                path = os.path.join(d, name)
                try:
                    if now - os.path.getmtime(path) > self.visibility_timeout:
                        os.remove(path)
                except OSError:
                    pass

    def _write_count(self, name: str, count: int) -> bool:
        """Rewrite a count file through a temporary and a rename, so a
        reader never sees it half written."""
        tmp = os.path.join(self.counts_dir, f".tmp-{uuid.uuid4().hex}")
        try:
            with open(tmp, "w") as f:
                f.write(str(count))
            os.rename(tmp, os.path.join(self.counts_dir, name))
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        return True

    def _read_count(self, name: str) -> int:
        try:
            with open(os.path.join(self.counts_dir, name)) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _bump_count(self, name: str) -> int:
        count = self._read_count(name) + 1
        self._write_count(name, count)
        return count

    def receive(self) -> Optional[Tuple[str, str]]:
        self._requeue_expired()
        for name in sorted(os.listdir(self.pending_dir)):
            src = os.path.join(self.pending_dir, name)
            dst = os.path.join(self.claimed_dir, name)
            try:
                os.rename(src, dst)  # the atomic claim
            except OSError:
                continue  # another worker claimed it first
            os.utime(dst)
            self._bump_count(name)
            with open(dst) as f:
                body, trace_id = unpack_task(f.read())
            self._note_receive(name, trace_id)
            return name, body
        return None

    def delete(self, handle: str) -> None:
        for path in (os.path.join(self.claimed_dir, handle),
                     os.path.join(self.counts_dir, handle)):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        getattr(self, "_traces", {}).pop(handle, None)

    def renew(self, handle: str, timeout: Optional[float] = None) -> None:
        timeout = self.visibility_timeout if timeout is None else timeout
        # a claim expires at mtime + visibility timeout: place the mtime so
        # it lives `timeout` seconds from now
        stamp = time.time() + timeout - self.visibility_timeout
        try:
            os.utime(os.path.join(self.claimed_dir, handle), (stamp, stamp))
        except OSError:
            pass  # expired and claimed elsewhere: the lease is lost

    def nack(self, handle: str, refund: bool = True) -> bool:
        # the refund lands before the rename makes the task visible: while
        # the claim file exists no other worker can claim and bump it
        refunded = False
        if refund:
            count = self._read_count(handle)
            if count > 0:
                refunded = self._write_count(handle, count - 1)
        try:
            os.rename(os.path.join(self.claimed_dir, handle),
                      os.path.join(self.pending_dir, handle))
        except OSError:
            if refunded:  # requeued by another worker: the count stands
                self._bump_count(handle)
            return False
        return True

    def receive_count(self, handle: str) -> int:
        return self._read_count(handle)

    def dead_letter(self, handle: str, reason: str = "") -> None:
        try:
            with open(os.path.join(self.claimed_dir, handle)) as f:
                body = f.read()
        except OSError:
            return  # the claim is lost: another worker owns the task
        entry = {"body": body, "reason": reason,
                 "receives": self._read_count(handle), "t": time.time()}
        tmp = os.path.join(self.dir, f".tmp-dead-{handle}")
        with open(tmp, "w") as f:
            json.dump(entry, f)
        os.rename(tmp, os.path.join(self.dead_dir, handle))
        self.delete(handle)

    def dead_letters(self) -> List[dict]:
        entries = []
        for name in sorted(os.listdir(self.dead_dir)):
            try:
                with open(os.path.join(self.dead_dir, name)) as f:
                    entries.append(self._present(json.load(f)))
            except (OSError, ValueError):
                continue
        return entries

    def requeue_dead(self) -> int:
        count = 0
        for name in sorted(os.listdir(self.dead_dir)):
            path = os.path.join(self.dead_dir, name)
            try:
                with open(path) as f:
                    entry = json.load(f)
            except (OSError, ValueError):
                continue
            self.send_messages([entry["body"]])  # the envelope is kept
            try:
                os.remove(path)
            except OSError:
                continue
            count += 1
        return count

    def stats(self) -> dict:
        self._requeue_expired()
        receives = sum(self._read_count(name)
                       for name in os.listdir(self.counts_dir)
                       if not name.startswith(".tmp-"))
        return {"pending": len(os.listdir(self.pending_dir)),
                "inflight": len(os.listdir(self.claimed_dir)),
                "dead": len(os.listdir(self.dead_dir)),
                "receives": receives}

    def __len__(self) -> int:
        return len(os.listdir(self.pending_dir))


class SQSQueue(QueueBase):
    """An SQS queue, the JAX package's ``SQSQueue`` call for call: batch
    sends of 10 whose ``Failed`` subset is retried once, an md5 check of
    each body, ``ApproximateReceiveCount`` as the receive count, ``nack``
    as visibility 0, dead letters in ``<name>-dead`` (visibility 300 s,
    listed by receiving until it is empty). ``client`` is anything with
    boto3's SQS methods; by default the port's own ``SQSClient``."""

    def __init__(self, name: str, visibility_timeout: int = 1800,
                 client=None):
        if client is None:
            from chunkflow_tpu_torch.cloud.sqs import SQSClient

            client = SQSClient()
        self.client = client
        self.name = name
        self.visibility_timeout = visibility_timeout
        resp = self.client.create_queue(
            QueueName=name,
            Attributes={"VisibilityTimeout": str(visibility_timeout)})
        self.queue_url = resp["QueueUrl"]
        self._dead_url: Optional[str] = None
        self._receive_counts: Dict[str, int] = {}
        self._bodies: Dict[str, str] = {}

    def _send_batch(self, entries: List[dict]) -> None:
        resp = self.client.send_message_batch(QueueUrl=self.queue_url,
                                              Entries=entries)
        failed = resp.get("Failed") or []
        if not failed:
            return
        # a partial failure is a success answer carrying Failed entries:
        # retry that subset once (throttling is transient), then raise
        failed_ids = {f["Id"] for f in failed}
        retry = [e for e in entries if e["Id"] in failed_ids]
        resp = self.client.send_message_batch(QueueUrl=self.queue_url,
                                              Entries=retry)
        failed = resp.get("Failed") or []
        if failed:
            raise IOError(
                f"SQS send_message_batch failed for {len(failed)} "
                f"message(s) after retry: "
                + "; ".join(f"{f.get('Id')}: {f.get('Code')} "
                            f"{f.get('Message', '')}" for f in failed))

    def send_messages(self, bodies: List[str]) -> None:
        bodies = self._pack_bodies(bodies)
        for i in range(0, len(bodies), 10):  # the SQS batch limit
            self._send_batch([{"Id": str(j), "MessageBody": body}
                              for j, body in enumerate(bodies[i:i + 10])])

    def receive(self) -> Optional[Tuple[str, str]]:
        resp = self.client.receive_message(
            QueueUrl=self.queue_url, MaxNumberOfMessages=1,
            WaitTimeSeconds=20, AttributeNames=["ApproximateReceiveCount"])
        messages = resp.get("Messages", [])
        if not messages:
            return None
        msg = messages[0]
        expected = msg.get("MD5OfBody")
        if expected:
            got = hashlib.md5(msg["Body"].encode()).hexdigest()
            if got != expected:
                raise IOError(f"SQS body md5 mismatch: got {got}, "
                              f"expected {expected}")
        handle = msg["ReceiptHandle"]
        try:
            self._receive_counts[handle] = int(
                (msg.get("Attributes") or {}).get("ApproximateReceiveCount",
                                                  0))
        except (TypeError, ValueError):
            self._receive_counts[handle] = 0
        self._bodies[handle] = msg["Body"]  # a dead letter re-sends it
        body, trace_id = unpack_task(msg["Body"])
        self._note_receive(handle, trace_id)
        return handle, body

    def delete(self, handle: str) -> None:
        self.client.delete_message(QueueUrl=self.queue_url,
                                   ReceiptHandle=handle)
        self._receive_counts.pop(handle, None)
        self._bodies.pop(handle, None)
        getattr(self, "_traces", {}).pop(handle, None)

    def renew(self, handle: str, timeout: Optional[float] = None) -> None:
        timeout = self.visibility_timeout if timeout is None else timeout
        self.client.change_message_visibility(
            QueueUrl=self.queue_url, ReceiptHandle=handle,
            VisibilityTimeout=int(timeout))

    def nack(self, handle: str, refund: bool = True) -> bool:
        # SQS cannot lower ApproximateReceiveCount: ``refund`` is accepted
        # and has no effect
        self.renew(handle, 0)
        return True

    def receive_count(self, handle: str) -> int:
        return self._receive_counts.get(handle, 0)

    def _dead_queue_url(self) -> str:
        if self._dead_url is None:
            # a short visibility: dead_letters() lists by receiving until
            # the queue is empty, so listed entries must hide in between
            # and come back soon after
            resp = self.client.create_queue(
                QueueName=f"{self.name}-dead",
                Attributes={"VisibilityTimeout": "300"})
            self._dead_url = resp["QueueUrl"]
        return self._dead_url

    def dead_letter(self, handle: str, reason: str = "") -> None:
        body = self._bodies.get(handle)
        if body is None:
            return  # not a task this client received
        entry = {"body": body, "reason": reason,
                 "receives": self.receive_count(handle), "t": time.time()}
        self.client.send_message(QueueUrl=self._dead_queue_url(),
                                 MessageBody=json.dumps(entry))
        self.delete(handle)

    def _drain_dead(self):
        while True:
            resp = self.client.receive_message(
                QueueUrl=self._dead_queue_url(), MaxNumberOfMessages=10,
                WaitTimeSeconds=0)
            messages = resp.get("Messages", [])
            if not messages:
                return
            for msg in messages:
                try:
                    entry = json.loads(msg["Body"])
                except ValueError:
                    entry = {"body": msg["Body"], "reason": "",
                             "receives": 0}
                yield msg["ReceiptHandle"], entry

    def dead_letters(self) -> List[dict]:
        # SQS lists nothing without receiving it: the entries hide for
        # the dead queue's visibility timeout and then come back
        return [self._present(entry) for _, entry in self._drain_dead()]

    def requeue_dead(self) -> int:
        count = 0
        for handle, entry in self._drain_dead():
            self.send_messages([entry["body"]])
            self.client.delete_message(QueueUrl=self._dead_queue_url(),
                                       ReceiptHandle=handle)
            count += 1
        return count

    def stats(self) -> dict:
        """Depths the service reports; ``None`` where it cannot say."""
        out = {"pending": None, "inflight": None, "dead": None,
               "receives": sum(self._receive_counts.values()) or None}
        try:
            resp = self.client.get_queue_attributes(
                QueueUrl=self.queue_url,
                AttributeNames=["ApproximateNumberOfMessages",
                                "ApproximateNumberOfMessagesNotVisible"])
            attrs = resp.get("Attributes") or {}
            out["pending"] = int(attrs.get("ApproximateNumberOfMessages", 0))
            out["inflight"] = int(
                attrs.get("ApproximateNumberOfMessagesNotVisible", 0))
        except Exception:
            pass  # restricted permissions: the depth stays unknown
        try:
            resp = self.client.get_queue_attributes(
                QueueUrl=self._dead_queue_url(),
                AttributeNames=["ApproximateNumberOfMessages"])
            out["dead"] = int((resp.get("Attributes") or {})
                              .get("ApproximateNumberOfMessages", 0))
        except Exception:
            pass
        return out


def open_queue(spec: str, visibility_timeout: float = 1800.0) -> QueueBase:
    """A queue from ``memory://name``, ``file:///dir`` (a bare path is a
    directory) or ``sqs://name``."""
    if spec.startswith("memory://"):
        return MemoryQueue.open(spec[len("memory://"):], visibility_timeout)
    if spec.startswith("sqs://"):
        return SQSQueue(spec[len("sqs://"):], int(visibility_timeout))
    if spec.startswith("file://"):
        spec = spec[len("file://"):]
    return FileQueue(spec, visibility_timeout)
