"""Local stand-ins for Google Cloud Storage, S3, SQS and CloudWatch (test
infrastructure, not a feature of the port).

Each fake is a ``ThreadingHTTPServer`` on ``127.0.0.1`` (port 0 picks a
free one) holding its objects or messages in memory:

* :class:`FakeGCS`: the JSON API (media reads with ``Range``, media
  uploads, listing with paging, deletes; generations and
  ``ifGenerationMatch`` / ``ifGenerationNotMatch``). With a public key
  (``key=`` a PEM private key file, whose public half it keeps) it is also
  an OAuth token endpoint (``POST /token``: RS256 JWT assertions and one
  refresh token) and a GCE metadata server, and then requires the bearer
  tokens it issued;
* :class:`FakeS3`: path-style REST (``GET`` with ``Range``, ``PUT`` with
  ``If-None-Match: *`` / ``If-Match``, ``DELETE``, ``ListObjectsV2`` with
  paging; MD5 ETags), checking every SigV4 signature when given
  ``secrets`` (a 403 otherwise);
* :class:`FakeSQS`: the AWS JSON 1.0 protocol (queues, batches,
  visibility timeouts, ``ApproximateReceiveCount``, ``MD5OfBody``,
  ``WaitTimeSeconds`` long polls), also SigV4-checked;
* :class:`FakeCloudWatch`: ``PutMetricData`` over the AWS Query
  protocol, SigV4-checked, each call's namespace and metric data
  recorded (``calls``, also in ``/_fake/stats``), at most 20 data a
  call.

Listings page every ``page_size`` (3) items, so paging runs. Faults: a
503 on a seeded share of requests (``fail_rate``), dropped connections
(``drop_next``: the next n requests are read and closed unanswered), a
forced 412 on the next conditional write of a named object (``race``),
and a delay before every answer (``delay_s``). ``/_fake/stats`` (GET)
and ``/_fake/config`` (POST, JSON) read and set these on a running fake.

In a thread: ``with FakeGCS() as gcs: ...`` (``gcs.url``). In a process
that worker processes reach::

    python -m chunkflow_tpu_torch.testing.cloud_fakes --port-file F \\
        [--sigv4] [--key KEY.pem] [--fail-rate R] [--seed S]

writes ``{"gcs": url, "s3": url, "sqs": url, "cloudwatch": url}`` to
``F`` and serves until
SIGTERM; :func:`cloud_env` gives the environment that points both
packages' clients at such fakes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from xml.sax.saxutils import escape

from chunkflow_tpu_torch.cloud import aws, google

__all__ = ["FakeGCS", "FakeS3", "FakeSQS", "FakeCloudWatch", "cloud_env",
           "ACCESS_KEY", "SECRET_KEY", "spawn", "control"]

ACCESS_KEY = "AKIDCHUNKFLOWTEST"
SECRET_KEY = "chunkflow/test/secret/key/not/a/real/one"
ACCOUNT = "000000000000"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def setup(self):
        super().setup()
        # headers and body leave in two writes: no Nagle delay between
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _dispatch(self):
        self.server.fake.dispatch(self)

    do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _dispatch

    def log_message(self, *args):
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128

    def handle_error(self, request, client_address):
        # a client that went away (a killed worker) is no fault of ours
        if not isinstance(sys.exc_info()[1], ConnectionError):
            super().handle_error(request, client_address)


class _Fake:
    """The server, the fault knobs, the counters."""

    name = "fake"
    #: listing page size: small, so that paging runs
    page_size = 3

    def __init__(self, fail_rate: float = 0.0, seed: int = 0):
        self.lock = threading.Condition()
        self.fail_rate = float(fail_rate)
        self.rng = random.Random(seed)
        self.delay_s = 0.0
        self.drop_next = 0
        self.race: set = set()
        self.server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self.reset_stats()

    # ---- lifetime ---------------------------------------------------------
    def start(self) -> "_Fake":
        self.server = _Server(("127.0.0.1", 0), _Handler)
        self.server.fake = self
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name=f"fake-{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self._thread.join(timeout=5)
            self.server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    # ---- counters and knobs -------------------------------------------------
    def reset_stats(self) -> None:
        with self.lock:
            self.stats = {"requests": {}, "status": {}, "bytes_in": 0,
                          "bytes_out": 0, "faults_503": 0, "dropped": 0,
                          "forced_412": 0, "auth_refused": 0}

    def snapshot(self) -> dict:
        with self.lock:
            return json.loads(json.dumps(self.stats))

    def configure(self, doc: dict) -> None:
        with self.lock:
            for key in ("fail_rate", "delay_s"):
                if key in doc:
                    setattr(self, key, float(doc[key]))
            if "drop_next" in doc:
                self.drop_next = int(doc["drop_next"])
            if "race" in doc:
                self.race.update(doc["race"])
            if "seed" in doc:
                self.rng = random.Random(doc["seed"])
        if doc.get("reset_stats"):
            self.reset_stats()
        if doc.get("clear"):
            self.clear()

    def clear(self) -> None:
        """Forget every object or message."""

    def _count(self, key: str, n: int = 1) -> None:
        with self.lock:
            self.stats[key] += n

    # ---- the request loop ---------------------------------------------------
    def dispatch(self, h: BaseHTTPRequestHandler) -> None:
        length = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(length) if length else b""
        parts = urllib.parse.urlsplit(h.path)
        if parts.path.startswith("/_fake/"):
            if parts.path == "/_fake/config":
                self.configure(json.loads(body or b"{}"))
            self._reply(h, 200, {"Content-Type": "application/json"},
                        json.dumps(self.snapshot()).encode(), count=False)
            return
        with self.lock:
            reqs = self.stats["requests"]
            reqs[h.command] = reqs.get(h.command, 0) + 1
            self.stats["bytes_in"] += len(body)
            drop = self.drop_next > 0
            if drop:
                self.drop_next -= 1
            fail = (not drop and self.fail_rate > 0
                    and self.rng.random() < self.fail_rate)
            delay = self.delay_s
        if delay:
            time.sleep(delay)
        if drop:
            self._count("dropped")
            h.close_connection = True
            return
        if fail:
            self._count("faults_503")
            self._reply(h, 503, {"Content-Type": "text/plain"},
                        b"injected fault")
            return
        query = dict(urllib.parse.parse_qsl(parts.query,
                                            keep_blank_values=True))
        status, headers, payload = self.route(h, parts.path, query, body)
        self._reply(h, status, headers, payload)

    def _reply(self, h, status: int, headers: Dict[str, str],
               payload: bytes, count: bool = True) -> None:
        if count:
            with self.lock:
                codes = self.stats["status"]
                codes[str(status)] = codes.get(str(status), 0) + 1
                self.stats["bytes_out"] += len(payload)
        h.send_response(status)
        for key, value in headers.items():
            h.send_header(key, value)
        h.send_header("Content-Length", str(len(payload)))
        h.end_headers()
        if h.command != "HEAD" and payload:
            h.wfile.write(payload)

    def route(self, h, path: str, query: dict, body: bytes
              ) -> Tuple[int, Dict[str, str], bytes]:
        raise NotImplementedError

    def _take_race(self, key: str) -> bool:
        with self.lock:
            if key in self.race:
                self.race.discard(key)
                self.stats["forced_412"] += 1
                return True
        return False


def _byte_range(header: Optional[str], size: int):
    """``(start, stop)`` of a ``Range: bytes=...`` header, None for the
    whole object, or ``"unsatisfiable"``."""
    if not header or not header.startswith("bytes="):
        return None
    first, _, last = header[len("bytes="):].partition("-")
    if first == "":
        start, stop = max(0, size - int(last)), size
    else:
        start = int(first)
        stop = min(size, int(last) + 1) if last else size
    if start >= size or stop <= start:
        return "unsatisfiable"
    return start, stop


def _json(status: int, doc: dict, headers: Optional[dict] = None):
    return (status, dict({"Content-Type": "application/json"},
                         **(headers or {})), json.dumps(doc).encode())


# ---------------------------------------------------------------------------
# Google Cloud Storage
# ---------------------------------------------------------------------------
class FakeGCS(_Fake):
    """The GCS JSON API on ``(bucket, name)`` objects with generations;
    with ``key`` also the token endpoint and the metadata server, and
    bearer tokens required."""

    name = "gcs"
    #: the one refresh token the token endpoint takes
    refresh_token = "chunkflow-test-refresh"

    def __init__(self, key: Optional[str] = None,
                 token_lifetime: float = 3600.0, **kw):
        super().__init__(**kw)
        self.objects: Dict[Tuple[str, str], Tuple[bytes, int]] = {}
        self._generation = 1_700_000_000_000_000
        self.public_key = None
        if key is not None:
            with open(key) as f:
                private = google.load_private_key(f.read())
            self.public_key = google.RSAKey(private.n, private.e)
        self.token_lifetime = float(token_lifetime)
        self.tokens: Dict[str, float] = {}  # token -> expiry
        self.grants: Dict[str, int] = {}

    def clear(self) -> None:
        with self.lock:
            self.objects.clear()

    def _issue(self, grant: str):
        token = f"fake-token-{uuid.uuid4().hex}"
        with self.lock:
            self.tokens[token] = time.time() + self.token_lifetime
            self.grants[grant] = self.grants.get(grant, 0) + 1
        return _json(200, {"access_token": token, "token_type": "Bearer",
                           "expires_in": int(self.token_lifetime)})

    def _token_endpoint(self, body: bytes):
        form = dict(urllib.parse.parse_qsl(body.decode()))
        grant = form.get("grant_type", "")
        if grant == "urn:ietf:params:oauth:grant-type:jwt-bearer":
            claims = google.decode_jwt(form.get("assertion", ""),
                                       self.public_key)
            if claims is None or float(claims.get("exp", 0)) < time.time() \
                    or "iss" not in claims:
                self._count("auth_refused")
                return _json(400, {"error": "invalid_grant"})
            return self._issue("jwt")
        if grant == "refresh_token" \
                and form.get("refresh_token") == self.refresh_token:
            return self._issue("refresh_token")
        self._count("auth_refused")
        return _json(400, {"error": "unsupported_grant_type"})

    def _metadata(self, path: str):
        flavor = {"Metadata-Flavor": "Google"}
        accounts = "/computeMetadata/v1/instance/service-accounts/"
        email = "worker@chunkflow-test.iam.gserviceaccount.com"
        account, _, leaf = path[len(accounts):].partition("/")
        if path == "/":
            return 200, flavor, b"computeMetadata/"
        if not path.startswith(accounts) or account not in ("default",
                                                            email):
            return 404, flavor, b"not found"
        if leaf == "token":
            status, headers, payload = self._issue("metadata")
            return status, dict(headers, **flavor), payload
        if leaf == "":
            return _json(200, {"aliases": ["default"], "email": email,
                               "scopes": [google.SCOPE]}, flavor)
        return 404, flavor, b"not found"

    def _authorized(self, h) -> bool:
        if self.public_key is None:
            return True
        auth = h.headers.get("Authorization", "")
        token = auth[len("Bearer "):] if auth.startswith("Bearer ") else ""
        with self.lock:
            ok = self.tokens.get(token, 0) > time.time()
        if not ok:
            self._count("auth_refused")
        return ok

    def route(self, h, path, query, body):
        method = h.command
        if self.public_key is not None:
            if path == "/token" and method == "POST":
                return self._token_endpoint(body)
            if h.headers.get("Metadata-Flavor") == "Google":
                return self._metadata(path)
        if not self._authorized(h):
            return _json(401, {"error": {"code": 401,
                                         "message": "no valid token"}})
        if path.startswith("/upload/storage/v1/b/") and method == "POST":
            bucket = path.split("/")[5]
            return self._write(bucket, query.get("name", ""), query, body)
        prefix = "/storage/v1/b/"
        if not path.startswith(prefix):
            return _json(404, {"error": {"code": 404, "message": path}})
        bucket, _, rest = path[len(prefix):].partition("/")
        if rest == "o" and method == "GET":
            return self._list(bucket, query)
        if not rest.startswith("o/"):
            return _json(404, {"error": {"code": 404, "message": path}})
        name = urllib.parse.unquote(rest[2:])
        if method == "DELETE":
            return self._delete(bucket, name, query)
        if method == "GET":
            return self._read(h, bucket, name, query)
        return _json(405, {"error": {"code": 405, "message": method}})

    def _meta(self, bucket, name, data, generation) -> dict:
        return {"kind": "storage#object", "bucket": bucket, "name": name,
                "generation": str(generation), "size": str(len(data)),
                "md5Hash": "", "id": f"{bucket}/{name}/{generation}"}

    def _precondition(self, query, generation) -> Optional[int]:
        match = query.get("ifGenerationMatch")
        if match is not None and int(match) != generation:
            return 412
        unmatch = query.get("ifGenerationNotMatch")
        if unmatch is not None and int(unmatch) == generation:
            return 304
        return None

    def _read(self, h, bucket, name, query):
        with self.lock:
            data, generation = self.objects.get((bucket, name), (None, 0))
        failed = self._precondition(query, generation)
        if failed is not None and (data is not None or failed == 412):
            return failed, {"x-goog-generation": str(generation)}, b""
        if data is None:
            return _json(404, {"error": {"code": 404,
                                         "message": "No such object"}})
        headers = {"x-goog-generation": str(generation),
                   "x-goog-metageneration": "1"}
        span = _byte_range(h.headers.get("Range"), len(data))
        if span == "unsatisfiable":
            return 416, headers, b""
        headers["Content-Type"] = "application/octet-stream"
        if span is None:
            return 200, headers, data
        start, stop = span
        headers["Content-Range"] = f"bytes {start}-{stop - 1}/{len(data)}"
        return 206, headers, data[start:stop]

    def _write(self, bucket, name, query, body):
        key = (bucket, name)
        with self.lock:
            _, generation = self.objects.get(key, (None, 0))
            conditional = "ifGenerationMatch" in query
        if conditional and self._take_race(name):
            with self.lock:  # another writer rewrote it meanwhile
                data, _ = self.objects.get(key, (None, 0))
                if data is not None:
                    self._generation += 1
                    self.objects[key] = (data, self._generation)
            return _json(412, {"error": {"code": 412,
                                         "message": "forced race"}})
        with self.lock:
            _, generation = self.objects.get(key, (None, 0))
            if self._precondition(query, generation) == 412:
                return _json(412, {"error": {"code": 412, "message":
                                             "conditionNotMet"}})
            self._generation += 1
            self.objects[key] = (bytes(body), self._generation)
            doc = self._meta(bucket, name, body, self._generation)
        return _json(200, doc)

    def _delete(self, bucket, name, query):
        with self.lock:
            data, generation = self.objects.get((bucket, name), (None, 0))
            if data is None:
                return _json(404, {"error": {"code": 404,
                                             "message": "No such object"}})
            if self._precondition(query, generation) == 412:
                return _json(412, {"error": {"code": 412, "message":
                                             "conditionNotMet"}})
            del self.objects[(bucket, name)]
        return 204, {}, b""

    def _list(self, bucket, query):
        prefix = query.get("prefix", "")
        lo = max(prefix, query.get("startOffset", ""))
        hi = query.get("endOffset")
        token = query.get("pageToken")
        with self.lock:
            names = sorted(n for (b, n) in self.objects
                           if b == bucket and n.startswith(prefix)
                           and n >= lo and (hi is None or n < hi)
                           and (token is None or n > token))
            page = names[:self.page_size]
            items = [self._meta(bucket, n, *self.objects[(bucket, n)])
                     for n in page]
        doc = {"kind": "storage#objects"}
        if items:
            doc["items"] = items
        if len(names) > len(page):
            doc["nextPageToken"] = page[-1]
        return _json(200, doc)


# ---------------------------------------------------------------------------
# S3
# ---------------------------------------------------------------------------
def _s3_error(status: int, code: str, message: str = ""):
    body = (f'<?xml version="1.0" encoding="UTF-8"?>\n<Error><Code>{code}'
            f'</Code><Message>{escape(message)}</Message></Error>').encode()
    return status, {"Content-Type": "application/xml"}, body


class _SigV4Fake(_Fake):
    """Checks SigV4 on every request when ``secrets`` are given."""

    def __init__(self, secrets: Optional[Dict[str, str]] = None, **kw):
        super().__init__(**kw)
        self.secrets = dict(secrets) if secrets else None

    def _refused(self, h, body) -> Optional[str]:
        if self.secrets is None:
            return None
        why = aws.verify(h.command, h.path, dict(h.headers.items()), body,
                         self.secrets)
        if why is not None:
            self._count("auth_refused")
        return why


class FakeS3(_SigV4Fake):
    """Path-style S3: ``/{bucket}/{key}``."""

    name = "s3"

    def __init__(self, **kw):
        super().__init__(**kw)
        self.objects: Dict[Tuple[str, str], Tuple[bytes, str]] = {}

    def clear(self) -> None:
        with self.lock:
            self.objects.clear()

    def route(self, h, path, query, body):
        why = self._refused(h, body)
        if why is not None:
            return _s3_error(403, "SignatureDoesNotMatch"
                             if "Signature" in why else "AccessDenied", why)
        bucket, _, key = path.lstrip("/").partition("/")
        key = urllib.parse.unquote(key)
        method = h.command
        if not key:
            if method == "GET" and query.get("list-type") == "2":
                return self._list(bucket, query)
            return _s3_error(400, "InvalidRequest", "bucket operation")
        if method in ("GET", "HEAD"):
            return self._read(h, bucket, key)
        if method == "PUT":
            return self._write(h, bucket, key, body)
        if method == "DELETE":
            return self._delete(h, bucket, key)
        return _s3_error(405, "MethodNotAllowed", method)

    def _read(self, h, bucket, key):
        with self.lock:
            data, etag = self.objects.get((bucket, key), (None, ""))
        if data is None:
            return _s3_error(404, "NoSuchKey", key)
        match = h.headers.get("If-Match")
        if match is not None and match != etag:
            return _s3_error(412, "PreconditionFailed", key)
        if h.headers.get("If-None-Match") == etag:
            return 304, {"ETag": etag}, b""
        headers = {"ETag": etag, "Content-Type": "application/octet-stream",
                   "Accept-Ranges": "bytes"}
        span = _byte_range(h.headers.get("Range"), len(data))
        if span == "unsatisfiable":
            return _s3_error(416, "InvalidRange", key)
        if span is None:
            return 200, headers, data
        start, stop = span
        headers["Content-Range"] = f"bytes {start}-{stop - 1}/{len(data)}"
        return 206, headers, data[start:stop]

    def _write(self, h, bucket, key, body):
        conditional = (h.headers.get("If-Match") is not None
                       or h.headers.get("If-None-Match") is not None)
        if conditional and self._take_race(key):
            return _s3_error(412, "PreconditionFailed", "forced race")
        with self.lock:
            data, etag = self.objects.get((bucket, key), (None, ""))
            if h.headers.get("If-None-Match") == "*" and data is not None:
                return _s3_error(412, "PreconditionFailed", key)
            match = h.headers.get("If-Match")
            if match is not None and data is None:
                return _s3_error(404, "NoSuchKey", key)
            if match is not None and match != etag:
                return _s3_error(412, "PreconditionFailed", key)
            etag = f'"{hashlib.md5(body).hexdigest()}"'
            self.objects[(bucket, key)] = (bytes(body), etag)
        return 200, {"ETag": etag}, b""

    def _delete(self, h, bucket, key):
        with self.lock:
            data, etag = self.objects.get((bucket, key), (None, ""))
            match = h.headers.get("If-Match")
            if match is not None and data is None:
                return _s3_error(404, "NoSuchKey", key)
            if match is not None and match != etag:
                return _s3_error(412, "PreconditionFailed", key)
            self.objects.pop((bucket, key), None)
        return 204, {}, b""

    def _list(self, bucket, query):
        prefix = query.get("prefix", "")
        after = query.get("start-after", "")
        token = query.get("continuation-token")
        with self.lock:
            keys = sorted(k for (b, k) in self.objects
                          if b == bucket and k.startswith(prefix)
                          and k > after and (token is None or k > token))
            page = keys[:self.page_size]
            sizes = [len(self.objects[(bucket, k)][0]) for k in page]
        truncated = len(keys) > len(page)
        parts = ['<?xml version="1.0" encoding="UTF-8"?>\n<ListBucketResult '
                 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">',
                 f"<Name>{escape(bucket)}</Name>",
                 f"<Prefix>{escape(prefix)}</Prefix>",
                 f"<KeyCount>{len(page)}</KeyCount>",
                 f"<MaxKeys>{self.page_size}</MaxKeys>",
                 f"<IsTruncated>{'true' if truncated else 'false'}"
                 f"</IsTruncated>"]
        for key, size in zip(page, sizes):
            parts.append(f"<Contents><Key>{escape(key)}</Key><Size>{size}"
                         f"</Size></Contents>")
        if truncated:
            parts.append(f"<NextContinuationToken>{escape(page[-1])}"
                         f"</NextContinuationToken>")
        parts.append("</ListBucketResult>")
        return 200, {"Content-Type": "application/xml"}, \
            "".join(parts).encode()


# ---------------------------------------------------------------------------
# SQS
# ---------------------------------------------------------------------------
class _Message:
    __slots__ = ("id", "body", "md5", "visible_at", "receives", "handle")

    def __init__(self, body: str):
        self.id = str(uuid.uuid4())
        self.body = body
        self.md5 = hashlib.md5(body.encode()).hexdigest()
        self.visible_at = 0.0
        self.receives = 0
        self.handle: Optional[str] = None


def _sqs_error(code: str, message: str, status: int = 400):
    return _json(status, {"__type": f"com.amazonaws.sqs#{code}",
                          "message": message})


class FakeSQS(_SigV4Fake):
    """SQS over the AWS JSON 1.0 protocol. ``fail_ids`` / ``fail_batches``
    report those batch entry ids as ``Failed`` in that many batches;
    ``max_wait_s`` caps a long poll below SQS's own 20 s."""

    name = "sqs"

    def __init__(self, fail_ids=(), fail_batches: int = 0, **kw):
        super().__init__(**kw)
        self.queues: Dict[str, dict] = {}
        self.fail_ids = set(fail_ids)
        self.fail_batches = int(fail_batches)
        self.max_wait_s = 20.0

    def clear(self) -> None:
        with self.lock:
            self.queues.clear()
            self.lock.notify_all()

    def configure(self, doc: dict) -> None:
        super().configure(doc)
        with self.lock:
            if "fail_ids" in doc:
                self.fail_ids = set(doc["fail_ids"])
            if "fail_batches" in doc:
                self.fail_batches = int(doc["fail_batches"])
            if "max_wait_s" in doc:
                self.max_wait_s = min(20.0, float(doc["max_wait_s"]))

    def route(self, h, path, query, body):
        why = self._refused(h, body)
        if why is not None:
            return _sqs_error("SignatureDoesNotMatch" if "Signature" in why
                              else "AccessDenied", why, 403)
        target = h.headers.get("X-Amz-Target", "")
        if h.command != "POST" or not target.startswith("AmazonSQS."):
            return _sqs_error("InvalidAction", target or h.command)
        try:
            params = json.loads(body or b"{}")
        except ValueError:
            return _sqs_error("SerializationException", "bad JSON")
        action = target[len("AmazonSQS."):]
        handler = getattr(self, f"_do_{action}", None)
        if handler is None:
            return _sqs_error("InvalidAction", action)
        if action != "CreateQueue":
            queue = self.queues.get(str(params.get("QueueUrl", ""))
                                    .rsplit("/", 1)[-1])
            if queue is None:
                return _sqs_error("QueueDoesNotExist",
                                  "The specified queue does not exist.")
            params["_queue"] = queue
        return handler(h, params)

    # ---- actions ------------------------------------------------------------
    def _do_CreateQueue(self, h, params):
        name = params["QueueName"]
        host = h.headers.get("Host") or "127.0.0.1"
        with self.lock:
            if name not in self.queues:
                attrs = {"VisibilityTimeout": "30"}
                attrs.update(params.get("Attributes") or {})
                self.queues[name] = {
                    "url": f"http://{host}/{ACCOUNT}/{name}",
                    "attrs": attrs, "messages": {}}
            url = self.queues[name]["url"]
        return _json(200, {"QueueUrl": url})

    def _send(self, queue, body: str) -> _Message:
        msg = _Message(body)
        queue["messages"][msg.id] = msg
        self.lock.notify_all()
        return msg

    def _do_SendMessage(self, h, params):
        with self.lock:
            msg = self._send(params["_queue"], params["MessageBody"])
        return _json(200, {"MessageId": msg.id,
                           "MD5OfMessageBody": msg.md5})

    def _do_SendMessageBatch(self, h, params):
        entries = params.get("Entries") or []
        if not entries or len(entries) > 10:
            return _sqs_error("TooManyEntriesInBatchRequest"
                              if entries else "EmptyBatchRequest",
                              f"{len(entries)} entries")
        ok, failed = [], []
        with self.lock:
            failing = self.fail_batches > 0 and any(
                e["Id"] in self.fail_ids for e in entries)
            for entry in entries:
                if failing and entry["Id"] in self.fail_ids:
                    failed.append({"Id": entry["Id"], "SenderFault": False,
                                   "Code": "Throttled",
                                   "Message": "try later"})
                    continue
                msg = self._send(params["_queue"], entry["MessageBody"])
                ok.append({"Id": entry["Id"], "MessageId": msg.id,
                           "MD5OfMessageBody": msg.md5})
            if failing:
                self.fail_batches -= 1
        doc = {"Successful": ok}
        if failed:
            doc["Failed"] = failed
        return _json(200, doc)

    def _do_ReceiveMessage(self, h, params):
        queue = params["_queue"]
        most = max(1, min(10, int(params.get("MaxNumberOfMessages", 1))))
        wait = max(0.0, min(self.max_wait_s,
                            float(params.get("WaitTimeSeconds", 0))))
        names = set(params.get("AttributeNames") or ()) | set(
            params.get("MessageSystemAttributeNames") or ())
        deadline = time.time() + wait
        with self.lock:
            while True:
                now = time.time()
                visible = [m for m in queue["messages"].values()
                           if m.visible_at <= now][:most]
                if visible or now >= deadline:
                    break
                later = [m.visible_at for m in queue["messages"].values()]
                until = min([deadline] + [t for t in later if t > now])
                self.lock.wait(max(0.001, until - now))
            timeout = float(params.get("VisibilityTimeout",
                                       queue["attrs"]["VisibilityTimeout"]))
            out = []
            for msg in visible:
                msg.receives += 1
                msg.visible_at = now + timeout
                msg.handle = f"{msg.id}#{msg.receives}#{uuid.uuid4().hex}"
                item = {"MessageId": msg.id, "ReceiptHandle": msg.handle,
                        "MD5OfBody": msg.md5, "Body": msg.body}
                if names & {"All", "ApproximateReceiveCount"}:
                    item["Attributes"] = {
                        "ApproximateReceiveCount": str(msg.receives)}
                out.append(item)
        return _json(200, {"Messages": out} if out else {})

    def _find(self, queue, handle):
        msg = queue["messages"].get(str(handle).split("#", 1)[0])
        return msg if msg is not None and msg.handle == handle else None

    def _do_DeleteMessage(self, h, params):
        with self.lock:
            msg = self._find(params["_queue"], params.get("ReceiptHandle"))
            if msg is not None:  # a stale handle deletes nothing, as SQS
                del params["_queue"]["messages"][msg.id]
        return _json(200, {})

    def _do_ChangeMessageVisibility(self, h, params):
        with self.lock:
            msg = self._find(params["_queue"], params.get("ReceiptHandle"))
            now = time.time()
            if msg is None or msg.visible_at <= now:
                return _sqs_error("MessageNotInflight",
                                  "The message is not in flight.")
            msg.visible_at = now + float(params["VisibilityTimeout"])
            self.lock.notify_all()
        return _json(200, {})

    def _do_GetQueueAttributes(self, h, params):
        queue = params["_queue"]
        now = time.time()
        with self.lock:
            msgs = list(queue["messages"].values())
            attrs = dict(queue["attrs"])
        attrs["ApproximateNumberOfMessages"] = str(
            sum(m.visible_at <= now for m in msgs))
        attrs["ApproximateNumberOfMessagesNotVisible"] = str(
            sum(m.visible_at > now for m in msgs))
        wanted = set(params.get("AttributeNames") or ())
        if "All" not in wanted:
            attrs = {k: v for k, v in attrs.items() if k in wanted}
        return _json(200, {"Attributes": attrs})


# ---------------------------------------------------------------------------
# CloudWatch
# ---------------------------------------------------------------------------
def _query_error(status: int, code: str, message: str):
    body = (f'<ErrorResponse xmlns="http://monitoring.amazonaws.com/doc/'
            f'2010-08-01/"><Error><Type>Sender</Type><Code>{code}</Code>'
            f'<Message>{escape(message)}</Message></Error></ErrorResponse>'
            ).encode()
    return status, {"Content-Type": "text/xml"}, body


class FakeCloudWatch(_SigV4Fake):
    """``PutMetricData`` over the AWS Query protocol: each call's
    ``(Namespace, MetricData)`` in boto3's shape, in ``calls``."""

    name = "cloudwatch"
    #: data per call, the cap the ``aws/cloud_watch`` plugin batches to
    max_data = 20

    def __init__(self, **kw):
        super().__init__(**kw)
        self.calls: list = []

    def clear(self) -> None:
        with self.lock:
            self.calls = []

    def snapshot(self) -> dict:
        doc = super().snapshot()
        with self.lock:
            doc["calls"] = json.loads(json.dumps(self.calls))
        return doc

    def route(self, h, path, query, body):
        why = self._refused(h, body)
        if why is not None:
            return _query_error(403, "SignatureDoesNotMatch"
                                if "Signature" in why else "AccessDenied",
                                why)
        if h.command != "POST" or path != "/":
            return _query_error(400, "InvalidAction", h.command + " " + path)
        form = urllib.parse.parse_qs(body.decode(), keep_blank_values=True)
        fields = {k: v[-1] for k, v in form.items()}
        if fields.get("Action") != "PutMetricData":
            return _query_error(400, "InvalidAction",
                                str(fields.get("Action")))
        if fields.get("Version") != "2010-08-01":
            return _query_error(400, "InvalidParameterValue",
                                f"Version {fields.get('Version')!r}")
        namespace = fields.get("Namespace")
        if not namespace:
            return _query_error(400, "MissingParameter", "Namespace")
        data = []
        while f"MetricData.member.{len(data) + 1}.MetricName" in fields:
            prefix = f"MetricData.member.{len(data) + 1}"
            datum = {"MetricName": fields[f"{prefix}.MetricName"]}
            if f"{prefix}.Value" in fields:
                datum["Value"] = float(fields[f"{prefix}.Value"])
            if f"{prefix}.Unit" in fields:
                datum["Unit"] = fields[f"{prefix}.Unit"]
            dims = []
            while f"{prefix}.Dimensions.member.{len(dims) + 1}.Name" \
                    in fields:
                dim = f"{prefix}.Dimensions.member.{len(dims) + 1}"
                dims.append({"Name": fields[f"{dim}.Name"],
                             "Value": fields.get(f"{dim}.Value", "")})
            if dims:
                datum["Dimensions"] = dims
            data.append(datum)
        if not data or len(data) > self.max_data:
            return _query_error(400, "InvalidParameterValue",
                                f"{len(data)} MetricData members; 1 to "
                                f"{self.max_data} a call")
        with self.lock:
            self.calls.append([namespace, data])
        body = (b'<PutMetricDataResponse xmlns="http://monitoring.amazonaws'
                b'.com/doc/2010-08-01/"><ResponseMetadata><RequestId>'
                + str(uuid.uuid4()).encode()
                + b'</RequestId></ResponseMetadata></PutMetricDataResponse>')
        return 200, {"Content-Type": "text/xml"}, body


# ---------------------------------------------------------------------------
# the environment, and the fakes in a process of their own
# ---------------------------------------------------------------------------
def cloud_env(gcs: Optional[str] = None, s3: Optional[str] = None,
              sqs: Optional[str] = None,
              credentials: Optional[str] = None,
              metadata: Optional[str] = None,
              cloudwatch: Optional[str] = None) -> Dict[str, str]:
    """The environment that points the port (and the JAX package's
    tensorstore, for ``gs://``) at fakes at these URLs: the endpoints, the
    test access key, a region, no instance metadata service, and the GCE
    metadata host at ``metadata`` (a fake's host:port, else an address on
    this machine where nothing listens). ``credentials``: a Google
    credentials file (``GOOGLE_APPLICATION_CREDENTIALS``)."""
    env = {"AWS_ACCESS_KEY_ID": ACCESS_KEY,
           "AWS_SECRET_ACCESS_KEY": SECRET_KEY,
           "AWS_REGION": "us-east-1",
           "AWS_EC2_METADATA_DISABLED": "true",
           "GCE_METADATA_HOST": metadata or "127.0.0.1:9",
           "GCE_METADATA_ROOT": metadata or "127.0.0.1:9"}
    if gcs:
        env["TENSORSTORE_GCS_HTTP_URL"] = gcs
    if s3:
        env["AWS_ENDPOINT_URL_S3"] = s3
    if sqs:
        env["AWS_ENDPOINT_URL_SQS"] = sqs
    if cloudwatch:
        env["AWS_ENDPOINT_URL_CLOUDWATCH"] = cloudwatch
    if credentials:
        env["GOOGLE_APPLICATION_CREDENTIALS"] = credentials
    return env


def service_account_file(path: str, key: str, token_uri: str) -> str:
    """Write a ``service_account`` credentials file with the PEM key at
    ``key`` and its ``token_uri`` (a fake's ``/token``); returns ``path``."""
    with open(key) as f:
        pem = f.read()
    doc = {"type": "service_account", "project_id": "chunkflow-test",
           "private_key_id": "test-key", "private_key": pem,
           "client_email": "worker@chunkflow-test.iam.gserviceaccount.com",
           "client_id": "1", "token_uri": token_uri}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def control(url: str, **config) -> dict:
    """Set knobs of a running fake (``/_fake/config``) and return its
    counters (``/_fake/stats`` when no knob is given)."""
    import urllib.request

    if config:
        req = urllib.request.Request(f"{url}/_fake/config", method="POST",
                                     data=json.dumps(config).encode())
    else:
        req = urllib.request.Request(f"{url}/_fake/stats")
    with urllib.request.urlopen(req, timeout=30) as answer:
        return json.loads(answer.read())


def spawn(port_file: str, sigv4: bool = False, key: Optional[str] = None,
          fail_rate: float = 0.0, seed: int = 0, env=None):
    """Start the fakes in a process of their own; returns ``(proc,
    {"gcs": url, "s3": url, "sqs": url, "cloudwatch": url})``. Stop it
    with ``terminate``."""
    args = [sys.executable, "-m", "chunkflow_tpu_torch.testing.cloud_fakes",
            "--port-file", port_file, "--fail-rate", str(fail_rate),
            "--seed", str(seed)]
    if sigv4:
        args.append("--sigv4")
    if key:
        args += ["--key", key]
    if os.path.exists(port_file):
        os.remove(port_file)
    proc = subprocess.Popen(args, env=env)
    t0 = time.time()
    while not os.path.exists(port_file):
        if proc.poll() is not None or time.time() - t0 > 60:
            proc.kill()
            raise RuntimeError(f"the cloud fakes did not start (rc "
                               f"{proc.poll()})")
        time.sleep(0.05)
    with open(port_file) as f:
        return proc, json.load(f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m chunkflow_tpu_torch.testing.cloud_fakes",
        description="Serve FakeGCS, FakeS3, FakeSQS and FakeCloudWatch "
                    "until SIGTERM.")
    parser.add_argument("--port-file", required=True,
                        help="where to write the fakes' URLs as JSON")
    parser.add_argument("--sigv4", action="store_true",
                        help="check SigV4 with the test access key")
    parser.add_argument("--key", default=None,
                        help="a PEM RSA key: issue and require tokens")
    parser.add_argument("--fail-rate", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    secrets = {ACCESS_KEY: SECRET_KEY} if args.sigv4 else None
    common = dict(fail_rate=args.fail_rate)
    fakes = {"gcs": FakeGCS(key=args.key, seed=args.seed, **common),
             "s3": FakeS3(secrets=secrets, seed=args.seed + 1, **common),
             "sqs": FakeSQS(secrets=secrets, seed=args.seed + 2, **common),
             "cloudwatch": FakeCloudWatch(secrets=secrets,
                                          seed=args.seed + 3, **common)}
    for fake in fakes.values():
        fake.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    tmp = f"{args.port_file}.tmp"
    with open(tmp, "w") as f:
        json.dump({k: fake.url for k, fake in fakes.items()}, f)
    os.replace(tmp, args.port_file)
    while not stop.wait(0.5):
        pass
    for fake in fakes.values():
        fake.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
