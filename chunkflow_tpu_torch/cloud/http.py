"""A small HTTP(S) client on ``http.client`` and ``ssl``.

The port's cloud clients (``cloud/gcs.py``, ``cloud/s3.py``,
``cloud/sqs.py``) speak HTTP through one :class:`HTTPClient`:

* one keep-alive connection per thread and host;
* a connect timeout and a read timeout;
* bounded retries with jittered exponential backoff on connection errors
  and on 408, 429 and 5xx answers, the statuses tensorstore retries;
* every other 4xx raises :class:`HTTPError` at once with the status and
  the first bytes of the body, but 404 and 412, which are returned for the
  caller to decide (an absent object, a lost race);
* counters ``<prefix>/requests/<VERB>``, ``<prefix>/bytes_sent``,
  ``<prefix>/bytes_received``, ``<prefix>/retries`` and ``<prefix>/412``
  (``storage/http`` for the object stores, ``queue/http`` for SQS).

A request is prepared anew before each attempt (``prepare``), so a
signature or a bearer token is fresh on every retry.
"""
from __future__ import annotations

import http.client
import random
import socket
import ssl
import threading
import time
import urllib.parse
from typing import Callable, Dict, NamedTuple, Optional

from chunkflow_tpu_torch.core import telemetry

__all__ = ["HTTPError", "Response", "HTTPClient", "RETRY_STATUSES"]

#: answers retried with backoff (tensorstore's set)
RETRY_STATUSES = frozenset({408, 429, 500, 502, 503, 504})
#: answers handed back to the caller
PASS_STATUSES = frozenset({404, 412})
CONNECT_TIMEOUT_S = 10.0
# above SQS's 20 s long poll
READ_TIMEOUT_S = 120.0
# the first retry's backoff ceiling and the largest, seconds
BACKOFF_S, BACKOFF_CAP_S = 0.1, 10.0
_CONNECTION_ERRORS = (OSError, http.client.HTTPException)


class HTTPError(IOError):
    """An answer the caller cannot use: its status and the body's first
    bytes."""

    def __init__(self, status: int, method: str, url: str, body: bytes):
        self.status = int(status)
        self.body = bytes(body)
        super().__init__(f"HTTP {status} for {method} {url}: "
                         f"{self.body[:300]!r}")


class Response(NamedTuple):
    status: int
    headers: Dict[str, str]  # lower-case names
    body: bytes


class _Connection(http.client.HTTPConnection):
    """Connects under the connect timeout, then reads under the read
    timeout, with Nagle's algorithm off (a request's head and body leave
    in two writes)."""

    def __init__(self, host, port, connect_timeout, read_timeout):
        super().__init__(host, port, timeout=connect_timeout)
        self.read_timeout = read_timeout

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(self.read_timeout)


class _TLSConnection(http.client.HTTPSConnection):
    def __init__(self, host, port, connect_timeout, read_timeout):
        super().__init__(host, port, timeout=connect_timeout,
                         context=ssl.create_default_context())
        self.read_timeout = read_timeout

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(self.read_timeout)


class HTTPClient:
    """Requests with retries over per-thread keep-alive connections."""

    def __init__(self, counter_prefix: str = "storage/http",
                 max_retries: int = 8):
        self.prefix = counter_prefix
        self.max_retries = int(max_retries)
        self._local = threading.local()
        self._rng = random.Random()
        self._rng_lock = threading.Lock()

    # ---- connections ------------------------------------------------------
    def _connection(self, scheme: str, netloc: str):
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        key = (scheme, netloc)
        conn = conns.get(key)
        if conn is None:
            parsed = urllib.parse.urlsplit(f"{scheme}://{netloc}")
            cls = _TLSConnection if scheme == "https" else _Connection
            conn = conns[key] = cls(parsed.hostname, parsed.port,
                                    CONNECT_TIMEOUT_S, READ_TIMEOUT_S)
        return conn

    def _drop(self, scheme: str, netloc: str) -> None:
        conn = getattr(self._local, "conns", {}).pop((scheme, netloc), None)
        if conn is not None:
            conn.close()

    def close(self) -> None:
        """Close this thread's connections."""
        for conn in getattr(self._local, "conns", {}).values():
            conn.close()
        self._local.conns = {}

    def _sleep(self, attempt: int) -> None:
        with self._rng_lock:
            jitter = self._rng.uniform(0.5, 1.0)
        time.sleep(min(BACKOFF_CAP_S, BACKOFF_S * 2 ** attempt) * jitter)

    # ---- requests ---------------------------------------------------------
    def request(self, method: str, url: str, body: bytes = b"",
                headers: Optional[Dict[str, str]] = None,
                prepare: Optional[Callable[[str, str, Dict[str, str], bytes],
                                           Dict[str, str]]] = None,
                connect_timeout: Optional[float] = None,
                max_retries: Optional[int] = None) -> Response:
        """Send one request; 2xx, 3xx, 404 and 412 come back, the rest
        raise (after the retries, for the retried statuses and connection
        errors). ``prepare(method, url, headers, body)`` returns the headers
        of each attempt (signing)."""
        parts = urllib.parse.urlsplit(url)
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        body = bytes(body)
        retries = self.max_retries if max_retries is None else max_retries
        attempt = 0
        while True:
            sent = dict(headers or {})
            sent.setdefault("Host", parts.netloc)
            if prepare is not None:
                sent = prepare(method, url, sent, body)
            telemetry.inc(f"{self.prefix}/requests/{method}")
            try:
                conn = self._connection(parts.scheme, parts.netloc)
                if connect_timeout is not None and conn.sock is None:
                    conn.timeout = connect_timeout
                conn.request(method, target, body=body or None,
                             headers=sent)
                telemetry.inc(f"{self.prefix}/bytes_sent", len(body))
                answer = conn.getresponse()
                data = answer.read()
                reply = Response(answer.status,
                                 {k.lower(): v for k, v in
                                  answer.getheaders()}, data)
                if answer.will_close:
                    self._drop(parts.scheme, parts.netloc)
            except _CONNECTION_ERRORS:
                self._drop(parts.scheme, parts.netloc)
                if attempt >= retries:
                    raise
                telemetry.inc(f"{self.prefix}/retries")
                self._sleep(attempt)
                attempt += 1
                continue
            telemetry.inc(f"{self.prefix}/bytes_received", len(data))
            status = reply.status
            if status < 400 or status in PASS_STATUSES:
                if status == 412:
                    telemetry.inc(f"{self.prefix}/412")
                return reply
            if status in RETRY_STATUSES and attempt < retries:
                telemetry.inc(f"{self.prefix}/retries")
                self._sleep(attempt)
                attempt += 1
                continue
            raise HTTPError(status, method, url, data)
