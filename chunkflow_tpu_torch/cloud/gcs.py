"""``gs://bucket/path``: a KV plane on the Google Cloud Storage JSON API.

* read: ``GET /storage/v1/b/{bucket}/o/{object}?alt=media`` (with
  ``Range`` for a part, ``ifGenerationMatch`` to pin a version);
* write: ``POST /upload/storage/v1/b/{bucket}/o?uploadType=media&name=...``
  (``ifGenerationMatch=G``; ``0``: must not exist);
* list: ``prefix``, ``startOffset``, ``endOffset``, ``pageToken``;
* delete: ``DELETE ...?ifGenerationMatch=G``.

The endpoint is ``https://storage.googleapis.com``, or
``TENSORSTORE_GCS_HTTP_URL`` when set: the variable the JAX package's
tensorstore driver honours, so one setting points both packages at the
same place. Credentials: ``cloud/google.py``.
"""
from __future__ import annotations

import json
import os
import threading
import urllib.parse
from typing import Dict, Optional

from chunkflow_tpu_torch.cloud.bucket import BucketKV
from chunkflow_tpu_torch.cloud.google import GoogleCredentials
from chunkflow_tpu_torch.volume.storage import PreconditionFailed

__all__ = ["GCSKV", "shared_credentials"]

DEFAULT_ENDPOINT = "https://storage.googleapis.com"

_LOCK = threading.Lock()
_CREDENTIALS: Dict[tuple, GoogleCredentials] = {}
_CREDENTIAL_ENV = ("GOOGLE_APPLICATION_CREDENTIALS", "CLOUDSDK_CONFIG",
                   "GCE_METADATA_HOST", "HOME")


def shared_credentials() -> GoogleCredentials:
    """One token cache per process and credential setting."""
    key = tuple(os.environ.get(name) for name in _CREDENTIAL_ENV)
    with _LOCK:
        if key not in _CREDENTIALS:
            _CREDENTIALS[key] = GoogleCredentials()
        return _CREDENTIALS[key]


class GCSKV(BucketKV):
    """The objects under ``gs://bucket/path/``."""

    scheme = "gs"

    def __init__(self, bucket: str, path: str = "",
                 credentials: Optional[GoogleCredentials] = None,
                 endpoint: Optional[str] = None):
        super().__init__(bucket, path)
        self.endpoint = (endpoint or os.environ.get(
            "TENSORSTORE_GCS_HTTP_URL") or DEFAULT_ENDPOINT).rstrip("/")
        self.credentials = credentials or shared_credentials()

    def _headers(self, method, url, headers, body):
        auth = self.credentials.authorization()
        if auth is not None:
            headers["Authorization"] = auth
        return headers

    def _object_url(self, name: str, **query) -> str:
        quoted = urllib.parse.quote(self.prefix + name, safe="")
        url = f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{quoted}"
        query = {k: v for k, v in query.items() if v is not None}
        return url + ("?" + urllib.parse.urlencode(query) if query else "")

    def _get(self, name, headers=None, if_generation=None):
        got = self.http.request(
            "GET", self._object_url(name, alt="media",
                                    ifGenerationMatch=if_generation),
            headers=headers, prepare=self._headers)
        if got.status == 412 or (got.status == 404
                                 and if_generation not in (None, 0)):
            raise PreconditionFailed(f"{self.url}{name} changed")
        if got.status == 404:
            return None, 0
        return got.body, int(got.headers.get("x-goog-generation", 0))

    def write_bytes(self, name: str, data, if_generation=None) -> None:
        query = {"uploadType": "media", "name": self.prefix + name}
        if if_generation is not None:
            query["ifGenerationMatch"] = if_generation
        got = self.http.request(
            "POST", f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o?"
                    + urllib.parse.urlencode(query),
            body=bytes(data),
            headers={"Content-Type": "application/octet-stream"},
            prepare=self._headers)
        if got.status == 412:
            raise PreconditionFailed(f"{self.url}{name} changed")
        if got.status == 404:
            raise IOError(f"bucket {self.bucket} not found writing {name}")

    def delete(self, name: str, if_generation=None) -> None:
        got = self.http.request(
            "DELETE", self._object_url(name, ifGenerationMatch=if_generation),
            prepare=self._headers)
        if got.status == 412 or (got.status == 404
                                 and if_generation not in (None, 0)):
            raise PreconditionFailed(f"{self.url}{name} changed")

    def list(self, start: str = "", stop: Optional[str] = None,
             prefix: str = ""):
        query = {"prefix": self.prefix + prefix,
                 "fields": "items(name),nextPageToken"}
        if start:
            query["startOffset"] = self.prefix + start
        if stop is not None:
            query["endOffset"] = self.prefix + stop
        token = None
        while True:
            page = dict(query, **({"pageToken": token} if token else {}))
            got = self.http.request(
                "GET", f"{self.endpoint}/storage/v1/b/{self.bucket}/o?"
                       + urllib.parse.urlencode(page),
                prepare=self._headers)
            if got.status == 404:
                raise IOError(f"bucket {self.bucket} not found")
            doc = json.loads(got.body or b"{}")
            for item in doc.get("items", ()):
                yield item["name"][len(self.prefix):]
            token = doc.get("nextPageToken")
            if not token:
                return
