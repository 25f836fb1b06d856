"""``s3://bucket/path``: a KV plane on the S3 REST API, signed with SigV4
(``cloud/aws.py``).

* read: ``GET`` (with ``Range`` for a part, ``If-Match`` to pin a
  version); the ETag is the generation;
* write: ``PUT`` with ``If-None-Match: *`` (create) or ``If-Match: <etag>``
  (replace);
* list: ``ListObjectsV2`` (``list-type=2``, ``prefix``, ``start-after``,
  ``continuation-token``);
* delete: ``DELETE`` (``If-Match``).

Requests go virtual-hosted to ``https://{bucket}.s3.{region}.amazonaws.com``,
as the JAX package's tensorstore driver resolves them, or path-style to
``AWS_ENDPOINT_URL_S3`` / ``AWS_ENDPOINT_URL`` when one is set.
"""
from __future__ import annotations

import os
import threading
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, Optional

from chunkflow_tpu_torch.cloud import aws
from chunkflow_tpu_torch.cloud.bucket import BucketKV
from chunkflow_tpu_torch.volume.storage import PreconditionFailed

__all__ = ["S3KV", "shared_chain", "signer"]

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
_LOCK = threading.Lock()
_CHAINS: Dict[tuple, aws.CredentialChain] = {}
_CHAIN_ENV = ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
              "AWS_SESSION_TOKEN", "AWS_PROFILE",
              "AWS_SHARED_CREDENTIALS_FILE", "AWS_EC2_METADATA_DISABLED",
              "AWS_EC2_METADATA_SERVICE_ENDPOINT", "HOME")


def shared_chain() -> aws.CredentialChain:
    """One credential chain per process and AWS setting."""
    key = tuple(os.environ.get(name) for name in _CHAIN_ENV)
    with _LOCK:
        if key not in _CHAINS:
            _CHAINS[key] = aws.CredentialChain()
        return _CHAINS[key]


def signer(chain: aws.CredentialChain, region: str, service: str):
    """A ``prepare`` hook of ``HTTPClient.request`` that signs each
    attempt (unsigned without credentials)."""
    def prepare(method, url, headers, body):
        creds = chain.get()
        if creds is None:
            return headers
        return aws.sign(method, url, headers, body, creds, region, service)
    return prepare


class S3KV(BucketKV):
    """The objects under ``s3://bucket/path/``."""

    scheme = "s3"

    def __init__(self, bucket: str, path: str = "",
                 chain: Optional[aws.CredentialChain] = None,
                 endpoint: Optional[str] = None):
        super().__init__(bucket, path)
        region = aws.region()
        endpoint = endpoint or aws.endpoint("s3")
        self.base = (f"{endpoint}/{bucket}" if endpoint else
                     f"https://{bucket}.s3.{region}.amazonaws.com")
        self._sign = signer(chain or shared_chain(), region, "s3")

    def _request(self, method, name, headers=None, body=b""):
        url = f"{self.base}/" + urllib.parse.quote(self.prefix + name,
                                                   safe="/-_.~")
        return self.http.request(method, url, body=body, headers=headers,
                                 prepare=self._sign)

    def _get(self, name, headers=None, if_generation=None):
        headers = dict(headers or {})
        if if_generation not in (None, 0):
            headers["If-Match"] = if_generation
        got = self._request("GET", name, headers)
        if got.status == 412 or (got.status == 404
                                 and if_generation not in (None, 0)):
            raise PreconditionFailed(f"{self.url}{name} changed")
        if got.status == 404:
            return None, 0
        return got.body, got.headers.get("etag", "")

    def write_bytes(self, name: str, data, if_generation=None) -> None:
        headers = {"Content-Type": "application/octet-stream"}
        if if_generation == 0:
            headers["If-None-Match"] = "*"
        elif if_generation is not None:
            headers["If-Match"] = if_generation
        got = self._request("PUT", name, headers, bytes(data))
        if got.status == 412 or (got.status == 404
                                 and if_generation is not None):
            raise PreconditionFailed(f"{self.url}{name} changed")
        if got.status == 404:
            raise IOError(f"bucket {self.bucket} not found writing {name}")

    def delete(self, name: str, if_generation=None) -> None:
        headers = {}
        if if_generation not in (None, 0):
            headers["If-Match"] = if_generation
        got = self._request("DELETE", name, headers)
        if got.status == 412 or (got.status == 404
                                 and if_generation not in (None, 0)):
            raise PreconditionFailed(f"{self.url}{name} changed")

    def list(self, start: str = "", stop: Optional[str] = None,
             prefix: str = ""):
        """``start-after`` is exclusive: the listing starts after ``start``
        less its last character."""
        query = {"list-type": "2", "prefix": self.prefix + prefix}
        if start:
            query["start-after"] = self.prefix + start[:-1]
        token = None
        while True:
            page = dict(query, **({"continuation-token": token}
                                  if token else {}))
            got = self.http.request(
                "GET", f"{self.base}/?" + urllib.parse.urlencode(page),
                prepare=self._sign)
            if got.status == 404:
                raise IOError(f"bucket {self.bucket} not found")
            root = ET.fromstring(got.body)
            for item in root.iter(f"{_NS}Contents"):
                name = item.find(f"{_NS}Key").text[len(self.prefix):]
                if stop is not None and name >= stop:
                    return
                if name >= start:
                    yield name
            truncated = root.find(f"{_NS}IsTruncated")
            token_el = root.find(f"{_NS}NextContinuationToken")
            if truncated is None or truncated.text != "true" \
                    or token_el is None:
                return
            token = token_el.text
