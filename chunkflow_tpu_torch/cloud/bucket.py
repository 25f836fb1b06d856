"""What the ``gs://`` and ``s3://`` KV planes share: the root's prefix
(a trailing slash, as the JAX ``TensorStoreKV`` makes it), reads in
terms of one ranged or whole GET, existence by one listing over the tight
key range (as ``TensorStoreKV.exists_many``), and the process's storage
HTTP client, whose keep-alive connections every volume shares."""
from __future__ import annotations

import abc
import os
import threading
from typing import Dict, Optional, Sequence

from chunkflow_tpu_torch.cloud.http import HTTPClient
from chunkflow_tpu_torch.volume.storage import KVBackend

__all__ = ["BucketKV", "shared_http"]

_LOCK = threading.Lock()
_HTTP: Optional[HTTPClient] = None


def shared_http() -> HTTPClient:
    global _HTTP
    with _LOCK:
        if _HTTP is None:
            _HTTP = HTTPClient(counter_prefix="storage/http")
        return _HTTP


class BucketKV(KVBackend):
    """The objects under ``<scheme>://bucket/path/``."""

    scheme = ""

    def __init__(self, bucket: str, path: str = ""):
        if not bucket:
            raise ValueError(f"a {self.scheme}:// URL needs a bucket")
        self.bucket = bucket
        self.prefix = path if not path or path.endswith("/") else path + "/"
        self.url = f"{self.scheme}://{bucket}/{self.prefix}"
        self.http = shared_http()

    @abc.abstractmethod
    def _get(self, name: str, headers=None, if_generation=None):
        """``(value or None, generation)`` of one GET."""

    @abc.abstractmethod
    def list(self, start: str = "", stop: Optional[str] = None,
             prefix: str = ""):
        """Names (relative to the root) in ``[start, stop)`` under
        ``prefix``."""

    def read_bytes(self, name: str) -> Optional[bytes]:
        return self._get(name)[0]

    def read_with_generation(self, name: str):
        return self._get(name)

    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None):
        if stop <= start:
            raise ValueError(f"empty range [{start}, {stop})")
        return self._get(name, {"Range": f"bytes={start}-{stop - 1}"},
                         if_generation)

    def read_suffix(self, name: str, length: int) -> Optional[bytes]:
        if length <= 0:
            raise ValueError(f"empty suffix of {length} bytes")
        return self._get(name, {"Range": f"bytes=-{length}"})[0]

    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        if not names:
            return {}
        ordered = sorted(names)
        present = set(self.list(ordered[0], ordered[-1] + "\x00",
                                os.path.commonprefix(ordered)))
        return {name: name in present for name in names}
