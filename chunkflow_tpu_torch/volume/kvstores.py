"""Read-only KV planes for tensorstore's other kvstores, which
``load_tensorstore`` opens: a key prefix of another KV plane
(:class:`PrefixKV`), files served over HTTP (:class:`HttpKV`, tensorstore's
``http`` kvstore) and the members of a zip archive (:class:`ZipKV`,
tensorstore's ``zip``). ``volume/ocdbt.py:OcdbtKV`` is the fourth. A
write raises ``ValueError``: tensorstore writes none of them either.
"""
from __future__ import annotations

import io
import urllib.parse
import zipfile
from typing import Dict, Optional, Sequence

from chunkflow_tpu_torch.volume.storage import KVBackend


class _ReadOnly(KVBackend):
    def write_bytes(self, name: str, data, if_generation=None) -> None:
        raise ValueError(f"{self}: a read-only kvstore")

    def delete(self, name: str, if_generation=None) -> None:
        raise ValueError(f"{self}: a read-only kvstore")


class PrefixKV(_ReadOnly):
    """The keys under ``prefix`` in ``base``."""

    def __init__(self, base: KVBackend, prefix: str):
        self.base = base
        self.prefix = prefix.strip("/") + "/" if prefix.strip("/") else ""

    def __repr__(self) -> str:
        return f"PrefixKV({self.base!r}, {self.prefix!r})"

    def read_bytes(self, name: str) -> Optional[bytes]:
        return self.base.read_bytes(self.prefix + name)

    def read_with_generation(self, name: str):
        return self.base.read_with_generation(self.prefix + name)

    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None):
        return self.base.read_range(self.prefix + name, start, stop,
                                    if_generation)

    def read_suffix(self, name: str, length: int) -> Optional[bytes]:
        return self.base.read_suffix(self.prefix + name, length)

    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        found = self.base.exists_many([self.prefix + n for n in names])
        return {n: found[self.prefix + n] for n in names}


class HttpKV(_ReadOnly):
    """The files under ``base_url``, read by GET (a range by a ``Range``
    header; a server that answers a ranged GET with the whole file is cut
    to the range here). A file's generation is its ``ETag``, else 1."""

    def __init__(self, base_url: str):
        from chunkflow_tpu_torch.cloud.bucket import shared_http

        self.base_url = base_url if base_url.endswith("/") else base_url + "/"
        self.http = shared_http()

    def __repr__(self) -> str:
        return f"HttpKV({self.base_url!r})"

    def _get(self, name: str, headers=None):
        reply = self.http.request(
            "GET", self.base_url + urllib.parse.quote(name), headers=headers)
        if reply.status == 404:
            return None, 0, False
        return (reply.body, reply.headers.get("etag", 1),
                reply.status == 206)

    def read_bytes(self, name: str) -> Optional[bytes]:
        return self._get(name)[0]

    def read_with_generation(self, name: str):
        return self._get(name)[:2]

    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None):
        data, generation, ranged = self._get(
            name, {"Range": f"bytes={start}-{stop - 1}"})
        if data is not None and not ranged:
            data = data[start:stop]
        return data, generation

    def read_suffix(self, name: str, length: int) -> Optional[bytes]:
        data, _, ranged = self._get(name, {"Range": f"bytes=-{length}"})
        if data is not None and not ranged:
            data = data[max(0, len(data) - length):]
        return data

    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        return {n: self.http.request(
            "HEAD", self.base_url + urllib.parse.quote(n)).status != 404
            for n in names}


class ZipKV(_ReadOnly):
    """The members of the zip archive ``key`` of ``base``, read whole on
    first use (``zipfile``)."""

    def __init__(self, base: KVBackend, key: str):
        self.base, self.key = base, key
        self._zip: Optional[zipfile.ZipFile] = None

    def __repr__(self) -> str:
        return f"ZipKV({self.base!r}, {self.key!r})"

    @property
    def archive(self) -> zipfile.ZipFile:
        if self._zip is None:
            data = self.base.read_bytes(self.key)
            if data is None:
                raise FileNotFoundError(f"no zip archive {self.key} in "
                                        f"{self.base!r}")
            self._zip = zipfile.ZipFile(io.BytesIO(data))
        return self._zip

    def read_bytes(self, name: str) -> Optional[bytes]:
        try:
            return self.archive.read(name)
        except KeyError:
            return None

    def read_with_generation(self, name: str):
        data = self.read_bytes(name)
        return data, 0 if data is None else 1

    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None):
        data, generation = self.read_with_generation(name)
        return (None if data is None else data[start:stop]), generation

    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        present = set(self.archive.namelist())
        return {n: n in present for n in names}
