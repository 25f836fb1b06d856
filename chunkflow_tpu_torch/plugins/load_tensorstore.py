"""Load a chunk from a zarr, zarr v3, N5 or neuroglancer precomputed
dataset (the JAX package's ``plugins/load_tensorstore.py``, which opens
the tensorstore spec ``{"driver": driver, "kvstore": kvstore}``), read
by the port's own formats through the storage plane: the dataset is
opened once per process, the cutout is read as the storage blocks that
cover it, and with ``cache`` truthy the blocks ride the shared block
LRU (``CHUNKFLOW_STORAGE_CACHE_MB``).

args example:
    driver=zarr;kvstore=file:///tmp/store;voxel_size=(40,4,4);cache=1

``driver`` is ``zarr`` (v2; the default), ``zarr3``, ``n5`` or
``neuroglancer_precomputed`` (scale 0, indexed x, y, z, channel as
tensorstore presents it). ``kvstore`` is ``scheme://path`` (``file``,
``gs``, ``s3``) or a tensorstore kvstore spec: ``{"driver": "file",
"path": ...}``, or ``"gcs"``/``"s3"`` with ``"bucket"`` and ``"path"``.
The bbox indexes the dataset's first three dimensions; trailing ones are
read whole. Any other driver raises naming its ROADMAP item.
"""
import json

import numpy as np

from chunkflow_tpu_torch.chunk import Chunk
from chunkflow_tpu_torch.volume.storage import (
    StorageBackend,
    blockwise_cutout,
    open_backend_cached,
    serial_cutout,
    shared_cache,
    storage_mode,
)
from chunkflow_tpu_torch.volume.zarr import ArrayBackend, open_array

DRIVERS = ("zarr", "zarr3", "n5", "neuroglancer_precomputed")
_ITEM = "ROADMAP, queue 1: annotations and plugins"


def kvstore_url(kvstore) -> str:
    """A kvstore (shorthand or spec) as the port's volume-root URL."""
    if isinstance(kvstore, str):
        if "://" not in kvstore:
            return kvstore
        scheme, path = kvstore.split("://", 1)
        if scheme in ("", "file"):
            return path
        if scheme in ("gs", "s3"):
            return f"{scheme}://{path}"
        raise NotImplementedError(f"the {scheme}:// kvstore is not ported "
                                  f"({_ITEM})")
    driver = kvstore.get("driver")
    path = kvstore.get("path", "")
    if driver == "file":
        return path
    if driver in ("gcs", "s3"):
        scheme = "gs" if driver == "gcs" else "s3"
        return f"{scheme}://{kvstore['bucket']}/{path}"
    raise NotImplementedError(f"the {driver} kvstore is not ported "
                              f"({_ITEM})")


class _XyzcBackend(StorageBackend):
    """A precomputed scale (czyx on the port's storage plane) indexed x,
    y, z, channel, as tensorstore's ``neuroglancer_precomputed`` driver
    presents it."""

    def __init__(self, inner):
        self.inner = inner
        self.cache_token = f"{inner.cache_token}|xyzc"

    @property
    def domain(self):
        lo, hi = self.inner.domain
        return tuple(reversed(lo)), tuple(reversed(hi))

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def block_shape(self):
        return tuple(reversed(self.inner.block_shape))

    @property
    def grid_offset(self):
        return tuple(reversed(self.inner.grid_offset))

    def read_async(self, lo, hi):
        from concurrent.futures import Future

        future = Future()
        inner = self.inner.read_async(tuple(reversed(lo)),
                                      tuple(reversed(hi)))

        def done(f):
            try:
                future.set_result(np.asarray(f.result()).transpose(3, 2, 1, 0))
            except Exception as exc:  # raised to the reader
                future.set_exception(exc)

        inner.add_done_callback(done)
        return future

    def write_async(self, lo, hi, arr):
        raise NotImplementedError("load_tensorstore reads only")


def open_dataset(driver: str, kvstore) -> StorageBackend:
    if driver not in DRIVERS:
        raise NotImplementedError(
            f"the tensorstore driver {driver!r} is not ported: the port "
            f"reads {', '.join(DRIVERS)} ({_ITEM})")
    url = kvstore_url(kvstore)
    key = json.dumps({"driver": driver, "kvstore": url})

    def opener():
        if driver == "neuroglancer_precomputed":
            from chunkflow_tpu_torch.volume.precomputed import \
                PrecomputedVolume

            return _XyzcBackend(PrecomputedVolume(url)._backend(0))
        return ArrayBackend(open_array(url, driver), token=key)

    return open_backend_cached(key, opener)


def execute(bbox, driver: str = "zarr", kvstore: str = None,
            cache: int = None, voxel_size: tuple = None):
    backend = open_dataset(driver, kvstore)
    dlo, dhi = backend.domain
    lo = tuple(bbox.start) + tuple(dlo[3:])
    hi = tuple(bbox.stop) + tuple(dhi[3:])
    if storage_mode() == "serial":
        array = serial_cutout(backend, lo, hi)
    else:
        array = blockwise_cutout(backend, lo, hi,
                                 cache=shared_cache() if cache else None)
    if isinstance(backend, ArrayBackend):
        array = backend.as_values(array)
    return Chunk(
        array,
        voxel_offset=bbox.start,
        voxel_size=voxel_size if voxel_size is not None else (1, 1, 1),
    )
