"""Load a chunk from a dataset that tensorstore opens (the JAX package's
``plugins/load_tensorstore.py``, which opens the tensorstore spec
``{"driver": driver, "kvstore": kvstore}``), read by the port's own
formats through the storage plane: the dataset is opened once per
process, the cutout is read as the storage blocks that cover it, and with
``cache`` truthy the blocks ride the shared block LRU
(``CHUNKFLOW_STORAGE_CACHE_MB``).

args example:
    driver=zarr;kvstore=file:///tmp/store;voxel_size=(40,4,4);cache=1

``driver`` is an array driver, ``zarr`` (v2; the default), ``zarr3``,
``n5`` or ``neuroglancer_precomputed`` (scale 0, indexed x, y, z,
channel as tensorstore presents it), ``auto`` (the one of these or of
the image drivers that the store's metadata or the file's leading bytes
name, looking into a zip archive), or an image driver, ``png``,
``jpeg``, ``bmp``, ``tiff``, ``webp`` or ``avif``: the image (a tiff's
first page) indexed y, x, channel, with one channel for a grayscale
image, decoded by Pillow; as in tensorstore, only uint8 images read
(another raises ``NotImplementedError``), and ``webp`` and ``avif`` read
where this machine's Pillow decodes them (else they raise
``NotImplementedError`` naming the ROADMAP item). ``cast``,
``downsample`` and any other driver raise ``ValueError``, as tensorstore
refuses the plugin's spec for them (``cast`` and ``downsample`` need a
``base``, which the spec has not).

``kvstore`` is ``scheme://path`` (``file``, ``gs``, ``s3``) or a
tensorstore kvstore spec: ``{"driver": "file", "path": ...}``,
``"gcs"``/``"s3"`` with ``"bucket"`` and ``"path"``, ``{"driver":
"ocdbt", "base": <kvstore>}`` (``volume/ocdbt.py``), ``{"driver":
"http", "base_url": ...}`` (``volume/kvstores.py:HttpKV``) or
``{"driver": "zip", "base": <the archive's kvstore>}``
(``volume/kvstores.py:ZipKV``), each with an optional ``"path"`` within
it. The shorthands ``http://`` and ``zip://``, ``memory`` kvstores (a
tensorstore memory store lives in its own process) and any other driver
raise ``ValueError``, as tensorstore refuses them. The bbox indexes the
dataset's first three dimensions; trailing ones are read whole.
"""
import io
import json
from typing import Optional, Tuple

import numpy as np

from chunkflow_tpu_torch.chunk import Chunk
from chunkflow_tpu_torch.volume.storage import (
    KVBackend,
    MemoryBackend,
    StorageBackend,
    blockwise_cutout,
    open_backend_cached,
    open_kv,
    serial_cutout,
    shared_cache,
    storage_mode,
)
from chunkflow_tpu_torch.volume.zarr import ArrayBackend, open_array

DRIVERS = ("zarr", "zarr3", "n5", "neuroglancer_precomputed")
#: the image drivers, by Pillow's format name
IMAGES = {"png": "PNG", "jpeg": "JPEG", "bmp": "BMP", "tiff": "TIFF",
          "webp": "WEBP", "avif": "AVIF"}
_ITEM = "ROADMAP, queue 1: annotations and plugins"
_MEMORY = ("a memory kvstore (a tensorstore memory store lives in its own "
           "process, so nothing the port could read is in one)")


def _refused(what: str):
    raise ValueError(f"load_tensorstore: {what}; tensorstore refuses it "
                     f"too")


def parse_kvstore(kvstore):
    """The JAX plugin's spelling: ``scheme://path`` as the tensorstore
    kvstore spec ``{"driver": scheme, "path": path}`` (``://path`` as a
    ``file`` one); anything else as it is."""
    if isinstance(kvstore, str) and "://" in kvstore:
        driver, path = kvstore.split("://", 1)
        return {"driver": driver or "file", "path": path}
    return kvstore


def open_kvstore(kvstore) -> Tuple[Optional[KVBackend], str]:
    """A kvstore (shorthand or spec) as ``(None, the port's volume-root
    URL)``, or as ``(KV plane, key prefix in it)`` where a URL does not
    name it."""
    spec = parse_kvstore(kvstore)
    if isinstance(spec, str):
        return None, spec
    if not isinstance(spec, dict):
        _refused(f"the kvstore {kvstore!r}")
    driver = spec.get("driver")
    path = spec.get("path", "")
    if isinstance(kvstore, str):  # the scheme://path shorthand
        if driver == "file":
            return None, path
        if driver in ("gs", "s3"):
            return None, f"{driver}://{path}"
        _refused(_MEMORY if driver == "memory" else
                 f"the {driver}:// kvstore shorthand (a {driver} kvstore "
                 f"is a spec with its own members)")
    if driver == "file":
        return None, path
    if driver in ("gcs", "s3"):
        if not spec.get("bucket"):
            _refused(f"a {driver} kvstore without its bucket")
        scheme = "gs" if driver == "gcs" else "s3"
        return None, f"{scheme}://{spec['bucket']}/{path}"
    if driver == "ocdbt":
        from chunkflow_tpu_torch.volume.ocdbt import OcdbtKV

        return OcdbtKV(_kv_root(_base(spec))), path
    if driver == "http":
        from chunkflow_tpu_torch.volume.kvstores import HttpKV

        if not spec.get("base_url"):
            _refused("an http kvstore without its base_url")
        return HttpKV(spec["base_url"]), path
    if driver == "zip":
        from chunkflow_tpu_torch.volume.kvstores import ZipKV

        kv, key = _kv_key(_base(spec))
        return ZipKV(kv, key), path
    _refused(_MEMORY if driver == "memory" else f"the {driver} kvstore")


def _base(kvstore: dict):
    if "base" not in kvstore:
        _refused(f"a {kvstore.get('driver')} kvstore without its base")
    return open_kvstore(kvstore["base"])


def _kv_root(opened) -> KVBackend:
    """The KV plane rooted where an opened kvstore points."""
    from chunkflow_tpu_torch.volume.kvstores import PrefixKV

    kv, where = opened
    return open_kv(where) if kv is None else PrefixKV(kv, where)


def _kv_key(opened) -> Tuple[KVBackend, str]:
    """``(KV plane, key)`` of the one value an opened kvstore names."""
    kv, where = opened
    if kv is not None:
        return kv, where
    parent, slash, key = where.rpartition("/")
    return open_kv(parent or slash or "."), key


def read_image(driver: str, data: bytes) -> np.ndarray:
    """An image file's pixels as tensorstore's image drivers give them:
    y, x, channel, uint8."""
    from PIL import Image, features

    if driver in ("webp", "avif") and not features.check(driver):
        raise NotImplementedError(
            f"the {driver} driver: this machine's Pillow does not decode "
            f"{driver} ({_ITEM})")
    with Image.open(io.BytesIO(data), formats=[IMAGES[driver]]) as image:
        pixels = np.asarray(image)
    if pixels.dtype != np.uint8:
        # tensorstore: '"png" driver only supports uint8 images'
        raise NotImplementedError(f'the "{driver}" driver reads only uint8 '
                                  f'images, as tensorstore\'s does; this '
                                  f'one is {pixels.dtype}')
    return pixels[..., None] if pixels.ndim == 2 else pixels


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


#: the metadata each array format keeps at its root, and the leading
#: bytes of each image format and of a zip archive
_ROOTS = ((".zarray", "zarr"), ("zarr.json", "zarr3"),
          ("attributes.json", "n5"), ("info", "neuroglancer_precomputed"))
_MAGIC = ((b"\x89PNG\r\n\x1a\n", 0, "png"), (b"\xff\xd8\xff", 0, "jpeg"),
          (b"BM", 0, "bmp"), (b"II*\x00", 0, "tiff"), (b"MM\x00*", 0, "tiff"),
          (b"WEBP", 8, "webp"), (b"ftypavif", 4, "avif"),
          (b"PK\x03\x04", 0, "zip"))


def detect(kv: Optional[KVBackend], where: str):
    """tensorstore's ``auto`` driver: ``(driver, kv, where)`` of the
    dataset an opened kvstore holds, by the metadata at its root or the
    leading bytes of the value it names (a zip archive is looked into)."""
    root = _kv_root((kv, where))
    for name, driver in _ROOTS:
        try:
            if root.read_bytes(name) is not None:
                return driver, kv, where
        except NotADirectoryError:  # a file's path
            break
    store, key = _kv_key((kv, where))
    head = store.read_range(key, 0, 16)[0] if key else None
    for magic, at, driver in _MAGIC:
        if head and head[at:at + len(magic)] == magic:
            if driver != "zip":
                return driver, kv, where
            from chunkflow_tpu_torch.volume.kvstores import ZipKV

            return detect(ZipKV(store, key), "")
    _refused(f"the auto driver over {where!r}: no format detected")


def open_dataset(driver: str, kvstore) -> StorageBackend:
    if driver not in DRIVERS + ("auto",) and driver not in IMAGES:
        _refused(f"the tensorstore driver {driver!r} over "
                 f"{{'kvstore': ...}} (the port reads "
                 f"{', '.join(DRIVERS + tuple(IMAGES))} and auto)")
    key = json.dumps({"driver": driver, "kvstore": kvstore}, sort_keys=True)

    def opener():
        kv, where = open_kvstore(kvstore)
        found = driver
        if found == "auto":
            found, kv, where = detect(kv, where)
        if found in IMAGES:
            store, name = _kv_key((kv, where))
            data = store.read_bytes(name)
            if data is None:
                raise FileNotFoundError(f"load_tensorstore: no {found} "
                                        f"image at {kvstore!r}")
            return MemoryBackend(read_image(found, data))
        if found == "neuroglancer_precomputed":
            from chunkflow_tpu_torch.volume.precomputed import \
                PrecomputedVolume

            volume = (PrecomputedVolume(where) if kv is None else
                      PrecomputedVolume(key, kv=_kv_root((kv, where))))
            return _XyzcBackend(volume._backend(0))
        return ArrayBackend(open_array(where, found, kv=kv), token=key)

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
