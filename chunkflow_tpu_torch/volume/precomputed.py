"""Neuroglancer precomputed volumes, read and written with numpy.

The counterpart of ``chunkflow_tpu/volume/precomputed.py``, which reads
and writes through tensorstore. Here the port's own
:class:`~chunkflow_tpu_torch.volume.storage.PrecomputedBackend` reads and
writes the ``raw``, ``jpeg``, ``png`` and ``compressed_segmentation``
encodings (``volume/codecs.py``), unsharded or in
``neuroglancer_uint64_sharded_v1`` shards (``volume/sharding.py``): the
same files tensorstore reads and writes, so a volume either package wrote
reads the same in the other. Everything outside sees czyx chunks in
global voxel coordinates; the info file is xyz.

Three behaviours of the JAX package are kept as they are:

* its block cache sits above the codec, so a ``cutout`` after a ``save``
  in one process returns the saved array, not its jpeg decoding, while
  ``CHUNKFLOW_STORAGE_CACHE_MB`` leaves the cache on;
* ``create(encoding="compressed_segmentation")`` writes no
  ``compressed_segmentation_block_size`` unless one is given, and such a
  scale raises ``ValueError`` at its first read or write;
* on a sharded scale :meth:`PrecomputedVolume.block_names` lists the
  unsharded file names, so ``has_all_blocks`` is False and a strict
  ``cutout`` raises ``FileNotFoundError``.

A volume root is a local directory (a bare path or ``file://``),
``gs://bucket/path`` or ``s3://bucket/path``, parsed as the JAX
package's ``_kvstore_spec`` parses it; every object (``info``, blocks,
shards, sidecars) goes through the root's KV plane (``open_kv``), so the
three behave alike.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from chunkflow_tpu_torch.chunk.base import (
    LAYER_TO_PRECOMPUTED,
    Chunk,
    LayerType,
    as_native_dtype,
    layer_type_from_precomputed,
)
from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian
from chunkflow_tpu_torch.volume.codecs import make_codec
from chunkflow_tpu_torch.volume.sharding import ShardedChunks, ShardingSpec
from chunkflow_tpu_torch.volume.storage import (
    KVBackend,
    PrecomputedBackend,
    blockwise_cutout,
    blockwise_save,
    open_kv,
    serial_cutout,
    shared_cache,
    split_url,
    storage_mode,
)


def _local_root(path: str) -> Optional[str]:
    """The directory of a local volume root; None for ``gs://`` and
    ``s3://``."""
    scheme, _, rest = split_url(path)
    return rest if scheme == "file" else None


def _plain(value):
    """A numpy scalar as the Python number ``json`` writes."""
    return value.item() if isinstance(value, np.generic) else value


class PrecomputedVolume:
    """One precomputed layer (every mip), czyx semantics."""

    def __init__(self, path: str):
        self.path = path
        self._kv = open_kv(path)
        self._backends: Dict[int, PrecomputedBackend] = {}
        self._info: Optional[dict] = None

    @property
    def kv(self) -> KVBackend:
        return self._kv

    @property
    def info(self) -> dict:
        if self._info is None:
            data = self.kv.read_bytes("info")
            if data is None:
                raise FileNotFoundError(f"no info file under {self.path}")
            self._info = json.loads(data)
        return self._info

    def read_json(self, name: str):
        """A JSON sidecar of the volume root, or None when absent."""
        data = self.kv.read_bytes(name)
        return json.loads(data) if data else None

    @property
    def num_mips(self) -> int:
        return len(self.info["scales"])

    @property
    def num_channels(self) -> int:
        return self.info["num_channels"]

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.info["data_type"])

    @property
    def layer_type(self) -> LayerType:
        return layer_type_from_precomputed(self.info["type"])

    def scale(self, mip: int) -> dict:
        return self.info["scales"][mip]

    def voxel_size(self, mip: int = 0) -> Cartesian:
        return Cartesian(*reversed(self.scale(mip)["resolution"]))

    def voxel_offset(self, mip: int = 0) -> Cartesian:
        return Cartesian(*reversed(self.scale(mip).get("voxel_offset",
                                                       (0, 0, 0))))

    def volume_size(self, mip: int = 0) -> Cartesian:
        return Cartesian(*reversed(self.scale(mip)["size"]))

    def block_size(self, mip: int = 0) -> Cartesian:
        return Cartesian(*reversed(self.scale(mip)["chunk_sizes"][0]))

    def bounds(self, mip: int = 0) -> BoundingBox:
        start = self.voxel_offset(mip)
        return BoundingBox(start, start + self.volume_size(mip))

    # ------------------------------------------------------------------
    def _backend(self, mip: int) -> PrecomputedBackend:
        """The storage-plane view of one mip (czyx, block grid anchored at
        the scale's voxel offset, its codec and shards), opened once. A
        scale tensorstore would not open raises ``ValueError``."""
        if mip not in self._backends:
            scale = self.scale(mip)
            codec = make_codec(scale, self.dtype, self.num_channels)
            sharded = None
            if scale.get("sharding"):
                sharded = ShardedChunks(self.kv, scale["key"],
                                        ShardingSpec(scale["sharding"]))
            self._backends[mip] = PrecomputedBackend(
                self.kv, scale["key"], self.volume_size(mip),
                self.voxel_offset(mip), self.block_size(mip),
                self.num_channels, self.dtype,
                token=f"{self.path}|mip{mip}", codec=codec, sharded=sharded)
        return self._backends[mip]

    def _czyx_bounds(self, bbox: BoundingBox) -> Tuple[tuple, tuple]:
        return ((0,) + tuple(bbox.start),
                (self.num_channels,) + tuple(bbox.stop))

    def cutout(self, bbox: BoundingBox, mip: int = 0,
               fill_missing: bool = True) -> Chunk:
        """A czyx chunk (zyx for one channel) over ``bbox`` at ``mip``.

        Absent blocks read as zeros under ``fill_missing``; without it
        (strict) a cutout over an absent block raises
        ``FileNotFoundError``. A block file of the wrong size raises
        whatever ``fill_missing`` says."""
        if not fill_missing and not self.has_all_blocks(bbox, mip=mip):
            raise FileNotFoundError(f"missing storage blocks under "
                                    f"{self.path} for {bbox} at mip {mip} "
                                    f"(strict read)")
        backend = self._backend(mip)
        lo, hi = self._czyx_bounds(bbox)
        if storage_mode() == "serial":
            arr = serial_cutout(backend, lo, hi)
        else:
            arr = blockwise_cutout(backend, lo, hi, cache=shared_cache())
        # little-endian to native; a whole block read serially comes back
        # as the file's read-only buffer
        arr = arr.astype(self.dtype, copy=not arr.flags.writeable)
        if arr.shape[0] == 1:
            arr = arr[0]
        return Chunk(arr, voxel_offset=bbox.start,
                     voxel_size=self.voxel_size(mip),
                     layer_type=self.layer_type)

    def save(self, chunk: Chunk, mip: int = 0, wait: bool = True):
        """Write a chunk at its global offset, converting its dtype as the
        JAX package does: a uint8 chunk into a float volume is divided by
        255; a float chunk into a uint8 volume is clipped to [0, 1],
        scaled by 255 and truncated.

        With ``wait=False`` the data is copied, the files are written in
        the background, and the write's future is returned: the caller
        drains it before it acks the task
        (``runtime.drain_pending_writes``)."""
        arr = as_native_dtype(chunk.array)
        if arr.ndim == 3:
            arr = arr[None]
        vol_dtype = np.dtype(self.dtype)
        if np.issubdtype(vol_dtype, np.floating) and arr.dtype == np.uint8:
            arr = arr.astype(vol_dtype) / np.array(255, vol_dtype)
        elif vol_dtype == np.uint8 and arr.dtype.kind == "f":
            arr = np.clip(arr, 0.0, 1.0) * 255.0
        arr = arr.astype(self.dtype, copy=False)
        lo, _hi = self._czyx_bounds(chunk.bbox)
        return blockwise_save(self._backend(mip), lo, arr,
                              cache=shared_cache(), wait=wait)

    # ------------------------------------------------------------------
    def block_names(self, bbox: BoundingBox, mip: int = 0) -> List[str]:
        """Object names of the storage blocks covering ``bbox``."""
        key = self.scale(mip)["key"]
        block = self.block_size(mip)
        bounds = self.bounds(mip)
        snapped = bbox.snap_to_blocks(block, offset=self.voxel_offset(mip),
                                      outward=True)
        names = []
        for blk in snapped.decompose(block):
            clamped = blk.clamp(bounds)
            if not clamped.is_valid():
                continue
            s, e = clamped.start, clamped.stop
            names.append(f"{key}/{s.x}-{e.x}_{s.y}-{e.y}_{s.z}-{e.z}")
        return names

    def has_all_blocks(self, bbox: BoundingBox, mip: int = 0) -> bool:
        """Whether every block covering ``bbox`` exists (resume skips)."""
        return all(self.kv.exists_many(self.block_names(bbox, mip)).values())

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, path: str, volume_size, voxel_size, voxel_offset=(0, 0, 0),
               num_channels: int = 1, dtype="uint8",
               layer_type: str = "image", block_size=(64, 64, 64),
               num_mips: int = 1, downsample_factor=(1, 2, 2),
               encoding: str = "raw", sharding: Optional[dict] = None,
               compressed_segmentation_block_size=None
               ) -> "PrecomputedVolume":
        """Write the info file of a mip pyramid (zyx arguments at mip 0;
        each mip divides the size by ``downsample_factor``, rounding up).

        Without the last two arguments the info is the JAX package's, byte
        for byte. ``sharding`` (a ``neuroglancer_uint64_sharded_v1``
        entry) shards every scale; ``compressed_segmentation_block_size``
        (zyx) is the block of every ``compressed_segmentation`` scale."""
        volume_size = to_cartesian(volume_size)
        voxel_size = to_cartesian(voxel_size)
        voxel_offset = to_cartesian(voxel_offset)
        block = to_cartesian(block_size)
        factor = to_cartesian(downsample_factor)
        scales = []
        size, res, offset = volume_size, voxel_size, voxel_offset
        for _ in range(num_mips):
            scales.append({
                "key": f"{res.x}_{res.y}_{res.z}",
                "size": [_plain(v) for v in (size.x, size.y, size.z)],
                "resolution": [_plain(v) for v in (res.x, res.y, res.z)],
                "voxel_offset": [_plain(v)
                                 for v in (offset.x, offset.y, offset.z)],
                "chunk_sizes": [[_plain(v)
                                 for v in (block.x, block.y, block.z)]],
                "encoding": encoding,
            })
            if compressed_segmentation_block_size is not None:
                scales[-1]["compressed_segmentation_block_size"] = [
                    int(v) for v in
                    reversed(tuple(compressed_segmentation_block_size))]
            if sharding is not None:
                scales[-1]["sharding"] = dict(sharding)
            size = size.ceildiv(factor)
            offset = offset // factor
            res = res * factor
        info = {"type": layer_type, "data_type": str(np.dtype(dtype)),
                "num_channels": _plain(num_channels), "scales": scales}
        local = _local_root(path)
        if local is not None:
            os.makedirs(local, exist_ok=True)
        vol = cls(path)
        vol.kv.write_bytes("info", json.dumps(info).encode())
        vol._info = info
        cache = shared_cache()
        if cache is not None:  # a recreated volume drops its old blocks
            for mip in range(num_mips):
                cache.invalidate_token(f"{path}|mip{mip}")
        return vol

    @classmethod
    def from_chunk(cls, chunk: Chunk, path: str,
                   **kwargs) -> "PrecomputedVolume":
        """A volume sized and typed like ``chunk``, holding it."""
        vol = cls.create(path, volume_size=chunk.shape[-3:],
                         voxel_size=chunk.voxel_size,
                         voxel_offset=chunk.voxel_offset,
                         num_channels=chunk.shape[0] if chunk.ndim == 4 else 1,
                         dtype=as_native_dtype(chunk.array).dtype,
                         layer_type=LAYER_TO_PRECOMPUTED[chunk.layer_type],
                         **kwargs)
        vol.save(chunk, mip=0)
        return vol


def load_chunk_or_volume(path: str, mip: int = 0,
                         bbox: Optional[BoundingBox] = None):
    """An ``.h5`` file (cut out over ``bbox`` when one is given), a
    ``.tif`` or a ``.npy`` file as a Chunk; a directory as a
    PrecomputedVolume, or its cutout over ``bbox`` when one is given."""
    if path.endswith(".h5"):
        return Chunk.from_h5(path, bbox=bbox)
    if path.endswith((".tif", ".tiff")):
        return Chunk.from_tif(path)
    if path.endswith(".npy"):
        return Chunk.from_npy(path)
    vol = PrecomputedVolume(path)
    if bbox is not None:
        return vol.cutout(bbox, mip=mip)
    return vol
