"""Chunk: an array (numpy or torch) + voxel offset/size + layer type.

The counterpart of ``chunkflow_tpu/chunk/base.py``, cut to the surface the
per-chunk inference path uses. The payload is a numpy array (host) or a
``torch.Tensor`` (CPU or CUDA); a tensor payload is kept as it is, never
run through ``np.asarray`` (which would copy a CPU tensor and fail on a
CUDA one). ``device(device)`` / ``host()`` move it explicitly. Spatial
geometry always refers to the trailing 3 (z, y, x) dims, so 3D (zyx) and
4D (czyx) chunks flow through the same code paths.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional, Union

import numpy as np
import torch

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian
from chunkflow_tpu_torch.core.dtypes import numpy_dtype, signed_view


class LayerType(str, Enum):
    IMAGE = "image"
    SEGMENTATION = "segmentation"
    AFFINITY_MAP = "affinity_map"
    PROBABILITY_MAP = "probability_map"
    UNKNOWN = "unknown"


def _as_tensor(array: np.ndarray) -> torch.Tensor:
    """A tensor sharing a host array's memory where torch allows it
    (contiguous and writable; otherwise one host copy)."""
    if not (array.flags.c_contiguous and array.flags.writeable):
        array = np.ascontiguousarray(array).copy()
    return torch.from_numpy(array)


class Chunk:
    """An ndarray located in a global voxel coordinate system."""

    def __init__(
        self,
        array,
        voxel_offset=None,
        voxel_size=None,
        layer_type: Union[str, LayerType, None] = None,
    ):
        if not isinstance(array, (np.ndarray, torch.Tensor)):
            array = np.asarray(array)
        if array.ndim not in (3, 4):
            raise ValueError(
                f"chunks are 3D (zyx) or 4D (czyx); got shape "
                f"{tuple(array.shape)}"
            )
        self.array = array
        self.voxel_offset = to_cartesian(voxel_offset) or Cartesian.zeros()
        self.voxel_size = to_cartesian(voxel_size) or Cartesian(1, 1, 1)
        if layer_type is None:
            layer_type = self._infer_layer_type(array)
        self.layer_type = LayerType(layer_type)

    @staticmethod
    def _infer_layer_type(array) -> LayerType:
        dtype = numpy_dtype(array.dtype)
        if dtype is None:  # bfloat16: a float map
            dtype = np.dtype(np.float32)
        if array.ndim == 4 and array.shape[0] == 3 and dtype.kind == "f":
            return LayerType.AFFINITY_MAP
        if dtype == np.uint8 and array.ndim == 3:
            return LayerType.IMAGE
        if dtype.kind in "iu" and dtype.itemsize >= 4:
            return LayerType.SEGMENTATION
        if dtype.kind == "f":
            return LayerType.PROBABILITY_MAP
        return LayerType.UNKNOWN

    # ---- factories -----------------------------------------------------
    @classmethod
    def create(
        cls,
        size=(64, 64, 64),
        dtype=np.uint8,
        voxel_offset=(0, 0, 0),
        voxel_size=(1, 1, 1),
        pattern: str = "sin",
        nchannels: Optional[int] = None,
        seed: int = 0,
    ) -> "Chunk":
        """Synthetic test chunk: smooth ``sin`` product, ``random``, ``zero``
        (the same values as the JAX package's ``Chunk.create``)."""
        size = tuple(to_cartesian(size))
        dtype = np.dtype(dtype)
        if pattern == "zero":
            arr = np.zeros(size, dtype=np.float32)
        elif pattern == "random":
            rng = np.random.default_rng(seed)
            arr = rng.random(size)
        elif pattern == "sin":
            z, y, x = np.meshgrid(
                *[np.linspace(0, 4 * np.pi, s) for s in size], indexing="ij"
            )
            arr = (np.sin(z) * np.sin(y) * np.sin(x) + 1.0) / 2.0
        else:
            raise ValueError(f"unknown pattern {pattern!r}")
        if dtype.kind in "iu":
            arr = (arr * np.iinfo(dtype).max).astype(dtype)
        else:
            arr = arr.astype(dtype)
        if nchannels is not None:
            arr = np.broadcast_to(arr[None, ...], (nchannels,) + size).copy()
        return cls(arr, voxel_offset=voxel_offset, voxel_size=voxel_size)

    @classmethod
    def from_bbox(
        cls, bbox: BoundingBox, dtype=np.float32, nchannels=None,
        voxel_size=None,
    ) -> "Chunk":
        """A zero chunk over ``bbox``; a torch ``dtype`` (bfloat16, which
        numpy lacks) makes a CPU tensor payload."""
        shape = tuple(bbox.shape)
        if nchannels is not None:
            shape = (nchannels,) + shape
        if isinstance(dtype, torch.dtype):
            array = torch.zeros(shape, dtype=dtype)
        else:
            array = np.zeros(shape, dtype=dtype)
        return cls(array, voxel_offset=bbox.start, voxel_size=voxel_size)

    @classmethod
    def from_npy(cls, path: str, voxel_offset=None, voxel_size=None) -> "Chunk":
        return cls(np.load(path), voxel_offset=voxel_offset,
                   voxel_size=voxel_size)

    def to_npy(self, path: str) -> str:
        """Save the payload; bfloat16 widens to float32 (npy has no
        bfloat16)."""
        arr = self.host().array
        if isinstance(arr, torch.Tensor):
            arr = arr.to(torch.float32).numpy()
        np.save(path, arr)
        return path

    # ---- array protocol -------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.array.shape)

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def ndim(self) -> int:
        return self.array.ndim

    def __repr__(self) -> str:
        return (
            f"Chunk(shape={self.shape}, dtype={self.dtype}, "
            f"offset={tuple(self.voxel_offset)}, layer={self.layer_type.value})"
        )

    # ---- device movement -------------------------------------------------
    # Asynchronous copies. A chunk staged to a CUDA device by device()
    # holds its pinned host source and the event that marks the copy
    # done (_upload); a device chunk whose download copy_to_host_async()
    # started holds the pinned destination, the event that marks its
    # compute done and the event that marks the copy done (_download).
    # _all_zero is a flag computed on the host at staging time, so the
    # blank-input check never reads the device.
    _upload = None
    _download = None
    _all_zero = None

    def device(self, device="cuda", stream=None) -> "Chunk":
        """Move the payload to ``device`` in its RAW dtype (a uint8 chunk
        rides host-to-device at 1/4 the bytes of float32; the inference
        front converts on the device).

        From the host to a CUDA device the copy is asynchronous: the
        payload is copied into page-locked memory, then to the device on
        ``stream`` (default: the current stream), and the result holds
        the pinned source and the copy's event. Work on another stream
        calls :meth:`await_upload` before it reads the payload."""
        arr = self.array
        if isinstance(arr, np.ndarray):
            arr = _as_tensor(arr)
        device = torch.device(device)
        if device.type != "cuda" or arr.device.type != "cpu":
            return self._with_array(arr.to(device))
        pinned = arr.pin_memory()
        stream = stream or torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            # allocated on the copy stream: await_upload() records every
            # other stream that reads it, so the allocator never hands
            # the memory on while they still do
            payload = torch.empty(pinned.shape, dtype=pinned.dtype,
                                  device=device)
            payload.copy_(pinned, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        out = self._with_array(payload)
        out._upload = (pinned, copied)
        return out

    def await_upload(self) -> None:
        """Make the current CUDA stream wait for this chunk's asynchronous
        upload (a no-op for any other chunk)."""
        if self._upload is None:
            return
        stream = torch.cuda.current_stream(self.array.device)
        stream.wait_event(self._upload[1])
        self.array.record_stream(stream)

    def copy_to_host_async(self, stream) -> "Chunk":
        """Start the device payload's download without blocking: on the
        current stream the payload is made contiguous and a compute-done
        event recorded; ``stream`` waits on that event and copies into
        page-locked host memory. :meth:`host` then waits on the copy's
        event only (and may run in any thread)."""
        arr = self.array.contiguous()
        computed = torch.cuda.Event(blocking=True)
        computed.record(torch.cuda.current_stream(arr.device))
        stream.wait_event(computed)
        with torch.cuda.stream(stream):
            host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            copied = torch.cuda.Event(blocking=True)
            copied.record(stream)
        # the download stream reads memory the current stream allocated
        arr.record_stream(stream)
        out = self._with_array(arr)
        out._download = (host, computed, copied)
        return out

    def wait_computed(self) -> None:
        """Block until the device work that produced a downloading payload
        has finished (a no-op for any other chunk)."""
        if self._download is not None:
            self._download[1].synchronize()

    def host(self) -> "Chunk":
        """The payload on the host: a numpy array, or a CPU tensor for
        dtypes numpy lacks (bfloat16). A chunk whose download was started
        waits for that copy and wraps its pinned buffer."""
        arr = self.array
        if self._download is not None:
            arr, _, copied = self._download
            copied.synchronize()
        elif isinstance(arr, torch.Tensor):
            arr = arr.cpu()
        if isinstance(arr, torch.Tensor) and numpy_dtype(arr.dtype) is not None:
            arr = arr.numpy()
        return self._with_array(arr)

    @property
    def is_on_device(self) -> bool:
        return (isinstance(self.array, torch.Tensor)
                and self.array.device.type != "cpu")

    def _with_array(self, array) -> "Chunk":
        return type(self)(
            array,
            voxel_offset=self.voxel_offset,
            voxel_size=self.voxel_size,
            layer_type=self.layer_type,
        )

    def with_voxel_size(self, voxel_size) -> "Chunk":
        out = self._with_array(self.array)
        out.voxel_size = Cartesian.from_collection(voxel_size)
        return out

    # ---- geometry --------------------------------------------------------
    @property
    def voxel_stop(self) -> Cartesian:
        return self.voxel_offset + Cartesian.from_collection(self.shape[-3:])

    @property
    def bbox(self) -> BoundingBox:
        return BoundingBox(self.voxel_offset, self.voxel_stop)

    def _rel_slices(self, bbox: BoundingBox) -> tuple:
        spatial = bbox.translate(-self.voxel_offset).slices
        if self.ndim == 4:
            return (slice(None),) + spatial
        return spatial

    def cutout(self, bbox: BoundingBox) -> "Chunk":
        """Extract a sub-chunk in global coordinates."""
        if not self.bbox.contains(bbox):
            raise ValueError(f"{bbox} not inside chunk bbox {self.bbox}")
        return type(self)(
            self.array[self._rel_slices(bbox)],
            voxel_offset=bbox.start,
            voxel_size=self.voxel_size,
            layer_type=self.layer_type,
        )

    def crop_margin(self, margin) -> "Chunk":
        """Shrink symmetrically by ``margin`` voxels per face."""
        margin = to_cartesian(margin)
        if margin == Cartesian.zeros():
            return self
        return self.cutout(self.bbox.adjust(-margin))

    # ---- analytics -------------------------------------------------------
    def all_zero(self) -> bool:
        if self._all_zero is not None:
            return self._all_zero
        if isinstance(self.array, torch.Tensor):
            # reduce where the payload lives: only the flag crosses to
            # the host
            return not bool(signed_view(self.array).any())
        return not bool(np.any(self.array))

    def mask_using_last_channel(self, threshold: float = 0.3) -> "Chunk":
        from chunkflow_tpu_torch.ops import voting

        return voting.mask_using_last_channel(self, threshold=threshold)
