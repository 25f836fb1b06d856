"""Chunk: an array (numpy or torch) + voxel offset/size + layer type.

The counterpart of ``chunkflow_tpu/chunk/base.py``. The payload is a
numpy array (host) or a ``torch.Tensor`` (CPU or CUDA); a tensor payload
is kept as it is, never run through ``np.asarray`` (which would copy a
CPU tensor and fail on a CUDA one). ``device(device)`` / ``host()`` move
it explicitly. Spatial geometry always refers to the trailing 3 (z, y, x)
dims, so 3D (zyx) and 4D (czyx) chunks flow through the same code paths.

numpy interop as in the JAX package (an ``NDArrayOperatorsMixin``):
``chunk * mask`` or ``chunk / 255`` keep the metadata. A host payload
computes with numpy itself; a tensor payload computes in torch where it
lies, under numpy's type rules and bitwise numpy's result
(``core/ufuncs.py``). Each operator computes where its chunk lies; none
moves a card payload to the host and back. The operators the JAX package
computes on the host only (``validate``) read a card payload once, as
its ``np.asarray`` does.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional, Union

import numpy as np
import torch

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian
from chunkflow_tpu_torch.core import ufuncs
from chunkflow_tpu_torch.core.dtypes import (
    numpy_dtype,
    signed_view,
    torch_dtype,
)


class LayerType(str, Enum):
    IMAGE = "image"
    SEGMENTATION = "segmentation"
    AFFINITY_MAP = "affinity_map"
    PROBABILITY_MAP = "probability_map"
    UNKNOWN = "unknown"


#: the ``type`` a precomputed volume's info records for each layer type
LAYER_TO_PRECOMPUTED = {
    LayerType.IMAGE: "image",
    LayerType.AFFINITY_MAP: "image",
    LayerType.PROBABILITY_MAP: "image",
    LayerType.SEGMENTATION: "segmentation",
    LayerType.UNKNOWN: "image",
}


def layer_type_from_precomputed(kind: str) -> LayerType:
    """The layer type of a chunk read from a precomputed volume whose info
    says ``"type": kind``."""
    return LayerType.SEGMENTATION if kind == "segmentation" else LayerType.IMAGE


def as_native_dtype(arr) -> np.ndarray:
    """A payload as a host numpy array, dtypes that numpy and the file
    formats lack (bfloat16) widened to float32."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if numpy_dtype(arr.dtype) is None:
            arr = arr.to(torch.float32)
        return arr.numpy()
    arr = np.asarray(arr)
    if arr.dtype.kind not in "biufc":
        return arr.astype(np.float32)
    return arr


def _as_tensor(array: np.ndarray) -> torch.Tensor:
    """A tensor sharing a host array's memory where torch allows it
    (contiguous and writable; otherwise one host copy)."""
    if not (array.flags.c_contiguous and array.flags.writeable):
        array = np.ascontiguousarray(array).copy()
    return torch.from_numpy(array)


def edge_pad(arr: torch.Tensor, zyx) -> torch.Tensor:
    """Pad a tensor's trailing (z, y, x) dims at the high side up to
    ``zyx`` by replicating the boundary plane (index clamping:
    ``F.pad``'s replicate mode takes no integer tensors). Conversion
    commutes with it, so a raw chunk pads exactly as a converted one
    would."""
    view = signed_view(arr)
    lead = arr.ndim - 3
    for axis, (run, size) in enumerate(zip(zyx, arr.shape[lead:]),
                                       start=lead):
        if run > size:
            index = torch.arange(run, device=arr.device).clamp_(max=size - 1)
            view = view.index_select(axis, index)
    return view.view(arr.dtype)


def _is_tensor(value) -> bool:
    return isinstance(value, torch.Tensor)


class Chunk(np.lib.mixins.NDArrayOperatorsMixin):
    """An ndarray located in a global voxel coordinate system."""

    def __init__(
        self,
        array,
        voxel_offset=None,
        voxel_size=None,
        layer_type: Union[str, LayerType, None] = None,
    ):
        if isinstance(array, Chunk):
            voxel_offset = voxel_offset or array.voxel_offset
            voxel_size = voxel_size or array.voxel_size
            layer_type = layer_type or array.layer_type
            array = array.array
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
    def from_array(cls, array, bbox: BoundingBox, voxel_size=None) -> "Chunk":
        """Wrap an array whose spatial extent is ``bbox``."""
        if tuple(array.shape[-3:]) != tuple(bbox.shape):
            raise ValueError(
                f"array spatial shape {tuple(array.shape[-3:])} does not "
                f"match bbox shape {tuple(bbox.shape)}"
            )
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

    @property
    def nchannels(self) -> int:
        return self.array.shape[0] if self.ndim == 4 else 1

    def __len__(self):
        return len(self.array)

    def __array__(self, dtype=None, copy=None):
        arr = self.array
        if _is_tensor(arr):
            if arr.device.type != "cpu":
                raise TypeError(
                    "the payload lies on the card: call .host() to bring "
                    "it to the host first")
            arr = as_native_dtype(arr)
        arr = np.asarray(arr)
        return arr.astype(dtype) if dtype is not None else arr

    _HANDLED = (np.ndarray, torch.Tensor, int, float, complex, np.number,
                bool, list, tuple)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """numpy interop: ``chunk * mask``, ``chunk / 255`` keep metadata.
        Host payloads run the numpy ufunc itself; when any operand holds a
        tensor the ufunc runs in torch on that tensor's device, with
        numpy's type rules (``core/ufuncs.py``)."""
        out = kwargs.get("out", ())
        for item in inputs + out:
            if not isinstance(item, self._HANDLED + (Chunk,)):
                return NotImplemented
        unwrapped = tuple(i.array if isinstance(i, Chunk) else i
                          for i in inputs)
        outs = tuple(o.array if isinstance(o, Chunk) else o for o in out)
        if any(_is_tensor(a) for a in unwrapped + outs):
            if method != "__call__" or kwargs:  # no out=, where=, ...
                return NotImplemented
            return self._rewrap(ufuncs.apply(ufunc, *unwrapped))
        if out:
            kwargs["out"] = outs
        result = getattr(ufunc, method)(*unwrapped, **kwargs)
        if method == "at":
            return None
        if isinstance(result, tuple):
            return tuple(self._rewrap(r) for r in result)
        if out:
            return self._rewrap(kwargs["out"][0])
        return self._rewrap(result)

    def _rewrap(self, result):
        if (
            hasattr(result, "ndim")
            and result.ndim in (3, 4)
            and tuple(result.shape[-3:]) == self.shape[-3:]
        ):
            return Chunk(
                result,
                voxel_offset=self.voxel_offset,
                voxel_size=self.voxel_size,
                layer_type=self.layer_type,
            )
        return result

    def __getitem__(self, key):
        return self.array[key]

    def __setitem__(self, key, value):
        if isinstance(value, Chunk):
            value = value.array
        if _is_tensor(self.array) and not _is_tensor(value):
            value = ufuncs.as_tensor(value, self.array.dtype,
                                     self.array.device)
        self.array[key] = value

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
        calls :meth:`await_upload` before it reads the payload. This is
        the staging seam: a host payload's bytes count in
        ``transfer/h2d_bytes`` (``core/profiling.note_h2d``)."""
        arr = self.array
        if isinstance(arr, np.ndarray):
            arr = _as_tensor(arr)
        device = torch.device(device)
        if device.type != "cpu" and arr.device.type == "cpu":
            from chunkflow_tpu_torch.core import profiling

            profiling.note_h2d(arr.numel() * arr.element_size())
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

    def astype(self, dtype) -> "Chunk":
        """The chunk converted to ``dtype``; a numpy payload converted to
        a torch dtype numpy lacks (bfloat16) becomes a tensor."""
        arr = self.array
        if not _is_tensor(arr) and isinstance(dtype, torch.dtype) and \
                numpy_dtype(dtype) is None:
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if _is_tensor(arr):
            return self._with_array(arr.to(torch_dtype(dtype)))
        return self._with_array(arr.astype(dtype))

    def clone(self) -> "Chunk":
        arr = self.array
        return self._with_array(arr.clone() if _is_tensor(arr)
                                else arr.copy())

    # ---- layer predicates ------------------------------------------------
    @property
    def is_image(self) -> bool:
        return self.layer_type is LayerType.IMAGE

    @property
    def is_segmentation(self) -> bool:
        return self.layer_type is LayerType.SEGMENTATION

    @property
    def is_affinity_map(self) -> bool:
        return self.layer_type is LayerType.AFFINITY_MAP

    @property
    def is_probability_map(self) -> bool:
        return self.layer_type is LayerType.PROBABILITY_MAP

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

    @property
    def bounding_box(self) -> BoundingBox:
        return self.bbox

    @property
    def start(self) -> Cartesian:
        return self.voxel_offset

    @property
    def stop(self) -> Cartesian:
        return self.voxel_stop

    @property
    def size(self):
        return self.array.numel() if _is_tensor(self.array) \
            else self.array.size

    @property
    def ndoffset(self) -> tuple:
        """Offset with the channel dim prepended for 4D chunks."""
        if self.ndim == 4:
            return (0,) + tuple(self.voxel_offset)
        return tuple(self.voxel_offset)

    @property
    def slices(self) -> tuple:
        """Global-coordinate slices of this chunk in the big volume."""
        return tuple(
            slice(o, o + s) for o, s in zip(self.ndoffset, self.shape)
        )

    @property
    def properties(self) -> dict:
        return {
            "voxel_offset": self.voxel_offset,
            "voxel_size": self.voxel_size,
            "layer_type": self.layer_type,
        }

    @properties.setter
    def properties(self, value: dict) -> None:
        self.set_properties(value)

    def set_properties(self, properties: dict) -> None:
        # None values (JSON nulls) leave the attribute unchanged
        if properties.get("voxel_offset") is not None:
            self.voxel_offset = to_cartesian(properties["voxel_offset"])
        if properties.get("voxel_size") is not None:
            self.voxel_size = to_cartesian(properties["voxel_size"])
        if properties.get("layer_type") is not None:
            self.layer_type = LayerType(properties["layer_type"])

    def fill(self, x) -> None:
        if _is_tensor(self.array):
            self.array.fill_(x)
        else:
            self.array.fill(x)

    def where(self, mask) -> tuple:
        """``np.where`` in GLOBAL coordinates: int64 index arrays on the
        host (a tensor mask is reduced where it lies)."""
        if isinstance(mask, Chunk):
            mask = mask.array
        if _is_tensor(mask):
            shape = tuple(mask.shape)
            index = tuple(i.cpu().numpy()
                          for i in torch.nonzero(mask, as_tuple=True))
        else:
            mask = np.asarray(mask)
            shape = mask.shape
            index = np.where(mask)
        if shape != self.shape:
            raise ValueError(
                f"mask shape {shape} != chunk shape {self.shape}"
            )
        return tuple(i + o for i, o in zip(index, self.ndoffset))

    def ascontiguousarray(self) -> "Chunk":
        if _is_tensor(self.array):
            self.array = self.array.contiguous()
        else:
            self.array = np.ascontiguousarray(self.array)
        return self

    def _as_payload(self, value):
        """``value`` (a patch's array) cast to this chunk's dtype, on this
        chunk's side (the host or this tensor's device)."""
        if _is_tensor(self.array):
            return ufuncs.as_tensor(value, self.array.dtype,
                                    self.array.device)
        if _is_tensor(value):
            value = as_native_dtype(value)
        return value.astype(self.dtype)

    def save(self, patch: "Chunk") -> None:
        """Overwrite the region covered by ``patch`` (global coords)."""
        inter = self.bbox.intersection(patch.bbox)
        if not inter.is_valid():
            return
        value = self._as_payload(patch.cutout(inter).array)
        self.array[self._rel_slices(inter)] = value

    def blend(self, patch: "Chunk") -> None:
        """Overlap-add ``patch`` into this chunk (global coords)."""
        inter = self.bbox.intersection(patch.bbox)
        if not inter.is_valid():
            return
        value = self._as_payload(patch.cutout(inter).array)
        self.array[self._rel_slices(inter)] += value

    def add_overlap(self, other: "Chunk") -> None:
        """Sum the overlapping region of ``other`` into this chunk."""
        self.blend(other)

    def shrink(self, size) -> "Chunk":
        """Trim voxels from the faces; ``size`` is 3 symmetric or 6
        (-z,-y,-x,+z,+y,+x) amounts."""
        size = tuple(int(s) for s in size)
        if len(size) == 3:
            size = size + size
        if len(size) != 6:
            raise ValueError(f"need 3 or 6 elements, got {len(size)}")
        if any(s < 0 for s in size):
            raise ValueError(f"shrink amounts must be non-negative: {size}")
        z, y, x = self.shape[-3:]
        if size[0] + size[3] >= z or size[1] + size[4] >= y or \
                size[2] + size[5] >= x:
            raise ValueError(
                f"shrink {size} consumes the whole extent {(z, y, x)}"
            )
        arr = self.array[
            ...,
            size[0]:z - size[3],
            size[1]:y - size[4],
            size[2]:x - size[5],
        ]
        return type(self)(
            arr,
            voxel_offset=self.voxel_offset + Cartesian.from_collection(size[:3]),
            voxel_size=self.voxel_size,
            layer_type=self.layer_type,
        )

    def pad_to(self, shape, mode: str = "constant") -> "Chunk":
        """Pad (at the stop side) so spatial dims reach ``shape``; a
        tensor pads where it lies (``constant`` and ``edge``)."""
        target = tuple(to_cartesian(shape))
        current = self.shape[-3:]
        pad = [(0, t - c) for t, c in zip(target, current)]
        if all(p == (0, 0) for p in pad):
            return self
        if any(p[1] < 0 for p in pad):
            raise ValueError(f"cannot pad {current} down to {target}")
        arr = self.array
        if not _is_tensor(arr):
            if self.ndim == 4:
                pad = [(0, 0)] + pad
            return self._with_array(np.pad(arr, pad, mode=mode))
        if mode == "constant":
            out = arr.new_zeros(arr.shape[:-3] + target)
            out[(..., *(slice(0, c) for c in current))] = arr
        elif mode == "edge":
            out = edge_pad(arr, target)
        else:
            raise ValueError(f"pad mode {mode!r} on a tensor payload: "
                             f"constant or edge")
        return self._with_array(out)

    def transpose(self, only_spatial: bool = True) -> "Chunk":
        """Reverse spatial axis order (zyx <-> xyz)."""
        if self.ndim == 4:
            axes = (0, 3, 2, 1) if only_spatial else (3, 2, 1, 0)
        else:
            axes = (2, 1, 0)
        arr = self.array
        arr = arr.permute(axes) if _is_tensor(arr) else arr.transpose(axes)
        return type(self)(
            arr,
            voxel_offset=Cartesian(*reversed(self.voxel_offset)),
            voxel_size=Cartesian(*reversed(self.voxel_size)),
            layer_type=self.layer_type,
        )

    def squeeze_channel(self) -> "Chunk":
        if self.ndim == 3:
            return self
        if self.shape[0] != 1:
            raise ValueError(f"cannot squeeze {self.shape[0]} channels")
        return self._with_array(self.array[0])

    # ---- analytics -------------------------------------------------------
    def all_zero(self) -> bool:
        if self._all_zero is not None:
            return self._all_zero
        if isinstance(self.array, torch.Tensor):
            # reduce where the payload lives: only the flag crosses to
            # the host
            return not bool(signed_view(self.array).any())
        return not bool(np.any(self.array))

    def min(self):
        return self.array.min()

    def max(self):
        return self.array.max()

    def threshold(self, threshold: float) -> "Chunk":
        from chunkflow_tpu_torch.ops import threshold as _threshold

        return _threshold.threshold(self, threshold)

    def connected_component(self, threshold: float = 0.5,
                            connectivity: int = 26,
                            device=False) -> "Chunk":
        """Label (a float chunk thresholded first) into a segmentation:
        on the host by default; with ``device`` by label propagation where
        a tensor payload lies, a host payload on ``device`` (``True``: the
        card), the labels left there (``ops/connected_components.py``)."""
        from chunkflow_tpu_torch.ops import connected_components as _cc

        return _cc.connected_components(self, threshold=threshold,
                                        connectivity=connectivity,
                                        device=device)

    def channel_voting(self, device="cuda") -> "Chunk":
        """Argmax over channels + 1, in torch where the chunk lies (a
        host chunk: on ``device``)."""
        from chunkflow_tpu_torch.ops import voting

        return voting.channel_voting(self, device=device)

    def mask_using_last_channel(self, threshold: float = 0.3) -> "Chunk":
        from chunkflow_tpu_torch.ops import voting

        return voting.mask_using_last_channel(self, threshold=threshold)

    def maskout(self, mask: "Chunk", device="cuda") -> "Chunk":
        """Multiply by a (possibly coarser) binary mask, in torch where
        the chunk lies (a host chunk: on ``device``)."""
        from chunkflow_tpu_torch.ops import mask as _mask

        return _mask.maskout(self, mask, device=device)

    def validate(self) -> bool:
        """Detect black-box corruption by template matching (on the
        host, as the JAX package)."""
        from chunkflow_tpu_torch.chunk.validate import (
            validate_by_template_matching,
        )

        return validate_by_template_matching(as_native_dtype(self.array))

    def gaussian_filter_2d(self, sigma: float = 1.0) -> "Chunk":
        """Per-section gaussian blur, where the payload lies
        (``ops/filters.py``)."""
        from chunkflow_tpu_torch.ops import filters

        return filters.gaussian_filter_2d(self, sigma=sigma)

    # ---- file formats ----------------------------------------------------
    def to_h5(self, path: str, compression: str = "gzip",
              with_unique: bool = False, chunk_size=None,
              with_offset: bool = True) -> str:
        """Write the ``main``, ``voxel_offset`` and ``voxel_size``
        datasets and the ``layer_type`` attribute (with ``with_unique``, a
        segmentation's ``unique_nonzeros`` too); a path not ending in
        ``.h5`` is a directory, named ``<bbox>.h5`` in it. HDF5 has no
        bfloat16: it is stored as float32. A card payload is downloaded
        once."""
        import os

        import h5py

        if not path.endswith(".h5"):
            path = os.path.join(path, f"{self.bbox.string}.h5")
        arr = as_native_dtype(self.array)
        chunks = None
        if chunk_size is not None:
            chunks = tuple(chunk_size)
            if arr.ndim == 4 and len(chunks) == 3:
                chunks = (arr.shape[0],) + chunks
            chunks = tuple(min(c, s) for c, s in zip(chunks, arr.shape))
        with h5py.File(path, "w") as f:
            f.create_dataset("main", data=arr, compression=compression,
                             chunks=chunks)
            if with_offset:
                f.create_dataset("voxel_offset", data=self.voxel_offset.vec)
            f.create_dataset("voxel_size", data=self.voxel_size.vec)
            f.attrs["layer_type"] = self.layer_type.value
            if with_unique and self.is_segmentation:
                f.create_dataset("unique_nonzeros",
                                 data=np.unique(arr[arr > 0]))
        return path

    @classmethod
    def from_h5(cls, path: str, dataset_path: str = "main",
                voxel_offset=None, voxel_size=None,
                bbox: Optional[BoundingBox] = None, dtype=None,
                channels=None) -> "Chunk":
        """A chunk read from an HDF5 file, on the host: ``bbox`` cuts it
        out (global coordinates, relative to the stored offset),
        ``channels`` ("0,2" or a list) keeps those of a 4D dataset,
        ``dtype`` converts."""
        import h5py

        with h5py.File(path, "r") as f:
            if voxel_offset is None and "voxel_offset" in f:
                voxel_offset = Cartesian(*f["voxel_offset"][()].tolist())
            if voxel_size is None and "voxel_size" in f:
                voxel_size = Cartesian(*f["voxel_size"][()].tolist())
            layer_type = f.attrs.get("layer_type", None)
            dset = f[dataset_path]
            if bbox is not None:
                offset = to_cartesian(voxel_offset) or Cartesian.zeros()
                sl = bbox.translate(-offset).slices
                if dset.ndim == 4:
                    sl = (slice(None),) + sl
                arr = dset[sl]
                voxel_offset = bbox.start
            else:
                arr = dset[()]
        if channels is not None and arr.ndim == 4:
            if isinstance(channels, str):
                idx = [int(c) for c in channels.split(",") if c.strip()]
            else:
                idx = [int(c) for c in channels]
            arr = arr[idx]
        if dtype is not None:
            arr = arr.astype(dtype)
        return cls(arr, voxel_offset=voxel_offset, voxel_size=voxel_size,
                   layer_type=layer_type)

    def to_tif(self, path: str, compression: str = "zlib") -> str:
        from chunkflow_tpu_torch.volume import io_tif

        return io_tif.write_tif(self, path, compression=compression)

    @classmethod
    def from_tif(cls, path: str, voxel_offset=None, voxel_size=None,
                 dtype=None) -> "Chunk":
        from chunkflow_tpu_torch.volume import io_tif

        return io_tif.read_tif(path, voxel_offset=voxel_offset,
                               voxel_size=voxel_size, dtype=dtype)
