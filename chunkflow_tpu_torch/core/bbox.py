"""Axis-aligned bounding boxes and the task grid.

The counterpart of ``chunkflow_tpu/core/bbox.py``, cut to what the port
uses: the ``BoundingBox`` surface of chunk geometry (cutout, margin crop,
the canonical ``zs-ze_ys-ye_xs-xe`` string), the block arithmetic of the
storage plane (clamp, alignment, snapping, decomposition) and the task
grid: ``BoundingBoxes.from_manual_setup`` behind ``generate-tasks`` and
the ``.txt`` / ``.npy`` task files, in the JAX package's formats.
"""
from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Iterable, Iterator, List

import numpy as np

from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian

_BBOX_RE = re.compile(
    r"(-?\d+)-(-?\d+)_(-?\d+)-(-?\d+)_(-?\d+)-(-?\d+)(?:\.\w+)?$"
)


@dataclass(frozen=True)
class BoundingBox:
    """Half-open box ``[start, stop)`` in zyx voxel coordinates."""

    start: Cartesian
    stop: Cartesian

    def __post_init__(self):
        object.__setattr__(self, "start", to_cartesian(self.start))
        object.__setattr__(self, "stop", to_cartesian(self.stop))

    @classmethod
    def from_delta(cls, start, size) -> "BoundingBox":
        start = to_cartesian(start)
        return cls(start, start + to_cartesian(size))

    @classmethod
    def from_string(cls, text: str) -> "BoundingBox":
        """Parse the canonical ``zs-ze_ys-ye_xs-xe`` string; a leading
        channel range and a trailing file extension are allowed (the LAST
        three ``a-b`` groups are the box)."""
        match = _BBOX_RE.search(text.strip())
        if match is None:
            raise ValueError(f"cannot parse bounding box from {text!r}")
        nums = [int(g) for g in match.groups()]
        return cls(Cartesian(nums[0], nums[2], nums[4]),
                   Cartesian(nums[1], nums[3], nums[5]))

    @property
    def shape(self) -> Cartesian:
        return self.stop - self.start

    @property
    def string(self) -> str:
        s, e = self.start, self.stop
        return f"{s.z}-{e.z}_{s.y}-{e.y}_{s.x}-{e.x}"

    @property
    def slices(self) -> tuple:
        return tuple(slice(s, e) for s, e in zip(self.start, self.stop))

    def is_valid(self) -> bool:
        return self.shape.all_positive()

    def __repr__(self) -> str:
        return f"BoundingBox({self.string})"

    def __hash__(self) -> int:
        return hash((self.start, self.stop))

    def translate(self, offset) -> "BoundingBox":
        offset = to_cartesian(offset)
        return BoundingBox(self.start + offset, self.stop + offset)

    def adjust(self, margin) -> "BoundingBox":
        """Grow (positive) or shrink (negative) symmetrically by ``margin``."""
        if margin is None:
            return self
        margin = Cartesian.from_collection(margin)
        return BoundingBox(self.start - margin, self.stop + margin)

    def contains(self, other: "BoundingBox") -> bool:
        return self.start <= other.start and other.stop <= self.stop

    def clamp(self, outer: "BoundingBox") -> "BoundingBox":
        """Shift/shrink this box so it fits inside ``outer``."""
        return BoundingBox(self.start.maximum(outer.start),
                           self.stop.minimum(outer.stop))

    def is_aligned_with(self, block_size, offset=None) -> bool:
        """True if both corners land on the block grid anchored at
        ``offset``: two aligned chunks never share a storage block."""
        block_size = to_cartesian(block_size)
        offset = to_cartesian(offset) or Cartesian.zeros()
        return ((self.start - offset) % block_size == Cartesian.zeros()
                and (self.stop - offset) % block_size == Cartesian.zeros())

    def snap_to_blocks(self, block_size, offset=None,
                       outward: bool = True) -> "BoundingBox":
        """Round the corners to the block grid anchored at ``offset``
        (``outward`` expands the box)."""
        block_size = to_cartesian(block_size)
        offset = to_cartesian(offset) or Cartesian.zeros()
        rel_start = self.start - offset
        rel_stop = self.stop - offset
        if outward:
            start = rel_start // block_size * block_size
            stop = rel_stop.ceildiv(block_size) * block_size
        else:
            start = rel_start.ceildiv(block_size) * block_size
            stop = rel_stop // block_size * block_size
        return BoundingBox(start + offset, stop + offset)

    def decompose_to_unaligned_block_bounding_boxes(
            self, block_size) -> List["BoundingBox"]:
        """Blocks anchored at ``start``, the trailing ones clipped at
        ``stop``."""
        block_size = to_cartesian(block_size)
        boxes = []
        for z in range(self.start.z, self.stop.z, block_size.z):
            for y in range(self.start.y, self.stop.y, block_size.y):
                for x in range(self.start.x, self.stop.x, block_size.x):
                    start = Cartesian(z, y, x)
                    boxes.append(BoundingBox(
                        start, (start + block_size).minimum(self.stop)))
        return boxes

    def decompose(self, block_size) -> List["BoundingBox"]:
        """Tile this box exactly into non-overlapping blocks."""
        block_size = to_cartesian(block_size)
        if self.shape % block_size != Cartesian.zeros():
            raise ValueError(f"shape {self.shape} is not a multiple of block "
                             f"size {block_size}")
        return [BoundingBox.from_delta(self.start + Cartesian(*idx)
                                       * block_size, block_size)
                for idx in itertools.product(
                    *(range(g) for g in self.shape // block_size))]

    def to_array(self) -> np.ndarray:
        return np.array([tuple(self.start), tuple(self.stop)],
                        dtype=np.int64)

    @classmethod
    def from_array(cls, arr) -> "BoundingBox":
        arr = np.asarray(arr).reshape(2, 3)
        return cls(Cartesian(*arr[0].tolist()), Cartesian(*arr[1].tolist()))


class BoundingBoxes:
    """An ordered collection of task boxes (the task grid)."""

    def __init__(self, boxes: Iterable[BoundingBox]):
        self.boxes: List[BoundingBox] = list(boxes)

    @classmethod
    def from_manual_setup(
        cls,
        chunk_size,
        overlap=None,
        stride=None,
        roi_start=None,
        roi_stop=None,
        roi_size=None,
        grid_size=None,
        aligned_block_size=None,
        block_offset=None,
        bounded: bool = False,
    ) -> "BoundingBoxes":
        """The overlapping chunk grid covering an ROI, in z-major order.

        Exactly one of ``overlap``/``stride`` may be given (default: no
        overlap). ``grid_size`` overrides the computed grid (and, without
        a stop or size, defines the ROI). ``aligned_block_size`` snaps the
        ROI outward to the block grid anchored at ``block_offset``. With
        ``bounded`` trailing chunks shift back inside the ROI.
        """
        chunk_size = to_cartesian(chunk_size)
        if stride is not None and overlap is not None:
            raise ValueError("give either overlap or stride, not both")
        if stride is None:
            overlap = to_cartesian(overlap) or Cartesian.zeros()
            stride = chunk_size - overlap
        else:
            stride = to_cartesian(stride)
            overlap = chunk_size - stride
        if not stride.all_positive():
            raise ValueError(f"stride must be positive, got {stride}")

        roi_start = to_cartesian(roi_start) or Cartesian.zeros()
        if roi_stop is None:
            if roi_size is not None:
                roi_stop = roi_start + to_cartesian(roi_size)
            elif grid_size is not None:
                grid = to_cartesian(grid_size)
                roi_stop = roi_start + (grid - 1) * stride + chunk_size
            else:
                raise ValueError("need roi_stop, roi_size, or grid_size")
        else:
            roi_stop = to_cartesian(roi_stop)

        if aligned_block_size is not None:
            roi = BoundingBox(roi_start, roi_stop).snap_to_blocks(
                aligned_block_size, offset=block_offset, outward=True)
            roi_start, roi_stop = roi.start, roi.stop

        roi_shape = roi_stop - roi_start
        if not roi_shape.all_positive():
            raise ValueError(
                f"empty roi: start {tuple(roi_start)} stop {tuple(roi_stop)}")
        if grid_size is None:
            # strides needed so chunks cover [roi_start, roi_stop)
            grid_size = (roi_shape - overlap).maximum(1).ceildiv(stride)
        grid_size = to_cartesian(grid_size)
        if not grid_size.all_positive():
            raise ValueError(
                f"grid size must be positive, got {tuple(grid_size)}")

        boxes = []
        for idx in itertools.product(*(range(g) for g in grid_size)):
            start = roi_start + Cartesian(*idx) * stride
            stop = start + chunk_size
            if bounded:
                shift = (stop - roi_stop).maximum(0)
                start = (start - shift).maximum(roi_start)
                stop = stop - shift
            boxes.append(BoundingBox(start, stop))
        obj = cls(boxes)
        obj.chunk_size = chunk_size
        obj.overlap = overlap
        obj.stride = stride
        obj.grid_size = grid_size
        obj.roi = BoundingBox(roi_start, roi_stop)
        return obj

    def __len__(self) -> int:
        return len(self.boxes)

    def __iter__(self) -> Iterator[BoundingBox]:
        return iter(self.boxes)

    def __getitem__(self, idx):
        picked = self.boxes[idx]
        if isinstance(idx, slice):
            return BoundingBoxes(picked)
        return picked

    def __eq__(self, other) -> bool:
        return isinstance(other, BoundingBoxes) and self.boxes == other.boxes

    def to_file(self, path: str) -> None:
        """A task file: ``.npy`` (an [N, 2, 3] int64 array of corners) or
        ``.txt`` (one bbox string per line)."""
        path = str(path)
        if path.endswith(".npy"):
            np.save(path, np.stack([b.to_array() for b in self.boxes]))
        elif path.endswith(".txt"):
            with open(path, "w") as f:
                for b in self.boxes:
                    f.write(b.string + "\n")
        else:
            raise ValueError(f"unsupported task-file format: {path}")

    @classmethod
    def from_file(cls, path: str) -> "BoundingBoxes":
        path = str(path)
        if path.endswith(".npy"):
            return cls(BoundingBox.from_array(a) for a in np.load(path))
        if path.endswith(".txt"):
            with open(path) as f:
                return cls(BoundingBox.from_string(line) for line in f
                           if line.strip())
        raise ValueError(f"unsupported task-file format: {path}")
