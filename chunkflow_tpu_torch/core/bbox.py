"""Axis-aligned bounding boxes and overlapping task grids.

A copy of ``chunkflow_tpu/core/bbox.py`` (numpy only), kept here so the
PyTorch port imports nothing of the JAX package: ``BoundingBox`` (a
frozen half-open box with the canonical ``zs-ze_ys-ye_xs-xe`` string,
set algebra, block decomposition and alignment checks),
``BoundingBoxes.from_manual_setup`` (the task grid behind
``generate-tasks`` and the ``.txt`` / ``.npy`` task files, in the JAX
package's formats) and ``PhysicalBoundingBox`` (a box tagged with its
voxel size, rescalable across mip levels).
"""
from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Union

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

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_delta(cls, start, size) -> "BoundingBox":
        start = to_cartesian(start)
        return cls(start, start + to_cartesian(size))

    @classmethod
    def from_center(cls, center, extent) -> "BoundingBox":
        center = to_cartesian(center)
        extent = to_cartesian(extent)
        return cls(center - extent, center + extent)

    @classmethod
    def from_string(cls, text: str) -> "BoundingBox":
        """Parse the canonical ``zs-ze_ys-ye_xs-xe`` string.

        Accepts an optional leading channel range and trailing file extension
        (e.g. ``0-3_16384-16492_86294-88342_121142-123190.json``): the LAST
        three ``a-b`` groups are the spatial box.
        """
        match = _BBOX_RE.search(text.strip())
        if match is None:
            raise ValueError(f"cannot parse bounding box from {text!r}")
        nums = [int(g) for g in match.groups()]
        start = Cartesian(nums[0], nums[2], nums[4])
        stop = Cartesian(nums[1], nums[3], nums[5])
        return cls(start, stop)

    @classmethod
    def from_slices(cls, slices: Sequence[slice]) -> "BoundingBox":
        slices = tuple(slices)[-3:]
        start = Cartesian(*(s.start for s in slices))
        stop = Cartesian(*(s.stop for s in slices))
        return cls(start, stop)

    @classmethod
    def from_array_like(cls, arr, voxel_offset=None) -> "BoundingBox":
        """Box covering the trailing-3 spatial dims of an array."""
        shape = Cartesian.from_collection(arr.shape[-3:])
        offset = to_cartesian(voxel_offset) or Cartesian.zeros()
        return cls(offset, offset + shape)

    # ---- basic properties ---------------------------------------------
    @property
    def shape(self) -> Cartesian:
        return self.stop - self.start

    @property
    def voxel_count(self) -> int:
        return int(self.shape.prod())

    @property
    def center(self) -> Cartesian:
        return (self.start + self.stop) // 2

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

    # ---- geometry ops --------------------------------------------------
    def clone(self) -> "BoundingBox":
        return BoundingBox(self.start, self.stop)

    def translate(self, offset) -> "BoundingBox":
        offset = to_cartesian(offset)
        return BoundingBox(self.start + offset, self.stop + offset)

    def adjust(self, margin) -> "BoundingBox":
        """Grow (positive) or shrink (negative) symmetrically by ``margin``."""
        if margin is None:
            return self
        margin = Cartesian.from_collection(margin)
        return BoundingBox(self.start - margin, self.stop + margin)

    def union(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(
            self.start.minimum(other.start), self.stop.maximum(other.stop)
        )

    def intersection(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(
            self.start.maximum(other.start), self.stop.minimum(other.stop)
        )

    def overlaps(self, other: "BoundingBox") -> bool:
        return self.intersection(other).is_valid()

    def contains_point(self, point) -> bool:
        point = to_cartesian(point)
        return self.start <= point and all(
            p < e for p, e in zip(point, self.stop)
        )

    def contains(self, other) -> bool:
        """Box containment for a BoundingBox, point containment otherwise
        (the reference calls contains() with bare zyx points, INCLUSIVE at
        the stop corner — cartesian_coordinate.py:448-452 — unlike the
        half-open contains_point)."""
        if not isinstance(other, BoundingBox):
            point = to_cartesian(other)
            return self.start <= point and point <= self.stop
        return self.start <= other.start and other.stop <= self.stop

    def clamp(self, outer: "BoundingBox") -> "BoundingBox":
        """Shift/shrink this box so it fits inside ``outer``."""
        start = self.start.maximum(outer.start)
        stop = self.stop.minimum(outer.stop)
        return BoundingBox(start, stop)

    # ---- block alignment ----------------------------------------------
    def is_aligned_with(self, block_size, offset=None) -> bool:
        """True if both corners land on the block grid anchored at ``offset``.

        Block alignment is the write-conflict-avoidance contract: two aligned
        chunks never share a storage block, so parallel writers never race
        (reference volume.py:194-209 and --aligned-block-size semantics).
        """
        block_size = to_cartesian(block_size)
        offset = to_cartesian(offset) or Cartesian.zeros()
        return ((self.start - offset) % block_size == Cartesian.zeros()) and (
            (self.stop - offset) % block_size == Cartesian.zeros()
        )

    def snap_to_blocks(self, block_size, offset=None, outward: bool = True) -> "BoundingBox":
        """Round corners to the block grid (outward=True expands the box)."""
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

    # ---- reference-spelling compatibility surface ----------------------
    @property
    def minpt(self) -> Cartesian:
        return self.start

    @property
    def maxpt(self) -> Cartesian:
        return self.stop

    @classmethod
    def from_list(cls, lst) -> "BoundingBox":
        """[z0, y0, x0, ..., z1, y1, x1] (reference :236-239)."""
        return cls(
            Cartesian.from_collection(lst[:3]),
            Cartesian.from_collection(lst[-3:]),
        )

    @classmethod
    def from_points(cls, points) -> "BoundingBox":
        """Tight integer box around an [N, 3] point array (stop is
        exclusive); float points floor toward -inf so negatives stay
        inside."""
        points = np.asarray(points)
        lo = np.floor(points.min(axis=0)).astype(np.int64)
        hi = np.floor(points.max(axis=0)).astype(np.int64) + 1
        return cls(
            Cartesian.from_collection(lo), Cartesian.from_collection(hi)
        )

    @property
    def random_coordinate(self) -> Cartesian:
        # property, matching the reference's attribute access (:300-301)
        import random

        return Cartesian(
            *(random.randrange(s, e) for s, e in zip(self.start, self.stop))
        )

    def inverse_order(self) -> "BoundingBox":
        """zyx <-> xyz flipped corners (plain method like reference :376)."""
        return BoundingBox(self.start.inverse, self.stop.inverse)

    def adjust_corner(self, corner_offset) -> "BoundingBox":
        """Six-element (start_z, start_y, start_x, stop_z, stop_y, stop_x)
        additive adjustment (reference :419-426)."""
        if corner_offset is None or len(corner_offset) != 6:
            raise ValueError("corner_offset must have 6 elements")
        return BoundingBox(
            self.start + Cartesian.from_collection(corner_offset[:3]),
            self.stop + Cartesian.from_collection(corner_offset[3:]),
        )

    @property
    def left_neighbors(self):
        """The three same-sized boxes adjacent on the -z, -y, -x faces
        (attribute access like the reference's cached_property :491)."""
        size = self.shape
        return tuple(
            BoundingBox.from_delta(
                self.start - Cartesian(*(size[i] if j == i else 0
                                         for j in range(3))),
                size,
            )
            for i in range(3)
        )

    def decompose_to_aligned_block_bounding_boxes(
        self, block_size, bounded: bool = True
    ) -> List["BoundingBox"]:
        """Grid of full-size blocks anchored at start; with bounded=False
        the grid extends to cover the stop corner (reference :316-331)."""
        block_size = to_cartesian(block_size)
        stops = (
            self.stop if bounded
            else self.stop + block_size - Cartesian(1, 1, 1)
        )
        boxes = []
        for z in range(self.start.z, stops.z, block_size.z):
            for y in range(self.start.y, stops.y, block_size.y):
                for x in range(self.start.x, stops.x, block_size.x):
                    boxes.append(
                        BoundingBox.from_delta(Cartesian(z, y, x), block_size)
                    )
        return boxes

    def decompose_to_unaligned_block_bounding_boxes(
        self, block_size
    ) -> List["BoundingBox"]:
        """Like the aligned decomposition but trailing blocks are clipped
        at this box's stop (reference :333-347)."""
        block_size = to_cartesian(block_size)
        boxes = []
        for z in range(self.start.z, self.stop.z, block_size.z):
            for y in range(self.start.y, self.stop.y, block_size.y):
                for x in range(self.start.x, self.stop.x, block_size.x):
                    start = Cartesian(z, y, x)
                    stop = Cartesian.from_collection(
                        np.minimum((start + block_size).vec, self.stop.vec)
                    )
                    boxes.append(BoundingBox(start, stop))
        return boxes

    def decompose(self, block_size) -> List["BoundingBox"]:
        """Tile this box exactly into non-overlapping blocks."""
        block_size = to_cartesian(block_size)
        if self.shape % block_size != Cartesian.zeros():
            raise ValueError(
                f"shape {self.shape} is not a multiple of block size {block_size}"
            )
        grid = self.shape // block_size
        boxes = []
        for idx in itertools.product(*(range(g) for g in grid)):
            start = self.start + Cartesian(*idx) * block_size
            boxes.append(BoundingBox.from_delta(start, block_size))
        return boxes

    # ---- numpy bridge --------------------------------------------------
    def to_array(self) -> np.ndarray:
        return np.array([self.start.tuple, self.stop.tuple], dtype=np.int64)

    @classmethod
    def from_array(cls, arr) -> "BoundingBox":
        arr = np.asarray(arr).reshape(2, 3)
        return cls(Cartesian(*arr[0].tolist()), Cartesian(*arr[1].tolist()))


class BoundingBoxes:
    """An ordered collection of task bounding boxes (the task grid).

    The factory :meth:`from_manual_setup` mirrors the reference task-grid
    generator: an ROI is covered by an overlapping grid of chunk-sized boxes
    with stride ``chunk_size - overlap``, optionally clamped to the ROI and
    snapped to storage-block alignment.
    """

    def __init__(self, boxes: Iterable[BoundingBox]):
        self.boxes: List[BoundingBox] = list(boxes)

    # ---- factory -------------------------------------------------------
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
        """Build the overlapping chunk grid covering an ROI.

        Exactly one of ``overlap``/``stride`` may be given (default: no
        overlap, stride == chunk_size). ``grid_size`` overrides the computed
        grid. With ``bounded=True`` trailing chunks are shifted back inside
        the ROI (so the last chunk overlaps its neighbor more instead of
        spilling out).
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
            # block grids anchor at the volume's voxel_offset, not the
            # absolute origin (storage blocks of an offset volume start at
            # the offset; snapping without it straddles block boundaries)
            roi = BoundingBox(roi_start, roi_stop).snap_to_blocks(
                aligned_block_size, offset=block_offset, outward=True
            )
            roi_start, roi_stop = roi.start, roi.stop

        roi_shape = roi_stop - roi_start
        if not roi_shape.all_positive():
            raise ValueError(
                f"empty roi: start {tuple(roi_start)} stop {tuple(roi_stop)}"
            )
        if grid_size is None:
            # number of strides needed so chunks cover [roi_start, roi_stop)
            grid_size = (roi_shape - overlap).maximum(1).ceildiv(stride)
        grid_size = to_cartesian(grid_size)
        if not grid_size.all_positive():
            raise ValueError(f"grid size must be positive, got {tuple(grid_size)}")

        boxes = []
        for idx in itertools.product(*(range(g) for g in grid_size)):
            start = roi_start + Cartesian(*idx) * stride
            stop = start + chunk_size
            if bounded:
                # shift trailing chunks back inside the ROI
                shift = (stop - roi_stop).maximum(0)
                start = start - shift
                stop = stop - shift
                start = start.maximum(roi_start)
            boxes.append(BoundingBox(start, stop))
        obj = cls(boxes)
        obj.chunk_size = chunk_size
        obj.overlap = overlap
        obj.stride = stride
        obj.grid_size = grid_size
        obj.roi = BoundingBox(roi_start, roi_stop)
        return obj

    # ---- container protocol -------------------------------------------
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

    # ---- serialization -------------------------------------------------
    def to_file(self, path: str) -> None:
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
            arr = np.load(path)
            return cls(BoundingBox.from_array(a) for a in arr)
        elif path.endswith(".txt"):
            with open(path) as f:
                return cls(
                    BoundingBox.from_string(line)
                    for line in f
                    if line.strip()
                )
        raise ValueError(f"unsupported task-file format: {path}")


@dataclass(frozen=True)
class PhysicalBoundingBox(BoundingBox):
    """A voxel box tagged with physical voxel size (nm), mip-rescalable."""

    voxel_size: Cartesian = Cartesian(1, 1, 1)

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "voxel_size", to_cartesian(self.voxel_size))

    @property
    def physical_start(self) -> Cartesian:
        return self.start * self.voxel_size

    @property
    def physical_stop(self) -> Cartesian:
        return self.stop * self.voxel_size

    def to_voxel_size(self, voxel_size) -> "PhysicalBoundingBox":
        """Rescale box coordinates to another voxel size (mip change)."""
        voxel_size = to_cartesian(voxel_size)
        factor = voxel_size / self.voxel_size
        start = (self.start / factor).floor()
        stop = (self.stop / factor).ceil()
        return PhysicalBoundingBox(start, stop, voxel_size)

    # reference spellings (cartesian_coordinate.py:709-724)
    def to_other_voxel_size(self, voxel_size) -> "PhysicalBoundingBox":
        """Reference rounding: floor-divide BOTH corners when coarsening
        (:712-724) — unlike to_voxel_size, which ceils the stop so the box
        always covers the original extent."""
        voxel_size = to_cartesian(voxel_size)
        factor = voxel_size / self.voxel_size
        return PhysicalBoundingBox(
            (self.start / factor).floor(),
            (self.stop / factor).floor(),
            voxel_size,
        )

    @property
    def voxel_bounding_box(self) -> BoundingBox:
        return BoundingBox(self.start, self.stop)
