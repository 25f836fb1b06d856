"""Physical regions of interest and their spatial decomposition tree.

A copy of ``chunkflow_tpu/core/roi.py`` (numpy only): ``RegionOfInterest``
(a bounding box with its voxel size) and ``ROITree`` (an aligned binary
space partition: split along the longest axis, in blocks, at a
block-aligned midpoint until every leaf fits the atomic block size).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from chunkflow_tpu_torch.core.bbox import BoundingBox, PhysicalBoundingBox
from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian


class RegionOfInterest(PhysicalBoundingBox):
    """A bounding box in voxel units paired with its physical voxel size."""

    @classmethod
    def from_bbox(cls, bbox: BoundingBox, voxel_size) -> "RegionOfInterest":
        return cls(bbox.start, bbox.stop, voxel_size)

    @property
    def bounding_box(self) -> BoundingBox:
        return BoundingBox(self.start, self.stop)

    @property
    def physical_size(self) -> Cartesian:
        return self.voxel_size * self.shape

    def clone(self) -> "RegionOfInterest":
        return RegionOfInterest(self.start, self.stop, self.voxel_size)

    def slices_in_scale(self, voxel_size) -> tuple:
        """Slices of this ROI viewed in a volume of another voxel size."""
        voxel_size = to_cartesian(voxel_size)
        start = tuple(
            p * s1 // s2
            for p, s1, s2 in zip(self.start, self.voxel_size, voxel_size)
        )
        stop = tuple(
            p * s1 // s2
            for p, s1, s2 in zip(self.stop, self.voxel_size, voxel_size)
        )
        return BoundingBox(start, stop).slices

    def __repr__(self) -> str:
        return (
            f"RegionOfInterest(from {tuple(self.start)} to "
            f"{tuple(self.stop)}, voxel_size={tuple(self.voxel_size)})"
        )


class ROITree:
    """Aligned binary space partition of an ROI down to atomic blocks."""

    def __init__(
        self,
        roi: RegionOfInterest,
        axis: Optional[int] = None,
        left: Optional["ROITree"] = None,
        right: Optional["ROITree"] = None,
    ):
        if axis is not None:
            assert 0 <= axis < 3
        self.roi = roi
        self.axis = axis
        self.left = left
        self.right = right

    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    @classmethod
    def from_roi(
        cls, roi: RegionOfInterest, atomic_block_size
    ) -> "ROITree":
        """Split recursively along the longest axis (in blocks) at a
        block-aligned midpoint until one block (or less) remains per leaf."""
        block = to_cartesian(atomic_block_size)
        shape = roi.shape
        blocks_per_axis = [
            -(-int(shape[i]) // int(block[i])) for i in range(3)
        ]
        if max(blocks_per_axis) <= 1:
            return cls(roi)
        axis = int(np.argmax(blocks_per_axis))
        mid_blocks = blocks_per_axis[axis] // 2
        split = int(roi.start[axis]) + mid_blocks * int(block[axis])

        left_stop = list(roi.stop)
        left_stop[axis] = split
        right_start = list(roi.start)
        right_start[axis] = split
        left = cls.from_roi(
            RegionOfInterest(roi.start, tuple(left_stop), roi.voxel_size),
            block,
        )
        right = cls.from_roi(
            RegionOfInterest(tuple(right_start), roi.stop, roi.voxel_size),
            block,
        )
        return cls(roi, axis=axis, left=left, right=right)

    def leaves(self) -> Iterator[RegionOfInterest]:
        if self.is_leaf:
            yield self.roi
            return
        yield from self.left.leaves()
        yield from self.right.leaves()

    def __len__(self) -> int:
        if self.is_leaf:
            return 1
        return len(self.left) + len(self.right)
