"""Axis-aligned bounding boxes: the ``BoundingBox`` surface ``Chunk`` uses.

The counterpart of ``chunkflow_tpu/core/bbox.py``, cut to what the port's
chunk geometry needs (cutout, margin crop, the canonical box string).
Task grids and physical boxes stay in the JAX package until a later slice
ports the task sources.
"""
from __future__ import annotations

from dataclasses import dataclass

from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian


@dataclass(frozen=True)
class BoundingBox:
    """Half-open box ``[start, stop)`` in zyx voxel coordinates."""

    start: Cartesian
    stop: Cartesian

    def __post_init__(self):
        object.__setattr__(self, "start", to_cartesian(self.start))
        object.__setattr__(self, "stop", to_cartesian(self.stop))

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
