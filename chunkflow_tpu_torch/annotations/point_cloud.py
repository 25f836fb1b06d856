"""Point cloud: N zyx points and a voxel size (the counterpart of
``chunkflow_tpu/annotations/point_cloud.py``)."""
from __future__ import annotations

import numpy as np

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian


class PointCloud:
    def __init__(self, points: np.ndarray, voxel_size=(1, 1, 1)):
        points = np.asarray(points)
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError(f"points must be [N, 3] zyx, got {points.shape}")
        self.points = points
        self.voxel_size = to_cartesian(voxel_size)

    def __len__(self) -> int:
        return self.points.shape[0]

    @property
    def bbox(self) -> BoundingBox:
        return BoundingBox.from_points(self.points)

    # the reference's spellings
    @property
    def bounding_box(self) -> BoundingBox:
        return self.bbox

    @property
    def point_num(self) -> int:
        return self.points.shape[0]

    @classmethod
    def from_swc(cls, path: str, voxel_size=(1, 1, 1)) -> "PointCloud":
        from chunkflow_tpu_torch.annotations.skeleton import Skeleton

        skel = Skeleton.from_swc(path)
        # skeleton nodes are physical nm, points voxel coordinates
        vs = np.asarray(to_cartesian(voxel_size).vec, dtype=np.float64)
        return cls(skel.nodes / vs, voxel_size=voxel_size)

    @property
    def physical(self) -> np.ndarray:
        return self.points * self.voxel_size.vec

    def filter_by_bbox(self, bbox: BoundingBox) -> "PointCloud":
        keep = np.all(
            (self.points >= np.asarray(bbox.start))
            & (self.points < np.asarray(bbox.stop)),
            axis=1,
        )
        return PointCloud(self.points[keep], self.voxel_size)

    # ---- I/O -----------------------------------------------------------
    def to_h5(self, path: str) -> str:
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("points", data=self.points)
            f.create_dataset("voxel_size", data=self.voxel_size.vec)
        return path

    @classmethod
    def from_h5(cls, path: str) -> "PointCloud":
        import h5py

        with h5py.File(path, "r") as f:
            points = f["points"][()]
            voxel_size = (
                Cartesian(*f["voxel_size"][()].tolist())
                if "voxel_size" in f
                else (1, 1, 1)
            )
        return cls(points, voxel_size)

    def to_npy(self, path: str) -> str:
        np.save(path, self.points)
        return path
