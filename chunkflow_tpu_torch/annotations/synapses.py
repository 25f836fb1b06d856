"""Synapse annotations: T-bars (pre) and their post-synaptic partners
(the counterpart of ``chunkflow_tpu/annotations/synapses.py``).

Pre is an [N, 3] int32 zyx array, post [M, 4] int32 (pre_index, z, y,
x), with optional confidences and user attributions; JSON and HDF5 round
trips; KDTree distance queries (pre to post distances, redundant posts,
per-neuron duplicates against a segmentation chunk, read once to the
host); bbox cropping with pre-index remapping; the DVID element list and
NeuTu task files. The JSON, DVID and NeuTu files carry the JAX package's
strings, so both packages write the same bytes.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian


class Synapses:
    def __init__(
        self,
        pre: np.ndarray,
        post: Optional[np.ndarray] = None,
        pre_confidence: Optional[np.ndarray] = None,
        post_confidence: Optional[np.ndarray] = None,
        resolution=(1, 1, 1),
        users: Optional[List[str]] = None,
    ):
        pre = np.asarray(pre, dtype=np.int32)
        if pre.size == 0:
            pre = pre.reshape(0, 3)  # json round-trips [] as shape (0,)
        if pre.ndim != 2 or pre.shape[1] != 3:
            raise ValueError(f"pre must be [N, 3] zyx, got {pre.shape}")
        if post is not None:
            post = np.asarray(post, dtype=np.int32)
            if post.size == 0:
                post = post.reshape(0, 4)
            if post.ndim != 2 or post.shape[1] != 4:
                raise ValueError(f"post must be [M, 4] (pre_idx, z, y, x)")
            if post.size and (
                post[:, 0].min() < 0 or post[:, 0].max() >= pre.shape[0]
            ):
                raise ValueError("post pre_index out of range")
        if pre_confidence is not None:
            pre_confidence = np.asarray(pre_confidence, dtype=np.float32)
            assert pre_confidence.shape[0] == pre.shape[0]
        self.pre = pre
        self.post = post
        self.pre_confidence = pre_confidence
        self.post_confidence = (
            np.asarray(post_confidence, dtype=np.float32)
            if post_confidence is not None
            else None
        )
        self.resolution = to_cartesian(resolution)
        self.users = users

    # ---- basic properties ---------------------------------------------
    @property
    def pre_num(self) -> int:
        return self.pre.shape[0]

    @property
    def post_num(self) -> int:
        return 0 if self.post is None else self.post.shape[0]

    def __len__(self) -> int:
        return self.pre_num

    def __eq__(self, other) -> bool:
        if not isinstance(other, Synapses):
            return NotImplemented
        same_pre = np.array_equal(self.pre, other.pre)
        same_post = (
            (self.post is None) == (other.post is None)
        ) and (self.post is None or np.array_equal(self.post, other.post))
        return same_pre and same_post

    @property
    def pre_bbox(self) -> BoundingBox:
        start = Cartesian(*self.pre.min(axis=0).tolist())
        stop = Cartesian(*(self.pre.max(axis=0) + 1).tolist())
        return BoundingBox(start, stop)

    @property
    def post_positions(self) -> np.ndarray:
        return self.post[:, 1:] if self.post is not None else np.zeros((0, 3))

    def post_indices_of_pre(self, pre_index: int) -> np.ndarray:
        if self.post is None:
            return np.zeros((0,), dtype=np.int64)
        return np.nonzero(self.post[:, 0] == pre_index)[0]

    @property
    def pre_with_post_num(self) -> int:
        if self.post is None:
            return 0
        return np.unique(self.post[:, 0]).size

    # ---- queries (KDTree) ---------------------------------------------
    def distances_from_pre_to_post(self) -> np.ndarray:
        """Physical distance of each post partner to its own T-bar."""
        if self.post is None or self.post_num == 0:
            return np.zeros((0,), dtype=np.float32)
        res = self.resolution.vec
        pre_pos = self.pre[self.post[:, 0]] * res
        post_pos = self.post[:, 1:] * res
        return np.linalg.norm(post_pos - pre_pos, axis=1)

    def find_redundant_post(self, distance_threshold: float) -> np.ndarray:
        """Indices of posts closer than the PHYSICAL threshold to an
        earlier post of the same T-bar (near-duplicate annotations). For
        the reference method of that (similar) name, use
        ``find_redundent_post`` — different signature and semantics."""
        from scipy.spatial import KDTree

        if self.post is None or self.post_num == 0:
            return np.zeros((0,), dtype=np.int64)
        redundant = []
        res = self.resolution.vec
        for pre_index in np.unique(self.post[:, 0]):
            indices = np.nonzero(self.post[:, 0] == pre_index)[0]
            if indices.size < 2:
                continue
            positions = self.post[indices, 1:] * res
            tree = KDTree(positions)
            pairs = tree.query_pairs(distance_threshold)
            for a, b in pairs:
                redundant.append(indices[max(a, b)])
        return np.unique(np.asarray(redundant, dtype=np.int64))

    def find_duplicate_post_on_same_neuron(self, seg) -> np.ndarray:
        """Posts of one T-bar landing on the same segment id (reference
        per-neuron duplicate detection against a Segmentation)."""
        if self.post is None or self.post_num == 0:
            return np.zeros((0,), dtype=np.int64)
        arr = np.asarray(seg.host())
        if arr.ndim == 4:
            arr = arr[0]  # czyx single-channel segmentation
        offset = seg.voxel_offset.vec
        duplicates = []
        for pre_index in np.unique(self.post[:, 0]):
            indices = np.nonzero(self.post[:, 0] == pre_index)[0]
            if indices.size < 2:
                continue
            coords = self.post[indices, 1:] - offset
            valid = np.all(
                (coords >= 0) & (coords < np.asarray(arr.shape)), axis=1
            )
            seen: Dict[int, int] = {}
            for local_i, ok in zip(indices[valid], coords[valid]):
                seg_id = int(arr[tuple(ok)])
                if seg_id == 0:
                    continue
                if seg_id in seen:
                    duplicates.append(local_i)
                else:
                    seen[seg_id] = local_i
        return np.asarray(sorted(set(duplicates)), dtype=np.int64)

    # ---- editing -------------------------------------------------------
    def filter_by_bbox(self, bbox: BoundingBox) -> "Synapses":
        """Keep T-bars inside bbox (and their posts), remapping pre indices."""
        keep = np.all(
            (self.pre >= np.asarray(bbox.start))
            & (self.pre < np.asarray(bbox.stop)),
            axis=1,
        )
        new_index = np.full(self.pre_num, -1, dtype=np.int64)
        new_index[keep] = np.arange(int(keep.sum()))
        post = None
        post_conf = None
        if self.post is not None:
            post_keep = keep[self.post[:, 0]]
            post = self.post[post_keep].copy()
            post[:, 0] = new_index[post[:, 0]]
            if self.post_confidence is not None:
                post_conf = self.post_confidence[post_keep]
        return Synapses(
            self.pre[keep],
            post=post,
            pre_confidence=(
                self.pre_confidence[keep]
                if self.pre_confidence is not None
                else None
            ),
            post_confidence=post_conf,
            resolution=self.resolution,
        )

    def remove_pre_without_post(self) -> "Synapses":
        if self.post is None:
            return self
        has_post = np.zeros(self.pre_num, dtype=bool)
        has_post[np.unique(self.post[:, 0])] = True
        new_index = np.full(self.pre_num, -1, dtype=np.int64)
        new_index[has_post] = np.arange(int(has_post.sum()))
        post = self.post.copy()
        post[:, 0] = new_index[post[:, 0]]
        return Synapses(
            self.pre[has_post],
            post=post,
            pre_confidence=(
                self.pre_confidence[has_post]
                if self.pre_confidence is not None
                else None
            ),
            post_confidence=self.post_confidence,
            resolution=self.resolution,
        )

    # ---- the reference's spellings ---------------------------------------
    # the names of the reference's synapses.py for user code that migrates
    # verbatim; the in-place editors delegate to vectorized cores
    @property
    def pre_bounding_box(self) -> BoundingBox:
        return self.pre_bbox

    def post_bounding_box(self) -> BoundingBox:
        # a plain method, as the reference calls it
        pos = self.post_positions
        if pos.shape[0] == 0:
            return self.pre_bbox
        return BoundingBox.from_points(pos)

    @property
    def bounding_box(self) -> BoundingBox:
        return self.pre_bounding_box.union(self.post_bounding_box())

    @property
    def post_coordinates(self) -> np.ndarray:
        return self.post_positions

    @property
    def pre_with_physical_coordinate(self) -> np.ndarray:
        return self.pre * self.resolution.vec

    @property
    def post_with_physical_coordinate(self) -> Optional[np.ndarray]:
        if self.post is None:
            return None
        # multiply in the post dtype (reference behavior) so column 0
        # stays an integer pre-index usable for fancy indexing
        post = self.post.copy()
        post[:, 1:] = post[:, 1:] * np.asarray(
            self.resolution.vec, dtype=post.dtype
        )
        return post

    @property
    def pre_point_cloud(self):
        from chunkflow_tpu_torch.annotations.point_cloud import PointCloud

        return PointCloud(self.pre, voxel_size=self.resolution)

    @property
    def post_point_cloud(self):
        from chunkflow_tpu_torch.annotations.point_cloud import PointCloud

        return PointCloud(self.post_positions, voxel_size=self.resolution)

    @property
    def pre_index2post_indices(self) -> List[List[int]]:
        if self.post is None:
            return [[] for _ in range(self.pre_num)]
        buckets: List[List[int]] = [[] for _ in range(self.pre_num)]
        for post_idx, pre_idx in enumerate(self.post[:, 0].tolist()):
            buckets[pre_idx].append(post_idx)
        return buckets

    @property
    def post_synapse_num_list(self) -> List[int]:
        if self.post is None:
            return [0] * self.pre_num
        counts = np.bincount(self.post[:, 0], minlength=self.pre_num)
        return counts.tolist()

    @property
    def pre_indices_without_post(self) -> List[int]:
        if self.post is None:
            return list(range(self.pre_num))
        has_post = np.zeros(self.pre_num, dtype=bool)
        has_post[np.unique(self.post[:, 0])] = True
        return np.nonzero(~has_post)[0].tolist()

    def add_pre(self, pre: np.ndarray, confidence: float = 1.0) -> "Synapses":
        pre = np.asarray(pre, dtype=np.int32).reshape(-1, 3)
        self.pre = np.vstack([self.pre, pre])
        if self.pre_confidence is not None:
            self.pre_confidence = np.concatenate([
                self.pre_confidence,
                np.full(pre.shape[0], confidence, dtype=np.float32),
            ])
        return self

    def remove_pre(self, indices) -> None:
        """Delete T-bars in place, dropping their posts and remapping the
        surviving posts' pre indices."""
        indices = np.asarray(list(indices), dtype=np.int64)
        keep = np.ones(self.pre_num, dtype=bool)
        keep[indices] = False
        new_index = np.full(self.pre_num, -1, dtype=np.int64)
        new_index[keep] = np.arange(int(keep.sum()))
        self.pre = self.pre[keep]
        if self.pre_confidence is not None:
            self.pre_confidence = self.pre_confidence[keep]
        if self.post is not None:
            post_keep = keep[self.post[:, 0]]
            self.post = self.post[post_keep].copy()
            self.post[:, 0] = new_index[self.post[:, 0]]
            if self.post_confidence is not None:
                self.post_confidence = self.post_confidence[post_keep]

    def remove_pre_duplicates(self) -> None:
        """Drop T-bars at identical coordinates (keep first occurrence);
        posts of a dropped duplicate re-attach to the surviving T-bar."""
        _, first, inverse = np.unique(
            self.pre, axis=0, return_index=True, return_inverse=True
        )
        keep_set = set(first.tolist())
        dupes = [i for i in range(self.pre_num) if i not in keep_set]
        if not dupes:
            return
        if self.post is not None:
            # route each post to the first occurrence of its T-bar coords
            canonical = first[inverse.reshape(-1)]
            self.post = self.post.copy()
            self.post[:, 0] = canonical[self.post[:, 0]]
        self.remove_pre(dupes)

    def remove_synapses_without_post(self) -> None:
        if self.post is None:
            # match remove_pre_without_post: pre-only sets are a no-op,
            # not a wipe
            return
        self.remove_pre(self.pre_indices_without_post)

    def remove_synapses_outside_bounding_box(self, bbox: BoundingBox) -> None:
        outside = ~np.all(
            (self.pre >= np.asarray(bbox.start))
            & (self.pre < np.asarray(bbox.stop)),
            axis=1,
        )
        self.remove_pre(np.nonzero(outside)[0])

    def transpose_axis(self) -> None:
        """Flip zyx <-> xyz in place."""
        self.pre = np.ascontiguousarray(self.pre[:, ::-1])
        self.resolution = Cartesian(*reversed(tuple(self.resolution)))
        if self.post is not None:
            self.post = self.post.copy()
            self.post[:, 1:] = self.post[:, 1:][:, ::-1]

    def user_id(self, user: str) -> Optional[int]:
        if self.users is None:
            return None
        for idx, item in enumerate(self.users):
            if user == item:
                return idx
        return None

    def find_redundent_post(self, num_threshold: int = 15,
                            distance_threshold: float = 50.0) -> set:
        """The reference's signature and semantics: posts
        farther than distance_threshold VOXELS from their T-bar, plus the
        worst posts beyond num_threshold per T-bar (by distance, or
        distance/confidence when confidences exist). Returns a set of post
        indices to remove. (find_redundant_post is this framework's
        physical-distance near-duplicate finder — different question.)"""
        if self.post is None or self.post_num == 0:
            return set()
        dv = np.linalg.norm(
            (self.post[:, 1:] - self.pre[self.post[:, 0]]).astype(np.float64),
            axis=1,
        )
        to_remove = set(np.nonzero(dv > distance_threshold)[0].tolist())
        for post_indices in self.pre_index2post_indices:
            if len(post_indices) > num_threshold:
                idx = np.asarray(post_indices, dtype=np.int64)
                costs = dv[idx]
                if self.post_confidence is not None:
                    costs = costs / self.post_confidence[idx]
                order = np.argsort(costs)
                to_remove |= set(idx[order[num_threshold:]].tolist())
        return to_remove

    @property
    def json_dict(self) -> dict:
        data = {
            "resolution": list(self.resolution),
            "pre": self.pre.tolist(),
        }
        if self.post is not None:
            data["post"] = self.post.tolist()
        if self.pre_confidence is not None:
            data["pre_confidence"] = self.pre_confidence.tolist()
        if self.post_confidence is not None:
            data["post_confidence"] = self.post_confidence.tolist()
        if self.users is not None:
            data["users"] = self.users
        return data

    @classmethod
    def from_dict(cls, data: dict) -> "Synapses":
        return cls(
            np.asarray(data["pre"], dtype=np.int32),
            post=(
                np.asarray(data["post"], dtype=np.int32)
                if data.get("post") is not None
                else None
            ),
            pre_confidence=data.get("pre_confidence"),
            post_confidence=data.get("post_confidence"),
            resolution=tuple(data.get("resolution", (1, 1, 1))),
            users=data.get("users"),
        )

    # ---- I/O -----------------------------------------------------------
    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.json_dict, f)
        return path

    @classmethod
    def from_json(cls, path: str) -> "Synapses":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_h5(self, path: str) -> str:
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("pre", data=self.pre)
            if self.post is not None:
                f.create_dataset("post", data=self.post)
            if self.pre_confidence is not None:
                f.create_dataset("pre_confidence", data=self.pre_confidence)
            if self.post_confidence is not None:
                f.create_dataset("post_confidence", data=self.post_confidence)
            f.create_dataset("resolution", data=self.resolution.vec)
        return path

    @classmethod
    def from_h5(cls, path: str) -> "Synapses":
        import h5py

        with h5py.File(path, "r") as f:
            return cls(
                f["pre"][()],
                post=f["post"][()] if "post" in f else None,
                pre_confidence=(
                    f["pre_confidence"][()] if "pre_confidence" in f else None
                ),
                post_confidence=(
                    f["post_confidence"][()] if "post_confidence" in f else None
                ),
                resolution=(
                    tuple(f["resolution"][()].tolist())
                    if "resolution" in f
                    else (1, 1, 1)
                ),
            )

    @classmethod
    def from_file(cls, path: str) -> "Synapses":
        if path.endswith(".json"):
            return cls.from_json(path)
        if path.endswith((".h5", ".hdf5")):
            return cls.from_h5(path)
        raise ValueError(f"unsupported synapse file format: {path}")

    def to_file(self, path: str) -> str:
        if path.endswith(".json"):
            return self.to_json(path)
        if path.endswith((".h5", ".hdf5")):
            return self.to_h5(path)
        raise ValueError(f"unsupported synapse file format: {path}")

    # ---- DVID / NeuTu interop -------------------------------------------
    @classmethod
    def from_dvid_list(cls, syns: List[dict],
                       resolution=(1, 1, 1)) -> "Synapses":
        """Build from a DVID annotation-element list (as fetched with
        fivol/DVID's elements API): dicts with 'Kind' ('PreSyn'/'PostSyn'),
        'Pos' [x, y, z], 'Prop' {'conf', 'user', ...}, and 'Rels'
        [{'Rel': 'PostSynTo', 'To': [x, y, z]}].

        Post elements whose presynapse is absent from the list are dropped
        (the reference logs and skips them the same way)."""
        pre_list, pre_conf, users = [], [], []
        for syn in syns:
            if "Pre" in syn.get("Kind", ""):
                pre_list.append(tuple(syn["Pos"][::-1]))  # xyz -> zyx
                prop = syn.get("Prop", {}) or {}
                pre_conf.append(float(prop.get("conf", 1.0)))
                users.append(prop.get("user", ""))
        pre_pos2idx = {pos: i for i, pos in enumerate(pre_list)}

        post_rows = []
        for syn in syns:
            if "Post" in syn.get("Kind", ""):
                rels = syn.get("Rels") or []
                if not rels:
                    continue  # post without a presynapse
                pre_pos = tuple(rels[0]["To"][::-1])
                pre_idx = pre_pos2idx.get(pre_pos)
                if pre_idx is None:
                    continue  # presynapse was deleted
                z, y, x = syn["Pos"][::-1]
                post_rows.append((pre_idx, z, y, x))

        pre = np.asarray(pre_list, dtype=np.int32).reshape(-1, 3)
        post = (
            np.asarray(post_rows, dtype=np.int32)
            if post_rows else None
        )
        return cls(
            pre,
            post=post,
            pre_confidence=np.asarray(pre_conf, dtype=np.float32),
            resolution=resolution,
            users=sorted(set(users)) if users else None,
        )

    def to_dvid_list_of_dict(self, user: str = "chunkflow",
                             comment: str = "ingested using chunkflow",
                             ) -> List[dict]:
        """Element list for DVID bulk ingestion: one PostSyn dict per post
        partner (with a PostSynTo relation) and one PreSyn dict per T-bar
        (with PreSynTo relations to all its partners)."""
        def xyz(zyx_row):
            return [int(v) for v in zyx_row[::-1]]

        data = []
        for post_idx in range(self.post_num):
            pre_idx = int(self.post[post_idx, 0])
            conf = (
                float(self.post_confidence[post_idx])
                if self.post_confidence is not None else 1.0
            )
            data.append({
                "Kind": "PostSyn",
                "Pos": xyz(self.post[post_idx, 1:]),
                "Prop": {"annotation": comment, "conf": str(conf),
                         "user": user},
                "Rels": [{"Rel": "PostSynTo", "To": xyz(self.pre[pre_idx])}],
                "Tags": [],
            })
        for pre_idx in range(self.pre_num):
            rels = [
                {"Rel": "PreSynTo", "To": xyz(self.post[post_idx, 1:])}
                for post_idx in self.post_indices_of_pre(pre_idx)
            ]
            conf = (
                float(self.pre_confidence[pre_idx])
                if self.pre_confidence is not None else 1.0
            )
            data.append({
                "Kind": "PreSyn",
                "Pos": xyz(self.pre[pre_idx]),
                "Prop": {"annotation": comment, "conf": str(conf),
                         "user": user},
                "Rels": rels,
                "Tags": [],
            })
        return data

    def to_neutu_task(self, path: str,
                      software_revision: int = 4809,
                      description: str = "transformed using chunkflow_tpu",
                      file_version: int = 1,
                      body_id: Optional[int] = None) -> str:
        """NeuTu focused-proofreading task JSON (presynapses only, like the
        reference's exporter)."""
        import time as _time

        if not path.endswith(".json"):
            raise ValueError("NeuTu task file must end with .json")
        task = {
            "metadata": {
                "date": _time.strftime("%d-%B-%Y %H:%M"),
                "session path": "",
                "software revision": software_revision,
                "description": description,
                "coordinate system": "dvid",
                "software": "chunkflow_tpu",
                "file version": file_version,
                "username": "chunkflow_tpu",
                "computer": "localhost",
            },
            "data": [
                {
                    "body ID": body_id if body_id is not None else "",
                    "location": [int(v) for v in self.pre[idx, ::-1]],
                }
                for idx in range(self.pre_num)
            ],
        }
        with open(path, "w") as f:
            json.dump(task, f)
        return path
