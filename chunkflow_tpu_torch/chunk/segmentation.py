"""Segmentation chunk: the counterpart of ``chunkflow_tpu/chunk/segmentation.py``.

Computed on the host, as the JAX package computes it (a card payload is
read once, as its ``np.asarray`` does). Evaluation metrics (Rand index,
adjusted Rand, variation of information, Fowlkes-Mallows) come from a
sparse contingency table (scipy.sparse), accumulating pair counts in
float64 on purpose; remap/renumber go through ``ops/remap.py`` (the
native leg for large uint32/uint64 arrays, numpy otherwise).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType, as_native_dtype


class Segmentation(Chunk):
    def __init__(self, array, **kwargs):
        kwargs.setdefault("layer_type", LayerType.SEGMENTATION)
        super().__init__(array, **kwargs)

    @classmethod
    def from_chunk(cls, chunk: Chunk) -> "Segmentation":
        return cls(
            chunk.array,
            voxel_offset=chunk.voxel_offset,
            voxel_size=chunk.voxel_size,
        )

    # ---- evaluation ------------------------------------------------------
    def evaluate(self, groundtruth) -> dict:
        """Clustering metrics of self vs groundtruth over nonzero voxels."""
        from scipy import sparse

        seg = as_native_dtype(self.array).ravel()
        if isinstance(groundtruth, Chunk):
            gt = as_native_dtype(groundtruth.array).ravel()
        else:
            gt = as_native_dtype(groundtruth).ravel()
        keep = np.logical_and(seg > 0, gt > 0)
        seg = seg[keep]
        gt = gt[keep]
        n = seg.size
        if n == 0:
            return dict(rand_index=1.0, adjusted_rand_index=1.0,
                        voi_split=0.0, voi_merge=0.0, fowlkes_mallows=1.0)

        _, seg_ids = np.unique(seg, return_inverse=True)
        _, gt_ids = np.unique(gt, return_inverse=True)
        cont = sparse.coo_matrix(
            (np.ones(n, dtype=np.float64), (seg_ids, gt_ids))
        ).tocsr()

        # pair counts
        sum_all = float((cont.data ** 2).sum())
        rows = np.asarray(cont.sum(axis=1)).ravel()
        cols = np.asarray(cont.sum(axis=0)).ravel()
        sum_rows = float((rows ** 2).sum())
        sum_cols = float((cols ** 2).sum())
        n_pairs = n * (n - 1) / 2.0
        a_pairs = (sum_all - n) / 2.0            # same in both
        row_pairs = (sum_rows - n) / 2.0
        col_pairs = (sum_cols - n) / 2.0
        b_pairs = row_pairs - a_pairs            # same in seg only
        c_pairs = col_pairs - a_pairs            # same in gt only
        d_pairs = n_pairs - row_pairs - col_pairs + a_pairs

        rand_index = (a_pairs + d_pairs) / n_pairs if n_pairs else 1.0
        expected = row_pairs * col_pairs / n_pairs if n_pairs else 0.0
        max_index = (row_pairs + col_pairs) / 2.0
        ari = (
            (a_pairs - expected) / (max_index - expected)
            if max_index != expected
            else 1.0
        )
        fm = (
            a_pairs / np.sqrt(row_pairs * col_pairs)
            if row_pairs > 0 and col_pairs > 0
            else 1.0
        )

        # variation of information
        p = cont.data / n
        pr = rows / n
        pc = cols / n
        h_joint = -np.sum(p * np.log(p))
        h_rows = -np.sum(pr * np.log(pr))
        h_cols = -np.sum(pc * np.log(pc))
        voi_split = h_joint - h_cols   # H(seg | gt)
        voi_merge = h_joint - h_rows   # H(gt | seg)

        return dict(
            rand_index=float(rand_index),
            adjusted_rand_index=float(ari),
            voi_split=float(max(voi_split, 0.0)),
            voi_merge=float(max(voi_merge, 0.0)),
            fowlkes_mallows=float(fm),
        )

    # ---- remapping -------------------------------------------------------
    def renumber(self, start_id: int = 1, base_id: int = 0) -> "Segmentation":
        from chunkflow_tpu_torch.ops import remap

        arr, _ = remap.renumber(as_native_dtype(self.array), start_id=start_id)
        if base_id:
            # offset in uint64 so large bases never wrap the source dtype
            arr = np.asarray(arr, dtype=np.uint64)
            arr = np.where(arr > 0, arr + np.uint64(base_id), np.uint64(0))
        return self._with_array(arr)

    def remap(self, base_id: int = 0) -> Tuple["Segmentation", int]:
        """Renumber ids consecutively, offset by ``base_id``; returns the
        new chunk and its max id as the next base (reference
        chunk/segmentation.py:69-84). Functional twist: the reference
        mutates in place and returns only the new base id."""
        seg = self.renumber(start_id=1, base_id=base_id).astype(np.uint64)
        new_base_id = max(int(as_native_dtype(seg.array).max()), int(base_id))
        return seg, new_base_id

    def mask_fragments(self, voxel_num_threshold: int) -> "Segmentation":
        """Dust removal: zero out objects smaller than the threshold."""
        arr = as_native_dtype(self.array)
        ids, counts = np.unique(arr, return_counts=True)
        small = ids[(counts < voxel_num_threshold) & (ids > 0)]
        keep = ~np.isin(arr, small)
        return self._with_array(np.where(keep, arr, 0).astype(arr.dtype))

    def mask_except(self, selected_ids: Sequence[int]) -> "Segmentation":
        """Keep only the listed object ids."""
        arr = as_native_dtype(self.array)
        keep = np.isin(arr, np.asarray(list(selected_ids)))
        return self._with_array(np.where(keep, arr, 0).astype(arr.dtype))
