"""Affinity map -> segmentation: native watershed and hierarchical
agglomeration (the JAX package's ``plugins/agglomerate.py``).

``fragments``: a precomputed fragment segmentation (only the
agglomeration runs); ``scoring_function``: a waterz spelling
(``OneMinus<MeanAffinity<RegionGraphType, ScoreValue>>``,
``OneMinus<QuantileAffinity<RegionGraphType, ScoreValue, 50, false>>``)
or a short one (``mean``, ``max``, ``min``, ``quantileN``);
``flip_channel``: reverse the channel axis of an x,y,z-ordered map.
"""
import re

import numpy as np

from chunkflow_tpu_torch import native
from chunkflow_tpu_torch.chunk import Segmentation


def _parse_scoring(scoring_function: str) -> str:
    s = scoring_function.strip().lower()
    if s in ("mean", "max", "min") or re.fullmatch(r"quantile\d{1,3}", s):
        return s
    for agg in ("mean", "max", "min"):
        if f"{agg}affinity" in s:
            return agg
    m = re.search(r"quantileaffinity<[^,]+,[^,]+,\s*(\d{1,3})", s)
    if m:
        return f"quantile{m.group(1)}"
    raise ValueError(
        f"unsupported scoring_function {scoring_function!r}: need "
        "mean/max/min/quantileN or a waterz spelling containing "
        "Mean/Max/Min/QuantileAffinity"
    )


def execute(
    affs,
    fragments=None,
    threshold: float = 0.7,
    aff_threshold_low: float = 0.0001,
    aff_threshold_high: float = 0.9999,
    scoring_function: str = "OneMinus<MeanAffinity<RegionGraphType, ScoreValue>>",
    flip_channel: bool = False,
):
    arr = np.asarray(affs.host(), dtype=np.float32)
    if arr.ndim != 4 or arr.shape[0] != 3:
        raise ValueError(f"need [3, z, y, x] affinity chunk, got {arr.shape}")
    if flip_channel:
        arr = np.ascontiguousarray(arr[::-1])
    frags = None
    if fragments is not None:
        frags = np.asarray(
            fragments.host() if hasattr(fragments, "host") else fragments
        )
        if frags.ndim == 4 and frags.shape[0] == 1:
            frags = frags[0]
    seg, count = native.watershed_agglomerate(
        arr,
        t_high=aff_threshold_high,
        t_low=aff_threshold_low,
        merge_threshold=threshold,
        scoring=_parse_scoring(scoring_function),
        fragments=frags,
    )
    print(f"agglomerate: {count} segments")
    return Segmentation(
        seg, voxel_offset=affs.voxel_offset, voxel_size=affs.voxel_size
    )
