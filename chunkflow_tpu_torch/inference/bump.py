"""Bump-function patch weighting for seamless overlap blending.

A copy of ``bump_map`` from ``chunkflow_tpu/inference/bump.py``: the "wu"
bump ``exp(-1/(1-z^2) - 1/(1-y^2) - 1/(1-x^2))`` on the open (-1, 1)^3
grid, computed on the host in float64 (the raw bump spans ~1e-190 at
256-wide patches, far below float32), affinely rescaled to [1, 1e6] and
cast to float32 — bitwise the JAX package's map. The blend divides by the
accumulated weight, so any monotone conditioning preserves exactness.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def bump_map(patch_size: Tuple[int, int, int]) -> np.ndarray:
    """Raw bump weights, float32, conditioned to [1, 1e6]."""
    coords = [np.linspace(-1.0, 1.0, s + 2)[1:-1] for s in patch_size]
    zz, yy, xx = np.meshgrid(*coords, indexing="ij")
    with np.errstate(under="ignore"):
        bump = np.exp(
            -1.0 / (1.0 - zz ** 2)
            - 1.0 / (1.0 - yy ** 2)
            - 1.0 / (1.0 - xx ** 2)
        )
    lo, hi = bump.min(), bump.max()
    bump = (bump - lo) / (hi - lo) * (1e6 - 1.0) + 1.0
    out = bump.astype(np.float32)
    # cached and shared: callers must not write into it
    out.setflags(write=False)
    return out
