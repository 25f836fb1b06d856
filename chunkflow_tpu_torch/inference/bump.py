"""Bump-function patch weighting for seamless overlap blending.

A copy of ``bump_map`` from ``chunkflow_tpu/inference/bump.py``: the "wu"
bump ``exp(-1/(1-z^2) - 1/(1-y^2) - 1/(1-x^2))`` on the open (-1, 1)^3
grid, computed on the host in float64 (the raw bump spans ~1e-190 at
256-wide patches, far below float32), affinely rescaled to [1, 1e6] and
cast to float32 — bitwise the JAX package's map. The blend divides by the
accumulated weight, so any monotone conditioning preserves exactness.
It carries the JAX function's result contract. :func:`bump_const` is
the map as a tensor on a device, the one form the inferencer and the
mesh engine blend with. The JAX package's ``normalized_patch_mask`` has
no counterpart here: only its own test calls it, and no path of either
package blends with it.
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import torch

from chunkflow_tpu_torch.core.contracts import Spec, contract


@contract(_result=Spec("z", "y", "x", dtype="float32"))
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


def bump_const(patch_size: Tuple[int, int, int],
               device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """:func:`bump_map` as a float32 tensor on ``device`` (the JAX
    package's device constant of the map)."""
    return torch.from_numpy(bump_map(tuple(patch_size)).copy()).to(device)
