"""Flax UNet3D params -> PyTorch ``UNet3D`` state dict.

The inverse of ``chunkflow_tpu/models/converter.py``'s name-paired
direction: one set of params then runs in both packages. Layouts:

- Conv kernel ``[kz, ky, kx, I, O]`` -> Conv3d weight ``[O, I, kz, ky, kx]``
- ConvTranspose kernel ``[kz, ky, kx, I, O]`` -> ConvTranspose3d weight
  ``[I, O, kz, ky, kx]``, spatially FLIPPED: flax's transposed conv does
  not flip its kernel the way torch's gradient-based one does
  (``converter.py:69-74`` flips on the way in)
- norm ``scale`` / ``bias`` -> ``weight`` / ``bias``

The params come as nested dicts of numpy arrays (``np.asarray`` of each
flax leaf), so this module needs no JAX.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (str(key),))
    else:
        yield prefix, np.asarray(tree)


def unet3d_state_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict for ``models.unet3d.UNet3D`` from a flax ``UNet3D``
    param tree (``variables["params"]``); transposed convs are the
    ``up{i}`` modules."""
    state = {}
    for path, value in _leaves(params):
        module, leaf = path[:-1], path[-1]
        key = ".".join(module)
        if leaf == "kernel":
            if value.ndim != 5:
                raise ValueError(f"{'/'.join(path)}: expected a 3D conv "
                                 f"kernel, got shape {value.shape}")
            if module[-1].startswith("up"):
                value = np.transpose(value[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))
            else:
                value = np.transpose(value, (4, 3, 0, 1, 2))
            state[f"{key}.weight"] = value
        elif leaf == "scale":
            state[f"{key}.weight"] = value
        elif leaf == "bias":
            state[f"{key}.bias"] = value
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    # one host copy per leaf: flipped views and read-only flax arrays
    # become plain contiguous tensors
    return {
        k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
        for k, v in state.items()
    }
