"""3D connected components: the counterpart of ``chunkflow_tpu/ops/connected_components.py``.

Host legs: the port's own copy of the JAX package's native union-find
(``csrc/host/cc3d.cpp``, ``native.py``), bitwise the JAX package's
native leg. Their plain versions are scipy's ``ndimage.label`` (bitwise
on a binary input) and the JAX package's vectorized multi-value split,
which numbers components by value, then first voxel, where the native
union-find numbers them by first voxel alone: the same partition, other
ids, in either package. Device leg: iterative label propagation in
torch where the mask lies, the JAX package's ``while_loop`` of masked
minima unrolled on the host, which checks for convergence every
``CHECK_EVERY`` sweeps (one host sync each). Its fixpoint is unique
(each component takes its smallest seed, linear index + 1), so its
labels are bitwise the JAX device leg's.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType, as_native_dtype
from chunkflow_tpu_torch.core.dtypes import signed_view

#: sweeps run by :func:`label_binary_device`, counted up to the first
#: sweep that changed nothing (the JAX ``while_loop``'s trip count)
sweeps = 0

#: sweeps between convergence checks of the device leg
CHECK_EVERY = 16


def _structure(connectivity: int) -> np.ndarray:
    if connectivity == 6:
        return ndimage.generate_binary_structure(3, 1)
    if connectivity == 18:
        return ndimage.generate_binary_structure(3, 2)
    if connectivity == 26:
        return ndimage.generate_binary_structure(3, 3)
    raise ValueError(f"connectivity must be 6, 18 or 26, got {connectivity}")


def label_binary(binary: np.ndarray, connectivity: int = 26) -> np.ndarray:
    """Label a binary volume through the native union-find (uint32,
    consecutive ids in raster order of each component's first voxel)."""
    from chunkflow_tpu_torch import native

    labels, _ = native.connected_components(
        np.asarray(binary).astype(np.uint8), connectivity)
    return labels


def label_binary_plain(binary: np.ndarray,
                       connectivity: int = 26) -> np.ndarray:
    """:func:`label_binary`'s plain version: ``scipy.ndimage.label``."""
    labels, _ = ndimage.label(binary, structure=_structure(connectivity))
    return labels.astype(np.uint32)


def _half_offsets(connectivity: int):
    """The lexicographically-positive half of the 3D neighbourhood: one
    shifted comparison per offset covers every neighbour pair once."""
    offsets = []
    for dz in (0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if (dz, dy, dx) <= (0, 0, 0):
                    continue
                order = abs(dz) + abs(dy) + abs(dx)
                if connectivity == 6 and order > 1:
                    continue
                if connectivity == 18 and order > 2:
                    continue
                offsets.append((dz, dy, dx))
    return offsets


def label_multivalue(arr: np.ndarray, connectivity: int = 26) -> np.ndarray:
    """Label each distinct-value region separately (cc3d semantics),
    through the native union-find: components numbered 1..N by their
    first voxel in raster order, as the JAX package's native leg numbers
    them (its plain version numbers by value first: the same
    partition)."""
    from chunkflow_tpu_torch import native

    labels, _ = native.connected_components(np.asarray(arr), connectivity)
    return labels


def label_multivalue_plain(arr: np.ndarray,
                           connectivity: int = 26) -> np.ndarray:
    """The JAX package's scipy leg of ``label_multivalue``: one scipy pass
    over the nonzero mask; mask-components holding one value are done,
    mixed ones split by a vectorized union-find over their equal-value
    neighbour edges. Components are numbered 1..N in (value ascending,
    then first raster voxel) order."""
    from chunkflow_tpu_torch.segment.merge_table import union_find

    out = np.zeros(arr.shape, dtype=np.uint32)
    mask = arr != 0
    if not mask.any():
        return out
    comp, num = ndimage.label(mask, structure=_structure(connectivity))
    flat_vals = arr.ravel()
    flat_comp = comp.ravel()
    nz = np.flatnonzero(flat_comp)
    comps_nz = flat_comp[nz]
    vals_nz = flat_vals[nz]

    # per mask-component value range and first voxel, in the native dtype
    vmin = np.full(num + 1, vals_nz.max(), dtype=arr.dtype)
    vmax = np.full(num + 1, vals_nz.min(), dtype=arr.dtype)
    first = np.full(num + 1, arr.size, dtype=np.int64)
    np.minimum.at(vmin, comps_nz, vals_nz)
    np.maximum.at(vmax, comps_nz, vals_nz)
    np.minimum.at(first, comps_nz, nz)
    pure = vmin == vmax
    pure[0] = False

    pure_ids = np.flatnonzero(pure)
    pure_values = vmin[pure_ids]
    pure_first = first[pure_ids]

    mixed_roots = np.empty(0, dtype=np.int64)
    mixed_inverse = np.empty(0, dtype=np.int64)
    mixed_lin = np.empty(0, dtype=np.int64)
    if not pure.all():
        mixed_voxel = ~pure[comp] & mask
        mixed_lin = np.flatnonzero(mixed_voxel.ravel())
        shape = arr.shape
        lin = np.arange(arr.size, dtype=np.int64).reshape(shape)
        edge_sets = []
        for off in _half_offsets(connectivity):
            a_sel = tuple(slice(max(0, -d), shape[i] - max(0, d))
                          for i, d in enumerate(off))
            b_sel = tuple(slice(max(0, d), shape[i] - max(0, -d))
                          for i, d in enumerate(off))
            pair = (mixed_voxel[a_sel] & mixed_voxel[b_sel]
                    & (arr[a_sel] == arr[b_sel]))
            if pair.any():
                edge_sets.append(np.stack(
                    [lin[a_sel][pair], lin[b_sel][pair]], axis=1))
        root = mixed_lin.copy()  # isolated voxels root at themselves
        if edge_sets:
            ids, roots = union_find(np.concatenate(edge_sets, axis=0))
            root[np.searchsorted(mixed_lin, ids.astype(np.int64))] = (
                roots.astype(np.int64))
        # root = min raster index of the equal-value sub-component
        mixed_roots, mixed_inverse = np.unique(root, return_inverse=True)

    values_all = np.concatenate([pure_values, flat_vals[mixed_roots]])
    first_all = np.concatenate([pure_first, mixed_roots])
    order = np.lexsort((first_all, values_all))
    rank = np.empty(order.size, dtype=np.uint32)
    rank[order] = np.arange(1, order.size + 1, dtype=np.uint32)

    rank_of_comp = np.zeros(num + 1, dtype=np.uint32)
    rank_of_comp[pure_ids] = rank[: pure_ids.size]
    out_flat = rank_of_comp[flat_comp]
    if mixed_lin.size:
        out_flat[mixed_lin] = rank[pure_ids.size:][mixed_inverse]
    return out_flat.reshape(arr.shape)


def connected_components(chunk: Chunk, threshold: float = 0.5,
                         connectivity: int = 26, device=False) -> Chunk:
    """Threshold (a float input) then label into a segmentation chunk.

    ``device`` falsy: the host legs (a card payload is read once).
    Otherwise the device leg labels where a tensor payload lies, a host
    payload on ``device`` (``True``: the card), and the labels stay
    there, non-consecutive (see :func:`label_binary_device`)."""
    if device is not False and device is not None:
        labels = _device_labels(chunk, threshold, connectivity,
                                "cuda" if device is True else device)
    else:
        arr = as_native_dtype(chunk.array)
        if arr.ndim == 4:
            if arr.shape[0] != 1:
                raise ValueError("connected components needs a "
                                 "single-channel chunk")
            arr = arr[0]
        kind = arr.dtype.kind
        if kind == "f":
            labels = label_binary(arr > threshold, connectivity=connectivity)
        elif kind == "b" or (kind in "iu" and arr.size > 0
                             and int(arr.max()) <= 1):
            labels = label_binary(arr != 0, connectivity=connectivity)
        else:
            labels = label_multivalue(arr, connectivity=connectivity)
    return Chunk(labels, voxel_offset=chunk.voxel_offset,
                 voxel_size=chunk.voxel_size,
                 layer_type=LayerType.SEGMENTATION)


def _device_labels(chunk: Chunk, threshold, connectivity, device):
    from chunkflow_tpu_torch.ops.mask import jnp_payload

    arr = jnp_payload(chunk, device)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError("connected components needs a single-channel "
                             "chunk")
        arr = arr[0]
    if arr.is_floating_point():
        # a Python float is weak, as in jnp: compared in the payload dtype
        binary = arr > threshold
    elif arr.dtype == torch.bool:
        binary = arr
    else:
        view = signed_view(arr)
        if arr.numel() == 0 or bool(((view != 0) & (view != 1)).any()):
            raise ValueError("device labeling supports binary/thresholded "
                             "input only")
        binary = view != 0
    return label_binary_device(binary, connectivity=connectivity)


def _min_into(out: torch.Tensor, src: torch.Tensor, axis: int,
              d: int) -> None:
    """``out[i] = min(out[i], src[i + d])`` along ``axis`` wherever
    ``i + d`` lies inside (outside is the background's maximum)."""
    n = out.shape[axis] - abs(d)
    if n <= 0:
        return
    o = out.narrow(axis, max(0, -d), n)
    torch.minimum(o, src.narrow(axis, max(0, d), n), out=o)


def _min3(src: torch.Tensor, axis: int) -> torch.Tensor:
    """The minimum of each voxel and its two neighbours along ``axis``."""
    out = src.clone()
    _min_into(out, src, axis, -1)
    _min_into(out, src, axis, 1)
    return out


def _neighbourhood_min(labels: torch.Tensor, connectivity: int):
    """The minimum over each voxel and its 6/18/26 neighbours. The 26
    neighbourhood is the 3x3x3 cube, a minimum separable by axis; the 18
    is the in-plane square with the in-plane cross above and below; the
    6 the face neighbours. A minimum is exact in any order, so this is
    the JAX package's minimum over the listed offsets."""
    if connectivity == 26:
        return _min3(_min3(_min3(labels, 2), 1), 0)
    if connectivity == 18:
        best = _min3(_min3(labels, 2), 1)
        cross = labels.clone()
        for axis in (1, 2):
            _min_into(cross, labels, axis, -1)
            _min_into(cross, labels, axis, 1)
        _min_into(best, cross, 0, -1)
        _min_into(best, cross, 0, 1)
        return best
    best = labels.clone()
    for axis in (0, 1, 2):
        _min_into(best, labels, axis, -1)
        _min_into(best, labels, axis, 1)
    return best


def label_binary_device(binary, connectivity: int = 26, device="cuda"):
    """Connected components of a binary volume by iterative label
    propagation, in torch where ``binary`` lies (a numpy array: on
    ``device``).

    Every foreground voxel is seeded with its linear index + 1; each sweep
    takes the minimum over the 6/18/26 neighbourhood, masked, until a
    sweep changes nothing: O(object diameter) sweeps. Returns uint32
    labels on that device, 0 for the background, NOT consecutive (each
    component holds its smallest seed): bitwise the JAX package's
    ``label_binary_device``. Adds the sweeps to the module's ``sweeps``."""
    global sweeps
    from chunkflow_tpu_torch.core.device import resolve_device

    if connectivity not in (6, 18, 26):
        raise ValueError(f"connectivity must be 6, 18 or 26, got "
                         f"{connectivity}")
    if not isinstance(binary, torch.Tensor):
        binary = torch.from_numpy(np.ascontiguousarray(binary)).to(
            resolve_device(device))
    n = binary.numel()
    if n >= np.iinfo(np.uint32).max:
        raise ValueError(
            f"volume has {n} voxels; uint32 seeds support at most "
            f"{np.iinfo(np.uint32).max - 1} — label sub-chunks instead")
    mask = binary != 0
    # int32 holds every seed below 2^31 - 1, its maximum marks background
    work = torch.int32 if n < np.iinfo(np.int32).max else torch.int64
    big = torch.iinfo(work).max
    seeds = torch.arange(1, n + 1, dtype=work,
                         device=mask.device).view(mask.shape)
    labels = torch.where(mask, seeds, big)
    del seeds
    count = 0
    while True:
        changed = torch.empty(CHECK_EVERY, dtype=torch.bool,
                              device=mask.device)
        for i in range(CHECK_EVERY):
            new = torch.where(mask, _neighbourhood_min(labels, connectivity),
                              big)
            changed[i] = (new != labels).any()
            labels = new
        changed = changed.cpu()
        if not bool(changed.all()):
            count += int(torch.nonzero(~changed)[0]) + 1
            break
        count += CHECK_EVERY
    sweeps += count
    labels = torch.where(mask, labels, 0)
    if work == torch.int32:
        return labels.view(torch.uint32)
    return labels.to(torch.uint32)
