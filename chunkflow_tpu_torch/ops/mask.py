"""Multi-resolution masking: the counterpart of ``chunkflow_tpu/ops/mask.py``.

A mask chunk stored at a coarser mip multiplies a finer chunk: each mask
voxel covers an integer factor block. The JAX package computes it with
``jnp`` wherever the chunk lives; the port computes it in torch where the
chunk lies (a host chunk: on the caller's ``device``, the result back on
the host, as ``jnp`` on the default device and ``np.asarray`` do). The
coarse mask is upsampled by a broadcast view and one copy of the
boolean window: no index tensor the size of the chunk.
"""
from __future__ import annotations

import torch

from chunkflow_tpu_torch.chunk.base import Chunk
from chunkflow_tpu_torch.core.cartesian import Cartesian
from chunkflow_tpu_torch.core.device import resolve_device
from chunkflow_tpu_torch.core.dtypes import torch_dtype
from chunkflow_tpu_torch.core.ufuncs import as_tensor

# jnp without x64 narrows 64-bit payloads on the way in
_JNP_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
               torch.uint64: torch.uint32}


def jnp_payload(chunk: Chunk, device) -> torch.Tensor:
    """The payload as ``jnp.asarray`` would hold it, as a tensor: on its
    own device when it is one, else on ``device``; 64-bit dtypes narrowed
    to 32 bits (the JAX package runs with x64 off)."""
    arr = chunk.array
    if not isinstance(arr, torch.Tensor):
        arr = as_tensor(arr, torch_dtype(arr.dtype), resolve_device(device))
    narrow = _JNP_NARROW.get(arr.dtype)
    return arr if narrow is None else arr.to(narrow)


def upsample_factor(fine: Chunk, coarse: Chunk) -> Cartesian:
    factor = coarse.voxel_size / fine.voxel_size
    if any(f != int(f) or f < 1 for f in factor):
        raise ValueError(
            f"mask voxel size {coarse.voxel_size} must be an integer multiple "
            f"of chunk voxel size {fine.voxel_size}"
        )
    return factor.astype_int()


def maskout(chunk: Chunk, mask: Chunk, inverse: bool = False,
            device="cuda") -> Chunk:
    """Multiply ``chunk`` by a (possibly coarser-resolution) binary mask,
    in torch on the chunk's device (a host chunk: on ``device``)."""
    factor = upsample_factor(chunk, mask)
    on_host = not isinstance(chunk.array, torch.Tensor)
    arr = jnp_payload(chunk, device)
    binary = jnp_payload(mask, arr.device)
    if binary.ndim == 4:
        binary = binary[0]
    binary = binary != 0
    if inverse:
        binary = ~binary

    # chunk start relative to the mask origin, in fine (chunk-res) voxels
    phys_delta = (chunk.voxel_offset * chunk.voxel_size
                  - mask.voxel_offset * mask.voxel_size)
    fine_start = (phys_delta / chunk.voxel_size).floor()
    coarse_start = fine_start // factor
    # sub-voxel phase: fine voxels to trim after upsampling (a chunk start
    # off the coarse mask grid)
    phase = fine_start - coarse_start * factor
    shape = (phase + chunk.shape[-3:]).ceildiv(factor)
    binary = binary[tuple(slice(s, s + n)
                          for s, n in zip(coarse_start, shape))]
    # the nearest-neighbour upsample (jnp.repeat per axis) as a broadcast
    # view, copied once by the reshape
    n = tuple(binary.shape)
    binary = binary[:, None, :, None, :, None].expand(
        n[0], factor[0], n[1], factor[1], n[2], factor[2]).reshape(
        n[0] * factor[0], n[1] * factor[1], n[2] * factor[2])
    binary = binary[tuple(slice(p, p + s)
                          for p, s in zip(phase, chunk.shape[-3:]))]
    if arr.ndim == 4:
        binary = binary[None]
    out = arr * binary.to(arr.dtype)
    if on_host:
        out = out.cpu().numpy()
    return chunk._with_array(out)
