"""chunkflow-tpu's per-chunk inference path on PyTorch and CUDA.

A port of the JAX package ``chunkflow_tpu`` (which stays the reference)
to one NVIDIA Hopper GPU: the same chunk and patch geometry, the same
bump-weighted overlap-add, and the JAX package's two Pallas TPU kernels
as hand-written CUDA kernels (``csrc/``). It imports ``torch`` and numpy,
never JAX or the JAX package.
"""
from chunkflow_tpu_torch.chunk.base import Chunk, LayerType
from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import Cartesian

__all__ = ["BoundingBox", "Cartesian", "Chunk", "LayerType"]
