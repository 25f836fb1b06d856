"""The chunk data model."""
from chunkflow_tpu_torch.chunk.base import Chunk, LayerType

__all__ = ["Chunk", "LayerType"]
