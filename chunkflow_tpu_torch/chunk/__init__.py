"""The chunk data model."""
from chunkflow_tpu_torch.chunk.base import Chunk, LayerType
from chunkflow_tpu_torch.chunk.image import Image
from chunkflow_tpu_torch.chunk.affinity_map import AffinityMap
from chunkflow_tpu_torch.chunk.segmentation import Segmentation
from chunkflow_tpu_torch.chunk.probability_map import ProbabilityMap

__all__ = [
    "Chunk",
    "LayerType",
    "Image",
    "AffinityMap",
    "Segmentation",
    "ProbabilityMap",
]
