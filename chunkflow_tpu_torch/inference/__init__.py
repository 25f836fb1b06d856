"""Per-chunk patch inference."""
from chunkflow_tpu_torch.inference.inferencer import Inferencer

__all__ = ["Inferencer"]
