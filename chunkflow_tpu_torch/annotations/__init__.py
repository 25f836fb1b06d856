"""Annotations: synapses, point clouds and skeletons (the counterpart of
``chunkflow_tpu/annotations/``). Host arithmetic in numpy and scipy, as
in the JAX package; a chunk a method reads is brought to the host once
with ``.host()``."""
from chunkflow_tpu_torch.annotations.point_cloud import PointCloud
from chunkflow_tpu_torch.annotations.synapses import Synapses

__all__ = ["Synapses", "PointCloud"]
