"""T-bar detection: probability map -> Synapses with pre sites (the JAX
package's ``plugins/synapse/detect_pre_synapses.py``)."""
from chunkflow_tpu_torch.annotations.synapses import Synapses
from chunkflow_tpu_torch.chunk import ProbabilityMap


def execute(prob, min_distance: int = 15, threshold_rel: float = 0.3):
    pm = ProbabilityMap.from_chunk(prob.host())
    points, confidences = pm.detect_points(
        min_distance=min_distance, threshold_rel=threshold_rel
    )
    print(f"detected {points.shape[0]} pre-synapses (T-bars)")
    return Synapses(
        points,
        pre_confidence=confidences,
        resolution=tuple(prob.voxel_size),
    )
