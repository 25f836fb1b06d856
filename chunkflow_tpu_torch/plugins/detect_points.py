"""Probability map -> its local maxima as points (the JAX package's
``plugins/detect_points.py``)."""
from chunkflow_tpu_torch.chunk import ProbabilityMap


def execute(chunk, min_distance: int = 15, threshold_rel: float = 0.3):
    pm = ProbabilityMap.from_chunk(chunk.host())
    points, confidences = pm.detect_points(
        min_distance=min_distance, threshold_rel=threshold_rel
    )
    print(f"detected {points.shape[0]} points")
    return points
