"""Post-synapse detection around known T-bars: for each pre site, the
peaks of the post-synapse probability map within a search radius (nm)
(the JAX package's ``plugins/synapse/detect_post_synapses.py``)."""
import numpy as np

from chunkflow_tpu_torch.annotations.synapses import Synapses
from chunkflow_tpu_torch.chunk import ProbabilityMap


def execute(
    synapses,
    post_prob,
    search_radius: int = 50,
    min_distance: int = 5,
    threshold_rel: float = 0.3,
):
    pm = ProbabilityMap.from_chunk(post_prob.host())
    peaks, confidences = pm.detect_points(
        min_distance=min_distance, threshold_rel=threshold_rel
    )
    if peaks.shape[0] == 0:
        print("no post-synapse candidates found")
        return synapses

    res = np.asarray(tuple(post_prob.voxel_size), dtype=np.float32)
    post_rows = []
    post_conf = []
    for pre_index in range(synapses.pre_num):
        delta = (peaks - synapses.pre[pre_index]) * res
        close = np.nonzero(np.linalg.norm(delta, axis=1) <= search_radius)[0]
        for peak_index in close:
            post_rows.append(
                (pre_index, *peaks[peak_index].tolist())
            )
            post_conf.append(confidences[peak_index])
    post = (
        np.asarray(post_rows, dtype=np.int32)
        if post_rows
        else None
    )
    print(f"attached {len(post_rows)} post-synapses")
    return Synapses(
        synapses.pre,
        post=post,
        pre_confidence=synapses.pre_confidence,
        post_confidence=np.asarray(post_conf) if post_conf else None,
        resolution=synapses.resolution,
    )
