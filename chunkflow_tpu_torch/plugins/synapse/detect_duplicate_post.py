"""Remove duplicate post-synapses: near-duplicates in space, and posts of
one T-bar on the same neuron of a segmentation (the JAX package's
``plugins/synapse/detect_duplicate_post.py``)."""
import numpy as np

from chunkflow_tpu_torch.annotations.synapses import Synapses


def execute(synapses, seg=None, distance_threshold: float = 10.0):
    drop = set(synapses.find_redundant_post(distance_threshold).tolist())
    if seg is not None:
        drop |= set(synapses.find_duplicate_post_on_same_neuron(seg).tolist())
    if not drop:
        print("no duplicate post-synapses")
        return synapses
    keep = np.asarray(
        [i for i in range(synapses.post_num) if i not in drop], dtype=np.int64
    )
    print(f"removed {len(drop)} duplicate post-synapses")
    return Synapses(
        synapses.pre,
        post=synapses.post[keep] if keep.size else None,
        pre_confidence=synapses.pre_confidence,
        post_confidence=(
            synapses.post_confidence[keep]
            if synapses.post_confidence is not None and keep.size
            else None
        ),
        resolution=synapses.resolution,
    )
