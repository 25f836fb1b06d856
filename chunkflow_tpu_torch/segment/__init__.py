"""The whole-volume segmentation plane: cross-chunk label stitching.

The port's copy of ``chunkflow_tpu/segment/``, a map -> reduce -> map
job over a chunk grid:

1. label (:func:`segment.stages.label_chunk`): each chunk labelled on
   its own, lifted into a collision-free global id space, saved
   blockwise, its six boundary faces written as sidecars;
2. merge (:func:`segment.stages.merge_node`): the face planes' edges
   merged bottom-up over a ``parallel.task_tree.SpatialTaskTree``; the
   root's union-find writes the global remap table;
3. relabel (:func:`segment.stages.relabel_chunk`): the remap applied per
   chunk, idempotently (canonical ids are fixpoints of the table).

Host numpy and host C++ as in the JAX package; the device leg labels a
chunk on the card (``device``).
"""
from chunkflow_tpu_torch.segment.merge_table import (  # noqa: F401
    face_pair_edges,
    labels_isomorphic,
    union_find,
)
from chunkflow_tpu_torch.segment.plan import SegmentPlan  # noqa: F401
from chunkflow_tpu_torch.segment.stages import (  # noqa: F401
    SegmentStore,
    execute_body,
)
from chunkflow_tpu_torch.segment.driver import (  # noqa: F401
    init_store,
    open_store,
    run_coordinator,
    run_local,
    segment_volume,
)
