"""Merge per-chunk skeleton fragments into one skeleton per object (the
JAX package's ``plugins/aggregate_skeleton_fragments.py``).

Fragments are files named ``<obj_id>:<bbox>`` in the precomputed
skeleton format; each object's fragments are concatenated in name order,
each fragment's roots joined to the nearest node merged before it, and
the result written as ``<obj_id>``.
"""
import os

import numpy as np

from chunkflow_tpu_torch.annotations.skeleton import Skeleton


def execute(fragment_dir: str, output_dir: str = None, id_prefix: str = None):
    output_dir = output_dir or fragment_dir
    by_id = {}
    for name in os.listdir(fragment_dir):
        if ":" not in name:
            continue
        obj_id = name.split(":")[0]
        if id_prefix and not obj_id.startswith(id_prefix):
            continue
        by_id.setdefault(obj_id, []).append(name)

    os.makedirs(output_dir, exist_ok=True)
    for obj_id, names in by_id.items():
        merged = None
        for name in sorted(names):
            with open(os.path.join(fragment_dir, name), "rb") as f:
                frag = Skeleton.from_precomputed_bytes(f.read())
            if merged is None:
                merged = frag
                continue
            base = len(merged)
            parents = frag.parents.copy()
            remapped = np.where(parents >= 0, parents + base, -1)
            # join the fragment's root(s) to the nearest merged node
            for root_local in np.nonzero(frag.parents == -1)[0]:
                dists = np.linalg.norm(
                    merged.nodes - frag.nodes[root_local], axis=1
                )
                remapped[root_local] = int(np.argmin(dists))
            merged = Skeleton(
                np.concatenate([merged.nodes, frag.nodes]),
                np.concatenate([merged.parents, remapped]),
                radii=np.concatenate([merged.radii, frag.radii]),
            )
        with open(os.path.join(output_dir, obj_id), "wb") as f:
            f.write(merged.to_precomputed_bytes())
    print(f"aggregated skeletons for {len(by_id)} objects")
    return len(by_id)
