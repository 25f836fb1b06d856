"""TEASAR-lite skeletonization (the JAX package's
``plugins/skeletonize.py``), per object:

1. the distance transform (DBF) of the object's mask;
2. the root is the voxel of largest DBF;
3. one Dijkstra over the object's 26-connected voxel graph, weighted by
   the TEASAR penalty ``(1 - dbf/max_dbf)^4`` so paths hug the medial
   axis; then, again and again, the path to the farthest unvisited voxel
   joins the tree and the voxels within ``invalidation_scale * dbf`` of
   it are invalidated;
4. the paths form one tree rooted at the DBF maximum.

Returns {obj_id: Skeleton} with nodes in physical (nm) coordinates;
``output_path=...`` also writes precomputed fragments named
``<obj_id>:<bbox>``.

The JAX plugin computes each object's mask and distance transform over
the whole chunk. Here each object is cut to its bounding box grown by one
voxel (clipped to the chunk): that shell holds no voxel of the object, so
every distance, graph edge and weight is the whole chunk's, and every
coordinate is taken in the chunk's frame, as there. The fragment bytes
are the JAX plugin's (``tests/test_torch_skeletonize.py``).
"""
import os

import numpy as np
from scipy import ndimage, sparse
from scipy.sparse.csgraph import dijkstra

from chunkflow_tpu_torch.annotations.skeleton import Skeleton


def _object_graph(mask, dbf, voxel_size):
    """Sparse 26-connectivity graph over the object's voxels."""
    coords = np.argwhere(mask)
    index = -np.ones(mask.shape, dtype=np.int64)
    index[tuple(coords.T)] = np.arange(coords.shape[0])
    max_dbf = dbf.max()
    penalty = (1.0 - dbf / (max_dbf + 1e-6)) ** 4

    rows, cols, weights = [], [], []
    offsets = [
        (dz, dy, dx)
        for dz in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dz, dy, dx) > (0, 0, 0)
    ]
    vs = np.asarray(voxel_size, dtype=np.float32)
    for off in offsets:
        shifted = coords + off
        valid = np.all(
            (shifted >= 0) & (shifted < np.asarray(mask.shape)), axis=1
        )
        src = coords[valid]
        dst = shifted[valid]
        dst_idx = index[tuple(dst.T)]
        ok = dst_idx >= 0
        src = src[ok]
        dst_idx = dst_idx[ok]
        src_idx = index[tuple(src.T)]
        step = np.linalg.norm(np.asarray(off) * vs)
        w = step * (
            1.0 + 100.0 * (penalty[tuple(src.T)] + penalty[tuple(dst[ok].T)])
        )
        rows.append(src_idx)
        cols.append(dst_idx)
        weights.append(w)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    weights = np.concatenate(weights)
    n = coords.shape[0]
    graph = sparse.coo_matrix(
        (
            np.concatenate([weights, weights]),
            (np.concatenate([rows, cols]), np.concatenate([cols, rows])),
        ),
        shape=(n, n),
    ).tocsr()
    return coords, index, graph


def _skeletonize_object(mask, voxel_size, invalidation_scale=4.0,
                        max_paths=10000, origin=(0, 0, 0)):
    """``mask`` is a crop of the chunk whose first voxel lies at
    ``origin`` in the chunk's frame."""
    dbf = ndimage.distance_transform_edt(mask, sampling=voxel_size)
    coords, index, graph = _object_graph(mask, dbf, voxel_size)
    n = coords.shape[0]
    if n == 0:
        return None
    dbf_per_voxel = dbf[tuple(coords.T)]
    coords = coords + np.asarray(origin, dtype=np.int64)
    root = int(np.argmax(dbf_per_voxel))

    dist, predecessors = dijkstra(
        graph, indices=root, return_predecessors=True
    )
    visited = np.zeros(n, dtype=bool)
    vs = np.asarray(voxel_size, dtype=np.float32)

    nodes = []          # voxel indices into coords
    parents = []        # parallel: parent position in nodes (-1 root)
    node_of_voxel = {}

    def add_node(voxel_idx, parent_node):
        if voxel_idx in node_of_voxel:
            return node_of_voxel[voxel_idx]
        nodes.append(voxel_idx)
        parents.append(parent_node)
        node_of_voxel[voxel_idx] = len(nodes) - 1
        return len(nodes) - 1

    add_node(root, -1)
    visited[root] = True

    from scipy.spatial import cKDTree

    all_phys = coords * vs
    phys_tree = cKDTree(all_phys)

    for _ in range(max_paths):
        finite = np.isfinite(dist) & ~visited
        if not finite.any():
            break
        target = int(np.argmax(np.where(finite, dist, -np.inf)))
        # walk the predecessors back to a voxel already on the tree (not
        # merely invalidated: joining the tube of off-axis voxels around
        # a path would misattach the branch); the root is on the tree
        path = []
        v = target
        while v != -9999 and v not in node_of_voxel:
            path.append(v)
            v = int(predecessors[v])
            if v < 0:
                break
        join = v if v >= 0 and v in node_of_voxel else root
        parent_node = node_of_voxel[join]
        for voxel in reversed(path):
            parent_node = add_node(voxel, parent_node)
        # invalidate the voxels near the new path (ball queries)
        path_coords = coords[path] * vs
        radius = invalidation_scale * dbf_per_voxel[path] + 1e-3
        for pc, r in zip(path_coords, radius):
            visited[phys_tree.query_ball_point(pc, r)] = True
        visited[path] = True

    if (np.isfinite(dist) & ~visited).any():
        print(
            f"warning: skeleton truncated at max_paths={max_paths} with "
            "unvisited voxels remaining; pass a larger max_paths"
        )
    skeleton_nodes = coords[nodes] * vs
    return Skeleton(
        skeleton_nodes,
        np.asarray(parents),
        radii=dbf_per_voxel[nodes],
    )


def execute(
    seg,
    voxel_num_threshold: int = 100,
    invalidation_scale: float = 4.0,
    max_paths: int = 10000,
    output_path: str = None,
):
    arr = np.asarray(seg.host())
    if arr.ndim == 4:
        arr = arr[0]
    voxel_size = tuple(seg.voxel_size)
    skeletons = {}
    ids, inverse, counts = np.unique(arr, return_inverse=True,
                                     return_counts=True)
    # each id's bounding box, from its index among the ids
    boxes = ndimage.find_objects(inverse.reshape(arr.shape) + 1)
    for k, (obj_id, count) in enumerate(zip(ids, counts)):
        if obj_id == 0 or count < voxel_num_threshold:
            continue
        crop = tuple(slice(max(s.start - 1, 0), min(s.stop + 1, n))
                     for s, n in zip(boxes[k], arr.shape))
        skel = _skeletonize_object(
            arr[crop] == obj_id, voxel_size,
            invalidation_scale=invalidation_scale,
            max_paths=max_paths,
            origin=[s.start for s in crop],
        )
        if skel is not None and len(skel) > 1:
            # shift into global physical coordinates
            skel.nodes += seg.voxel_offset.vec * np.asarray(voxel_size)
            skeletons[int(obj_id)] = skel
    print(f"skeletonized {len(skeletons)} objects")
    if output_path:
        os.makedirs(output_path, exist_ok=True)
        bbox_str = seg.bbox.string
        for obj_id, skel in skeletons.items():
            with open(
                os.path.join(output_path, f"{obj_id}:{bbox_str}"), "wb"
            ) as f:
                f.write(skel.to_precomputed_bytes())
    return skeletons
