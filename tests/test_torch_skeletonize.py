"""The port's ``skeletonize`` and ``aggregate_skeleton_fragments``
plugins against the JAX package's, on the CPU.

The four shapes of ``tests/test_skeletonize.py`` and the bar of its
``test_skeletonize_plugin``, each skeletonized by both packages: the
port's skeletons pass the JAX test's checks and are the JAX skeletons,
fragment bytes included. The port cuts each object to its bounding box
grown by one voxel; seeded labellings with objects on every face of the
chunk, anisotropic voxels and an offset hold that cut to the JAX
plugin's bytes, and fragments of two adjacent crops aggregate into the
JAX package's bytes.
"""
import contextlib
import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

from chunkflow_tpu.chunk.segmentation import Segmentation as JaxSegmentation
from chunkflow_tpu.plugins import aggregate_skeleton_fragments as jax_agg
from chunkflow_tpu.plugins import skeletonize as jax_skeletonize
from chunkflow_tpu_torch.annotations.skeleton import Skeleton
from chunkflow_tpu_torch.chunk.segmentation import Segmentation
from chunkflow_tpu_torch.plugins import aggregate_skeleton_fragments as agg
from chunkflow_tpu_torch.plugins import skeletonize

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)


def _tree_is_valid(skel):
    n = len(skel)
    roots = np.nonzero(skel.parents == -1)[0]
    assert len(roots) == 1
    for i in range(n):
        j, hops = i, 0
        while skel.parents[j] != -1:
            j = int(skel.parents[j])
            hops += 1
            assert hops <= n
    return True


def both(seg, voxel_offset=(0, 0, 0), voxel_size=(1, 1, 1), **kwargs):
    """(port skeletons, JAX skeletons, what each printed): the same ids,
    and each skeleton's fragment bytes the same."""
    out = {}
    for tag, cls, module in (("port", Segmentation, skeletonize),
                             ("jax", JaxSegmentation, jax_skeletonize)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            skels = module.execute(cls(seg.copy(), voxel_offset=voxel_offset,
                                       voxel_size=voxel_size), **kwargs)
        out[tag] = (skels, buf.getvalue())
    (got, got_out), (ref, ref_out) = out["port"], out["jax"]
    assert sorted(got) == sorted(ref)
    for obj_id in ref:
        assert isinstance(got[obj_id], Skeleton)
        assert got[obj_id].to_precomputed_bytes() == \
            ref[obj_id].to_precomputed_bytes(), obj_id
        assert np.array_equal(got[obj_id].parents, ref[obj_id].parents)
        assert np.array_equal(got[obj_id].nodes, ref[obj_id].nodes)
    assert got_out == ref_out
    return got


def test_skeletonize_branching_object_topology():
    seg = np.zeros((3, 40, 40), dtype=np.uint32)
    seg[:, 18:22, 4:36] = 1          # bar along x
    seg[:, 4:30, 18:22] = 1          # stem along y, crossing the bar
    skels = both(seg, voxel_num_threshold=10)
    skel = skels[1]
    assert _tree_is_valid(skel)
    edges = skel.edges
    lengths = np.linalg.norm(
        skel.nodes[edges[:, 0]] - skel.nodes[edges[:, 1]], axis=1)
    assert lengths.max() <= 2.0
    assert skel.cable_length() > 35.0


def test_skeletonize_cylinder_centerline_accuracy():
    Z, R, CY, CX = 40, 5, 16, 16
    seg = np.zeros((Z, 32, 32), dtype=np.uint32)
    yy, xx = np.mgrid[0:32, 0:32]
    seg[:, (yy - CY) ** 2 + (xx - CX) ** 2 <= R ** 2] = 7
    skel = both(seg, voxel_num_threshold=10)[7]
    assert _tree_is_valid(skel)
    interior_z = (skel.nodes[:, 0] >= R) & (skel.nodes[:, 0] < Z - R)
    off_axis = np.linalg.norm(skel.nodes[interior_z, 1:] - [CY, CX], axis=1)
    assert off_axis.max() <= 2.0
    assert skel.nodes[:, 0].max() - skel.nodes[:, 0].min() >= Z - 4
    interior = (skel.nodes[:, 0] > 8) & (skel.nodes[:, 0] < Z - 8)
    assert interior.any()
    assert np.all(np.abs(skel.radii[interior] - R) <= 2.0)


def test_skeletonize_anisotropic_voxels():
    seg = np.zeros((20, 12, 12), dtype=np.uint32)
    seg[:, 4:8, 4:8] = 3
    skel = both(seg, voxel_size=(40, 4, 4), voxel_num_threshold=10)[3]
    assert _tree_is_valid(skel)
    assert skel.cable_length() >= 15 * 40
    assert skel.nodes[:, 1].max() < 8 * 4
    assert skel.nodes[:, 2].max() < 8 * 4


def test_skeletonize_disjoint_objects_and_threshold():
    seg = np.zeros((6, 30, 30), dtype=np.uint32)
    seg[:, 2:6, 2:28] = 1
    seg[:, 20:24, 2:28] = 2
    seg[0, 28, 28] = 5             # dust: below the threshold
    skels = both(seg, voxel_num_threshold=10)
    assert set(skels) == {1, 2}
    for skel in skels.values():
        assert _tree_is_valid(skel)
        assert skel.cable_length() > 20.0


def test_skeletonize_plugin(tmp_path):
    """``tests/test_annotations.py``'s case through both packages'
    ``plugin`` loaders: the same fragment file, aggregated into the same
    bytes."""
    from chunkflow_tpu.flow.plugin import load_plugin as jax_load
    from chunkflow_tpu_torch.flow.plugin import load_plugin

    arr = np.zeros((8, 8, 32), dtype=np.uint32)
    arr[2:6, 2:6, 2:30] = 1
    outs = {}
    for tag, load, cls in (("port", load_plugin, Segmentation),
                           ("jax", jax_load, JaxSegmentation)):
        frag_dir = str(tmp_path / tag / "skel")
        skeletons = load("skeletonize")(cls(arr, voxel_size=(1, 1, 1)),
                                        voxel_num_threshold=10,
                                        output_path=frag_dir)
        assert 1 in skeletons and len(skeletons[1]) > 3
        assert np.ptp(skeletons[1].nodes[:, 2]) > 15
        assert len(os.listdir(frag_dir)) == 1
        agg_dir = str(tmp_path / tag / "agg")
        assert load("aggregate_skeleton_fragments")(frag_dir, agg_dir) == 1
        outs[tag] = {name: (Path(d) / name).read_bytes()
                     for d in (frag_dir, agg_dir)
                     for name in os.listdir(d)}
    assert outs["port"] == outs["jax"]


def _labels(seed, shape=(12, 40, 40)):
    """A seeded labelling: smooth noise over its 65% quantile, components
    as ids (times 7, as uint64), so objects touch every face."""
    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.random(shape), 1.5)
    labels, _ = ndimage.label(field > np.quantile(field, 0.65))
    return labels.astype(np.uint64) * 7


@pytest.mark.parametrize("seed, voxel_size, max_paths", [
    (0, (1, 1, 1), 10000), (1, (40, 4, 4), 10000), (2, (40, 4, 4), 5),
    (3, (8, 8, 8), 30)])
def test_per_object_crop_is_the_jax_bytes(seed, voxel_size, max_paths):
    seg = _labels(seed)
    touching = {int(i) for face in (seg[0], seg[-1], seg[:, 0], seg[:, -1],
                                    seg[..., 0], seg[..., -1])
                for i in np.unique(face) if i}
    skels = both(seg, voxel_offset=(3, 50, 7), voxel_size=voxel_size,
                 voxel_num_threshold=20, max_paths=max_paths)
    assert len(skels) >= 2 and touching & set(skels)


def test_fragments_of_two_crops_aggregate_into_the_jax_bytes(tmp_path):
    """Two adjacent crops of one labelling: fragment files, the aggregated
    files written by each package from its own fragments, and the port
    aggregating the JAX package's fragments, byte for byte."""
    seg = _labels(4, (10, 32, 64))
    files = {}
    for tag, cls, sk, ag in (("port", Segmentation, skeletonize, agg),
                             ("jax", JaxSegmentation, jax_skeletonize,
                              jax_agg)):
        frag_dir = str(tmp_path / tag / "frags")
        with contextlib.redirect_stdout(io.StringIO()):
            for x0 in (0, 32):
                sk.execute(cls(seg[..., x0:x0 + 32].copy(),
                               voxel_offset=(2, 4, 100 + x0),
                               voxel_size=(40, 4, 4)),
                           voxel_num_threshold=15, output_path=frag_dir)
            count = ag.execute(frag_dir, str(tmp_path / tag / "agg"))
        files[tag] = {
            sub: {n: (tmp_path / tag / sub / n).read_bytes()
                  for n in os.listdir(tmp_path / tag / sub)}
            for sub in ("frags", "agg")}
        assert count == len(files[tag]["agg"])
    assert files["port"] == files["jax"]
    ids = {n.split(":")[0] for n in files["port"]["frags"]}
    assert set(files["port"]["agg"]) == ids
    assert any(sum(n.startswith(f"{i}:") for n in files["port"]["frags"]) > 1
               for i in ids), "no object spans both crops"
    for blob in files["port"]["agg"].values():
        assert _tree_is_valid(Skeleton.from_precomputed_bytes(blob))
    with contextlib.redirect_stdout(io.StringIO()):
        agg.execute(str(tmp_path / "jax" / "frags"),
                    str(tmp_path / "cross"), id_prefix="1")
    cross = {n: (tmp_path / "cross" / n).read_bytes()
             for n in os.listdir(tmp_path / "cross")}
    assert cross and all(n.startswith("1") for n in cross)
    assert cross == {n: b for n, b in files["jax"]["agg"].items()
                     if n.startswith("1")}
