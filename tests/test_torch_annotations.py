"""The port's annotations against the JAX package's, on the CPU.

Every public method and property of ``Synapses``, ``PointCloud`` and
``Skeleton`` runs in both packages on the same seeded inputs and gives
equal arrays (dtype included) and values. Files are held byte for byte:
JSON, SWC, npy, precomputed skeleton bytes, the DVID element list and
the NeuTu task (its ``metadata.date`` set aside); HDF5 by a cross-read
(each package reads the other's file). The cases of
``tests/test_annotations.py`` then run on the port.
"""
import json
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chunkflow_tpu.annotations.point_cloud import PointCloud as JaxPointCloud
from chunkflow_tpu.annotations.skeleton import Skeleton as JaxSkeleton
from chunkflow_tpu.annotations.synapses import Synapses as JaxSynapses
from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.chunk.segmentation import Segmentation as JaxSegmentation
from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
from chunkflow_tpu_torch.annotations import PointCloud, Synapses
from chunkflow_tpu_torch.annotations.skeleton import Skeleton
from chunkflow_tpu_torch.chunk.base import Chunk
from chunkflow_tpu_torch.chunk.segmentation import Segmentation
from chunkflow_tpu_torch.core.bbox import BoundingBox

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

JAX = SimpleNamespace(Synapses=JaxSynapses, PointCloud=JaxPointCloud,
                      Skeleton=JaxSkeleton, BoundingBox=JaxBox,
                      Chunk=JaxChunk, Segmentation=JaxSegmentation)
PORT = SimpleNamespace(Synapses=Synapses, PointCloud=PointCloud,
                       Skeleton=Skeleton, BoundingBox=BoundingBox,
                       Chunk=Chunk, Segmentation=Segmentation)


def canon(value):
    """A result of either package as plain data: arrays as (dtype, shape,
    values), annotations as their arrays, boxes as their corners."""
    if isinstance(value, (Synapses, JaxSynapses)):
        return ("synapses", canon(value.pre), canon(value.post),
                canon(value.pre_confidence), canon(value.post_confidence),
                tuple(value.resolution), value.users)
    if isinstance(value, (PointCloud, JaxPointCloud)):
        return ("points", canon(value.points), tuple(value.voxel_size))
    if isinstance(value, (Skeleton, JaxSkeleton)):
        return ("skeleton", canon(value.nodes), canon(value.parents),
                canon(value.radii), canon(value.node_types))
    if isinstance(value, (BoundingBox, JaxBox)):
        return ("box", tuple(value.start), tuple(value.stop))
    if isinstance(value, np.ndarray):
        return ("array", str(value.dtype), value.shape,
                value.tobytes() if value.dtype.kind != "O"
                else value.tolist())
    if isinstance(value, np.generic):
        return ("scalar", str(value.dtype), value.item())
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return ("cartesian", tuple(value))
    if isinstance(value, (set, frozenset)):
        return ("set", sorted(canon(v) for v in value))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [canon(v) for v in value])
    if isinstance(value, dict):
        return ("dict", {k: canon(v) for k, v in value.items()})
    return (type(value).__name__, value)


def assert_same(got, ref):
    assert canon(got) == canon(ref)


# ---------------------------------------------------------------------------
# seeded inputs, one per package
# ---------------------------------------------------------------------------
def _synapse_arrays(seed=41):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 24, (30, 3)).astype(np.int32)
    pre[5] = pre[2]  # a duplicate T-bar
    pre_of_post = np.sort(rng.integers(0, 30, 70))
    pre_of_post = pre_of_post[pre_of_post != 7]  # a T-bar without posts
    post = np.concatenate(
        [pre_of_post[:, None],
         pre[pre_of_post] + rng.integers(-3, 4, (pre_of_post.size, 3))],
        axis=1).astype(np.int32)
    post[3, 1:] = post[2, 1:]  # two posts of one T-bar at one place
    return dict(pre=pre, post=post,
                pre_confidence=rng.random(30).astype(np.float32),
                post_confidence=rng.random(post.shape[0]).astype(np.float32),
                resolution=(40, 4, 4), users=["ann", "bob"])


def synapses(ns, seed=41, **overrides):
    arrays = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in {**_synapse_arrays(seed), **overrides}.items()}
    return ns.Synapses(**arrays)


def segmentation(ns):
    """Labels over the synapses' box (offset 1, 2, 3): few ids, so posts of
    one T-bar share neurons."""
    rng = np.random.default_rng(42)
    arr = (rng.integers(0, 4, (26, 28, 28)) * 3).astype(np.uint32)
    return ns.Segmentation(arr, voxel_offset=(1, 2, 3), voxel_size=(40, 4, 4))


def skeleton(ns, n=25, seed=43):
    rng = np.random.default_rng(seed)
    parents = np.array([-1] + [int(rng.integers(0, i)) for i in range(1, n)])
    parents[n // 2] = -1  # a second tree
    return ns.Skeleton(rng.random((n, 3)).astype(np.float32) * 1000,
                       parents,
                       radii=rng.random(n).astype(np.float32) * 50,
                       node_types=rng.integers(0, 5, n))


def point_cloud(ns):
    rng = np.random.default_rng(44)
    return ns.PointCloud(rng.integers(-5, 30, (20, 3)), voxel_size=(40, 4, 4))


# ---------------------------------------------------------------------------
# every public method, both packages
# ---------------------------------------------------------------------------
def _mutated(method, *args):
    """Run an in-place editor and return the edited synapses."""
    def run(ns):
        s = synapses(ns)
        getattr(s, method)(*args)
        return s
    return run


SYNAPSE_CASES = {
    "pre_num": lambda ns: synapses(ns).pre_num,
    "post_num": lambda ns: synapses(ns).post_num,
    "len": lambda ns: len(synapses(ns)),
    "eq": lambda ns: (synapses(ns) == synapses(ns),
                      synapses(ns) == synapses(ns, seed=1)),
    "pre_bbox": lambda ns: synapses(ns).pre_bbox,
    "post_positions": lambda ns: synapses(ns).post_positions,
    "post_positions-none": lambda ns: synapses(ns, post=None,
                                               post_confidence=None
                                               ).post_positions,
    "post_indices_of_pre": lambda ns: [synapses(ns).post_indices_of_pre(i)
                                       for i in (0, 7, 29)],
    "pre_with_post_num": lambda ns: synapses(ns).pre_with_post_num,
    "distances_from_pre_to_post":
        lambda ns: synapses(ns).distances_from_pre_to_post(),
    "find_redundant_post": lambda ns: [synapses(ns).find_redundant_post(d)
                                       for d in (0.5, 10.0, 40.0)],
    "find_duplicate_post_on_same_neuron":
        lambda ns: synapses(ns).find_duplicate_post_on_same_neuron(
            segmentation(ns)),
    "filter_by_bbox": lambda ns: synapses(ns).filter_by_bbox(
        ns.BoundingBox((2, 3, 4), (18, 20, 22))),
    "remove_pre_without_post": lambda ns: synapses(
        ns).remove_pre_without_post(),
    "pre_bounding_box": lambda ns: synapses(ns).pre_bounding_box,
    "post_bounding_box": lambda ns: synapses(ns).post_bounding_box(),
    "bounding_box": lambda ns: synapses(ns).bounding_box,
    "post_coordinates": lambda ns: synapses(ns).post_coordinates,
    "pre_with_physical_coordinate":
        lambda ns: synapses(ns).pre_with_physical_coordinate,
    "post_with_physical_coordinate":
        lambda ns: synapses(ns).post_with_physical_coordinate,
    "pre_point_cloud": lambda ns: synapses(ns).pre_point_cloud,
    "post_point_cloud": lambda ns: synapses(ns).post_point_cloud,
    "pre_index2post_indices": lambda ns: synapses(ns).pre_index2post_indices,
    "post_synapse_num_list": lambda ns: synapses(ns).post_synapse_num_list,
    "pre_indices_without_post":
        lambda ns: synapses(ns).pre_indices_without_post,
    "add_pre": lambda ns: synapses(ns).add_pre(
        np.array([[1, 2, 3], [4, 5, 6]], np.int32), confidence=0.25),
    "remove_pre": _mutated("remove_pre", [0, 7, 11]),
    "remove_pre_duplicates": _mutated("remove_pre_duplicates"),
    "remove_synapses_without_post": _mutated("remove_synapses_without_post"),
    "remove_synapses_outside_bounding_box": lambda ns: _mutated(
        "remove_synapses_outside_bounding_box",
        ns.BoundingBox((0, 0, 0), (12, 14, 16)))(ns),
    "transpose_axis": _mutated("transpose_axis"),
    "user_id": lambda ns: [synapses(ns).user_id(u)
                           for u in ("ann", "bob", "eve")],
    "find_redundent_post": lambda ns: [
        synapses(ns).find_redundent_post(num_threshold=n,
                                         distance_threshold=d)
        for n, d in ((15, 50.0), (1, 100.0), (2, 2.5))],
    "json_dict": lambda ns: synapses(ns).json_dict,
    "from_dict": lambda ns: ns.Synapses.from_dict(synapses(ns).json_dict),
    "to_dvid_list_of_dict": lambda ns: synapses(ns).to_dvid_list_of_dict(
        user="tester", comment="seeded"),
    "from_dvid_list": lambda ns: ns.Synapses.from_dvid_list(
        synapses(ns).to_dvid_list_of_dict(), resolution=(8, 8, 8)),
    "empty": lambda ns: ns.Synapses(np.zeros((0,), np.int32),
                                    post=np.zeros((0,), np.int32)),
}


@pytest.mark.parametrize("case", sorted(SYNAPSE_CASES))
def test_synapses_method_matches_jax(case):
    assert_same(SYNAPSE_CASES[case](PORT), SYNAPSE_CASES[case](JAX))


@pytest.mark.parametrize("bad", [
    dict(pre=np.zeros((2, 2), np.int32)),
    dict(pre=np.zeros((1, 3), np.int32), post=np.array([[5, 0, 0, 0]])),
    dict(pre=np.zeros((1, 3), np.int32), post=np.array([[-1, 0, 0, 0]])),
    dict(pre=np.zeros((1, 3), np.int32), post=np.zeros((2, 3), np.int32)),
], ids=["pre-shape", "post-index-high", "post-index-low", "post-shape"])
def test_synapse_validation_matches_jax(bad):
    for ns in (JAX, PORT):
        with pytest.raises(ValueError) as info:
            ns.Synapses(**bad)
        if ns is JAX:
            want = str(info.value)
    assert str(info.value) == want


POINT_CASES = {
    "len": lambda ns, tmp: len(point_cloud(ns)),
    "point_num": lambda ns, tmp: point_cloud(ns).point_num,
    "bbox": lambda ns, tmp: point_cloud(ns).bbox,
    "bounding_box": lambda ns, tmp: point_cloud(ns).bounding_box,
    "physical": lambda ns, tmp: point_cloud(ns).physical,
    "filter_by_bbox": lambda ns, tmp: point_cloud(ns).filter_by_bbox(
        ns.BoundingBox((0, 2, 4), (20, 22, 24))),
    "from_swc": lambda ns, tmp: ns.PointCloud.from_swc(
        skeleton(ns).to_swc(str(tmp / "pc.swc")), voxel_size=(40, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(POINT_CASES))
def test_point_cloud_method_matches_jax(case, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert_same(POINT_CASES[case](PORT, tmp_path / "port"),
                POINT_CASES[case](JAX, tmp_path / "jax"))


SKELETON_CASES = {
    "len": lambda ns: len(skeleton(ns)),
    "edges": lambda ns: skeleton(ns).edges,
    "cable_length": lambda ns: skeleton(ns).cable_length(),
    "cable_length-one-node": lambda ns: ns.Skeleton(
        np.ones((1, 3)), [-1]).cable_length(),
    "defaults": lambda ns: ns.Skeleton(np.arange(6).reshape(2, 3), [-1, 0]),
    "to_precomputed_bytes": lambda ns: skeleton(ns).to_precomputed_bytes(),
    "from_precomputed_bytes": lambda ns: ns.Skeleton.from_precomputed_bytes(
        skeleton(ns).to_precomputed_bytes()),
    "from_precomputed_bytes-minimal": lambda ns:
        ns.Skeleton.from_precomputed_bytes(
            skeleton(ns).to_precomputed_bytes()[:-25 * 4]),
}


@pytest.mark.parametrize("case", sorted(SKELETON_CASES))
def test_skeleton_method_matches_jax(case):
    assert_same(SKELETON_CASES[case](PORT), SKELETON_CASES[case](JAX))


def _shuffled_edge_blob(seed):
    """A precomputed blob of a random forest whose edge pairs are shuffled
    and flipped: the parents come from the walk alone."""
    rng = np.random.default_rng(seed)
    n = 40
    parents = [-1] + [int(rng.integers(0, i)) for i in range(1, n)]
    edges = np.array([(i, p) for i, p in enumerate(parents) if p >= 0])
    edges = edges[rng.permutation(len(edges))]
    flip = rng.random(len(edges)) < 0.5
    edges[flip] = edges[flip][:, ::-1]
    edges = edges[np.arange(len(edges)) % 7 != 3]  # cut into several trees
    blob = struct.pack("<II", n, len(edges))
    blob += rng.random((n, 3)).astype("<f4").tobytes()
    blob += edges.astype("<u4").tobytes()
    return blob


@pytest.mark.parametrize("seed", range(4))
def test_precomputed_parents_walk_in_the_jax_order(seed):
    """The walk pops the last entry, as the JAX package's does: the same
    parent arrays, root by root."""
    blob = _shuffled_edge_blob(seed)
    got = Skeleton.from_precomputed_bytes(blob)
    ref = JaxSkeleton.from_precomputed_bytes(blob)
    assert_same(got, ref)
    assert (got.parents == -1).sum() > 1


# ---------------------------------------------------------------------------
# files: byte for byte, h5 by a cross-read
# ---------------------------------------------------------------------------
def _write_both(tmp_path, name, write):
    paths = {}
    for tag, ns in (("jax", JAX), ("port", PORT)):
        paths[tag] = str(tmp_path / f"{tag}-{name}")
        write(ns, paths[tag])
    return paths


@pytest.mark.parametrize("variant", ["full", "no-post", "no-confidence",
                                     "empty"])
def test_synapse_json_is_the_jax_bytes(tmp_path, variant):
    overrides = {
        "full": {}, "no-post": dict(post=None, post_confidence=None),
        "no-confidence": dict(pre_confidence=None, post_confidence=None,
                              users=None),
        "empty": dict(pre=np.zeros((0, 3), np.int32),
                      post=np.zeros((0, 4), np.int32), pre_confidence=None,
                      post_confidence=None, users=None)}[variant]
    paths = _write_both(tmp_path, "syn.json",
                        lambda ns, p: synapses(ns, **overrides).to_file(p))
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    # each package reads the other's file into the same synapses
    assert_same(Synapses.from_file(paths["jax"]),
                JaxSynapses.from_file(paths["port"]))
    assert_same(Synapses.from_json(paths["port"]),
                JaxSynapses.from_json(paths["jax"]))


@pytest.mark.parametrize("variant", ["full", "no-post"])
def test_synapse_h5_cross_reads(tmp_path, variant):
    pytest.importorskip("h5py")
    overrides = ({} if variant == "full"
                 else dict(post=None, post_confidence=None))
    paths = _write_both(tmp_path, "syn.h5",
                        lambda ns, p: synapses(ns, **overrides).to_file(p))
    for path in paths.values():
        got, ref = Synapses.from_file(path), JaxSynapses.from_file(path)
        assert_same(got, ref)
        assert got == synapses(PORT, users=None, **overrides)


def test_unknown_synapse_file_raises_alike(tmp_path):
    for ns in (JAX, PORT):
        for call in (lambda: ns.Synapses.from_file("x.txt"),
                     lambda: synapses(ns).to_file(str(tmp_path / "x.csv"))):
            with pytest.raises(ValueError, match="unsupported synapse file"):
                call()


def test_neutu_task_is_the_jax_bytes_but_its_date(tmp_path):
    paths = _write_both(tmp_path, "task.json",
                        lambda ns, p: synapses(ns).to_neutu_task(
                            p, body_id=77))
    loaded = {}
    for tag, path in paths.items():
        with open(path) as f:
            loaded[tag] = json.load(f)
    dates = [loaded[tag]["metadata"].pop("date") for tag in loaded]
    assert all(len(d) > 10 for d in dates)
    assert loaded["port"] == loaded["jax"]
    # the bytes too, once the date is the same
    texts = {}
    for tag, path in paths.items():
        with open(path) as f:
            texts[tag] = f.read()
    assert texts["port"].replace(dates[1], dates[0]) == texts["jax"]
    for ns in (JAX, PORT):
        with pytest.raises(ValueError, match=".json"):
            synapses(ns).to_neutu_task(str(tmp_path / "task.txt"))


def test_dvid_list_is_the_jax_json():
    texts = {tag: json.dumps(synapses(ns).to_dvid_list_of_dict())
             for tag, ns in (("jax", JAX), ("port", PORT))}
    assert texts["port"] == texts["jax"]


@pytest.mark.parametrize("variant", ["seeded", "one-node", "with-offset"])
def test_swc_is_the_jax_bytes(tmp_path, variant):
    make = {"seeded": skeleton,
            "one-node": lambda ns: ns.Skeleton(np.ones((1, 3)), [-1]),
            "with-offset": lambda ns: ns.Skeleton(
                np.arange(15, dtype=np.float32).reshape(5, 3) * 40.5,
                [-1, 0, 1, 1, 3], radii=[1, 2, 3, 4, 5])}[variant]
    paths = _write_both(tmp_path, "s.swc", lambda ns, p: make(ns).to_swc(p))
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    assert_same(Skeleton.from_swc(paths["jax"]),
                JaxSkeleton.from_swc(paths["port"]))


def test_point_npy_is_the_jax_bytes_and_h5_cross_reads(tmp_path):
    paths = _write_both(tmp_path, "p.npy",
                        lambda ns, p: point_cloud(ns).to_npy(p))
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    pytest.importorskip("h5py")
    paths = _write_both(tmp_path, "p.h5",
                        lambda ns, p: point_cloud(ns).to_h5(p))
    for path in paths.values():
        assert_same(PointCloud.from_h5(path), JaxPointCloud.from_h5(path))
    assert_same(PointCloud.from_h5(paths["jax"]), point_cloud(PORT))


def test_duplicates_on_a_4d_segmentation_and_a_chunk_match_jax():
    arr = np.random.default_rng(45).integers(0, 3, (1, 26, 28, 28))
    for ns_arr in (arr.astype(np.uint32), arr.astype(np.uint64)):
        got = synapses(PORT).find_duplicate_post_on_same_neuron(
            Segmentation(ns_arr, voxel_offset=(1, 2, 3)))
        ref = synapses(JAX).find_duplicate_post_on_same_neuron(
            JaxSegmentation(ns_arr, voxel_offset=(1, 2, 3)))
        assert_same(got, ref)
        assert got.size > 0


# ---------------------------------------------------------------------------
# tests/test_annotations.py, on the port
# ---------------------------------------------------------------------------
@pytest.fixture
def fixture_synapses():
    pre = np.array([[10, 10, 10], [50, 50, 50], [90, 90, 90]], dtype=np.int32)
    post = np.array(
        [
            [0, 12, 10, 10],
            [0, 10, 14, 10],
            [1, 52, 50, 50],
        ],
        dtype=np.int32,
    )
    return Synapses(pre, post=post, resolution=(40, 4, 4))


class TestSynapses:
    def test_basic_counts(self, fixture_synapses):
        s = fixture_synapses
        assert s.pre_num == 3
        assert s.post_num == 3
        assert s.pre_with_post_num == 2
        assert s.post_indices_of_pre(0).tolist() == [0, 1]

    def test_distances(self, fixture_synapses):
        d = fixture_synapses.distances_from_pre_to_post()
        assert d.shape == (3,)
        np.testing.assert_allclose(d[0], 2 * 40)  # z offset of 2
        np.testing.assert_allclose(d[1], 4 * 4)   # y offset of 4

    def test_json_h5_roundtrip(self, fixture_synapses, tmp_path):
        suffixes = ["json"]
        try:
            import h5py  # noqa: F401
            suffixes.append("h5")
        except ImportError:
            pass
        for suffix in suffixes:
            path = str(tmp_path / f"syn.{suffix}")
            fixture_synapses.to_file(path)
            loaded = Synapses.from_file(path)
            assert loaded == fixture_synapses
            assert loaded.resolution == fixture_synapses.resolution

    def test_dvid_roundtrip(self, fixture_synapses):
        elements = fixture_synapses.to_dvid_list_of_dict(user="tester")
        kinds = [e["Kind"] for e in elements]
        assert kinds.count("PostSyn") == 3 and kinds.count("PreSyn") == 3
        pre0 = next(e for e in elements if e["Kind"] == "PreSyn")
        assert pre0["Pos"] == [10, 10, 10]
        assert {r["Rel"] for r in pre0["Rels"]} == {"PreSynTo"}
        back = Synapses.from_dvid_list(elements, resolution=(40, 4, 4))
        assert back == fixture_synapses

    def test_dvid_list_drops_orphan_posts(self):
        elements = [
            {"Kind": "PreSyn", "Pos": [1, 2, 3], "Prop": {}, "Rels": []},
            {"Kind": "PostSyn", "Pos": [9, 9, 9], "Prop": {},
             "Rels": [{"Rel": "PostSynTo", "To": [7, 7, 7]}]},
            {"Kind": "PostSyn", "Pos": [8, 8, 8], "Prop": {}, "Rels": []},
        ]
        syn = Synapses.from_dvid_list(elements)
        assert syn.pre_num == 1 and syn.post_num == 0

    def test_neutu_task_export(self, fixture_synapses, tmp_path):
        path = str(tmp_path / "task.json")
        fixture_synapses.to_neutu_task(path, body_id=77)
        with open(path) as f:
            task = json.load(f)
        assert task["metadata"]["coordinate system"] == "dvid"
        assert len(task["data"]) == fixture_synapses.pre_num
        assert task["data"][0] == {"body ID": 77, "location": [10, 10, 10]}
        with pytest.raises(ValueError):
            fixture_synapses.to_neutu_task(str(tmp_path / "task.txt"))

    def test_filter_by_bbox_remaps_indices(self, fixture_synapses):
        cropped = fixture_synapses.filter_by_bbox(
            BoundingBox((40, 40, 40), (100, 100, 100)))
        assert cropped.pre_num == 2
        assert cropped.post_num == 1
        assert cropped.post[0, 0] == 0
        np.testing.assert_array_equal(cropped.post[0, 1:], [52, 50, 50])

    def test_remove_pre_without_post(self, fixture_synapses):
        trimmed = fixture_synapses.remove_pre_without_post()
        assert trimmed.pre_num == 2
        assert trimmed.post_num == 3
        assert trimmed.post[:, 0].max() <= 1

    def test_redundant_post(self):
        pre = np.array([[0, 0, 0]], dtype=np.int32)
        post = np.array(
            [[0, 0, 0, 10], [0, 0, 0, 12], [0, 0, 0, 50]], dtype=np.int32
        )
        syn = Synapses(pre, post=post, resolution=(1, 1, 1))
        assert syn.find_redundant_post(5.0).tolist() == [1]

    def test_duplicate_on_same_neuron(self):
        seg_arr = np.zeros((4, 4, 4), dtype=np.uint32)
        seg_arr[:, :, :2] = 7
        pre = np.array([[0, 0, 0]], dtype=np.int32)
        post = np.array(
            [[0, 1, 1, 0], [0, 2, 2, 1], [0, 3, 3, 3]], dtype=np.int32
        )
        syn = Synapses(pre, post=post)
        dups = syn.find_duplicate_post_on_same_neuron(Chunk(seg_arr))
        assert dups.tolist() == [1]

    def test_validation(self):
        with pytest.raises(ValueError):
            Synapses(np.zeros((2, 2), dtype=np.int32))
        with pytest.raises(ValueError):
            Synapses(
                np.zeros((1, 3), dtype=np.int32),
                post=np.array([[5, 0, 0, 0]], dtype=np.int32),
            )


class TestPointCloud:
    def test_basics_and_io(self, tmp_path):
        points = np.array([[1, 2, 3], [7, 8, 9]], dtype=np.int64)
        pc = PointCloud(points, voxel_size=(40, 4, 4))
        assert len(pc) == 2
        assert pc.bbox == BoundingBox((1, 2, 3), (8, 9, 10))
        np.testing.assert_array_equal(pc.physical[0], [40, 8, 12])
        pytest.importorskip("h5py")
        path = str(tmp_path / "points.h5")
        pc.to_h5(path)
        np.testing.assert_array_equal(PointCloud.from_h5(path).points, points)

    def test_filter(self):
        pc = PointCloud(np.array([[0, 0, 0], [5, 5, 5], [9, 9, 9]]))
        assert len(pc.filter_by_bbox(BoundingBox((1, 1, 1), (8, 8, 8)))) == 1


class TestSkeleton:
    def _y_skeleton(self):
        nodes = np.array(
            [[0, 0, 0], [0, 10, 0], [0, 20, 0], [0, 15, 5], [0, 20, 10]],
            dtype=np.float32,
        )
        return Skeleton(nodes, np.array([-1, 0, 1, 1, 3]))

    def test_edges_and_length(self):
        skel = self._y_skeleton()
        assert skel.edges.shape == (4, 2)
        assert skel.cable_length() > 0

    def test_swc_roundtrip(self, tmp_path):
        skel = self._y_skeleton()
        path = str(tmp_path / "skel.swc")
        skel.to_swc(path)
        loaded = Skeleton.from_swc(path)
        np.testing.assert_allclose(loaded.nodes, skel.nodes)
        np.testing.assert_array_equal(loaded.parents, skel.parents)

    def test_precomputed_roundtrip(self):
        skel = self._y_skeleton()
        loaded = Skeleton.from_precomputed_bytes(skel.to_precomputed_bytes())
        assert len(loaded) == len(skel)
        np.testing.assert_allclose(loaded.nodes, skel.nodes)
        orig = {tuple(sorted(e)) for e in skel.edges.tolist()}
        back = {tuple(sorted(e)) for e in loaded.edges.tolist()}
        assert orig == back


class TestSynapsePlugins:
    def test_detect_pre_and_post(self):
        from chunkflow_tpu_torch.flow.plugin import load_plugin

        prob = np.zeros((8, 32, 32), dtype=np.float32)
        prob[4, 8, 8] = 1.0
        prob[4, 24, 24] = 0.9
        synapses_ = load_plugin("detect_pre_synapses")(Chunk(prob),
                                                        min_distance=3)
        assert synapses_.pre_num == 2
        post_prob = np.zeros((8, 32, 32), dtype=np.float32)
        post_prob[4, 10, 10] = 1.0
        with_post = load_plugin("detect_post_synapses")(
            synapses_, Chunk(post_prob), search_radius=5, min_distance=2)
        assert with_post.post_num == 1
        assert with_post.post[0, 0] in (0, 1)

    def test_find_tbar_object(self):
        from chunkflow_tpu_torch.flow.plugin import load_plugin

        seg_arr = np.zeros((8, 8, 8), dtype=np.uint32)
        seg_arr[2, 2, 2] = 42
        syn = Synapses(np.array([[2, 2, 2], [5, 5, 5]], dtype=np.int32))
        ids = load_plugin("find_tbar_object")(syn, Chunk(seg_arr))
        assert ids.tolist() == [42, 0]

    def test_adjust_pre(self):
        from chunkflow_tpu_torch.flow.plugin import load_plugin

        prob = np.zeros((8, 8, 8), dtype=np.float32)
        prob[3, 3, 3] = 1.0
        syn = Synapses(np.array([[2, 2, 2]], dtype=np.int32))
        moved = load_plugin("adjust_pre")(syn, Chunk(prob), window=2)
        np.testing.assert_array_equal(moved.pre[0], [3, 3, 3])


def test_skeleton_precomputed_undirected_edges():
    nodes = np.arange(12, dtype=np.float32).reshape(4, 3)
    blob = struct.pack("<II", 4, 3)
    blob += nodes[:, ::-1].astype("<f4").tobytes()
    blob += np.asarray([[0, 1], [2, 3], [0, 2]], dtype="<u4").tobytes()
    skel = Skeleton.from_precomputed_bytes(blob)
    assert len(skel) == 4
    assert int((skel.parents == -1).sum()) == 1
    assert skel.edges.shape[0] == 3
    root = int(np.nonzero(skel.parents == -1)[0][0])
    for i in range(4):
        seen, j = set(), i
        while skel.parents[j] != -1:
            assert j not in seen
            seen.add(j)
            j = int(skel.parents[j])
        assert j == root


def test_empty_synapses_json_roundtrip(tmp_path):
    empty = Synapses(np.zeros((0, 3), np.int32), np.zeros((0, 4), np.int32))
    path = str(tmp_path / "empty.json")
    empty.to_json(path)
    back = Synapses.from_json(path)
    assert back.pre_num == 0 and back.post_num == 0
    assert back == empty


def test_duplicate_post_4d_segmentation():
    seg = Segmentation(np.ones((1, 4, 4, 4), np.uint32))
    syn = Synapses(
        np.asarray([[1, 1, 1]], np.int32),
        np.asarray([[0, 1, 1, 2], [0, 2, 2, 2]], np.int32),
    )
    assert syn.find_duplicate_post_on_same_neuron(seg).tolist() == [1]


def test_skeleton_precomputed_radii_roundtrip():
    skel = Skeleton(np.arange(9, dtype=np.float32).reshape(3, 3), [-1, 0, 1],
                    radii=[3.0, 2.0, 1.0])
    back = Skeleton.from_precomputed_bytes(skel.to_precomputed_bytes())
    np.testing.assert_allclose(back.radii, [3.0, 2.0, 1.0])


def test_synapses_reference_api_surface():
    pre = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    post = np.array([[0, 1, 2, 4], [0, 1, 3, 3], [2, 7, 9, 9]], np.int32)
    s = Synapses(pre, post=post, resolution=(40, 4, 4))

    assert s.pre_bounding_box == s.pre_bbox
    assert s.bounding_box.contains((7, 9, 9))
    assert np.array_equal(s.post_coordinates, post[:, 1:])
    assert np.allclose(s.pre_with_physical_coordinate[0], [40, 8, 12])
    assert np.allclose(s.post_with_physical_coordinate[0, 1:], [40, 8, 16])
    assert s.pre_point_cloud.points.shape == (3, 3)
    assert s.post_point_cloud.points.shape == (3, 3)
    assert s.pre_index2post_indices == [[0, 1], [], [2]]
    assert s.post_synapse_num_list == [2, 0, 1]
    assert s.pre_indices_without_post == [1]
    assert Synapses.from_dict(s.json_dict) == s

    s3 = Synapses.from_dict(s.json_dict)
    s3.remove_pre([0])
    assert s3.pre_num == 2 and s3.post_num == 1
    assert s3.post[0, 0] == 1

    s4 = Synapses.from_dict(s.json_dict)
    s4.remove_synapses_without_post()
    assert s4.pre_num == 2 and s4.post_num == 3

    s5 = Synapses.from_dict(s.json_dict)
    s5.remove_synapses_outside_bounding_box(BoundingBox((0, 0, 0), (5, 6, 7)))
    assert s5.pre_num == 2

    s6 = Synapses.from_dict(s.json_dict)
    s6.add_pre(np.array([[1, 2, 3]], np.int32))
    assert s6.pre_num == 4
    s6.remove_pre_duplicates()
    assert s6.pre_num == 3
    assert s6.post_num == 3

    s8 = Synapses(np.array([[1, 2, 3]], np.int32))
    s8.remove_synapses_without_post()
    assert s8.pre_num == 1

    s7 = Synapses.from_dict(s.json_dict)
    s7.transpose_axis()
    assert tuple(s7.pre[0]) == (3, 2, 1)
    assert tuple(s7.resolution) == (4, 4, 40)
    assert tuple(s7.post[0, 1:]) == (4, 2, 1)

    assert s.find_redundent_post(distance_threshold=0.5) == {0, 1, 2}
    assert s.find_redundent_post(distance_threshold=1.0) == set()
    assert s.find_redundent_post(num_threshold=1,
                                 distance_threshold=100.0) == {1}


def test_annotations_package_exports():
    import chunkflow_tpu.annotations as jax_pkg
    import chunkflow_tpu_torch.annotations as pkg

    assert pkg.__all__ == jax_pkg.__all__
    assert os.path.basename(pkg.__file__) == "__init__.py"
