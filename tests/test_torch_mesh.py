"""Meshes, watershed and agglomeration on the CPU, port against JAX.

The port's host C++ copies (``csrc/host/surface_nets.cpp``,
``watershed.cpp``) and ``flow/mesh.py`` against the JAX package's
``native`` and ``flow/mesh.py``, in one process on seeded fixtures (those
of ``tests/test_native.py`` and ``tests/flow/test_cli.py``'s mesh test):
vertices, faces and segmentations bitwise, fragment files, manifests and
obj/ply text byte for byte, and ``mesh-manifest`` and ``download-mesh``
through both CLIs. Ids at or above 2^32 mesh as their value mod 2^32 in
both packages (``mesh_object`` casts to uint32, as the JAX one does).
"""
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from chunkflow_tpu import native as jax_native
from chunkflow_tpu.chunk import AffinityMap as JaxAffinityMap
from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.flow import mesh as jax_mesh
from chunkflow_tpu.flow.cli import main as jax_main
from chunkflow_tpu_torch import native
from chunkflow_tpu_torch.chunk.base import Chunk
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.flow import mesh

torch.set_num_threads(1)


def _ball(shape, center, radius):
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    d2 = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2
          + (xx - center[2]) ** 2)
    return (d2 <= radius ** 2).astype(np.uint32)


def _torus():
    shape = (24, 48, 48)
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    ring = np.sqrt((yy - 23.5) ** 2 + (xx - 23.5) ** 2) - 14.0
    return ((ring ** 2 + (zz - 11.5) ** 2) <= 25.0).astype(np.uint32)


def _touching():
    seg = np.zeros((16, 16, 16), np.uint32)
    ball = _ball((16, 16, 16), (7.5, 7.5, 7.5), 6.0)
    seg[:8] = ball[:8]
    seg[8:] = ball[8:] * 2
    return seg


def _cube():
    seg = np.zeros((6, 6, 6), np.uint32)
    seg[2:4, 2:4, 2:4] = 1
    return seg


def _two_objects():
    arr = np.zeros((8, 8, 8), np.uint32)
    arr[1:4, 1:4, 1:4] = 1
    arr[5:7, 5:7, 5:7] = 2
    return arr


def _cli_seg():
    """``tests/flow/test_cli.py``'s mesh fixture: two touching boxes of
    object 7."""
    seg = np.zeros((8, 16, 16), np.uint32)
    seg[2:6, 2:14, 2:8] = 7
    seg[2:6, 2:14, 8:14] = 7
    return seg


SEGS = {
    "cube": (_cube, 1),
    "absent": (lambda: np.zeros((4, 4, 4), np.uint32), 7),
    "sphere": (lambda: _ball((64, 64, 64), (31.5, 31.5, 31.5), 20.0), 1),
    "torus": (_torus, 1),
    "touching-1": (_touching, 1),
    "touching-2": (_touching, 2),
    "cli": (_cli_seg, 7),
}


def _edge_counts(faces):
    from collections import Counter

    edges = Counter()
    for tri in faces:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            edges[tuple(sorted((int(tri[a]), int(tri[b]))))] += 1
    return edges


@pytest.mark.parametrize("name", sorted(SEGS))
def test_mesh_object_is_the_jax_packages(name):
    make, obj = SEGS[name]
    seg = make()
    vertices, faces = native.mesh_object(seg, obj)
    want_v, want_f = jax_native.mesh_object(seg, obj)
    assert vertices.dtype == want_v.dtype and faces.dtype == want_f.dtype
    assert np.array_equal(vertices, want_v) and np.array_equal(faces, want_f)
    if faces.shape[0]:
        assert set(_edge_counts(faces).values()) == {2}  # closed


def test_ids_past_uint32_mesh_as_the_jax_package_does():
    """An id >= 2^32 is passed as ``c_uint32`` and the labels cast to
    uint32 in both packages, so objects equal mod 2^32 share one mesh.
    Phase 16's ids stay below 2^32."""
    seg = np.zeros((8, 8, 16), np.uint64)
    seg[2:5, 2:5, 2:5] = 5
    seg[2:5, 2:5, 9:12] = 5 + (1 << 32)
    big = native.mesh_object(seg, 5 + (1 << 32))
    want = jax_native.mesh_object(seg, 5 + (1 << 32))
    assert all(np.array_equal(a, b) for a, b in zip(big, want))
    small = native.mesh_object(seg, 5)
    assert all(np.array_equal(a, b) for a, b in zip(big, small))
    assert big[1].shape[0] == 2 * native.mesh_object(
        (seg == 5).astype(np.uint32), 1)[1].shape[0]


def test_mesh_chunk_nm_scaling_is_the_jax_packages():
    arr = _ball((32, 32, 32), (15.5, 15.5, 15.5), 10.0)
    got = mesh.mesh_chunk(Chunk(arr, voxel_offset=(100, 200, 300),
                                voxel_size=(40, 8, 8)))
    want = jax_mesh.mesh_chunk(JaxChunk(arr, voxel_offset=(100, 200, 300),
                                        voxel_size=(40, 8, 8)))
    assert got.keys() == want.keys() == {1}
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cell", [0.0, 8.0, 20.0])
def test_simplify_mesh_is_the_jax_packages(cell):
    vertices, faces = native.mesh_object(
        _ball((64, 64, 64), (31.5, 31.5, 31.5), 20.0), 1)
    got = mesh.simplify_mesh(vertices * 4.0, faces, cell)
    want = jax_mesh.simplify_mesh(vertices * 4.0, faces, cell)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _files(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("fmt, manifest, error", [
    ("precomputed", True, 0.0), ("precomputed", False, 6.0),
    ("obj", False, 0.0), ("ply", False, 0.0), ("ply", False, 6.0)])
def test_mesh_operator_writes_the_jax_packages_files(tmp_path, fmt,
                                                     manifest, error):
    """``tests/test_native.py``'s two objects, meshed in two chunks of
    one volume, so an object's manifest lists a fragment per chunk."""
    arr = _two_objects()
    for tag, op_cls, chunk_cls in (("port", mesh.MeshOperator, Chunk),
                                   ("jax", jax_mesh.MeshOperator, JaxChunk)):
        op = op_cls(str(tmp_path / tag), output_format=fmt,
                    manifest=manifest, simplification_error_nm=error)
        for z in (0, 4):
            assert op(chunk_cls(arr[z:z + 4].copy(), voxel_offset=(z, 0, 0),
                                voxel_size=(40, 4, 4))) >= 1
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    if manifest:
        assert mesh.write_manifests(str(tmp_path / "port")) == 2
        assert jax_mesh.write_manifests(str(tmp_path / "jax")) == 2
        assert _files(tmp_path / "port") == _files(tmp_path / "jax")
        got = mesh.download_mesh(str(tmp_path / "port"), 1)
        want = jax_mesh.download_mesh(str(tmp_path / "jax"), 1)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert mesh.download_mesh(str(tmp_path / "port"), 3) is None


def test_precomputed_bytes_round_trip():
    vertices, faces = native.mesh_object(_cube(), 1)
    blob = mesh.to_precomputed_bytes(vertices, faces)
    assert blob == jax_mesh.to_precomputed_bytes(vertices, faces)
    back = mesh.from_precomputed_bytes(blob)
    assert np.array_equal(back[0], vertices)
    assert np.array_equal(back[1], faces)


def _jax_cli(args):
    result = CliRunner().invoke(jax_main, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.output


@pytest.mark.parametrize("fmt", ["obj", "ply"])
def test_mesh_commands_through_both_clis(tmp_path, capsys, fmt):
    """``tests/flow/test_cli.py:268``'s object 7 through ``load-npy |
    mesh --manifest``, then ``mesh-manifest`` and ``download-mesh`` (by id
    and by rank), in both CLIs: every file byte for byte."""
    npy = str(tmp_path / "seg.npy")
    np.save(npy, _cli_seg())
    for tag in ("port", "jax"):
        out = tmp_path / tag
        out.mkdir()
        chain = [
            ["load-npy", "-f", npy, "--voxel-offset", "2", "0", "0",
             "mesh", "-o", str(out / "mesh"), "--manifest", "--voxel-size",
             "40", "4", "4"],
            ["mesh-manifest", "-d", str(out / "mesh")],
            ["load-npy", "-f", npy, "download-mesh", "-v", str(out / "mesh"),
             "-i", "7", "-o", str(out / "id_"), "-f", fmt],
            ["load-npy", "-f", npy, "download-mesh", "-v", str(out / "mesh"),
             "--input", "chunk", "-s", "0", "-p", "1", "-o",
             str(out / "rank_"), "-f", fmt],
        ]
        for args in chain:
            if tag == "port":
                assert cli.main(["--device", "cpu", *args]) == 0
            else:
                _jax_cli(args)
    capsys.readouterr()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert _files(tmp_path / "port" / "mesh") == _files(
        tmp_path / "jax" / "mesh")
    for name in (f"id_7.{fmt}", f"rank_7.{fmt}"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes()
    fused = mesh.download_mesh(str(tmp_path / "port" / "mesh"), 7)
    assert set(_edge_counts(fused[1]).values()) == {2}


# ---------------------------------------------------------------------------
# watershed and agglomeration
# ---------------------------------------------------------------------------
def _voronoi_affinity_fixture(noise, inside, boundary, seed=0):
    rng = np.random.default_rng(seed)
    shape = (32, 64, 64)
    seeds = np.stack([rng.uniform(0, s, 12) for s in shape], axis=1)
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    pts = np.stack([zz, yy, xx], -1).reshape(-1, 3)
    d2 = ((pts[:, None, :] - seeds[None]) ** 2).sum(-1)
    gt = (d2.argmin(1) + 1).reshape(shape).astype(np.uint32)
    aff = np.asarray(JaxAffinityMap.from_segmentation(
        gt, inside=inside, boundary=boundary).array)
    aff = aff + rng.normal(0, noise, aff.shape).astype(np.float32)
    return np.clip(aff, 0, 1).astype(np.float32)


def _split_plane():
    aff = np.ones((3, 4, 8, 8), np.float32)
    aff[:, :, :, 4] = 0.05
    return aff


def _strong_boundary():
    aff = np.ones((3, 2, 4, 4), np.float32)
    aff[:, :, :, 2] = 0.8
    return aff


def _mixed_boundary():
    aff = np.ones((3, 2, 4, 8), np.float32)
    aff[:, :, :, 4] = 0.1
    aff[2, 0, 0, 4] = 0.9
    return aff


def _plateau():
    aff = np.full((3, 8, 16, 32), 0.5, np.float32)
    aff[:, :, :, :6] = 0.995
    aff[:, :, :, 26:] = 0.995
    return aff


def _noise():
    rng = np.random.default_rng(21)
    return np.clip(rng.normal(0.6, 0.2, (3, 8, 32, 32)), 0,
                   1).astype(np.float32)


AFFINITIES = {
    "split-plane": (_split_plane, (0.9, 0.2, 0.5), "mean"),
    "strong-boundary": (_strong_boundary, (0.9, 0.2, 0.5), "mean"),
    "strong-boundary-high": (_strong_boundary, (0.9, 0.2, 0.9), "mean"),
    "background": (lambda: np.full((3, 2, 4, 4), 0.01, np.float32),
                   (0.9, 0.2, 0.5), "mean"),
    "max": (_mixed_boundary, (0.95, 0.01, 0.6), "max"),
    "min": (_mixed_boundary, (0.95, 0.01, 0.6), "min"),
    "quantile50": (_noise, (0.9, 0.2, 0.55), "quantile50"),
    "plateau": (_plateau, (0.99, 0.3, 2.0), "mean"),
    "noise-fragments": (_noise, (0.9, 0.2, 0.0), "mean"),
    "noise": (_noise, (0.9, 0.2, 0.55), "mean"),
    "voronoi-clean": (lambda: _voronoi_affinity_fixture(0.05, 0.9, 0.1),
                      (0.9, 0.3, 0.5), "mean"),
    "voronoi-noisy": (lambda: _voronoi_affinity_fixture(0.15, 0.85, 0.15,
                                                        seed=1),
                      (0.9, 0.3, 0.5), "mean"),
}


@pytest.mark.parametrize("name", sorted(AFFINITIES))
def test_watershed_agglomerate_is_the_jax_packages(name):
    make, (t_high, t_low, merge), scoring = AFFINITIES[name]
    aff = make()
    seg, count = native.watershed_agglomerate(aff, t_high, t_low, merge,
                                              scoring=scoring)
    want, want_count = jax_native.watershed_agglomerate(
        aff, t_high, t_low, merge, scoring=scoring)
    assert count == want_count and seg.dtype == want.dtype
    assert np.array_equal(seg, want)


@pytest.mark.parametrize("threshold", [0.55, 0.8, 0.95])
def test_agglomerate_fragments_is_the_jax_packages(threshold):
    aff = _noise()
    frags, _ = native.watershed_agglomerate(aff, 0.9, 0.2, 0.0)
    frags = np.where(frags > 0, frags.astype(np.uint64) * 7 + 1000, 0)
    got = native.watershed_agglomerate(aff, merge_threshold=threshold,
                                       fragments=frags)
    want = jax_native.watershed_agglomerate(aff, merge_threshold=threshold,
                                            fragments=frags)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


@pytest.mark.parametrize("bad", ["median", "quantile101", "quantilex"])
def test_bad_scoring_raises_in_both(bad):
    aff = np.ones((3, 2, 4, 4), np.float32)
    for mod in (native, jax_native):
        with pytest.raises(ValueError, match="scoring"):
            mod.watershed_agglomerate(aff, scoring=bad)
    assert native.SCORING == jax_native.SCORING


def test_fragments_past_uint32_raise_in_both():
    aff = np.ones((3, 2, 4, 4), np.float32)
    frags = np.zeros((2, 4, 4), np.int64)
    frags[:, :, 2:] = 1 << 33
    for mod in (native, jax_native):
        with pytest.raises(ValueError, match="uint32"):
            mod.watershed_agglomerate(aff, fragments=frags)
