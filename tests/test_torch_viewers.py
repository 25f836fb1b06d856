"""The port's viewers against the JAX package's, on the CPU.

A stub ``neuroglancer`` module (a copy of the one in
``tests/flow/test_viewers.py``) records every layer each package's
``build_layers`` makes from the same chunks, synapses, point clouds and
skeletons: the records are equal, arrays bitwise. The napari dispatch
and ``serve_neuroglancer`` run under stubs too. ``view --screenshot``
writes the same PNG bytes from both CLIs, and ``neuroglancer`` and
``napari`` fail with the same message where their package is missing.
"""
import contextlib
import sys
import types

import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.chunk.base import LayerType as JaxLayerType
from chunkflow_tpu.flow import viewers as jax_viewers
from chunkflow_tpu_torch.chunk.base import Chunk, LayerType
from chunkflow_tpu_torch.flow import viewers
from tests.test_torch_annotations import JAX, PORT, point_cloud, synapses

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)


class _Record:
    """A stand-in that records its constructor's arguments."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs


class _Layers:
    def __init__(self):
        self.entries = []

    def append(self, name=None, layer=None, **kwargs):
        assert name is not None and layer is not None
        self.entries.append({"name": name, "layer": layer, **kwargs})


class _Txn:
    def __init__(self):
        self.layers = _Layers()


@pytest.fixture
def stub_ng(monkeypatch):
    ng = types.ModuleType("neuroglancer")
    for cls in (
        "CoordinateSpace",
        "LocalVolume",
        "LocalAnnotationLayer",
        "AnnotationPropertySpec",
        "PointAnnotation",
        "LineAnnotation",
    ):
        setattr(ng, cls, type(cls, (_Record,), {}))
    monkeypatch.setitem(sys.modules, "neuroglancer", ng)
    return ng


def record(value):
    """A recorded layer as plain data; arrays with dtype and shape."""
    if isinstance(value, _Record):
        return (type(value).__name__, record(list(value.args)),
                record(value.kwargs))
    if isinstance(value, dict):
        return {k: record(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [record(v) for v in value])
    if isinstance(value, np.ndarray):
        return ("array", str(value.dtype), value.shape,
                np.ascontiguousarray(value).tobytes())
    if isinstance(value, np.generic):
        return ("scalar", str(value.dtype), value.item())
    return (type(value).__name__, value)


def _chunk(cls, layer_type, dtype=np.float32, nchan=None):
    shape = (4, 8, 8) if nchan is None else (nchan, 4, 8, 8)
    arr = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    if np.issubdtype(np.dtype(dtype), np.integer) or dtype is bool:
        arr = (arr % 5).astype(dtype)
    else:
        arr = (arr / arr.max()).astype(dtype)
    layer = (LayerType if cls is Chunk else JaxLayerType)(layer_type)
    return cls(arr, voxel_offset=(1, 2, 3), voxel_size=(40, 8, 8),
               layer_type=layer)


class _Skel:
    """A skeleton as the reference's viewer reads one."""
    vertices = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.5, 7, 8]])
    edges = np.array([[0, 1], [1, 2]])


def _datas(which):
    cls, ns = (Chunk, PORT) if which == "port" else (JaxChunk, JAX)
    return {
        "img": _chunk(cls, "image"),
        "img-u8": _chunk(cls, "image", dtype=np.uint8),
        "seg": _chunk(cls, "segmentation", dtype=np.uint32),
        "seg-bool": _chunk(cls, "segmentation", dtype=bool),
        "seg-int64": _chunk(cls, "segmentation", dtype=np.int64),
        "seg-u8": _chunk(cls, "segmentation", dtype=np.uint8),
        "seg-4d": _chunk(cls, "segmentation", dtype=np.uint64, nchan=1),
        "aff": _chunk(cls, "affinity_map", nchan=3),
        "prob": _chunk(cls, "probability_map", nchan=1),
        "prob-2": _chunk(cls, "probability_map", nchan=2),
        "prob-3d": _chunk(cls, "probability_map"),
        "prob-f64": _chunk(cls, "probability_map", dtype=np.float64,
                           nchan=3),
        "rgb": _chunk(cls, "image", nchan=2),
        "syn": synapses(ns),
        "syn-pre-only": synapses(ns, post=None, post_confidence=None),
        "pts": point_cloud(ns),
        "raw_pts": np.array([[7, 8, 9], [1, 2, 3]]),
        "skel": {42: _Skel(), 7: _Skel()},
        "empty-skel": {},
        "none": None,
    }


@pytest.mark.parametrize("name", sorted(_datas("port")))
def test_build_layers_matches_jax(stub_ng, name):
    got, ref = _Txn(), _Txn()
    n = viewers.build_layers(got, {name: _datas("port")[name]})
    m = jax_viewers.build_layers(ref, {name: _datas("jax")[name]})
    assert n == m
    assert record(got.layers.entries) == record(ref.layers.entries)


def test_build_layers_all_at_once_and_voxel_size(stub_ng):
    got, ref = _Txn(), _Txn()
    assert viewers.build_layers(got, _datas("port"), voxel_size=(4, 4, 4)) \
        == jax_viewers.build_layers(ref, _datas("jax"), voxel_size=(4, 4, 4))
    assert record(got.layers.entries) == record(ref.layers.entries)
    assert len(got.layers.entries) == 21  # synapses make two layers each


def test_build_layers_rejects_the_unknown_alike(stub_ng):
    for module in (viewers, jax_viewers):
        with pytest.raises(ValueError, match="cannot render 'bad' of type"):
            module.build_layers(_Txn(), {"bad": object()})


def test_napari_layers_match_jax():
    calls = {}

    def viewer(tag):
        calls[tag] = []

        class _Viewer:
            def add_labels(self, arr, name=None):
                calls[tag].append(("labels", name, record(arr)))

            def add_image(self, arr, name=None):
                calls[tag].append(("image", name, record(arr)))

        return _Viewer()

    keys = ("seg", "img", "aff", "none")
    got = viewers.add_napari_layers(
        viewer("port"), {k: _datas("port")[k] for k in keys})
    ref = jax_viewers.add_napari_layers(
        viewer("jax"), {k: _datas("jax")[k] for k in keys})
    assert got == ref == 3
    assert calls["port"] == calls["jax"]


def test_serve_neuroglancer_matches_jax(stub_ng):
    served, txns = [], []

    class _Viewer:
        def txn(self):
            @contextlib.contextmanager
            def cm():
                txns.append(_Txn())
                yield txns[-1]

            return cm()

        def get_viewer_url(self):
            return "http://stub"

    stub_ng.set_server_bind_address = lambda **kw: served.append(kw)
    stub_ng.Viewer = _Viewer
    for module, which in ((viewers, "port"), (jax_viewers, "jax")):
        module.serve_neuroglancer(
            {k: _datas(which)[k] for k in ("img", "syn")}, port=9,
            voxel_size=(4, 4, 4), blocking=False)
    assert served[0] == served[1] == {"bind_address": "0.0.0.0",
                                      "bind_port": 9}
    assert record(txns[0].layers.entries) == record(txns[1].layers.entries)


# ---------------------------------------------------------------------------
# the viewer commands through both CLIs
# ---------------------------------------------------------------------------
def _run_clis(argv):
    """(port error or None, JAX error or None) of one command line."""
    from click.testing import CliRunner

    from chunkflow_tpu.flow.cli import main as jax_main
    from chunkflow_tpu_torch.flow import cli

    try:
        cli.main(["--device", "cpu", *argv])
        port = None
    except SystemExit as exc:
        port = str(exc)
    result = CliRunner().invoke(jax_main, argv)
    jax = None
    if result.exit_code:
        jax = result.output.strip().removeprefix("Error: ")
    return port, jax


@pytest.mark.parametrize("with_seg", [False, True])
def test_view_screenshot_is_the_jax_png(tmp_path, with_seg):
    pytest.importorskip("matplotlib")
    from click.testing import CliRunner

    from chunkflow_tpu.flow.cli import main as jax_main
    from chunkflow_tpu_torch.flow import cli

    rng = np.random.default_rng(51)
    np.save(tmp_path / "img.npy", rng.integers(0, 256, (5, 24, 32)).astype(
        np.uint8))
    np.save(tmp_path / "seg.npy", rng.integers(0, 600, (1, 5, 24, 32)).astype(
        np.uint32))

    def argv(out):
        loads = ["load-npy", "-f", str(tmp_path / "img.npy"), "-o", "img"]
        view = ["view", "--image-chunk-name", "img", "--screenshot", str(out)]
        if with_seg:
            loads += ["load-npy", "-f", str(tmp_path / "seg.npy"), "-o",
                      "seg"]
            view += ["--segmentation-chunk-name", "seg"]
        return loads + view

    port_png, jax_png = tmp_path / "port.png", tmp_path / "jax.png"
    assert cli.main(["--device", "cpu", *argv(port_png)]) == 0
    result = CliRunner().invoke(jax_main, argv(jax_png))
    assert result.exit_code == 0, result.output
    got, ref = port_png.read_bytes(), jax_png.read_bytes()
    assert got[:8] == b"\x89PNG\r\n\x1a\n" and got == ref


@pytest.mark.parametrize("command, package", [
    (["neuroglancer", "-c", "chunk", "-p", "0"], "neuroglancer"),
    (["napari", "-c", "chunk"], "napari")])
def test_missing_viewer_package_fails_like_jax(command, package):
    if package in sys.modules or _importable(package):
        pytest.skip(f"{package} is installed here")
    port, jax = _run_clis(["create-chunk", "--size", "4", "8", "8", *command])
    assert port is not None and port == jax
    assert f"the {package} package is not installed" in port


def _importable(name):
    import importlib.util

    return importlib.util.find_spec(name) is not None
