"""The port's ``plugin`` command and bundled plugins against the JAX
package's, on the CPU.

Each bundled plugin the port has runs through both CLIs' ``plugin``
command on the same seeded task (``tests/test_torch_cli_ops.py``'s
chunks): the tasks they leave are bitwise equal, dtype and metadata
included, and so is what they print or write. So does a user plugin
found through ``$CHUNKFLOW_PLUGIN_DIR`` whose output shrank
symmetrically (the voxel-offset fix). ``str_to_dict`` parses the
arguments' mini-language as the JAX package does. The seven plugins
built on the annotations (synapse detection and editing, skeletonize
and fragment aggregation) leave the JAX tasks, output and files; so do
the three that need a package (``clahe`` bitwise cv2; ``czann_inference``
and ``napari_pixel_classifier`` with their package absent and stubbed).
"""
import os
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from chunkflow_tpu.flow import plugin as jplugin
from chunkflow_tpu_torch.flow import cli, plugin
from tests.test_torch_chunk import assert_same_chunk
from tests.test_torch_cli_ops import (
    OFFSET,
    VSIZE,
    _tasks,
    assert_same_tasks,
    jax_stage,
    port_stage,
    run_both,
)

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

CHUNK_PLUGINS = {
    "inverse": ["-n", "inverse"],
    "inverse-float": ["-n", "inverse", "-i", "prob", "-o", "inv"],
    "mapto01": ["-n", "mapto01.py", "-o", "unit"],
    "median_filter": ["-n", "median_filter", "-a", "size=3"],
    "median_filter-zyx": ["-n", "median_filter", "-i", "aff", "-a",
                          "size=(1,3,3);mode=nearest"],
    "rescale_intensity": ["-n", "rescale_intensity", "-a",
                          "low=10;high=200"],
    "rescale_intensity-float": ["-n", "rescale_intensity", "-i", "prob"],
    "stretch_intensity": ["-n", "stretch_intensity", "-a",
                          "low_percentile=5;high_percentile=95"],
    "fill_segmentation_holes": ["-n", "fill_segmentation_holes", "-i",
                                "seg", "-o", "filled"],
    "gaussian_filter": ["-n", "gaussian_filter", "-i", "prob", "-a",
                        "sigma=1.5"],
    "transpose": ["-n", "transpose", "-i", "aff"],
    "detect_points": ["-n", "detect_points", "-i", "prob", "-o", "points",
                      "-a", "min_distance=2;threshold_rel=0.5"],
    "print_max_id": ["-n", "print_max_id", "-i", "seg", "-o", "none"],
    "statistics": ["-n", "statistics", "-o", "none"],
    "agglomerate": ["-n", "agglomerate", "-i", "aff", "-o", "seg2", "-a",
                    "threshold=0.5;scoring_function=OneMinus<QuantileAffinity"
                    "<RegionGraphType, ScoreValue, 50, false>>"],
    "agglomerate-fragments": ["-n", "agglomerate", "-i", "aff,seg", "-o",
                              "seg2", "-a", "scoring_function=max"],
}


@pytest.mark.parametrize("name", sorted(CHUNK_PLUGINS))
def test_bundled_plugin_matches_jax(name, capsys):
    args = ["plugin", *CHUNK_PLUGINS[name]]
    capsys.readouterr()
    jax_tasks, port_tasks = run_both(args)
    printed = capsys.readouterr().out.splitlines()
    # each package's plugin printed once, in that order
    half = len(printed) // 2
    jax_out, port_out = printed[:half], printed[half:]
    assert port_out == jax_out
    assert_same_tasks(port_tasks, jax_tasks)


def _loaders(tmp_path):
    """Files for the loader plugins: MRC and NRRD written by the JAX
    package, an N5 dataset by tensorstore."""
    from chunkflow_tpu.volume.io_mrc import save_mrc
    from chunkflow_tpu.volume.io_nrrd import save_nrrd

    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (4, 16, 16)).astype(np.uint8)
    save_mrc(str(tmp_path / "a.mrc"), img, voxel_size_nm=(40.0, 4.0, 4.0))
    save_nrrd(str(tmp_path / "a.nrrd"), img.astype(np.uint16),
              voxel_size=(40, 4, 4), voxel_offset=(4, 8, 40))
    return {
        "load_mrc": ["-n", "load_mrc", "-i", "", "-o", "mrc", "-a",
                     f"file_name={tmp_path / 'a.mrc'};voxel_offset=(1,2,3)"],
        "load_nrrd": ["-n", "load_nrrd", "-i", "", "-o", "nrrd", "-a",
                      f"file_name={tmp_path / 'a.nrrd'}"],
    }


@pytest.mark.parametrize("name", ["load_mrc", "load_nrrd"])
def test_loader_plugin_matches_jax(name, tmp_path):
    jax_tasks, port_tasks = run_both(["plugin", *_loaders(tmp_path)[name]])
    assert_same_tasks(port_tasks, jax_tasks)


def test_load_n5_reads_what_tensorstore_reads(tmp_path):
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(32)
    data = rng.integers(0, 2 ** 16, (12, 40, 72, 2)).astype(np.uint16)
    for compression in ({"type": "raw"}, {"type": "gzip"}):
        path = tmp_path / compression["type"]
        store = ts.open({
            "driver": "n5", "kvstore": {"driver": "file", "path": str(path)},
            "path": "group/ds",
            "metadata": {"dimensions": list(data.shape),
                         "blockSize": [5, 16, 32, 2],
                         "dataType": "uint16", "compression": compression},
            "create": True}).result()
        store.write(data).result()
        args = ["plugin", "-n", "load_n5", "-i", "bbox", "-o", "n5", "-a",
                f"n5_dir={path};group_path=group/ds;voxel_size=(40,4,4)"]
        jax_tasks, port_tasks = run_both(args)
        assert_same_tasks(port_tasks, jax_tasks)
        got = port_tasks[0]["n5"]
        assert got.array.shape == (2, 12, 12, 2)


def test_save_nrrd_writes_the_jax_bytes(tmp_path, capsys):
    jax_file, port_file = tmp_path / "jax.nrrd", tmp_path / "port.nrrd"
    from tests.test_torch_cli_ops import jax_stage, port_stage, _tasks

    jax_task, port_task = _tasks()
    list(jax_stage(["plugin", "-n", "save_nrrd", "-i", "other", "-o", "x",
                    "-a", f"file_name={jax_file}"])(iter([jax_task])))
    list(port_stage(["plugin", "-n", "save_nrrd", "-i", "other", "-o", "x",
                     "-a", f"file_name={port_file}"])(iter([port_task])))
    assert port_file.read_bytes() == jax_file.read_bytes()
    out = capsys.readouterr().out
    assert f"saved chunk to {port_file}" in out


class _Dvid(BaseHTTPRequestHandler):
    """A local DVID raw-label endpoint: the labels of a seeded volume."""

    labels = np.random.default_rng(33).integers(
        0, 2 ** 40, (16, 32, 64)).astype(np.uint64)
    paths = []

    def do_GET(self):
        type(self).paths.append(self.path)
        parts = self.path.split("?")[0].split("/")
        sx, sy, sz = map(int, parts[-2].split("_"))
        ox, oy, oz = map(int, parts[-1].split("_"))
        block = self.labels[oz:oz + sz, oy:oy + sy, ox:ox + sx]
        body = np.ascontiguousarray(block).tobytes()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_cutout_dvid_label_against_a_local_server():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Dvid)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        args = ["plugin", "-n", "cutout_dvid_label", "-i", "bbox", "-o",
                "labels", "-a", f"server={url};uuid=abc;supervoxels=true"]
        jax_tasks, port_tasks = run_both(args)
    finally:
        server.shutdown()
        server.server_close()
    assert_same_tasks(port_tasks, jax_tasks)
    assert _Dvid.paths[0] == _Dvid.paths[1]
    assert "supervoxels=true" in _Dvid.paths[0]
    got = port_tasks[0]["labels"]
    assert np.array_equal(got.array, _Dvid.labels[5:7, 10:22, 42:54])


USER_PLUGIN = '''import numpy as np


def execute(chunk, margin=(1, 2, 3), scale=2):
    arr = np.asarray(chunk.host() if hasattr(chunk, "host")
                     else chunk.array)
    mz, my, mx = margin
    return [arr[..., mz:-mz, my:-my, mx:-mx] * scale,
            arr[..., :-1, :, :], None]
'''


def test_user_plugin_from_plugin_dir_and_crop_offset(tmp_path, monkeypatch):
    """A symmetric shrink moves the voxel offset by half of it; an
    asymmetric one keeps it, in both packages."""
    (tmp_path / "shrink.py").write_text(USER_PLUGIN)
    monkeypatch.setenv("CHUNKFLOW_PLUGIN_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path.parent)
    args = ["plugin", "-n", "shrink", "-i", "aff", "-o", "core,lopped,none",
            "-a", "margin=(1,2,3);scale=3"]
    jax_tasks, port_tasks = run_both(args)
    assert_same_tasks(port_tasks, jax_tasks)
    core = port_tasks[0]["core"]
    assert tuple(core.voxel_offset) == tuple(
        o + m for o, m in zip(OFFSET, (1, 2, 3)))
    assert tuple(core.voxel_size) == VSIZE
    assert tuple(port_tasks[0]["lopped"].voxel_offset) == OFFSET
    assert port_tasks[0]["none"] is None


def test_wrap_outputs_matches_jax():
    from chunkflow_tpu.chunk.base import Chunk as JaxChunk
    from chunkflow_tpu_torch import Chunk

    arr = np.arange(2 * 6 * 8 * 10, dtype=np.float32).reshape(2, 6, 8, 10)
    outputs = [arr[:, 1:-1, 2:-2, 3:-3], arr[0, :5], arr[0, 0], 7, None]
    got = plugin.wrap_outputs(outputs, [Chunk(arr, voxel_offset=OFFSET,
                                              voxel_size=VSIZE)])
    ref = jplugin.wrap_outputs(outputs, [JaxChunk(arr, voxel_offset=OFFSET,
                                                  voxel_size=VSIZE)])
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        if isinstance(r, JaxChunk):
            assert_same_chunk(g, r)
        else:
            assert type(g) is type(r) and np.array_equal(g, r)
    assert plugin.wrap_outputs(None, []) == jplugin.wrap_outputs(None, [])


STR_TO_DICT = [
    None, "", "k=3", "k=3;k2=(1,2);k3=abc", "a=1.5;b=-2;c=1e-3",
    "flag=True;other=false;x=TRUE", "t=();l=[];u=(1,);v=[1, 2.5, x]",
    "  spaced = 4 ; ;trail=;", "path=/tmp/a=b.h5", "neg=(-1, -2, 0)",
    "s=OneMinus<MeanAffinity<RegionGraphType, ScoreValue>>",
]


@pytest.mark.parametrize("text", STR_TO_DICT)
def test_str_to_dict_matches_jax(text):
    got, ref = plugin.str_to_dict(text), jplugin.str_to_dict(text)
    assert got == ref
    assert [type(v) for v in got.values()] == [type(v) for v in ref.values()]


UNPORTED = ["skeletonize", "aggregate_skeleton_fragments", "adjust_pre",
            "synapse/detect_duplicate_post", "detect_post_synapses",
            "detect_pre_synapses", "find_tbar_object", "clahe",
            "czann_inference", "napari_pixel_classifier", "aws/cloud_watch",
            "load_tensorstore"]

#: the bundled plugins of the JAX package that need a package beyond
#: numpy and scipy
PACKAGE_GATED = {"clahe": "cv2", "czann_inference": "czmodel",
                 "napari_pixel_classifier": "apoc"}


class _Recorder:
    """boto3's ``put_metric_data``, recorded."""

    def __init__(self):
        self.calls = []

    def put_metric_data(self, Namespace, MetricData):
        self.calls.append((Namespace, MetricData))


@pytest.mark.parametrize("name", UNPORTED)
def test_a_plugin_left_out_raises_naming_its_item(name, tmp_path, capsys,
                                                  monkeypatch):
    """The JAX package finds each of these among its bundled plugins, and
    so does the port. ``clahe`` runs bitwise the JAX plugin's cv2 (a
    non-uint8 chunk raises the same ``ValueError``); ``czann_inference``
    and ``napari_pixel_classifier`` raise what the JAX plugins raise
    without their package, and give what they give with a stub of it
    (``gated_outcomes``); the seven the annotations brought,
    ``load_tensorstore`` and ``aws/cloud_watch`` run, equal to the JAX
    package's (``aws/cloud_watch`` with a recording client in both:
    ``tests/test_torch_cloud_watch.py`` holds it on the CloudWatch
    fake)."""
    assert os.path.exists(jplugin.find_plugin(name))
    if name == "aws/cloud_watch":
        from chunkflow_tpu.core import telemetry as jax_telemetry
        from chunkflow_tpu_torch.core import telemetry

        # both registries empty: each execute publishes its own
        telemetry.reset()
        jax_telemetry.reset()
        calls = []
        for load in (plugin.load_plugin, jplugin.load_plugin):
            recorder = _Recorder()
            load(name)({"timer": {"inference": 1.5}}, client=recorder)
            calls.append(recorder.calls)
        assert calls[0] == calls[1] and calls[0]
        return
    if name == "load_tensorstore":
        root, _ = _ts_dataset(tmp_path, "zarr")
        run_both_plugins(["-n", "load_tensorstore", "-i", "bbox", "-o",
                          "chunk", "-a", f"driver=zarr;kvstore=file://{root}"
                          ";voxel_size=(40,4,4)"])
        return
    if name not in PACKAGE_GATED:
        run_annotation_plugin(ANNOTATION_PLUGINS[name.split("/")[-1]],
                              tmp_path, capsys)
        return
    if name == "clahe":
        pytest.importorskip("cv2")
        jax_tasks, port_tasks = run_both(["plugin", "-n", "clahe", "-a",
                                          "clip_limit=3;tile_size=4"])
        assert_same_tasks(port_tasks, jax_tasks)
        jax_out, port_out = gated_outcomes(["-n", "clahe", "-i", "prob"])
        assert port_out == jax_out == (ValueError,
                                       "CLAHE needs a uint8 image chunk")
        return
    package = PACKAGE_GATED[name]
    args = ["-n", name, "-o", "out", "-a", ARGUMENT[name]]
    monkeypatch.setitem(sys.modules, package, None)
    jax_out, port_out = gated_outcomes(args)
    assert jax_out[0] is ImportError and f"'{package}' package" in jax_out[1]
    assert port_out == jax_out
    for module in STUBS[package]():
        monkeypatch.setitem(sys.modules, module.__name__, module)
    jax_out, port_out = gated_outcomes(args)
    if name == "czann_inference":
        assert jax_out[0] is NotImplementedError
        assert port_out == jax_out
    else:
        assert_same_tasks(port_out, jax_out)
        assert port_out[0]["out"].array.dtype == np.float32


def gated_outcomes(args):
    """(JAX, port): each CLI's ``plugin`` command on the same task, as
    the tasks it leaves or the type and text of what it raised."""
    outcomes = []
    for stage, task in zip((jax_stage, port_stage), _tasks()):
        try:
            outcomes.append(list(stage(["plugin", *args])(iter([task]))))
        except Exception as exc:  # compared across the two packages
            outcomes.append((type(exc), str(exc)))
    return outcomes


def _czmodel_stub():
    """``czmodel.pytorch.convert`` with a ``DefaultConverter``."""
    names = ("czmodel", "czmodel.pytorch", "czmodel.pytorch.convert")
    modules = [types.ModuleType(n) for n in names]
    modules[-1].DefaultConverter = object
    return modules


class _PixelClassifier:
    """apoc's classifier: a fixed function of the image."""

    def __init__(self, opencl_filename=None):
        self.path = opencl_filename

    def predict(self, image):
        assert self.path == "c.cl"
        return (np.asarray(image) % 7).astype(np.uint32)


def _apoc_stub():
    module = types.ModuleType("apoc")
    module.PixelClassifier = _PixelClassifier
    return [module]


STUBS = {"czmodel": _czmodel_stub, "apoc": _apoc_stub}
ARGUMENT = {"czann_inference": "model_file=m.czann",
            "napari_pixel_classifier": "classifier_path=c.cl"}


# ---------------------------------------------------------------------------
# load_tensorstore
# ---------------------------------------------------------------------------
TS_DATA = np.random.default_rng(0).integers(1, 255, size=(32, 64, 64),
                                            dtype=np.uint8)


def _ts_dataset(tmp_path, driver):
    """``tests/test_plugins_tensorstore.py``'s fixture array written by
    tensorstore in ``driver``'s format, 16x32x32 chunks; precomputed as
    x, y, z, channel at an offset."""
    ts = pytest.importorskip("tensorstore")
    root = str(tmp_path / driver)
    spec = {"driver": driver, "kvstore": {"driver": "file", "path": root}}
    data = TS_DATA
    if driver == "neuroglancer_precomputed":
        spec.update(multiscale_metadata={"type": "image",
                                         "data_type": "uint8",
                                         "num_channels": 1},
                    scale_metadata={"size": [64, 64, 32],
                                    "resolution": [4, 4, 40],
                                    "encoding": "raw",
                                    "chunk_size": [32, 32, 16],
                                    "voxel_offset": [3, 5, 7]})
        store = ts.open(spec, create=True).result()
        store[...] = data.transpose(2, 1, 0)[..., None]
        return root, data
    store = ts.open(spec, create=True, dtype="uint8", shape=data.shape,
                    chunk_layout=ts.ChunkLayout(
                        write_chunk_shape=[16, 32, 32])).result()
    store[...] = data
    return root, data


def run_both_plugins(args):
    """One ``plugin`` command through both CLIs on one task with a bbox:
    the chunks are the same."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox

    box = ((4, 8, 8), (28, 56, 60))
    jax_task, port_task = _tasks()
    jax_task["bbox"], port_task["bbox"] = JaxBox(*box), BoundingBox(*box)
    ref = list(jax_stage(["plugin", *args])(iter([jax_task])))[0]["chunk"]
    got = list(port_stage(["plugin", *args])(iter([port_task])))[0]["chunk"]
    assert_same_chunk(got, ref)
    return got


@pytest.mark.parametrize("driver", ["zarr", "zarr3", "n5",
                                    "neuroglancer_precomputed"])
def test_load_tensorstore_is_the_jax_plugin(tmp_path, driver):
    """Each driver over ``file://`` and a kvstore spec, and with the block
    cache, bitwise the JAX plugin."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.volume import storage

    root, data = _ts_dataset(tmp_path, driver)
    execute = plugin.load_plugin("load_tensorstore")
    jexecute = jplugin.load_plugin("load_tensorstore")
    box = ((3, 6, 9), (29, 60, 61)) if driver != "neuroglancer_precomputed" \
        else ((9, 10, 12), (60, 66, 36))
    for kvstore in (f"file://{root}", {"driver": "file", "path": root}):
        ref = jexecute(JaxBox(*box), driver=driver, kvstore=kvstore,
                       voxel_size=(40, 4, 4))
        got = execute(BoundingBox(*box), driver=driver, kvstore=kvstore,
                      voxel_size=(40, 4, 4))
        assert_same_chunk(got, ref)
    if driver != "neuroglancer_precomputed":
        assert np.array_equal(got.array, data[tuple(
            slice(a, b) for a, b in zip(*box))])
    storage.reset_shared_cache()
    telemetry.reset()
    try:
        for _ in range(2):
            cached = execute(BoundingBox(*box), driver=driver,
                             kvstore=f"file://{root}", cache=1)
            assert np.array_equal(cached.array, got.array)
        counters = telemetry.snapshot()["counters"]
        assert counters["storage/hits"] == counters["storage/block_reads"]
    finally:
        storage.reset_shared_cache()
        telemetry.reset()


def test_load_tensorstore_unported_driver_raises(tmp_path):
    """A memory kvstore and a driver tensorstore does not register raise
    ``ValueError`` in both plugins (the JAX one's is tensorstore's)."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox

    execute = plugin.load_plugin("load_tensorstore")
    jexecute = jplugin.load_plugin("load_tensorstore")
    for args in (dict(driver="zarr", kvstore=f"memory://{tmp_path}"),
                 dict(driver="jsonl", kvstore=f"file://{tmp_path}")):
        with pytest.raises(ValueError, match="tensorstore refuses"):
            execute(BoundingBox((0, 0, 0), (1, 1, 1)), **args)
        with pytest.raises(ValueError):
            jexecute(JaxBox((0, 0, 0), (1, 1, 1)), **args)


def test_unported_names_exactly_the_package_gated_plugins():
    """No bundled plugin is left out: the package-gated ones too have
    their port file, found as the JAX package finds its own."""
    jax_dir = os.path.dirname(jplugin.find_plugin("clahe"))
    for root, _, files in os.walk(jax_dir):
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                rel = os.path.relpath(os.path.join(root, f), jax_dir)
                assert os.path.isfile(os.path.join(plugin.BUNDLED, rel)), rel
    assert not hasattr(plugin, "UNPORTED")
    for name in PACKAGE_GATED:
        assert plugin.find_plugin(name).startswith(plugin.BUNDLED)


# ---------------------------------------------------------------------------
# the plugins built on the annotations
# ---------------------------------------------------------------------------
ANNOTATION_PLUGINS = {
    "detect_pre_synapses": ["-n", "detect_pre_synapses", "-i", "prob",
                            "-o", "found", "-a",
                            "min_distance=2;threshold_rel=0.5"],
    "detect_post_synapses": ["-n", "detect_post_synapses", "-i",
                             "synapses,prob", "-o", "synapses", "-a",
                             "search_radius=50;min_distance=1"],
    "adjust_pre": ["-n", "adjust_pre", "-i", "synapses,prob", "-o",
                   "adjusted", "-a", "window=2"],
    "detect_duplicate_post": ["-n", "synapse/detect_duplicate_post", "-i",
                              "synapses,seg", "-o", "deduped", "-a",
                              "distance_threshold=6.0"],
    "find_tbar_object": ["-n", "find_tbar_object", "-i", "synapses,seg",
                         "-o", "ids"],
    "skeletonize": ["-n", "skeletonize", "-i", "seg", "-o", "skels", "-a",
                    "voxel_num_threshold=5;max_paths=40;output_path={out}"],
    "aggregate_skeleton_fragments": [
        "-n", "aggregate_skeleton_fragments", "-i", "frags", "-o", "count",
        "-a", "output_dir={out}"],
    # more settings of the same plugins
    "detect_pre_synapses-default": ["-n", "detect_pre_synapses", "-i",
                                    "prob", "-o", "found"],
    "detect_post_synapses-none-near": [
        "-n", "detect_post_synapses", "-i", "synapses,prob", "-o", "s2",
        "-a", "search_radius=1;threshold_rel=0.9"],
    "detect_post_synapses-on-aff": [
        "-n", "detect_post_synapses", "-i", "synapses,aff", "-o", "s2",
        "-a", "min_distance=1"],
    "adjust_pre-default": ["-n", "adjust_pre", "-i", "synapses,aff", "-o",
                           "adjusted"],
    "detect_duplicate_post-no-seg": ["-n", "detect_duplicate_post", "-i",
                                     "synapses", "-o", "deduped"],
    "detect_duplicate_post-none": ["-n", "detect_duplicate_post", "-i",
                                   "synapses", "-o", "deduped", "-a",
                                   "distance_threshold=0.1"],
    "find_tbar_object-4d": ["-n", "find_tbar_object", "-i",
                            "synapses,seg4", "-o", "ids"],
    "skeletonize-threshold": ["-n", "skeletonize", "-i", "seg", "-o",
                              "skels", "-a", "voxel_num_threshold=40"],
}


def run_annotation_plugin(args, tmp_path, capsys):
    """One plugin through both CLIs' ``plugin`` command on the same seeded
    task (``tests/test_torch_cli_ops.py``'s, with synapses, a 4D
    segmentation and a directory of skeleton fragments): the tasks, what
    each printed and the files each wrote are the same."""
    from chunkflow_tpu.chunk.segmentation import Segmentation
    from chunkflow_tpu.plugins import skeletonize
    from tests.test_torch_cli_ops import (
        _annotated_tasks,
        _files,
        assert_same_annotated_tasks,
        jax_stage,
        port_stage,
    )
    from tests.test_torch_skeletonize import _labels

    frags = tmp_path / "frags"
    seg = _labels(6, (6, 16, 32))
    for x0 in (0, 16):
        skeletonize.execute(Segmentation(seg[..., x0:x0 + 16].copy(),
                                         voxel_offset=(0, 0, x0)),
                            voxel_num_threshold=10, output_path=str(frags))
    tasks = _annotated_tasks()
    for task in tasks:
        task["frags"] = str(frags)
        task["seg4"] = type(task["seg"])(task["seg"].array[None].copy(),
                                         voxel_offset=OFFSET,
                                         voxel_size=VSIZE)
    capsys.readouterr()
    out = {}
    for tag, stage, task in (("jax", jax_stage, tasks[0]),
                             ("port", port_stage, tasks[1])):
        d = tmp_path / tag
        d.mkdir()
        argv = ["plugin"] + [a.replace("{out}", str(d)) for a in args]
        out[tag] = (list(stage(argv)(iter([task]))),
                    capsys.readouterr().out, _files(d))
    (ref, ref_out, ref_files), (got, got_out, got_files) = (out["jax"],
                                                           out["port"])
    assert_same_annotated_tasks(got, ref)
    assert got_out == ref_out
    assert got_files == ref_files
    return got[0]


@pytest.mark.parametrize("name", sorted(ANNOTATION_PLUGINS))
def test_annotation_plugin_matches_jax(name, tmp_path, capsys):
    task = run_annotation_plugin(ANNOTATION_PLUGINS[name], tmp_path, capsys)
    key = ANNOTATION_PLUGINS[name][ANNOTATION_PLUGINS[name].index("-o") + 1]
    value = task[key]
    if name in ("detect_pre_synapses", "detect_post_synapses"):
        assert value.pre_num > 0
    if name == "detect_post_synapses":
        assert value.post_num > 0
    if name == "find_tbar_object":
        assert value.ndim == 1 and value.size == task["synapses"].pre_num
    if name.startswith("skeletonize"):
        assert isinstance(value, dict)
    if name == "aggregate_skeleton_fragments":
        assert value > 0


def test_a_missing_plugin_is_not_found(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CHUNKFLOW_PLUGIN_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="not found"):
        plugin.find_plugin("no_such_plugin")
    # a user file beats the bundled one, as in the JAX package
    (tmp_path / "inverse.py").write_text("def execute(c):\n    return c\n")
    assert plugin.find_plugin("inverse") == str(tmp_path / "inverse.py")
    assert plugin.find_plugin("inverse") == jplugin.find_plugin("inverse")
    (tmp_path / "noexec.py").write_text("x = 1\n")
    with pytest.raises(AttributeError, match="no execute"):
        plugin.load_plugin("noexec")


def test_plugin_through_whole_command_lines(tmp_path):
    """``load-npy | plugin | save-npy`` through both CLIs."""
    from click.testing import CliRunner

    from chunkflow_tpu.flow.cli import main as jax_main

    arr = np.random.default_rng(34).integers(0, 256, (4, 16, 16)).astype(
        np.uint8)
    np.save(tmp_path / "in.npy", arr)
    outs = {}
    for which in ("jax", "port"):
        out = str(tmp_path / f"{which}.npy")
        args = ["load-npy", "-f", str(tmp_path / "in.npy"), "plugin", "-n",
                "inverse", "plugin", "-n", "mapto01", "save-npy", "-f", out]
        if which == "jax":
            result = CliRunner().invoke(jax_main, args,
                                        catch_exceptions=False)
            assert result.exit_code == 0, result.output
        else:
            assert cli.main(["--device", "cpu", *args]) == 0
        outs[which] = np.load(out)
    assert outs["port"].dtype == outs["jax"].dtype == np.float32
    assert np.array_equal(outs["port"], outs["jax"])
    assert outs["port"].max() == 1.0
