"""The names the port gained so that its public surface is the JAX
package's (``tests/test_torch_api_surface.py``), each against the JAX
function on the same input, on the CPU.

``PrecomputedVolume``'s reference spellings (``bounding_box``, ``bbox``,
``start``, ``stop``, ``shape``, ``block_bounding_boxes``,
``physical_bounding_box``, ``from_numpy``) on one volume written by each
package, mirroring ``tests/test_volume.py``'s reference test; the
telemetry registry's ``add_counter``, ``set_gauge`` and ``emit``;
``bump_const``; ``load_tensorstore.parse_kvstore``, the one parser of
``open_kvstore``; ``GatherFuture.done``; ``storage.reset_open_backends``.
"""
import io
import json
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from chunkflow_tpu.core import telemetry as jax_telemetry
from chunkflow_tpu.inference import bump as jax_bump
from chunkflow_tpu.plugins import load_tensorstore as jax_load_tensorstore
from chunkflow_tpu.volume import storage as jax_storage
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.inference import bump
from chunkflow_tpu_torch.plugins import load_tensorstore
from chunkflow_tpu_torch.volume import storage
from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

torch.set_num_threads(1)


def _box(box):
    return tuple(box.start), tuple(box.stop)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_precomputed_volume_reference_spellings(tmp_path, writer):
    """One volume (blocks that do not divide it), written by
    ``from_numpy`` of either package and opened by both: the eight
    members agree, and the cutout over ``bounding_box`` is the array."""
    pytest.importorskip("tensorstore")
    from chunkflow_tpu.volume.precomputed import (
        PrecomputedVolume as JaxVolume,
    )

    arr = np.arange(8 * 20 * 24, dtype=np.uint32).reshape(8, 20, 24)
    path = str(tmp_path / "v")
    cls = PrecomputedVolume if writer == "port" else JaxVolume
    made = cls.from_numpy(arr, path, block_size=(8, 8, 16))
    assert isinstance(made, cls)
    port, ref = PrecomputedVolume(path), JaxVolume(path)
    assert tuple(port.shape) == tuple(ref.shape) == (1, 8, 20, 24)
    assert _box(port.bounding_box) == _box(ref.bounding_box)
    assert _box(port.bbox) == _box(ref.bbox) == _box(port.bounding_box)
    assert tuple(port.start) == tuple(ref.start) == (0, 0, 0)
    assert tuple(port.stop) == tuple(ref.stop) == (8, 20, 24)
    blocks = [_box(b) for b in port.block_bounding_boxes]
    assert blocks == [_box(b) for b in ref.block_bounding_boxes]
    assert len(blocks) == 6 and blocks[-1] == ((0, 16, 16), (8, 20, 24))
    phys, ref_phys = port.physical_bounding_box, ref.physical_bounding_box
    assert _box(phys) == _box(ref_phys)
    assert tuple(phys.voxel_size) == tuple(ref_phys.voxel_size) == \
        tuple(port.voxel_size(0))
    back = np.asarray(port.cutout(port.bounding_box).array)
    want = np.asarray(ref.cutout(ref.bounding_box).array)
    assert np.array_equal(back, want)
    assert np.array_equal(back.reshape(arr.shape), arr)


def test_from_numpy_keeps_a_chunks_channels_and_kwargs(tmp_path):
    """A czyx array and ``create``'s keywords pass through, as in the
    JAX ``from_numpy``."""
    from chunkflow_tpu.volume.precomputed import (
        PrecomputedVolume as JaxVolume,
    )

    arr = np.random.default_rng(3).random((2, 4, 8, 8), dtype=np.float32)
    port = PrecomputedVolume.from_numpy(arr, str(tmp_path / "p"),
                                        block_size=(4, 4, 4))
    ref = JaxVolume.from_numpy(arr, str(tmp_path / "j"),
                               block_size=(4, 4, 4))
    assert port.info == ref.info
    assert tuple(port.shape) == tuple(ref.shape) == (2, 4, 8, 8)


def test_registry_methods_behave_as_the_jax_ones():
    """The same calls on both registries: the same counters, gauges and
    sink lines; ``emit`` with no sink writes nothing."""
    regs = {"port": telemetry._Registry(), "jax": jax_telemetry._Registry()}
    sinks = {}
    for name, reg in regs.items():
        reg.emit({"kind": "dropped"})
        sinks[name] = reg.sink = io.StringIO()
        for n in (1, 2.5, -1):
            reg.add_counter("tasks", n)
        reg.add_counter("other", 3)
        reg.set_gauge("depth", 4)
        reg.set_gauge("depth", 2)
        threads = [threading.Thread(target=reg.add_counter, args=("hot", 1))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        reg.emit({"kind": "gauge", "name": "depth", "value": 2})
        reg.emit({"kind": "event", "name": "x", "attrs": [1, "a"]})
    assert regs["port"].counters == regs["jax"].counters == {
        "tasks": 2.5, "other": 3, "hot": 8}
    assert regs["port"].gauges == regs["jax"].gauges == {"depth": 2}
    assert sinks["port"].getvalue() == sinks["jax"].getvalue()
    assert [json.loads(line) for line in
            sinks["port"].getvalue().splitlines()][0]["name"] == "depth"


@pytest.mark.parametrize("patch", [(4, 16, 16), (5, 9, 7), (20, 64, 64)])
def test_bump_const_is_the_jax_constant(patch):
    got = bump.bump_const(patch, device="cpu")
    want = np.asarray(jax_bump.bump_const(patch))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)


KVSTORES = ["file:///tmp/store", "gs://bucket/a/b", "s3://b/k",
            "://relative/path", "memory://", "plain/path",
            {"driver": "file", "path": "/x"}, None]


@pytest.mark.parametrize("kvstore", KVSTORES)
def test_parse_kvstore_is_the_jax_functions(kvstore):
    assert load_tensorstore.parse_kvstore(kvstore) == \
        jax_load_tensorstore.parse_kvstore(kvstore)


def test_gather_future_done_is_the_jax_ones():
    """Done once every member that can say is done; a member without
    ``done`` does not hold it back."""
    class Plain:
        def result(self):
            return None

    for cls in (storage.GatherFuture, jax_storage.GatherFuture):
        first, second = Future(), Future()
        both = cls([first, Plain(), second])
        assert not both.done()
        first.set_result(1)
        assert not both.done()
        second.set_exception(ValueError("lost"))
        assert both.done()
        with pytest.raises(ValueError, match="lost"):
            both.result()
        assert cls([]).done() and cls([Plain()]).done()


def test_reset_open_backends_forgets_the_cached_handles():
    opened = []

    def opener():
        opened.append(object())
        return opened[-1]

    key = "test_torch_api_parity:reset"
    first = storage.open_backend_cached(key, opener)
    assert storage.open_backend_cached(key, opener) is first
    storage.reset_open_backends()
    assert storage.open_backend_cached(key, opener) is not first
    assert len(opened) == 2
    storage.reset_open_backends()

