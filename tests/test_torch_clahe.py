"""The port's CLAHE (``ops/clahe.py``, ``csrc/host/clahe.cpp``, the
``clahe`` plugin) against the JAX package's ``clahe`` plugin, which calls
cv2, on the CPU.

The port's plugin equals the JAX plugin bitwise on every shape class (a
grid that divides the section, one that does not, a section smaller than
the grid, a side of one pixel), grid sizes 2-16 and clip limits 0, 1, 2
and 40; the host C++ equals its numpy plain version on any thread count;
both CLIs' ``plugin -n clahe`` leave the same task; a chunk that is not
uint8 raises the same ``ValueError`` in both.
"""
import itertools

import numpy as np
import pytest
import torch

from chunkflow_tpu.flow import plugin as jplugin
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.flow import plugin
from chunkflow_tpu_torch.ops.clahe import clahe, clahe_plain, reflect_101

pytest.importorskip("cv2")

torch.set_num_threads(1)

SHAPES = {"divisible": (2, 64, 48), "ragged": (2, 45, 37),
          "under-the-grid": (2, 5, 5), "one-row": (2, 1, 40),
          "one-column": (2, 33, 1)}
TILES = (2, 5, 8, 16)
CLIPS = (0, 1, 2, 40)


def _sections(shape, seed=0):
    """Random sections, and a smooth ramp with noise (whose histograms
    clip unevenly)."""
    rng = np.random.default_rng(seed)
    z, y, x = shape
    ramp = (np.add.outer(np.arange(y) * 3, np.arange(x) * 5) % 97
            + rng.integers(0, 20, (y, x))).astype(np.uint8)
    return np.concatenate([rng.integers(0, 256, (z - 1, y, x),
                                        dtype=np.uint8), ramp[None]])


class _Chunk:
    """What the JAX plugin reads: an ``array``."""

    def __init__(self, array):
        self.array = array


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_plugin_is_the_jax_plugin_bitwise(shape, tile, clip):
    arr = _sections(SHAPES[shape], seed=tile)
    want = jplugin.load_plugin("clahe")(_Chunk(arr), clip_limit=clip,
                                        tile_size=tile)
    got = plugin.load_plugin("clahe")(Chunk(arr.copy()), clip_limit=clip,
                                      tile_size=tile)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_host_cpp_is_its_plain_version_on_any_thread_count(threads):
    from chunkflow_tpu_torch import native

    for (shape, tile, clip) in itertools.product(
            ((5, 61, 59), (3, 32, 32), (4, 7, 130)), (3, 8, 16), (0, 2.5)):
        arr = _sections(shape, seed=threads)
        want = clahe_plain(arr, clip, tile)
        assert np.array_equal(native.clahe(arr, clip, tile, threads), want)
        assert np.array_equal(clahe(arr, clip, tile), want)


def test_reflect_101_is_opencvs_border():
    """``borderInterpolate(BORDER_REFLECT_101)``: edge not repeated, again
    and again for a pad longer than the side, index 0 for a side of one."""
    assert reflect_101(4, 6).tolist() == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    assert reflect_101(1, 3).tolist() == [0, 0, 0, 0]
    assert reflect_101(2, 3).tolist() == [0, 1, 0, 1, 0]


def test_both_clis_give_the_same_task():
    from tests.test_torch_cli_ops import assert_same_tasks, run_both

    jax_tasks, port_tasks = run_both(
        ["plugin", "-n", "clahe", "-a", "clip_limit=3;tile_size=16"],
        _tasks(_sections((3, 50, 70), seed=3)))
    assert_same_tasks(port_tasks, jax_tasks)
    assert port_tasks[0]["chunk"].array.dtype == np.uint8
    assert not np.array_equal(port_tasks[0]["chunk"].array,
                              _sections((3, 50, 70), seed=3))


def _tasks(arr):
    from chunkflow_tpu.chunk.base import Chunk as JaxChunk
    from chunkflow_tpu.flow.runtime import new_task as jax_new_task
    from chunkflow_tpu_torch.flow.runtime import new_task

    jax_task, port_task = jax_new_task(), new_task()
    meta = dict(voxel_offset=(2, 4, 6), voxel_size=(40, 4, 4))
    jax_task["chunk"] = JaxChunk(arr.copy(), **meta)
    port_task["chunk"] = Chunk(arr.copy(), **meta)
    return jax_task, port_task


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_a_chunk_that_is_not_uint8_raises_in_both(dtype):
    arr = _sections((2, 16, 16)).astype(dtype)
    for execute, chunk in ((jplugin.load_plugin("clahe"), _Chunk(arr)),
                           (plugin.load_plugin("clahe"), Chunk(arr))):
        with pytest.raises(ValueError, match="CLAHE needs a uint8 image "
                                             "chunk"):
            execute(chunk)
