"""The flax msgpack writer (``models/flax_msgpack.py:dumps``,
``models/unet3d.py:save_params``, ``models/convert.py:flax_from_state``)
and the reference-model names of ``models/migrate.py``, against flax and
the JAX package on the CPU.

A port model of each family (UNet3D parity and ``tpu_s2d4``, RSUNet),
loaded from the JAX package's own init tree, is saved by
``save_params``: the file's bytes are
``flax.serialization.to_bytes`` of that tree, also with flax's chunk
threshold lowered in both packages so every leaf is cut; the JAX
``init_or_load_params`` loads the file bitwise, and so does the port's
loader. ``dumps`` gives ``to_bytes``'s bytes on a tree of every msgpack
width. ``flax_params_from_reference_model`` gives the JAX function's
tree bitwise for a reference RSUNet checkpoint.
"""
import numpy as np
import pytest
import torch

import jax
from flax import serialization

from chunkflow_tpu.models import migrate as jax_migrate
from chunkflow_tpu.models import rsunet as flax_rsunet
from chunkflow_tpu.models import unet3d as flax_unet3d
from chunkflow_tpu_torch.models import flax_msgpack, migrate
from chunkflow_tpu_torch.models.convert import (
    flax_from_state,
    init_or_load_weights,
    state_from_flax,
)
from chunkflow_tpu_torch.models.rsunet import RSUNet
from chunkflow_tpu_torch.models.unet3d import save_params
from tests.test_torch_models import FEATS, _pair, reference_model

torch.set_num_threads(1)

FAMILIES = ["parity", "tpu_s2d4", "rsunet"]


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _same_tree(got, want):
    """The same keys in the same order at every level, each leaf's dtype
    and values bitwise."""
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), key


def _family(family, seed=0):
    """(flax model, port model loaded from the JAX init tree, the tree,
    the input patch)."""
    fnet, tnet, pin = _pair(family, "float32")
    params = flax_unet3d.init_params(fnet, pin, 1, seed=seed)
    tnet.load_state_dict(state_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    return fnet, tnet, params, pin


@pytest.mark.parametrize("family", FAMILIES)
def test_save_params_is_flax_to_bytes(tmp_path, family):
    fnet, tnet, params, pin = _family(family, seed=FAMILIES.index(family))
    path = save_params(tnet, str(tmp_path / "w.msgpack"))
    data = open(path, "rb").read()
    assert data == serialization.to_bytes(params)
    assert flax_msgpack.dumps(flax_from_state(tnet.state_dict())) == data
    # the JAX worker's loader, and the port's, read it bitwise
    _same_tree(flax_unet3d.init_or_load_params(fnet, path, pin, 1), params)
    _, back, _ = _pair(family, "float32")
    init_or_load_weights(back, path)
    for key, value in tnet.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


@pytest.mark.parametrize("family", ["parity", "rsunet"])
def test_save_params_cuts_large_leaves_as_flax(tmp_path, monkeypatch,
                                               family):
    """flax's chunk threshold lowered to 256 bytes in both packages:
    every kernel is written in flat parts, as flax writes it."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 256)
    fnet, tnet, params, pin = _family(family, seed=7)
    path = save_params(tnet.state_dict(), str(tmp_path / "w.msgpack"))
    data = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in data
    assert data == serialization.to_bytes(params)
    _same_tree(flax_unet3d.init_or_load_params(fnet, path, pin, 1), params)
    _, back, _ = _pair(family, "float32")
    init_or_load_weights(back, path)
    for key, value in tnet.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


def test_dumps_is_to_bytes_at_every_width():
    """Ints, str, bin, maps and lists at each msgpack width, floats,
    booleans, nil, and array leaves of several dtypes: numpy arrays and
    torch tensors (bfloat16 by its bits); lists and tuples as flax's
    maps of "0", "1", ...."""
    import ml_dtypes

    rng = np.random.default_rng(8)
    bf16 = rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16)
    ints = (0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**64 - 1, -1,
            -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63)
    base = {
        "ints": {str(v): v for v in ints},
        "floats": {"a": 0.5, "b": -1e300},
        "flags": {"t": True, "f": False, "none": None},
        "str": {"short": "x" * 31, "s32": "q" * 32, "s8": "y" * 200,
                "s16": "z" * 70_000, "utf8": "é" * 20},
        "bin": {"b8": b"\x01" * 10, "b16": b"\x02" * 300,
                "b32": b"\x03" * 70_000},
        "list": [1, [2, "three"], {"four": 4}, (5, 6)],
        "big_map": {f"k{i}": i for i in range(20)},
        "big_list": list(range(20)),
    }
    arrays = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "i32": np.arange(-3, 3, dtype=np.int32),
        "u8": np.arange(7, dtype=np.uint8).reshape(7, 1, 1),
        "scalar": np.array(2.5, np.float32), "one": np.zeros(1, np.uint8),
        "empty": np.zeros((0, 3), np.float32),
        "big": rng.standard_normal(20_000).astype(np.float32),
    }
    ours = dict(base, arrays=dict(arrays, tensor=torch.from_numpy(
        arrays["f32"]), bf16=torch.from_numpy(bf16.view(np.int16)).view(
            torch.bfloat16)))
    theirs = dict(base, arrays=dict(arrays, tensor=arrays["f32"],
                                    bf16=bf16))
    assert flax_msgpack.dumps(ours) == serialization.to_bytes(theirs)
    # and the port's reader reads it back
    back = flax_msgpack.loads(flax_msgpack.dumps(ours))
    assert back["ints"] == base["ints"] and back["list"]["3"] == {"0": 5,
                                                                  "1": 6}
    assert torch.equal(back["arrays"]["bf16"], ours["arrays"]["bf16"])
    with pytest.raises(TypeError):
        flax_msgpack.dumps({"a": {1, 2}})
    with pytest.raises(TypeError):
        serialization.to_bytes({"a": {1, 2}})


def test_flax_params_from_reference_model_is_the_jax_functions(tmp_path):
    """A reference RSUNet ``model.py`` and its checkpoint (BatchNorm
    statistics drawn from a seed): the port's tree is the JAX function's,
    keys, order and bits."""
    model_py, model = reference_model(tmp_path, width=FEATS + (10,), seed=4)
    weights = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), weights)
    width = FEATS + (10,)
    want = jax_migrate.flax_params_from_reference_model(
        model_py, weights, flax_rsunet.RSUNet(1, 3, width=width), (4, 16, 16))
    got = migrate.flax_params_from_reference_model(
        model_py, weights, RSUNet(width=width))
    _same_tree(got, want)
    with pytest.raises(NotImplementedError, match="name_map"):
        migrate.flax_params_from_reference_model(
            model_py, weights, RSUNet(width=width), name_map={"a": "b"})


def test_load_torch_module_runs_the_model_file_as_jax_does(tmp_path):
    model_py, _ = reference_model(tmp_path, width=FEATS + (10,))
    port = migrate.load_torch_module(model_py)
    ref = jax_migrate.load_torch_module(model_py)
    assert port.__name__ == ref.__name__ == "chunkflow_user_torch_model"
    public = sorted(n for n in vars(ref) if not n.startswith("_"))
    assert sorted(n for n in vars(port) if not n.startswith("_")) == public
    assert [k for k in port.InstantiatedModel.state_dict()] == \
        [k for k in ref.InstantiatedModel.state_dict()]
