"""The port's whole per-chunk path against the JAX ``Inferencer``, on the CPU.

The same chunk (numpy, from a seed) goes through the JAX ``Inferencer``
and the port's ``Inferencer(device="cpu")``, whose CPU tensors take the
kernels' plain PyTorch versions. With the identity engine every step is
exact or an IEEE float32 operation in the JAX package's order, so the
outputs must be BITWISE equal. With a small UNet3D (one set of params in
both packages) the forward differs in summation order: float32 within
1e-5, uint8 within 1 LSB.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.inference import engines as jax_engines
from chunkflow_tpu.inference.inferencer import Inferencer as JaxInferencer
from chunkflow_tpu.models import unet3d as flax_unet3d
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.models.convert import state_from_flax
from chunkflow_tpu_torch.models.unet3d import UNet3D
from chunkflow_tpu_torch.ops import accumulate, gather

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (4, 16, 16)
OVERLAP = (2, 8, 8)
IDENTITY = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                num_output_channels=2, framework="identity", batch_size=2,
                crop_output_margin=False)


def _chunk(shape, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(np.dtype(dtype))
        hi = min(int(info.max), 2**40)
        return rng.integers(0, hi, shape, endpoint=True).astype(dtype)
    return rng.random(shape).astype(dtype)


def _both(arr, jax_kwargs=None, **kwargs):
    """(JAX result, port result) as host arrays for one chunk."""
    ref = JaxInferencer(**(jax_kwargs or kwargs))(JaxChunk(arr))
    got = Inferencer(device="cpu", **kwargs)(Chunk(arr))
    return ref, got.host()


def _assert_bitwise(ref_chunk, got_chunk):
    ref = np.asarray(ref_chunk.array)
    got = got_chunk.array
    if isinstance(got, torch.Tensor):  # bfloat16
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              ref.view(np.int16))
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref)
    assert tuple(got_chunk.voxel_offset) == tuple(ref_chunk.voxel_offset)
    assert got_chunk.layer_type.value == ref_chunk.layer_type.value


# (8, 32, 32): 27 patches, so batch 2 carries a validity-0 padding row;
# (9, 35, 33): no alignment anywhere; (10, 40, 40): dense overlap
@pytest.mark.parametrize("shape", [(8, 32, 32), (9, 35, 33), (10, 40, 40)])
def test_identity_bitwise(shape):
    _assert_bitwise(*_both(_chunk(shape), **IDENTITY))


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32", "int64",
                                   "float64"])
def test_identity_bitwise_raw_and_host_converted_dtypes(dtype):
    """uint8/uint16/int32 ride raw and convert in the gather; int64 and
    float64 convert on the host, as in the JAX package."""
    _assert_bitwise(*_both(_chunk((9, 35, 33), dtype, seed=1), **IDENTITY))


@pytest.mark.parametrize("output_dtype", ["uint8", "bfloat16"])
def test_identity_bitwise_narrow_output(output_dtype):
    kwargs = dict(IDENTITY, output_dtype=output_dtype)
    _assert_bitwise(*_both(_chunk((9, 35, 33), "uint8", seed=2), **kwargs))


def test_identity_bitwise_crop_margin_and_batch_3():
    """Output patch (2, 12, 12) inside the (4, 16, 16) input, the margin
    cropped off the result; batch 3 pads the grid with two rows."""
    kwargs = dict(IDENTITY, output_patch_size=(2, 12, 12),
                  output_patch_overlap=(1, 4, 4), crop_output_margin=True,
                  batch_size=3)
    ref, got = _both(_chunk((10, 40, 40), seed=3), **kwargs)
    assert got.shape == (2, 8, 36, 36)
    _assert_bitwise(ref, got)


def test_identity_bitwise_shape_bucket_edge_padding():
    """A ragged uint16 chunk padded up to the bucket by replicating its
    boundary planes (index clamping on the raw chunk), cropped back."""
    kwargs = dict(IDENTITY, shape_bucket=(8, 24, 24))
    _assert_bitwise(*_both(_chunk((9, 35, 33), "uint16", seed=4), **kwargs))


def test_identity_bitwise_two_input_channels_myelin_mask():
    arr = _chunk((2, 8, 32, 32), seed=5)
    kwargs = dict(IDENTITY, num_input_channels=2, num_output_channels=3,
                  mask_myelin_threshold=0.5, crop_output_margin=True)
    ref, got = _both(arr, **kwargs)
    assert got.shape == (2, 8, 32, 32)
    _assert_bitwise(ref, got)


def test_identity_bitwise_augment():
    kwargs = dict(IDENTITY, augment=True)
    _assert_bitwise(*_both(_chunk((8, 32, 32), seed=6), **kwargs))


@pytest.mark.parametrize("case", ["dry_run", "all_zero"])
def test_blank_output_matches_jax(case):
    arr = np.zeros((8, 32, 32), np.float32) if case == "all_zero" \
        else _chunk((8, 32, 32))
    kwargs = dict(IDENTITY, num_output_channels=3, crop_output_margin=True,
                  output_patch_size=(2, 12, 12), mask_myelin_threshold=0.3,
                  dry_run=case == "dry_run")
    _assert_bitwise(*_both(arr, **kwargs))


def test_patch_grid_shape_matches_jax():
    for shape in [(8, 32, 32), (9, 35, 33), (64, 512, 512)]:
        kwargs = dict(IDENTITY, shape_bucket=(8, 24, 24))
        assert Inferencer(device="cpu", **kwargs).patch_grid_shape(shape) \
            == JaxInferencer(**kwargs).patch_grid_shape(shape)


# ---------------------------------------------------------------------------
# a small UNet3D in both packages
# ---------------------------------------------------------------------------
FEATS = (4, 6, 8)
DOWNS = ((1, 2, 2), (2, 2, 2))


def _unet_engines(cout=3, seed=0):
    """One set of numpy-drawn flax-layout params as a JAX engine and a
    port engine."""
    fnet = flax_unet3d.UNet3D(in_channels=1, out_channels=cout,
                              feature_maps=FEATS, down_factors=DOWNS)
    shapes = jax.eval_shape(lambda: flax_unet3d.init_params(fnet, PIN, 1))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return x * 0.1 + (1.0 if path[-1].key == "scale" else 0.0)

    params = jax.tree_util.tree_map_with_path(draw, shapes)

    def jax_apply(p, batch):
        y = fnet.apply({"params": p}, jnp.moveaxis(batch, 1, -1))
        return jnp.moveaxis(y, -1, 1)

    jax_engine = jax_engines.Engine(params=params, apply=jax_apply,
                                    num_input_channels=1,
                                    num_output_channels=cout)
    model = UNet3D(in_channels=1, out_channels=cout, feature_maps=FEATS,
                   down_factors=DOWNS).eval()
    model.load_state_dict(state_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    port_engine = engines.Engine(apply=model, num_input_channels=1,
                                 num_output_channels=cout, model=model)
    return jax_engine, port_engine


@pytest.mark.parametrize("output_dtype, augment, tol", [
    ("float32", False, 1e-5),
    ("float32", True, 1e-5),
    ("uint8", False, 1),
])
def test_unet_inferencer_within_tolerance(output_dtype, augment, tol):
    jax_engine, port_engine = _unet_engines()
    kwargs = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                  num_output_channels=3, framework="prebuilt", batch_size=2,
                  output_dtype=output_dtype, augment=augment)
    arr = _chunk((8, 32, 32), "uint8", seed=7)
    ref, got = _both(arr, jax_kwargs=dict(kwargs, engine=jax_engine),
                     engine=port_engine, **kwargs)
    ref = np.asarray(ref.array)
    assert got.array.dtype == ref.dtype and got.shape == ref.shape
    diff = np.abs(got.array.astype(np.float64) - ref.astype(np.float64))
    assert diff.max() <= tol


# ---------------------------------------------------------------------------
# device rules, unported options, counters
# ---------------------------------------------------------------------------
def test_cpu_run_takes_the_plain_path(monkeypatch):
    monkeypatch.setattr(gather, "launches", 0)
    monkeypatch.setattr(accumulate, "launches", 0)
    out = Inferencer(device="cpu", **IDENTITY)(Chunk(_chunk((8, 32, 32))))
    assert out.array.device.type == "cpu"
    assert gather.launches == 0 and accumulate.launches == 0


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Inferencer(**IDENTITY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["create-chunk", "--size", "8", "32", "32",
                  "inference", "-f", "identity", "-p", *map(str, PIN)])


@pytest.mark.parametrize("kwargs, match", [
    # fold is ported; with a mesh it still meets the multi-GPU raise
    pytest.param({"blend": "fold", "mesh": "data=2"}, "multi-GPU",
                 id="kwargs0-fold"),
    ({"mesh": "data=2"}, "multi-GPU"),
    ({"sharding": "patch"}, "multi-GPU"),
    ({"precision": "bf16"}, "precision"),
    ({"precision": "int8"}, "precision"),
    ({"mesh": "y=2"}, "multi-GPU"),
])
def test_unported_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        Inferencer(device="cpu", **dict(IDENTITY, **kwargs))


def test_tensor_payload_and_chunk_roundtrip():
    """A CPU-tensor payload is used as it is (not copied through numpy),
    the input is never written, and host() gives numpy back."""
    arr = _chunk((8, 32, 32), "uint8", seed=8)
    payload = torch.from_numpy(arr.copy())
    chunk = Chunk(payload, voxel_offset=(1, 2, 3))
    assert chunk.array is payload and not chunk.is_on_device
    assert chunk.device("cpu").array.data_ptr() == payload.data_ptr()
    out = Inferencer(device="cpu", **IDENTITY)(chunk)
    assert np.array_equal(payload.numpy(), arr)
    ref = JaxInferencer(**IDENTITY)(JaxChunk(arr, voxel_offset=(1, 2, 3)))
    _assert_bitwise(ref, out.host())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("output_dtype", ["uint8", "bfloat16"])
def test_cli_chain_matches_library(tmp_path, output_dtype):
    """save-npy writes bfloat16 results widened to float32 (npy has no
    bfloat16); the values are the JAX package's bits."""
    out_npy = tmp_path / "out.npy"
    rc = cli.main([
        "--device", "cpu",
        "create-chunk", "--size", "9", "35", "33", "--dtype", "uint16",
        "--pattern", "random",
        "inference", "--framework", "identity", "-p", *map(str, PIN),
        "-v", *map(str, OVERLAP), "-c", "2", "-b", "2",
        "--output-dtype", output_dtype,
        "save-npy", "-f", str(out_npy),
    ])
    assert rc == 0
    arr = JaxChunk.create(size=(9, 35, 33), dtype=np.uint16,
                          pattern="random").array
    ref = JaxInferencer(**dict(IDENTITY, crop_output_margin=True,
                               output_dtype=output_dtype))(JaxChunk(arr))
    expected = np.asarray(ref.array)
    if output_dtype == "bfloat16":
        expected = expected.astype(np.float32)
    got = np.load(out_npy)
    assert got.dtype == expected.dtype and np.array_equal(got, expected)


def test_cli_load_npy_crop_and_patch_num(tmp_path):
    arr = _chunk((8, 32, 32), seed=9)
    np.save(tmp_path / "in.npy", arr)
    common = ["--device", "cpu", "load-npy", "-f", str(tmp_path / "in.npy"),
              "inference", "-f", "identity", "-p", *map(str, PIN),
              "-v", *map(str, OVERLAP), "-c", "1", "--patch-num"]
    assert cli.main(common + ["3", "3", "3", "--output-crop-margin", "1",
                              "2", "2", "save-npy", "-f",
                              str(tmp_path / "out.npy")]) == 0
    ref = JaxInferencer(**dict(IDENTITY, num_output_channels=1))(
        JaxChunk(arr))
    expected = np.asarray(ref.array)[:, 1:-1, 2:-2, 2:-2]
    assert np.array_equal(np.load(tmp_path / "out.npy"), expected)
    with pytest.raises(SystemExit, match="--patch-num"):
        cli.main(common + ["2", "3", "3"])
