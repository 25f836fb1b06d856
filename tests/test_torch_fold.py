"""The port's fold blend, and the blend/precision environment, against JAX.

The same numpy-seeded inputs go through the JAX package and the port on
the CPU. Fold is its own reference (its per-voxel sum order is not
scatter's), so it is compared with the JAX fold:

- with the JAX package run op by op (``jax.disable_jit``), BITWISE: the
  port repeats its arithmetic in its order — each prediction times the
  bump rounded to float32, then the parity classes added in ``cz``,
  ``cy``, ``cx`` order;
- with the JAX package compiled (how it runs), within 4 float32 ulp on
  a float32 output: XLA on the CPU fuses the bump multiply into each
  class add as one fused multiply-add, which rounds once where the port
  (and the JAX package op by op) rounds twice. Measured on these
  fixtures (``python -m tests.test_torch_fold`` prints each): at most 4
  ulp, 1.8e-7 max-abs (ROADMAP.md §3); bfloat16 and uint8 outputs round
  the difference away and are compared bitwise.

A small UNet3D is held within 1e-5 (the forward's summation order).
"""
import numpy as np
import pytest
import torch

import jax

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.inference.inferencer import Inferencer as JaxInferencer
from chunkflow_tpu.ops import fold_blend as jax_fold
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.inference import precision
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.ops import fold_blend
from tests.test_torch_inferencer import _unet_engines

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (4, 16, 16)
OVERLAP = (2, 8, 8)
FOLD = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
            num_output_channels=2, framework="identity", batch_size=2,
            crop_output_margin=False, blend="fold")
# the compiled JAX fold's fused multiply-adds (module docstring)
FMA_ULP = 4


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("CHUNKFLOW_BLEND", "CHUNKFLOW_PRECISION",
                "CHUNKFLOW_BLEND_STACK_MAX_GB"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(precision, "_WARNED_VALUES", set())


def _chunk(shape, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(0, np.iinfo(dtype).max, shape,
                            endpoint=True).astype(dtype)
    return rng.random(shape).astype(dtype)


def _host(chunk):
    """A port result's host payload as numpy (bfloat16 as its int16
    bits)."""
    arr = chunk.host().array
    if isinstance(arr, torch.Tensor):
        return arr.view(torch.int16).numpy()
    return arr


def _jax(arr, eager=False, **kwargs):
    if eager:
        with jax.disable_jit():
            out = JaxInferencer(**kwargs)(JaxChunk(arr))
    else:
        out = JaxInferencer(**kwargs)(JaxChunk(arr))
    ref = np.asarray(out.array)
    if ref.dtype.name == "bfloat16":
        ref = ref.view(np.int16)
    return ref


def _assert_within_ulp(got, ref, ulp):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype != np.float32:
        assert np.array_equal(got, ref)
        return
    np.testing.assert_array_max_ulp(got, ref, maxulp=ulp)


# ---------------------------------------------------------------------------
# geometry and the parity-class accumulation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pin, stride", [
    ((20, 256, 256), (16, 192, 192)),
    ((4, 16, 16), (2, 8, 8)),
    ((8, 24, 24), (2, 8, 8)),
    ((3, 5, 7), (1, 4, 2)),
])
def test_fold_geometry_matches_jax(pin, stride):
    for zyx in [(64, 512, 512), (36, 448, 448), (8, 32, 32), (9, 35, 33),
                (3, 32, 32), (1, 1, 1), (5, 17, 18), (40, 456, 456)]:
        padded = fold_blend.fold_pad_shape(zyx, pin, stride)
        assert padded == jax_fold.fold_pad_shape(zyx, pin, stride)
        assert fold_blend.fold_grid(padded, pin, stride) \
            == jax_fold.fold_grid(padded, pin, stride)
    ragged = tuple(p + s + 1 for p, s in zip(pin, stride))
    with pytest.raises(ValueError):
        fold_blend.fold_grid(ragged, pin, stride)


@pytest.mark.parametrize("grid, stride, pout", [
    ((3, 2, 2), (4, 12, 12), (8, 16, 16)),   # k=2 per axis
    ((2, 4, 3), (8, 6, 8), (8, 16, 16)),     # kz=1, ky=3, kx=2
    ((1, 1, 5), (4, 16, 5), (4, 16, 12)),    # heavy x overlap, kx=3
])
def test_fold_accumulate_bitwise(grid, stride, pout):
    """The cases of tests/ops/test_fold_blend.py, bitwise: the same
    float32 adds in the same class order."""
    rng = np.random.default_rng(0)
    stack = rng.random((int(np.prod(grid)), 2) + pout).astype(np.float32)
    offset = (1, 2, 3)
    out_zyx = tuple(offset[i] + (grid[i] - 1) * stride[i] + pout[i]
                    for i in range(3))
    ref = np.asarray(jax_fold.fold_accumulate(
        stack, grid, stride, pout, offset, out_zyx))
    got = fold_blend.fold_accumulate(torch.from_numpy(stack), grid, stride,
                                     pout, offset, out_zyx)
    assert np.array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the fold inferencer against the JAX fold
# ---------------------------------------------------------------------------
FIXTURES = {
    "aligned": ((8, 32, 32), {}),
    "ragged": ((9, 35, 33), {}),
    "ragged_wide": ((8, 33, 37), {}),
    "thinner_than_a_patch": ((3, 32, 32), {}),
    "margin": ((10, 40, 40), dict(output_patch_size=(2, 12, 12),
                                  output_patch_overlap=(1, 4, 4),
                                  crop_output_margin=True)),
    "tta_bfloat16": ((8, 32, 32), dict(augment=True,
                                       output_dtype="bfloat16")),
    "uint8": ((9, 35, 33), dict(output_dtype="uint8")),
    "uint16_input": ((9, 35, 33), dict(dtype_in="uint16")),
}


def fold_gap(name):
    """(port result, JAX op-by-op result, JAX compiled result) on the
    fixture ``name``; run as a script, prints each fixture's gap to the
    compiled JAX fold (max ulp, max-abs, first differing index)."""
    shape, extra = FIXTURES[name]
    extra = dict(extra)
    arr = _chunk(shape, seed=len(name), dtype=extra.pop("dtype_in",
                                                        "float32"))
    kwargs = dict(FOLD, **extra)
    got = _host(Inferencer(device="cpu", **kwargs)(Chunk(arr)))
    return got, _jax(arr, eager=True, **kwargs), _jax(arr, **kwargs)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fold_identity_matches_jax(name):
    got, eager, compiled = fold_gap(name)
    assert np.array_equal(got, eager)
    _assert_within_ulp(got, compiled, FMA_ULP)


def test_fold_unet_within_tolerance():
    jax_engine, port_engine = _unet_engines()
    kwargs = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                  num_output_channels=3, framework="prebuilt", batch_size=2,
                  blend="fold")
    arr = _chunk((9, 35, 33), seed=7, dtype="uint8")
    ref = _jax(arr, engine=jax_engine, **kwargs)
    got = _host(Inferencer(device="cpu", engine=port_engine, **kwargs)(
        Chunk(arr)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5


def test_fold_patch_grid_shape_matches_jax(monkeypatch):
    kwargs = dict(FOLD, shape_bucket=(8, 24, 24))
    for shape in [(8, 32, 32), (9, 35, 33), (3, 32, 32), (64, 512, 512)]:
        for bucket in (None, (8, 24, 24)):
            kw = dict(kwargs, shape_bucket=bucket)
            assert Inferencer(device="cpu", **kw).patch_grid_shape(shape) \
                == JaxInferencer(**kw).patch_grid_shape(shape)
    monkeypatch.setenv("CHUNKFLOW_BLEND_STACK_MAX_GB", "0.000001")
    for shape in [(8, 32, 32), (3, 32, 32)]:
        assert Inferencer(device="cpu", **FOLD).patch_grid_shape(shape) \
            == JaxInferencer(**FOLD).patch_grid_shape(shape)


@pytest.mark.parametrize("shape", [(8, 32, 32), (3, 32, 32)])
def test_fold_budget_fallback_matches_jax(monkeypatch, capfd, shape):
    """Over the stack budget fold falls back to the scatter path, says so
    on stderr, and gives the JAX fallback's bits (thin chunks keep their
    one-patch padding)."""
    monkeypatch.setenv("CHUNKFLOW_BLEND_STACK_MAX_GB", "0.000001")
    arr = _chunk(shape, seed=6)
    inferencer = Inferencer(device="cpu", **FOLD)
    assert not inferencer._use_fold(inferencer._run_shape(shape))
    capfd.readouterr()
    got = _host(inferencer(Chunk(arr)))
    assert "fold blend gated off" in capfd.readouterr().err
    assert np.array_equal(got, _jax(arr, **FOLD))


# ---------------------------------------------------------------------------
# the repaired environment: CHUNKFLOW_BLEND and CHUNKFLOW_PRECISION
# ---------------------------------------------------------------------------
def test_blend_env_selects_fold(monkeypatch):
    """blend='auto' reads CHUNKFLOW_BLEND as the JAX package does: with
    fold set, the port runs fold and gives the JAX fold's result."""
    monkeypatch.setenv("CHUNKFLOW_BLEND", "fold")
    kwargs = dict(FOLD, blend="auto")
    inferencer = Inferencer(device="cpu", **kwargs)
    assert inferencer.blend_mode == "fold"
    arr = _chunk((9, 35, 33), seed=11)
    got = _host(inferencer(Chunk(arr)))
    assert np.array_equal(got, _jax(arr, eager=True, **kwargs))
    # a convnet sees the edge-replicated context only under fold
    jax_engine, port_engine = _unet_engines()
    unet = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                num_output_channels=3, framework="prebuilt", batch_size=2)
    ref = _jax(arr, engine=jax_engine, **unet)
    got = _host(Inferencer(device="cpu", engine=port_engine, **unet)(
        Chunk(arr)))
    assert np.abs(got - ref).max() <= 1e-5
    monkeypatch.setenv("CHUNKFLOW_BLEND", "SCATTER")
    assert Inferencer(device="cpu", **kwargs).blend_mode == "scatter"


@pytest.mark.parametrize("kwargs, env, error, match", [
    ({"blend": "auto"}, "gather", ValueError, "unknown blend"),
    ({"blend": "fold", "sharding": "patch"}, None, ValueError,
     "single-device"),
    ({"blend": "auto", "sharding": "spatial"}, "fold", ValueError,
     "single-device"),
])
def test_blend_errors_match_jax(monkeypatch, kwargs, env, error, match):
    if env is not None:
        monkeypatch.setenv("CHUNKFLOW_BLEND", env)
    args = dict(FOLD, **kwargs)
    with pytest.raises(error, match=match):
        JaxInferencer(**args)
    with pytest.raises(error, match=match):
        Inferencer(device="cpu", **args)


@pytest.mark.parametrize("value", ["bf16", "bfloat16", "int8", "I8"])
def test_precision_env_raises_where_jax_quantizes(monkeypatch, value):
    """CHUNKFLOW_PRECISION naming a quantized forward selects the JAX
    package's precision (the name is kept from when the port raised
    here), and the fold result under it is the JAX fold's: bitwise the
    JAX package op by op, within FMA_ULP of the compiled fold."""
    monkeypatch.setenv("CHUNKFLOW_PRECISION", value)
    port = Inferencer(device="cpu", **FOLD)
    assert port.precision == JaxInferencer(**FOLD).precision != "float32"
    arr = _chunk((9, 35, 33), seed=5)
    got = _host(port(Chunk(arr)))
    assert np.array_equal(got, _jax(arr, eager=True, **FOLD))
    _assert_within_ulp(got, _jax(arr, **FOLD), FMA_ULP)


def test_precision_env_float32_and_typo(monkeypatch, capfd):
    arr = _chunk((8, 32, 32), seed=12)
    kwargs = dict(FOLD, blend="scatter")
    want = _host(Inferencer(device="cpu", **kwargs)(Chunk(arr)))
    for value in ("float32", "F32", "fp32", ""):
        monkeypatch.setenv("CHUNKFLOW_PRECISION", value)
        assert Inferencer(device="cpu", **kwargs).precision == "float32"
    capfd.readouterr()
    monkeypatch.setenv("CHUNKFLOW_PRECISION", "bf61")
    got = _host(Inferencer(device="cpu", **kwargs)(Chunk(arr)))
    Inferencer(device="cpu", **kwargs)
    err = capfd.readouterr().err
    assert err.count("CHUNKFLOW_PRECISION='bf61' is not a recognized") == 1
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="precision must be one of"):
        Inferencer(device="cpu", precision="fp16", **kwargs)
    assert Inferencer(device="cpu", precision="f32", **kwargs).precision \
        == "float32"


if __name__ == "__main__":
    for fixture in FIXTURES:
        port, _, ref = fold_gap(fixture)
        diff = np.abs(port.astype(np.float64) - ref.astype(np.float64))
        ulp = 0
        if port.dtype == np.float32:
            ulp = int(np.abs(port.view(np.int32).astype(np.int64)
                             - ref.view(np.int32)).max())
        first = np.argwhere(diff > 0)[:1].tolist()
        print(f"{fixture}: max ulp {ulp}, max-abs {diff.max():.3g}, "
              f"first differing index {first[0] if first else None}")
