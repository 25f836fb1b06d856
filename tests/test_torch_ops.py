"""The PyTorch port's kernel modules against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (the XLA legs, and the
Pallas kernels in interpret mode) and through the port's function, whose
CPU tensors take the kernels' plain PyTorch versions. Gather, accumulate
and normalization must agree BITWISE: every step is an exact conversion,
copy or IEEE float32 operation applied in the same order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chunkflow_tpu.inference import bump as jax_bump
from chunkflow_tpu.inference import patching as jax_patching
from chunkflow_tpu.ops import blend as jax_blend
from chunkflow_tpu.ops import pallas_blend, pallas_gather, voting
from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.inference import bump, patching
from chunkflow_tpu_torch.ops import accumulate, blend, gather
from chunkflow_tpu_torch.ops import voting as torch_voting

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (3, 12, 18)
# no (sublane, 128) alignment anywhere: the TPU kernel's window logic
# is exercised, the port has none to get wrong
STARTS = np.array([[0, 0, 0], [1, 7, 13], [6, 28, 32], [2, 19, 5]], np.int32)


def _raw(dtype, rng, shape=(2, 9, 40, 50)):
    if dtype == "float32":
        return rng.standard_normal(shape).astype(np.float32)
    info = np.iinfo(np.dtype(dtype))
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32", "float32"])
def test_gather_plain_matches_jax_convert_and_slice(dtype):
    raw = _raw(dtype, np.random.default_rng(1))
    full = np.asarray(pallas_gather.convert_chunk(jnp.asarray(raw)))
    got = gather.gather_patches(torch.from_numpy(raw),
                                torch.from_numpy(STARTS), PIN).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 2) + PIN
    for b, (z, y, x) in enumerate(STARTS):
        exp = full[:, z:z + PIN[0], y:y + PIN[1], x:x + PIN[2]]
        assert np.array_equal(got[b], exp), (dtype, b)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16",
                                   "int32", "uint32", "float32"])
def test_gather_plain_storage_offset_view_matches_jax(dtype):
    """A contiguous view one element into its storage, at starts with
    every x alignment the CUDA kernel must handle."""
    shape = (2, 9, 40, 50)
    raw = _raw(dtype, np.random.default_rng(6), (int(np.prod(shape)) + 1,))
    view = raw[1:].reshape(shape)
    full = np.asarray(pallas_gather.convert_chunk(jnp.asarray(view)))
    chunk = torch.from_numpy(raw).flatten()[1:].view(shape)
    assert chunk.storage_offset() == 1 and chunk.is_contiguous()
    starts = np.array([[0, 0, 13], [1, 7, 1], [6, 28, 15], [2, 19, 31]],
                      np.int32)
    got = gather.gather_patches(chunk, torch.from_numpy(starts), PIN).numpy()
    for b, (z, y, x) in enumerate(starts):
        exp = full[:, z:z + PIN[0], y:y + PIN[1], x:x + PIN[2]]
        assert np.array_equal(got[b], exp), (dtype, b)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32", "float32"])
def test_gather_plain_matches_pallas_interpret(dtype):
    raw = _raw(dtype, np.random.default_rng(2))
    pad_y, pad_x = pallas_gather.gather_buffer_padding(PIN, raw.dtype)
    padded = np.pad(raw, [(0, 0), (0, 0), (0, pad_y), (0, pad_x)])
    ref = np.asarray(pallas_gather.gather_patches(
        jnp.asarray(padded), jnp.asarray(STARTS), PIN, interpret=True))
    got = gather.gather_patches(torch.from_numpy(raw),
                                torch.from_numpy(STARTS), PIN).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint32", "float64",
                                   "int64"])
def test_conversion_rules_match_jax(dtype):
    """raw_eligible and the scale agree with the JAX package for every
    dtype it names; the eligible ones convert bitwise."""
    assert gather.raw_eligible(dtype) == pallas_gather.raw_eligible(dtype)
    assert gather.int_scale(dtype) == pallas_gather._int_scale(dtype)
    if gather.raw_eligible(dtype):
        raw = _raw(dtype, np.random.default_rng(3))
        ref = np.asarray(pallas_gather.convert_chunk(jnp.asarray(raw)))
        got = gather.convert_chunk(torch.from_numpy(raw)).numpy()
        assert np.array_equal(got, ref)


def test_gather_validates_its_operands():
    chunk = torch.zeros((1, 4, 8, 8), dtype=torch.uint8)
    starts = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="leave the chunk"):
        gather.gather_patches(chunk, torch.tensor([[1, 0, 0]],
                                                  dtype=torch.int32),
                              (4, 4, 4))
    with pytest.raises(TypeError, match="int32"):
        gather.gather_patches(chunk, starts.long(), (2, 2, 2))
    with pytest.raises(TypeError, match="float64"):
        gather.gather_patches(chunk.double(), starts, (2, 2, 2))
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_patches(chunk.transpose(2, 3), starts, (2, 2, 2))


def _acc_fixture(seed, co=3, zyx=(5, 32, 40), B=5, pout=(3, 12, 16)):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((co,) + zyx).astype(np.float32)
    weight = rng.random(zyx).astype(np.float32)
    preds = rng.standard_normal((B, co) + pout).astype(np.float32)
    bmp = (rng.random(pout) * 5 + 1).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 0], np.float32)[:B]
    # dense overlap, a duplicate window and validity-0 rows: per-cell
    # addition order decides the bits
    starts = np.array([[0, 0, 0], [1, 6, 8], [2, 12, 16], [1, 6, 8],
                       [0, 0, 0]], np.int32)[:B]
    return out, weight, preds, bmp, valid, starts


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("pre_weighted", [False, True])
def test_accumulate_plain_matches_jax(monkeypatch, mode, pre_weighted):
    monkeypatch.setenv("CHUNKFLOW_PALLAS", mode)
    out, weight, preds, bmp, valid, starts = _acc_fixture(4)
    pout = bmp.shape
    acc, acc_w, pad_y, pad_x = jax_blend.make_accumulate(pout, bmp)
    pad = [(0, 0), (0, pad_y), (0, pad_x)]
    ref_out, ref_w = (acc_w if pre_weighted else acc)(
        jnp.asarray(np.pad(out, [(0, 0)] + pad)),
        jnp.asarray(np.pad(weight, pad)),
        jnp.asarray(preds), jnp.asarray(valid), jnp.asarray(starts),
    )
    zyx = weight.shape
    ref_out = np.asarray(ref_out)[:, :, :zyx[1], :zyx[2]]
    ref_w = np.asarray(ref_w)[:, :zyx[1], :zyx[2]]

    got_out, got_w = torch.from_numpy(out.copy()), torch.from_numpy(
        weight.copy())
    args = (got_out, got_w, torch.from_numpy(preds), torch.from_numpy(valid))
    if pre_weighted:
        accumulate.fused_accumulate_patches(
            *args, torch.from_numpy(bmp), torch.from_numpy(starts),
            pre_weighted=True)
    else:
        blend.make_accumulate(pout, torch.from_numpy(bmp))(
            *args, torch.from_numpy(starts))
    assert np.array_equal(got_out.numpy(), ref_out)
    assert np.array_equal(got_w.numpy(), ref_w)


def test_accumulate_direct_kernel_oracle():
    """The JAX kernel suite's numpy oracle, through the port's wrapper."""
    out, weight, preds, bmp, valid, starts = _acc_fixture(7, B=4)
    exp_out, exp_w = out.copy(), weight.copy()
    pz, py, px = bmp.shape
    for b, (z, y, x) in enumerate(starts):
        exp_out[:, z:z + pz, y:y + py, x:x + px] += \
            (preds[b] * bmp[None]) * valid[b]
        exp_w[z:z + pz, y:y + py, x:x + px] += bmp * valid[b]
    got = accumulate.fused_accumulate_patches(
        torch.from_numpy(out), torch.from_numpy(weight),
        torch.from_numpy(preds), torch.from_numpy(valid),
        torch.from_numpy(bmp), torch.from_numpy(starts))
    assert np.array_equal(got[0].numpy(), exp_out)
    assert np.array_equal(got[1].numpy(), exp_w)


def test_accumulate_validates_its_operands():
    out, weight, preds, bmp, valid, starts = (
        torch.from_numpy(a) for a in _acc_fixture(8))
    with pytest.raises(ValueError, match="leave the buffer"):
        accumulate.fused_accumulate_patches(
            out, weight, preds, valid, bmp, starts + 30)
    with pytest.raises(TypeError, match="float32"):
        accumulate.fused_accumulate_patches(
            out.double(), weight, preds, valid, bmp, starts)
    with pytest.raises(ValueError, match=r"\[B, co"):
        accumulate.fused_accumulate_patches(
            out, weight, preds[:, :2].contiguous(), valid, bmp, starts)
    with pytest.raises(TypeError, match="int32"):
        accumulate.fused_accumulate_patches(
            out, weight, preds, valid, bmp, starts.long())


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """CPU tensors never reach a kernel: the counters stay 0 and the
    build is never asked for."""
    def no_build(name):
        raise AssertionError(f"kernel {name} requested for CPU tensors")

    monkeypatch.setattr("chunkflow_tpu_torch._build.load", no_build)
    monkeypatch.setattr(gather, "launches", 0)
    monkeypatch.setattr(accumulate, "launches", 0)
    raw = torch.from_numpy(_raw("uint8", np.random.default_rng(5)))
    gather.gather_patches(raw, torch.from_numpy(STARTS), PIN)
    out, weight, preds, bmp, valid, starts = (
        torch.from_numpy(a) for a in _acc_fixture(9))
    accumulate.fused_accumulate_patches(out, weight, preds, valid, bmp, starts)
    assert gather.launches == 0 and accumulate.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_normalize_blend_matches_jax(dtype):
    rng = np.random.default_rng(10)
    weight = (rng.random((4, 9, 11)) * 3).astype(np.float32)
    weight[0] = 0.0          # nothing predicted: exact zeros
    weight[1, :3] = 1e-30    # below the 1e-20 floor
    out = (rng.standard_normal((2, 4, 9, 11)) * weight).astype(np.float32)
    out[:, 2] = np.abs(out[:, 2]) * 2  # quantization clips above 1
    ref = np.asarray(jax_blend.normalize_blend(
        jnp.asarray(out), jnp.asarray(weight), dtype))
    got = blend.normalize_blend(torch.from_numpy(out),
                                torch.from_numpy(weight), dtype)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              ref.view(np.int16))
    else:
        assert np.array_equal(got.numpy(), ref)
        assert got.numpy().dtype == ref.dtype


def test_mask_using_last_channel_matches_jax():
    arr = np.random.default_rng(11).random((3, 4, 6, 7)).astype(np.float32)
    ref = np.asarray(voting.mask_using_last_channel(JaxChunk(arr), 0.4).array)
    for payload in (arr, torch.from_numpy(arr)):
        got = torch_voting.mask_using_last_channel(Chunk(payload), 0.4)
        got = got.host().array
        assert isinstance(got, np.ndarray) and np.array_equal(got, ref)


@pytest.mark.parametrize("size", [(4, 16, 16), (2, 12, 12), (20, 256, 256)])
def test_bump_map_is_the_jax_packages(size):
    assert np.array_equal(bump.bump_map(size), jax_bump.bump_map(size))


@pytest.mark.parametrize("shape, pin, pout, overlap, batch", [
    ((9, 35, 33), (4, 16, 16), None, (2, 8, 8), 2),
    ((10, 40, 40), (4, 16, 16), (2, 12, 12), (1, 4, 4), 3),
    ((64, 512, 512), (20, 256, 256), None, (4, 64, 64), 2),
])
def test_patch_grid_is_the_jax_packages(shape, pin, pout, overlap, batch):
    ref = jax_patching.enumerate_patches(shape, pin, pout, overlap)
    got = patching.enumerate_patches(shape, pin, pout, overlap)
    assert np.array_equal(got.input_starts, ref.input_starts)
    assert np.array_equal(got.output_starts, ref.output_starts)
    assert tuple(got.crop_margin) == tuple(ref.crop_margin)
    for a, b in zip(patching.pad_to_batch(got, batch),
                    jax_patching.pad_to_batch(ref, batch)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
