"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``: every test needs an NVIDIA GPU (and ``nvcc`` to build
the kernels) and skips elsewhere. The file imports no JAX, so on a
machine without it run it alone, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.ops import accumulate, gather

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _raw(dtype, rng, shape):
    if dtype == "float32":
        return rng.standard_normal(shape).astype(np.float32)
    info = np.iinfo(np.dtype(dtype))
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


# wider than one shared-memory tile of the kernel (24,560 bytes a row):
# the kernel stages such a row in segments
WIDE = 50_000


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("ci", [1, 2])
@pytest.mark.parametrize("px", [16, 18, WIDE])
@pytest.mark.parametrize("x_mod16", [0, 1, 7, 8, 15])
@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16",
                                   "int32", "uint32", "float32"])
def test_gather_kernel_is_its_plain_version(cuda, dtype, x_mod16, px, ci,
                                            offset):
    """Any x start, rows of px % 4 != 0 floats, a row pitch that is no
    multiple of 16 bytes, rows wider than a tile, and a contiguous view
    ``offset`` elements into its storage (the kernel aligns by the
    absolute address): bitwise the plain version, in one launch."""
    if px == WIDE:
        px = WIDE // np.dtype(dtype).itemsize + 3
    zyx, pin = (6, 20, px + 41), (3, 5, px)
    n_el = ci * int(np.prod(zyx))
    raw = _raw(dtype, np.random.default_rng(x_mod16), (n_el + offset,))
    chunk = torch.from_numpy(raw).to(cuda)[offset:].view((ci,) + zyx)
    assert chunk.storage_offset() == offset and chunk.is_contiguous()
    starts = torch.tensor([[0, 0, x_mod16], [1, 3, 16 + x_mod16],
                           [3, 15, zyx[2] - px]], dtype=torch.int32)
    before = gather.launches
    got = gather.gather_patches(chunk, starts, pin)
    assert gather.launches == before + 1
    ref = gather.gather_patches_plain(chunk.cpu(), starts, pin)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("pre_weighted", [False, True])
def test_accumulate_kernel_is_its_plain_version(cuda, pre_weighted):
    rng = np.random.default_rng(1)
    co, zyx, pout = 3, (5, 32, 40), (3, 12, 16)
    out = torch.from_numpy(rng.standard_normal((co,) + zyx).astype(
        np.float32))
    weight = torch.from_numpy(rng.random(zyx).astype(np.float32))
    preds = torch.from_numpy(rng.standard_normal((5, co) + pout).astype(
        np.float32))
    bump = torch.from_numpy((rng.random(pout) * 5 + 1).astype(np.float32))
    valid = torch.tensor([1, 1, 1, 0, 0], dtype=torch.float32)
    starts = torch.tensor([[0, 0, 0], [1, 6, 8], [2, 12, 16], [1, 6, 8],
                           [0, 0, 0]], dtype=torch.int32)
    ref = accumulate.fused_accumulate_patches_plain(
        out.clone(), weight.clone(), preds, valid, bump, starts,
        pre_weighted)
    before = accumulate.launches
    got = accumulate.fused_accumulate_patches(
        out.to(cuda), weight.to(cuda), preds.to(cuda), valid.to(cuda),
        bump.to(cuda), starts, pre_weighted)
    assert accumulate.launches == before + 1
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])


def test_batches_larger_than_one_launch(cuda):
    """More rows than one launch's parameters hold: the wrappers split the
    batch into launches in ascending order — still bitwise."""
    rng = np.random.default_rng(2)
    zyx, pout, n = (6, 30, 34), (3, 8, 9), 70
    starts = torch.from_numpy(np.stack(
        [rng.integers(0, e - p + 1, n) for e, p in zip(zyx, pout)],
        axis=1).astype(np.int32))
    chunk = torch.from_numpy(rng.integers(0, 65535, (1,) + zyx).astype(
        np.uint16))
    before = gather.launches
    assert torch.equal(
        gather.gather_patches(chunk.to(cuda), starts, pout).cpu(),
        gather.gather_patches_plain(chunk, starts, pout))
    assert gather.launches == before + 2
    preds = torch.from_numpy(rng.standard_normal((n, 2) + pout).astype(
        np.float32))
    valid = torch.from_numpy((rng.random(n) > 0.2).astype(np.float32))
    bump = torch.from_numpy((rng.random(pout) + 1).astype(np.float32))
    ref = accumulate.fused_accumulate_patches_plain(
        torch.zeros((2,) + zyx), torch.zeros(zyx), preds, valid, bump, starts)
    got = accumulate.fused_accumulate_patches(
        torch.zeros((2,) + zyx, device=cuda), torch.zeros(zyx, device=cuda),
        preds.to(cuda), valid.to(cuda), bump.to(cuda), starts)
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_identity_inferencer_card_equals_cpu(cuda, dtype):
    chunk = Chunk.create(size=(9, 35, 33), dtype=np.dtype(dtype),
                         pattern="random")
    kwargs = dict(input_patch_size=(4, 16, 16),
                  output_patch_overlap=(2, 8, 8), num_output_channels=2,
                  framework="identity", batch_size=2)
    on_cpu = Inferencer(device="cpu", **kwargs)(chunk).host().array
    gather.launches = accumulate.launches = 0
    on_card = Inferencer(**kwargs)(chunk)
    assert on_card.is_on_device
    assert gather.launches > 0 and accumulate.launches > 0
    assert np.array_equal(on_card.host().array, on_cpu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["parity", "rsunet", "tpu", "tpu_s2d4"])
def test_convnet_kernel_path_is_the_plain_path(cuda, monkeypatch, variant,
                                               dtype):
    """Every family at full width, seeded weights, in both compute
    dtypes: the kernels give bitwise what their plain versions give
    around the same deterministic cuDNN forward."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    chunk = Chunk.create(size=(6, 48, 48), dtype=np.uint8, pattern="random")
    inferencer = Inferencer(input_patch_size=(4, 32, 32),
                            output_patch_overlap=(2, 16, 16),
                            num_output_channels=3, framework="pytorch",
                            model_variant=variant, dtype=dtype, batch_size=2)
    gather.launches = accumulate.launches = 0
    got = inferencer(chunk).host().array
    assert gather.launches > 0 and accumulate.launches > 0
    monkeypatch.setattr(gather, "gather_patches", gather.gather_patches_plain)
    monkeypatch.setattr(accumulate, "fused_accumulate_patches",
                        accumulate.fused_accumulate_patches_plain)
    ref = inferencer(chunk).host().array
    assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1
    assert np.array_equal(got, ref)
