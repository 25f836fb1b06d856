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


# ---------------------------------------------------------------------------
# the streamed path and fold on the card
# ---------------------------------------------------------------------------
STREAM_KW = dict(input_patch_size=(4, 32, 32), output_patch_overlap=(2, 16, 16),
                 num_output_channels=3, batch_size=2)


def _stream_chunks(n=4, shape=(6, 48, 48)):
    rng = np.random.default_rng(3)
    return [Chunk(rng.integers(0, 256, shape, endpoint=False).astype(
        np.uint8), voxel_offset=(i, 0, 0)) for i in range(n)]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("framework, variant, dtype", [
    ("identity", "parity", "float32"),
    ("pytorch", "tpu_s2d4", "bfloat16"),
])
def test_stream_on_card_is_the_serial_path(cuda, monkeypatch, framework,
                                           variant, dtype, adaptive):
    """Uploads on one stream, downloads on another, compute between: the
    streamed results are bitwise the serial ones, through the kernels."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    inferencer = Inferencer(framework=framework, model_variant=variant,
                            dtype=dtype, **STREAM_KW)
    chunks = _stream_chunks()
    gather.launches = accumulate.launches = 0
    serial = [inferencer(c).host().array for c in chunks]
    counts = (gather.launches, accumulate.launches)
    gather.launches = accumulate.launches = 0
    out = list(inferencer.stream(iter(chunks), adaptive=adaptive))
    assert counts[0] > 0 and (gather.launches, accumulate.launches) == counts
    for ref, got in zip(serial, out):
        assert not got.is_on_device
        assert np.array_equal(got.array, ref)


def test_dispatch_path_never_waits_for_the_card(cuda):
    """stage + infer_async for several chunks under the sync debug mode,
    which raises on any call that waits for the device (.item(), bool(),
    .cpu(), a pageable copy)."""
    inferencer = Inferencer(framework="identity", **STREAM_KW)
    chunks = _stream_chunks(n=3)
    serial = [inferencer(c).host().array for c in chunks]
    inferencer.infer_async(inferencer.stage(chunks[0])).host()  # warm-up
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [inferencer.infer_async(inferencer.stage(c), consume=True)
                for c in chunks]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for ref, out in zip(serial, outs):
        assert np.array_equal(out.host().array, ref)


@pytest.mark.parametrize("shape", [(6, 48, 48), (7, 53, 61)])
def test_fold_on_card_is_the_cpu_port(cuda, shape):
    chunk = Chunk.create(size=shape, dtype=np.uint8, pattern="random")
    kwargs = dict(STREAM_KW, framework="identity", blend="fold")
    on_cpu = Inferencer(device="cpu", **kwargs)(chunk).host().array
    gather.launches = accumulate.launches = 0
    on_card = Inferencer(**kwargs)(chunk)
    assert gather.launches == accumulate.launches == 0  # fold: no kernels
    assert np.array_equal(on_card.host().array, on_cpu)


def test_caller_device_chunk_unchanged_after_stream(cuda):
    chunks = _stream_chunks(n=2)
    inferencer = Inferencer(framework="identity", **STREAM_KW)
    serial = [inferencer(c).host().array for c in chunks]
    on_card = [c.device() for c in chunks]
    before = [c.array.clone() for c in on_card]
    out = list(inferencer.stream(iter(on_card)))
    torch.cuda.synchronize()
    for dev, copy, ref, got in zip(on_card, before, serial, out):
        assert torch.equal(dev.array, copy)
        assert np.array_equal(got.array, ref)


# ---------------------------------------------------------------------------
# float32 stays float32 whatever the process's flags
# ---------------------------------------------------------------------------
def test_float32_forward_under_default_flags(cuda, monkeypatch, tmp_path):
    """With PyTorch's default global flags (cuDNN TF32 on) the library
    Inferencer and the CLI compute the float32 forward on one 8x64x64
    patch: within 1e-4 of the CPU, bitwise the forward under the flags a
    caller would set by hand (TF32 off, deterministic, no autotuning),
    and the process's flags are as they were afterwards."""
    from chunkflow_tpu_torch.flow import cli

    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    kwargs = dict(input_patch_size=(8, 64, 64), num_output_channels=3,
                  framework="pytorch", batch_size=1)
    chunk = Chunk.create(size=(8, 64, 64), dtype=np.uint8, pattern="random")
    on_card = Inferencer(**kwargs)(chunk).host().array
    assert cudnn.allow_tf32 and not cudnn.deterministic
    on_cpu = Inferencer(device="cpu", **kwargs)(chunk).host().array
    assert np.abs(on_card - on_cpu).max() <= 1e-4
    npy = tmp_path / "out.npy"
    assert cli.main(["create-chunk", "--size", "8", "64", "64", "--pattern",
                     "random", "inference", "--framework", "pytorch",
                     "--input-patch-size", "8", "64", "64",
                     "--num-output-channels", "3",
                     "save-npy", "--file-name", str(npy)]) == 0
    assert np.array_equal(np.load(npy), on_card)
    monkeypatch.setattr(cudnn, "allow_tf32", False)
    monkeypatch.setattr(cudnn, "deterministic", True)
    by_hand = Inferencer(**kwargs)(chunk).host().array
    assert np.array_equal(by_hand, on_card)
