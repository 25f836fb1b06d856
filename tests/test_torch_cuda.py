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
# RSUNet's convolution epilogue
# ---------------------------------------------------------------------------
EPILOGUE_MODES = ("bias", "affine", "residual", "skip")
# (y's dtype, the compute dtype its parameters round to): the int8 real
# leg's float32 sums in a bfloat16 model is the third
EPILOGUE_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
                   "f32": (torch.float32, torch.float32),
                   "f32_bf16_params": (torch.float32, torch.bfloat16)}
# [N, C, D, H, W]: whole vectors with one channel a vector; planes of
# 5 * 7 * 9 elements (ragged: no multiple of 8 or 4, and the element count
# neither) at width 36
EPILOGUE_SHAPES = {"vectors": (2, 28, 4, 32, 32),
                   "ragged": (1, 36, 5, 7, 9)}
EPILOGUE_SPECIALS = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _epilogue_operands(cuda, mode, dtype, shape, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, c = shape[:2]
    y = torch.randn(shape, generator=g) * 3
    other = torch.randn(shape, generator=g) * 3
    for i, v in enumerate(EPILOGUE_SPECIALS):
        y.view(-1)[i * 37] = v
        other.view(-1)[i * 41 + 1] = v
    params = [torch.randn(c, generator=g) for _ in range(3)]
    params[0][1], params[1][2], params[2][3] = -0.0, -0.0, float("inf")
    params[1][4], params[2][5] = float("nan"), float("-inf")

    def place(t):
        t = t.to(dtype).to(cuda)
        if channels_last:
            t = t.contiguous(memory_format=torch.channels_last_3d)
        return t

    bias, scale, shift = (p.to(cuda) for p in params)
    affine = mode in ("affine", "residual")
    return dict(y=place(y), bias=bias, scale=scale if affine else None,
                shift=shift if affine else None,
                other=place(other) if mode in ("residual", "skip") else None)


@pytest.mark.parametrize("shape", list(EPILOGUE_SHAPES))
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtypes", list(EPILOGUE_DTYPES))
@pytest.mark.parametrize("mode", EPILOGUE_MODES)
def test_conv_epilogue_kernel_is_its_plain_version(cuda, mode, dtypes,
                                                   channels_last, shape):
    """Each mode, dtype and layout, NaN, infinities and signed zeros in
    every operand, and a ragged element count: bitwise the plain
    sequence on the card, in place, one launch."""
    from chunkflow_tpu_torch.ops import conv_epilogue

    ydt, dt = EPILOGUE_DTYPES[dtypes]
    ops = _epilogue_operands(cuda, mode, ydt, EPILOGUE_SHAPES[shape],
                             channels_last)
    y = ops.pop("y")
    ref = conv_epilogue.conv_epilogue_plain(y.clone(), dtype=dt, **ops)
    before = conv_epilogue.launches
    with torch.no_grad():
        got = conv_epilogue.conv_epilogue(y, dtype=dt, **ops)
    assert conv_epilogue.launches == before + 1
    assert got is y and got.dtype == ref.dtype
    assert torch.equal(_bits(got.contiguous()), _bits(ref.contiguous()))


def test_conv_epilogue_relu_of_signed_zero_and_nan(cuda):
    """The ReLU's edge values alone: -0, +0, NaN, -inf after the shift."""
    from chunkflow_tpu_torch.ops import conv_epilogue

    for ydt in (torch.bfloat16, torch.float32):
        y = torch.tensor([-0.0, 0.0, float("nan"), float("-inf"), -1.0,
                          2.0, -0.0, 0.0], dtype=ydt,
                         device=cuda).view(1, 8, 1, 1, 1)
        z = torch.zeros(8, device=cuda)
        minus = torch.full((8,), -0.0, device=cuda)
        one = torch.ones(8, device=cuda)
        for bias, shift in ((minus, minus), (z, z), (minus, z), (z, minus)):
            ref = conv_epilogue.conv_epilogue_plain(y.clone(), bias, one,
                                                    shift)
            got = conv_epilogue.conv_epilogue(y.clone(), bias, one, shift)
            assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("case", ["cpu_bias", "cpu_other", "float16",
                                  "float64_bias", "bf16_y_f32_params",
                                  "strided", "other_layout", "grad",
                                  "offset_y", "offset_other", "channels"])
def test_conv_epilogue_wrapper_refuses(cuda, case):
    """The wrapper's refusals, and the launcher's (a ``y`` or ``other``
    one element into its storage, so not 16-byte aligned; more than 2048
    channels): each raises and launches nothing."""
    from chunkflow_tpu_torch.ops import conv_epilogue

    def offset(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        return flat[1:].view(t.shape).copy_(t)

    y = torch.randn(2, 4, 3, 8, 8, device=cuda)
    p = torch.randn(4, device=cuda)
    kw = dict(y=y, bias=p, scale=p, shift=p, other=None, dtype=None)
    error = ValueError
    if case == "cpu_bias":
        kw["bias"] = p.cpu()
    elif case == "cpu_other":
        kw["other"] = y.cpu()
    elif case == "float16":
        kw["y"], error = y.half(), TypeError
    elif case == "float64_bias":
        kw["bias"], error = p.double(), TypeError
    elif case == "bf16_y_f32_params":
        kw.update(y=y.bfloat16(), dtype=torch.float32)
        error = TypeError
    elif case == "strided":
        kw["y"] = y.transpose(3, 4)
    elif case == "other_layout":
        kw["other"] = y.contiguous(memory_format=torch.channels_last_3d)
    elif case == "offset_y":
        kw["y"], error = offset(y), RuntimeError
    elif case == "offset_other":
        kw["other"], error = offset(y), RuntimeError
    elif case == "channels":
        p = torch.randn(2049, device=cuda)
        kw.update(y=torch.randn(1, 2049, 1, 2, 2, device=cuda), bias=p,
                  scale=p, shift=p)
        error = RuntimeError
    else:
        kw["y"], error = y.requires_grad_(), RuntimeError
    before = conv_epilogue.launches
    with pytest.raises(error):
        conv_epilogue.conv_epilogue(**kw)
    assert conv_epilogue.launches == before


def _rsunet_bf16(cuda, dtype=torch.bfloat16):
    """The benchmark configuration's RSUNet: widths 28-80, 1x2x2 pooling,
    seeded kernels and folded batch norms."""
    from chunkflow_tpu_torch.models.rsunet import RSUNet
    from chunkflow_tpu_torch.models.unet3d import seeded_init

    model = RSUNet(1, 3, width=(28, 36, 48, 64, 80),
                   down_factors=((1, 2, 2),) * 4, dtype=dtype).eval()
    g = torch.Generator().manual_seed(7)
    seeded_init(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".bn" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.2
                        + (1.0 if name.endswith("weight") else 0.0))
    return model.to(cuda)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rsunet_forward_with_epilogue_kernel_is_the_plain_sequence(
        cuda, monkeypatch, dtype):
    """A whole ``rsunet-bf16``-width forward on one batch of two
    20x256x256 patches, under the engine's flags: bitwise the same
    forward through the plain epilogue, 32 launches a batch."""
    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.ops import conv_epilogue

    model = _rsunet_bf16(cuda, getattr(torch, dtype))
    x = torch.rand((2, 1, 20, 256, 256),
                   generator=torch.Generator().manual_seed(2)).to(cuda)
    before = conv_epilogue.launches
    with torch.no_grad(), engines.exact_float32():
        got = model(x)
        assert conv_epilogue.launches == before + 32
        monkeypatch.setattr(conv_epilogue, "conv_epilogue",
                            conv_epilogue.conv_epilogue_plain)
        ref = model(x)
    assert conv_epilogue.launches == before + 32
    assert torch.isfinite(got).all() and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("leg", ["fake", "fakeint", "real"])
def test_rsunet_int8_legs_with_epilogue_kernel_are_the_plain_sequence(
        cuda, monkeypatch, leg, dtype):
    """The int8 legs mark activations by the tensors torch functions
    return; the kernel writes into the marked convolution output, so
    each leg quantizes what it quantized before: bitwise the plain
    epilogue's forward."""
    from chunkflow_tpu_torch.inference import engines, precision
    from chunkflow_tpu_torch.ops import conv_epilogue

    engine = engines.create_engine("pytorch", model_variant="rsunet",
                                   dtype=dtype)
    engine.model.to(cuda)
    batch = torch.rand((2, 1, 4, 32, 32),
                       generator=torch.Generator().manual_seed(1)).to(cuda)
    monkeypatch.setenv("CHUNKFLOW_INT8", leg)

    def run():
        with torch.no_grad():
            return precision.wrap_apply(engine.apply, "int8", engine.params,
                                        engine.call)(batch)

    before = conv_epilogue.launches
    got = run()
    assert conv_epilogue.launches > before
    monkeypatch.setattr(conv_epilogue, "conv_epilogue",
                        conv_epilogue.conv_epilogue_plain)
    ref = run()
    assert torch.isfinite(got).all() and torch.equal(got, ref)


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


def _devtrace():
    """The benchmark's device trace (``portbench/devtrace.py``): the
    profiler session its metrics read."""
    import sys
    from pathlib import Path

    bench = str(Path(__file__).resolve().parent.parent / "portbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import devtrace

    return devtrace


def test_span_holds_its_kernel_on_the_device_trace_clock(cuda):
    """A span around a kernel that spins for milliseconds, then a
    synchronize, contains that kernel's interval as the profiler stamps
    it: the span ring and the device trace are on one clock."""
    from chunkflow_tpu_torch.core import telemetry

    devtrace = _devtrace()
    tracer = devtrace.Tracer()
    tracer.warm(torch)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    tracer.start()
    try:
        with telemetry.span("test/spin") as sp:
            torch.cuda._sleep(40_000_000)
            torch.cuda.synchronize()
    finally:
        events = tracer.stop(torch)
    kernels = [(e - s, s, e) for n, s, e in events if not devtrace.is_copy(n)]
    _, start, end = max(kernels)
    lead, tail = start - sp.start_ns / 1e3, sp.end_ns / 1e3 - end
    assert end - start > 5000
    assert lead >= 0 and tail >= 0, (lead, tail)


def test_forward_device_time_is_the_traced_forward(cuda):
    """``inference/forward_device`` of one chunk, from the event pairs the
    blend records around each forward, is within 10% of the device time
    the trace gives that chunk's forward kernels (every kernel but the
    gather, the accumulate, copies and memsets; the zero fills and the
    normalization are a few of them)."""
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.flow.pipeline import _drain_host

    devtrace = _devtrace()
    inferencer = Inferencer(input_patch_size=(20, 256, 256),
                            output_patch_overlap=(4, 64, 64),
                            num_output_channels=3, framework="pytorch",
                            model_variant="rsunet", dtype="bfloat16",
                            batch_size=2)
    rng = np.random.default_rng(11)
    chunk = Chunk(rng.integers(0, 256, (20, 640, 640)).astype(np.uint8))
    _drain_host(inferencer.infer_async(inferencer.stage(chunk)), "warm")
    tracer = devtrace.Tracer()
    tracer.warm(torch)
    telemetry.reset()
    tracer.start()
    try:
        out = inferencer.infer_async(inferencer.stage(chunk), consume=True)
        _drain_host(out, 0)
    finally:
        events = tracer.stop(torch)
    h = telemetry.snapshot()["hists"]["inference/forward_device"]
    traced = sum(e - s for n, s, e in events
                 if not devtrace.is_copy(n) and "gather_kernel" not in n
                 and "accumulate_kernel" not in n) / 1e6
    assert h["count"] == 1
    assert abs(h["total"] / traced - 1) < 0.10, (h["total"], traced)


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


# ---------------------------------------------------------------------------
# chunk operators: each card leg bitwise its CPU leg (the JAX package's
# host arithmetic, or the port's torch leg on the CPU for the operators the
# JAX package runs in jnp)
# ---------------------------------------------------------------------------
def _card_and_host(arr, cuda, cls=Chunk, **meta):
    meta = dict(dict(voxel_offset=(3, 17, 9), voxel_size=(40, 4, 4)), **meta)
    return (cls(torch.from_numpy(arr.copy()).to(cuda), **meta),
            cls(arr.copy(), **meta))


def _assert_card_is_host(card, host):
    assert card.array.device.type == "cuda"
    got = card.host().array
    want = np.asarray(host.array)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)
    if want.dtype.kind == "f":
        assert np.array_equal(np.signbit(got), np.signbit(want))
    assert tuple(card.voxel_offset) == tuple(host.voxel_offset)
    assert card.layer_type == host.layer_type


def _aff(seed=0, shape=(3, 8, 96, 80)):
    return (np.random.default_rng(seed).random(shape) * 1.2 - 0.1).astype(
        np.float32)


@pytest.mark.parametrize("factor", [(1, 1, 1), (1, 4, 4), (1, 16, 16),
                                    (2, 8, 4)])
@pytest.mark.parametrize("inverse", [False, True])
def test_maskout_card_is_its_cpu_leg(cuda, factor, inverse):
    from chunkflow_tpu_torch.ops.mask import maskout

    card, host = _card_and_host(_aff(1), cuda)
    mvsize = tuple(v * f for v, f in zip(host.voxel_size, factor))
    mshape = tuple((o + s) // f + 2 for o, s, f in
                   zip(host.voxel_offset, host.shape[-3:], factor))
    mask = Chunk((np.random.default_rng(2).random(mshape) > 0.3).astype(
        np.uint8), voxel_size=mvsize)
    _assert_card_is_host(maskout(card, mask, inverse=inverse),
                         maskout(host, mask, inverse=inverse, device="cpu"))
    # a host chunk on the card: the result comes back to the host
    got = maskout(host, mask, inverse=inverse, device="cuda")
    assert isinstance(got.array, np.ndarray)
    assert np.array_equal(got.array, maskout(host, mask, inverse=inverse,
                                             device="cpu").array)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_channel_voting_card_is_its_cpu_leg(cuda, dtype):
    arr = _aff(3, (5, 8, 64, 64))
    if dtype == "uint8":
        arr = (arr.clip(0, 1) * 4).astype(np.uint8)
    card, host = _card_and_host(arr, cuda)
    _assert_card_is_host(card.channel_voting(),
                         host.channel_voting(device="cpu"))


@pytest.mark.parametrize("value", [0.5, 0.3, 0.7000001])
def test_threshold_card_is_its_cpu_leg(cuda, value):
    card, host = _card_and_host(_aff(4), cuda)
    _assert_card_is_host(card.threshold(value), host.threshold(value))


@pytest.mark.parametrize("mode", ["xy", "z"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_quantize_card_is_its_cpu_leg(cuda, mode, dtype):
    from chunkflow_tpu_torch.chunk import AffinityMap

    arr = _aff(5)
    if dtype == "uint8":
        arr = (arr.clip(0, 1) * 255).astype(np.uint8)
    card, host = _card_and_host(arr, cuda, cls=AffinityMap)
    _assert_card_is_host(card.quantize(mode), host.quantize(mode))


@pytest.mark.parametrize("op", ["chunk*chunk", "u8*f32", "f32/float",
                                "float-f32", "u8*float", "f32>float"])
def test_operators_card_are_their_cpu_leg(cuda, op):
    a, b = _aff(6), _aff(7)
    u8 = (b.clip(0, 1) * 255).astype(np.uint8)
    ca, ha = _card_and_host(a, cuda)
    cb, hb = _card_and_host(b, cuda)
    cu, hu = _card_and_host(u8, cuda)
    fn = {"chunk*chunk": lambda x, y, u: x * y,
          "u8*f32": lambda x, y, u: u * x,
          "f32/float": lambda x, y, u: x / 127.5,
          "float-f32": lambda x, y, u: 1.0 - x,
          "u8*float": lambda x, y, u: u * 2.5,
          "f32>float": lambda x, y, u: x > 0.3}[op]
    _assert_card_is_host(fn(ca, cb, cu), fn(ha, hb, hu))


@pytest.mark.parametrize("per_section", [True, False])
@pytest.mark.parametrize("shape", [(8, 96, 80), (2, 8, 64, 64)])
def test_normalize_contrast_card_is_its_cpu_leg(cuda, per_section, shape):
    from chunkflow_tpu_torch.chunk import Image

    arr = np.random.default_rng(8).integers(0, 256, shape).astype(np.uint8)
    card, host = _card_and_host(arr, cuda, cls=Image)
    for kwargs in ({}, {"lower_clip_fraction": 0.1,
                        "upper_clip_fraction": 0.3, "minval": 0}):
        _assert_card_is_host(
            card.normalize_contrast(per_section=per_section, **kwargs),
            host.normalize_contrast(per_section=per_section, **kwargs))


def test_chunk_methods_card_are_their_cpu_leg(cuda):
    card, host = _card_and_host(_aff(9), cuda)
    for fn in (lambda c: c.astype(np.uint8), lambda c: c.clone(),
               lambda c: c.shrink((1, 2, 3, 0, 4, 5)),
               lambda c: c.pad_to((9, 100, 81)),
               lambda c: c.pad_to((9, 100, 81), mode="edge"),
               lambda c: c.transpose(), lambda c: c.crop_margin((1, 8, 8))):
        _assert_card_is_host(fn(card), fn(host))
    assert card.where(card.array > 0.9)[1].tolist() == \
        host.where(host.array > 0.9)[1].tolist()


# ---------------------------------------------------------------------------
# the segmentation legs and the file formats of a card chunk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("p", [0.3, 0.55])
def test_device_labels_card_are_their_cpu_leg(cuda, connectivity, p):
    from chunkflow_tpu_torch.ops import connected_components as cc

    binary = torch.from_numpy(
        np.random.default_rng(7).random((24, 96, 80)) > p)
    got = cc.label_binary_device(binary.to(cuda), connectivity)
    assert got.device.type == "cuda" and got.dtype == torch.uint32
    assert torch.equal(got.cpu(), cc.label_binary_device(binary,
                                                         connectivity))


@pytest.mark.parametrize("factor", [(1, 2, 2), (2, 2, 2), (1, 3, 3)])
@pytest.mark.parametrize("dtype", ["uint8", "uint32", "uint64", "float32"])
def test_pools_card_are_their_cpu_leg(cuda, factor, dtype):
    from chunkflow_tpu_torch.ops.downsample import downsample

    rng = np.random.default_rng(8)
    shape = (2, 10, 70, 66)
    if dtype == "float32":
        arr, layer = rng.random(shape).astype(np.float32), "image"
    else:
        arr, layer = rng.integers(0, 3, shape).astype(dtype), "segmentation"
    host = torch.from_numpy(arr)
    got = downsample(Chunk(host.to(cuda), layer_type=layer), factor)
    ref = downsample(Chunk(host, layer_type=layer), factor)
    assert got.array.device.type == "cuda"
    assert torch.equal(got.array.cpu(), ref.array)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_gaussian_card_is_its_cpu_leg(cuda, sigma, dtype):
    from chunkflow_tpu_torch.ops.filters import gaussian_filter_2d

    arr = _raw(dtype, np.random.default_rng(9), (6, 90, 70))
    if dtype == "float32":
        arr = np.abs(arr)
    host = torch.from_numpy(arr)
    got = gaussian_filter_2d(Chunk(host.to(cuda)), sigma)
    ref = gaussian_filter_2d(Chunk(host), sigma)
    assert torch.equal(got.array.cpu(), ref.array)


@pytest.mark.parametrize("fmt", ["h5", "zarr"])
def test_file_round_trip_of_a_card_chunk(cuda, tmp_path, fmt):
    """A card chunk's file, written through the CLI's stage (one
    download), reads back bitwise with its offset and voxel size."""
    if fmt == "h5":
        pytest.importorskip("h5py")
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import new_task

    arr = np.random.default_rng(10).random((3, 6, 40, 36)).astype(np.float32)
    if fmt == "zarr":  # a zyx store
        arr = arr[0]
    task = new_task()
    task["chunk"] = Chunk(torch.from_numpy(arr).to(cuda),
                          voxel_offset=(2, 3, 4), voxel_size=(40, 4, 4))
    if fmt == "h5":
        save = ["save-h5", "-f", str(tmp_path / "c.h5")]
        load = ["load-h5", "-f", str(tmp_path / "c.h5")]
    else:
        save = ["save-zarr", "-p", str(tmp_path / "z")]
        load = ["load-zarr", "-p", str(tmp_path / "z"), "--chunk-start", "2",
                "3", "4", "--chunk-size", "6", "40", "36", "--voxel-size",
                "40", "4", "4"]
    list(cli.build_stages(save)[1][0](iter([task])))
    got = list(cli.build_stages(load)[1][0](iter([new_task()])))[0]["chunk"]
    assert isinstance(got.array, np.ndarray) and np.array_equal(got.array,
                                                                arr)
    assert tuple(got.voxel_offset) == (2, 3, 4)
    assert tuple(got.voxel_size) == (40, 4, 4)


@pytest.mark.parametrize("store_dtype", ["bfloat16", "float32", "uint8"])
def test_bfloat16_inference_output_into_an_existing_store(cuda, tmp_path,
                                                          store_dtype):
    """A bfloat16 inference output on the card, saved through the CLI's
    stage into a zyx store made before: as it is into a ``bfloat16``
    store, widened to float32 into a float32 one, and ``TypeError`` into
    a uint8 one, as tensorstore writes it."""
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import new_task
    from chunkflow_tpu_torch.volume.zarr import ZarrArray

    chunk = Chunk.create(size=(6, 48, 48), dtype=np.uint8, pattern="random")
    out = Inferencer(input_patch_size=(4, 32, 32),
                     output_patch_overlap=(2, 16, 16), num_output_channels=1,
                     framework="pytorch", model_variant="parity",
                     dtype="bfloat16", output_dtype="bfloat16",
                     batch_size=2)(chunk)
    assert out.array.is_cuda and out.array.dtype == torch.bfloat16
    task = new_task()
    task["chunk"] = Chunk(out.array[0], voxel_offset=(0, 0, 0))
    path = str(tmp_path / "z")
    ZarrArray.create(path, tuple(out.array.shape[1:]), store_dtype)
    save = cli.build_stages(["save-zarr", "-p", path])[1][0]
    if store_dtype == "uint8":
        with pytest.raises(TypeError):
            list(save(iter([task])))
        return
    list(save(iter([task])))
    got = ZarrArray(path).read_values()
    want = out.array[0].cpu()
    if store_dtype == "bfloat16":
        assert torch.equal(got, want)
    else:
        assert got.dtype == np.float32
        assert np.array_equal(got, want.float().numpy())


# ---------------------------------------------------------------------------
# the int8 convolution kernel and the precision ladder on the card
# ---------------------------------------------------------------------------
# (x [B, C, D, H, W], w [N, C, kz, ky, kx], stride, padding, dilation):
# every shape class the real leg gives the kernel, and the edges of its
# tiling (narrow N, C not a multiple of 4, M not a multiple of the tile)
INT8_CONV_CASES = {
    "3x3x3_28": ((2, 28, 5, 20, 18), (28, 28, 3, 3, 3), 1, 1, 1),
    "1x3x3_rsunet": ((2, 36, 4, 12, 12), (36, 36, 1, 3, 3), 1, (0, 1, 1), 1),
    "1x5x5_conv_in": ((2, 1, 4, 32, 32), (28, 1, 1, 5, 5), 1, (0, 2, 2), 1),
    "1x5x5_s2d_stem": ((2, 4, 4, 16, 16), (56, 4, 1, 5, 5), 1, (0, 2, 2), 1),
    "1x5x5_s2d4_stem": ((2, 16, 4, 8, 8), (112, 16, 1, 5, 5), 1, (0, 2, 2),
                        1),
    "1x1x1_head": ((2, 28, 4, 16, 16), (3, 28, 1, 1, 1), 1, 0, 1),
    "3x3x3_256": ((1, 256, 3, 6, 6), (256, 256, 3, 3, 3), 1, 1, 1),
    "mxu_slice": ((10, 56, 1, 16, 16), (56, 56, 1, 3, 3), 1, (0, 1, 1), 1),
    "transpose_as_1x1x1": ((2, 72, 2, 8, 8), (224, 72, 1, 1, 1), 1, 0, 1),
    "c3_strided_dilated": ((2, 3, 7, 11, 13), (5, 3, 3, 3, 3), 2, 1, 2),
}


@pytest.mark.parametrize("name", list(INT8_CONV_CASES))
def test_int8_conv_kernel_is_its_plain_version(cuda, name):
    from chunkflow_tpu_torch.ops import int8_conv

    xs, ws, stride, padding, dilation = INT8_CONV_CASES[name]
    g = torch.Generator().manual_seed(len(name))
    x = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8)
    before = int8_conv.launches
    got = int8_conv.conv3d_int8(x.to(cuda), w.to(cuda), stride, padding,
                                dilation)
    assert int8_conv.launches == before + 1
    ref = int8_conv.conv3d_int8_plain(x, w, stride, padding, dilation)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), ref)


# the Hopper kernel's edges: halos cut by all six faces (same and valid
# padding, ragged in every dimension), M not a multiple of the 128-row
# tile, each width class of output channels, streamed weights, stores
# with and without split-K
INT8_HOPPER_CASES = {
    "faces_3x3x3": ((2, 20, 7, 13, 37), (24, 20, 3, 3, 3), 1),
    "faces_1x5x5": ((1, 16, 3, 9, 35), (8, 16, 1, 5, 5), (0, 2, 2)),
    "valid_3x3x3": ((2, 32, 6, 10, 40), (32, 32, 3, 3, 3), 0),
    "wide_pad_3x3x3": ((1, 28, 4, 6, 9), (28, 28, 3, 3, 3), 2),
    "ragged_m": ((3, 28, 5, 7, 9), (28, 28, 3, 3, 3), 1),
    "n3": ((2, 32, 3, 8, 16), (3, 32, 3, 3, 3), 1),
    "n28": ((2, 32, 3, 8, 16), (28, 32, 3, 3, 3), 1),
    "n36": ((2, 32, 3, 8, 16), (36, 32, 3, 3, 3), 1),
    "n56": ((2, 32, 3, 8, 16), (56, 32, 3, 3, 3), 1),
    "n112": ((2, 32, 3, 8, 16), (112, 32, 3, 3, 3), 1),
    "n224": ((2, 32, 3, 8, 16), (224, 32, 1, 1, 1), 0),
    "n256": ((2, 32, 3, 8, 16), (256, 32, 3, 3, 3), 1),
    "n768": ((2, 64, 3, 8, 16), (768, 64, 1, 1, 1), 0),
    "no_split_store": ((2, 28, 8, 32, 64), (28, 28, 3, 3, 3), 1),
    "no_split_ragged_w": ((2, 28, 8, 33, 70), (28, 28, 3, 3, 3), 1),
    "streamed_weights": ((2, 72, 8, 32, 64), (72, 72, 3, 3, 3), 1),
    "split_k_bridge": ((2, 256, 5, 8, 8), (256, 256, 3, 3, 3), 1),
    "split_k_odd_substeps": ((2, 144, 2, 4, 4), (192, 144, 3, 3, 3), 1),
}


@pytest.mark.parametrize("name", list(INT8_HOPPER_CASES))
def test_int8_conv_hopper_kernel_edges(cuda, name):
    """Each edge case through the Hopper kernel: one launch, bitwise the
    plain version and the generic kernel."""
    from chunkflow_tpu_torch.ops import int8_conv

    xs, ws, padding = INT8_HOPPER_CASES[name]
    assert int8_conv.plan(xs, ws, 1, padding).path == "hopper"
    g = torch.Generator().manual_seed(len(name))
    x = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8)
    xc = int8_conv.channels_last_padded(x.to(cuda))
    before = int8_conv.path_launches["hopper"]
    got = int8_conv.conv3d_int8(xc, w.to(cuda), 1, padding)
    assert int8_conv.path_launches["hopper"] == before + 1
    ref = int8_conv.conv3d_int8_plain(x, w, 1, padding)
    generic = int8_conv.conv3d_int8_generic(xc, w.to(cuda), 1, padding)
    assert torch.equal(got.cpu(), ref) and torch.equal(generic.cpu(), ref)


def test_int8_matmul_kernel_is_its_plain_version(cuda):
    from chunkflow_tpu_torch.ops import int8_conv

    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (1000, 72), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (72, 224), generator=g, dtype=torch.int8)
    got = int8_conv.matmul_int8(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), int8_conv.matmul_int8(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["parity", "rsunet", "tpu", "tpu_mxu",
                                     "tpu_s2d4"])
def test_real_int8_forward_kernel_is_the_plain_path(cuda, monkeypatch,
                                                    variant, dtype):
    """The real int8 forward of every family at full width: through the
    kernel, bitwise the same forward through the plain version (float64
    on the card); ``fake`` launches no integer convolution."""
    from chunkflow_tpu_torch.inference import engines, precision
    from chunkflow_tpu_torch.ops import int8_conv

    engine = engines.create_engine("pytorch", model_variant=variant,
                                   dtype=dtype)
    engine.model.to(cuda)
    g = torch.Generator().manual_seed(1)
    batch = torch.rand((2, 1, 4, 32, 32), generator=g).to(cuda)

    def run(leg):
        monkeypatch.setenv("CHUNKFLOW_INT8", leg)
        with torch.no_grad():
            return precision.wrap_apply(engine.apply, "int8", engine.params,
                                        engine.call)(batch)

    int8_conv.launches = 0
    got = run("real")
    assert int8_conv.launches > 0
    monkeypatch.setattr(int8_conv, "conv3d_int8", int8_conv.conv3d_int8_plain)
    ref = run("real")
    monkeypatch.undo()
    int8_conv.launches = 0
    run("fake")
    assert int8_conv.launches == 0
    assert torch.isfinite(got).all() and torch.equal(got, ref)


def test_serving_http_request_on_card_is_per_chunk(cuda):
    """One ``POST /infer`` over a real listener, served on the card: the
    decoded response is bitwise the same chunk's ``Inferencer.__call__``,
    through the gather and the pre-weighted accumulate kernels."""
    import base64
    import json
    import urllib.request

    from chunkflow_tpu_torch.parallel.restapi import (
        bound_port,
        shutdown_server,
    )
    from chunkflow_tpu_torch.serve import (
        LocalBackend,
        ServingService,
        start_serving,
    )

    inferencer = Inferencer(framework="pytorch", **STREAM_KW)
    arr = np.random.default_rng(5).integers(0, 256, (6, 48, 61)).astype(
        np.uint8)
    ref = inferencer(Chunk(arr, voxel_offset=(2, 3, 4))).host().array
    backend = LocalBackend(inferencer, workers=2)
    server = start_serving(ServingService(backend), host="127.0.0.1", port=0)
    body = json.dumps({"shape": list(arr.shape), "dtype": "uint8",
                       "data_b64": base64.b64encode(arr.tobytes()).decode(),
                       "voxel_offset": [2, 3, 4]}).encode()
    try:
        gather.launches = accumulate.launches = 0
        req = urllib.request.Request(
            f"http://127.0.0.1:{bound_port(server)}/infer", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            payload = json.loads(resp.read())
    finally:
        shutdown_server(server)
        backend.close()
    assert gather.launches > 0 and accumulate.launches > 0
    out = np.frombuffer(base64.b64decode(payload["data_b64"]),
                        dtype=payload["dtype"]).reshape(payload["shape"])
    assert payload["voxel_offset"] == [2, 3, 4]
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("precision_, leg", [
    ("float32", "fake"), ("bfloat16", "fake"), ("int8", "fake"),
    ("int8", "real")])
def test_packer_on_card_is_per_chunk(cuda, monkeypatch, precision_, leg):
    """Mixed requests packed into shared batches on the card: each result
    bitwise its own ``Inferencer.__call__``, through the gather and the
    pre-weighted accumulate kernels."""
    from chunkflow_tpu_torch.serve.packer import PatchPacker

    monkeypatch.setenv("CHUNKFLOW_INT8", leg)
    inferencer = Inferencer(framework="pytorch", model_variant="tpu",
                            dtype="bfloat16", precision=precision_,
                            **dict(STREAM_KW, batch_size=4))
    rng = np.random.default_rng(4)
    chunks = [Chunk(rng.integers(0, 256, s).astype(np.uint8),
                    voxel_offset=(8 * i, 0, 0))
              for i, s in enumerate([(4, 32, 32), (6, 48, 48), (5, 40, 61)])]
    refs = [inferencer(c).host().array for c in chunks]
    gather.launches = accumulate.launches = 0
    packer = PatchPacker(inferencer, max_wait_ms=200.0)
    try:
        outs = [h.result(timeout=120).host().array
                for h in [packer.submit(c) for c in chunks]]
    finally:
        packer.close()
    assert gather.launches > 0 and accumulate.launches > 0
    for ref, out in zip(refs, outs):
        assert np.array_equal(out, ref)


@pytest.mark.parametrize("framework, mesh", [
    ("identity", "data=8"), ("identity", "y=4,x=2"), ("identity", "y=8"),
    ("identity", "pipeline=8"), ("pytorch", "data=8"),
    ("pytorch", "y=4,x=2")])
def test_mesh_on_one_card_repeated_is_one_device(cuda, monkeypatch,
                                                 framework, mesh):
    """The mesh engine with its eight shards on ``[cuda:0] * 8``: the
    identity and the parity UNet3D bitwise one device, through the gather
    and accumulate kernels, the dispatch under the sync check."""
    inf = Inferencer(framework=framework, model_variant="parity",
                     **STREAM_KW)
    inf._mesh = [torch.device("cuda", 0)] * 8
    arr = np.random.default_rng(17).integers(0, 256, (8, 72, 80)).astype(
        np.uint8)
    ref = inf(Chunk(arr)).host().array
    monkeypatch.setenv("CHUNKFLOW_MESH", mesh)
    inf(Chunk(arr)).host()  # the first dispatch runs the readiness probe
    staged = inf.stage(Chunk(arr))
    gather.launches = accumulate.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = inf.infer_async(staged, consume=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert gather.launches > 0 and accumulate.launches > 0
    assert np.array_equal(out.host().array, ref)


@pytest.mark.parametrize("wrapper", ["distributed", "spatial", "spatial2d"])
def test_legacy_wrapper_with_parameters_is_one_device(cuda, wrapper):
    """A legacy wrapper with the parity UNet3D, its parameters on the
    host, over eight shards on the cards (``[cuda:0] * 8`` on one card,
    round-robin over several): each shard runs a copy of the parameters
    on its card, through the gather and accumulate kernels, bitwise the
    inferencer on one device."""
    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.parallel import distributed, spatial, spatial2d

    fn = {"distributed": distributed.sharded_inference,
          "spatial": spatial.spatial_sharded_inference,
          "spatial2d": spatial2d.spatial2d_sharded_inference}[wrapper]
    eng = engines.create_convnet_engine("", None, model_variant="parity")
    arr = np.random.default_rng(18).random((8, 72, 80)).astype(np.float32)
    devices = [torch.device("cuda", k % torch.cuda.device_count())
               for k in range(8)]
    pin, overlap = STREAM_KW["input_patch_size"], \
        STREAM_KW["output_patch_overlap"]
    gather.launches = accumulate.launches = 0
    with torch.no_grad():
        got = fn(arr, eng, pin, pin, overlap, batch_size=2, devices=devices)
    assert gather.launches > 0 and accumulate.launches > 0
    assert got.device.type == "cuda"
    assert next(eng.params.parameters()).device == torch.device("cpu")
    inf = Inferencer(framework="prebuilt", engine=eng,
                     crop_output_margin=False, **STREAM_KW)
    ref = inf(Chunk(arr)).host().array
    assert np.array_equal(got.cpu().numpy(), ref)


# ---------------------------------------------------------------------------
# the segmentation plane's device leg
# ---------------------------------------------------------------------------
def _segment_input():
    return np.random.default_rng(16).random((32, 128, 128)).astype(
        np.float32)


@pytest.mark.parametrize("connectivity", [6, 26])
def test_segment_volume_card_is_its_cpu_device_leg(cuda, connectivity):
    """Each chunk labelled on the card, uploaded once and read back once:
    the stitched volume bitwise the CPU device leg's, isomorphic to the
    host leg's."""
    from chunkflow_tpu_torch.segment import labels_isomorphic, segment_volume

    arr = _segment_input()
    kw = dict(threshold=0.6, connectivity=connectivity, workers=2)
    got = segment_volume(arr, (16, 64, 64), device="cuda", **kw)
    want = segment_volume(arr, (16, 64, 64), device="cpu", **kw)
    assert np.array_equal(got, want)
    assert labels_isomorphic(got, segment_volume(arr, (16, 64, 64), **kw))


def test_segment_job_finished_by_a_card_worker_after_a_cpu_worker(
        cuda, tmp_path):
    """A device-leg job: a worker on the CPU labels half the chunks, a
    worker on the card the rest, then merges and relabels: the volume is
    the CPU device leg's."""
    from chunkflow_tpu_torch.segment import driver, stages

    arr = _segment_input()
    npy = str(tmp_path / "in.npy")
    np.save(npy, arr)
    want = driver.segment_volume(arr, (16, 64, 64), threshold=0.6,
                                 device="cpu")
    cpu = driver.init_store(str(tmp_path / "job"), npy, (16, 64, 64),
                            threshold=0.6, device="cpu")
    card = driver.open_store(str(tmp_path / "job"), device="cuda")
    chunks = cpu.plan.chunks
    for chunk in chunks[: len(chunks) // 2]:
        stages.label_chunk(cpu, chunk)
    for chunk in chunks[len(chunks) // 2:]:
        stages.label_chunk(card, chunk)
    for node in card.plan.make_tree().post_order():
        if not node.is_leaf:
            stages.merge_node(card, node.bbox)
    for chunk in chunks:
        stages.relabel_chunk(card, chunk)
    assert np.array_equal(driver.export_segmentation(card), want)


def _encoded_worker(tmp_path, device, image, out_scale):
    """``load-precomputed | inference -f identity | save-precomputed`` over
    every task of an encoded image volume, into an encoded and sharded
    output volume; the output's array."""
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    out = str(tmp_path / f"out-{device}")
    PrecomputedVolume.create(out, volume_size=(16, 64, 64),
                             voxel_size=(40, 4, 4), voxel_offset=(4, 16, 16),
                             num_channels=3, block_size=(8, 32, 32),
                             **out_scale)
    dev = ["--device", "cpu"] if device == "cpu" else []
    tasks = str(tmp_path / f"tasks-{device}.npy")
    assert cli.main(dev + ["generate-tasks", "--volume-path", out,
                           "--chunk-size", "8", "32", "32",
                           "--file-path", tasks]) == 0
    assert cli.main(dev + [
        "fetch-task-from-file", "-f", tasks, "load-precomputed", "-v", image,
        "-e", "2", "8", "8", "inference", "-f", "identity", "-p", "4", "16",
        "16", "-v", "2", "8", "8", "-c", "3", "-b", "2",
        "--output-crop-margin", "2", "8", "8", "save-precomputed", "-v",
        out]) == 0
    vol = PrecomputedVolume(out)
    return vol.cutout(vol.bounds(0)).array


@pytest.mark.parametrize("out_scale", [
    {"dtype": "float32", "sharding": {
        "@type": "neuroglancer_uint64_sharded_v1", "preshift_bits": 0,
        "hash": "murmurhash3_x86_128", "minishard_bits": 1, "shard_bits": 2,
        "minishard_index_encoding": "gzip", "data_encoding": "raw"}},
    {"dtype": "uint8", "encoding": "png"}])
def test_encoded_volume_worker_card_is_its_cpu_leg(cuda, tmp_path,
                                                   monkeypatch, out_scale):
    """The worker reads a jpeg image volume and writes a sharded or png
    output on the card: bitwise the same chain on the CPU, and the kernels
    launch on the card."""
    from chunkflow_tpu_torch import Chunk as PortChunk
    from chunkflow_tpu_torch.volume import storage
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", "0")
    storage.reset_shared_cache()
    image = str(tmp_path / "image")
    PrecomputedVolume.create(image, volume_size=(24, 96, 96),
                             voxel_size=(40, 4, 4), block_size=(8, 32, 32),
                             encoding="jpeg")
    PrecomputedVolume(image).save(PortChunk(np.random.default_rng(3).integers(
        0, 256, (24, 96, 96), dtype=np.uint8)))
    before = gather.launches, accumulate.launches
    card = _encoded_worker(tmp_path, "cuda", image, out_scale)
    assert gather.launches > before[0] and accumulate.launches > before[1]
    cpu = _encoded_worker(tmp_path, "cpu", image, out_scale)
    assert card.any() and np.array_equal(card, cpu)


def test_fleet_run_on_card_is_one_worker(cuda, tmp_path):
    """``fleet-run`` with two worker processes on the card drains a
    volume into the bytes one in-process worker writes there, and every
    worker that computed a task launched both kernels."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from chunkflow_tpu_torch import Chunk as PortChunk
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    image = str(tmp_path / "image")
    PrecomputedVolume.create(image, volume_size=(16, 96, 96),
                             voxel_size=(40, 4, 4), block_size=(8, 32, 32))
    PrecomputedVolume(image).save(PortChunk(np.random.default_rng(5).integers(
        0, 256, (16, 96, 96), dtype=np.uint8)))
    stages = ["load-precomputed", "-v", image, "-e", "2", "8", "8",
              "inference", "-f", "identity", "-p", "4", "16", "16", "-v",
              "2", "8", "8", "-c", "3", "-b", "2", "--output-crop-margin",
              "2", "8", "8", "--async-depth", "2"]
    outputs = {}
    for name in ("one", "fleet"):
        out = str(tmp_path / name)
        queue = f"file://{tmp_path / f'{name}-queue'}"
        assert cli.main(["create-info", "-v", out, "-c", "3", "--dtype",
                         "float32", "--volume-size", "12", "64", "64",
                         "--voxel-offset", "2", "8", "8", "--block-size",
                         "2", "16", "16"]) == 0
        assert cli.main(["generate-tasks", "--volume-path", out,
                         "--chunk-size", "6", "32", "32", "--queue-name",
                         queue]) == 0
        chain = stages + ["save-precomputed", "-v", out,
                          "delete-task-in-queue"]
        if name == "one":
            assert cli.main(["fetch-task-from-queue", "-q", queue, "-r", "0",
                             *chain]) == 0
        else:
            metrics = tmp_path / "metrics"
            env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                                  .parent.parent))
            proc = subprocess.run(
                [sys.executable, "-m", "chunkflow_tpu_torch", "-v",
                 "--metrics-dir", str(metrics), "fleet-run", "-q", queue,
                 "--min-workers", "2", "--max-workers", "2", "--interval",
                 "0.5", "-r", "4", "--poll-interval", "0.25", "--ledger",
                 str(tmp_path / "ledger"), "--max-runtime", "240", "-w",
                 " ".join(chain)],
                env=env, capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            assert "fleet drained:" in proc.stdout
            launched = []
            for log in metrics.glob("worker-fleet-w*.log"):
                lines = [ln for ln in log.read_text().splitlines()
                         if ln.startswith("run counters: ")]
                if lines:
                    c = json.loads(lines[-1][len("run counters: "):])
                    if c.get("inference/chunks"):
                        launched.append((c["kernels/gather"],
                                         c["kernels/accumulate"]))
            assert launched and all(g > 0 and a > 0 for g, a in launched)
        assert open_queue(queue).stats()["pending"] == 0
        outputs[name] = PrecomputedVolume(out).cutout(
            PrecomputedVolume(out).bounds()).array
    assert outputs["fleet"].any()
    assert np.array_equal(outputs["fleet"], outputs["one"])


def test_synapse_plugins_on_a_card_chunk(cuda, tmp_path):
    """The five synapse plugins and ``skeletonize`` on an inference output
    and a segmentation that lie on the card equal the same plugins on
    their host copies (each plugin reads its chunks with ``.host()``)."""
    from scipy import ndimage

    from chunkflow_tpu_torch.annotations.synapses import Synapses
    from chunkflow_tpu_torch.chunk.segmentation import Segmentation
    from chunkflow_tpu_torch.flow.plugin import load_plugin

    rng = np.random.default_rng(61)
    image = ndimage.gaussian_filter(rng.random((16, 64, 64)), 2).astype(
        np.float32)
    inferencer = Inferencer(
        input_patch_size=(4, 16, 16), output_patch_overlap=(2, 8, 8),
        num_output_channels=2, framework="identity", batch_size=2,
        device="cuda")
    prob = inferencer(Chunk(image, voxel_offset=(2, 4, 6),
                            voxel_size=(40, 4, 4)))
    labels = ndimage.label(image > np.quantile(image, 0.6))[0]
    seg = Segmentation(torch.from_numpy(labels.astype(np.int64)).to(cuda),
                       voxel_offset=(2, 4, 6), voxel_size=(40, 4, 4))
    assert prob.is_on_device and seg.is_on_device
    with pytest.raises(TypeError, match="host"):
        np.asarray(prob)
    post = Chunk(prob.array[1:2], voxel_offset=prob.voxel_offset,
                 voxel_size=prob.voxel_size)

    def chain(prob, post, seg):
        run = {name: load_plugin(name) for name in (
            "detect_pre_synapses", "detect_post_synapses", "adjust_pre",
            "detect_duplicate_post", "find_tbar_object", "skeletonize")}
        syn = run["detect_pre_synapses"](prob, min_distance=3)
        syn = run["detect_post_synapses"](syn, post, search_radius=50,
                                          min_distance=2)
        syn = run["adjust_pre"](syn, prob)
        syn = run["detect_duplicate_post"](syn, seg)
        ids = run["find_tbar_object"](syn, seg)
        skels = run["skeletonize"](seg, voxel_num_threshold=50, max_paths=20)
        return syn, ids, {k: s.to_precomputed_bytes()
                          for k, s in skels.items()}

    card = chain(prob, post, seg)
    host = chain(prob.host(), post.host(), seg.host())
    assert isinstance(card[0], Synapses) and card[0].pre_num > 0
    assert card[0] == host[0]
    for a, b in ((card[0].pre_confidence, host[0].pre_confidence),
                 (card[0].post_confidence, host[0].post_confidence),
                 (card[1], host[1])):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert card[2] == host[2] and card[2]


def test_orbax_checkpoint_loads_on_the_card(cuda):
    """The committed orbax checkpoint (OCDBT, zstd zarr arrays) read by the
    port's own decoders into the parity engine on the card: the seeded
    weights bitwise, and one chunk's kernel path bitwise its plain path."""
    from pathlib import Path
    from unittest import mock

    from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init

    path = Path(__file__).resolve().parent / "data" / "orbax_parity_seed0"
    inferencer = Inferencer(input_patch_size=(4, 32, 32),
                            output_patch_overlap=(2, 8, 8),
                            num_output_channels=3, framework="flax",
                            model_variant="parity", weight_path=str(path),
                            batch_size=2)
    model = inferencer.engine.model
    assert next(model.parameters()).is_cuda
    seeded = seeded_init(UNet3D(in_channels=1, out_channels=3),
                         torch.Generator().manual_seed(0))
    loaded = model.state_dict()
    for key, value in seeded.state_dict().items():
        assert torch.equal(loaded[key].cpu(), value), key
    chunk = Chunk(np.random.default_rng(21).integers(
        0, 256, (6, 64, 64)).astype(np.uint8))
    got = inferencer(chunk).host().array
    with mock.patch.object(gather, "gather_patches",
                           gather.gather_patches_plain), \
            mock.patch.object(accumulate, "fused_accumulate_patches",
                              accumulate.fused_accumulate_patches_plain):
        plain = inferencer(chunk).host().array
    assert np.isfinite(got).all() and np.array_equal(got, plain)


def test_zarr3_fixtures_load_on_the_card(cuda):
    """The committed ``use_zarr3`` checkpoint (sharding_indexed leaves)
    loads into the parity engine on the card with the seeded weights and
    gives the v2 checkpoint's output bitwise; the committed sharded zarr v3
    store reads as its seeded array, here where no tensorstore is."""
    import chip_smoke
    from chunkflow_tpu_torch.volume.zarr import open_array

    assert np.array_equal(
        open_array(str(chip_smoke.SHARDED_STORE), "zarr3").read(),
        chip_smoke.sharded_array(np))
    chunk = Chunk(np.random.default_rng(22).integers(
        0, 256, (6, 64, 64)).astype(np.uint8))
    outputs = []
    for path in (chip_smoke.CHECKPOINT, chip_smoke.CHECKPOINT_ZARR3):
        inferencer = Inferencer(input_patch_size=(4, 32, 32),
                                output_patch_overlap=(2, 8, 8),
                                num_output_channels=3, framework="flax",
                                model_variant="parity",
                                weight_path=str(path), batch_size=2)
        assert next(inferencer.engine.model.parameters()).is_cuda
        outputs.append(inferencer(chunk).host().array)
    assert np.isfinite(outputs[1]).all()
    assert np.array_equal(outputs[0], outputs[1])


def test_clahe_then_inference_on_the_card(cuda):
    """The ``clahe`` plugin (host C++) ahead of the card's inference, as
    ``chip_smoke.py`` phase 25 runs it: bitwise the numpy plain CLAHE
    through ``Inferencer.__call__``."""
    from chunkflow_tpu_torch.flow import plugin
    from chunkflow_tpu_torch.ops.clahe import clahe_plain

    raw = np.random.default_rng(23).integers(0, 256, (6, 61, 59),
                                             dtype=np.uint8)
    card = Chunk(torch.from_numpy(raw).cuda())
    equalized = plugin.load_plugin("clahe")(card, clip_limit=2.0,
                                            tile_size=8)
    assert np.array_equal(equalized, clahe_plain(raw, 2.0, 8))
    inferencer = Inferencer(input_patch_size=(4, 32, 32),
                            output_patch_overlap=(2, 8, 8),
                            num_output_channels=3, framework="identity",
                            batch_size=2)
    got = inferencer(Chunk(equalized)).host().array
    assert np.isfinite(got).all() and got.shape == (3, 6, 61, 59)


CUDA_RANK = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.ops import accumulate, gather
from chunkflow_tpu_torch.parallel import multihost

pid = {pid}
cfg = json.load(open({cfg!r}))
multihost.initialize(cfg["coord"], 2, pid, device="cuda:0")
pin = tuple(cfg["pin"])
got = multihost.sharded_inference_global(
    np.load(cfg["chunk"]), engines.create_identity_engine(pin, pin, 3), pin,
    pin, tuple(cfg["overlap"]), batch_size=2)
np.save(cfg["out"] + "/rank%d.npy" % pid, got.cpu().numpy())
json.dump(dict(backend=multihost.backend(), device=str(got.device),
               gather=gather.launches, accumulate=accumulate.launches),
          open(cfg["out"] + "/rank%d.json" % pid, "w"))
print("CUDA_RANK_OK", pid)
"""


def test_multihost_psum_on_one_card_is_within_tolerance(cuda, tmp_path):
    """Two ranks in a gloo world on ``cuda:0`` (ranks sharing a card):
    the identity psum recipe within 2e-6 of one device (the JAX
    cross-topology gate), each rank through both kernels."""
    import json

    from tests.test_torch_multihost import _run_world

    pin, overlap = (8, 64, 64), (2, 16, 16)
    arr = np.random.default_rng(23).random((16, 128, 160)).astype(
        np.float32)
    np.save(tmp_path / "chunk.npy", arr)
    _run_world(tmp_path, CUDA_RANK,
               dict(out=str(tmp_path), chunk=str(tmp_path / "chunk.npy"),
                    pin=pin, overlap=overlap), "CUDA_RANK_OK")
    ref = Inferencer(input_patch_size=pin, output_patch_overlap=overlap,
                     num_output_channels=3, framework="identity",
                     batch_size=2, crop_output_margin=False)(
        Chunk(arr)).host().array
    for pid in range(2):
        info = json.loads((tmp_path / f"rank{pid}.json").read_text())
        assert info["backend"] == "gloo" and info["device"] == "cuda:0"
        assert info["gather"] > 0 and info["accumulate"] > 0
        got = np.load(tmp_path / f"rank{pid}.npy")
        assert got.shape == ref.shape
        assert np.abs(got.astype(np.float64) - ref).max() <= 2e-6


# ---------------------------------------------------------------------------
# compute-sanitizer: the card's counterpart of the JAX package's kernelcheck
# ---------------------------------------------------------------------------
SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"

# The four kernels at small shapes, each held to its plain version. The
# inputs are made on the host and copied, so the only device code besides
# the kernels is PyTorch's copies and fills. The Hopper kernel's input
# has its pad channels zeroed: ``channels_last_padded`` leaves them
# unwritten on purpose (the kernel multiplies them by zero weights), which
# initcheck would report as reads of uninitialized memory.
SANITIZED_KERNELS = r"""
import numpy as np, torch
from chunkflow_tpu_torch.ops import accumulate, gather, int8_conv

dev = torch.device("cuda")
rng = np.random.default_rng(0)
chunk = torch.from_numpy(rng.integers(0, 256, (1, 6, 40, 72), dtype=np.uint8))
starts = torch.tensor([[0, 0, 0], [2, 10, 13], [3, 24, 40]], dtype=torch.int32)
got = gather.gather_patches(chunk.to(dev), starts, (3, 16, 32))
assert torch.equal(got.cpu(), gather.gather_patches_plain(chunk, starts,
                                                          (3, 16, 32)))
out = torch.from_numpy(rng.random((2, 6, 40, 72), dtype=np.float32))
weight = torch.from_numpy(rng.random((6, 40, 72), dtype=np.float32))
preds = torch.from_numpy(rng.random((3, 2, 3, 16, 32), dtype=np.float32))
valid = torch.tensor([1.0, 1.0, 0.0])
bump = torch.from_numpy(rng.random((3, 16, 32), dtype=np.float32) + 1)
o, w = accumulate.fused_accumulate_patches(
    out.to(dev), weight.to(dev), preds.to(dev), valid.to(dev), bump.to(dev),
    starts)
ro, rw = accumulate.fused_accumulate_patches_plain(
    out.clone(), weight.clone(), preds, valid, bump, starts)
assert torch.equal(o.cpu(), ro) and torch.equal(w.cpu(), rw)
g = torch.Generator().manual_seed(0)
x = torch.randint(-127, 128, (2, 20, 7, 13, 37), generator=g, dtype=torch.int8)
k = torch.randint(-127, 128, (24, 20, 3, 3, 3), generator=g, dtype=torch.int8)
assert int8_conv.plan(x.shape, k.shape, 1, 1).path == "hopper"
B, C, D, H, W = x.shape
buf = torch.zeros((B, D, H, W, int8_conv.channel_pitch(C)), dtype=torch.int8)
buf[..., :C] = x.permute(0, 2, 3, 4, 1)
xc = buf.to(dev)[..., :C].permute(0, 4, 1, 2, 3)
before = dict(int8_conv.path_launches)
got = int8_conv.conv3d_int8(xc, k.to(dev), 1, 1)
assert torch.equal(got.cpu(), int8_conv.conv3d_int8_plain(x, k, 1, 1))
x = torch.randint(-127, 128, (2, 3, 7, 11, 13), generator=g, dtype=torch.int8)
k = torch.randint(-127, 128, (5, 3, 3, 3, 3), generator=g, dtype=torch.int8)
assert int8_conv.plan(x.shape, k.shape, 2, 1, 2).path == "generic"
got = int8_conv.conv3d_int8(x.to(dev), k.to(dev), 2, 1, 2)
assert torch.equal(got.cpu(), int8_conv.conv3d_int8_plain(x, k, 2, 1, 2))
torch.cuda.synchronize()
launched = {p: n - before[p] for p, n in int8_conv.path_launches.items()}
assert gather.launches == accumulate.launches == 1, (gather.launches,
                                                    accumulate.launches)
assert launched == {"hopper": 1, "generic": 1}, launched
print("KERNELS_OK")
"""


@pytest.mark.parametrize("tool", ["memcheck", "initcheck", "racecheck"])
def test_kernels_clean_under_compute_sanitizer(cuda, tool):
    """Out-of-bounds and misaligned accesses (memcheck), reads of
    uninitialized device memory (initcheck) and shared-memory races
    (racecheck): what kernelcheck checks in interpret mode on the JAX
    package's Pallas kernels. The gather, the accumulate and both int8
    convolutions run once each in a child process under the tool, with
    PyTorch's caching allocator off so every allocation is its own
    (an access past a tensor's end then lands outside any allocation);
    the tool must report 0 errors. It skips when the tool is absent, or
    present but unable to attach to the card ("Device not supported")."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from chunkflow_tpu_torch import _build

    if not Path(SANITIZER).exists():
        pytest.skip(f"{SANITIZER} is not installed")
    # built here, so the child only loads them
    _build.build_all(("gather", "accumulate", "conv3d_int8",
                      "conv3d_int8_generic"))
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [SANITIZER, "--tool", tool, "--error-exitcode", "97",
         sys.executable, "-c", SANITIZED_KERNELS],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    text = proc.stdout + proc.stderr
    if "Device not supported" in text:
        # the tool is installed but cannot attach to this card (a
        # container without the debugger interface): it checked nothing
        pytest.skip(f"{SANITIZER} cannot attach to the card here: "
                    f"Device not supported")
    assert proc.returncode == 0, text[-6000:]
    assert "KERNELS_OK" in proc.stdout, text[-6000:]
    summary = [line for line in text.splitlines() if "SUMMARY" in line]
    assert summary and all("0 errors" in line for line in summary), \
        summary or text[-6000:]
