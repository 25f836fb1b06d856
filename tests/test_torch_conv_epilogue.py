"""RSUNet's convolution epilogue on the CPU: the plain version
(``ops/conv_epilogue.conv_epilogue_plain``) and the RSUNet forward that
calls it, each held bit for bit against the op sequence RSUNet ran
before the epilogue was one call (written out here as it was), in every
mode, compute dtype and precision leg. The CUDA kernel is held against
the plain version on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch
import torch.nn.functional as F

from chunkflow_tpu_torch.inference import precision
from chunkflow_tpu_torch.models.rsunet import RSUNet
from chunkflow_tpu_torch.models.unet3d import (
    Conv3d,
    ConvTranspose3d,
    _add_bias,
    seeded_init,
)
from chunkflow_tpu_torch.ops import conv_epilogue

torch.set_num_threads(1)

MODES = ("bias", "affine", "residual", "skip")
WIDTHS = (28, 36, 48, 64, 80)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SPECIALS = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (NaN payloads and signed zeros count)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _operands(mode, width, dtype, seed=0, shape=(2, 3, 5, 7)):
    """A convolution output, its parameters (float32) and, for the modes
    that add one, a residual or skip; special values sown in each."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((shape[0], width) + shape[1:], generator=g) * 3
    other = torch.randn(y.shape, generator=g) * 3
    bias, scale, shift = (torch.randn(width, generator=g) for _ in range(3))
    flat = y.view(-1)
    for i, v in enumerate(SPECIALS):
        flat[i * 37] = v
        other.view(-1)[i * 41 + 1] = v
    bias[1], scale[2], shift[3] = -0.0, -0.0, float("inf")
    return dict(y=y.to(dtype), bias=bias,
                scale=scale if mode in ("affine", "residual") else None,
                shift=shift if mode in ("affine", "residual") else None,
                other=other.to(dtype) if mode in ("residual", "skip")
                else None)


def _before(y, bias, scale, shift, other, dtype):
    """The sequence RSUNet ran before this module existed: the conv
    layer's in-place bias add (``_add_bias``), ``Affine``'s multiply and
    add, the residual or skip add, ``F.relu``."""
    y = _add_bias(y, bias.to(dtype))
    if scale is not None:
        shape = (-1,) + (1,) * (y.dim() - 2)
        y = (y * scale.to(dtype).view(shape)
             + shift.to(dtype).view(shape))
        if other is not None:
            y = y + other
        return F.relu(y)
    return y if other is None else y + other


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_plain_epilogue_is_the_sequence_it_replaced(mode, dtype, width):
    dt = DTYPES[dtype]
    ops = _operands(mode, width, dt, seed=width)
    ref = _before(ops["y"].clone(), ops["bias"], ops["scale"], ops["shift"],
                  ops["other"], dt)
    y = ops.pop("y")
    got = conv_epilogue.conv_epilogue_plain(y.clone(), dtype=dt, **ops)
    assert got.dtype == ref.dtype == dt
    assert torch.equal(_bits(got), _bits(ref))
    # the dispatching call runs the plain version on a CPU tensor
    assert torch.equal(_bits(conv_epilogue.conv_epilogue(y, dtype=dt, **ops)),
                       _bits(ref))


@pytest.mark.parametrize("mode", MODES)
def test_plain_epilogue_on_a_float32_output_with_bf16_parameters(mode):
    """The int8 ``real`` leg's case: float32 convolution sums in a
    bfloat16 model, its parameters rounded to bfloat16 and combined in
    float32, as the layers' type promotion did."""
    ops = _operands(mode, 36, torch.float32, seed=5)
    ref = _before(ops["y"].clone(), ops["bias"], ops["scale"], ops["shift"],
                  ops["other"], torch.bfloat16)
    got = conv_epilogue.conv_epilogue_plain(dtype=torch.bfloat16, **ops)
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("layout", ["contiguous", "channels_last",
                                    "permuted"])
def test_dense_reaches_a_kernel_layout_without_changing_values(layout):
    y = torch.randn(2, 5, 3, 4, 6)
    other = torch.randn(2, 5, 3, 4, 6)
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last_3d)
    elif layout == "permuted":
        y = y.transpose(3, 4).contiguous().transpose(3, 4)
    got, got_other = conv_epilogue.dense(y, other)
    assert torch.equal(got, y) and torch.equal(got_other, other)
    if layout == "permuted":
        assert got.is_contiguous() and got_other is other
    else:
        assert got is y
        fmt = (torch.channels_last_3d if layout == "channels_last"
               else torch.contiguous_format)
        assert got_other.is_contiguous(memory_format=fmt)
    alone, none = conv_epilogue.dense(y)
    assert none is None and torch.equal(alone, y)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cls", [Conv3d, ConvTranspose3d])
def test_conv_layers_still_add_their_bias(cls, dtype):
    """The layers UNet3D and the ``tpu`` families run: bitwise the
    convolution, then the in-place bias add; ``add_bias=False`` is the
    convolution alone."""
    dt = DTYPES[dtype]
    torch.manual_seed(3)
    if cls is Conv3d:
        layer = cls(6, 8, (1, 3, 3), padding=(0, 1, 1))
        conv = F.conv3d
        args = (layer.stride, layer.padding, layer.dilation, layer.groups)
    else:
        layer = cls(6, 8, (1, 2, 2), stride=(1, 2, 2))
        conv = F.conv_transpose3d
        args = (layer.stride, layer.padding, layer.output_padding,
                layer.groups, layer.dilation)
    layer.compute_dtype = dt
    x = torch.randn(2, 6, 3, 8, 8)
    with torch.no_grad():
        bare = conv(x.to(dt), layer.weight.to(dt), None, *args)
        want = bare.clone().add_(layer.bias.to(dt).view(-1, 1, 1, 1))
        assert torch.equal(_bits(layer(x)), _bits(want))
        assert torch.equal(_bits(layer(x, add_bias=False)), _bits(bare))


def _rsunet_before(model, x):
    """RSUNet's forward as it was, from the model's own layers."""

    def finish(conv, h, bn=None, other=None):
        y = conv(h)  # the layer adds its bias
        if bn is None:
            return y if other is None else y + other
        dt = conv.compute_dtype or y.dtype
        shape = (-1,) + (1,) * (y.dim() - 2)
        y = y * bn.weight.to(dt).view(shape) + bn.bias.to(dt).view(shape)
        return F.relu(y if other is None else y + other)

    def block(b, h):
        h = finish(b.conv1, h, b.bn1)
        residual = h
        h = finish(b.conv2, h, b.bn2)
        return finish(b.conv3, h, b.bn3, residual)

    orig = x.dtype
    h = finish(model.embed, x.to(model.dtype))
    depth = len(model.width)
    skips = []
    for i in range(depth - 1):
        h = block(getattr(model, f"enc{i}"), h)
        skips.append(h)
        f = model.down_factors[i]
        h = F.max_pool3d(h, kernel_size=f, stride=f)
    h = block(model.bridge, h)
    for i in reversed(range(depth - 1)):
        h = finish(getattr(model, f"up{i}"), h, other=skips[i])
        h = block(getattr(model, f"dec{i}"), h)
    return torch.sigmoid(model.out(h)).to(orig)


def _seeded_rsunet(dtype, seed=0):
    model = RSUNet(1, 3, width=(4, 6, 8), down_factors=((1, 2, 2),
                                                        (2, 2, 2)),
                   dtype=dtype).eval()
    g = torch.Generator().manual_seed(seed)
    seeded_init(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".bn" in name:
                # folded statistics: scales near 1, offsets near 0
                p.copy_(torch.randn(p.shape, generator=g) * 0.2
                        + (1.0 if name.endswith("weight") else 0.0))
    return model


@pytest.mark.parametrize("leg", ["float32", "bfloat16", "fake", "fakeint",
                                 "real"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rsunet_forward_is_what_it_was(monkeypatch, dtype, leg):
    """The whole forward in each compute dtype and at each precision leg
    (int8 through ``wrap_apply``, as the engine runs it; on the CPU the
    real leg sums on the integer grid in float64): bitwise the forward
    before the epilogue was one call."""
    model = _seeded_rsunet(DTYPES[dtype])
    x = torch.rand((2, 1, 4, 16, 16),
                   generator=torch.Generator().manual_seed(1))
    if leg in ("float32", "bfloat16"):
        prec = leg
    else:
        prec = "int8"
        monkeypatch.setenv("CHUNKFLOW_INT8", leg)

    def run(forward):
        with torch.no_grad():
            return precision.wrap_apply(
                lambda b: forward(model, b), prec, model, forward)(x)

    got = run(lambda m, b: m(b))
    ref = run(_rsunet_before)
    assert got.dtype == ref.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cost_count_sees_every_rsunet_convolution(dtype):
    """The cost ledger's analytic count (``core/profiling.count_work``, a
    global forward hook on the convolution layers) finds every one of
    RSUNet's convolutions: each runs through its layer's call without its
    bias (``add_bias=False``), so the count is the forward's before the
    epilogue was one call."""
    from chunkflow_tpu_torch.core import profiling

    model = _seeded_rsunet(DTYPES[dtype])
    x = torch.rand((2, 1, 4, 16, 16),
                   generator=torch.Generator().manual_seed(1))
    counted = []
    for forward in (lambda m, b: m(b), _rsunet_before):
        with torch.no_grad(), profiling.count_work() as work:
            forward(model, x)
        counted.append((work.flops, work.bytes))
    assert counted[0] == counted[1] and counted[0][0] > 0
