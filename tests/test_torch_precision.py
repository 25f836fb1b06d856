"""The port's precision ladder (bf16, int8 fake / fakeint / real) against
the JAX package.

The same numpy-seeded inputs go through both packages on the CPU, where
the port's int8 convolution is its plain version (float64 on the integer
grid: exact). Held:

- every case of ``tests/inference/test_precision.py`` but the two mesh
  tests, on the port AND the JAX package: the JAX gates (bf16 0.02 /
  0.005, int8 0.05 / 0.01 max-abs / mean-abs against float32) on the
  identity and conv engines, plain, ragged and crop-margin traffic; the
  uint8 contract; float32 as the engine's apply itself; ``real``
  bitwise ``fakeint``;
- the identity engine bitwise the JAX package at every leg, except
  int8 ``fake`` against the COMPILED JAX program: XLA on the CPU fuses
  the dequant multiply into the bump-weighted accumulation, as in the
  fold (``tests/test_torch_fold.py``); there the port is bitwise the JAX
  package run op by op and within 4 float32 ulp of the compiled one;
- one quantized layer per shape class of the int8 kernel (SAME
  convolutions (3,3,3), (1,3,3), (1,5,5), (1,1,1) from 1 to 64 input
  channels, the MxuConv 2D slices over ``b * d`` rows, the kernel ==
  stride transposed convolution, the GEMM upsample), bitwise the JAX
  ``_int8_conv`` / ``_int8_dot`` with ``integer`` True and False;
- every convnet family at every leg against the JAX package, at narrow
  widths. Not bitwise (XLA and oneDNN sum in other orders, and an int8
  grid turns a last-bit difference into a whole level now and then).
  Measured max-abs / mean-abs, port vs JAX, fakeint and real alike:
  parity 1.2e-7 / 5e-9, rsunet 6e-8 / 1e-10, tpu 0.006 / 3.8e-4,
  tpu_mxu 0.020 / 1.5e-3, tpu_s2d4 1.8e-7 / 1.9e-8 (bf16 <= 0.002, fake
  <= 1e-6): held within the int8 gate (0.05 / 0.01), the fake leg within
  1e-5 and bf16 within 0.02; each case prints its bitwise share.

``tpu`` on a bfloat16 engine under int8 ``real`` (the README chain with
``CHUNKFLOW_PRECISION=int8 CHUNKFLOW_INT8=real``) does not run in the
JAX package: its jaxpr replay binds the bias add with the float32
product and the traced bf16 bias, and ``lax.add`` refuses mixed dtypes
(``test_jax_real_int8_on_a_bf16_engine_raises``). The port follows
flax's dtype flow instead (the product float32, the bias promoted, the
norm bf16, each convolution quantizing its bf16-rounded input); its
reference here is the flax model with the JAX package's own W8A8
arithmetic substituted at each ``lax.conv_general_dilated`` and
``lax.conv_transpose`` call.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.inference import engines as jax_engines
from chunkflow_tpu.inference import precision as jax_precision
from chunkflow_tpu.inference.inferencer import Inferencer as JaxInferencer
from chunkflow_tpu.models import rsunet as flax_rsunet
from chunkflow_tpu.models import unet3d as flax_unet3d
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.inference import engines, precision
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.inference.precision import (
    PRECISIONS,
    Int8Mode,
    resolve_precision,
    wrap_apply,
)
from chunkflow_tpu_torch.models.convert import state_from_flax
from chunkflow_tpu_torch.models.rsunet import RSUNet
from chunkflow_tpu_torch.models.unet3d import UNet3D
from chunkflow_tpu_torch.ops import int8_conv
from tests.test_torch_models import DOWNS, FEATS, draw_params, numpy_tree

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (4, 16, 16)
OVERLAP = (2, 8, 8)

# the JAX package's gates (tests/inference/test_precision.py)
MAX_ABS_ERR = {"bfloat16": 0.02, "int8": 0.05}
MEAN_ERR = {"bfloat16": 0.005, "int8": 0.01}
# the compiled JAX program's fused multiply-adds (module docstring)
FMA_ULP = 4
# port vs JAX, per leg (module docstring)
LEG_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (0.02, 0.005),
           "fake": (1e-5, 1e-6), "fakeint": (0.05, 0.01),
           "real": (0.05, 0.01)}
LEGS = (("bfloat16", None), ("int8", "fake"), ("int8", "fakeint"),
        ("int8", "real"))
FAMILIES = ("parity", "rsunet", "tpu", "tpu_mxu", "tpu_s2d4")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("CHUNKFLOW_PRECISION", "CHUNKFLOW_INT8", "CHUNKFLOW_PALLAS",
                "CHUNKFLOW_GATHER", "CHUNKFLOW_BLEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(precision, "_WARNED_VALUES", set())
    monkeypatch.setattr(precision, "_INT8_WARNED", set())
    monkeypatch.setattr(jax_precision, "_WARNED_VALUES", set())
    monkeypatch.setattr(jax_precision, "_INT8_WARNED", set())
    return monkeypatch


def _leg(monkeypatch, leg):
    if leg is None:
        monkeypatch.delenv("CHUNKFLOW_INT8", raising=False)
    else:
        monkeypatch.setenv("CHUNKFLOW_INT8", leg)


# ---------------------------------------------------------------------------
# spec resolution
# ---------------------------------------------------------------------------
def test_resolve_precision_defaults_and_aliases(monkeypatch):
    monkeypatch.delenv("CHUNKFLOW_PRECISION", raising=False)
    assert resolve_precision() == "float32"
    assert resolve_precision("bf16") == "bfloat16"
    assert resolve_precision("FP32") == "float32"
    assert resolve_precision("i8") == "int8"
    for p in PRECISIONS:
        assert resolve_precision(p) == p
    monkeypatch.setenv("CHUNKFLOW_PRECISION", "int8")
    assert resolve_precision() == "int8"
    assert PRECISIONS == jax_precision.PRECISIONS


def test_resolve_precision_explicit_is_strict():
    with pytest.raises(ValueError, match="precision"):
        resolve_precision("float16")
    with pytest.raises(ValueError, match="precision"):
        jax_precision.resolve_precision("float16")


def test_resolve_precision_env_typo_warns_once(monkeypatch, capsys):
    monkeypatch.setenv("CHUNKFLOW_PRECISION", "bfloat61")
    assert resolve_precision() == "float32"
    err = capsys.readouterr().err
    assert "bfloat61" in err and "not a recognized value" in err
    assert resolve_precision() == "float32"
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("value", ["", "fake", "0", "OFF", "real", "1",
                                   "On", "fakeint", "reel"])
def test_int8_mode_matches_jax(monkeypatch, capsys, value):
    """``CHUNKFLOW_INT8``: the same leg for every value in both packages,
    one identical note each for a typo, and the same precision tags."""
    monkeypatch.setenv("CHUNKFLOW_INT8", value)
    for _ in range(2):
        assert precision.int8_mode() == jax_precision.int8_mode()
    for p in PRECISIONS:
        assert precision.precision_tag(p) == jax_precision.precision_tag(p)
    err = capsys.readouterr().err
    note = "CHUNKFLOW_INT8='reel' is not a recognized value"
    assert err.count(note) == (2 if value == "reel" else 0)
    if value == "reel":
        lines = [line for line in err.splitlines() if note in line]
        assert lines[0] == lines[1]


def test_float32_wrap_is_identity_object():
    def apply(batch):
        return batch

    assert wrap_apply(apply, "float32") is apply
    assert wrap_apply(apply, "bfloat16") is not apply


# ---------------------------------------------------------------------------
# the quantization-error suite, both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def conv_engines():
    """The JAX gate's conv engine (the full-width parity UNet3D, seeded
    flax init) and the port's engine holding the same weights."""
    jax_engine = jax_engines.create_flax_engine(
        "", None, PIN, num_input_channels=1, num_output_channels=3)
    port_engine = engines.create_engine("pytorch", model_variant="parity")
    port_engine.model.load_state_dict(
        state_from_flax(numpy_tree(jax_engine.params)))
    return jax_engine, port_engine


def _identity(pout=PIN):
    return (jax_engines.create_identity_engine(
                input_patch_size=PIN, output_patch_size=pout,
                num_input_channels=1, num_output_channels=3),
            engines.create_identity_engine(
                input_patch_size=PIN, output_patch_size=pout,
                num_input_channels=1, num_output_channels=3))


def _kwargs(crop=False, **kw):
    if crop:
        return dict(input_patch_size=PIN, output_patch_size=(2, 8, 8),
                    output_patch_overlap=(1, 4, 4), num_output_channels=3,
                    framework="prebuilt", batch_size=2,
                    crop_output_margin=True, **kw)
    return dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                num_output_channels=3, framework="prebuilt", batch_size=2,
                crop_output_margin=False, **kw)


def _traffic(kind: str) -> np.ndarray:
    rng = np.random.default_rng(17)
    if kind == "ragged":
        return rng.random((6, 37, 45)).astype(np.float32)
    return rng.random((8, 40, 48)).astype(np.float32)


def _both(engine_pair, precision_, arr, crop=False, **kw):
    """(port result, JAX result) as numpy on one chunk."""
    jax_engine, port_engine = engine_pair
    ref = np.asarray(JaxInferencer(
        engine=jax_engine, precision=precision_, **_kwargs(crop, **kw))(
            JaxChunk(arr)).array)
    got = Inferencer(device="cpu", engine=port_engine, precision=precision_,
                     **_kwargs(crop, **kw))(Chunk(arr)).host().array
    return got, ref


def _gate(got, ref32, precision_, label):
    err = np.abs(got.astype(np.float64) - ref32.astype(np.float64))
    scale = max(float(np.abs(ref32).max()), 1.0)
    assert err.max() <= MAX_ABS_ERR[precision_] * scale, (label, err.max())
    assert err.mean() <= MEAN_ERR[precision_] * scale, (label, err.mean())
    return err


def _against_jax(got, ref, engine_kind, leg):
    """The port against the JAX package: the identity engine bitwise
    (int8 ``fake`` within FMA_ULP of the compiled program), a convnet
    within the leg's tolerance."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if engine_kind == "identity":
        if leg == "fake" and got.dtype == np.float32:
            np.testing.assert_array_max_ulp(got, ref, maxulp=FMA_ULP)
        else:
            assert np.array_equal(got, ref)
        return
    max_tol, mean_tol = LEG_TOL[leg]
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    print(f"port vs JAX ({leg}): max-abs {diff.max():.3g}, mean-abs "
          f"{diff.mean():.3g}, bitwise share {np.mean(got == ref):.3f}")
    assert diff.max() <= max_tol and diff.mean() <= mean_tol


@pytest.mark.parametrize("precision_", ["bfloat16", "int8"])
@pytest.mark.parametrize("engine_kind", ["identity", "conv"])
@pytest.mark.parametrize("traffic", ["plain", "ragged"])
def test_quantization_error_bounds(conv_engines, engine_kind, precision_,
                                   traffic):
    """bf16 / int8 (fake) within the JAX gates of float32 in the port and
    in the JAX package, on the same chunk; the port against JAX."""
    pair = _identity() if engine_kind == "identity" else conv_engines
    arr = _traffic(traffic)
    ref32, jax32 = _both(pair, "float32", arr)
    got, ref = _both(pair, precision_, arr)
    for out, base, who in ((got, ref32, "port"), (ref, jax32, "jax")):
        err = _gate(out, base, precision_, f"{who}/{engine_kind}/{traffic}")
        assert err.max() > 0.0  # a narrow forward that changes nothing
    _against_jax(got, ref, engine_kind,
                 "bfloat16" if precision_ == "bfloat16" else "fake")


@pytest.mark.parametrize("precision_", ["bfloat16", "int8"])
def test_quantization_error_crop_margin(precision_):
    pair = _identity(pout=(2, 8, 8))
    arr = _traffic("ragged")
    ref32, _ = _both(pair, "float32", arr, crop=True)
    got, ref = _both(pair, precision_, arr, crop=True)
    err = np.abs(got.astype(np.float64) - ref32.astype(np.float64))
    assert 0.0 < err.max() <= MAX_ABS_ERR[precision_]
    _against_jax(got, ref, "identity",
                 "bfloat16" if precision_ == "bfloat16" else "fake")


def test_uint8_quantization_contract_survives():
    pair = _identity()
    arr = _traffic("plain")
    ref32, _ = _both(pair, "float32", arr, output_dtype="uint8")
    got, ref = _both(pair, "bfloat16", arr, output_dtype="uint8")
    assert got.dtype == np.uint8 == ref32.dtype
    assert np.abs(got.astype(np.int32) - ref32.astype(np.int32)).max() <= 1
    assert np.array_equal(got, ref)


def test_float32_default_bitwise_untouched(monkeypatch):
    _, engine = _identity()
    arr = _traffic("ragged")
    default = Inferencer(device="cpu", engine=engine, **_kwargs())
    assert default.precision == "float32"
    assert default._apply is engine.apply
    ref = default(Chunk(arr)).host().array
    explicit = Inferencer(device="cpu", engine=engine, precision="float32",
                          **_kwargs())(Chunk(arr)).host().array
    assert np.array_equal(ref, explicit)
    monkeypatch.setenv("CHUNKFLOW_PRECISION", "bfloat16")
    assert Inferencer(device="cpu", engine=engine,
                      **_kwargs()).precision == "bfloat16"


def test_precision_composes_with_fused_kernel(monkeypatch):
    """bf16 forward, then the port's accumulation: bitwise the JAX
    package with its Pallas kernel (interpret) and with its XLA
    scatter."""
    pair = _identity()
    arr = _traffic("ragged")
    monkeypatch.setenv("CHUNKFLOW_PALLAS", "0")
    got, ref = _both(pair, "bfloat16", arr)
    monkeypatch.setenv("CHUNKFLOW_PALLAS", "interpret")
    _, ref_kernel = _both(pair, "bfloat16", arr)
    assert np.array_equal(got, ref) and np.array_equal(got, ref_kernel)


def test_fake_identity_is_the_jax_package_op_by_op(monkeypatch):
    """The int8 fake leg on the identity engine: bitwise the JAX package
    run op by op (its arithmetic in its order); the compiled program
    fuses the dequant multiply into the accumulation (module
    docstring)."""
    _leg(monkeypatch, "fake")
    jax_engine, port_engine = _identity()
    arr = _traffic("ragged")
    with jax.disable_jit():
        eager = np.asarray(JaxInferencer(engine=jax_engine, precision="int8",
                                         **_kwargs())(JaxChunk(arr)).array)
    got = Inferencer(device="cpu", engine=port_engine, precision="int8",
                     **_kwargs())(Chunk(arr)).host().array
    assert np.array_equal(got, eager)


# ---------------------------------------------------------------------------
# the real int8 leg
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine_kind", ["identity", "conv"])
def test_int8_real_vs_fakeint_bitwise(conv_engines, engine_kind,
                                      monkeypatch):
    """The agreement oracle: the exact integer sums and their float32
    twin on the same grids, dequantized by one expression: bitwise while
    the sums stay below 2^24. And each leg against the JAX package."""
    pair = _identity() if engine_kind == "identity" else conv_engines
    arr = _traffic("ragged")
    _leg(monkeypatch, "real")
    real, jax_real = _both(pair, "int8", arr)
    _leg(monkeypatch, "fakeint")
    twin, jax_twin = _both(pair, "int8", arr)
    assert np.array_equal(real, twin)
    assert np.array_equal(jax_real, jax_twin)
    _against_jax(real, jax_real, engine_kind, "real")


def test_int8_real_runs_integer_convolutions(conv_engines, monkeypatch):
    """The int8 probe (the JAX jaxpr probe's counterpart): under ``real``
    the integer convolution runs on int8 operands (its plain version here,
    its kernel on the card); under ``fake`` and ``fakeint`` it never
    runs."""
    calls = []
    plain = int8_conv.conv3d_int8_plain

    def probe(x, w, *args):
        calls.append((x.dtype, w.dtype))
        return plain(x, w, *args)

    monkeypatch.setattr(int8_conv, "conv3d_int8_plain", probe)
    _, port_engine = conv_engines
    batch = torch.linspace(0.0, 1.0, int(np.prod((2, 1) + PIN))).reshape(
        (2, 1) + PIN)
    for leg, expect in (("real", True), ("fake", False),
                        ("fakeint", False)):
        _leg(monkeypatch, leg)
        calls.clear()
        with torch.no_grad():
            out = wrap_apply(port_engine.apply, "int8", port_engine.params,
                             port_engine.call)(batch)
        assert out.dtype == torch.float32 and out.shape == (2, 3) + PIN
        assert bool(calls) == expect, (leg, len(calls))
        assert all(d == (torch.int8, torch.int8) for d in calls)


@pytest.mark.parametrize("engine_kind", ["identity", "conv"])
@pytest.mark.parametrize("traffic", ["plain", "ragged"])
def test_int8_real_error_bounds(conv_engines, engine_kind, traffic,
                                monkeypatch):
    """The real leg inside the int8 gates in both packages; the identity
    engine (no convolution) passes through exactly."""
    pair = _identity() if engine_kind == "identity" else conv_engines
    arr = _traffic(traffic)
    ref32, jax32 = _both(pair, "float32", arr)
    _leg(monkeypatch, "real")
    got, ref = _both(pair, "int8", arr)
    for out, base, who in ((got, ref32, "port"), (ref, jax32, "jax")):
        err = _gate(out, base, "int8", f"{who}/{engine_kind}/{traffic}")
        if engine_kind == "conv":
            assert err.max() > 0.0
        else:
            assert err.max() == 0.0
    _against_jax(got, ref, engine_kind, "real")


def test_int8_real_composes_with_kernels_clean(monkeypatch):
    """Real int8 forward and the port's accumulation: bitwise the JAX
    package with both Pallas kernels in interpret mode."""
    _leg(monkeypatch, "real")
    monkeypatch.setenv("CHUNKFLOW_PALLAS", "interpret")
    monkeypatch.setenv("CHUNKFLOW_GATHER", "interpret")
    got, ref = _both(_identity(), "int8", _traffic("ragged"))
    assert np.array_equal(got, ref)


# ---------------------------------------------------------------------------
# one quantized layer per shape class, bitwise the JAX arithmetic
# ---------------------------------------------------------------------------
def _conv_params(lhs_shape, rhs_shape, padding, spec):
    nd = len(lhs_shape) - 2
    return dict(
        window_strides=(1,) * nd, padding=padding,
        lhs_dilation=(1,) * nd, rhs_dilation=(1,) * nd,
        dimension_numbers=lax.conv_dimension_numbers(lhs_shape, rhs_shape,
                                                     spec),
        feature_group_count=1, batch_group_count=1)


# name -> (input [B, C, *zyx], weight [O, C, *k], padding)
CONV_CLASSES = {
    "3x3x3_4to7": ((2, 4, 5, 9, 11), (7, 4, 3, 3, 3), 1),
    "3x3x3_28to28": ((2, 28, 3, 6, 6), (28, 28, 3, 3, 3), 1),
    "1x3x3_8to8": ((2, 8, 3, 9, 7), (8, 8, 1, 3, 3), (0, 1, 1)),
    "1x5x5_conv_in": ((2, 1, 4, 16, 16), (6, 1, 1, 5, 5), (0, 2, 2)),
    "1x5x5_s2d4_stem": ((2, 16, 4, 4, 4), (12, 16, 1, 5, 5), (0, 2, 2)),
    "1x1x1_head": ((3, 6, 4, 8, 8), (3, 6, 1, 1, 1), 0),
    "3x3x3_64to64": ((1, 64, 2, 4, 4), (64, 64, 3, 3, 3), 1),
    "mxu_slice_2d": ((6, 8, 9, 7), (5, 8, 3, 3), 1),
}


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("tainted", [True, False])
@pytest.mark.parametrize("name", list(CONV_CLASSES))
def test_int8_conv_layer_is_the_jax_arithmetic(name, tainted, integer):
    xs, ws, pad = CONV_CLASSES[name]
    rng = np.random.default_rng(len(name))
    x = (rng.standard_normal(xs) * rng.random((xs[0],) + (1,) * (len(xs)
         - 1))).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.1).astype(np.float32)
    nd = len(xs) - 2
    padding = [(p, p) for p in ((pad,) * nd if isinstance(pad, int)
                                else pad)]
    spec = ("NCDHW", "OIDHW", "NCDHW") if nd == 3 else ("NCHW", "OIHW",
                                                         "NCHW")
    ref = np.asarray(jax_precision._int8_conv(
        _conv_params(xs, ws, padding, spec), x, w, tainted, integer))
    got = precision._int8_conv(torch.from_numpy(x), torch.from_numpy(w),
                               tainted, integer, 1, pad)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("factor", [(1, 2, 2), (2, 2, 2)])
def test_int8_conv_transpose_is_the_jax_arithmetic(factor, integer):
    """flax's ``ConvTranspose`` (a convolution with input dilation in the
    JAX package) against the port's ``F.conv_transpose3d`` under the
    mode, as a 1x1x1 convolution and depth-to-space: the same scales and
    integer sums, bitwise."""
    import flax.linen as nn

    rng = np.random.default_rng(sum(factor))
    x = rng.standard_normal((2, 3, 4, 5, 12)).astype(np.float32)  # NDHWC
    kernel = (rng.standard_normal(factor + (12, 7)) * 0.2).astype(np.float32)
    fnet = nn.ConvTranspose(7, factor, strides=factor, use_bias=False)
    closed = jax.make_jaxpr(lambda k, v: fnet.apply(
        {"params": {"kernel": k}}, v))(kernel, x)
    eqn = next(e for e in closed.jaxpr.eqns
               if e.primitive.name == "conv_general_dilated")
    ref = np.asarray(jax_precision._int8_conv(eqn.params, x, kernel, True,
                                              integer))
    weight = torch.from_numpy(np.ascontiguousarray(
        np.transpose(kernel[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))))
    with Int8Mode(integer) as mode:
        got = torch.nn.functional.conv_transpose3d(
            mode.mark(torch.from_numpy(x).permute(0, 4, 1, 2, 3)), weight,
            stride=factor)
    assert np.array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("lhs_tainted", [True, False])
def test_int8_gemm_upsample_is_the_jax_arithmetic(lhs_tainted, integer):
    """MxuConvTranspose's ``x @ k2`` through the JAX ``_int8_dot`` and
    the port's (through the mode's ``@``): per-row over the batch axis,
    per-tensor weight, bitwise."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5, 12)).astype(np.float32)
    k2 = (rng.standard_normal((12, 28)) * 0.2).astype(np.float32)
    params = {"dimension_numbers": (((4,), (0,)), ((), ()))}
    ref = np.asarray(jax_precision._int8_dot(params, x, k2, lhs_tainted,
                                             False, integer))
    with Int8Mode(integer) as mode:
        xt = torch.from_numpy(x)
        if lhs_tainted:
            mode.mark(xt)
        else:
            mode.mark(torch.from_numpy(k2))  # nothing marked: no rewrite
        got = precision._int8_dot(xt, torch.from_numpy(k2), lhs_tainted,
                                  False, integer, params["dimension_numbers"])
        via_mode = xt @ torch.from_numpy(k2)
    assert np.array_equal(got.numpy(), ref)
    if lhs_tainted:
        assert np.array_equal(via_mode.numpy(), ref)


def test_mode_catches_plain_torch_layers():
    """A user model of plain ``nn.Conv3d`` / ``nn.ConvTranspose3d`` /
    ``nn.Linear``: the mode rewrites each layer an activation reaches,
    and only those (a parameter-only product stays float32)."""
    torch.manual_seed(0)
    conv = torch.nn.Conv3d(2, 4, 3, padding=1)
    up = torch.nn.ConvTranspose3d(4, 3, (1, 2, 2), stride=(1, 2, 2))
    lin = torch.nn.Linear(16, 5)
    x = torch.rand(2, 2, 3, 8, 8)
    with torch.no_grad(), Int8Mode(True) as mode:
        y = conv(mode.mark(x.clone()))
        z = up(y)
        v = lin(z)
        w_only = conv.weight.flatten(1) @ conv.weight.flatten(1).t()
        assert all(mode.is_activation(t) for t in (y, z, v))
        assert not mode.is_activation(w_only)
    yq = precision._int8_conv(x, conv.weight, True, True, 1, 1) \
        + conv.bias.view(1, -1, 1, 1, 1)
    assert torch.equal(y, yq)
    assert torch.equal(w_only, conv.weight.flatten(1)
                       @ conv.weight.flatten(1).t())


# ---------------------------------------------------------------------------
# every family at every leg, port vs JAX
# ---------------------------------------------------------------------------
def _family(family, dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    if family == "rsunet":
        return (flax_rsunet.RSUNet(1, 3, width=FEATS, down_factors=DOWNS,
                                   dtype=jdt),
                RSUNet(1, 3, width=FEATS, down_factors=DOWNS, dtype=tdt),
                (4, 16, 16))
    s2d, pin = {"parity": (None, (4, 16, 16)),
                "tpu": ((1, 2, 2), (4, 16, 16)),
                "tpu_mxu": ((1, 2, 2), (4, 16, 16)),
                "tpu_s2d4": ((1, 4, 4), (4, 32, 32))}[family]
    impl = "mxu" if family == "tpu_mxu" else "native"
    return (flax_unet3d.UNet3D(1, 3, feature_maps=FEATS, down_factors=DOWNS,
                               dtype=jdt, s2d_factor=s2d, conv_impl=impl),
            UNet3D(1, 3, feature_maps=FEATS, down_factors=DOWNS, dtype=tdt,
                   s2d_factor=s2d, conv_impl=impl),
            pin)


def _forwards(family, dtype="float32"):
    """(JAX engine apply, its params, port apply/params/call, input)."""
    fnet, tnet, pin = _family(family, dtype)
    params = draw_params(fnet, pin, seed=3)
    tnet.load_state_dict(state_from_flax(numpy_tree(params)))
    tnet.eval()

    def jax_apply(p, batch):
        y = fnet.apply({"params": p}, jnp.moveaxis(batch, 1, -1))
        return jnp.moveaxis(y, -1, 1).astype(jnp.float32)

    def call(module, batch):
        with engines.exact_float32():
            return module(batch).float()

    x = np.random.default_rng(4).random((2, 1) + pin, dtype=np.float32)
    return jax_apply, params, tnet, call, x


def _port(tnet, call, precision_, x):
    with torch.no_grad():
        return wrap_apply(lambda b: call(tnet, b), precision_, tnet, call)(
            torch.from_numpy(x)).numpy()


def _compare(got, ref, leg, label):
    max_tol, mean_tol = LEG_TOL[leg]
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    print(f"{label}: port vs JAX max-abs {diff.max():.3g}, mean-abs "
          f"{diff.mean():.3g}, bitwise share {np.mean(got == ref):.3f}")
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert diff.max() <= max_tol and diff.mean() <= mean_tol


@pytest.mark.parametrize("precision_, leg", LEGS,
                         ids=["bf16", "fake", "fakeint", "real"])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_leg_matches_jax(family, precision_, leg, monkeypatch):
    _leg(monkeypatch, leg)
    jax_apply, params, tnet, call, x = _forwards(family)
    ref = np.asarray(jax_precision.wrap_apply(jax_apply, precision_)(
        params, x))
    got = _port(tnet, call, precision_, x)
    _compare(got, ref, leg or "bfloat16", f"{family} {leg or precision_}")


def _flax_int8(monkeypatch, integer=True):
    """Substitute the JAX package's W8A8 arithmetic (``_int8_conv``'s
    expressions: activations per row over the batch axis, kernels per
    tensor) at flax's ``lax.conv_general_dilated`` and
    ``lax.conv_transpose`` calls; flax's own code around them then runs
    as written, promotions included."""
    conv, conv_t = lax.conv_general_dilated, lax.conv_transpose

    def quant(lhs, rhs):
        ql, sl = jax_precision._quant_rows_axis(lhs, 0)
        qr, sr = jax_precision._quant_tensor(rhs)
        return ql.astype(jnp.int8), qr.astype(jnp.int8), sl, sr

    def conv_int8(lhs, rhs, *args, preferred_element_type=None, **kw):
        ql, qr, sl, sr = quant(lhs, rhs)
        prod = conv(ql, qr, *args, preferred_element_type=jnp.int32,
                    **kw).astype(jnp.float32)
        return prod * (sl.reshape((-1,) + (1,) * (prod.ndim - 1)) * sr)

    def conv_t_int8(lhs, rhs, *args, preferred_element_type=None, **kw):
        ql, qr, sl, sr = quant(lhs, rhs)
        prod = conv_t(ql, qr, *args, preferred_element_type=jnp.int32,
                      **kw).astype(jnp.float32)
        return prod * (sl.reshape((-1,) + (1,) * (prod.ndim - 1)) * sr)

    monkeypatch.setattr(lax, "conv_general_dilated", conv_int8)
    monkeypatch.setattr(lax, "conv_transpose", conv_t_int8)


def test_real_int8_on_a_bf16_engine_follows_flax(monkeypatch):
    """``tpu`` computing in bfloat16 under int8 ``real``: the port
    against the flax model with the JAX package's W8A8 arithmetic at
    each convolution (module docstring), within the int8 leg's
    tolerance; and against the bf16 engine's own float forward, within
    the int8 gates."""
    _leg(monkeypatch, "real")
    jax_apply, params, tnet, call, x = _forwards("tpu", "bfloat16")
    plain = _port(tnet, call, "float32", x)
    got = _port(tnet, call, "int8", x)
    with monkeypatch.context() as patched:
        _flax_int8(patched)
        ref = np.asarray(jax_apply(params, x))
    _compare(got, ref, "real", "tpu bf16 engine, real")
    _gate(got, plain, "int8", "tpu bf16 engine, real vs its float forward")


def test_jax_real_int8_on_a_bf16_engine_raises(monkeypatch):
    """The JAX package's own real leg on a bf16 engine fails: the jaxpr
    replay binds ``add`` with the float32 product and the bf16 bias
    (``_eval_int8_jaxpr`` keeps each traced primitive's operand dtypes).
    Recorded in ROADMAP §3; the port runs the flax dtype flow."""
    _leg(monkeypatch, "real")
    jax_apply, params, _, _, x = _forwards("tpu", "bfloat16")
    with pytest.raises(TypeError, match="same dtypes"):
        jax_precision.wrap_apply(jax_apply, "int8")(params, x)


@pytest.mark.parametrize("family", FAMILIES)
def test_fake_quantizes_the_flax_leaves(family):
    """``fake`` quantizes every float leaf per tensor: the port's float
    parameters and buffers are the flax leaves one for one (a flip or a
    layout change keeps the amax), so the quantized state is the JAX
    package's quantized tree, converted."""
    fnet, tnet, pin = _family(family)
    params = draw_params(fnet, pin, seed=3)
    tnet.load_state_dict(state_from_flax(numpy_tree(params)))
    floats = [n for n, t in list(tnet.named_parameters())
              + list(tnet.named_buffers()) if t.is_floating_point()]
    leaves = jax.tree_util.tree_leaves(params)
    assert len(floats) == len(leaves)
    quantized = precision._quant_float_leaves(tnet)
    expect = state_from_flax(numpy_tree(
        jax_precision._quant_float_leaves(params)))
    state = quantized.state_dict()
    assert sorted(state) == sorted(expect)
    for key, value in expect.items():
        assert torch.equal(state[key], value), key
    # the caller's module is untouched
    assert torch.equal(tnet.state_dict()[floats[0]],
                       state_from_flax(numpy_tree(params))[floats[0]])


# ---------------------------------------------------------------------------
# every route runs the chosen precision
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leg", ["fake", "real", "fakeint"])
def test_every_route_runs_the_precision(monkeypatch, leg, tmp_path):
    """``CHUNKFLOW_PRECISION=int8`` with each ``CHUNKFLOW_INT8`` leg:
    ``__call__``, both streamed executors and the CLI's ``inference`` give
    one result on a small convnet; the fold blend runs too."""
    from chunkflow_tpu_torch.flow import cli

    monkeypatch.setenv("CHUNKFLOW_PRECISION", "int8")
    _leg(monkeypatch, leg)
    kwargs = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                  num_output_channels=3, framework="pytorch",
                  model_variant="tpu", batch_size=2)
    inf = Inferencer(device="cpu", **kwargs)
    assert inf.precision == "int8"
    arr = (np.random.default_rng(1).random((8, 32, 32)) * 255).astype(
        np.uint8)
    want = inf(Chunk(arr)).host().array
    for adaptive in (True, False):
        out = list(inf.stream(iter([Chunk(arr)]), adaptive=adaptive))
        assert np.array_equal(out[0].array, want)
    folded = Inferencer(device="cpu", blend="fold", **kwargs)(Chunk(arr))
    assert folded.host().array.shape == want.shape
    np.save(tmp_path / "in.npy", arr)
    rc = cli.main(["--device", "cpu", "load-npy", "-f",
                   str(tmp_path / "in.npy"), "inference", "-f", "pytorch",
                   "--model-variant", "tpu", "-p", *map(str, PIN), "-v",
                   *map(str, OVERLAP), "-c", "3", "-b", "2", "save-npy", "-f",
                   str(tmp_path / "out.npy")])
    assert rc == 0
    assert np.array_equal(np.load(tmp_path / "out.npy"), want)


@pytest.mark.parametrize("leg", ["fake", "real"])
def test_int8_gap_at_full_width_is_the_jax_packages(monkeypatch, leg):
    """int8 against float32 at full width, ``chip_smoke.py`` phase 13's
    weights (the parity engine's seeded init) on one 8x64x64 crop of its
    chunk: the port's gap is the JAX package's own, and both exceed the
    JAX gates the fixture-size suite above holds (``real`` both gates;
    ``fake`` reaches the max gate). Measured max-abs / mean-abs on this
    crop, port vs JAX: fake 0.05046 / 0.00627 both, real 0.103 / 0.0139
    vs 0.115 / 0.0139 (on four crops, fake 0.0505 / 0.00590 both, real
    0.121 / 0.0140 vs 0.120 / 0.0140). So phase 13 prints the chunk's
    gap and holds the card against the CPU port instead."""
    from tests.test_torch_models import _flax_full_width, smoke_crops
    from chunkflow_tpu.models.converter import torch_to_flax_by_name

    _leg(monkeypatch, leg)
    engine = engines.create_engine("pytorch", model_variant="parity")
    template = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype),
        jax.eval_shape(lambda: flax_unet3d.init_params(
            _flax_full_width("parity"), (4, 32, 32), 1)))
    params = torch_to_flax_by_name(
        {k: v.numpy() for k, v in engine.model.state_dict().items()},
        template)
    fnet = _flax_full_width("parity")

    def jax_apply(p, batch):
        y = fnet.apply({"params": p}, jnp.moveaxis(batch, 1, -1))
        return jnp.moveaxis(y, -1, 1).astype(jnp.float32)

    x = smoke_crops()[1:2]
    with torch.no_grad():
        port32 = engine.apply(torch.from_numpy(x)).numpy()
        port8 = wrap_apply(engine.apply, "int8", engine.params,
                           engine.call)(torch.from_numpy(x)).numpy()
    jax32 = np.asarray(jax.jit(jax_apply)(params, x))
    jax8 = np.asarray(jax.jit(jax_precision.wrap_apply(jax_apply, "int8"))(
        params, x))
    port_gap, jax_gap = np.abs(port8 - port32), np.abs(jax8 - jax32)
    print(leg, "port", port_gap.max(), port_gap.mean(), "jax", jax_gap.max(),
          jax_gap.mean())
    assert abs(port_gap.mean() - jax_gap.mean()) <= 0.02 * jax_gap.mean()
    assert port_gap.max() <= 1.25 * jax_gap.max()
    if leg == "real":
        assert jax_gap.max() > MAX_ABS_ERR["int8"]
        assert jax_gap.mean() > MEAN_ERR["int8"]


# (lhs shape, rhs shape, port kwargs, JAX params): grouped, strided and
# dilated convolutions and "same" padding with an even kernel, as a user
# model may have them
GENERAL_CONVS = {
    "groups2": ((2, 4, 6, 7), (6, 2, 3, 3), dict(padding=1, groups=2),
                dict(padding=[(1, 1), (1, 1)], feature_group_count=2)),
    "stride2_dilation2": ((2, 3, 11, 12), (5, 3, 3, 3),
                          dict(stride=2, padding=1, dilation=2),
                          dict(window_strides=(2, 2), padding=[(1, 1),
                               (1, 1)], rhs_dilation=(2, 2))),
    "same_even": ((2, 3, 7, 8), (4, 3, 2, 4), dict(padding="same"),
                  dict(padding="SAME")),
}


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("name", list(GENERAL_CONVS))
def test_general_conv_is_the_jax_arithmetic(name, integer):
    xs, ws, kwargs, jax_kwargs = GENERAL_CONVS[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.2).astype(np.float32)
    params = dict(window_strides=(1, 1), lhs_dilation=(1, 1),
                  rhs_dilation=(1, 1), feature_group_count=1,
                  batch_group_count=1,
                  dimension_numbers=lax.conv_dimension_numbers(
                      xs, ws, ("NCHW", "OIHW", "NCHW")))
    params.update(jax_kwargs)
    ref = np.asarray(jax_precision._int8_conv(params, x, w, True, integer))
    got = precision._int8_conv(torch.from_numpy(x), torch.from_numpy(w),
                               True, integer, **kwargs)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("integer", [True, False])
def test_batched_matmul_is_the_jax_arithmetic(integer):
    """``[B, M, K] @ [B, K, N]`` under the mode: batch dims, so both
    operands quantize per tensor, as ``_int8_dot`` rules."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((3, 5, 8)).astype(np.float32)
    b = rng.standard_normal((3, 8, 4)).astype(np.float32)
    params = {"dimension_numbers": (((2,), (1,)), ((0,), (0,)))}
    ref = np.asarray(jax_precision._int8_dot(params, a, b, True, False,
                                             integer))
    with Int8Mode(integer) as mode:
        got = mode.mark(torch.from_numpy(a)) @ torch.from_numpy(b)
    assert np.array_equal(got.numpy(), ref)
    with Int8Mode(integer) as mode, pytest.raises(NotImplementedError):
        torch.nn.functional.conv_transpose2d(
            mode.mark(torch.rand(1, 2, 4, 4)), torch.rand(2, 3, 3, 3),
            stride=2)
