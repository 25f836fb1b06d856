"""The port's convnet families and converters against the JAX package.

One set of flax params, drawn with numpy from a seed, runs in both
packages through ``state_from_flax``, for every family the convnet
engine serves: the parity UNet3D, RSUNet, and the space-to-depth ``tpu``
/ ``tpu_mxu`` / ``tpu_s2d4`` flagship, at narrow widths. The forward is
not bitwise (XLA and oneDNN sum convolutions in other orders, and bf16
rounds at other places); the gates are max-abs <= 1e-5 in float32 and
<= 0.02 in bfloat16 (the JAX package's own bf16 gate,
``tests/inference/test_precision.py``).

Measured max-abs on the fixtures of ``test_family_matches_flax``,
float32 / bfloat16: parity 8.3e-7 / 3e-8, rsunet 6e-8 / 0.0039,
rsunet_mxu 1.2e-7 / 0.0078, tpu 7.2e-7 / 3e-5, tpu_mxu 8.9e-7 / 0.013,
tpu_s2d4 1.1e-6 / 6e-8, s2d (2,1,4) 6.6e-7 / 6e-8. The mxu rows are the
largest in bfloat16 because JAX's ``MxuConv`` sums in float32 and rounds
once after its bias, where flax's native convolution, and the port's,
round before the bias add.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import chip_smoke
from chunkflow_tpu.models import rsunet as flax_rsunet
from chunkflow_tpu.models import unet3d as flax_unet3d
from chunkflow_tpu.models.converter import torch_to_flax, torch_to_flax_by_name
from chunkflow_tpu.models.migrate import load_torch_module
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.models import flax_msgpack, reference_rsunet
from chunkflow_tpu_torch.models.convert import (
    NameConversionError,
    init_or_load_weights,
    state_from_flax,
    state_from_torch_by_name,
    state_from_torch_positional,
)
from chunkflow_tpu_torch.models.rsunet import RSUNet
from chunkflow_tpu_torch.models.unet3d import (
    UNet3D,
    depth_to_space,
    seeded_init,
    space_to_depth,
)

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

FEATS = (4, 6, 8)
DOWNS = ((1, 2, 2), (2, 2, 2))
TOL = {"float32": 1e-5, "bfloat16": 0.02}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def draw_params(fnet, pin, cin=1, seed=0):
    """Params for the flax model ``fnet`` drawn with numpy from ``seed``
    (the tree's shapes come from tracing flax's init, not running it):
    kernels ~ N(0, 1/fan_in), biases and norm offsets ~ N(0, 0.1),
    scales ~ 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(
        lambda: flax_unet3d.init_params(fnet, pin, cin))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return (x / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return x * 0.1 + (1.0 if name == "scale" else 0.0)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def flax_forward(fnet, params, x):
    """``[B, C, z, y, x]`` numpy through the flax model, float32 out."""
    y = fnet.apply({"params": params}, jnp.asarray(np.moveaxis(x, 1, -1)))
    return np.moveaxis(np.asarray(y.astype(jnp.float32)), -1, 1)


# family -> (flax model, port model, input patch) at narrow widths
def _pair(family, dtype, cin=1, cout=3):
    jdt, tdt = JNP[dtype], getattr(torch, dtype)
    if family.startswith("rsunet"):
        impl = "mxu" if family == "rsunet_mxu" else "native"
        return (flax_rsunet.RSUNet(cin, cout, width=FEATS, down_factors=DOWNS,
                                   dtype=jdt, conv_impl=impl),
                RSUNet(cin, cout, width=FEATS, down_factors=DOWNS,
                       dtype=tdt),
                (4, 16, 16))
    s2d, pin = {"parity": (None, (4, 16, 16)),
                "tpu": ((1, 2, 2), (4, 16, 16)),
                "tpu_mxu": ((1, 2, 2), (4, 16, 16)),
                "tpu_s2d4": ((1, 4, 4), (4, 32, 32)),
                "tpu_s2d_asym": ((2, 1, 4), (8, 16, 32))}[family]
    impl = "mxu" if family == "tpu_mxu" else "native"
    return (flax_unet3d.UNet3D(cin, cout, feature_maps=FEATS,
                               down_factors=DOWNS, dtype=jdt,
                               s2d_factor=s2d, conv_impl=impl),
            UNet3D(cin, cout, feature_maps=FEATS, down_factors=DOWNS,
                   dtype=tdt, s2d_factor=s2d),
            pin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["parity", "rsunet", "rsunet_mxu", "tpu",
                                    "tpu_mxu", "tpu_s2d4", "tpu_s2d_asym"])
def test_family_matches_flax(family, dtype):
    """``*_mxu``: JAX's ``conv_impl="mxu"`` lowering against the port's
    one module; ``tpu_s2d_asym``: an s2d factor different on every axis,
    so a channel order that swapped two of (fz, fy, fx, c) would show."""
    fnet, tnet, pin = _pair(family, dtype)
    params = draw_params(fnet, pin, seed=3)
    tnet.load_state_dict(state_from_flax(numpy_tree(params)))
    x = np.random.default_rng(4).random((2, 1) + pin, dtype=np.float32)
    ref = flax_forward(fnet, params, x)
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= TOL[dtype]


def bf16_gaps(variant, params, state, x):
    """{package: (max-abs, mean-abs)} of bfloat16 vs float32 at full width,
    the port's model of ``variant`` holding ``state`` and the JAX
    engine's holding the flax ``params``, on ``x``.

    RSUNet takes its sigmoid in the compute dtype. XLA's bfloat16 logistic
    on the CPU is not correctly rounded (it errs by more than half a bf16
    step); torch's, the port's, is. So the JAX side's RSUNet sigmoid is
    torch's, taken in the compute dtype on flax's pre-activation: what is
    compared is the network, not two logistics."""
    gaps = {}
    for package in ("port", "jax"):
        out = {}
        for dtype in ("float32", "bfloat16"):
            if package == "port":
                model = engines.build_model(variant, dtype=dtype).eval()
                model.load_state_dict(state)
                with torch.no_grad():
                    out[dtype] = model(torch.from_numpy(x)).numpy()
            elif variant == "rsunet":
                pre = flax_forward(flax_rsunet.RSUNet(
                    1, 3, dtype=JNP[dtype], final_activation="none"), params, x)
                out[dtype] = torch.sigmoid(torch.tensor(pre).to(
                    getattr(torch, dtype))).float().numpy()
            else:
                out[dtype] = flax_forward(
                    _flax_full_width(variant, JNP[dtype]), params, x)
        diff = np.abs(out["bfloat16"] - out["float32"])
        gaps[package] = (float(diff.max()), float(diff.mean()))
    return gaps


@pytest.mark.parametrize("variant", ["parity", "rsunet", "tpu", "tpu_s2d4"])
def test_bf16_gap_is_the_jax_packages(variant):
    """bfloat16 vs float32 at full width on one 8x64x64 patch: the port's
    gap is the JAX package's own on the same weights, so what bf16 costs
    is the compute dtype's, not the port's (and a model that ignored its
    dtype would show no gap). Measured max-abs / mean-abs, port vs JAX:
    parity 0.0160 / 0.00221 vs 0.0169 / 0.00222; rsunet 0.0069 / 0.00114
    vs 0.0068 / 0.00114; tpu 0.0152 / 0.00204 vs 0.0159 / 0.00204;
    tpu_s2d4 0.0162 / 0.00192 vs 0.0164 / 0.00191 (printed with ``-s``)."""
    x = np.random.default_rng(11).random((1, 1, 8, 64, 64), dtype=np.float32)
    params = draw_params(_flax_full_width(variant), (4, 32, 32), seed=12)
    gaps = bf16_gaps(variant, params, state_from_flax(numpy_tree(params)), x)
    print(variant, gaps)
    (port_max, port_mean), (jax_max, jax_mean) = gaps["port"], gaps["jax"]
    assert port_max <= TOL["bfloat16"] and port_max <= 1.25 * jax_max
    assert abs(port_mean - jax_mean) <= 0.05 * jax_mean


def smoke_crops():
    """``chip_smoke.py``'s bf16 crops of its main-path chunk,
    ``Chunk.create(CHUNK, uint8, "sin")``, as the gather hands them to
    the model: [N, 1, z, y, x] float32, uint8 x 1/255. The values are the
    ``sin`` pattern's, computed over each window alone."""
    axes = [np.linspace(0, 4 * np.pi, s) for s in chip_smoke.CHUNK]
    crops = []
    for start in chip_smoke.BF16_CROPS:
        z, y, x = np.meshgrid(*[a[s:s + n] for a, s, n in
                                zip(axes, start, chip_smoke.CROP)],
                              indexing="ij")
        arr = (np.sin(z) * np.sin(y) * np.sin(x) + 1.0) / 2.0
        crops.append((arr * 255).astype(np.uint8))
    return (np.stack(crops)[:, None].astype(np.float32)
            * np.float32(1 / 255))


@pytest.mark.parametrize("variant", ["parity", "rsunet", "tpu", "tpu_s2d4"])
def test_bf16_gap_on_the_smoke_chunk(tmp_path, variant):
    """bfloat16 vs float32 with ``chip_smoke.py``'s phase 7 weights (the
    engine's seeded init; RSUNet's reference ``model.py`` seeded and
    migrated as there) on four 8x64x64 crops of its chunk (393 K
    outputs): the port's gap is again the JAX package's own. Measured
    max-abs / mean-abs, port vs JAX (printed with ``-s``): parity 0.0227
    / 0.00261 vs 0.0237 / 0.00262; rsunet 0.0087 / 0.00118 vs 0.0090 /
    0.00118; tpu 0.0192 / 0.00245 vs 0.0218 / 0.00246; tpu_s2d4 0.0156 /
    0.00198 vs 0.0154 / 0.00198. The JAX package's own max passes its
    0.02 gate here for rsunet and tpu_s2d4 only."""
    if variant == "rsunet":
        model_py = tmp_path / "model.py"
        model_py.write_text(reference_rsunet.model_py())
        ref = load_torch_module(str(model_py)).InstantiatedModel
        gen = torch.Generator().manual_seed(0)
        reference_rsunet.seed_batchnorm(seeded_init(ref, gen), gen)
        source = ref.state_dict()
        state = state_from_torch_by_name(source, RSUNet().state_dict())
    else:
        state = engines.create_engine(
            "pytorch", model_variant=variant).model.state_dict()
        source = state
    template = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype),
        jax.eval_shape(lambda: flax_unet3d.init_params(
            _flax_full_width(variant), (4, 32, 32), 1)))
    params = torch_to_flax_by_name(
        {k: v.numpy() for k, v in source.items()}, template)
    gaps = bf16_gaps(variant, params, state, smoke_crops())
    print(variant, gaps)
    (port_max, port_mean), (jax_max, jax_mean) = gaps["port"], gaps["jax"]
    assert port_max <= 1.25 * jax_max
    assert abs(port_mean - jax_mean) <= 0.05 * jax_mean


@pytest.mark.parametrize("factor", [(1, 2, 2), (1, 4, 4), (2, 1, 4),
                                    (3, 2, 1)])
def test_space_to_depth_is_flax_channel_order(factor):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 6, 8, 8)).astype(np.float32)
    ref = np.asarray(flax_unet3d.space_to_depth(
        jnp.asarray(np.moveaxis(x, 1, -1)), factor))
    got = space_to_depth(torch.from_numpy(x), factor)
    assert np.array_equal(got.numpy(), np.moveaxis(ref, -1, 1))
    back = np.asarray(flax_unet3d.depth_to_space(jnp.asarray(ref), factor))
    assert np.array_equal(depth_to_space(got, factor).numpy(), x)
    assert np.array_equal(np.moveaxis(back, -1, 1), x)


def _flax_full_width(variant, dtype=jnp.float32):
    """The JAX engine's model for ``variant`` (engines.py:113-138)."""
    if variant == "rsunet":
        return flax_rsunet.RSUNet(1, 3, dtype=dtype)
    if variant == "parity":
        return flax_unet3d.UNet3D(1, 3, dtype=dtype)
    return flax_unet3d.create_tpu_optimized_model(
        1, 3, dtype=dtype,
        conv_impl="mxu" if variant == "tpu_mxu" else "native",
        s2d_factor=(1, 4, 4) if variant == "tpu_s2d4" else (1, 2, 2))


@pytest.mark.parametrize("variant", list(engines.MODEL_VARIANTS))
def test_full_width_params_convert_strictly(variant):
    """At the full widths every flax leaf of the JAX engine's model lands
    on a parameter of the same shape in the port's model of the variant,
    and nothing is left."""
    pin = (4, 32, 32)
    params = draw_params(_flax_full_width(variant), pin)
    state = state_from_flax(numpy_tree(params))
    model = engines.build_model(variant)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # strict
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(v.size for v in jax.tree_util.tree_leaves(params))
    if variant.startswith("tpu"):
        assert model.feature_maps[0] == (112 if variant == "tpu_s2d4"
                                         else 56)


# ---------------------------------------------------------------------------
# reference checkpoints: BatchNorm fold, positional fallback, strictness
# ---------------------------------------------------------------------------
# the reference contract's pre/post-processing hooks, which a user's
# model.py may define and the engines ignore, as the JAX package does
HOOKS = """

def pre_process(input_patch):
    return torch.from_numpy(input_patch)


def post_process(net_output):
    return net_output
"""


def reference_model(tmp_path, width=(28, 36, 48, 64), seed=0):
    """(model.py path, its InstantiatedModel in eval mode): a reference
    user's RSUNet file (``models/reference_rsunet.py``) with the hooks,
    its BatchNorm statistics and affine parameters drawn from ``seed``."""
    model_py = tmp_path / "model.py"
    model_py.write_text(reference_rsunet.model_py(width) + HOOKS)
    model = load_torch_module(str(model_py)).InstantiatedModel
    reference_rsunet.seed_batchnorm(model, torch.Generator().manual_seed(seed))
    return str(model_py), model.eval()


def test_batchnorm_fold_is_bitwise_the_jax_converters(tmp_path):
    """The scrambled-order reference checkpoint, by name: the port's
    folded parameters are bitwise ``torch_to_flax_by_name``'s (read back
    through ``state_from_flax``, which only transposes and flips)."""
    _, model = reference_model(tmp_path)
    state = model.state_dict()
    port = state_from_torch_by_name(state, RSUNet().state_dict())
    template = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype),
        jax.eval_shape(lambda: flax_unet3d.init_params(
            flax_rsunet.RSUNet(1, 3), (4, 32, 32), 1)))
    ref = state_from_flax(numpy_tree(torch_to_flax_by_name(state, template)))
    assert set(port) == set(ref) == set(RSUNet().state_dict())
    for key in ref:
        assert port[key].dtype == torch.float32
        assert torch.equal(port[key], ref[key]), key
    # the fold is real: bn scales differ from the BatchNorm gammas
    assert not torch.equal(port["enc0.bn1.weight"], state["enc0.bn1.weight"])


def test_folded_rsunet_matches_the_reference_model(tmp_path):
    _, model = reference_model(tmp_path, width=FEATS + (10,))
    port = RSUNet(width=FEATS + (10,)).eval()
    port.load_state_dict(state_from_torch_by_name(model.state_dict(),
                                                  port.state_dict()))
    x = torch.from_numpy(np.random.default_rng(6).random(
        (2, 1, 8, 32, 32), dtype=np.float32))
    with torch.no_grad():
        ref, got = model(x), port(x)
    assert ref.std() > 1e-3
    assert (got - ref).abs().max() <= 1e-5


def _renamed(state):
    """The parity UNet3D's state under names that share nothing with it,
    in its own (execution) order."""
    return {f"layer{i:03d}.{k.rsplit('.', 1)[1]}": v
            for i, (k, v) in enumerate(state.items())}


def test_positional_fallback_matches_jax(tmp_path):
    """Disjoint names: ``init_or_load_weights`` falls back to positional
    pairing, bitwise what ``torch_to_flax`` gives."""
    src = seeded_init(UNet3D(feature_maps=FEATS, down_factors=DOWNS),
                      torch.Generator().manual_seed(7))
    state = _renamed(src.state_dict())
    path = tmp_path / "renamed.pt"
    torch.save({"state_dict": state}, path)
    got = init_or_load_weights(UNet3D(feature_maps=FEATS, down_factors=DOWNS),
                               str(path))
    # a real init: its dict keeps flax's creation (execution) order, which
    # positional pairing follows (eval_shape's tree would sort the keys)
    template = flax_unet3d.init_params(
        flax_unet3d.UNet3D(1, 3, feature_maps=FEATS, down_factors=DOWNS),
        (4, 16, 16), 1)
    ref = state_from_flax(numpy_tree(torch_to_flax(
        {k: v.numpy() for k, v in state.items()}, template)))
    for key, value in got.state_dict().items():
        assert torch.equal(value, ref[key]), key
        assert torch.equal(value, src.state_dict()[key]), key


def test_positional_fallback_rejects_a_mismatch():
    model = UNet3D(feature_maps=FEATS, down_factors=DOWNS)
    state = _renamed(model.state_dict())
    state.pop(next(iter(state)))  # one kernel fewer
    with pytest.raises(ValueError, match="do not mirror"):
        state_from_torch_positional(state, model.state_dict())


def test_by_name_is_strict(tmp_path):
    """A leftover raises; a partial name match is not handed to the
    positional fallback (it could pair same-shape tensors wrongly)."""
    model = RSUNet(width=FEATS, down_factors=DOWNS)
    state = dict(model.state_dict())
    with pytest.raises(ValueError, match="not consumed"):
        state_from_torch_by_name(dict(state, extra=torch.zeros(3)),
                                 model.state_dict())
    partial = {k.replace("embed.", "input_conv."): v
               for k, v in state.items()}
    with pytest.raises(NameConversionError) as err:
        state_from_torch_by_name(partial, model.state_dict())
    assert err.value.matched == len(state) - 2
    path = tmp_path / "partial.pt"
    torch.save(partial, path)
    with pytest.raises(NameConversionError):
        init_or_load_weights(model, str(path))
    bad = dict(state, **{"out.weight": torch.zeros(3, 4, 1, 1, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        state_from_torch_by_name(bad, model.state_dict())


# ---------------------------------------------------------------------------
# the .msgpack reader
# ---------------------------------------------------------------------------
def _assert_same_tree(got, ref):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref)
        for key in ref:
            _assert_same_tree(got[key], ref[key])
    elif isinstance(ref, np.ndarray):
        if ref.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  ref.view(np.int16))
        else:
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
    else:
        assert type(got) is type(ref) and got == ref


def test_msgpack_reads_flax_params():
    fnet, _, pin = _pair("tpu", "float32")
    params = numpy_tree(draw_params(fnet, pin))
    data = serialization.to_bytes(params)
    _assert_same_tree(flax_msgpack.loads(data),
                      serialization.msgpack_restore(data))


def test_msgpack_reads_chunked_arrays(monkeypatch):
    """Arrays above flax's chunk size are cut into flat parts (lowered
    here to 64 bytes so that every leaf of a small tree is cut)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    fnet, _, pin = _pair("rsunet", "float32")
    params = numpy_tree(draw_params(fnet, pin))
    data = serialization.to_bytes(params)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(flax_msgpack.loads(data), numpy_tree(params))


def test_msgpack_types():
    """Every msgpack width of ints, str, bin and containers, floats,
    booleans, nil, and arrays of several dtypes (bfloat16 included)."""
    rng = np.random.default_rng(8)
    tree = {
        "ints": {str(v): v for v in (0, 1, 127, 128, 255, 256, 65535, 65536,
                                     2**32, -1, -32, -33, -128, -129,
                                     -32768, -32769, -2**31 - 1)},
        "floats": {"a": 0.5, "b": -1e300},
        "flags": {"t": True, "f": False, "none": None},
        "str": {"short": "x" * 31, "s8": "y" * 200, "s16": "z" * 70_000},
        "bin": {"b8": b"\x01" * 10, "b16": b"\x02" * 300},
        "list": [1, [2, "three"], {"four": 4}],
        "big_map": {f"k{i}": i for i in range(20)},
        "arrays": {
            "f32": rng.standard_normal((3, 4)).astype(np.float32),
            "f64": rng.standard_normal(5),
            "i32": np.arange(-3, 3, dtype=np.int32),
            "u8": np.arange(7, dtype=np.uint8).reshape(7, 1, 1),
            "bf16": rng.standard_normal((2, 3)).astype(jnp.bfloat16),
            "scalar": np.array(2.5, np.float32),
        },
    }
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(flax_msgpack.loads(data),
                      serialization.msgpack_restore(data))
    with pytest.raises(ValueError, match="bytes after"):
        flax_msgpack.loads(data + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(data[:-3])


@pytest.mark.parametrize("family", ["parity", "rsunet", "tpu_s2d4"])
def test_msgpack_weights_load_into_the_engine(tmp_path, family):
    """Params saved by the JAX package (``unet3d.save_params``) load into
    the port's model and compute the flax forward."""
    fnet, tnet, pin = _pair(family, "float32")
    params = draw_params(fnet, pin, seed=9)
    path = flax_unet3d.save_params(params, str(tmp_path / "w.msgpack"))
    init_or_load_weights(tnet, path)
    x = np.random.default_rng(10).random((1, 1) + pin, dtype=np.float32)
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - flax_forward(fnet, params, x)).max() <= 1e-5
