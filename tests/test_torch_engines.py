"""The port's convnet engines end to end against the JAX package, on the CPU.

The same chunk and the same weight FILES go through the JAX
``Inferencer`` and the port's ``Inferencer(device="cpu")``: a reference
``model.py`` with a BatchNorm ``.pt`` checkpoint into the full-width
RSUNet mirror, flax ``.msgpack`` params into the full-width ``tpu``
flagship, a user ``create_model`` file, and a ``universal`` engine file.
Gates: float32 compute within 1e-5 (uint8 output: 1 LSB); bfloat16
compute within 0.02, the JAX package's bf16 gate (uint8 output: that gate
on the 255 scale, 5.1, plus the 1 LSB of the truncating cast).

Measured, rsunet / tpu: float32 1.2e-7 / 1.5e-6, uint8 1 / 0 LSB;
bfloat16 0.0038 / 0.0137, uint8 1 / 3 LSB.
"""
import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.inference.inferencer import Inferencer as JaxInferencer
from chunkflow_tpu.models import unet3d as flax_unet3d
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from tests.test_torch_models import (
    FEATS,
    DOWNS,
    draw_params,
    reference_model,
)

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (4, 16, 16)
OVERLAP = (2, 8, 8)
COMMON = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
              num_output_channels=3, batch_size=2)
TOL = {("float32", "float32"): 1e-5, ("float32", "uint8"): 1,
       ("bfloat16", "float32"): 0.02, ("bfloat16", "uint8"): 6.1}


def _chunk(shape=(8, 32, 32), seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _both(arr, **kwargs):
    """(JAX result, port result) as float64 host arrays of one dtype."""
    ref = np.asarray(JaxInferencer(**kwargs)(JaxChunk(arr)).array)
    got = Inferencer(device="cpu", **kwargs)(Chunk(arr)).host().array
    assert got.dtype == ref.dtype and got.shape == ref.shape
    return ref.astype(np.float64), got.astype(np.float64)


@pytest.fixture(scope="module")
def rsunet_files(tmp_path_factory):
    """A reference model.py (full-width RSUNet, scrambled definition
    order, BatchNorm statistics) and its wrapped .pt checkpoint."""
    tmp = tmp_path_factory.mktemp("rsunet")
    model_py, model = reference_model(tmp, seed=1)
    ckpt = tmp / "model.chkpt.pt"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    return model_py, str(ckpt)


@pytest.fixture(scope="module")
def tpu_msgpack(tmp_path_factory):
    """Full-width ``tpu`` flagship params drawn from a seed, saved as the
    JAX package saves them."""
    fnet = flax_unet3d.create_tpu_optimized_model(1, 3)
    path = tmp_path_factory.mktemp("tpu") / "tpu.msgpack"
    return flax_unet3d.save_params(draw_params(fnet, PIN, seed=2), str(path))


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_rsunet_matches_jax(rsunet_files, dtype, output_dtype):
    """The user's migration path: ``-f pytorch -m model.py -w model.pt
    --model-variant rsunet``."""
    model_py, ckpt = rsunet_files
    ref, got = _both(_chunk(seed=3), framework="pytorch", model_path=model_py,
                     weight_path=ckpt, model_variant="rsunet", dtype=dtype,
                     output_dtype=output_dtype, **COMMON)
    assert ref.std() > 1e-3 * (255 if output_dtype == "uint8" else 1)
    assert np.abs(got - ref).max() <= TOL[dtype, output_dtype]


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msgpack_tpu_matches_jax(tpu_msgpack, dtype, output_dtype):
    ref, got = _both(_chunk(seed=4), framework="flax",
                     weight_path=tpu_msgpack, model_variant="tpu",
                     dtype=dtype, output_dtype=output_dtype, **COMMON)
    assert ref.std() > 1e-3 * (255 if output_dtype == "uint8" else 1)
    assert np.abs(got - ref).max() <= TOL[dtype, output_dtype]


def test_create_model_file_matches_jax(tmp_path):
    """``create_model(ci, co)``: a flax module in the JAX package, an
    ``nn.Module`` in the port; the same .msgpack weights load into
    both."""
    make = ("def create_model(ci, co):\n"
            "    return UNet3D(ci, co, feature_maps={}, down_factors={})\n"
            .format(FEATS, DOWNS))
    jax_py, port_py = tmp_path / "jax_model.py", tmp_path / "port_model.py"
    jax_py.write_text("from chunkflow_tpu.models.unet3d import UNet3D\n"
                      + make)
    port_py.write_text(
        "from chunkflow_tpu_torch.models.unet3d import UNet3D\n" + make)
    fnet = flax_unet3d.UNet3D(1, 3, feature_maps=FEATS, down_factors=DOWNS)
    weights = flax_unet3d.save_params(draw_params(fnet, PIN, seed=5),
                                      str(tmp_path / "w.msgpack"))
    arr = _chunk(seed=6)
    ref = np.asarray(JaxInferencer(framework="flax", model_path=str(jax_py),
                                   weight_path=weights, **COMMON)(
        JaxChunk(arr)).array)
    port = Inferencer(device="cpu", framework="flax",
                      model_path=str(port_py), weight_path=weights, **COMMON)
    assert port.engine.model.feature_maps == FEATS
    got = port(Chunk(arr)).host().array
    assert np.abs(got - ref).max() <= 1e-5


UNIVERSAL_JAX = """
import jax.numpy as jnp


def create_engine(weight_path, pin, pout, ci, co):
    margin = [(i - o) // 2 for i, o in zip(pin, pout)]
    window = tuple(slice(m, m + o) for m, o in zip(margin, pout))

    def apply(params, batch):
        center = batch[(slice(None), slice(0, 1)) + window] * params["scale"]
        return jnp.broadcast_to(center, (batch.shape[0], co) + tuple(pout))

    return {"scale": jnp.float32(0.5)}, apply
"""

UNIVERSAL_PORT = """
import torch


class Scale(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(0.5))


def create_engine(weight_path, pin, pout, ci, co):
    margin = [(i - o) // 2 for i, o in zip(pin, pout)]
    window = tuple(slice(m, m + o) for m, o in zip(margin, pout))

    def apply(params, batch):
        center = batch[(slice(None), slice(0, 1)) + window] * params.scale
        return center.expand((batch.shape[0], co) + tuple(pout))

    return Scale(), apply
"""


def test_universal_engine_is_bitwise_jax(tmp_path):
    """A user engine file's ``(params, apply)``; a module as ``params`` is
    the engine's model. Crop times 0.5 is exact, so the whole path is
    bitwise (the identity engine's guarantee)."""
    (tmp_path / "jax_engine.py").write_text(UNIVERSAL_JAX)
    (tmp_path / "port_engine.py").write_text(UNIVERSAL_PORT)
    arr = np.random.default_rng(7).random((9, 35, 33)).astype(np.float32)
    ref = JaxInferencer(framework="universal",
                        model_path=str(tmp_path / "jax_engine.py"), **COMMON)(
        JaxChunk(arr))
    port = Inferencer(device="cpu", framework="universal",
                      model_path=str(tmp_path / "port_engine.py"), **COMMON)
    assert isinstance(port.engine.model, torch.nn.Module)
    got = port(Chunk(arr)).host().array
    assert np.array_equal(got, np.asarray(ref.array))


# ---------------------------------------------------------------------------
# the port alone: every variant and dtype, the CLI, errors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(engines.MODEL_VARIANTS))
def test_every_variant_runs_in_the_inferencer(variant, dtype):
    """Full widths, seeded weights: sigmoid maps of the chunk's shape."""
    inferencer = Inferencer(device="cpu", framework="pytorch",
                            model_variant=variant, dtype=dtype,
                            input_patch_size=(4, 32, 32),
                            output_patch_overlap=(2, 16, 16),
                            num_output_channels=3, batch_size=2)
    assert inferencer.engine.model.dtype == getattr(torch, dtype)
    out = inferencer(Chunk(_chunk((6, 48, 48), seed=8))).host().array
    assert out.dtype == np.float32 and out.shape == (3, 6, 48, 48)
    assert np.isfinite(out).all() and 0 <= out.min() and out.max() <= 1
    assert out.std() > 1e-4


def test_tpu_mxu_is_the_tpu_module():
    """``tpu_mxu`` is the ``tpu`` UNet3D with ``conv_impl="mxu"`` (the JAX
    package's ``MxuConv`` / ``MxuConvTranspose`` layers): the same
    parameter names and the same seeded weights, so checkpoints
    interchange."""
    tpu = engines.create_engine("pytorch", model_variant="tpu").model
    mxu = engines.create_engine("pytorch", model_variant="tpu_mxu").model
    assert type(tpu) is type(mxu) and tpu.s2d_factor == mxu.s2d_factor
    assert (tpu.conv_impl, mxu.conv_impl) == ("native", "mxu")
    for (k, a), (j, b) in zip(tpu.state_dict().items(),
                              mxu.state_dict().items()):
        assert k == j and torch.equal(a, b)


def test_cli_runs_a_reference_checkpoint(tmp_path, rsunet_files):
    """The README's command for a user's RSUNet checkpoint, on the CPU,
    equals the library path."""
    model_py, ckpt = rsunet_files
    out_npy = tmp_path / "out.npy"
    arr = _chunk(seed=9)
    np.save(tmp_path / "in.npy", arr)
    rc = cli.main([
        "--device", "cpu", "load-npy", "-f", str(tmp_path / "in.npy"),
        "inference", "-f", "pytorch", "-m", model_py, "-w", ckpt,
        "--model-variant", "rsunet", "-d", "bfloat16",
        "-p", *map(str, PIN), "-v", *map(str, OVERLAP), "-c", "3", "-b", "2",
        "save-npy", "-f", str(out_npy),
    ])
    assert rc == 0
    expected = Inferencer(device="cpu", framework="pytorch",
                          model_path=model_py, weight_path=ckpt,
                          model_variant="rsunet", dtype="bfloat16",
                          **COMMON)(Chunk(arr)).host().array
    assert np.array_equal(np.load(out_npy), expected)


def test_load_model_contract(tmp_path, rsunet_files):
    """A model.py with ``load_model(weight_path)`` is honored over
    ``InstantiatedModel``."""
    model_py, ckpt = rsunet_files
    source = open(model_py).read() + (
        "\n\ndef load_model(weight_path):\n"
        "    model = RSUNet()\n"
        "    model.load_state_dict(torch.load(weight_path)['state_dict'])\n"
        "    return model\n"
        "\n\nInstantiatedModel = None\n")
    custom = tmp_path / "custom.py"
    custom.write_text(source)
    a = engines.create_engine("pytorch", model_path=str(custom),
                              weight_path=ckpt, model_variant="rsunet").model
    b = engines.create_engine("pytorch", model_path=model_py,
                              weight_path=ckpt, model_variant="rsunet").model
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_engine_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="weights not found"):
        engines.create_engine("pytorch", weight_path=str(tmp_path / "w.pt"))
    with pytest.raises(FileNotFoundError, match="model file not found"):
        engines.create_engine("pytorch", model_path=str(tmp_path / "m.py"))
    (tmp_path / "w.h5").write_bytes(b"")
    with pytest.raises(ValueError, match="msgpack"):
        engines.create_engine("pytorch", weight_path=str(tmp_path / "w.h5"))
    with pytest.raises(ValueError, match="model_variant"):
        engines.create_engine("pytorch", model_variant="unet2d")
    with pytest.raises(ValueError, match="compute dtype"):
        engines.create_engine("pytorch", dtype="float16")
    (tmp_path / "empty.py").write_text("x = 1\n")
    with pytest.raises(ValueError, match="InstantiatedModel"):
        engines.create_engine("pytorch", model_path=str(tmp_path / "empty.py"))


@pytest.mark.parametrize("variant", list(engines.MODEL_VARIANTS))
def test_orbax_directory_raises_naming_its_roadmap_item(variant, tmp_path):
    """An orbax directory the JAX package saves loads into every
    variant's inferencer, bitwise the JAX restore; one the JAX restore
    refuses (an OCDBT save whose root manifest was never merged) raises
    its ``ValueError``."""
    from tests.test_torch_models import draw_params
    from tests.test_torch_orbax import (
        assert_same_state,
        jax_model,
        jax_state,
        save,
        unmerged,
    )

    family = "tpu" if variant == "tpu_mxu" else variant
    path = save(tmp_path / "ck", draw_params(jax_model(family), PIN,
                                             seed=4))
    inferencer = Inferencer(device="cpu", framework="flax",
                            model_variant=variant, weight_path=path,
                            **COMMON)
    assert_same_state(inferencer.engine.model.state_dict(),
                      jax_state(family, path))
    split = unmerged(tmp_path / "split")
    with pytest.raises(ValueError):
        jax_state(family, split)
    with pytest.raises(ValueError, match="manifest.ocdbt"):
        Inferencer(device="cpu", framework="flax", model_variant=variant,
                   weight_path=split, **COMMON)

