"""The plain reference against the program's CPU path, at small sizes:
the forwards with the same seeded weights, and the blend through the
identity engine."""
import json

import numpy as np
import pytest
import torch

import modelfile
import weights
from reference import blend, models
from tiny import BENCH


def config(name, **overrides):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(input_patch=[8, 64, 64], **overrides)
    return cfg


def program_model(cfg, directory):
    """The program's model as the benchmark hands it over: built by the
    model file's ``create_model``."""
    from chunkflow_tpu_torch.models.migrate import load_user_module

    path = modelfile.write(cfg, str(directory))
    return load_user_module(path).create_model(cfg["in_channels"],
                                               cfg["out_channels"])


@pytest.mark.parametrize("name", ["rsunet-bf16", "tpu_s2d4-bf16"])
def test_parameter_names_are_the_programs(name, tmp_path):
    cfg = config(name)
    model = program_model(cfg, tmp_path)
    spec = models.param_spec(cfg)
    assert [(n, tuple(s)) for n, s, _ in spec] == [
        (n, tuple(t.shape)) for n, t in model.state_dict().items()]
    assert sum(int(np.prod(s)) for _, s, _ in spec) == cfg["parameters"]


@pytest.mark.parametrize("dtype,tolerance", [("float32", 1e-4),
                                             ("bfloat16", 0.0)])
@pytest.mark.parametrize("name", ["rsunet-bf16", "tpu_s2d4-bf16"])
def test_forward_matches_the_program(name, dtype, tolerance, tmp_path):
    """float32: the same function to rounding. bfloat16: RSUNet rounds
    where the program rounds, bit for bit on the CPU; the U-Net's
    instance norm is the reference's own formula, whose last-bit changes
    the random net amplifies: held to a mean gap, the JAX package's
    bfloat16 gate of 0.005."""
    cfg = config(name, compute_dtype=dtype)
    params = weights.make(cfg, 2**31 + 5, "cpu")
    model = program_model(cfg, tmp_path)
    model.load_state_dict(params)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((2, 1, 8, 64, 64), generator=gen)
    with torch.no_grad():
        got = model(x).float()
        ref = models.forward(cfg, params, x)
    gap = (got - ref).abs()
    assert ref.std() > 0.1  # outputs spread over (0, 1), not saturated
    if cfg["family"] == "unet3d" and dtype == "bfloat16":
        assert gap.mean() <= 0.005
    else:
        assert gap.max() <= tolerance


@pytest.mark.parametrize("shape", [(16, 128, 128), (9, 70, 61)])
def test_blend_matches_the_identity_inferencer(shape):
    """Grid, uint8 conversion, bump, overlap-add and normalization, with
    the identity engine standing in for the convnet: bitwise."""
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.inference.inferencer import Inferencer

    raw = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    patch, overlap = (4, 32, 32), (2, 8, 8)
    got = Inferencer(input_patch_size=patch, output_patch_overlap=overlap,
                     num_output_channels=3, batch_size=2,
                     framework="identity", device="cpu")(Chunk(raw))
    ref = blend.infer_chunk(lambda x: x.expand(-1, 3, -1, -1, -1),
                            torch.from_numpy(raw), patch, overlap, 3,
                            batch=2)
    assert torch.equal(torch.as_tensor(np.asarray(got.host().array)), ref)
    quantized = blend.to_uint8(ref)
    assert quantized.dtype == torch.uint8
    assert torch.equal(quantized,
                       (ref.clamp(0, 1) * 255).to(torch.uint8))


def test_bump_is_chunkflows():
    from chunkflow_tpu_torch.inference.bump import bump_map

    assert np.array_equal(blend.bump((20, 256, 256)),
                          bump_map((20, 256, 256)))


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "chunkflow_tpu_torch", "chunkflow_tpu", "jax"), path
