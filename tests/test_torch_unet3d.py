"""The port's UNet3D and converter against the flax UNet3D, on the CPU.

One set of flax-layout params, drawn with numpy from a seed, runs in
both packages through ``state_from_flax``. The forward is
not bitwise (XLA and oneDNN sum convolutions in other orders); the gate
is max-abs <= 1e-5 in float32 (3.9e-7 was measured on this fixture).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chunkflow_tpu.models import unet3d as flax_unet3d
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.models.convert import state_from_flax
from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

FEATS = (4, 6, 8)
DOWNS = ((1, 2, 2), (2, 2, 2))


def _params(seed=0, cin=1, cout=3, feats=FEATS, downs=DOWNS):
    """A flax UNet3D and params for it drawn with numpy from ``seed``
    (the tree's shapes come from tracing flax's init, not running it):
    kernels ~ N(0, 1/fan_in), biases and norm offsets ~ N(0, 0.1), norm
    scales ~ 1 + N(0, 0.1)."""
    fnet = flax_unet3d.UNet3D(in_channels=cin, out_channels=cout,
                              feature_maps=feats, down_factors=downs)
    shapes = jax.eval_shape(
        lambda: flax_unet3d.init_params(fnet, (4, 16, 16), cin))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return x * 0.1 + (1.0 if name == "scale" else 0.0)

    return fnet, jax.tree_util.tree_map_with_path(draw, shapes)


def _numpy_tree(params):
    if isinstance(params, dict) or hasattr(params, "items"):
        return {k: _numpy_tree(v) for k, v in params.items()}
    return np.asarray(params)


@pytest.mark.parametrize("cin, cout, seed", [(1, 3, 0), (2, 1, 5)])
def test_unet3d_matches_flax(cin, cout, seed):
    fnet, params = _params(seed, cin, cout)
    tnet = UNet3D(in_channels=cin, out_channels=cout, feature_maps=FEATS,
                  down_factors=DOWNS).eval()
    tnet.load_state_dict(state_from_flax(_numpy_tree(params)))
    x = np.random.default_rng(seed).random((2, cin, 4, 16, 16)).astype(
        np.float32)
    ref = np.moveaxis(np.asarray(fnet.apply(
        {"params": params}, jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, cout, 4, 16, 16)
    assert np.abs(got - ref).max() <= 1e-5


def test_parity_widths_state_dict_converts_strictly():
    """At the parity widths every flax leaf lands on a torch parameter of
    the same shape, under the flax module names, and nothing is left."""
    _, params = _params(feats=(28, 36, 48, 64),
                        downs=((1, 2, 2), (2, 2, 2), (2, 2, 2)))
    state = state_from_flax(_numpy_tree(params))
    tnet = UNet3D()
    assert set(state) == set(tnet.state_dict())
    tnet.load_state_dict(state)  # strict
    assert tnet.up0.weight.shape == (36, 28, 1, 2, 2)
    assert tnet.enc1.conv1.weight.shape == (36, 28, 3, 3, 3)
    assert tnet.conv_in.weight.shape == (28, 1, 1, 5, 5)


def test_transposed_conv_kernel_is_flipped():
    """flax's ConvTranspose places its kernel unflipped; torch's flips it,
    so the converter flips the spatial axes (and only for up{i})."""
    k = np.arange(2 * 2 * 2 * 3 * 5, dtype=np.float32).reshape(2, 2, 2, 3, 5)
    state = state_from_flax({"up0": {"kernel": k, "bias": np.zeros(5)},
                                    "conv_in": {"kernel": k,
                                                "bias": np.zeros(5)}})
    assert np.array_equal(state["up0.weight"].numpy(),
                          np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))
    assert np.array_equal(state["conv_in.weight"].numpy(),
                          np.transpose(k, (4, 3, 0, 1, 2)))


def test_seeded_init_is_deterministic_and_device_free():
    a, b, c = (seeded_init(UNet3D(feature_maps=FEATS, down_factors=DOWNS),
                           torch.Generator().manual_seed(seed))
               for seed in (3, 3, 4))
    for (ka, va), vb, vc in zip(a.state_dict().items(),
                                b.state_dict().values(),
                                c.state_dict().values()):
        assert torch.equal(va, vb), ka
        if ka.endswith("conv1.weight"):
            assert not torch.equal(va, vc)
    assert torch.equal(a.enc0.norm1.weight, torch.ones(4))


def test_engine_loads_pt_weights(tmp_path):
    """The pytorch/flax/jax frameworks load a reference-style .pt state
    dict (DataParallel prefixes and a state_dict wrapper accepted)."""
    seeded = seeded_init(UNet3D(), torch.Generator().manual_seed(9))
    path = tmp_path / "w.pt"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in seeded.state_dict().items()}},
               path)
    for framework in ("pytorch", "flax", "jax"):
        engine = engines.create_engine(framework, weight_path=str(path),
                                       num_output_channels=3)
        for key, value in seeded.state_dict().items():
            assert torch.equal(engine.model.state_dict()[key], value)
    fresh = engines.create_engine("pytorch")
    again = engines.create_engine("pytorch")
    assert torch.equal(fresh.model.conv_out.weight, again.model.conv_out.weight)


@pytest.mark.parametrize("framework", ["pytorch", "flax", "jax"])
def test_engine_unported_options_raise(framework, tmp_path):
    """An orbax checkpoint directory loads (the committed one holds the
    seeded full-width weights, bitwise); one the JAX restore refuses (an
    OCDBT save whose root manifest was never merged) raises its
    ``ValueError``."""
    from tests.test_torch_orbax import FIXTURE, jax_state, unmerged

    seeded = seeded_init(UNet3D(), torch.Generator().manual_seed(0))
    engine = engines.create_engine(framework, weight_path=str(FIXTURE),
                                   num_output_channels=3)
    for key, value in seeded.state_dict().items():
        assert torch.equal(engine.model.state_dict()[key], value)
    split = unmerged(tmp_path / "split")
    with pytest.raises(ValueError):
        jax_state("parity", split)
    with pytest.raises(ValueError, match="manifest.ocdbt"):
        engines.create_engine(framework, weight_path=split)
