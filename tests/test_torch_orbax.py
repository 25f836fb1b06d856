"""Orbax checkpoint directories in the port (``models/orbax.py``)
against the JAX package on the CPU.

The JAX package restores ``inference -w <dir>`` with
``StandardCheckpointer().restore``; the port reads the same directory
without orbax. For each family (parity, ``rsunet``, ``tpu``,
``tpu_s2d4``), with ``use_ocdbt`` on and off, the port's engine holds
weights bitwise equal to the JAX ``init_or_load_params`` put through
``state_from_flax``. The committed full-width parity checkpoint
``tests/data/orbax_parity_seed0`` and its ``use_zarr3`` twin
``orbax_parity_seed0_zarr3`` (``python -m tests.test_torch_orbax``
rewrites both) hold the seeded tree ``chip_smoke.py`` loads on the card,
and a fresh save of that tree reads the same. ``use_zarr3`` saves, whose
leaves are ``sharding_indexed`` zarr v3 arrays, load bitwise the JAX
restore, with OCDBT on and off. A checkpoint the JAX restore refuses (an
OCDBT save whose root manifest was never merged, an added scalar leaf, an
extra or missing array leaf, a ``.msgpack`` missing a module) raises
``ValueError`` in both packages; a ``.msgpack`` with a leaf the model
lacks loads in both, bitwise.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.models import orbax
from chunkflow_tpu_torch.models.convert import state_from_flax
from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init

ocp = pytest.importorskip("orbax.checkpoint")

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "orbax_parity_seed0"
ZARR3_FIXTURE = FIXTURE.with_name("orbax_parity_seed0_zarr3")
PIN = (4, 16, 16)


def seeded_tree():
    """The flax-layout tree of the seeded full-width parity UNet3D
    (``chip_smoke.py`` phases 5 and 21)."""
    from chip_smoke import _flax_layout

    model = seeded_init(UNet3D(in_channels=1, out_channels=3),
                        torch.Generator().manual_seed(0))
    return _flax_layout(model.state_dict())


def save(path, tree, **options):
    """``tree`` saved as orbax saves it (``StandardCheckpointer`` with
    ``options`` for its handler)."""
    handler = (ocp.PyTreeCheckpointHandler(**options) if options
               else ocp.StandardCheckpointHandler())
    checkpointer = ocp.Checkpointer(handler)
    args = (ocp.args.PyTreeSave(tree) if options
            else ocp.args.StandardSave(tree))
    checkpointer.save(str(path), args=args)
    return str(path)


def unmerged(path):
    """An orbax save both packages refuse: an OCDBT checkpoint whose root
    holds no merged ``manifest.ocdbt`` (a multi-process save the root
    never merged)."""
    saved = save(path, {"conv_out": {"bias": np.zeros(3, np.float32)}})
    (Path(saved) / "manifest.ocdbt").unlink()
    return saved


def jax_model(variant):
    from chunkflow_tpu.models import rsunet, unet3d

    if variant == "rsunet":
        return rsunet.RSUNet(in_channels=1, out_channels=3)
    if variant == "parity":
        return unet3d.UNet3D(in_channels=1, out_channels=3)
    return unet3d.create_tpu_optimized_model(
        1, 3, s2d_factor=(1, 4, 4) if variant == "tpu_s2d4" else (1, 2, 2))


def jax_state(variant, path):
    """The JAX package's restore of ``path`` (``init_or_load_params``), in
    the port's layout. Its template's shapes are traced, not computed: a
    full-width ``model.init`` compiles for tens of seconds on the CPU, and
    orbax restores into abstract arrays alike."""
    import jax

    from chunkflow_tpu.models import unet3d

    real = unet3d.init_params
    unet3d.init_params = lambda *args, **kwargs: jax.eval_shape(
        lambda: real(*args, **kwargs))
    try:
        params = unet3d.init_or_load_params(jax_model(variant), path, PIN, 1)
    finally:
        unet3d.init_params = real
    return state_from_flax(jax.tree_util.tree_map(np.asarray, params))


def assert_same_state(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_the_committed_checkpoint_is_the_seeded_tree(tmp_path):
    """The fixture, a fresh save of the same tree and the JAX restore of
    the fixture all give the seeded weights."""
    seeded = seeded_init(UNet3D(in_channels=1, out_channels=3),
                         torch.Generator().manual_seed(0)).state_dict()
    tree = seeded_tree()
    want = state_from_flax(tree)
    for key, value in seeded.items():
        assert torch.equal(want[key], value)
    assert_same_state(state_from_flax(orbax.load_params(str(FIXTURE))), want)
    fresh = save(tmp_path / "fresh", tree)
    assert_same_state(state_from_flax(orbax.load_params(fresh)), want)
    assert_same_state(jax_state("parity", str(FIXTURE)), want)
    metadata = json.loads((FIXTURE / "_METADATA").read_text())
    assert metadata["use_ocdbt"] and not metadata["use_zarr3"]
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 3 * 2 ** 20


@pytest.mark.parametrize("use_ocdbt", [True, False], ids=["ocdbt", "files"])
@pytest.mark.parametrize("variant", ["parity", "rsunet", "tpu", "tpu_s2d4"])
def test_every_family_loads_bitwise_the_jax_restore(tmp_path, variant,
                                                    use_ocdbt):
    from chunkflow_tpu_torch.inference import engines
    from tests.test_torch_models import draw_params

    params = draw_params(jax_model(variant), PIN, seed=3)
    path = str(tmp_path / "ck")
    checkpointer = ocp.Checkpointer(
        ocp.StandardCheckpointHandler(use_ocdbt=use_ocdbt))
    checkpointer.save(path, args=ocp.args.StandardSave(params))
    assert (Path(path) / "manifest.ocdbt").exists() == use_ocdbt
    engine = engines.create_engine("flax", weight_path=path,
                                   model_variant=variant,
                                   num_output_channels=3)
    assert_same_state(engine.model.state_dict(), jax_state(variant, path))


@pytest.mark.parametrize("use_ocdbt", [True, False], ids=["ocdbt", "files"])
@pytest.mark.parametrize("variant", ["parity", "tpu_s2d4"])
def test_zarr3_checkpoints_load_bitwise_the_jax_restore(tmp_path, variant,
                                                        use_ocdbt):
    """``use_zarr3`` saves (each leaf a ``sharding_indexed`` zarr v3
    array) load into the port's engine as the JAX package restores
    them."""
    from chunkflow_tpu_torch.inference import engines
    from tests.test_torch_models import draw_params

    params = draw_params(jax_model(variant), PIN, seed=5)
    path = save(tmp_path / "ck", params, use_zarr3=True,
                use_ocdbt=use_ocdbt)
    metadata = json.loads((Path(path) / "_METADATA").read_text())
    assert metadata["use_zarr3"] and metadata["use_ocdbt"] == use_ocdbt
    engine = engines.create_engine("flax", weight_path=path,
                                   model_variant=variant,
                                   num_output_channels=3)
    assert_same_state(engine.model.state_dict(), jax_state(variant, path))


def test_the_committed_zarr3_checkpoint_is_the_seeded_tree():
    """``ZARR3_FIXTURE`` (the seeded tree saved with ``use_zarr3``, which
    ``chip_smoke.py`` phase 21 loads on the card) reads as the seeded
    weights in the port and in the JAX restore."""
    want = state_from_flax(seeded_tree())
    assert_same_state(state_from_flax(orbax.load_params(str(ZARR3_FIXTURE))),
                      want)
    assert_same_state(jax_state("parity", str(ZARR3_FIXTURE)), want)
    metadata = json.loads((ZARR3_FIXTURE / "_METADATA").read_text())
    assert metadata["use_ocdbt"] and metadata["use_zarr3"]
    size = sum(p.stat().st_size for p in ZARR3_FIXTURE.rglob("*")
               if p.is_file())
    assert size < 3 * 2 ** 20


def test_a_bfloat16_leaf_reads_as_float32_exactly(tmp_path):
    import jax.numpy as jnp

    values = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    tree = {"a": {"kernel": jnp.asarray(values, jnp.bfloat16),
                  "bias": values[0]}}
    got = orbax.load_params(save(tmp_path / "ck", tree))
    want = np.asarray(jnp.asarray(values, jnp.bfloat16).astype(jnp.float32))
    assert got["a"]["kernel"].dtype == np.float32
    assert np.array_equal(got["a"]["kernel"], want)
    assert np.array_equal(got["a"]["bias"], values[0])


def test_what_the_port_does_not_read_raises_naming_its_item(tmp_path):
    tree = {"a": {"bias": np.arange(4, dtype=np.float32)}}
    # zarr v3 arrays inside a sharding_indexed codec read as orbax restores
    for use_ocdbt in (True, False):
        path = save(tmp_path / f"z3{use_ocdbt}", tree, use_zarr3=True,
                    use_ocdbt=use_ocdbt)
        got = orbax.load_params(path)
        restored = ocp.Checkpointer(ocp.PyTreeCheckpointHandler()).restore(
            path)
        assert np.array_equal(got["a"]["bias"], tree["a"]["bias"])
        assert np.array_equal(got["a"]["bias"],
                              np.asarray(restored["a"]["bias"]))
    # what the JAX restore refuses raises its class, ValueError, naming
    # the file or the leaf: a save whose processes' stores the root does
    # not merge, and a leaf that is not an array (an added step: 5)
    path = unmerged(tmp_path / "split")
    with pytest.raises(ValueError, match="manifest.ocdbt"):
        orbax.load_params(path)
    with pytest.raises(ValueError):
        jax_state("parity", path)
    path = save(tmp_path / "scalar", dict(seeded_tree(), step=5))
    meta = json.loads((Path(path) / "_METADATA").read_text())
    assert meta["tree_metadata"]["('step',)"]["value_metadata"][
        "value_type"] not in orbax.ARRAY_TYPES
    with pytest.raises(ValueError, match="step"):
        orbax.load_params(path)
    with pytest.raises(ValueError):
        jax_state("parity", path)
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        orbax.load_params(str(tmp_path))


def _flax_msgpack(path, tree):
    from flax import serialization

    path.write_bytes(serialization.to_bytes(tree))
    return str(path)


@pytest.mark.parametrize("case", ["orbax-extra", "orbax-missing",
                                  "msgpack-missing"])
def test_a_tree_of_other_leaves_raises_in_both_packages(tmp_path, case):
    """An orbax tree with an extra array leaf or without ``bridge``, and a
    ``.msgpack`` without ``bridge``: the JAX loader raises ``ValueError``,
    and so does the port's, naming the leaves."""
    from chunkflow_tpu_torch.models.convert import init_or_load_weights

    tree = seeded_tree()
    if case == "orbax-extra":
        tree["extra"] = {"bias": np.zeros(3, np.float32)}
        name = "extra.bias"
    else:
        del tree["bridge"]
        name = "bridge"
    path = (_flax_msgpack(tmp_path / "w.msgpack", tree)
            if case.startswith("msgpack") else save(tmp_path / "ck", tree))
    with pytest.raises(ValueError):
        jax_state("parity", path)
    with pytest.raises(ValueError, match=name):
        init_or_load_weights(UNet3D(in_channels=1, out_channels=3), path)


def test_a_msgpack_leaf_the_model_lacks_is_ignored_as_flax_does(tmp_path):
    """A ``.msgpack`` with a leaf the model has no parameter for loads in
    the JAX package (flax's ``from_state_dict`` ignores it) and in the
    port, bitwise."""
    from chunkflow_tpu_torch.models.convert import init_or_load_weights

    tree = dict(seeded_tree(), extra={"bias": np.zeros(3, np.float32)})
    path = _flax_msgpack(tmp_path / "w.msgpack", tree)
    model = init_or_load_weights(UNet3D(in_channels=1, out_channels=3), path)
    want = jax_state("parity", path)
    assert_same_state(model.state_dict(), want)
    assert_same_state(want, state_from_flax(seeded_tree()))


def write_fixture() -> None:
    shutil.rmtree(FIXTURE, ignore_errors=True)
    save(FIXTURE, seeded_tree())
    shutil.rmtree(ZARR3_FIXTURE, ignore_errors=True)
    save(ZARR3_FIXTURE, seeded_tree(), use_zarr3=True)


if __name__ == "__main__":
    write_fixture()
