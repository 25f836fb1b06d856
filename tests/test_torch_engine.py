"""The port's mesh engine against the JAX package's, on the CPU.

The port runs every mesh on an injected device list, ``[cpu] * 8``
(``Inferencer._mesh``; the CLI's local-device lister is patched the same
way), where the JAX suite runs its 8 virtual CPU devices
(``tests/conftest.py``). Each mesh shape of the JAX parity matrix
(``tests/parallel/test_engine.py``, ``MESHES``) and each traffic class
goes through both packages: the port's mesh output must equal, bitwise,
the port's single device and the JAX ``Inferencer`` on the same mesh for
the identity engines; a small UNet3D (one set of flax-layout weights in
both, ``models/convert.py``) is bitwise the port's single device and
within 1e-5 of JAX. The spec grammar, the stage groups, the precision
wrapping of stages, the legacy wrappers, the ``shard/*`` telemetry, the
replay flip, the scheduler, the packer and the CLI are held against the
JAX package too.
"""
import numpy as np
import pytest
import torch

import jax

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.core import telemetry as jax_telemetry
from chunkflow_tpu.inference import engines as jax_engines
from chunkflow_tpu.inference import precision as jax_precision
from chunkflow_tpu.inference.inferencer import Inferencer as JaxInferencer
from chunkflow_tpu.parallel import engine as jax_engine_mod
from chunkflow_tpu.parallel import pipeline as jax_pipeline
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.inference import engines, precision
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.parallel import engine as engine_mod
from chunkflow_tpu_torch.parallel import pipeline

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (4, 16, 16)
OVERLAP = (2, 8, 8)
CPU8 = [torch.device("cpu")] * 8
MESHES = ["1", "data=2", "data=4", "data=8", "y=2", "y=4", "y=8",
          "y=2,x=2", "y=4,x=2", "y=2,x=4", "pipeline=4", "pipeline=8"]
TRAFFIC = ["plain", "ragged", "uint8", "crop_margin"]


def _traffic_chunk(traffic: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if traffic == "ragged":
        # non-divisible extents: edge snapping and uneven slab buckets
        return rng.random((6, 37, 45)).astype(np.float32)
    if traffic == "uint8":
        return rng.integers(0, 256, (8, 40, 48), dtype=np.uint8)
    return rng.random((8, 40, 48)).astype(np.float32)


def _kwargs(crop: bool, **kw) -> dict:
    if crop:
        # a central-crop identity engine: the margin crop is a real
        # (1, 4, 4) one
        base = dict(input_patch_size=PIN, output_patch_size=(2, 8, 8),
                    output_patch_overlap=(1, 4, 4), crop_output_margin=True)
    else:
        base = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                    crop_output_margin=False)
    base.update(num_output_channels=3, framework="identity", batch_size=2)
    base.update(kw)
    return base


def port_inferencer(mesh=None, crop=False, devices=CPU8, **kw):
    inf = Inferencer(device="cpu", mesh=mesh, **_kwargs(crop, **kw))
    inf._mesh = devices
    return inf


def jax_inferencer(mesh=None, crop=False, **kw):
    return JaxInferencer(mesh=mesh, **_kwargs(crop, **kw))


@pytest.fixture(scope="module")
def shared():
    """One port and one JAX inferencer per (package, mesh, crop), shared
    across the matrix (a fresh JAX inferencer per case would compile
    every program again)."""
    cache = {}

    def get(package, mesh=None, crop=False):
        key = (package, mesh, crop)
        if key not in cache:
            make = port_inferencer if package == "port" else jax_inferencer
            cache[key] = make(mesh, crop)
        return cache[key]

    return get


def _port_out(inf, arr) -> np.ndarray:
    return inf(Chunk(arr.copy())).host().array


def _jax_out(inf, arr) -> np.ndarray:
    return np.asarray(inf(JaxChunk(arr.copy())).array)


def _same(got: np.ndarray, ref: np.ndarray, what: str) -> None:
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert np.array_equal(got, ref), (
        f"{what}: max abs {np.abs(got.astype(np.float64) - ref).max():.3e}")


# ---------------------------------------------------------------------------
# the spec grammar
# ---------------------------------------------------------------------------
SPECS = [(None, None), ("1", None), ("off", None), ("auto", 8),
         ("auto", 1), ("8", None), ("data=4", None), ("y=4", None),
         ("x=4", None), ("y=4,x=2", None), ("y=1,x=1", None),
         ("data=8", None), ("pipeline=4", None), ("pipeline=1", None),
         (" Y = 2 , X = 2 ", None), ("z=4", None), ("data=4,y=2", None),
         ("pipeline=2,y=2", None), ("pipeline=16", 8), ("y=2,y=4", None),
         ("data=16", 8), ("data=0", None), ("2", 1), ("auto", None)]


@pytest.mark.parametrize("value, n_devices", SPECS,
                         ids=[f"{v}-{n}" for v, n in SPECS])
def test_spec_grammar_is_the_jax_grammar(value, n_devices):
    try:
        ref = jax_engine_mod.parse_mesh_spec(value, n_devices)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            engine_mod.parse_mesh_spec(value, n_devices)
        assert str(got.value) == str(exc)
        return
    got = engine_mod.parse_mesh_spec(value, n_devices)
    assert tuple(got) == tuple(ref)
    assert got.describe() == ref.describe()
    assert got.n_devices == ref.n_devices


def test_env_spec_is_read_per_call(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_MESH", "y=4,x=2")
    assert tuple(engine_mod.mesh_env_spec()) == tuple(
        jax_engine_mod.mesh_env_spec())
    with pytest.raises(ValueError) as ref:
        jax_engine_mod.mesh_env_spec(4)
    with pytest.raises(ValueError) as got:
        engine_mod.mesh_env_spec(4)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("extent, n, pin, pout", [
    (512, 4, 256, 256), (40, 2, 16, 16), (37, 8, 16, 8), (45, 1, 16, 16)])
def test_axis_geometry_is_the_jax_geometry(extent, n, pin, pout):
    assert engine_mod.axis_geometry(extent, n, pin, pout) == \
        jax_engine_mod.axis_geometry(extent, n, pin, pout)


# ---------------------------------------------------------------------------
# the parity matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES[1:])
@pytest.mark.parametrize("traffic", TRAFFIC)
def test_mesh_bitwise_parity_matrix(shared, mesh, traffic):
    """Every mesh shape x every traffic class: the port on ``[cpu] * 8``
    == the port's single device == the JAX ``Inferencer`` on the same
    mesh, bitwise."""
    crop = traffic == "crop_margin"
    arr = _traffic_chunk(traffic, seed=len(traffic))
    single = _port_out(shared("port", crop=crop), arr)
    got = _port_out(shared("port", mesh, crop), arr)
    ref = _jax_out(shared("jax", mesh, crop), arr)
    _same(got, single, f"{mesh} vs the port's single device")
    _same(got, ref, f"{mesh} vs the JAX mesh")


@pytest.mark.parametrize("replay", ["sharded", "replicated"])
@pytest.mark.parametrize("mesh", MESHES[1:])
def test_kernel_calls_per_run_follow_the_plans(shared, mesh, replay,
                                               monkeypatch):
    """Each shard calls the gather and the accumulate as often as the
    engine's partition and replay plans say
    (``chip_smoke.mesh_expected_launches``, which the card's launch
    counts are held to)."""
    import chip_smoke
    from chunkflow_tpu_torch.ops import accumulate, gather

    calls = {"gather": 0, "accumulate": 0}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(gather, "gather_patches",
                        counting("gather", gather.gather_patches))
    monkeypatch.setattr(accumulate, "fused_accumulate_patches",
                        counting("accumulate",
                                 accumulate.fused_accumulate_patches))
    monkeypatch.setenv("CHUNKFLOW_SHARD_REPLAY", replay)
    arr = _traffic_chunk("ragged")
    _port_out(shared("port", mesh), arr)
    assert (calls["gather"], calls["accumulate"]) == \
        chip_smoke.mesh_expected_launches(
            engine_mod.parse_mesh_spec(mesh), replay, arr.shape, PIN,
            OVERLAP, 2)


def test_kill_switch_spec_is_single(shared):
    assert shared("port", "1").shard_engine() is None


@pytest.mark.parametrize("mesh", MESHES[1:])
def test_packed_serving_bitwise_per_chunk(mesh, monkeypatch):
    """The packed-serve traffic class: requests packed into batches of
    ``batch_size x n_devices`` slots over the mesh, each result bitwise
    its own single-device call and the JAX ``Inferencer``'s."""
    from chunkflow_tpu_torch.serve.packer import PatchPacker

    rng = np.random.default_rng(5)
    arrs = [rng.random(shape).astype(np.float32)
            for shape in ((4, 16, 48), (4, 32, 32), (6, 16, 40))]
    kw = dict(output_patch_overlap=(0, 0, 0))
    inf = port_inferencer(**kw)
    refs = [_port_out(inf, a) for a in arrs]
    jax_inf = jax_inferencer(**kw)
    jax_refs = [_jax_out(jax_inf, a) for a in arrs]
    monkeypatch.setenv("CHUNKFLOW_MESH", mesh)
    telemetry.reset()
    packer = PatchPacker(inf, max_wait_ms=25.0)
    try:
        handles = [packer.submit(Chunk(a.copy())) for a in arrs]
        outs = [h.result(timeout=120).host().array for h in handles]
    finally:
        packer.close()
    snap = telemetry.snapshot()
    telemetry.reset()
    for out, ref, jax_ref in zip(outs, refs, jax_refs):
        _same(out, ref, f"packed under {mesh}")
        _same(out, jax_ref, f"packed under {mesh} vs JAX")
    n = engine_mod.parse_mesh_spec(mesh).n_devices
    assert snap["gauges"]["serving/chips"] == float(n)


# ---------------------------------------------------------------------------
# a convolutional engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unet_engines():
    from tests.test_torch_inferencer import _unet_engines

    return _unet_engines()


@pytest.mark.parametrize("mesh", ["data=8", "y=4,x=2"])
def test_conv_engine_bitwise_one_device_and_close_to_jax(unet_engines,
                                                         mesh):
    """Per-row forwards at the single-device batch shape: the mesh is
    bitwise the port's one device; the forward differs from XLA's in its
    summation order, within 1e-5."""
    jax_engine, port_engine = unet_engines
    arr = _traffic_chunk("ragged", seed=11)
    kw = dict(framework="prebuilt")
    single = _port_out(port_inferencer(engine=port_engine, **kw), arr)
    got = _port_out(port_inferencer(mesh, engine=port_engine, **kw), arr)
    ref = _jax_out(jax_inferencer(mesh, engine=jax_engine, **kw), arr)
    _same(got, single, f"conv {mesh}")
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-5


def test_pipeline_mesh_needs_a_staged_engine(unet_engines):
    """A convnet declares no stages: ``pipeline=N`` raises the JAX
    message in both packages."""
    jax_engine, port_engine = unet_engines
    arr = _traffic_chunk("ragged")
    kw = dict(framework="prebuilt")
    with pytest.raises(ValueError) as ref:
        jax_inferencer("pipeline=4", engine=jax_engine, **kw)(JaxChunk(arr))
    with pytest.raises(ValueError) as got:
        port_inferencer("pipeline=4", engine=port_engine, **kw)(Chunk(arr))
    assert str(got.value) == str(ref.value)
    assert "stage protocol" in str(got.value)


def test_pipeline_under_augment_raises_as_in_jax():
    arr = _traffic_chunk("plain")
    with pytest.raises(ValueError) as ref:
        jax_inferencer("pipeline=4", augment=True)(JaxChunk(arr))
    with pytest.raises(ValueError) as got:
        port_inferencer("pipeline=4", augment=True)(Chunk(arr))
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("mesh", ["data=2", "y=2", "pipeline=2"])
def test_a_mesh_wider_than_the_devices_raises_the_jax_error(mesh,
                                                            monkeypatch):
    """One local device in both packages (the JAX suite's conftest gives
    it eight; here it sees one, as on a one-card machine)."""
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    arr = _traffic_chunk("uint8")
    with pytest.raises(ValueError) as ref:
        jax_inferencer(mesh)(JaxChunk(arr))
    with pytest.raises(ValueError) as got:
        port_inferencer(mesh, devices=None)(Chunk(arr))
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("prec, augment", [("float32", False),
                                            ("bfloat16", True)])
def test_a_shard_elsewhere_runs_a_copy_of_the_parameters(prec, augment):
    """A shard's forward: the inferencer's own on its device, and for an
    engine without parameters; on another device the engine's call on a
    copy of its parameters there, at the same precision and TTA, bitwise.
    The inferencer is told it lives on the meta device, so that the CPU
    is "another device" here."""
    inf = Inferencer(device="cpu", framework="pytorch",
                     model_variant="parity", input_patch_size=PIN,
                     num_output_channels=3, batch_size=2, precision=prec,
                     augment=augment)
    cpu = torch.device("cpu")
    assert inf._forward_on(cpu) == inf._forward
    x = torch.from_numpy(np.random.default_rng(12).random(
        (2, 1) + PIN).astype(np.float32))
    with torch.no_grad():
        ref = inf._forward(x)
        inf.device = torch.device("meta")
        forward = inf._forward_on(cpu)
        assert forward != inf._forward and inf._forward_on(cpu) is forward
        assert torch.equal(forward(x), ref)
    identity = port_inferencer()
    identity.device = torch.device("meta")
    assert identity._forward_on(cpu) == identity._forward


# ---------------------------------------------------------------------------
# the stage protocol and its precision wrapping
# ---------------------------------------------------------------------------
def test_stage_groups_are_the_jax_groups():
    for package in (pipeline, jax_pipeline):
        with pytest.raises(ValueError, match="stage protocol"):
            package.require_stages(None, None, "test context")
    traces = []
    for package in (pipeline, jax_pipeline):
        trace = []

        def body(tag, trace=trace):
            def run(params, x):
                trace.append(tag)
                return x + 1
            return run

        for n_bodies, n_stages in ((5, 3), (1, 4), (4, 4), (7, 2)):
            groups = package.stage_groups(
                tuple(body(i) for i in range(n_bodies)), n_stages)
            assert len(groups) == n_stages
            for s, group in enumerate(groups):
                trace.append(("stage", s, group(None, 0)))
        traces.append(trace)
    assert traces[0] == traces[1]
    with pytest.raises(ValueError) as ref:
        jax_pipeline.stage_groups((), 0)
    with pytest.raises(ValueError) as got:
        pipeline.stage_groups((), 0)
    assert str(got.value) == str(ref.value)


def test_identity_engine_declares_its_stages():
    eng = engines.create_identity_engine(PIN, (2, 8, 8), 3)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 1) + PIN).astype(np.float32))
    staged = eng.stage_tail(None, eng.stage_bodies[0](None, x))
    assert torch.equal(staged, eng.apply(x))
    assert engines.create_convnet_engine(
        "", None, model_variant="parity").stage_bodies is None


@pytest.mark.parametrize("prec, leg", [("float32", "fake"),
                                       ("bfloat16", "fake"),
                                       ("int8", "fake")])
def test_wrapped_stages_compose_to_wrap_apply(prec, leg, monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_INT8", leg)
    eng = engines.create_identity_engine(PIN, PIN, 3)
    entry, bodies, tail = precision.wrap_stages(
        eng.stage_bodies, eng.stage_tail, prec, eng.params)
    if prec == "float32":
        assert bodies == eng.stage_bodies and tail is eng.stage_tail
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 1) + PIN).astype(np.float32))
    staged = entry(x)
    for body in bodies:
        staged = body(None, staged)
    staged = tail(None, staged)
    ref = precision.wrap_apply(eng.apply, prec, eng.params, eng.call)(x)
    assert staged.dtype == ref.dtype == torch.float32
    assert torch.equal(staged, ref)
    # and the pipeline mesh at this precision: bitwise the port's one
    # device, and the JAX mesh (int8 fake within 4 ulp of the compiled
    # JAX program, which fuses the dequant multiply into the blend:
    # tests/test_torch_precision.py)
    monkeypatch.setenv("CHUNKFLOW_PRECISION", prec)
    arr = _traffic_chunk("ragged", seed=3)
    got = _port_out(port_inferencer("pipeline=4"), arr)
    _same(got, _port_out(port_inferencer(), arr), f"pipeline {prec}")
    ref = _jax_out(jax_inferencer("pipeline=4"), arr)
    if prec == "int8":
        np.testing.assert_array_max_ulp(got, ref, maxulp=4)
    else:
        _same(got, ref, f"pipeline {prec} vs JAX")


@pytest.mark.parametrize("leg", ["real", "fakeint"])
def test_int8_legs_that_rewrite_the_forward_refuse_a_pipeline(leg,
                                                              monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_INT8", leg)
    eng = engines.create_identity_engine(PIN, PIN, 3)
    assert precision.wrap_stages(eng.stage_bodies, eng.stage_tail,
                                 "int8") == (None, None, None)
    assert jax_precision.wrap_stages(
        jax_engines.create_identity_engine(PIN, PIN, 3).stage_bodies,
        jax_engines.create_identity_engine(PIN, PIN, 3).stage_tail,
        "int8") == (None, None, None)
    arr = _traffic_chunk("plain")
    with pytest.raises(ValueError) as ref:
        jax_inferencer("pipeline=4", precision="int8")(JaxChunk(arr))
    with pytest.raises(ValueError) as got:
        port_inferencer("pipeline=4", precision="int8")(Chunk(arr))
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the legacy wrappers
# ---------------------------------------------------------------------------
def test_legacy_wrappers_delegate_bitwise():
    from chunkflow_tpu.parallel.distributed import (
        sharded_inference as jax_distributed,
    )
    from chunkflow_tpu.parallel.spatial import (
        spatial_sharded_inference as jax_spatial,
    )
    from chunkflow_tpu.parallel.spatial2d import (
        near_square_shape as jax_near_square,
        spatial2d_sharded_inference as jax_spatial2d,
    )
    from chunkflow_tpu_torch.parallel.distributed import sharded_inference
    from chunkflow_tpu_torch.parallel.spatial import (
        spatial_geometry,
        spatial_sharded_inference,
    )
    from chunkflow_tpu_torch.parallel.spatial2d import (
        near_square_shape,
        spatial2d_sharded_inference,
    )
    from chunkflow_tpu.parallel.spatial import (
        spatial_geometry as jax_spatial_geometry,
    )

    arr = _traffic_chunk("plain", seed=2)
    ref = _port_out(port_inferencer(), arr)
    eng = engines.create_identity_engine(PIN, PIN, 3)
    jax_eng = jax_engines.create_identity_engine(
        input_patch_size=PIN, output_patch_size=PIN, num_input_channels=1,
        num_output_channels=3)
    for port_fn, jax_fn in ((sharded_inference, jax_distributed),
                            (spatial_sharded_inference, jax_spatial),
                            (spatial2d_sharded_inference, jax_spatial2d)):
        got = port_fn(arr, eng, PIN, PIN, OVERLAP, batch_size=2,
                      devices=CPU8, device="cpu").numpy()
        _same(got, ref, port_fn.__name__)
        _same(got, np.asarray(jax_fn(arr, jax_eng, PIN, PIN, OVERLAP,
                                     batch_size=2)), port_fn.__name__)
    for n in range(1, 17):
        assert near_square_shape(n) == jax_near_square(n)
    assert spatial_geometry(40, 4, PIN, (2, 8, 8)) == \
        jax_spatial_geometry(40, 4, PIN, (2, 8, 8))


@pytest.mark.parametrize("wrapper", ["distributed", "spatial2d"])
def test_legacy_wrapper_runs_a_conv_engine_bitwise(unet_engines, wrapper):
    """A raw engine with parameters through a legacy wrapper over eight
    shards: bitwise the port's single device."""
    from chunkflow_tpu_torch.parallel import distributed, spatial2d

    fn = (distributed.sharded_inference if wrapper == "distributed"
          else spatial2d.spatial2d_sharded_inference)
    _, port_engine = unet_engines
    arr = _traffic_chunk("ragged", seed=13)
    single = _port_out(port_inferencer(engine=port_engine,
                                       framework="prebuilt"), arr)
    with torch.no_grad():
        got = fn(arr, port_engine, PIN, PIN, OVERLAP, batch_size=2,
                 devices=CPU8, device="cpu")
    _same(got.numpy(), single, wrapper)


def test_legacy_wrappers_run_on_the_card_unless_asked(monkeypatch):
    """As every entry point of the port: the default device is the card,
    and without one the wrappers raise, where they would otherwise run
    the whole mesh on the host."""
    from chunkflow_tpu_torch.parallel import distributed, spatial, spatial2d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = _traffic_chunk("plain")
    eng = engines.create_identity_engine(PIN, PIN, 3)
    for fn in (distributed.sharded_inference,
               spatial.spatial_sharded_inference,
               spatial2d.spatial2d_sharded_inference):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(arr, eng, PIN, PIN, OVERLAP, batch_size=2)
        out = fn(arr, eng, PIN, PIN, OVERLAP, batch_size=2, device="cpu")
        assert out.device == torch.device("cpu")


def test_a_shard_off_the_parameters_device_gets_a_copy():
    """``on_device``: the home value on the parameters' device or without
    parameters; elsewhere ``make`` of a copy of the parameters there,
    built once. The home is named the meta device, so that the CPU is
    "another device" here."""
    module = torch.nn.Conv3d(1, 2, 3)
    cpu = torch.device("cpu")
    assert engine_mod.params_device(module) == cpu
    assert engine_mod.params_device({"a": [None, module.weight]}) == cpu
    assert engine_mod.params_device(torch.nn.ReLU()) is None
    assert engine_mod.params_device(None) is None
    built: dict = {}
    home = object()
    assert engine_mod.on_device(cpu, cpu, home, module, None, built) is home
    assert engine_mod.on_device(cpu, "meta", home, None, None, built) is home
    copy = engine_mod.on_device(cpu, "meta", home, module, lambda p: p,
                                built)
    assert copy is not module and copy is not home
    assert torch.equal(copy.weight, module.weight)
    assert engine_mod.on_device(cpu, "meta", home, module, None,
                                built) is copy


@pytest.mark.parametrize("legacy, kind, shape", [
    ("patch", "data", (8,)),
    ("spatial", "spatial", (8, 1)),
    ("spatial2d", "spatial", (2, 4)),
])
def test_legacy_sharding_names_map_to_the_jax_layouts(legacy, kind, shape):
    spec = port_inferencer(sharding=legacy).shard_engine().spec
    ref = jax_inferencer(sharding=legacy).shard_engine().spec
    assert (spec.kind, spec.shape) == (kind, shape) == (ref.kind, ref.shape)


def test_mesh_and_legacy_sharding_conflict_as_in_jax():
    with pytest.raises(ValueError) as ref:
        jax_inferencer("data=4", sharding="patch")
    with pytest.raises(ValueError) as got:
        port_inferencer("data=4", sharding="patch")
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# shard/* telemetry
# ---------------------------------------------------------------------------
#: the JAX names the port has no counterpart for: XLA's cost-analysis
#: split, and the readiness probe's wall-clock readings
_UNSHARED = ("shard/compute_s_est", "shard/collective_s_est",
             "shard/collective_share_est", "shard/chip_skew_s")


def _shard_metrics(snap) -> dict:
    out = {}
    for kind in ("counters", "gauges"):
        for name, value in snap[kind].items():
            if (name.startswith("shard/") and name not in _UNSHARED
                    and not name.endswith("/ready_s")):
                out[name] = value
    return out


@pytest.mark.parametrize("mesh, replay", [
    ("data=8", "sharded"), ("y=2,x=2", "sharded"), ("y=4", "replicated"),
    ("pipeline=4", "sharded"), ("data=4", "replicated")])
def test_shard_telemetry_names_and_values_are_the_jax_ones(
        mesh, replay, monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_SHARD_REPLAY", replay)
    monkeypatch.setenv("CHUNKFLOW_CHIP_PROBE_EVERY", "1")
    arr = _traffic_chunk("ragged", seed=6)
    snaps = []
    for reg, run in ((jax_telemetry, lambda: _jax_out(
            jax_inferencer(mesh), arr)),
                     (telemetry, lambda: _port_out(
                         port_inferencer(mesh), arr))):
        reg.reset()
        try:
            run()
            snaps.append(reg.snapshot())
        finally:
            reg.reset()
    ref, got = (_shard_metrics(s) for s in snaps)
    assert got == ref
    n = engine_mod.parse_mesh_spec(mesh).n_devices
    gauges = snaps[1]["gauges"]
    assert [f"shard/chip/{i}/ready_s" in gauges for i in range(n)] == \
        [True] * n
    assert gauges["shard/chip_skew_s"] >= 0.0


def test_telemetry_off_means_no_shard_metrics_and_no_probe(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_TELEMETRY", "0")
    monkeypatch.setenv("CHUNKFLOW_CHIP_PROBE_EVERY", "1")
    arr = _traffic_chunk("plain", seed=13)
    telemetry.reset()
    inf = port_inferencer("data=8")
    out = _port_out(inf, arr)
    snap = telemetry.snapshot()
    telemetry.reset()
    assert not any(k.startswith("shard/") for k in snap["gauges"])
    assert not any(k.startswith("shard/") for k in snap["counters"])
    _same(out, _port_out(port_inferencer(), arr), "telemetry off")
    engine = inf.shard_engine()
    assert not any(engine._probing() for _ in range(3))


def test_probe_cadence_is_sampled(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_CHIP_PROBE_EVERY", "4")
    engine = engine_mod.ShardedEngine(
        lambda x: x, 1, 3, PIN, PIN, 2, engine_mod.MeshSpec("data", (8,)))
    telemetry.reset()
    try:
        assert [engine._probing() for _ in range(9)] == \
            [True, False, False, False] * 2 + [True]
    finally:
        telemetry.reset()


def test_replay_buffer_is_slab_plus_margin(monkeypatch):
    """The analytic per-shard blend buffer of the sharded replay, the JAX
    number, below the full chunk's."""
    monkeypatch.setenv("CHUNKFLOW_MESH", "y=4,x=2")
    z, y, x = 8, 120, 96
    arr = np.random.default_rng(25).random((z, y, x)).astype(np.float32)
    telemetry.reset()
    try:
        _port_out(port_inferencer(), arr)
        gauges = telemetry.snapshot()["gauges"]
    finally:
        telemetry.reset()
    yslab = engine_mod.axis_geometry(y, 4, PIN[1], PIN[1])[0]
    xslab = engine_mod.axis_geometry(x, 2, PIN[2], PIN[2])[0]
    expected = 4 * z * (yslab + 2 * PIN[1]) * (xslab + 2 * PIN[2]) * 4
    assert gauges["shard/replay_buffer_bytes"] == float(expected)
    assert expected < 4 * z * y * x * 4
    assert all(gauges[f"shard/chip/{i}/replay_buffer_bytes"] == expected
               for i in range(8))


# ---------------------------------------------------------------------------
# the replay flip, the env switch, the scheduler, the CLI
# ---------------------------------------------------------------------------
def test_replay_flip_and_kill_switch_bitwise(monkeypatch):
    """``CHUNKFLOW_SHARD_REPLAY`` and ``CHUNKFLOW_MESH`` are re-read per
    chunk on a live inferencer: every setting bitwise one device."""
    arr = _traffic_chunk("ragged", seed=21)
    ref = _port_out(port_inferencer(), arr)
    inf = port_inferencer()
    monkeypatch.setenv("CHUNKFLOW_MESH", "y=2,x=2")
    assert inf.shard_engine() is not None
    _same(_port_out(inf, arr), ref, "sharded replay")
    monkeypatch.setenv("CHUNKFLOW_SHARD_REPLAY", "replicated")
    _same(_port_out(inf, arr), ref, "replicated replay")
    monkeypatch.setenv("CHUNKFLOW_MESH", "1")
    assert inf.shard_engine() is None
    _same(_port_out(inf, arr), ref, "kill switch")


def test_explicit_mesh_overrides_env(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_MESH", "data=8")
    inf = port_inferencer("y=2")
    assert tuple(inf.shard_engine().spec) == ("spatial", (2, 1))
    monkeypatch.setenv("CHUNKFLOW_MESH", "1")
    assert inf.shard_engine() is not None


def test_fold_with_a_mesh_notes_and_runs_one_device(capsys):
    arr = _traffic_chunk("plain", seed=8)
    got = _port_out(port_inferencer("data=4", blend="fold"), arr)
    note = capsys.readouterr().err
    ref = _jax_out(jax_inferencer("data=4", blend="fold"), arr)
    assert "fold blend is a single-device program" in note
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-6


def test_scheduled_stream_through_a_mesh(monkeypatch):
    """``Inferencer.stream`` on a mesh inferencer is bitwise the serial
    single-device loop, and the stream announces its mesh once."""
    rng = np.random.default_rng(4)
    arrs = [rng.random((8, 40, 48)).astype(np.float32) for _ in range(3)]
    refs = [_port_out(port_inferencer(), a) for a in arrs]
    jax_refs = [_jax_out(jax_inferencer(), a) for a in arrs]
    monkeypatch.setenv("CHUNKFLOW_MESH", "y=2,x=2")
    events = []
    monkeypatch.setattr(
        telemetry, "event",
        lambda kind, name, **attrs: events.append((kind, name, attrs)))
    inf = port_inferencer()
    outs = [c.array for c in inf.stream(
        iter(Chunk(a, voxel_offset=(8 * i, 0, 0))
             for i, a in enumerate(arrs)))]
    for out, ref, jax_ref in zip(outs, refs, jax_refs):
        _same(np.asarray(out), ref, "stream")
        _same(np.asarray(out), jax_ref, "stream vs JAX")
    meshes = [a for k, n, a in events if (k, n) == ("scheduler", "mesh")]
    assert meshes == [{"mesh": "y=2,x=2", "devices": 4}]


def test_cli_inference_mesh_through_both_clis(monkeypatch):
    """``inference --mesh y=2,x=2`` in both CLIs on one task: the port's
    local-device lister patched to ``[cpu] * 8`` where the JAX suite has
    its 8 virtual devices; bitwise each other and the port's one-device
    run."""
    from tests.test_torch_cli_ops import _tasks, run_both

    monkeypatch.setattr(engine_mod, "local_devices", lambda device: CPU8)
    arr = _traffic_chunk("uint8", seed=9)
    tasks = _tasks()
    for task, make in zip(tasks, (JaxChunk, Chunk)):
        task["chunk"] = make(arr.copy(), voxel_offset=(4, 8, 40),
                             voxel_size=(40, 4, 4))
    args = ["inference", "-f", "identity", "-p", *map(str, PIN), "-v",
            *map(str, OVERLAP), "-c", "3", "-b", "2",
            "--no-crop-output-margin"]
    jax_out, port_out = run_both(args + ["--mesh", "y=2,x=2"], tasks)
    got = port_out[0]["chunk"].host()
    _same(got.array, np.asarray(jax_out[0]["chunk"].array), "CLI")
    assert tuple(got.voxel_offset) == (4, 8, 40)
    _, single = run_both(args, _tasks_with(arr))
    _same(got.array, single[0]["chunk"].host().array, "CLI one device")


def _tasks_with(arr):
    from tests.test_torch_cli_ops import _tasks

    tasks = _tasks()
    for task, make in zip(tasks, (JaxChunk, Chunk)):
        task["chunk"] = make(arr.copy(), voxel_offset=(4, 8, 40),
                             voxel_size=(40, 4, 4))
    return tasks
