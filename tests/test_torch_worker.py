"""The queue-fed volume worker end to end on the CPU, port against JAX.

One command line, the one every worker of a fleet runs::

    generate-tasks --volume-path OUT --queue-name file://Q
    fetch-task-from-queue -q file://Q --max-retries 3 --ledger L
        | load-precomputed -v IN -e MARGIN
        | inference ... --output-crop-margin MARGIN --async-depth 2
        | save-precomputed -v OUT --async-write | delete-task-in-queue

runs through the port's CLI (``--device cpu``) and the JAX package's on
the same input volume and weights. The output volumes are equal: the
identity engine bitwise (the same files), a small UNet3D (flax ``.msgpack``
weights for the JAX package, carried across to a ``.pt`` state dict by
``models/convert.py``) within 1e-5; under the adaptive and the static
executor. Under a chaos plan that kills every stage boundary once, the
port's output is bitwise the fault-free run's, every task is acked once
(the workers' event files), the queue ends empty and the ledger holds
every task.
"""
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("tensorstore")

from click.testing import CliRunner

from chunkflow_tpu.flow.cli import main as jax_main
from chunkflow_tpu.models import unet3d as flax_unet3d
from chunkflow_tpu.parallel.queues import QueueBase as JaxQueueBase
from chunkflow_tpu.volume import storage as jax_storage
from chunkflow_tpu.volume.precomputed import PrecomputedVolume as JaxVolume
from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
from chunkflow_tpu_torch import BoundingBox, Chunk
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.models.convert import state_from_flax
from chunkflow_tpu_torch.parallel.lifecycle import FileLedger
from chunkflow_tpu_torch.parallel.queues import open_queue
from chunkflow_tpu_torch.testing import chaos
from chunkflow_tpu_torch.volume import storage
from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume
from tests.test_torch_models import DOWNS, FEATS, draw_params

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

IN_SIZE = (20, 80, 80)
ROI = ((2, 8, 8), (16, 64, 64))   # the output volume: 8 tasks
TASK = (8, 32, 32)
MARGIN = ("2", "8", "8")
PIN, OVERLAP = ("4", "16", "16"), ("2", "8", "8")
OUT = BoundingBox(ROI[0], tuple(a + b for a, b in zip(*ROI)))
# the boundaries of this worker: ``inference --async-depth 2`` is a
# streamed stage, not a runtime operator, so ``op/inference`` is not one
# (in either package)
EVERY_BOUNDARY = ("lifecycle/claim", "op/load-precomputed",
                  "op/save-precomputed", "lifecycle/pre_ledger",
                  "lifecycle/pre_ack")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for var in ("CHUNKFLOW_CHAOS", "CHUNKFLOW_SCHED", "CHUNKFLOW_TELEMETRY",
                "CHUNKFLOW_STORAGE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(JaxQueueBase, "retry_sleep", 0.02)
    chaos.reset()
    telemetry.reset()
    storage.reset_shared_cache()
    jax_storage.reset_shared_cache()
    yield
    chaos.reset()


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """A seeded uint8 input volume, written by the port."""
    path = str(tmp_path_factory.mktemp("image") / "image")
    data = np.random.default_rng(5).integers(0, 256, IN_SIZE, dtype=np.uint8)
    PrecomputedVolume.create(path, volume_size=IN_SIZE, voxel_size=(40, 4, 4),
                             block_size=(8, 32, 32))
    PrecomputedVolume(path).save(Chunk(data))
    return path


@pytest.fixture(scope="module")
def unet_files(tmp_path_factory):
    """A small UNet3D: a ``create_model`` file per package, flax .msgpack
    weights for the JAX package and their ``state_from_flax`` .pt for the
    port."""
    tmp = tmp_path_factory.mktemp("unet")
    make = ("def create_model(ci, co):\n"
            f"    return UNet3D(ci, co, feature_maps={FEATS}, "
            f"down_factors={DOWNS})\n")
    (tmp / "jax_model.py").write_text(
        "from chunkflow_tpu.models.unet3d import UNet3D\n" + make)
    (tmp / "port_model.py").write_text(
        "from chunkflow_tpu_torch.models.unet3d import UNet3D\n" + make)
    fnet = flax_unet3d.UNet3D(1, 3, feature_maps=FEATS, down_factors=DOWNS)
    params = draw_params(fnet, tuple(map(int, PIN)), seed=7)
    msgpack = flax_unet3d.save_params(params, str(tmp / "w.msgpack"))
    pt = str(tmp / "w.pt")
    torch.save(state_from_flax(jax_tree(params)), pt)
    return {"jax": ["-m", str(tmp / "jax_model.py"), "-w", msgpack],
            "port": ["-m", str(tmp / "port_model.py"), "-w", pt]}


def jax_tree(params):
    """A flax param tree as nested dicts of numpy arrays."""
    if hasattr(params, "items"):
        return {k: jax_tree(v) for k, v in params.items()}
    return np.asarray(params)


def _commands(tmp, tag, image, engine, extra=(), before=(), after=(),
              retries="3"):
    out, queue = str(tmp / f"out-{tag}"), f"file://{tmp / f'q-{tag}'}"
    ledger = str(tmp / f"ledger-{tag}")
    setup = [
        ["create-info", "-v", out, "-s", *map(str, ROI[1]),
         "--voxel-size", "40", "4", "4", "--voxel-offset", *map(str, ROI[0]),
         "-c", "3", "--dtype", "float32", "--block-size", "8", "32", "32"],
        ["generate-tasks", "--volume-path", out, "-c", *map(str, TASK),
         "--queue-name", queue]]
    worker = [
        "fetch-task-from-queue", "-q", queue, "--max-retries", retries,
        "--ledger", ledger, "-r", "100", "--poll-interval", "0.02",
        "--backoff-base", "0.5", "--backoff-cap", "1",
        "load-precomputed", "-v", image, "-e", *MARGIN, *before,
        "inference", *engine, "-p", *PIN, "-v", *OVERLAP, "-c", "3",
        "-b", "2", "--output-crop-margin", *MARGIN, "--async-depth", "2",
        *after, "save-precomputed", "-v", out, "--async-write",
        "delete-task-in-queue", *extra]
    return setup, worker, out, queue, ledger


def _port(args):
    assert cli.main(["--device", "cpu", *args]) == 0


def _jax(args):
    result = CliRunner().invoke(jax_main, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output


def _run(tmp, tag, image, engine, runner, metrics=None, **stages):
    setup, worker, out, queue, ledger = _commands(tmp, tag, image, engine,
                                                  **stages)
    for args in setup:
        runner(args)
    if metrics is not None:
        worker = ["--metrics-dir", metrics] + worker
    runner(worker)
    return out, queue, ledger


def _blocks(path):
    scale = os.path.join(path, "4_4_40")
    return {name: open(os.path.join(scale, name), "rb").read()
            for name in os.listdir(scale)}


@pytest.mark.parametrize("sched", ["adaptive", "static"])
@pytest.mark.parametrize("engine", ["identity", "unet3d"])
def test_the_worker_writes_the_jax_workers_volume(tmp_path, monkeypatch,
                                                  image, unet_files, engine,
                                                  sched):
    monkeypatch.setenv("CHUNKFLOW_SCHED", sched)
    engines = ({"jax": ["-f", "identity"], "port": ["-f", "identity"]}
               if engine == "identity" else
               {k: ["-f", "flax", *v] for k, v in unet_files.items()})
    port_out, port_q, _ = _run(tmp_path, "port", image, engines["port"],
                               _port)
    jax_out, _, _ = _run(tmp_path, "jax", image, engines["jax"], _jax)
    assert open_queue(port_q).stats() == {"pending": 0, "inflight": 0,
                                          "dead": 0, "receives": 0}
    got = PrecomputedVolume(port_out).cutout(OUT).array
    jax_storage.reset_shared_cache()
    want = np.asarray(JaxVolume(jax_out).cutout(
        JaxBox(tuple(OUT.start), tuple(OUT.stop))).array)
    assert got.shape == (3,) + ROI[1] and want.std() > 0.01
    if engine == "identity":
        assert np.array_equal(got, want)
        assert _blocks(port_out) == _blocks(jax_out)
        raw = PrecomputedVolume(image).cutout(OUT).array
        assert np.abs(got - raw[None] / 255.0).max() < 1e-6
    else:
        assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("sched, points", [
    ("adaptive", EVERY_BOUNDARY),
    ("static", EVERY_BOUNDARY),
    ("adaptive", EVERY_BOUNDARY + ("scheduler/dispatch", "scheduler/post")),
], ids=["adaptive", "static", "adaptive-scheduler"])
def test_chaos_at_every_boundary_converges_bitwise(tmp_path, monkeypatch,
                                                   image, sched, points):
    """Each boundary fails once. The retry backoff runs without its
    jitter here (its ceiling, 0.5 s then 1 s): a retried task comes back
    after the other tasks have met the remaining faults, where a near-zero
    draw could bring one task back into three of them and, under
    ``--max-retries 3``, dead-letter it."""
    from chunkflow_tpu_torch.parallel import lifecycle

    monkeypatch.setenv("CHUNKFLOW_SCHED", sched)
    monkeypatch.setattr(lifecycle, "backoff_delay",
                        lambda attempt, base, cap, rng=None:
                        min(cap, base * 2 ** (attempt - 1)))
    engine = ["-f", "identity"]
    clean_out, _, _ = _run(tmp_path, "clean", image, engine, _port)
    chaos.configure("once=" + ",".join(points))
    metrics = str(tmp_path / "events")
    out, queue, ledger = _run(tmp_path, "chaos", image, engine, _port,
                              metrics=metrics)
    assert chaos.injections() == {point: 1 for point in points}
    chaos.reset()
    assert _blocks(out) == _blocks(clean_out)
    bodies = sorted(b.string for b in (
        BoundingBox(s, t) for s, t in _task_corners()))
    assert FileLedger(ledger).keys() == bodies
    assert open_queue(queue).stats() == {"pending": 0, "inflight": 0,
                                         "dead": 0, "receives": 0}
    acks = {body: 0 for body in bodies}
    for name in os.listdir(metrics):
        if not name.endswith(".jsonl"):
            continue  # programs.json, the cost ledger's catalog
        with open(os.path.join(metrics, name)) as f:
            for line in f:
                event = json.loads(line)
                if event.get("name") in ("lifecycle/committed",
                                         "lifecycle/ledger_skip"):
                    acks[event["body"]] += 1
    assert acks == {body: 1 for body in bodies}
    counters = telemetry.snapshot()["counters"]
    assert counters.get("ledger/skips", 0) == 1  # the pre_ack kill
    assert counters["pipeline/chain_rebuilds"] >= 3


def _events(metrics):
    """(per-body claim receive counts, per-body acks, dead-lettered bodies)
    from a worker's telemetry event files."""
    claims, acks, dead = {}, {}, []
    for name in os.listdir(metrics):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(metrics, name)) as f:
            for line in f:
                event = json.loads(line)
                body = event.get("body")
                if event.get("name") == "lifecycle/claimed":
                    claims.setdefault(body, []).append(event["receives"])
                elif event.get("name") in ("lifecycle/committed",
                                       "lifecycle/ledger_skip"):
                    acks[body] = acks.get(body, 0) + 1
                elif event.get("name") == "lifecycle/dead_letter":
                    dead.append(body)
    return claims, acks, sorted(dead)


@pytest.mark.parametrize("plan", [
    "once=lifecycle/claim,op/inference",
    # the third claim fails (seeded draws 0.96, 0.95, 0.06)
    "once=op/inference:seed=4:rate=0.3:points=lifecycle/claim:max=1",
], ids=["first-claim", "third-claim"])
def test_chaos_plan_settles_as_in_the_jax_package(tmp_path, monkeypatch,
                                                  image, plan):
    """One CHUNKFLOW_CHAOS plan through both CLIs under ``--async-depth 2
    --max-retries 2``: the same faults fire (``op/inference`` is no chaos
    point of a streamed stage in either package), the same receive
    counts per task (which task a file queue hands out first differs, so
    they are compared as a multiset), no dead letters, each task acked
    once, and the same output volume. A fault at ``lifecycle/claim`` is
    raised untagged in both, so every task in flight is charged: here
    only the claimed one, since the executor first finishes the tasks it
    dispatched."""
    from chunkflow_tpu.testing import chaos as jax_chaos
    from chunkflow_tpu.parallel import lifecycle as jax_lifecycle
    from chunkflow_tpu_torch.parallel import lifecycle

    def fixed(attempt, base, cap, rng=None):
        return min(cap, base * 2 ** (attempt - 1))

    monkeypatch.setattr(lifecycle, "backoff_delay", fixed)
    monkeypatch.setattr(jax_lifecycle, "backoff_delay", fixed)
    runs = {}
    for tag, runner, module in (("port", _port, chaos),
                                ("jax", _jax, jax_chaos)):
        module.configure(plan)
        metrics = str(tmp_path / f"events-{tag}")
        try:
            out, _, _ = _run(tmp_path, tag, image, ["-f", "identity"],
                             runner, metrics=metrics, retries="2")
            injected = module.injections()
        finally:
            module.reset()
        runs[tag] = (injected, _events(metrics), out)
    (p_inj, (p_claims, p_acks, p_dead), p_out) = runs["port"]
    (j_inj, (j_claims, j_acks, j_dead), j_out) = runs["jax"]
    assert p_inj == j_inj == {"lifecycle/claim": 1}
    assert sorted(p_claims.values()) == sorted(j_claims.values())
    assert sorted(p_claims.values()).count([1, 2]) == 1
    assert p_dead == j_dead == []
    assert set(p_acks.values()) == set(j_acks.values()) == {1}
    assert len(p_acks) == len(j_acks) == 8
    assert _blocks(p_out) == _blocks(j_out)


def _mask_volume(tmp):
    """A seeded uint8 mask at 40x64x64 nm (a 1x16x16 factor over the
    image's 40x4x4 nm) with zeroed blocks; the tasks start at y, x = 8
    and 40, off the coarse grid."""
    path = str(tmp / "mask")
    shape = (IN_SIZE[0], IN_SIZE[1] // 16, IN_SIZE[2] // 16)
    mask = (np.random.default_rng(6).random(shape) > 0.3).astype(np.uint8)
    mask[:6, :2, :] = 0
    PrecomputedVolume.create(path, volume_size=shape, voxel_size=(40, 64, 64),
                             block_size=(8, 4, 4))
    PrecomputedVolume(path).save(Chunk(mask, voxel_size=(40, 64, 64)))
    return path


@pytest.mark.parametrize("sched", ["adaptive", "static"])
def test_the_worker_with_normalize_and_mask_stages(tmp_path, monkeypatch,
                                                   image, sched):
    """The README's worker chain: a ``normalize-contrast`` stage before
    inference and a ``mask`` stage after it (a coarser mask volume, task
    starts off its grid), identity engine: the port's output volume is
    the JAX CLI's, byte for byte."""
    monkeypatch.setenv("CHUNKFLOW_SCHED", sched)
    mask = _mask_volume(tmp_path)
    stages = dict(before=("normalize-contrast",), after=("mask", "-v", mask))
    port_out, port_q, _ = _run(tmp_path, "port", image, ["-f", "identity"],
                               _port, **stages)
    jax_out, _, _ = _run(tmp_path, "jax", image, ["-f", "identity"], _jax,
                         **stages)
    assert open_queue(port_q).stats() == {"pending": 0, "inflight": 0,
                                          "dead": 0, "receives": 0}
    assert _blocks(port_out) == _blocks(jax_out)
    got = PrecomputedVolume(port_out).cutout(OUT).array
    assert (got == 0).mean() > 0.2 and got.std() > 0.01


def _task_corners():
    start, size = ROI
    for z in range(start[0], start[0] + size[0], TASK[0]):
        for y in range(start[1], start[1] + size[1], TASK[1]):
            for x in range(start[2], start[2] + size[2], TASK[2]):
                yield (z, y, x), (z + TASK[0], y + TASK[1], x + TASK[2])


def test_setup_env_plans_as_the_jax_package(tmp_path, capsys):
    """setup-env: the same plan, volume info and task grid as the JAX
    command, into a queue."""
    def fill(tag):
        return ["setup-env", "--volume-start", "0", "0", "0",
                "--volume-size", "64", "512", "512",
                "-l", str(tmp_path / f"vol-{tag}"),
                "-z", "20", "256", "256", "--output-patch-overlap", "4", "64",
                "64", "--max-ram-size", "0.3", "--max-mip", "2",
                "--thumbnail-mip", "2", "--overwrite-info",
                "-q", f"file://{tmp_path / f'q-{tag}'}"]

    _port(fill("port"))
    port_plan = capsys.readouterr().out
    result = CliRunner().invoke(jax_main, fill("jax"),
                                catch_exceptions=False)
    assert result.exit_code == 0
    assert port_plan.replace("port", "jax") == result.output
    for sub in ("", "thumbnail"):
        port = json.load(open(tmp_path / "vol-port" / sub / "info"))
        jax = json.load(open(tmp_path / "vol-jax" / sub / "info"))
        assert port == jax
    port_q, jax_q = (open_queue(f"file://{tmp_path / f'q-{t}'}")
                     for t in ("port", "jax"))
    bodies = []
    for q in (port_q, jax_q):
        q.max_empty_retries = 0
        bodies.append(sorted(body for _, body in q))
    assert bodies[0] == bodies[1] and len(bodies[0]) > 1
