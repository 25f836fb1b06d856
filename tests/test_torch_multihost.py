"""The port's multi-process engine against the JAX package, on the CPU.

Two-process ``torch.distributed`` worlds on gloo, each rank driving
``[cpu] * 4``, so the global device list has 8 entries, as the JAX
package's two-process bring-up test has 2 processes x 4 virtual devices
(``tests/parallel/test_multihost_bringup.py``). A module-scoped world
runs its steps in sequence and writes each rank's results to a directory
the tests read: bring-up, the store allgather, the broadcast with its
sentinel (over collectives and over the store), ``sharded_inference_global``
with the identity engine and a small UNet3D (seeded flax params,
``models/convert.py``) under collectives (the psum recipe) and with
``CHUNKFLOW_MULTIHOST_COLLECTIVES=0`` (the guarded local compute),
``Inferencer(sharding="patch")``, and the consistency guard on a permuted
chunk. The results are held against the JAX package in this process on
its 8 CPU devices: the psum recipe within 2e-6 (identity) and 1e-5
(UNet3D) of JAX's ``data=8`` result, the no-collectives leg bitwise. A
second world runs the JAX test's CLI task loop in the port
(``tests/parallel/test_podsim.py``); a third is a rank whose peer never
joins.

Every child gets ``OMP_NUM_THREADS=1`` and a free port on 127.0.0.1,
and imports no JAX.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.flow import runtime
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.parallel import distributed, multihost

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PIN = (4, 16, 16)
OVERLAP = (2, 8, 8)
# the JAX worker's fixture: one seeded 8x32x32 chunk on every rank
CHUNK_SEED = 42
DIVERGENT_SEED = 100
# 27 patches padded to 8 global devices x batch 1: 4 rows a device, 16 a
# rank of four devices
RANK_ROWS = 16
WORLD_S = 180

WORLD_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from chunkflow_tpu_torch.parallel import multihost

pid = {pid}
cfg = json.load(open({cfg!r}))
out = cfg["out"]
cpu = torch.device("cpu")
t0 = time.perf_counter()
multihost.initialize(cfg["coord"], 2, pid, device="cpu",
                     local_devices=[cpu] * 4)
res = dict(
    startup_s=time.perf_counter() - t0,
    rank=multihost.process_index(), count=multihost.process_count(),
    coordinator=multihost.is_coordinator(), backend=multihost.backend(),
    mesh=[[g.process, str(g.device)] for g in multihost.global_mesh()],
    collectives=multihost.backend_supports_collectives())
res["allgather"] = [b.decode() for b in
                    multihost.allgather_bytes(b"proc-%d" % pid)]
res["broadcast"] = [
    multihost.broadcast_string("bbox-task-1" if pid == 0 else None),
    multihost.broadcast_string(None)]
os.environ["CHUNKFLOW_MULTIHOST_COLLECTIVES"] = "0"
res["broadcast_store"] = [
    multihost.broadcast_string("bbox-task-2" if pid == 0 else None),
    multihost.broadcast_string(None)]
res["collectives_off"] = multihost.backend_supports_collectives()
del os.environ["CHUNKFLOW_MULTIHOST_COLLECTIVES"]

from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.models.unet3d import UNet3D
from chunkflow_tpu_torch.ops import accumulate, gather

calls = dict(gather=0, accumulate=0)
for module, name, key in ((gather, "gather_patches", "gather"),
                          (accumulate, "fused_accumulate_patches",
                           "accumulate")):
    def counting(*args, _fn=getattr(module, name), _key=key, **kwargs):
        calls[_key] += 1
        return _fn(*args, **kwargs)
    setattr(module, name, counting)

pin, overlap = tuple(cfg["pin"]), tuple(cfg["overlap"])
chunk = np.load(cfg["chunk"])
model = UNet3D(in_channels=1, out_channels=3,
               feature_maps=tuple(cfg["feats"]),
               down_factors=tuple(map(tuple, cfg["downs"]))).eval()
model.load_state_dict(torch.load(cfg["unet"]))
nets = dict(
    identity=engines.create_identity_engine(pin, pin, 3),
    unet=engines.Engine(apply=model, num_input_channels=1,
                        num_output_channels=3, model=model, params=model,
                        call=lambda m, x: m(x)))
res["calls"] = {{}}
for leg, flag in (("psum", None), ("fallback", "0")):
    if flag is not None:
        os.environ["CHUNKFLOW_MULTIHOST_COLLECTIVES"] = flag
    for name, engine in nets.items():
        for key in calls:
            calls[key] = 0
        with torch.no_grad():
            got = multihost.sharded_inference_global(
                chunk, engine, input_patch_size=pin, output_patch_size=pin,
                output_patch_overlap=overlap, batch_size=1)
        np.save(f"{{out}}/{{leg}}_{{name}}_{{pid}}.npy", got.numpy())
        res["calls"][f"{{leg}} {{name}}"] = dict(calls)
    inferencer = Inferencer(
        input_patch_size=pin, output_patch_overlap=overlap,
        num_output_channels=3, framework="identity", batch_size=1,
        sharding="patch", crop_output_margin=False, device="cpu")
    np.save(f"{{out}}/{{leg}}_inferencer_{{pid}}.npy",
            inferencer(Chunk(chunk)).host().array)
    os.environ.pop("CHUNKFLOW_MULTIHOST_COLLECTIVES", None)

# the guard: a permutation of the same values on rank 1 (equal plain
# sums), over both transports
rng = np.random.default_rng(cfg["divergent_seed"])
divergent = rng.random(chunk.shape).astype(np.float32)
if pid == 1:
    divergent = np.ascontiguousarray(divergent[::-1])
res["guard"] = {{}}
for leg, flag in (("psum", None), ("fallback", "0")):
    if flag is not None:
        os.environ["CHUNKFLOW_MULTIHOST_COLLECTIVES"] = flag
    try:
        multihost.sharded_inference_global(
            divergent, nets["identity"], input_patch_size=pin,
            output_patch_size=pin, output_patch_overlap=overlap,
            batch_size=1)
    except ValueError as exc:
        res["guard"][leg] = str(exc)
    else:
        res["guard"][leg] = None
    os.environ.pop("CHUNKFLOW_MULTIHOST_COLLECTIVES", None)
json.dump(res, open(f"{{out}}/rank{{pid}}.json", "w"))
print("WORKER_OK", pid)
"""

CLI_WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from chunkflow_tpu_torch.parallel import multihost

pid = {pid}
cfg = json.load(open({cfg!r}))
multihost.initialize(cfg["coord"], 2, pid, device="cpu",
                     local_devices=[torch.device("cpu")] * 4)
from chunkflow_tpu_torch.chunk.base import Chunk
from chunkflow_tpu_torch.flow.cli import main
from chunkflow_tpu_torch.parallel import queues

counts = dict(writes=0, acks=0)

def counted(fn, key):
    def call(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)
    return call

Chunk.to_h5 = counted(Chunk.to_h5, "writes")
queues.FileQueue.delete = counted(queues.FileQueue.delete, "acks")
main(["--device", "cpu"] + cfg["argv"])
json.dump(counts, open(cfg["out"] + "/counts%d.json" % pid, "w"))
print("CLIWORKER_OK", pid)
"""

LONE_WORKER = r"""
import sys, time
sys.path.insert(0, {repo!r})
from chunkflow_tpu_torch.parallel import multihost

t0 = time.perf_counter()
try:
    multihost.initialize({coord!r}, 2, 0, device="cpu")
except Exception as exc:
    print("RAISED", type(exc).__name__, time.perf_counter() - t0, exc)
    raise
print("JOINED")
"""

TORCHRUN_WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.parallel import multihost

multihost.initialize(device="cpu", local_devices=[torch.device("cpu")] * 2)
pid = multihost.process_index()
pin, overlap = {pin!r}, {overlap!r}
got = multihost.sharded_inference_global(
    np.load({chunk!r}), engines.create_identity_engine(pin, pin, 3),
    input_patch_size=pin, output_patch_size=pin,
    output_patch_overlap=overlap, batch_size=1)
np.save(os.path.join({out!r}, "torchrun%d.npy" % pid), got.numpy())
json.dump(dict(
    rank=pid, count=multihost.process_count(), backend=multihost.backend(),
    local_rank=os.environ["LOCAL_RANK"],
    mesh=[[g.process, str(g.device)] for g in multihost.global_mesh()],
    allgather=[b.decode() for b in
               multihost.allgather_bytes(b"proc-%d" % pid)],
    broadcast=multihost.broadcast_string("task" if pid == 0 else None)),
    open(os.path.join({out!r}, "torchrun%d.json" % pid), "w"))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("CHUNKFLOW_MULTIHOST_COLLECTIVES", None)
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _run_world(tmp: Path, template: str, cfg: dict, ok: str) -> list:
    """Two ranks of ``template`` against one coordinator; each rank's log,
    after both ended with ``ok``."""
    cfg = dict(cfg, coord=f"127.0.0.1:{_free_port()}")
    cfg_path = tmp / f"{ok}.json"
    cfg_path.write_text(json.dumps(cfg))
    logs = [tmp / f"{ok}{pid}.log" for pid in range(2)]
    procs = []
    for pid in range(2):
        with open(logs[pid], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", template.format(
                    repo=str(ROOT), cfg=str(cfg_path), pid=pid)],
                stdout=log, stderr=subprocess.STDOUT, env=_child_env()))
    try:
        # poll both: a rank that dies must surface its own traceback, not
        # a timeout on the healthy peer blocked in an exchange
        deadline = time.monotonic() + WORLD_S
        pending = dict(enumerate(procs))
        while pending and time.monotonic() < deadline:
            for pid, p in list(pending.items()):
                if p.poll() is not None:
                    text = logs[pid].read_text()
                    assert p.returncode == 0, f"rank {pid} failed:\n{text}"
                    assert f"{ok} {pid}" in text
                    del pending[pid]
            time.sleep(0.1)
        assert not pending, f"ranks {sorted(pending)} timed out"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [log.read_text() for log in logs]


# ---------------------------------------------------------------------------
# the JAX references and the module world
# ---------------------------------------------------------------------------

def _chunk(seed=CHUNK_SEED) -> np.ndarray:
    return np.random.default_rng(seed).random((8, 32, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two-process world's results, the JAX package's ``data=8``
    results and the port's one-device results on the same inputs."""
    import jax

    from chunkflow_tpu.inference import engines as jax_engines
    from chunkflow_tpu.parallel.distributed import (
        sharded_inference as jax_sharded,
    )
    from tests.test_torch_inferencer import DOWNS, FEATS, _unet_engines

    assert len(jax.devices()) == 8
    tmp = tmp_path_factory.mktemp("multihost")
    chunk = _chunk()
    np.save(tmp / "chunk.npy", chunk)
    jax_unet, port_unet = _unet_engines()
    torch.save(port_unet.model.state_dict(), tmp / "unet.pt")
    cfg = dict(out=str(tmp), chunk=str(tmp / "chunk.npy"),
               unet=str(tmp / "unet.pt"), pin=PIN, overlap=OVERLAP,
               feats=FEATS, downs=DOWNS, divergent_seed=DIVERGENT_SEED)
    logs = _run_world(tmp, WORLD_WORKER, cfg, "WORKER_OK")
    jax_identity = jax_engines.create_identity_engine(
        input_patch_size=PIN, output_patch_size=PIN, num_input_channels=1,
        num_output_channels=3)
    ref = {name: np.asarray(jax_sharded(chunk, eng, PIN, PIN, OVERLAP,
                                        batch_size=1))
           for name, eng in (("identity", jax_identity),
                             ("unet", jax_unet))}
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.inference.inferencer import Inferencer

    one = Inferencer(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                     num_output_channels=3, framework="prebuilt",
                     engine=port_unet, batch_size=1,
                     crop_output_margin=False, device="cpu")
    with torch.no_grad():
        one_device = one(Chunk(chunk)).host().array
    ranks = [json.loads((tmp / f"rank{pid}.json").read_text())
             for pid in range(2)]

    def out(leg, name, pid):
        return np.load(tmp / f"{leg}_{name}_{pid}.npy")

    return dict(ranks=ranks, ref=ref, one_device=one_device, out=out,
                chunk=chunk, logs=logs)


def _max_abs(a, b) -> float:
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


# ---------------------------------------------------------------------------
# the world's steps
# ---------------------------------------------------------------------------

def test_bringup_joins_one_world_of_eight_devices(world):
    for pid, res in enumerate(world["ranks"]):
        assert res["rank"] == pid and res["count"] == 2
        assert res["coordinator"] is (pid == 0)
        # gloo on the CPU; the CPU backend all-reduces (unlike XLA's)
        assert res["backend"] == "gloo" and res["collectives"] is True
        assert res["collectives_off"] is False
        assert res["mesh"] == [[p, "cpu"] for p in (0, 1) for _ in range(4)]
        print(f"rank {pid}: start-up {res['startup_s']:.3f} s")


def test_allgather_and_broadcast_with_its_sentinel(world):
    for res in world["ranks"]:
        assert res["allgather"] == ["proc-0", "proc-1"]
        assert res["broadcast"] == ["bbox-task-1", None]
        assert res["broadcast_store"] == ["bbox-task-2", None]


@pytest.mark.parametrize("name, tol", [("identity", 2e-6), ("unet", 1e-5)])
def test_psum_recipe_within_tolerance_of_jax(world, name, tol):
    """The psum recipe against JAX's ``data=8`` (the JAX cross-topology
    gate for identity, the float32 forward's tolerance for the UNet)."""
    ref = world["ref"][name]
    for pid in range(2):
        got = world["out"]("psum", name, pid)
        assert got.shape == ref.shape == (3, 8, 32, 32)
        assert _max_abs(got, ref) <= tol, (name, pid, _max_abs(got, ref))
    if name == "identity":
        np.testing.assert_allclose(
            world["out"]("psum", name, 0),
            np.broadcast_to(world["chunk"], ref.shape), atol=1e-5)
    else:
        assert _max_abs(world["out"]("psum", name, 0),
                        world["one_device"]) <= tol


def test_no_collectives_leg_is_bitwise_one_device(world):
    """``CHUNKFLOW_MULTIHOST_COLLECTIVES=0``: each rank computes over its
    four devices through the mesh engine, bitwise JAX's result for the
    identity engine and bitwise the port's one device for the UNet (whose
    forward is within 1e-5 of XLA's)."""
    for pid in range(2):
        got = world["out"]("fallback", "identity", pid)
        ref = world["ref"]["identity"]
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        unet = world["out"]("fallback", "unet", pid)
        assert np.array_equal(unet, world["one_device"])
        assert _max_abs(unet, world["ref"]["unet"]) <= 1e-5


@pytest.mark.parametrize("leg", ["psum", "fallback"])
def test_replicas_agree_across_ranks(world, leg):
    for name in ("identity", "unet", "inferencer"):
        a, b = world["out"](leg, name, 0), world["out"](leg, name, 1)
        print(f"{leg} {name}: replicas bitwise {np.array_equal(a, b)}")
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        if leg == "fallback":
            assert np.array_equal(a, b)


def test_each_rank_launches_its_share_of_the_plan(world):
    """Under the psum recipe each rank gathers and accumulates its 16
    rows (4 devices x 4 rows at batch 1) of the 32-row padded plan."""
    for res in world["ranks"]:
        for name in ("identity", "unet"):
            assert res["calls"][f"psum {name}"] == dict(
                gather=RANK_ROWS, accumulate=RANK_ROWS)


@pytest.mark.parametrize("leg", ["psum", "fallback"])
def test_inferencer_patch_sharding_spans_the_world(world, leg):
    ref = world["ref"]["identity"]
    for pid in range(2):
        got = world["out"](leg, "inferencer", pid)
        assert got.shape == ref.shape
        assert _max_abs(got, ref) <= 2e-6
        if leg == "fallback":
            assert np.array_equal(got, ref)


@pytest.mark.parametrize("leg", ["psum", "fallback"])
def test_guard_fires_on_both_ranks_for_a_permuted_chunk(world, leg):
    a = _chunk(DIVERGENT_SEED)
    # the plain sums tie: only the strengthened digest tells them apart
    assert multihost._chunk_digest(a)[0] == \
        multihost._chunk_digest(np.ascontiguousarray(a[::-1]))[0]
    for res in world["ranks"]:
        assert res["guard"][leg] is not None
        assert "checksums differ" in res["guard"][leg]


# ---------------------------------------------------------------------------
# the CLI task loop
# ---------------------------------------------------------------------------

def _cli_args(queue_spec, src, outdir):
    return ["fetch-task-from-queue", "-q", queue_spec, "-r", "0",
            "load-h5", "--file-name", src,
            "inference", "--framework", "identity",
            "--input-patch-size", *map(str, PIN),
            "--output-patch-overlap", *map(str, OVERLAP),
            "--num-output-channels", "3", "--no-crop-output-margin",
            "--sharding", "patch",
            "save-h5", "--file-name-prefix", outdir,
            "delete-task-in-queue"]


def test_cli_task_loop_matches_the_jax_cli(tmp_path):
    """The JAX test's task loop in the port: one file queue of 2 tasks,
    coordinator-fetch and broadcast, patch-sharded inference over the
    world (psum recipe), coordinator-only writes and acks; the outputs
    within 2e-6 of the JAX CLI's single-process run."""
    from chunkflow_tpu.chunk.base import Chunk as JaxChunk
    from chunkflow_tpu.core.bbox import BoundingBoxes
    from chunkflow_tpu.flow.cli import main as jax_main
    from chunkflow_tpu.parallel.queues import open_queue

    src = str(tmp_path / "src.h5")
    full = JaxChunk(_chunk(7))
    full.to_h5(src)
    bboxes = BoundingBoxes.from_manual_setup(
        chunk_size=(4, 32, 32), roi_start=(0, 0, 0), roi_stop=(8, 32, 32))
    queue_spec = f"file://{tmp_path / 'queue'}"
    open_queue(queue_spec).send_messages([b.string for b in bboxes])
    outdir = str(tmp_path / "out_port") + "/"
    os.makedirs(outdir)
    _run_world(tmp_path, CLI_WORKER,
               dict(out=str(tmp_path),
                    argv=_cli_args(queue_spec, src, outdir)),
               "CLIWORKER_OK")
    assert len(open_queue(queue_spec)) == 0
    outputs = sorted(os.listdir(outdir))
    assert len(outputs) == 2, outputs
    counts = [json.loads((tmp_path / f"counts{pid}.json").read_text())
              for pid in range(2)]
    assert counts == [dict(writes=2, acks=2), dict(writes=0, acks=0)]

    queue2 = f"file://{tmp_path / 'queue2'}"
    open_queue(queue2).send_messages([b.string for b in bboxes])
    outdir2 = str(tmp_path / "out_jax") + "/"
    os.makedirs(outdir2)
    jax_main(_cli_args(queue2, src, outdir2), standalone_mode=False)
    assert sorted(os.listdir(outdir2)) == outputs
    for name in outputs:
        port = JaxChunk.from_h5(os.path.join(outdir, name))
        ref = JaxChunk.from_h5(os.path.join(outdir2, name))
        a, b = np.asarray(port.array), np.asarray(ref.array)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _max_abs(a, b) <= 2e-6
        assert tuple(port.voxel_offset) == tuple(ref.voxel_offset)


def test_a_peer_that_never_joins_fails_the_bringup_in_time(tmp_path):
    """Rank 0 of a two-rank world alone, with a 2 s exchange timeout:
    ``initialize`` raises, naming the missing rank, within the timeout
    (plus the store's polling), and the process exits non-zero."""
    timeout = 2.0
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", LONE_WORKER.format(
            repo=str(ROOT), coord=f"127.0.0.1:{_free_port()}")],
        capture_output=True, text=True, timeout=60,
        env=_child_env(CHUNKFLOW_MULTIHOST_TIMEOUT_S=str(timeout)))
    wall = time.monotonic() - t0
    assert proc.returncode != 0
    assert "JOINED" not in proc.stdout
    line = next(li for li in proc.stdout.splitlines()
                if li.startswith("RAISED"))
    _, kind, seconds, *_ = line.split()
    assert kind == "TimeoutError" and "rank 1 of 2 did not join" in line
    assert timeout <= float(seconds) <= timeout + 1.0, line
    assert wall < 30


@pytest.mark.parametrize("launch", [
    ["--master-addr", "127.0.0.1", "--master-port", "{port}"],
    ["--rdzv-backend", "c10d", "--rdzv-endpoint", "127.0.0.1:{port}"],
], ids=["static", "c10d"])
def test_torchrun_world_joins_the_agents_store(tmp_path, launch):
    """``torchrun --nproc-per-node 2 worker.py`` with ``initialize()``
    given no coordinator: each rank joins the store torchrun's agent
    already serves at ``MASTER_PORT`` (static and c10d rendezvous), and
    the world runs the exchanges and the psum recipe, the identity oracle
    within 2e-6 of the chunk on both ranks."""
    chunk = _chunk(11)
    np.save(tmp_path / "chunk.npy", chunk)
    script = tmp_path / "worker.py"
    script.write_text(TORCHRUN_WORKER.format(
        repo=str(ROOT), pin=PIN, overlap=OVERLAP,
        chunk=str(tmp_path / "chunk.npy"), out=str(tmp_path)))
    port = str(_free_port())
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc-per-node", "2", "--nnodes", "1",
         *[a.format(port=port) for a in launch], str(script)],
        capture_output=True, text=True, timeout=WORLD_S,
        env=_child_env(CHUNKFLOW_MULTIHOST_TIMEOUT_S="60"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # no rank tried to serve a second store on the agent's port
    assert "failed to bind" not in proc.stderr
    # each rank's own file: the ranks share torchrun's stdout, where
    # their lines may interleave
    for pid in range(2):
        res = json.loads((tmp_path / f"torchrun{pid}.json").read_text())
        assert res == dict(
            rank=pid, count=2, backend="gloo", local_rank=str(pid),
            mesh=[[p, "cpu"] for p in (0, 1) for _ in range(2)],
            allgather=["proc-0", "proc-1"], broadcast="task")
        got = np.load(tmp_path / f"torchrun{pid}.npy")
        assert got.shape == (3,) + chunk.shape
        assert _max_abs(got, np.broadcast_to(chunk, got.shape)) <= 2e-6


@pytest.mark.parametrize("rank", [0, 1])
def test_under_torchrun_every_rank_is_a_client_of_the_agents_store(
        monkeypatch, rank):
    """With ``TORCHELASTIC_USE_AGENT_STORE=True`` rank 0 too joins the
    store at ``MASTER_PORT`` as a client (torchrun's agent serves it),
    its keys under the restart attempt's prefix."""
    import datetime

    import torch.distributed as dist

    agent = dist.TCPStore("127.0.0.1", 0, 2, is_master=True,
                          wait_for_workers=False)
    for name, value in dict(
            TORCHELASTIC_USE_AGENT_STORE="True",
            TORCHELASTIC_RESTART_COUNT="3", MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(agent.port), RANK=str(rank),
            WORLD_SIZE="2").items():
        monkeypatch.setenv(name, value)
    coord, size, got_rank, agent_store = multihost._world_request(
        None, None, None)
    assert (coord, size, got_rank, agent_store) == (
        f"127.0.0.1:{agent.port}", 2, rank, True)
    store = multihost._store(coord, size, rank, agent_store,
                             datetime.timedelta(seconds=5))
    assert isinstance(store, dist.PrefixStore)
    store.set("chunkflow/devices/0", "x")
    assert agent.get("chunkflow/attempt_3/chunkflow/devices/0") == b"x"
    monkeypatch.delenv("TORCHELASTIC_USE_AGENT_STORE")
    assert multihost._world_request(None, None, None)[3] is False


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_single_process_helpers():
    """A world of one (nothing joined): we are the coordinator, the mesh
    is the local devices, every exchange is the identity, the guard a
    no-op (JAX ``test_podsim.py:94``)."""
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_coordinator() is True
    assert multihost.process_device() is None and multihost.backend() is None
    mesh = multihost.global_mesh("cpu")
    assert [g.device for g in mesh] == [torch.device("cpu")]
    assert multihost.backend_supports_collectives() is True
    assert multihost.allgather_bytes(b"x") == [b"x"]
    assert multihost.broadcast_string("task") == "task"
    assert multihost.broadcast_string(None) is None
    multihost.ensure_consistent(_chunk(), None)


def _identity_sharded(n_devices: int):
    """A ``data=<n_devices>`` mesh engine of the identity engine on the
    CPU, as ``engine.sharded_inference`` builds it."""
    from chunkflow_tpu_torch.parallel.engine import MeshSpec, ShardedEngine

    engine = engines.create_identity_engine(PIN, PIN, 3)
    return ShardedEngine(engine.apply, 1, 3, PIN, PIN, 1,
                         MeshSpec("data", (n_devices,)),
                         devices=[torch.device("cpu")] * n_devices,
                         device="cpu")


def test_the_psum_program_in_one_process_is_within_tolerance_of_jax():
    """``prepare_sharded`` + ``run_global`` over ``[cpu] * 8`` in one
    process (no all-reduce): the eight partial buffers summed, within
    2e-6 of JAX's ``data=8``, the identity oracle within 1e-5; the
    program is built once per mesh and kept on the engine."""
    from chunkflow_tpu.inference import engines as jax_engines
    from chunkflow_tpu.parallel.distributed import (
        sharded_inference as jax_sharded,
    )
    from chunkflow_tpu_torch.inference.patching import enumerate_patches

    chunk = _chunk(3)
    mesh = [multihost.GlobalDevice(0, torch.device("cpu"))] * 8
    sharded = _identity_sharded(8)
    grid = enumerate_patches((1,) + chunk.shape, PIN, PIN, OVERLAP)
    program, in_starts, out_starts, valid = distributed.prepare_sharded(
        sharded, grid, mesh)
    assert len(valid) == 32
    assert distributed.prepare_sharded(sharded, grid, mesh)[0] is program
    got = multihost.run_global(program, torch.from_numpy(chunk[None]),
                               in_starts, out_starts, valid, None,
                               mesh).numpy()
    ref = np.asarray(jax_sharded(
        chunk, jax_engines.create_identity_engine(
            input_patch_size=PIN, output_patch_size=PIN,
            num_input_channels=1, num_output_channels=3),
        PIN, PIN, OVERLAP, batch_size=1))
    assert _max_abs(got, ref) <= 2e-6
    np.testing.assert_allclose(got, np.broadcast_to(chunk, got.shape),
                               atol=1e-5)


def _digest_arrays():
    rng = np.random.default_rng(0)
    a = rng.random((4, 8, 8)).astype(np.float32)
    nan = a.copy()
    nan[2, 2, 2] = np.nan
    return {
        "float32": a,
        "permuted": np.ascontiguousarray(a[::-1]),
        "reshaped": a.reshape(8, 4, 8),
        "with_nan": nan,
        "all_nan": np.full((3, 5), np.nan, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "uint8": rng.integers(0, 256, (6, 40, 48), dtype=np.uint8),
        "int64": rng.integers(-9, 9, (300, 200)),
        "float64_large": rng.standard_normal((40, 64, 64)),
    }


@pytest.mark.parametrize("name", list(_digest_arrays()))
def test_chunk_digest_is_the_jax_digest(name):
    from chunkflow_tpu.parallel.multihost import _chunk_digest as jax_digest

    arr = _digest_arrays()[name]
    want = jax_digest(arr)
    for given in (arr, torch.from_numpy(arr)):
        got = multihost._chunk_digest(given)
        assert np.array_equal(np.asarray(got), np.asarray(want),
                              equal_nan=True), (got, want)


def test_chunk_digest_tells_permutations_apart():
    arrays = _digest_arrays()
    a = arrays["float32"]
    assert multihost._chunk_digest(a) != multihost._chunk_digest(
        arrays["permuted"])
    assert multihost._chunk_digest(a) != multihost._chunk_digest(
        arrays["reshaped"])
    c = a.copy()
    c[0, 0, 0] += 0.25
    c[1, 1, 1] -= 0.25
    assert multihost._chunk_digest(a) != multihost._chunk_digest(c)


def test_params_fingerprint_is_the_jax_fingerprint():
    from chunkflow_tpu.parallel.multihost import (
        _params_fingerprint as jax_fingerprint,
    )

    rng = np.random.default_rng(1)
    params = {"dense": {"kernel": rng.random((300, 8), dtype=np.float32),
                        "bias": np.zeros((8,), np.float32)},
              "conv": [rng.random((3, 3, 3, 4, 6)).astype(np.float32)]}
    assert multihost._params_fingerprint(params) == jax_fingerprint(params)


def test_inplace_reload_invalidates_the_params_caches(monkeypatch):
    """Weights reloaded INTO the same module: ``sharded_inference_global``
    rebuilds its kept engine (and with it the device copies of the
    parameters), the guard's digest cache re-digests, and the psum
    program kept on an engine reads the reloaded weights; a stale entry
    would keep serving the old ones (JAX
    ``test_multihost_bringup.py:290``)."""
    from chunkflow_tpu_torch.inference.patching import enumerate_patches
    from chunkflow_tpu_torch.parallel.engine import MeshSpec, ShardedEngine

    cpu = torch.device("cpu")
    model = torch.nn.Conv3d(1, 3, 1)
    engine = engines.Engine(apply=model, num_input_channels=1,
                            num_output_channels=3, model=model,
                            params=model, call=lambda m, x: m(x))
    mesh = [multihost.GlobalDevice(0, cpu)] * 2
    key = multihost._mesh_key(mesh)
    # a joined world of one process driving [cpu] * 2
    monkeypatch.setattr(multihost, "_world", multihost._World(
        None, 0, 1, cpu, [cpu] * 2, "gloo", mesh))
    monkeypatch.setattr(multihost, "_GLOBAL_ENGINES", {})
    chunk = _chunk(5)

    def want():
        with torch.no_grad():
            return model(torch.from_numpy(chunk)[None, None])[0]

    def run_global():
        got = multihost.sharded_inference_global(chunk, engine, PIN, PIN,
                                                 OVERLAP)
        (entry,) = multihost._GLOBAL_ENGINES.values()
        return got, entry

    out0, entry0 = run_global()
    torch.testing.assert_close(out0, want(), atol=1e-5, rtol=1e-5)
    assert run_global()[1] is entry0
    sharded = ShardedEngine(model, 1, 3, PIN, PIN, 1, MeshSpec("data", (2,)),
                            devices=[cpu] * 2, device="cpu")
    grid = enumerate_patches((1,) + chunk.shape, PIN, PIN, OVERLAP)
    program, *plan = distributed.prepare_sharded(sharded, grid, mesh)
    dig0 = multihost._params_digest_cached(model, key)
    fp0 = multihost._PARAMS_DIGEST_CACHE[(id(model), key)][1]
    with torch.no_grad():
        model.weight.add_(1.0)
    out1, entry1 = run_global()
    assert entry1 is not entry0 and entry1[1] != entry0[1]
    assert not torch.equal(out0, out1)
    torch.testing.assert_close(out1, want(), atol=1e-5, rtol=1e-5)
    assert multihost._params_digest_cached(model, key) != dig0
    assert multihost._PARAMS_DIGEST_CACHE[(id(model), key)][1] != fp0
    assert distributed.prepare_sharded(sharded, grid, mesh)[0] is program
    torch.testing.assert_close(
        multihost.run_global(program, torch.from_numpy(chunk[None]), *plan,
                             model, mesh), want(), atol=1e-5, rtol=1e-5)
    assert len(multihost._PARAMS_DIGEST_CACHE) <= multihost._CACHE_MAX


def test_broadcast_frame_raises_the_jax_error():
    from chunkflow_tpu.parallel.multihost import (
        broadcast_string as jax_broadcast,
    )

    with pytest.raises(ValueError) as jax_err:
        jax_broadcast("x" * 600)
    with pytest.raises(ValueError) as port_err:
        multihost.broadcast_string("x" * 600)
    assert str(port_err.value) == str(jax_err.value)
    assert "600 bytes exceeds the 512-byte broadcast frame" in str(
        port_err.value)


def test_slurm_without_a_coordinator_raises_the_jax_error(monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    monkeypatch.delenv("CHUNKFLOW_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="CHUNKFLOW_COORDINATOR"):
        multihost.initialize(device="cpu")
    assert multihost.process_count() == 1


def test_no_world_to_join_raises_naming_what_is_missing(monkeypatch):
    for name in ("SLURM_PROCID", "MASTER_ADDR", "MASTER_PORT", "RANK",
                 "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="MASTER_PORT, RANK, WORLD_SIZE"):
        multihost.initialize(device="cpu")
    assert multihost.process_count() == 1


@pytest.mark.parametrize("value, ms", [(None, 300000), ("2.5", 2500),
                                       ("0.01", 1000), ("bad", 300000)])
def test_exchange_timeout_is_the_jax_timeout(monkeypatch, value, ms):
    from chunkflow_tpu.parallel.multihost import (
        _exchange_timeout_ms as jax_timeout,
    )

    if value is None:
        monkeypatch.delenv("CHUNKFLOW_MULTIHOST_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("CHUNKFLOW_MULTIHOST_TIMEOUT_S", value)
    assert multihost._exchange_timeout_ms() == jax_timeout() == ms


@pytest.mark.parametrize("value, want", [("0", False), ("off", False),
                                         ("1", True), ("yes", True)])
def test_collectives_override_is_read_per_call(monkeypatch, value, want):
    monkeypatch.setenv("CHUNKFLOW_MULTIHOST_COLLECTIVES", value)
    assert multihost.backend_supports_collectives() is want
    monkeypatch.delenv("CHUNKFLOW_MULTIHOST_COLLECTIVES")
    assert multihost.backend_supports_collectives() is True


def test_write_operators_pass_mirror_tasks_through(tmp_path):
    """A mirror task (a peer's copy of the coordinator's task) runs the
    compute but no write: ``save-npy`` leaves it untouched and writes
    nothing."""
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.flow.cli import build_stages

    mirror = runtime.new_task()
    mirror.update(bbox=BoundingBox((0, 0, 0), (2, 4, 4)),
                  replica_mirror=True,
                  chunk=Chunk(np.ones((2, 4, 4), np.float32)))
    assert runtime.is_mirror_task(mirror)
    assert not runtime.is_mirror_task(runtime.new_task())
    assert not runtime.is_mirror_task(None)
    path = tmp_path / "out.npy"
    _, stages = build_stages(["--device", "cpu", "save-npy", "-f",
                              str(path)])
    (stage,) = stages
    out = list(stage(iter([mirror])))
    assert out == [mirror] and not path.exists()
    plain = dict(mirror, replica_mirror=False)
    list(stage(iter([plain])))
    assert path.exists()


@pytest.mark.parametrize("n_local", [1, 3, 4, 8])
@pytest.mark.parametrize("mesh", ["data=4", "data=8", "y=4", "y=2,x=2",
                                  "y=4,x=2", "pipeline=4", "pipeline=8"])
def test_local_spec_clamps_as_jax_does(monkeypatch, mesh, n_local):
    """The no-collectives leg's spec: the mesh clamped to the process's
    local devices, as the JAX engine clamps it."""
    import jax

    from chunkflow_tpu.parallel import engine as jax_engine_mod
    from chunkflow_tpu_torch.parallel import engine as engine_mod

    cpu = torch.device("cpu")
    monkeypatch.setattr(multihost, "local_devices",
                        lambda device="cuda": [cpu] * n_local)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:n_local])
    port = engine_mod.ShardedEngine(
        None, 1, 3, PIN, PIN, 2, engine_mod.parse_mesh_spec(mesh))
    ref = jax_engine_mod.ShardedEngine(
        None, 1, 3, PIN, PIN, 2, jax_engine_mod.parse_mesh_spec(mesh))
    got, want = port._local_spec(), ref._local_spec()
    assert (got.kind, tuple(got.shape)) == (want.kind, tuple(want.shape))


def _fetch_stage(argv):
    from chunkflow_tpu_torch.flow.cli import build_stages

    _, (stage,) = build_stages(["--device", "cpu", "fetch-task-from-queue",
                                *argv])
    return stage(iter([runtime.new_task()]))


def test_the_coordinator_broadcasts_each_task_then_the_sentinel(
        monkeypatch, tmp_path, capsys):
    """In a world of two, the coordinator broadcasts each body before it
    yields the task and the sentinel on every exit path (the ``--num``
    budget spent, the generator closed); supervision options print the
    JAX warning and run unsupervised."""
    from chunkflow_tpu_torch.parallel.queues import open_queue

    sent = []
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "is_coordinator", lambda: True)
    monkeypatch.setattr(multihost, "broadcast_string",
                        lambda s=None, max_len=512: sent.append(s))
    spec = f"file://{tmp_path / 'queue'}"
    boxes = [BoundingBox((0, 0, 8 * i), (2, 4, 8 * i + 8)).string
             for i in range(3)]
    open_queue(spec).send_messages(boxes)
    tasks = list(_fetch_stage(["-q", spec, "-r", "0", "--num", "2",
                               "--max-retries", "3"]))
    assert [t["task_body"] for t in tasks] == sent[:2]
    assert sent[2] is None and len(sent) == 3
    assert all(not runtime.is_mirror_task(t) for t in tasks)
    assert "lifecycle supervision does not compose" in \
        capsys.readouterr().err
    sent.clear()
    stream = _fetch_stage(["-q", spec, "-r", "0"])
    first = next(stream)
    stream.close()
    assert sent == [first["task_body"], None]


def test_a_peer_runs_mirror_tasks_until_the_sentinel(monkeypatch,
                                                     tmp_path):
    """A non-coordinator never opens the queue: it receives each body and
    yields a mirror task until the sentinel."""
    bodies = iter([BoundingBox((0, 0, 0), (2, 4, 8)).string,
                   BoundingBox((0, 0, 8), (2, 4, 16)).string, None])
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "is_coordinator", lambda: False)
    monkeypatch.setattr(multihost, "broadcast_string",
                        lambda s=None, max_len=512: next(bodies))
    missing = tmp_path / "no-queue"
    tasks = list(_fetch_stage(["-q", f"file://{missing}", "-r", "0"]))
    assert [t["bbox"].string for t in tasks] == [
        "0-2_0-4_0-8", "0-2_0-4_8-16"]
    assert all(runtime.is_mirror_task(t) and "queue" not in t
               for t in tasks)
    assert not missing.exists()
