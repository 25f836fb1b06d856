"""Multi-process bring-up on ``torch.distributed``: one inference and one
task stream spanning processes.

The counterpart of ``chunkflow_tpu/parallel/multihost.py``, with its
names. chunkflow's workers never talk to each other: they share a task
queue and object storage. When one inference spans processes (ranks on
the cards of one node, or nodes of a cluster), the processes form one
``torch.distributed`` world:

- :func:`initialize` joins it. The coordination store is a
  ``torch.distributed.TCPStore`` at the coordinator address, served by
  rank 0 (under torchrun, by torchrun's agent), and the process group
  runs on that store. The backend follows one rule: ``nccl`` when every
  rank has a card of its own, ``gloo`` on the CPU and when ranks share a
  card.
- the psum recipe (``parallel/distributed.py``) runs the patch-parallel
  program over the global device list: each rank blends its share of
  the patches and ``all_reduce`` sums the partial buffers, where the JAX
  program runs ``lax.psum``.
- the task loop (``fetch-task-from-queue``) is single-sourced: only the
  coordinator touches the queue and :func:`broadcast_string` hands each
  task to the peers, which run mirror tasks that neither write nor ack
  (``flow/runtime.is_mirror_task``).

Every cross-process exchange has two transports, chosen by
:func:`backend_supports_collectives`: collectives of the process group on
the rank's device, or the store's keys in the JAX key layout (the
fallback the JAX package runs on its CPU backend). Without collectives
:func:`sharded_inference_global` checks the consistency guard and then
computes over the rank's local devices through the mesh engine, bitwise
one device on every rank.

A failed bring-up, a missing peer or an exchange that times out
(``CHUNKFLOW_MULTIHOST_TIMEOUT_S``) raises: nothing here carries on as a
world of one.
"""
from __future__ import annotations

import atexit
import base64
import datetime
import itertools
import json
import os
import socket
import warnings
import zlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.device import resolve_device

__all__ = [
    "GlobalDevice", "initialize", "process_count", "process_index",
    "process_device", "local_devices", "global_mesh", "is_coordinator",
    "backend", "backend_supports_collectives", "allgather_bytes",
    "broadcast_string", "ensure_consistent", "run_global",
    "sharded_inference_global",
]

# the torchrun variables a rank reads when it is given no coordinator
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

# Host-side collective sequence numbers: every process calls the same
# collectives in the same order (they are collectives), so per-process
# counters stay aligned and key names never collide across calls.
_ALLGATHER_SEQ = itertools.count()
_BCAST_SEQ = itertools.count()


class GlobalDevice(NamedTuple):
    """One entry of the global device list: the rank that drives it and
    the device on that rank."""

    process: int
    device: torch.device


class _World:
    """The joined world: the store, this rank, its devices, the backend
    and the global device list (rank-major)."""

    def __init__(self, store, rank: int, size: int, device: torch.device,
                 local: List[torch.device], backend: str,
                 devices: List[GlobalDevice]):
        self.store = store
        self.rank = rank
        self.size = size
        self.device = device
        self.local = local
        self.backend = backend
        self.devices = devices


_world: Optional[_World] = None


def _exchange_timeout_ms() -> int:
    """Exchange timeout (seconds via ``CHUNKFLOW_MULTIHOST_TIMEOUT_S``,
    default 300, at least 1 s — a peer that died before publishing its
    key should fail the exchange loudly, not hang the fleet forever)."""
    try:
        s = float(os.environ.get("CHUNKFLOW_MULTIHOST_TIMEOUT_S", "300"))
    except ValueError:
        s = 300.0
    return max(1000, int(s * 1000))


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(milliseconds=_exchange_timeout_ms())


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------

def _local_rank(rank: int) -> int:
    """The card of this rank: ``LOCAL_RANK`` or ``SLURM_LOCALID``, else
    the rank modulo the card count (ranks then share cards
    round-robin)."""
    for name in ("LOCAL_RANK", "SLURM_LOCALID"):
        if name in os.environ:
            value = int(os.environ[name])
            if value >= torch.cuda.device_count():
                raise ValueError(
                    f"{name}={value}, but this host has "
                    f"{torch.cuda.device_count()} card(s)")
            return value
    return rank % torch.cuda.device_count()


def _world_request(coordinator_address, num_processes, process_id):
    """(coordinator, world size, rank, whether torchrun's agent serves
    the store) from the arguments, SLURM or the torchrun variables;
    raises naming what is missing."""
    agent_store = False
    if coordinator_address is None and "SLURM_PROCID" in os.environ:
        process_id = int(os.environ["SLURM_PROCID"])
        num_processes = int(os.environ["SLURM_NTASKS"])
        coordinator_address = os.environ.get("CHUNKFLOW_COORDINATOR")
        if coordinator_address is None:
            raise ValueError(
                "SLURM bring-up needs a coordinator: set "
                "CHUNKFLOW_COORDINATOR=<host:port> (reachable from every "
                "task) or pass coordinator_address explicitly"
            )
    if coordinator_address is None:
        missing = [name for name in _TORCHRUN if name not in os.environ]
        if missing:
            raise ValueError(
                f"multihost.initialize() found no world to join: pass "
                f"coordinator_address, num_processes and process_id, run "
                f"under SLURM with CHUNKFLOW_COORDINATOR, or set the "
                f"torchrun variables (missing: {', '.join(missing)})")
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        # torchrun's agent already serves a store at MASTER_PORT and says
        # so to its workers, which then join it as clients
        agent_store = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") \
            == str(True)
    if num_processes is None or process_id is None:
        raise ValueError(
            "multihost.initialize() needs num_processes and process_id "
            "with a coordinator_address")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is outside a world of "
                         f"{num_processes}")
    return (coordinator_address, int(num_processes), int(process_id),
            agent_store)


def _store(coordinator_address: str, size: int, rank: int,
           agent_store: bool, timeout: datetime.timedelta):
    """The coordination store: served by rank 0 at the coordinator
    address, or, under torchrun, the agent's store joined as a client,
    its keys prefixed by the restart attempt so that a restarted world
    never reads the keys of the one before."""
    host, port = coordinator_address.rsplit(":", 1)
    if not agent_store:
        return dist.TCPStore(host, int(port), size, is_master=rank == 0,
                             timeout=timeout, wait_for_workers=False)
    store = dist.TCPStore(host, int(port), size, is_master=False,
                          timeout=timeout)
    attempt = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0")
    return dist.PrefixStore(f"chunkflow/attempt_{attempt}", store)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    local_devices: Optional[list] = None,
) -> None:
    """Join the multi-process world (idempotent).

    With no arguments it reads SLURM (``SLURM_PROCID``, ``SLURM_NTASKS``
    and ``CHUNKFLOW_COORDINATOR``) or the torchrun variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``), and raises naming what is missing. Rank 0 serves the
    coordination store at ``coordinator_address`` (``host:port``); under
    torchrun every rank joins the store its agent serves there. Every
    rank waits for the whole world, up to the exchange timeout.

    ``device`` is the rank's device: by default the card ``cuda:<local
    rank>`` (``device="cpu"`` runs on the CPU, as the tests do).
    ``local_devices`` are the devices the rank drives (default
    ``[device]``; they may repeat one device, as the mesh engine allows).
    The backend is ``nccl`` when the device is a card that no other rank
    of the world uses, else ``gloo``."""
    global _world
    if _world is not None:
        return
    coordinator_address, size, rank, agent_store = _world_request(
        coordinator_address, num_processes, process_id)
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _local_rank(rank))
    local = [torch.device(d) for d in (local_devices or [device])]
    timeout = _timeout()
    store = _store(coordinator_address, size, rank, agent_store, timeout)
    # the rendezvous: every rank's host, device and local devices (the
    # backend rule and the global device list); a rank that does not
    # publish within the timeout fails the bring-up, naming it
    store.set(f"chunkflow/devices/{rank}", json.dumps({
        "host": socket.gethostname(), "device": str(device),
        "local": [str(d) for d in local]}))
    ranks = []
    for r in range(size):
        key = f"chunkflow/devices/{r}"
        try:
            store.wait([key], timeout)
        except dist.DistStoreError as exc:
            raise TimeoutError(
                f"multihost.initialize: rank {r} of {size} did not join "
                f"within {timeout.total_seconds():g} s "
                f"(CHUNKFLOW_MULTIHOST_TIMEOUT_S)") from exc
        ranks.append(json.loads(store.get(key)))
    cards = [(r["host"], r["device"]) for r in ranks]
    own_card = (all(d.startswith("cuda") for _, d in cards)
                and len(set(cards)) == len(cards))
    backend_name = "nccl" if own_card else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_name, store=store, rank=rank,
                            world_size=size, timeout=timeout)
    devices = [GlobalDevice(r, torch.device(d))
               for r, info in enumerate(ranks) for d in info["local"]]
    _world = _World(store, rank, size, device, local, backend_name, devices)
    atexit.register(_shutdown)
    telemetry.event("multihost", "initialize", backend=backend_name,
                    rank=rank, world=size, device=str(device),
                    local_devices=len(local), global_devices=len(devices))


def _shutdown() -> None:
    """Leave the world at exit: the process group's threads are joined
    here, not torn down with the interpreter (which can abort a rank
    whose work had ended)."""
    global _world
    if _world is not None and dist.is_initialized():
        dist.destroy_process_group()
    _world = None


def _require_world() -> _World:
    if _world is None:
        raise RuntimeError(
            "torch.distributed is not initialized in this process; call "
            "multihost.initialize() first"
        )
    return _world


def process_count() -> int:
    return _world.size if _world is not None else 1


def process_index() -> int:
    return _world.rank if _world is not None else 0


def process_device() -> Optional[torch.device]:
    """This rank's device, or None outside a world."""
    return _world.device if _world is not None else None


def backend() -> Optional[str]:
    """The process group's backend (``nccl`` or ``gloo``), or None
    outside a world."""
    return _world.backend if _world is not None else None


def local_devices(device="cuda") -> List[torch.device]:
    """The devices this rank drives; outside a world, the local devices
    of ``device`` (every card, or ``[cpu]``)."""
    if _world is not None:
        return list(_world.local)
    from chunkflow_tpu_torch.parallel.engine import local_devices as local

    return local(resolve_device(device))


def global_mesh(device="cuda") -> List[GlobalDevice]:
    """Every device of every rank, rank-major (each rank's local devices
    in order), as JAX orders ``jax.devices()``."""
    if _world is not None:
        return list(_world.devices)
    return [GlobalDevice(0, d) for d in local_devices(device)]


def is_coordinator() -> bool:
    return process_index() == 0


def backend_supports_collectives() -> bool:
    """Whether cross-process exchanges run as collectives of the process
    group on this rank's device (else they ride the store):
    ``CHUNKFLOW_MULTIHOST_COLLECTIVES=0/1`` overrides, re-read on every
    call; otherwise True: the backend rule only picks a backend that
    all-reduces and broadcasts on the rank's device (gloo on the CPU and
    on cards, NCCL on cards).

    The answer differs from the JAX package's on the CPU: XLA's CPU
    backend cannot run one computation across processes, so JAX answers
    False there, while gloo all-reduces CPU tensors. The JAX answer's
    leg is ``CHUNKFLOW_MULTIHOST_COLLECTIVES=0``."""
    override = os.environ.get("CHUNKFLOW_MULTIHOST_COLLECTIVES", "")
    if override:
        return override.lower() not in ("0", "off", "false", "no")
    return True


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

def _store_get(key: str) -> bytes:
    """A blocking get that times out after the exchange timeout."""
    store = _require_world().store
    store.wait([key], _timeout())
    return store.get(key)


def allgather_bytes(payload: bytes) -> list:
    """Host-side allgather through the store: every process contributes
    ``payload`` and receives the list of all processes' payloads, index
    == process id. Values ride the store base64-encoded under
    ``chunkflow/allgather/<seq>/<rank>``; a missing peer fails the
    exchange after the timeout instead of wedging."""
    if process_count() <= 1:
        return [bytes(payload)]
    world = _require_world()
    seq = next(_ALLGATHER_SEQ)
    prefix = f"chunkflow/allgather/{seq}"
    world.store.set(f"{prefix}/{world.rank}",
                    base64.b64encode(bytes(payload)).decode("ascii"))
    return [base64.b64decode(_store_get(f"{prefix}/{p}"))
            for p in range(world.size)]


def _allgather_digest(digest):
    """Allgather one float64 digest row per process: an ``all_reduce`` of
    the rows (each process fills its own, zeros elsewhere: exact) when
    the backend has collectives, the store's byte exchange when it does
    not. Returns [n_processes, len(digest)]."""
    digest = np.asarray(digest, np.float64)
    if backend_supports_collectives():
        world = _require_world()
        rows = torch.zeros((world.size, digest.size), dtype=torch.float64,
                           device=world.device)
        rows[world.rank] = torch.from_numpy(digest).to(world.device)
        dist.all_reduce(rows)
        return rows.cpu().numpy()
    rows = allgather_bytes(digest.tobytes())
    return np.stack([np.frombuffer(r, np.float64) for r in rows])


def broadcast_string(s: Optional[str] = None, max_len: int = 512):
    """Collective: the coordinator's string reaches every process.

    The cross-process task loop's distribution primitive: the coordinator
    pulls bbox tasks from the queue and broadcasts each body here (None
    broadcasts a stop sentinel); non-coordinators pass anything (their
    value is ignored) and receive. Every process must call this the same
    number of times. With collectives the frame is the JAX one,
    ``int32[2 + max_len]`` (flag, length, bytes), broadcast on the rank's
    device; without, the coordinator publishes ``chunkflow/broadcast/<seq>``
    (``N`` for the sentinel) and every peer's blocking get is the
    rendezvous."""
    if s is not None:
        data = s.encode("utf-8")
        if len(data) > max_len:
            raise ValueError(
                f"task string of {len(data)} bytes exceeds the "
                f"{max_len}-byte broadcast frame"
            )
    if not backend_supports_collectives():
        world = _require_world()
        seq = next(_BCAST_SEQ)
        key = f"chunkflow/broadcast/{seq}"
        if world.rank == 0:
            value = ("N" if s is None
                     else "S" + base64.b64encode(
                         s.encode("utf-8")).decode("ascii"))
            world.store.set(key, value)
        got = _store_get(key).decode("ascii")
        if got == "N":
            return None
        return base64.b64decode(got[1:]).decode("utf-8")
    if process_count() <= 1:
        return s
    buf = torch.zeros(2 + max_len, dtype=torch.int32)
    if _world.rank == 0 and s is not None:
        buf[0] = 1
        buf[1] = len(data)
        buf[2:2 + len(data)] = torch.frombuffer(bytearray(data),
                                                dtype=torch.uint8)
    buf = buf.to(_world.device)
    dist.broadcast(buf, src=0)
    out = buf.cpu()
    if int(out[0]) == 0:
        return None
    n = int(out[1])
    return bytes(out[2:2 + n].to(torch.uint8).numpy()).decode("utf-8")


# ---------------------------------------------------------------------------
# the consistency guard
# ---------------------------------------------------------------------------

# the guard's parameter digests, one full-tree walk per (params, mesh):
# entries hold a strong reference to the keyed params object, so an id()
# can never be recycled while its entry lives; a cheap content
# fingerprint is re-checked on every hit, so reloading weights INTO the
# same object in place re-digests instead of serving a stale digest.
# Bounded FIFO.
_PARAMS_DIGEST_CACHE: dict = {}
_CACHE_MAX = 4
# sharded_inference_global's mesh engines, one per (engine, mesh,
# geometry): each keeps the copies of the parameters on this rank's
# devices and its psum program, so a host-resident engine crosses to the
# card once, not every chunk. Same strong reference, fingerprint re-check
# and FIFO bound as above.
_GLOBAL_ENGINES: dict = {}


def _mesh_key(mesh) -> tuple:
    return tuple((g.process, str(g.device)) for g in mesh)


def _leaves(params) -> list:
    """The parameter tree's leaves in a fixed order: a module's
    ``state_dict`` in its order, a dict's values by sorted key (as JAX
    flattens a dict), a list or tuple in order; None has none."""
    if params is None:
        return []
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().values())
    if isinstance(params, dict):
        return [leaf for key in sorted(params)
                for leaf in _leaves(params[key])]
    if isinstance(params, (list, tuple)):
        return [leaf for item in params for leaf in _leaves(item)]
    return [params]


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (bfloat16 widened to float32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _params_fingerprint(params) -> tuple:
    """O(leaves * 128) content fingerprint: shape, dtype, and a
    strided-sample float64 sum per leaf (only the sample leaves a card).
    Not cryptographic — it exists to catch in-place weight reloads, which
    change many entries at once."""
    parts = []
    for leaf in _leaves(params):
        flat = leaf.reshape(-1) if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf).reshape(-1)
        stride = max(1, int(flat.shape[0]) // 128)
        parts.append((
            tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf).shape,
            _dtype_name(leaf),
            float(_host(flat[::stride]).sum(dtype=np.float64)),
        ))
    return tuple(parts)


def _chunk_digest(arr) -> list:
    """Per-process digest of a replicated input: full float64 sum plus
    shape-crc, nan-aware min/max, and a crc32 of a strided byte sample —
    so permuted or sign-cancelling divergence that keeps the plain sum
    equal still trips the guard. The JAX function's digest, float for
    float."""
    a = _host(arr)
    flat = a.reshape(-1)
    if flat.size == 0:
        return [0.0, float(zlib.crc32(repr(a.shape).encode())), 0.0, 0.0,
                0.0]
    stride = max(1, flat.size // 16384)
    sample = np.ascontiguousarray(flat[::stride])
    if np.issubdtype(flat.dtype, np.floating):
        # all-NaN yields NaN, which the NaN-aware compare accepts
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            lo = float(np.nanmin(flat))
            hi = float(np.nanmax(flat))
    else:
        lo = float(flat.min())
        hi = float(flat.max())
    return [
        float(flat.sum(dtype=np.float64)),
        float(zlib.crc32(repr(a.shape).encode())),
        lo,
        hi,
        float(zlib.crc32(sample.tobytes())),
    ]


def _params_digest_cached(params, cache_key) -> list:
    """The per-leaf float64 sum digest of a parameter tree, cached by
    (id, fingerprint) so the full-tree walk happens once per reload."""
    fingerprint = _params_fingerprint(params)
    dkey = (id(params), cache_key)
    entry = _PARAMS_DIGEST_CACHE.get(dkey)
    if entry is None or entry[0] is not params or entry[1] != fingerprint:
        pdig = [float(_host(leaf).sum(dtype=np.float64))
                for leaf in _leaves(params)]
        _PARAMS_DIGEST_CACHE[dkey] = (params, fingerprint, pdig)
        while len(_PARAMS_DIGEST_CACHE) > _CACHE_MAX:
            _PARAMS_DIGEST_CACHE.pop(next(iter(_PARAMS_DIGEST_CACHE)))
    else:
        pdig = entry[2]
    return pdig


def ensure_consistent(chunk_arr, params, cache_key="local") -> None:
    """Cross-process consistency guard: allgather a digest of the
    (supposedly replicated) chunk and params — collectives when the
    backend has them, the store's byte exchange when it does not — and
    fail loudly on any disagreement. Divergent "replicated" inputs (two
    queue workers that each pulled a DIFFERENT task while sharing one
    world) would otherwise produce silently corrupt output on every rank.
    NaN digest entries compare equal so masked chunks don't spuriously
    abort. No-op in a world of one."""
    if process_count() <= 1:
        return
    pdig = _params_digest_cached(params, cache_key)
    digest = np.asarray(_chunk_digest(chunk_arr) + pdig, np.float64)
    gathered = _allgather_digest(digest)
    ref = gathered[0][None]
    same = np.all(
        (gathered == ref) | (np.isnan(gathered) & np.isnan(ref))
    )
    if not same:
        raise ValueError(
            "multihost: chunk/params checksums differ across "
            f"processes:\n{gathered}\nevery process must feed "
            "identical replicated inputs (did two workers pull "
            "different tasks while sharing one torch.distributed "
            "world?)"
        )


# ---------------------------------------------------------------------------
# the cross-process recipe
# ---------------------------------------------------------------------------

def run_global(
    program,
    chunk_arr,
    in_starts,
    out_starts,
    valid,
    params,
    mesh,
    check_consistency: bool = True,
):
    """Run a psum program (``distributed.prepare_sharded``) over a device
    list that spans processes.

    The one place that owns the cross-process recipe (used by
    ``ShardedEngine._run_multiprocess``, under both
    :func:`sharded_inference_global` and ``Inferencer(sharding='patch')``):
    the program's forwards carry their parameters on this rank's devices,
    and it returns the normalized output on this rank's first device.

    ``check_consistency`` (default on): allgather a digest of the chunk
    and ``params`` first and fail loudly if any process disagrees —
    divergent "replicated" inputs would otherwise all-reduce into
    silently corrupt output on every rank."""
    if check_consistency and process_count() > 1:
        ensure_consistent(chunk_arr, params, cache_key=_mesh_key(mesh))
    return program(chunk_arr, in_starts, out_starts, valid)


def sharded_inference_global(
    chunk_array,
    engine,
    input_patch_size,
    output_patch_size,
    output_patch_overlap,
    batch_size: int = 1,
):
    """ONE patch-parallel inference spanning processes; the result is a
    float32 tensor ``[C, Z, Y, X]`` on this rank's device (the card
    unless the world was joined on the CPU; outside a world, the card).

    The chunk is taken as float32, as the JAX function takes it, and runs
    through the mesh engine at ``data=<global devices>`` over this rank's
    devices (``ShardedEngine.for_engine``, kept per (engine, mesh) with
    its copies of the parameters, the fingerprint re-checked on every
    hit). With collectives that is the psum recipe: each rank blends its
    share of the padded patch list, the partial buffers are all-reduced,
    ulp-level against one device. Without collectives each process
    checks the guard and computes the whole chunk over its local
    devices, bitwise one device."""
    from chunkflow_tpu_torch.inference.patching import enumerate_patches
    from chunkflow_tpu_torch.parallel.engine import MeshSpec, ShardedEngine

    device = process_device() or resolve_device("cuda")
    arr = torch.as_tensor(chunk_array).to(device=device, dtype=torch.float32)
    if arr.dim() == 3:
        arr = arr[None]
    arr = arr.contiguous()
    pin, pout = tuple(input_patch_size), tuple(output_patch_size)
    grid = enumerate_patches(tuple(arr.shape), pin, pout,
                             tuple(output_patch_overlap))
    mesh = global_mesh(device)
    key = (id(engine), _mesh_key(mesh), pin, pout, batch_size)
    fingerprint = _params_fingerprint(engine.params)
    entry = _GLOBAL_ENGINES.get(key)
    if entry is None or entry[0] is not engine or entry[1] != fingerprint:
        sharded = ShardedEngine.for_engine(
            engine, pin, pout, batch_size, MeshSpec("data", (len(mesh),)),
            devices=local_devices(device), device=device)
        entry = _GLOBAL_ENGINES[key] = (engine, fingerprint, sharded)
        while len(_GLOBAL_ENGINES) > _CACHE_MAX:
            _GLOBAL_ENGINES.pop(next(iter(_GLOBAL_ENGINES)))
    with torch.no_grad():
        return entry[2].run(arr, grid, host_params=engine.params)
