"""The mesh engine: one process drives patch inference over a list of
devices, bitwise equal to one device.

The counterpart of ``chunkflow_tpu/parallel/engine.py``. In one process
it runs ``ShardedEngine._run_local``; in a world of several processes
(``parallel/multihost.py``) ``_run_multiprocess``: the data kind runs the
psum recipe over the global device list when the backend has
collectives, and every other case checks the consistency guard and runs
``_run_local`` over the process's own devices. The mesh spec
(``CHUNKFLOW_MESH``, ``inference --mesh``, ``Inferencer(mesh=...)``):

    1            one device: no engine is built
    auto         one ``data`` axis over every local device
    data=N       patch-parallel over N devices
    y=A[,x=B]    the chunk sharded in y (and x) slabs, with halo exchange
    pipeline=N   the layer stack staged over N devices, patch
                 micro-batches streamed through (engines that declare the
                 stage protocol, ``parallel/pipeline.py``)

Shard ``i`` lives on ``devices[i]``. The devices default to every CUDA
device (``[cpu]`` for a CPU inferencer) and may repeat: on one card every
mesh kind runs as N shards queued on that card, and the CPU tests run
``[cpu] * 8``. A collective of the JAX program is a copy between those
devices: a ``ppermute`` is ``.to(devices[j], non_blocking=True)`` of a
halo, a fringe window strip or a stage handoff, and an ``all_gather`` is
the same copy to every device, in device order, then a ``cat``. Copies
move data exactly, and a copy between cards is ordered by CUDA events,
not by a host sync. Each shard's gather, forward, accumulate and
normalize run on the current stream of its device, through the port's
kernels (``ops/gather.py``, ``ops/accumulate.py``), which dispatch by
device as everywhere else.

**The bitwise contract** (the JAX package's). The forward is sharded, at
the per-batch shape ``[B, ci, *pin]`` of the single-device loop; every
row's result is independent of the rows beside it. The weighted
predictions ``forward * bump * valid`` then replay the single-device
accumulation verbatim: the same pre-weighted accumulate step, each
voxel's windows in ascending patch order, then the same normalization.
The spatial kinds shard the chunk itself (a slab plus exchanged halos per
shard), bucket the patches by the slab that holds their output start,
and a host index restores global patch order.

**Sharded replay** (``CHUNKFLOW_SHARD_REPLAY=sharded``, the default).
Each shard replays only the windows that touch its output slab, into a
slab+margin buffer; windows that cross a slab boundary travel to the
neighbour whole (y phase, then x phase). ``replicated`` replays every
window on every shard into a full-chunk buffer. Filler rows of a replay
select a zero row and start inside the cropped margin, so they touch no
live voxel. The port's accumulate needs no alignment pad (the Pallas
kernel's ``pad_y``/``pad_x`` are a TPU tiling rule).

**Pipeline.** ``pipeline=N`` runs the engine's stage groups one per
device; at tick ``t`` stage ``s`` runs micro-batch ``t - s`` and hands its
activation to stage ``s + 1``, so the ring drains in ``T + N - 1`` ticks.
The last stage's weighted stack is copied to every device and replayed
as above.

Telemetry (the JAX names and values): the gauges ``shard/mesh_devices``,
``shard/mesh_y``, ``shard/mesh_x``, ``shard/mesh_pipeline``,
``shard/per_chip_voxels``, ``shard/chip/<i>/voxels``, the counter
``shard/chunks`` and the span ``shard/dispatch``; the analytic byte
counters ``shard/halo_bytes``, ``shard/gather_bytes``,
``shard/replay_strip_bytes``, ``shard/handoff_bytes`` and
``shard/collective_bytes`` with their ``*_per_chunk`` gauges;
``shard/replay_buffer_bytes`` and its per-chip copies; and a sampled
readiness probe (the first dispatch, then every
``CHUNKFLOW_CHIP_PROBE_EVERY``-th, default 8), ``shard/chip/<i>/ready_s``
and ``shard/chip_skew_s``. Each dispatch is one call of a ``shard``
program of the cost ledger (``core/profiling.py``), keyed as the JAX
program (kind, devices, chunk shape, rows, plan), whose first call
counts its FLOPs; with them the collective-vs-compute split gauges
``shard/compute_s_est``, ``shard/collective_s_est`` and
``shard/collective_share_est``, as in the JAX package. The serving
forward is the ledger's ``serve_forward`` program of the mesh. Nothing
is recorded under ``CHUNKFLOW_TELEMETRY=0``.
"""
from __future__ import annotations

import copy
import functools
import itertools
import os
import re
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from chunkflow_tpu_torch.core import profiling, telemetry
from chunkflow_tpu_torch.core.device import resolve_device
from chunkflow_tpu_torch.inference.bump import bump_const
from chunkflow_tpu_torch.inference.patching import (
    PatchGrid,
    enumerate_patches,
    pad_to_batch,
)
from chunkflow_tpu_torch.ops import accumulate as _accumulate
from chunkflow_tpu_torch.ops import gather as _gather
from chunkflow_tpu_torch.ops.blend import (
    device_valid,
    normalize_blend,
    shard_replay_mode,
)
from chunkflow_tpu_torch.parallel import pipeline as pipe_mod

__all__ = [
    "MeshSpec", "parse_mesh_spec", "mesh_env_spec", "local_devices",
    "canonical_device", "mesh_devices", "params_to", "params_device",
    "on_device",
    "ShardedEngine", "sharded_inference",
]

Triple = Tuple[int, int, int]

_OFF_VALUES = ("", "1", "none", "off", "single", "0")


class MeshSpec(NamedTuple):
    """A parsed mesh request: ``kind`` is ``single`` (no engine),
    ``data``, ``spatial`` (a ``(ny, nx)`` mesh; ``nx == 1`` is the 1D
    y-slab layout) or ``pipeline``."""

    kind: str
    shape: Tuple[int, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def describe(self) -> str:
        if self.kind == "single":
            return "1"
        if self.kind == "data":
            return f"data={self.shape[0]}"
        if self.kind == "pipeline":
            return f"pipeline={self.shape[0]}"
        ny, nx = self.shape
        return f"y={ny},x={nx}" if nx > 1 else f"y={ny}"


def parse_mesh_spec(value: Optional[str],
                    n_devices: Optional[int] = None) -> MeshSpec:
    """Parse a mesh spec string (the ``CHUNKFLOW_MESH`` grammar), with
    the JAX package's errors. ``n_devices`` bounds ``auto`` and checks
    explicit sizes; ``None`` leaves the check to the engine."""
    raw = (value or "").strip().lower()
    if raw in _OFF_VALUES:
        return MeshSpec("single", (1,))
    if raw == "auto":
        n = n_devices if n_devices is not None else 0
        if n <= 1:
            return MeshSpec("single", (1,))
        return MeshSpec("data", (n,))
    if re.fullmatch(r"\d+", raw):
        n = int(raw)
        spec = MeshSpec("single", (1,)) if n <= 1 else MeshSpec("data", (n,))
        _check_devices(spec, n_devices, value)
        return spec
    axes = {}
    for part in raw.split(","):
        m = re.fullmatch(r"\s*(data|y|x|pipeline)\s*=\s*(\d+)\s*", part)
        if not m:
            raise ValueError(
                f"bad mesh spec {value!r}: expected '1', 'auto', 'N', "
                f"'data=N', 'y=A', 'y=A,x=B' or 'pipeline=N' "
                f"(docs/multichip.md)"
            )
        axis, n = m.group(1), int(m.group(2))
        if axis in axes:
            raise ValueError(f"bad mesh spec {value!r}: duplicate '{axis}='")
        if n < 1:
            raise ValueError(f"bad mesh spec {value!r}: {axis}={n}")
        axes[axis] = n
    if "pipeline" in axes:
        if len(axes) > 1:
            raise ValueError(
                f"bad mesh spec {value!r}: 'pipeline' does not compose "
                f"with other axes"
            )
        n = axes["pipeline"]
        spec = MeshSpec("single", (1,)) if n <= 1 \
            else MeshSpec("pipeline", (n,))
        _check_devices(spec, n_devices, value)
        return spec
    if "data" in axes:
        if len(axes) > 1:
            raise ValueError(
                f"bad mesh spec {value!r}: 'data' does not compose with "
                f"spatial axes"
            )
        n = axes["data"]
        spec = MeshSpec("single", (1,)) if n <= 1 else MeshSpec("data", (n,))
    else:
        ny = axes.get("y", 1)
        nx = axes.get("x", 1)
        if ny * nx <= 1:
            spec = MeshSpec("single", (1,))
        else:
            spec = MeshSpec("spatial", (ny, nx))
    _check_devices(spec, n_devices, value)
    return spec


def _check_devices(spec: MeshSpec, n_devices: Optional[int], value) -> None:
    if n_devices is not None and spec.n_devices > n_devices:
        raise ValueError(
            f"mesh spec {value!r} needs {spec.n_devices} devices, only "
            f"{n_devices} available"
        )


def mesh_env_spec(n_devices: Optional[int] = None) -> MeshSpec:
    """The ``CHUNKFLOW_MESH`` spec (default: one device), re-read per
    call so a live worker can flip it."""
    return parse_mesh_spec(os.environ.get("CHUNKFLOW_MESH", "1"), n_devices)


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices(device) -> List[torch.device]:
    """The devices a mesh spreads over by default: every CUDA device for
    a CUDA ``device``, else ``[device]``."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [device]


def mesh_devices(devices, device) -> List[torch.device]:
    """``devices`` as a list, or by default the local devices of
    ``device`` (which must exist: a CUDA device raises without a
    card)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    return local_devices(resolve_device(device))


def params_to(params, device):
    """A copy of an engine's parameters (an ``nn.Module`` or a tree of
    tensors) on ``device``; the original is untouched."""
    if isinstance(params, torch.nn.Module):
        return copy.deepcopy(params).to(device)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params


def params_device(params) -> Optional[torch.device]:
    """The device of the first tensor of ``params`` (an ``nn.Module`` or
    a tree of tensors); None when it holds no tensor."""
    if isinstance(params, torch.nn.Module):
        for t in itertools.chain(params.parameters(), params.buffers()):
            return t.device
        return None
    if isinstance(params, torch.Tensor):
        return params.device
    leaves = (params.values() if isinstance(params, dict)
              else params if isinstance(params, (list, tuple)) else ())
    for leaf in leaves:
        found = params_device(leaf)
        if found is not None:
            return found
    return None


def on_device(device, home_device, home, params, make: Callable,
              built: dict):
    """What a shard on ``device`` runs with the parameters there:
    ``home`` on ``home_device`` or when there are no parameters
    (``params`` None); else ``make`` of a copy of ``params`` on
    ``device`` (:func:`params_to`), built once per device into
    ``built``. The inferencer's shard forwards and stages and the
    standalone entry's share it."""
    device = canonical_device(device)
    if params is None or device == canonical_device(home_device):
        return home
    value = built.get(device)
    if value is None:
        value = built[device] = make(params_to(params, device))
    return value


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def axis_geometry(extent: int, n_dev: int, pin: int, pout: int):
    """(slab, halo_left, halo_right, padded) for sharding one spatial
    axis over ``n_dev`` devices; ``n_dev == 1`` is one slab with no
    halos."""
    if n_dev <= 1:
        return extent, 0, 0, extent
    margin = (pin - pout) // 2
    halo_left = margin
    halo_right = pin - margin
    slab = max(-(-extent // n_dev), halo_left, halo_right, pout)
    return slab, halo_left, halo_right, slab * n_dev


def _pad_chunk(arr: torch.Tensor, padded_y: int,
               padded_x: int) -> torch.Tensor:
    """Zero-pad ``[C, Z, y, x]`` on the high side of y and x."""
    y, x = arr.shape[-2:]
    if (y, x) == (padded_y, padded_x):
        return arr
    out = arr.new_zeros(tuple(arr.shape[:-2]) + (padded_y, padded_x))
    out[..., :y, :x] = arr
    return out


class _Partition(NamedTuple):
    """The patch partition of one (grid, mesh) pair."""

    dev_in: np.ndarray      # [ny, nx, P, 3] int32, slab-local gathers
    dev_valid: np.ndarray   # [ny, nx, P] float32
    src_index: np.ndarray   # [n_ref] int32: global padded row -> shard row
    out_starts: np.ndarray  # [n_ref, 3] int32, global replay corners
    valid: np.ndarray       # [n_ref] float32, the reference validity
    per_dev: int            # P
    global_index: np.ndarray  # [ny, nx, P] int32 global row per local row
                              # (-1 for filler slots)
    counts: np.ndarray        # [ny, nx] int32 real rows per shard


def partition_for_mesh(
    grid: PatchGrid,
    shape: Tuple[int, int],
    batch_size: int,
    yslab: int,
    xslab: int,
    halo_left_y: int,
    halo_left_x: int,
) -> _Partition:
    """Bucket the reference padded patch list (``pad_to_batch(grid, B)``,
    its padding rows included, so their signed zeros flow through the
    replay as in the single-device loop) by output-start slab, with the
    gather corners in each shard's extended-slab frame."""
    ny, nx = shape
    in_starts, out_starts, valid = pad_to_batch(grid, batch_size)
    n_ref = len(valid)
    by = np.clip(out_starts[:, 1] // yslab, 0, ny - 1)
    bx = np.clip(out_starts[:, 2] // xslab, 0, nx - 1)
    flat = by * nx + bx
    max_count = max(int((flat == d).sum()) for d in range(ny * nx))
    per_dev = max(-(-max_count // batch_size) * batch_size, batch_size)

    dev_in = np.zeros((ny, nx, per_dev, 3), dtype=np.int32)
    dev_valid = np.zeros((ny, nx, per_dev), dtype=np.float32)
    src_index = np.zeros(n_ref, dtype=np.int32)
    global_index = np.full((ny, nx, per_dev), -1, dtype=np.int32)
    counts = np.zeros((ny, nx), dtype=np.int32)
    for dy in range(ny):
        for dx in range(nx):
            idx = np.nonzero(flat == dy * nx + dx)[0]
            k = idx.size
            local = in_starts[idx].copy()
            # the extended slab starts at global (dy*yslab - hl_y,
            # dx*xslab - hl_x); z is never sharded
            local[:, 1] -= dy * yslab - halo_left_y
            local[:, 2] -= dx * xslab - halo_left_x
            dev_in[dy, dx, :k] = local
            dev_valid[dy, dx, :k] = valid[idx]
            global_index[dy, dx, :k] = idx.astype(np.int32)
            counts[dy, dx] = k
            src_index[idx] = (dy * nx + dx) * per_dev + np.arange(
                k, dtype=np.int32
            )
    return _Partition(dev_in, dev_valid, src_index, out_starts, valid,
                      per_dev, global_index, counts)


# ---------------------------------------------------------------------------
# sharded-replay plans
# ---------------------------------------------------------------------------

class _ReplayPlan(NamedTuple):
    """The spatial kinds' sharded replay: which weighted windows each
    shard sends to its +y / +x neighbour (those crossing the slab
    boundary: ``slab >= pout``, so one hop a phase, corners two-hopping
    y then x) and, per shard, the global-order replay index into the
    pool ``own ++ recv_y ++ recv_x ++ zero row``. Filler slots select the
    zero row at a start inside the cropped high margin."""

    fringe_y: np.ndarray   # [ny, nx, Fy] int32 into own rows (sent in y)
    fringe_x: np.ndarray   # [ny, nx, Fx] int32 into own++recv_y (in x)
    index: np.ndarray      # [ny, nx, R] int32 into own++recv_y++recv_x++zero
    starts: np.ndarray     # [ny, nx, R, 3] int32, slab-frame corners
    valid: np.ndarray      # [ny, nx, R] float32
    margin_y: int
    margin_x: int
    fy: int
    fx: int
    r: int


def replay_plan_spatial(
    part: _Partition,
    pout: Triple,
    shape: Tuple[int, int],
    yslab: int,
    xslab: int,
    batch_size: int,
) -> _ReplayPlan:
    """The sharded-replay plan of a spatial partition (host numpy over
    ``partition_for_mesh``'s bookkeeping)."""
    ny, nx = shape
    py, px = pout[1], pout[2]
    m_y = py if ny > 1 else 0
    m_x = px if nx > 1 else 0
    out_starts = part.out_starts
    ref_valid = part.valid
    per_dev = part.per_dev

    # (global_row, pool_index) per shard, in global (ascending) order
    own = [[[(int(g), j) for j, g in enumerate(
        part.global_index[dy, dx, : int(part.counts[dy, dx])])]
        for dx in range(nx)] for dy in range(ny)]

    # y-phase fringe: own rows whose window crosses the +y slab boundary
    fringe_y_meta = [[[
        (g, j) for g, j in own[dy][dx]
        if out_starts[g, 1] + py > (dy + 1) * yslab
    ] for dx in range(nx)] for dy in range(ny)]
    fy = max(
        (len(fringe_y_meta[dy][dx])
         for dy in range(ny - 1) for dx in range(nx)),
        default=0,
    ) if ny > 1 else 0

    # the pool after the y phase: own ++ recv_y (receive slot k holds the
    # sender's k-th fringe row)
    pool_y = [[list(own[dy][dx]) for dx in range(nx)] for dy in range(ny)]
    if fy:
        for dy in range(1, ny):
            for dx in range(nx):
                pool_y[dy][dx] += [
                    (g, per_dev + k)
                    for k, (g, _) in enumerate(fringe_y_meta[dy - 1][dx])
                ]

    # x-phase fringe: pool rows (own and y-received corners) crossing +x
    fringe_x_meta = [[[
        (g, p) for g, p in pool_y[dy][dx]
        if out_starts[g, 2] + px > (dx + 1) * xslab
    ] for dx in range(nx)] for dy in range(ny)]
    fx = max(
        (len(fringe_x_meta[dy][dx])
         for dy in range(ny) for dx in range(nx - 1)),
        default=0,
    ) if nx > 1 else 0

    pool = [[list(pool_y[dy][dx]) for dx in range(nx)] for dy in range(ny)]
    if fx:
        for dy in range(ny):
            for dx in range(1, nx):
                pool[dy][dx] += [
                    (g, per_dev + fy + k)
                    for k, (g, _) in enumerate(fringe_x_meta[dy][dx - 1])
                ]

    r_need = max(len(pool[dy][dx]) for dy in range(ny) for dx in range(nx))
    r = max(-(-max(r_need, 1) // batch_size) * batch_size, batch_size)
    zero_row = per_dev + fy + fx
    filler_start = (
        (0, m_y + yslab, 0) if ny > 1 else (0, 0, m_x + xslab)
    )

    fringe_y = np.zeros((ny, nx, fy), dtype=np.int32)
    fringe_x = np.zeros((ny, nx, fx), dtype=np.int32)
    index = np.full((ny, nx, r), zero_row, dtype=np.int32)
    starts = np.tile(
        np.asarray(filler_start, dtype=np.int32), (ny, nx, r, 1)
    )
    valid = np.zeros((ny, nx, r), dtype=np.float32)
    for dy in range(ny):
        for dx in range(nx):
            for k, (_, j) in enumerate(fringe_y_meta[dy][dx][:fy]):
                fringe_y[dy, dx, k] = j
            for k, (_, p) in enumerate(fringe_x_meta[dy][dx][:fx]):
                fringe_x[dy, dx, k] = p
            rows = sorted(pool[dy][dx])  # by global row: reference order
            for i, (g, p) in enumerate(rows):
                index[dy, dx, i] = p
                starts[dy, dx, i] = (
                    out_starts[g, 0],
                    out_starts[g, 1] - dy * yslab + m_y,
                    out_starts[g, 2] - dx * xslab + m_x,
                )
                valid[dy, dx, i] = ref_valid[g]
    return _ReplayPlan(fringe_y, fringe_x, index, starts, valid,
                       m_y, m_x, fy, fx, r)


class _ReplayPlan1D(NamedTuple):
    """The sharded replay of the kinds whose every shard holds the whole
    global weighted stack (``data`` after its all_gather, ``pipeline``
    after its drain): each shard takes, in global order, the rows whose
    window meets its y output slab (a window may meet several) and
    replays them into a slab+margin buffer."""

    index: np.ndarray   # [n_dev, R] int32 into stack ++ zero row
    starts: np.ndarray  # [n_dev, R, 3] int32, slab-frame corners
    valid: np.ndarray   # [n_dev, R] float32
    margin: int
    r: int


def replay_plan_1d(
    out_starts: np.ndarray,
    ref_valid: np.ndarray,
    n_ref: int,
    pool_rows: int,
    pout: Triple,
    n_dev: int,
    slab: int,
    batch_size: int,
) -> _ReplayPlan1D:
    py = pout[1]
    margin = py
    rows = [[] for _ in range(n_dev)]
    for g in range(n_ref):
        y = int(out_starts[g, 1])
        # the window [y, y+py) meets slabs y//slab .. (y+py-1)//slab
        d_lo = min(n_dev - 1, y // slab)
        d_hi = min(n_dev - 1, (y + py - 1) // slab)
        for d in range(d_lo, d_hi + 1):
            if y + py > d * slab and y < (d + 1) * slab:
                rows[d].append(g)
    r_need = max(len(rs) for rs in rows)
    r = max(-(-max(r_need, 1) // batch_size) * batch_size, batch_size)
    index = np.full((n_dev, r), pool_rows, dtype=np.int32)
    starts = np.tile(
        np.asarray((0, margin + slab, 0), dtype=np.int32), (n_dev, r, 1)
    )
    valid = np.zeros((n_dev, r), dtype=np.float32)
    for d in range(n_dev):
        for i, g in enumerate(rows[d]):
            index[d, i] = g
            starts[d, i] = (
                out_starts[g, 0],
                out_starts[g, 1] - d * slab + margin,
                out_starts[g, 2],
            )
            valid[d, i] = ref_valid[g]
    return _ReplayPlan1D(index, starts, valid, margin, r)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A ``ppermute`` edge: ``t`` on ``device`` (the tensor itself when it
    is there already; nothing writes into a tensor it sends)."""
    return t.to(device, non_blocking=True)


def _all_gather(stacks: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """A tiled ``all_gather``: every shard's rows on ``device``, in device
    order."""
    return torch.cat([_send(s, device) for s in stacks])


def _with_halos(block: Callable, i: int, n: int, dim: int, slab: int,
                hl: int, hr: int, device: torch.device) -> torch.Tensor:
    """Block ``i`` of one mesh axis (``block(k)``) with its halos along
    ``dim``: the last ``hl`` planes of block ``i-1`` (the forward
    ``ppermute``) and the first ``hr`` of block ``i+1`` (the backward
    one), zeros where there is no neighbour."""
    own = block(i)

    def planes(t, lo, hi):
        index = [slice(None)] * t.dim()
        index[dim] = slice(lo, hi)
        return t[tuple(index)]

    def zeros(width):
        shape = list(own.shape)
        shape[dim] = width
        return own.new_zeros(shape)

    pieces = []
    if hl:
        pieces.append(_send(planes(block(i - 1), slab - hl, slab), device)
                      if i > 0 else zeros(hl))
    pieces.append(own)
    if hr:
        pieces.append(_send(planes(block(i + 1), 0, hr), device)
                      if i < n - 1 else zeros(hr))
    return torch.cat(pieces, dim=dim)


class ShardedEngine:
    """One engine for every mesh kind.

    Built by :meth:`for_inferencer` (the inferencer's forward at its
    precision, its batch and output dtype, its devices) or directly from
    a raw forward (the legacy wrappers). ``forward(batch)`` runs a batch
    on the batch's device; ``forward_on(device)``, when given, returns
    the forward whose parameters live on ``device``
    (:func:`on_device`)."""

    def __init__(
        self,
        forward: Callable,
        num_input_channels: int,
        num_output_channels: int,
        input_patch_size: Triple,
        output_patch_size: Triple,
        batch_size: int,
        spec: MeshSpec,
        out_dtype: str = "float32",
        devices=None,
        stage_entry=None,
        stage_bodies=None,
        stage_tail=None,
        stage_params=None,
        precision_tag: str = "",
        forward_on: Optional[Callable] = None,
        device="cpu",
    ):
        if spec.kind == "single":
            raise ValueError("single spec needs no ShardedEngine "
                             "(the kill switch path)")
        self.forward = forward
        self.forward_on = forward_on
        self.num_input_channels = num_input_channels
        self.num_output_channels = num_output_channels
        self.input_patch_size = tuple(input_patch_size)
        self.output_patch_size = tuple(output_patch_size)
        self.batch_size = int(batch_size)
        self.spec = spec
        self.out_dtype = out_dtype
        # where the engine's caller keeps its chunk and wants the result
        self.device = torch.device(device)
        self._devices = devices
        self._mesh: Optional[List[torch.device]] = None
        self._bumps: dict = {}
        self._dispatches = 0  # the readiness probe's sampling clock
        # the cost ledger's records of this engine's dispatches
        self._programs: dict = {}
        # the multi-process recipe's psum programs (one per mesh,
        # ``distributed.prepare_sharded``) and the local engines of its
        # no-collectives leg
        self._global_programs: dict = {}
        self._local_engines: dict = {}
        # the stage protocol (parallel/pipeline.py), precision-wrapped;
        # None: the forward is opaque and a pipeline mesh raises
        self.stage_entry = stage_entry
        self.stage_bodies = stage_bodies
        self.stage_tail = stage_tail
        self.stage_params = stage_params
        self.precision_tag = precision_tag

    # ------------------------------------------------------------------
    @classmethod
    def for_inferencer(cls, inferencer, spec: MeshSpec,
                       devices=None) -> "ShardedEngine":
        from chunkflow_tpu_torch.inference.precision import (
            precision_tag,
            wrap_stages,
        )

        engine = inferencer.engine
        # TTA wraps the forward in an 8-variant loop the stage protocol
        # cannot split: a staged engine under augment reports no stages
        if inferencer.augment:
            entry = bodies = tail = None
        else:
            entry, bodies, tail = wrap_stages(
                engine.stage_bodies, engine.stage_tail,
                inferencer.precision, engine.params)
        return cls(
            inferencer._forward,
            inferencer.num_input_channels,
            inferencer.num_output_channels,
            tuple(inferencer.input_patch_size),
            tuple(inferencer.output_patch_size),
            inferencer.batch_size,
            spec,
            out_dtype=inferencer.output_dtype,
            devices=devices,
            stage_entry=entry,
            stage_bodies=bodies,
            stage_tail=tail,
            stage_params=engine.params,
            precision_tag=precision_tag(inferencer.precision),
            forward_on=inferencer._forward_on,
            device=inferencer.device,
        )

    @classmethod
    def for_engine(cls, engine, input_patch_size: Triple,
                   output_patch_size: Triple, batch_size: int,
                   spec: MeshSpec, out_dtype: str = "float32",
                   devices=None, device="cpu") -> "ShardedEngine":
        """The mesh engine of a raw ``engines.Engine``: a shard on a
        device other than the parameters' runs the engine's call on a
        copy of them there, made on its first use and kept by the
        engine."""
        home = params_device(engine.params)
        params = (None if engine.call is None or home is None
                  else engine.params)
        built: dict = {}

        def forward_on(dev):
            return on_device(dev, home, engine.apply, params,
                             lambda p: functools.partial(engine.call, p),
                             built)

        return cls(engine.apply, engine.num_input_channels,
                   engine.num_output_channels, input_patch_size,
                   output_patch_size, batch_size, spec, out_dtype=out_dtype,
                   devices=devices, forward_on=forward_on, device=device)

    # ------------------------------------------------------------------
    def mesh(self) -> List[torch.device]:
        """The spec's devices, shard ``i`` on ``mesh()[i]`` (row-major:
        y outer, x inner); raises the JAX package's ``ValueError`` when
        there are fewer than the spec needs."""
        if self._mesh is not None:
            return self._mesh
        devices = self._devices
        if devices is None:
            devices = local_devices(self.device)
        devices = [torch.device(d) for d in devices]
        need = self.spec.n_devices
        if len(devices) < need:
            raise ValueError(
                f"mesh spec {self.spec.describe()!r} needs {need} devices, "
                f"only {len(devices)} available"
            )
        self._mesh = devices[:need]
        return self._mesh

    def _forward_for(self, device: torch.device) -> Callable:
        if self.forward_on is None:
            return self.forward
        return self.forward_on(device)

    def _bump(self, device: torch.device) -> torch.Tensor:
        bump = self._bumps.get(device)
        if bump is None:
            bump = bump_const(self.output_patch_size, device)
            self._bumps[device] = bump
        return bump

    # ------------------------------------------------------------------
    def _forward_scan(self, device, chunk, in_starts: np.ndarray,
                      valid: np.ndarray) -> torch.Tensor:
        """``forward * bump * valid`` over one shard's patch batches of B,
        gathered out of its RAW chunk (or extended slab):
        ``[n_local, co, *pout]`` on ``device``, the single-device loop's
        per-row arithmetic at its per-batch shape."""
        B = self.batch_size
        forward = self._forward_for(device)
        bump = self._bump(device)
        pin = self.input_patch_size
        valid_d = device_valid(valid, device)
        stack = torch.empty(
            (len(in_starts), self.num_output_channels)
            + self.output_patch_size, dtype=torch.float32, device=device)
        for i0 in range(0, len(in_starts), B):
            rows = slice(i0, i0 + B)
            patches = _gather.gather_patches(
                chunk, torch.from_numpy(in_starts[rows]), pin)
            preds = forward(patches)
            torch.mul(preds * bump[None, None],
                      valid_d[rows, None, None, None, None],
                      out=stack[rows])
        return stack

    def _replay(self, device, pick: Callable, n_rows: int,
                valid: np.ndarray, starts: np.ndarray, buf: Triple,
                crop) -> torch.Tensor:
        """The reference accumulation replayed verbatim on ``device`` (the
        JAX ``_replay``, and with a margin ``crop`` its ``_slab_replay``):
        batches of B weighted rows (``pick(i0)``), in order, through the
        pre-weighted accumulate step into zeroed ``buf`` buffers; the
        ``crop`` then ``normalize_blend``."""
        B = self.batch_size
        bump = self._bump(device)
        valid_d = device_valid(valid, device)
        out = torch.zeros((self.num_output_channels,) + tuple(buf),
                          dtype=torch.float32, device=device)
        weight = torch.zeros(tuple(buf), dtype=torch.float32, device=device)
        for i0 in range(0, n_rows, B):
            _accumulate.fused_accumulate_patches(
                out, weight, pick(i0), valid_d[i0:i0 + B], bump,
                torch.from_numpy(starts[i0:i0 + B]), pre_weighted=True)
        return normalize_blend(out[(slice(None),) + crop], weight[crop],
                               self.out_dtype)

    def _slab_pick(self, rows: Callable, index: np.ndarray, device):
        """``pick`` over a pool: ``rows(p)`` is pool row ``p`` or None for
        a zero row (the filler slots' and the unfilled receive slots':
        the JAX ``_append_zero_row``)."""
        B = self.batch_size
        zero = torch.zeros((self.num_output_channels,)
                           + self.output_patch_size, dtype=torch.float32,
                           device=device)

        def pick(i0):
            picked = [rows(int(p)) for p in index[i0:i0 + B]]
            return torch.stack([zero if t is None else t for t in picked])

        return pick

    # ------------------------------------------------------------------
    def _run_data(self, arr, grid: PatchGrid, sharded_replay: bool):
        """The JAX ``_build_data_program`` and its dispatch.
        Patch-parallel: the chunk on every device, the padded global
        patch list split into contiguous shards, the weighted stacks
        gathered back in global order (contiguous shards: no
        permutation), then the replay: slab-sharded in y, or replicated
        into full-chunk buffers."""
        devices = self.mesh()
        n_dev = len(devices)
        B = self.batch_size
        chunk_shape = tuple(arr.shape)
        _, z, y, x = chunk_shape
        in_starts, out_starts, valid = pad_to_batch(grid, B * n_dev)
        n_pad_g = len(valid)
        n_ref = grid.num_patches + (-grid.num_patches % B)
        n_local = n_pad_g // n_dev
        plan = None
        slab = 0
        if sharded_replay:
            slab = -(-y // n_dev)
            plan = replay_plan_1d(out_starts, valid, n_ref, n_pad_g,
                                  self.output_patch_size, n_dev, slab, B)
        self._gauges(int(np.prod(chunk_shape[1:])),
                     chip_patches=valid.reshape(n_dev, -1).sum(axis=1))
        probe = self._probing()
        key = (("shard", "data", n_dev, chunk_shape, n_pad_g)
               + ((plan.r,) if plan is not None else ()))

        def dispatch():
            stacks = []
            for i, dev in enumerate(devices):
                rows = slice(i * n_local, (i + 1) * n_local)
                stacks.append(self._forward_scan(
                    dev, _send(arr, dev), in_starts[rows], valid[rows]))
            outs = self._replay_1d(
                devices, lambda dev: _all_gather(stacks, dev), plan, slab,
                n_pad_g, valid[:n_ref], out_starts[:n_ref], chunk_shape)
            ready = self._record(outs) if probe else None
            return ready, self._collect(outs, plan is not None, chunk_shape)

        with telemetry.span("shard/dispatch", mesh=self.spec.describe()):
            ready, result = self._dispatch(key, dispatch)
        # the weighted-stack all_gather: each shard's [rows, co, *pout]
        # float32 stack reaches the n-1 others
        row_bytes = self.num_output_channels * int(
            np.prod(self.output_patch_size)) * 4
        self._note_collectives(
            key, 0.0, float(n_dev * (n_dev - 1) * n_local * row_bytes),
            flops=profiling.program_flops(self._programs, key))
        if plan is not None:
            self._replay_buffer_gauges(
                z, slab + 2 * self.output_patch_size[1], x, n_dev)
        self._probe_chip_readiness(ready)
        return result

    def _replay_1d(self, devices, gathered_on: Callable,
                   plan: Optional[_ReplayPlan1D], slab: int, n_pool: int,
                   valid: np.ndarray, out_starts: np.ndarray,
                   chunk_shape) -> List[torch.Tensor]:
        """The replay of the kinds whose every device holds the whole
        weighted stack (``gathered_on(device)``, ``n_pool`` rows, global
        order): under ``plan`` each device replays the rows meeting its y
        slab into a slab+margin buffer; without one every device replays
        the reference rows (``valid``, ``out_starts``) into a full-chunk
        buffer."""
        B = self.batch_size
        _, z, y, x = chunk_shape
        outs = []
        for d, dev in enumerate(devices):
            gathered = gathered_on(dev)
            if plan is None:
                outs.append(self._replay(
                    dev, lambda i0, g=gathered: g[i0:i0 + B], len(valid),
                    valid, out_starts, (z, y, x), (slice(None),) * 3))
                continue
            m = plan.margin
            outs.append(self._replay(
                dev, self._slab_pick(
                    lambda p, g=gathered: g[p] if p < n_pool else None,
                    plan.index[d], dev),
                plan.r, plan.valid[d], plan.starts[d], (z, slab + 2 * m, x),
                (slice(None), slice(m, m + slab), slice(None))))
        return outs

    def _run_pipeline(self, arr, grid: PatchGrid, sharded_replay: bool):
        """The JAX ``_build_pipeline_program`` and its dispatch.
        Stage-parallel: micro-batches of B stream through the stage
        groups (``T + S - 1`` ticks); the last stage's weighted stack is
        copied to every device (the drain) and replayed as in the data
        kind."""
        pipe_mod.require_stages(self.stage_bodies, self.stage_tail,
                                "CHUNKFLOW_MESH=" + self.spec.describe())
        devices = self.mesh()
        S = len(devices)
        B = self.batch_size
        chunk_shape = tuple(arr.shape)
        _, z, y, x = chunk_shape
        in_starts, out_starts, valid = pad_to_batch(grid, B)
        n_ref = len(valid)
        T = n_ref // B
        plan = None
        slab = 0
        if sharded_replay:
            slab = -(-y // S)
            plan = replay_plan_1d(out_starts, valid, n_ref, n_ref,
                                  self.output_patch_size, S, slab, B)
        # every device touches every patch: no per-device patch share
        self._gauges(int(np.prod(chunk_shape[1:])))
        probe = self._probing()
        key = (("shard", "pipeline", S, chunk_shape, n_ref)
               + ((plan.r,) if plan is not None else ()))

        def dispatch():
            chunk = _send(arr, devices[0])
            pin = self.input_patch_size

            def feed(t):
                return _gather.gather_patches(
                    chunk, torch.from_numpy(in_starts[t * B:(t + 1) * B]),
                    pin)

            stack = self._pipeline_stack(devices, feed, valid, T)
            outs = self._replay_1d(
                devices, lambda dev: _send(stack, dev), plan, slab, n_ref,
                valid, out_starts, chunk_shape)
            ready = self._record(outs) if probe else None
            return ready, self._collect(outs, plan is not None, chunk_shape)

        with telemetry.span("shard/dispatch", mesh=self.spec.describe()):
            ready, result = self._dispatch(key, dispatch)
        # stage handoffs: one activation micro-batch on each of the S-1
        # edges a tick (T + S - 1 ticks); the drain gathers each device's
        # weighted stack
        act_itemsize = 2 if self.precision_tag == "prec-bfloat16" else 4
        act_bytes = (B * self.num_input_channels
                     * int(np.prod(self.input_patch_size)) * act_itemsize)
        stack_bytes = n_ref * self.num_output_channels * int(
            np.prod(self.output_patch_size)) * 4
        self._note_collectives(
            key, 0.0, float(S * (S - 1) * stack_bytes),
            handoff_bytes=float((T + S - 1) * (S - 1) * act_bytes),
            flops=profiling.program_flops(self._programs, key))
        if plan is not None:
            self._replay_buffer_gauges(
                z, slab + 2 * self.output_patch_size[1], x, S)
        self._probe_chip_readiness(ready)
        return result

    def _pipeline_stack(self, devices, feed: Callable, valid: np.ndarray,
                        T: int) -> torch.Tensor:
        """The stage ring: at tick ``t`` stage ``s`` runs micro-batch
        ``t - s`` on ``devices[s]`` (stage 0 on ``entry(feed(t))``) and
        hands its activation to stage ``s + 1``; the last stage's tail,
        ``* bump * valid``, fills the weighted stack ``[T * B, co,
        *pout]`` on ``devices[-1]``. Stages run from the last to the
        first within a tick, so each consumes what its predecessor handed
        over on the tick before."""
        S = len(devices)
        B = self.batch_size
        stage_fns = pipe_mod.stage_groups(self.stage_bodies, S)
        # every stage runs on the one copy of the parameters: only the
        # identity engine, which has none, declares stages (as in the
        # JAX package)
        params = self.stage_params
        last = devices[-1]
        bump = self._bump(last)
        valid_d = device_valid(valid, last)
        stack = torch.empty((T * B, self.num_output_channels)
                            + self.output_patch_size, dtype=torch.float32,
                            device=last)
        inbox: List[Optional[torch.Tensor]] = [None] * S
        for t in range(T + S - 1):
            for s in reversed(range(S)):
                mb = t - s
                if not 0 <= mb < T:
                    continue
                x = self.stage_entry(feed(mb)) if s == 0 else inbox[s]
                act = stage_fns[s](params, x)
                if s < S - 1:
                    inbox[s + 1] = _send(act, devices[s + 1])
                    continue
                rows = slice(mb * B, (mb + 1) * B)
                out = self.stage_tail(params, act)
                torch.mul(out * bump[None, None],
                          valid_d[rows, None, None, None, None],
                          out=stack[rows])
        return stack

    def _run_spatial(self, arr, grid: PatchGrid, sharded_replay: bool):
        """The JAX ``_build_spatial_program`` and its dispatch. The chunk
        sharded over the (y, x) mesh: each shard's slab gets
        its halos from its neighbours (y phase, then x phase of the
        y-extended block, so corners arrive without diagonal sends; a
        border shard's missing neighbour gives zeros) and forwards the
        patches whose output start lies in its slab. Sharded replay: the
        fringe windows travel to the +y then +x neighbour and each shard
        replays ``own ∪ received`` in global order into its slab+margin
        buffer. Replicated: every shard gathers every stack, restores
        global order and replays the whole chunk."""
        devices = self.mesh()
        ny, nx = self.spec.shape
        B = self.batch_size
        c, z, y, x = tuple(arr.shape)
        pin = self.input_patch_size
        pout = self.output_patch_size
        geometry = (axis_geometry(y, ny, pin[1], pout[1]),
                    axis_geometry(x, nx, pin[2], pout[2]))
        (yslab, hl_y, hr_y, padded_y), (xslab, hl_x, hr_x, padded_x) = \
            geometry
        part = partition_for_mesh(grid, (ny, nx), B, yslab, xslab,
                                  hl_y, hl_x)
        plan = replay_plan_spatial(part, pout, (ny, nx), yslab, xslab,
                                   B) if sharded_replay else None
        self._gauges(int(c * z * yslab * xslab),
                     chip_patches=part.dev_valid.sum(axis=2).reshape(-1))
        probe = self._probing()

        def dev_of(dy, dx):
            return devices[dy * nx + dx]

        key = (("shard", "spatial", (ny, nx), (c, z, padded_y, padded_x),
                part.per_dev, len(part.valid))
               + ((plan.fy, plan.fx, plan.r) if plan is not None else ()))

        def dispatch():
            padded = _pad_chunk(arr, padded_y, padded_x)
            slabs = [[_send(padded[:, :, dy * yslab:(dy + 1) * yslab,
                                   dx * xslab:(dx + 1) * xslab]
                            .contiguous(), dev_of(dy, dx))
                      for dx in range(nx)] for dy in range(ny)]
            # 1a. the y halo exchange (ppermute i -> i+1 and i+1 -> i)
            ext = slabs
            if ny > 1:
                ext = [[_with_halos(lambda k, dx=dx: slabs[k][dx], dy, ny,
                                    2, yslab, hl_y, hr_y, dev_of(dy, dx))
                        for dx in range(nx)] for dy in range(ny)]
            # 1b. the x halo exchange of the y-extended blocks
            if nx > 1:
                ext_y = ext
                ext = [[_with_halos(lambda k, dy=dy: ext_y[dy][k], dx, nx,
                                    3, xslab, hl_x, hr_x, dev_of(dy, dx))
                        for dx in range(nx)] for dy in range(ny)]
            # 2. each shard's gather + forward over its extended slab
            stacks = [[self._forward_scan(
                dev_of(dy, dx), ext[dy][dx], part.dev_in[dy, dx],
                part.dev_valid[dy, dx])
                for dx in range(nx)] for dy in range(ny)]
            outs = []
            if plan is None:
                flat = [stacks[dy][dx] for dy in range(ny)
                        for dx in range(nx)]
                for dev in devices:
                    gathered = _all_gather(flat, dev)
                    outs.append(self._replay(
                        dev, self._slab_pick(
                            lambda p, g=gathered: g[p], part.src_index,
                            dev),
                        len(part.valid), part.valid, part.out_starts,
                        (z, y, x), (slice(None),) * 3))
            else:
                pools = self._fringe_exchange(stacks, plan, dev_of)
                m_y, m_x = plan.margin_y, plan.margin_x
                for dy in range(ny):
                    for dx in range(nx):
                        dev = dev_of(dy, dx)
                        outs.append(self._replay(
                            dev, self._slab_pick(
                                lambda p, pool=pools[dy][dx]: pool[p],
                                plan.index[dy, dx], dev),
                            plan.r, plan.valid[dy, dx],
                            plan.starts[dy, dx],
                            (z, yslab + 2 * m_y, xslab + 2 * m_x),
                            (slice(None), slice(m_y, m_y + yslab),
                             slice(m_x, m_x + xslab))))
            ready = self._record(outs) if probe else None
            if plan is None:
                return ready, _send(outs[0], self.device)
            rows = [torch.cat([_send(outs[dy * nx + dx], self.device)
                               for dx in range(nx)], dim=3)
                    for dy in range(ny)]
            return ready, torch.cat(rows, dim=2)[:, :, :y, :x]

        with telemetry.span("shard/dispatch", mesh=self.spec.describe()):
            ready, result = self._dispatch(key, dispatch)
        # halo traffic: each shard exchanges its halo rows (y, at slab
        # width) and columns (x, at the y-extended height), counted at
        # float32 as the JAX package counts them; plus the weighted-stack
        # all_gather (replicated) or the fringe strips (sharded)
        n_chips = ny * nx
        halo_bytes = 0.0
        if ny > 1:
            halo_bytes += n_chips * c * z * (hl_y + hr_y) * xslab * 4
        if nx > 1:
            halo_bytes += (n_chips * c * z * (yslab + hl_y + hr_y)
                           * (hl_x + hr_x) * 4)
        row_bytes = self.num_output_channels * int(np.prod(pout)) * 4
        if plan is None:
            gather_bytes = float(n_chips * (n_chips - 1) * part.per_dev
                                 * row_bytes)
            strip_bytes = 0.0
        else:
            gather_bytes = 0.0
            strip_bytes = float(
                ((ny - 1) * nx * plan.fy + ny * (nx - 1) * plan.fx)
                * row_bytes)
        self._note_collectives(key, halo_bytes, gather_bytes,
                               replay_strip_bytes=strip_bytes,
                               flops=profiling.program_flops(
                                   self._programs, key))
        if plan is not None:
            self._replay_buffer_gauges(
                z, yslab + 2 * plan.margin_y, xslab + 2 * plan.margin_x,
                n_chips)
        self._probe_chip_readiness(ready)
        return result

    def _fringe_exchange(self, stacks, plan: _ReplayPlan, dev_of):
        """Each shard's replay pool ``own ++ recv_y ++ recv_x ++ zero``
        as a list of rows (None for a zero row): the whole weighted
        windows crossing the +y boundary travel to the +y neighbour, then
        the pool rows crossing +x (corners among them) to the +x one."""
        ny, nx = self.spec.shape
        fy, fx = plan.fy, plan.fx

        def strip(pool, index, device):
            rows = [pool[int(p)] for p in index]
            return list(_send(torch.stack([
                torch.zeros_like(pool[0]) if r is None else r
                for r in rows]), device))

        pools = [[list(stacks[dy][dx]) for dx in range(nx)]
                 for dy in range(ny)]
        if ny > 1 and fy:
            recv = [[strip(pools[dy - 1][dx], plan.fringe_y[dy - 1, dx],
                           dev_of(dy, dx)) if dy > 0 else [None] * fy
                     for dx in range(nx)] for dy in range(ny)]
            for dy in range(ny):
                for dx in range(nx):
                    pools[dy][dx] += recv[dy][dx]
        if nx > 1 and fx:
            recv = [[strip(pools[dy][dx - 1], plan.fringe_x[dy, dx - 1],
                           dev_of(dy, dx)) if dx > 0 else [None] * fx
                     for dx in range(nx)] for dy in range(ny)]
            for dy in range(ny):
                for dx in range(nx):
                    pools[dy][dx] += recv[dy][dx]
        for row in pools:
            for pool in row:
                pool.append(None)
        return pools

    def _collect(self, outs, sharded: bool, chunk_shape) -> torch.Tensor:
        """The 1D kinds' result on the engine's device: the y slabs in
        order, cropped to the chunk (sharded), or the first shard's copy
        (replicated: every shard holds the same)."""
        if not sharded:
            return _send(outs[0], self.device)
        slabs = [_send(o, self.device) for o in outs]
        return torch.cat(slabs, dim=2)[:, :, :chunk_shape[2], :]

    # ------------------------------------------------------------------
    def serve_forward_program(self) -> Callable:
        """The serving packer's forward over the devices of this mesh:
        ``program(patches [B * n, ci, *pin], valid) -> forward * bump *
        valid`` on the patches' device, ``valid`` the host column (ones
        for the packed rows, then zeros). The data and spatial
        kinds split the packed batch into one share of rows per device
        (``[B, ...]`` each: the single-device loop's per-batch shape);
        the pipeline kind streams it through the stage ring as ``n``
        micro-batches of B. A batch collected under a wider mesh (a
        kill-switch race) has more rows; each device then takes its
        share of them."""
        n_chips = self.spec.n_devices
        pipelined = self.spec.kind == "pipeline"
        if pipelined:
            pipe_mod.require_stages(
                self.stage_bodies, self.stage_tail,
                "serving over CHUNKFLOW_MESH=" + self.spec.describe())
        return profiling.cached_program(
            self._programs,
            ("serve_forward", n_chips) + (("pipeline",) if pipelined else ()),
            self._build_serve_forward, label="sharded", device=self.device)

    def _build_serve_forward(self) -> Callable:
        n_chips = self.spec.n_devices

        def program(patches: torch.Tensor, valid: np.ndarray):
            devices = self.mesh()
            home = patches.device
            if self.spec.kind == "pipeline":
                B = self.batch_size

                def feed(t):
                    return _send(patches[t * B:(t + 1) * B], devices[0])

                stack = self._pipeline_stack(devices, feed, valid,
                                             patches.shape[0] // B)
                return _send(stack, home)
            per = patches.shape[0] // n_chips
            outs = []
            for i, dev in enumerate(devices):
                rows = slice(i * per, (i + 1) * per)
                preds = self._forward_for(dev)(_send(patches[rows], dev))
                outs.append(
                    preds * self._bump(dev)[None, None]
                    * device_valid(valid[rows], dev)[:, None, None, None,
                                                     None])
            return torch.cat([_send(o, home) for o in outs])

        return program

    # ------------------------------------------------------------------
    def _gauges(self, per_chip_voxels: int, chip_patches=None) -> None:
        spec = self.spec
        telemetry.gauge("shard/mesh_devices", float(spec.n_devices))
        if spec.kind in ("data", "pipeline"):
            telemetry.gauge("shard/mesh_y", 1.0)
            telemetry.gauge("shard/mesh_x", 1.0)
        else:
            telemetry.gauge("shard/mesh_y", float(spec.shape[0]))
            telemetry.gauge("shard/mesh_x", float(spec.shape[1]))
        telemetry.gauge(
            "shard/mesh_pipeline",
            float(spec.shape[0]) if spec.kind == "pipeline" else 0.0,
        )
        telemetry.gauge("shard/per_chip_voxels", float(per_chip_voxels))
        if chip_patches is not None:
            # output voxels each shard computes this dispatch: its valid
            # patches times the output patch's voxels
            pvox = float(np.prod(self.output_patch_size))
            for i, npatches in enumerate(chip_patches):
                telemetry.chip_gauge("shard", i, "voxels",
                                     float(npatches) * pvox)
        telemetry.inc("shard/chunks")

    def _dispatch(self, key, body):
        """``body()`` as one call of the ledger's program ``key``."""
        return profiling.run_program(self._programs, key, body,
                                     label="sharded", device=self.device)

    def _note_collectives(self, key, halo_bytes: float, gather_bytes: float,
                          replay_strip_bytes: float = 0.0,
                          handoff_bytes: float = 0.0,
                          flops=None) -> None:
        """This dispatch's analytic traffic between devices: input halos,
        weighted-stack gathers, fringe strips and stage handoffs, each a
        counter and a per-chunk gauge, and their sum in
        ``shard/collective_bytes`` and the family bucket of ``key``
        (``profiling.note_collective``). ``flops`` is the program's FLOPs
        from the ledger: with it, the collective-vs-compute split gauges
        ``shard/compute_s_est``, ``shard/collective_s_est`` and
        ``shard/collective_share_est``; without it only the byte planes
        are recorded."""
        if not telemetry.enabled():
            return
        for name, nbytes in (("halo_bytes", halo_bytes),
                             ("gather_bytes", gather_bytes),
                             ("replay_strip_bytes", replay_strip_bytes),
                             ("handoff_bytes", handoff_bytes)):
            if nbytes > 0:
                telemetry.inc(f"shard/{name}", float(nbytes))
                telemetry.gauge(f"shard/{name}_per_chunk", float(nbytes))
        total = (float(halo_bytes) + float(gather_bytes)
                 + float(replay_strip_bytes) + float(handoff_bytes))
        if total > 0:
            profiling.note_collective(total, key=key, label="sharded")
        if flops:
            split = profiling.estimate_collective_split(
                flops, total, profiling.device_identity(self.device)[1])
            telemetry.gauge("shard/compute_s_est", split["compute_s"])
            telemetry.gauge("shard/collective_s_est", split["collective_s"])
            telemetry.gauge("shard/collective_share_est",
                            split["collective_share"])

    def _replay_buffer_gauges(self, z: int, buf_y: int, buf_x: int,
                              n_chips: int) -> None:
        """The analytic blend-buffer footprint of one shard (out and
        weight planes, float32): slab+margin under the sharded replay."""
        if not telemetry.enabled():
            return
        nbytes = float((self.num_output_channels + 1) * z * buf_y * buf_x
                       * 4)
        telemetry.gauge("shard/replay_buffer_bytes", nbytes)
        for i in range(n_chips):
            telemetry.chip_gauge("shard", i, "replay_buffer_bytes", nbytes)

    def _chip_probe_every(self) -> int:
        raw = os.environ.get("CHUNKFLOW_CHIP_PROBE_EVERY", "")
        try:
            return max(1, int(raw)) if raw else 8
        except ValueError:
            return 8

    def _probing(self) -> bool:
        """Whether this dispatch runs the readiness probe: the first, then
        every ``CHUNKFLOW_CHIP_PROBE_EVERY``-th; never with telemetry
        off."""
        n = self._dispatches
        self._dispatches = n + 1
        return telemetry.enabled() and n % self._chip_probe_every() == 0

    @staticmethod
    def _record(outs) -> list:
        """One readiness marker per shard output, in device order: a CUDA
        event recorded on its device's current stream (None on the
        CPU)."""
        ready = []
        for out in outs:
            event = None
            if out.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(out.device))
            ready.append(event)
        return ready

    def _probe_chip_readiness(self, ready) -> None:
        """Wait on each shard's output in device order, recording the
        wall until each is ready (``shard/chip/<i>/ready_s``) and the
        skew between the first and the last. ``ready`` is None when this
        dispatch is not sampled."""
        if ready is None:
            return
        t0 = time.perf_counter()
        readies = []
        for event in ready:
            if event is not None:
                event.synchronize()
            readies.append(time.perf_counter() - t0)
        if not readies:
            return
        for i, ready_s in enumerate(readies):
            telemetry.chip_gauge("shard", i, "ready_s", ready_s)
        telemetry.gauge("shard/chip_skew_s", readies[-1] - readies[0])

    # ------------------------------------------------------------------
    def run(self, arr: torch.Tensor, grid: PatchGrid,
            host_params=None) -> torch.Tensor:
        """Run one chunk ``[C, Z, y, x]`` (raw, on the engine's device)
        over the mesh; returns the normalized output on the engine's
        device. Nothing here waits for a device, but the sampled
        readiness probe. In a world of several processes
        (``parallel/multihost.py``) it runs :meth:`_run_multiprocess`;
        ``host_params`` is the parameter tree the cross-process
        consistency guard digests."""
        from chunkflow_tpu_torch.parallel import multihost

        if multihost.process_count() > 1:
            return self._run_multiprocess(arr, grid, host_params)
        return self._run_local(arr, grid)

    def _run_local(self, arr: torch.Tensor,
                   grid: PatchGrid) -> torch.Tensor:
        sharded = shard_replay_mode() == "sharded"
        if self.spec.kind == "data":
            return self._run_data(arr, grid, sharded)
        if self.spec.kind == "pipeline":
            return self._run_pipeline(arr, grid, sharded)
        return self._run_spatial(arr, grid, sharded)

    def _run_multiprocess(self, arr: torch.Tensor, grid: PatchGrid,
                          host_params) -> torch.Tensor:
        """A world spanning processes. With collectives the data kind runs
        the cross-process recipe (the psum program over the global device
        list behind ``run_global``'s guard, ulp-level against one
        device); every other case checks the guard and computes over this
        process's local devices (bitwise one device, so every process
        holds the same copy)."""
        from chunkflow_tpu_torch.parallel import multihost

        if multihost.backend_supports_collectives() \
                and self.spec.kind == "data":
            from chunkflow_tpu_torch.parallel.distributed import (
                prepare_sharded,
            )

            # the shards' forwards carry their parameters; the raw chunk
            # goes to the gather, which converts it as the one-device path
            mesh = multihost.global_mesh()
            n_glob = len(mesh)
            program, in_starts, out_starts, valid = prepare_sharded(
                self, grid, mesh)
            voxels = int(np.prod(tuple(arr.shape)[1:]))
            self._gauges(voxels, chip_patches=valid.reshape(n_glob, -1)
                         .sum(axis=1))
            with telemetry.span("shard/dispatch", mesh="global"):
                out = multihost.run_global(program, arr, in_starts,
                                           out_starts, valid, host_params,
                                           mesh)
            # the cross-process recipe all-reduces partial float32 blend
            # buffers: a ring all-reduce moves ~2(n-1) output-buffer copies
            out_bytes = self.num_output_channels * voxels * 4
            rec = getattr(program, "_rec", None)
            self._note_collectives(
                ("shard", "global"), 0.0,
                float(2 * (n_glob - 1) * out_bytes),
                flops=getattr(rec, "flops", None))
            return _send(out, self.device)

        # no cross-process collectives: guard, then compute locally
        multihost.ensure_consistent(arr, host_params)
        spec = self._local_spec()
        local = self._local_engines.get(spec)
        if local is None:
            local = self._local_engines[spec] = ShardedEngine(
                self.forward, self.num_input_channels,
                self.num_output_channels, self.input_patch_size,
                self.output_patch_size, self.batch_size, spec,
                out_dtype=self.out_dtype,
                devices=multihost.local_devices(self.device),
                stage_entry=self.stage_entry,
                stage_bodies=self.stage_bodies, stage_tail=self.stage_tail,
                stage_params=self.stage_params,
                precision_tag=self.precision_tag,
                forward_on=self.forward_on, device=self.device)
        return local._run_local(arr, grid)

    def _local_spec(self) -> MeshSpec:
        """This spec clamped to the process-local device count (the
        no-collectives leg), as the JAX package clamps it."""
        from chunkflow_tpu_torch.parallel import multihost

        n_local = len(multihost.local_devices(self.device))
        if self.spec.kind == "data":
            n = min(self.spec.shape[0], n_local)
            return (MeshSpec("data", (n,)) if n > 1
                    else MeshSpec("data", (max(n_local, 1),)))
        if self.spec.kind == "pipeline":
            # fewer devices means coarser stage groups: the stage
            # protocol keeps the composition (and the bits) identical
            n = min(self.spec.shape[0], n_local)
            return (MeshSpec("pipeline", (n,)) if n > 1
                    else MeshSpec("data", (max(n_local, 1),)))
        ny, nx = self.spec.shape
        if ny * nx <= n_local:
            return self.spec
        # shrink y first (the outer axis) until the mesh fits
        while ny * nx > n_local and ny > 1:
            ny -= 1
        while ny * nx > n_local and nx > 1:
            nx -= 1
        return MeshSpec("spatial", (max(ny, 1), max(nx, 1))) \
            if ny * nx > 1 else MeshSpec("data", (max(n_local, 1),))


# ---------------------------------------------------------------------------
# the standalone entry (the legacy wrappers')
# ---------------------------------------------------------------------------

def sharded_inference(
    chunk_array,
    engine,
    input_patch_size: Triple,
    output_patch_size: Optional[Triple] = None,
    output_patch_overlap: Triple = (0, 0, 0),
    batch_size: int = 1,
    spec: Optional[MeshSpec] = None,
    mesh_spec: Optional[str] = None,
    out_dtype: str = "float32",
    devices=None,
    device="cuda",
):
    """Mesh inference of a raw array with a raw ``engines.Engine``, the
    entry the legacy ``distributed.sharded_inference`` and
    ``spatial*_sharded_inference`` wrappers delegate to. The array (numpy
    or a tensor) is moved to ``device`` (a CUDA device unless the caller
    asks for the CPU; it raises without a card) as float32, and the
    result stays there. ``devices`` defaults to the local devices of
    ``device``; a shard on a device other than the parameters' runs the
    engine's call on a copy of them there. In a world of several
    processes (``multihost.sharded_inference_global``) the cross-process
    guard digests ``engine.params``."""
    device = resolve_device(device)
    arr = torch.as_tensor(chunk_array).to(device=device,
                                          dtype=torch.float32)
    devices = mesh_devices(devices, device)
    if spec is None:
        n_local = len(devices)
        spec = (parse_mesh_spec(mesh_spec, n_local) if mesh_spec
                else MeshSpec("data", (n_local,)))
    pin = tuple(input_patch_size)
    pout = tuple(output_patch_size) if output_patch_size else pin
    if arr.dim() == 3:
        arr = arr[None]
    arr = arr.contiguous()
    grid = enumerate_patches(tuple(arr.shape), pin, pout,
                             tuple(output_patch_overlap))
    sharded = ShardedEngine.for_engine(
        engine, pin, tuple(grid.output_patch_size), batch_size, spec,
        out_dtype=out_dtype, devices=devices, device=device)
    with torch.no_grad():
        return sharded.run(arr, grid, host_params=engine.params)
