"""Patch-parallel inference: the legacy entry over the mesh engine, and
the psum program of the cross-process recipe.

The counterpart of ``chunkflow_tpu/parallel/distributed.py``. Its
single-process path delegates to :mod:`chunkflow_tpu_torch.parallel.
engine` (``data=N``), bitwise one device. What remains here is the
psum-merge program that the multi-process recipe runs
(``ShardedEngine._run_multiprocess``, behind ``multihost.run_global``'s
guard): when one inference spans processes, sending every device's
weighted stack to every process costs bandwidth for data no process
needs; each rank instead blends its share of the patches into partial
float32 ``out`` and ``weight`` buffers (the port's gather and accumulate
kernels, ``ops/blend.build_local_blend``), and
``torch.distributed.all_reduce`` sums them where the JAX program runs
``lax.psum``, at ulp-level (not bitwise) parity with one device. Each program is a
``shard`` record of the program cost ledger (``core/profiling.py``),
keyed ``("shard", "global", <mesh>)`` as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from chunkflow_tpu_torch.core import profiling, telemetry
from chunkflow_tpu_torch.inference.patching import pad_to_batch
from chunkflow_tpu_torch.ops.blend import (
    build_local_blend,
    device_valid,
    normalize_blend,
)

# psum programs kept on each engine, one per mesh
_PROGRAMS_MAX = 4


def build_sharded_program(
    forward_for,
    num_input_channels: int,
    num_output_channels: int,
    input_patch_size,
    output_patch_size,
    batch_size: int,
    mesh,
    bump_for,
    out_dtype="float32",
):
    """The multi-process fused inference: ``program(chunk, in_starts,
    out_starts, valid) -> output`` on this rank's first device.

    ``mesh`` is the global device list (``multihost.global_mesh()``);
    this rank runs the entries it drives. Patch arrays must be padded so
    N is divisible by (len(mesh) * batch_size) (``pad_to_batch`` with
    that product); global device ``d`` takes rows ``[d·N/n, (d+1)·N/n)``,
    as ``P("data")`` splits them. ``forward_for(device)`` is the forward
    whose parameters live on ``device``, ``bump_for(device)`` the bump
    map there. The chunk is given to every device (raw or float32: the
    gather converts it); each local device's partial buffers are summed
    on the first, the ranks' all-reduced, then normalized, cast to
    ``out_dtype`` after the float32 accumulation."""
    import torch.distributed as dist

    from chunkflow_tpu_torch.parallel import multihost

    rank = multihost.process_index()
    local = [(d, g.device) for d, g in enumerate(mesh) if g.process == rank]
    if not local:
        raise ValueError(f"the mesh holds no device of process {rank}")
    n_glob = len(mesh)

    def program(chunk, in_starts, out_starts, valid):
        n = len(valid)
        if n % (n_glob * batch_size):
            raise ValueError(
                f"{n} patches is not a multiple of {n_glob} devices x "
                f"batch {batch_size}; pad with pad_to_batch")
        per = n // n_glob
        home = local[0][1]
        chunk = torch.as_tensor(chunk)
        out = weight = None
        with torch.no_grad():
            for d, device in local:
                rows = slice(d * per, (d + 1) * per)
                blend = build_local_blend(
                    forward_for(device), num_input_channels,
                    num_output_channels, tuple(input_patch_size),
                    tuple(output_patch_size), batch_size, bump_for(device))
                o, w = blend(
                    chunk.to(device, non_blocking=True),
                    torch.from_numpy(np.ascontiguousarray(in_starts[rows])),
                    torch.from_numpy(np.ascontiguousarray(out_starts[rows])),
                    device_valid(valid[rows], device))
                if out is None:
                    out, weight = o.to(home), w.to(home)
                else:
                    out += o.to(home)
                    weight += w.to(home)
            if multihost.process_count() > 1:
                with telemetry.span("shard/all_reduce", backend=str(
                        multihost.backend())):
                    dist.all_reduce(out)
                    dist.all_reduce(weight)
            return normalize_blend(out, weight, out_dtype)

    return program


def prepare_sharded(engine, grid, mesh):
    """The psum recipe's plan for one chunk of ``engine`` (a
    ``ShardedEngine``): the rows of ``grid`` padded to batch x
    ``len(mesh)``, and the program over ``mesh``, built once per mesh and
    kept on the engine (the last four). Returns (program, in_starts,
    out_starts, valid)."""
    from chunkflow_tpu_torch.parallel.multihost import _mesh_key

    in_starts, out_starts, valid = pad_to_batch(
        grid, engine.batch_size * len(mesh))
    programs = engine._global_programs
    key = ("shard", "global", _mesh_key(mesh))
    program = profiling.cached_program(
        programs, key,
        lambda: build_sharded_program(
            engine._forward_for, engine.num_input_channels,
            engine.num_output_channels, engine.input_patch_size,
            engine.output_patch_size, engine.batch_size, mesh,
            engine._bump, out_dtype=engine.out_dtype),
        label="distributed", device=engine.device, maxsize=_PROGRAMS_MAX)
    return program, in_starts, out_starts, valid


def sharded_inference(
    chunk_array: np.ndarray,
    engine,
    input_patch_size,
    output_patch_size,
    output_patch_overlap,
    batch_size: int = 1,
    devices=None,
    device="cuda",
):
    """Patch-parallel inference over ``devices`` (default: the local
    devices of ``device``, every card; ``device="cpu"`` runs on the
    CPU), delegating to the mesh engine; the result is a tensor on
    ``device``."""
    from chunkflow_tpu_torch.parallel.engine import (
        MeshSpec,
        mesh_devices,
        sharded_inference as unified,
    )

    devices = mesh_devices(devices, device)
    return unified(
        chunk_array, engine, input_patch_size, output_patch_size,
        output_patch_overlap, batch_size=batch_size,
        spec=MeshSpec("data", (len(devices),)), devices=devices,
        device=device,
    )
