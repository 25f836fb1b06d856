"""The stage protocol of the ``pipeline=N`` mesh.

The counterpart of ``chunkflow_tpu/parallel/pipeline.py``. The mesh
engine (``parallel/engine.py``) stages an engine's layer stack over the
devices of a ``pipeline=N`` mesh and streams patch micro-batches through
them; this module owns the contract an engine must meet to be split.

**The stage protocol.** An :class:`~chunkflow_tpu_torch.inference.engines.
Engine` opts in with two fields:

- ``stage_bodies``: a tuple of ``(params, x) -> x`` callables, each
  mapping a ``[B, ci, *pin]`` activation to the same shape and dtype
  (the handoff between two stages carries one uniform activation);
- ``stage_tail``: one ``(params, x) -> [B, co, *pout]`` callable closing
  the stack,

with ``apply == stage_tail ∘ stage_bodies[-1] ∘ ... ∘ stage_bodies[0]``
holding bitwise: an engine declares ``apply`` as that literal
composition, so the pipelined and unpipelined forwards run the same
floating-point expression per row. An engine whose forward is opaque (a
convnet, a user model, a TTA forward) declares no stages, and a
``pipeline=N`` mesh then raises (:func:`require_stages`) instead of
falling back.

:func:`stage_groups` regroups the declared bodies onto ``n_stages``
devices: contiguous balanced groups (a stage given no body is the
identity), which keeps the composition order.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

__all__ = ["stage_groups", "require_stages"]


def stage_groups(stage_bodies: Sequence[Callable],
                 n_stages: int) -> Tuple[Callable, ...]:
    """Regroup ``stage_bodies`` onto ``n_stages`` stages: contiguous
    balanced groups, the later stages taking the remainder (stage 0 also
    gathers the patches), each one ``(params, x) -> x`` callable. A stage
    with no body is the identity. The composition of the groups is the
    composition of the bodies, in order."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1 (got {n_stages})")
    bodies = tuple(stage_bodies)
    base, extra = divmod(len(bodies), n_stages)
    groups = []
    start = 0
    for s in range(n_stages):
        # stage s takes one extra body when s >= n_stages - extra
        count = base + (1 if s >= n_stages - extra else 0)
        group = bodies[start:start + count]
        start += count

        def run_group(params, x, _group=group):
            for body in _group:
                x = body(params, x)
            return x

        groups.append(run_group)
    return tuple(groups)


def require_stages(stage_bodies: Optional[Sequence[Callable]],
                   stage_tail: Optional[Callable],
                   context: str) -> None:
    """Raise when a pipeline mesh is asked of an engine that declares no
    stages: a silent fallback to the unpipelined forward would misreport
    the mesh the user asked for. The message is the JAX package's."""
    if stage_bodies is None or stage_tail is None:
        raise ValueError(
            f"{context} needs an engine declaring the stage protocol "
            f"(stage_bodies + stage_tail with apply == tail ∘ bodies, "
            f"parallel/pipeline.py); this engine's forward is opaque — "
            f"use a data or spatial mesh instead (docs/multichip.md "
            f"'Choosing a scaling shape')"
        )
