"""The ``CHUNKFLOW_MESH`` grammar: a copy of ``parse_mesh_spec`` from
``chunkflow_tpu/parallel/engine.py``.

The JAX ``Inferencer`` reads the variable once per chunk and runs a
sharded engine for any spec but the single-device one. The port parses
the same grammar with the same errors; a spec that the devices could
satisfy raises ``NotImplementedError`` naming the multi-GPU engine
(ROADMAP, queue 1), which is not ported.
"""
from __future__ import annotations

import os
import re
from typing import NamedTuple, Optional, Tuple

_OFF_VALUES = ("", "1", "none", "off", "single", "0")


class MeshSpec(NamedTuple):
    """A parsed mesh request: ``kind`` is ``single``, ``data``,
    ``spatial`` (a ``(ny, nx)`` mesh) or ``pipeline``."""

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
    """Parse a mesh spec string; ``n_devices`` bounds ``auto`` and
    validates explicit sizes (``None`` defers the check)."""
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


def mesh_env_spec() -> MeshSpec:
    """The ``CHUNKFLOW_MESH`` spec (default: single device), re-read per
    call as the JAX package does per chunk."""
    return parse_mesh_spec(os.environ.get("CHUNKFLOW_MESH", "1"))


def require_single_device(n_devices: int) -> None:
    """Raise as the JAX package's sharded engine does when the
    ``CHUNKFLOW_MESH`` spec needs more devices than exist; raise
    ``NotImplementedError`` when they would suffice (no multi-GPU engine
    yet). A single-device spec returns."""
    spec = mesh_env_spec()
    if spec.kind == "single":
        return
    if spec.n_devices > n_devices:
        raise ValueError(
            f"mesh spec {spec.describe()!r} needs {spec.n_devices} "
            f"devices, only {n_devices} available"
        )
    raise NotImplementedError(
        f"CHUNKFLOW_MESH={spec.describe()} is not ported yet (ROADMAP, "
        f"queue 1: multi-GPU engine)")
