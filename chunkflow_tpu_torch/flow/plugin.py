"""User plugins: any python file with an ``execute(*inputs, **kwargs)``.

The counterpart of ``chunkflow_tpu/flow/plugin.py``. A name is looked
for in the working directory, then among the bundled plugins
(``chunkflow_tpu_torch/plugins/`` and its ``synapse/``), then in
``$CHUNKFLOW_PLUGIN_DIR``. Every bundled plugin of the JAX package has
its counterpart there; ``czann_inference`` and
``napari_pixel_classifier`` import their packages at ``execute``, as the
JAX package's do. An ndarray a plugin returns becomes a ``Chunk`` with
the first input chunk's metadata; when it shrank symmetrically (a
valid-mode filter), its voxel offset moves by half the shrink. Anything
else (``Synapses``, a dict of skeletons, a 1-D id array) passes through
as it is.
"""
from __future__ import annotations

import importlib.util
import os
from typing import List, Optional, Sequence

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk
from chunkflow_tpu_torch.core.cartesian import Cartesian

BUNDLED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "plugins")


def find_plugin(name: str) -> str:
    """A plugin name or path as a python file."""
    if not name.endswith(".py"):
        name = name + ".py"
    if os.path.isfile(name):
        return os.path.abspath(name)
    for rel in (name, os.path.join("synapse", name)):
        path = os.path.join(BUNDLED, rel)
        if os.path.isfile(path):
            return os.path.abspath(path)
    env_dir = os.environ.get("CHUNKFLOW_PLUGIN_DIR")
    if env_dir and os.path.isfile(os.path.join(env_dir, name)):
        return os.path.abspath(os.path.join(env_dir, name))
    raise FileNotFoundError(
        f"plugin {name!r} not found in ./, bundled plugins, or "
        f"$CHUNKFLOW_PLUGIN_DIR"
    )


def load_plugin(name: str):
    path = find_plugin(name)
    spec = importlib.util.spec_from_file_location(
        f"chunkflow_plugin_{os.path.basename(path)[:-3]}", path
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not hasattr(module, "execute"):
        raise AttributeError(f"plugin {path} has no execute() function")
    return module.execute


def str_to_dict(args: Optional[str]) -> dict:
    """Parse the plugin arguments' mini-language ``k=3;k2=(1,2);k3=abc``."""
    if not args:
        return {}
    out = {}
    for item in args.split(";"):
        if not item.strip():
            continue
        key, _, value = item.partition("=")
        out[key.strip()] = _simplest_type(value.strip())
    return out


def _simplest_type(text: str):
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    if text.startswith("(") and text.endswith(")"):
        inner = text[1:-1].strip().rstrip(",")
        if not inner:
            return ()
        return tuple(_simplest_type(t.strip()) for t in inner.split(","))
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip().rstrip(",")
        if not inner:
            return []
        return [_simplest_type(t.strip()) for t in inner.split(",")]
    return text


def wrap_outputs(outputs, inputs: Sequence) -> List:
    """A plugin's outputs, each ndarray wrapped as a Chunk with the first
    input chunk's voxel size, and its voxel offset shifted by half of a
    symmetric shrink of the spatial shape."""
    if outputs is None:
        return []
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    template = next((i for i in inputs if isinstance(i, Chunk)), None)
    wrapped = []
    for out in outputs:
        if isinstance(out, Chunk) or not isinstance(out, np.ndarray):
            wrapped.append(out)
            continue
        if template is None or out.ndim not in (3, 4):
            wrapped.append(out)
            continue
        in_shape = Cartesian.from_collection(template.shape[-3:])
        out_shape = Cartesian.from_collection(out.shape[-3:])
        shrink = in_shape - out_shape
        offset = template.voxel_offset
        if shrink != Cartesian.zeros() and shrink % 2 == Cartesian.zeros():
            offset = offset + shrink // 2
        wrapped.append(
            Chunk(out, voxel_offset=offset, voxel_size=template.voxel_size)
        )
    return wrapped
