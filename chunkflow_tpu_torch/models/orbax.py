"""Orbax checkpoint directories, read without orbax.

The JAX package restores weights from a directory with
``orbax.checkpoint.StandardCheckpointer().restore`` (``inference -w
<dir>``). Such a directory holds ``_METADATA``, a JSON file whose
``tree_metadata`` names every leaf of the param tree by its key path,
and says how the arrays were stored:

- ``use_ocdbt`` (orbax's default): one OCDBT store (``volume/ocdbt.py``)
  at the root, its ``manifest.ocdbt`` merging the processes' own
  (``ocdbt.process_0/``);
- else one directory per leaf;
- ``use_zarr3``: each leaf a zarr v3 array (one ``sharding_indexed``
  shard of zstd inner chunks, its index checked by crc32c), else zarr v2
  (orbax's default, each chunk a zstd frame).

A leaf's array is named by its key path joined with ``"."``
(``conv_in.kernel``) and read through ``volume/zarr.py``. A ``bfloat16``
leaf reads as float32 (exactly). :func:`load_params` gives the nested
param tree of numpy arrays that ``convert.state_from_flax`` takes, as the
``.msgpack`` reader does; opening the store is timed into the telemetry
span ``orbax/open``, each chunk's read and decode into ``volume/zarr.py``'s
spans. What the JAX package's restore refuses raises ``ValueError``
naming the file or the leaf, as the restore does: an OCDBT save without a
root manifest (a multi-process save the root never merged), a leaf keyed
by other than a dict key or whose value is not an array (an added
``step: 5``); ``convert.init_or_load_weights`` refuses a tree whose leaves
are not the model's.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import torch

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.volume.ocdbt import MANIFEST, OcdbtKV
from chunkflow_tpu_torch.volume.storage import FileKV, KVBackend
from chunkflow_tpu_torch.volume.zarr import open_array

METADATA = "_METADATA"
#: orbax's key types: a dict key (the only kind a flax param tree has)
DICT_KEY = 2
ARRAY_TYPES = ("jax.Array", "np.ndarray")


def _refused(path: str, what: str):
    raise ValueError(f"{path}: {what}; the JAX package's orbax restore "
                     f"refuses it too")


def open_store(path: str, metadata: dict) -> KVBackend:
    """The KV plane a checkpoint's arrays live in."""
    base = FileKV(path)
    if not metadata.get("use_ocdbt"):
        return base
    if base.read_bytes(MANIFEST) is None:
        _refused(path, "an OCDBT checkpoint without a root manifest.ocdbt "
                       "(a multi-process save the root did not merge)")
    return OcdbtKV(base)


def load_params(path: str) -> Dict:
    """The param tree saved in the orbax directory ``path``: nested dicts
    of numpy arrays."""
    try:
        with open(os.path.join(path, METADATA)) as f:
            metadata = json.load(f)
    except FileNotFoundError:
        raise ValueError(f"{path}: not an orbax checkpoint (no "
                         f"{METADATA})") from None
    if "tree_metadata" not in metadata:
        _refused(path, f"a {METADATA} without tree_metadata")
    with telemetry.span("orbax/open"):
        kv = open_store(path, metadata)
    driver = "zarr3" if metadata.get("use_zarr3") else "zarr"
    tree: Dict = {}
    for name, leaf in metadata["tree_metadata"].items():
        keys = leaf["key_metadata"]
        if any(k.get("key_type") != DICT_KEY for k in keys):
            _refused(path, f"the leaf {name}, keyed by other than dict "
                           f"keys")
        value = leaf["value_metadata"]
        if value.get("skip_deserialize"):
            continue
        if value.get("value_type") not in ARRAY_TYPES:
            _refused(path, f"the leaf {name} of value type "
                           f"{value.get('value_type')!r}, not an array")
        parts = [str(k["key"]) for k in keys]
        values = open_array(".".join(parts), driver, kv=kv).read_values()
        if isinstance(values, torch.Tensor):  # bfloat16
            values = values.float().numpy()
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = values
    return tree
