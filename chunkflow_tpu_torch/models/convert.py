"""Weights into the port's convnets: flax params, torch state dicts, files.

The counterpart of ``chunkflow_tpu/models/converter.py`` and of
``init_or_load_params`` in ``chunkflow_tpu/models/unet3d.py``. The JAX
package converts a torch state dict INTO flax params; the port's models
are torch modules, so a reference checkpoint needs no layout change, only
the JAX package's pairing rules (by name, BatchNorm folded, strict; or
positional when no name matches), and flax params need the inverse of
its layout change:

- Conv kernel ``[kz, ky, kx, I, O]`` -> Conv3d weight ``[O, I, kz, ky, kx]``
- ConvTranspose kernel (modules ``up{i}``) ``[kz, ky, kx, I, O]`` ->
  ConvTranspose3d weight ``[I, O, kz, ky, kx]``, spatially FLIPPED:
  flax's transposed conv does not flip its kernel the way torch's
  gradient-based one does (``converter.py:69-74`` flips on the way in)
- norm and affine ``scale`` / ``bias`` -> ``weight`` / ``bias``

Flax params come as nested dicts of numpy arrays (``np.asarray`` of each
flax leaf, or a ``.msgpack`` file read by ``models/flax_msgpack.py``), so
this module needs no JAX.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from chunkflow_tpu_torch.models import flax_msgpack
from chunkflow_tpu_torch.models.unet3d import seeded_init

# BatchNorm3d's default epsilon: a state dict does not carry the layer's
BN_EPS = 1e-5
_BN_STATS = (".running_mean", ".running_var", ".num_batches_tracked")


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (str(key),))
    elif isinstance(tree, torch.Tensor):  # bfloat16 leaves of a msgpack
        yield prefix, tree.float().numpy()
    else:
        yield prefix, np.asarray(tree)


def state_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``UNet3D`` (every variant) or ``RSUNet``
    from the flax param tree (``variables["params"]``) of the JAX
    package's model of the same family and widths."""
    state = {}
    for path, value in _leaves(params):
        module, leaf = path[:-1], path[-1]
        key = ".".join(module)
        if leaf == "kernel":
            if value.ndim != 5:
                raise ValueError(f"{'/'.join(path)}: expected a 3D conv "
                                 f"kernel, got shape {value.shape}")
            if module[-1].startswith("up"):
                value = np.transpose(value[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))
            else:
                value = np.transpose(value, (4, 3, 0, 1, 2))
            state[f"{key}.weight"] = value
        elif leaf == "scale":
            state[f"{key}.weight"] = value
        elif leaf == "bias":
            state[f"{key}.bias"] = value
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    # one host copy per leaf: flipped views and read-only flax arrays
    # become plain contiguous tensors
    return {
        k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
        for k, v in state.items()
    }


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt``/``.pth`` state dict on the CPU; a ``{"state_dict": ...}``
    wrapper and DataParallel ``module.`` prefixes are taken off."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k.removeprefix("module."): v for k, v in state.items()}


def _numpy(state) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in state.items()}


class NameConversionError(KeyError):
    """Name-based conversion failed; ``matched`` counts the template
    entries that DID find a torch parameter (0: the two share no names
    and a positional fallback is safe; more: the names were meant to
    match and falling back would risk silent mis-pairing)."""

    def __init__(self, message: str, matched: int):
        super().__init__(message)
        self.matched = matched


def state_from_torch_by_name(state, template) -> Dict[str, torch.Tensor]:
    """A reference torch state dict as the state dict ``template`` (the
    port model's own) by PARAMETER NAME, independent of the order in
    which the reference model defines its modules
    (``converter.py:torch_to_flax_by_name``).

    BatchNorm folding: a 1-D ``weight``/``bias`` whose torch module has
    ``running_mean``/``running_var`` becomes the inference affine
    ``scale = gamma / sqrt(var + BN_EPS)``, ``bias = beta - mean * scale``,
    in float32 numpy and in the JAX converter's order, so the folded
    parameters are bitwise its own. Raises :class:`NameConversionError`
    for a template entry with no torch parameter and ``ValueError`` for a
    torch parameter left over (running statistics aside) or a shape that
    does not match.
    """
    state = _numpy(state)
    converted: Dict[str, np.ndarray] = {}
    used: set = set()
    missing: List[str] = []
    for key, target in template.items():
        prefix, leaf = key.rsplit(".", 1)
        mean_key = f"{prefix}.running_mean"
        out = None
        if target.dim() == 1 and mean_key in state:  # BatchNorm -> affine
            var = state[f"{prefix}.running_var"]
            gamma = state.get(f"{prefix}.weight", np.ones_like(var))
            beta = state.get(f"{prefix}.bias", np.zeros_like(var))
            scale = gamma / np.sqrt(var + BN_EPS)
            out = scale if leaf == "weight" else beta - state[mean_key] * scale
            used.update(
                k for k in (
                    f"{prefix}.weight", f"{prefix}.bias", mean_key,
                    f"{prefix}.running_var",
                    f"{prefix}.num_batches_tracked",
                ) if k in state
            )
        elif key in state:
            out = state[key]
            used.add(key)
        if out is None:
            missing.append(key)
            continue
        if tuple(np.shape(out)) != tuple(target.shape):
            raise ValueError(f"shape mismatch converting {key} "
                             f"{np.shape(out)} -> {tuple(target.shape)}")
        converted[key] = out
    if missing:
        raise NameConversionError(
            f"no torch parameter found for: {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''}; available torch keys "
            f"include {sorted(state)[:8]}...",
            matched=len(converted),
        )
    leftovers = [k for k in state
                 if k not in used and not k.endswith(_BN_STATS)]
    if leftovers:
        raise ValueError(
            f"torch parameters not consumed by the model: {leftovers[:8]}"
            f"{'...' if len(leftovers) > 8 else ''}"
        )
    return {k: torch.from_numpy(np.array(v)) for k, v in converted.items()}


def _category(name: str, shape) -> str:
    if name.endswith(_BN_STATS):
        return "skip"
    if len(shape) >= 2 and name.endswith("weight"):
        return "kernel"
    if name.endswith("weight"):
        return "scale"
    if name.endswith("bias"):
        return "bias"
    return "other"


def state_from_torch_positional(state, template) -> Dict[str, torch.Tensor]:
    """``converter.py:torch_to_flax``'s fallback: tensors paired in order
    within each kind (conv kernels, 1-D scales, biases), every pair
    shape-checked. Right when the reference model defines its modules in
    execution order, as the port's models do; running statistics are
    skipped, not folded, as in the JAX package."""
    by_kind: Dict[str, list] = {}
    for name, value in _numpy(state).items():
        by_kind.setdefault(_category(name, value.shape), []).append(
            (name, value))
    targets: Dict[str, list] = {}
    for key, target in template.items():
        targets.setdefault(_category(key, target.shape), []).append(
            (key, target))
    converted = {}
    for kind, items in targets.items():
        sources = by_kind.get(kind, [])
        if len(sources) != len(items):
            raise ValueError(
                f"cannot convert: {len(sources)} torch '{kind}' tensors vs "
                f"{len(items)} in the model; architectures do not mirror. "
                f"torch: {[n for n, _ in sources]}; "
                f"model: {[k for k, _ in items]}"
            )
        for (name, value), (key, target) in zip(sources, items):
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch converting {name} "
                                 f"{value.shape} -> {key} "
                                 f"{tuple(target.shape)}")
            converted[key] = torch.from_numpy(np.array(value))
    return converted


def init_or_load_weights(model: nn.Module,
                         weight_path: Optional[str]) -> nn.Module:
    """Weights for ``model`` (``init_or_load_params``):

    - ``None``/empty    -> :func:`models.unet3d.seeded_init` from seed 0
    - ``*.pt``/``*.pth`` -> a torch state dict, by name; positional only
      when no name matched
    - ``*.msgpack``      -> flax params (``serialization.to_bytes``)
    - a directory        -> an orbax checkpoint: not ported, raises
    """
    if not weight_path:
        return seeded_init(model, torch.Generator().manual_seed(0))
    if not os.path.exists(weight_path):
        raise FileNotFoundError(f"weights not found: {weight_path}")
    template = model.state_dict()
    if weight_path.endswith((".pt", ".pth")):
        state = load_torch_state_dict(weight_path)
        try:
            state = state_from_torch_by_name(state, template)
        except NameConversionError as e:
            if e.matched > 0:
                raise
            state = state_from_torch_positional(state, template)
    elif weight_path.endswith(".msgpack"):
        state = state_from_flax(flax_msgpack.load(weight_path))
    elif os.path.isdir(weight_path):
        raise NotImplementedError(
            f"{weight_path}: orbax checkpoint directories are not ported "
            f"yet: their OCDBT/tensorstore format has no reader without "
            f"JAX (ROADMAP, queue 1: convnet engines, orbax checkpoints)")
    else:
        raise ValueError(f"{weight_path}: weights are a .pt/.pth state "
                         f"dict, a flax .msgpack file or an orbax directory")
    model.load_state_dict(state)
    return model
