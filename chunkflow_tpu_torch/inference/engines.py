"""Patch inference engines: batch-forward callables on tensors.

The counterpart of ``chunkflow_tpu/inference/engines.py``. An engine's
``apply`` maps a ``[B, Cin, *in_patch]`` float32 batch to ``[B, Cout,
*out_patch]`` float32 on the batch's device; ``model`` (when there is
one) is the ``nn.Module`` the inferencer moves to its device. Frameworks:
``identity`` (the test oracle), ``pytorch`` / ``flax`` / ``jax`` (the
built-in parity UNet3D — the names are kept for CLI parity with the JAX
package, whose flax engine loads the same ``.pt`` weights), and
``prebuilt`` (an ``Engine`` passed in).
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from chunkflow_tpu_torch.models.unet3d import UNet3D


class Engine(NamedTuple):
    apply: Callable  # [B, Cin, *pin] float32 -> [B, Cout, *pout] float32
    num_input_channels: int
    num_output_channels: int
    model: Optional[nn.Module] = None


def create_identity_engine(
    input_patch_size,
    output_patch_size,
    num_output_channels: int = 1,
    num_input_channels: int = 1,
) -> Engine:
    """Crop-and-repeat oracle: output is the input's first channel's
    central crop, repeated across output channels. Identity through the
    whole blend path must reproduce the input exactly."""
    pin = tuple(input_patch_size)
    pout = tuple(output_patch_size)
    margin = tuple((i - o) // 2 for i, o in zip(pin, pout))
    window = tuple(slice(m, m + o) for m, o in zip(margin, pout))

    def apply(batch):
        center = batch[(slice(None), slice(0, 1)) + window]
        return center.expand((batch.shape[0], num_output_channels) + pout)

    return Engine(apply=apply, num_input_channels=num_input_channels,
                  num_output_channels=num_output_channels)


def create_unet3d_engine(
    weight_path: Optional[str],
    num_input_channels: int = 1,
    num_output_channels: int = 3,
    seed: int = 0,
) -> Engine:
    """The parity UNet3D; weights from a ``.pt``/``.pth`` state dict (a
    ``{"state_dict": ...}`` wrapper and DataParallel ``module.`` prefixes
    are accepted), or a seeded init when ``weight_path`` is None."""
    model = UNet3D(in_channels=num_input_channels,
                   out_channels=num_output_channels)
    if weight_path:
        if not weight_path.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"{weight_path}: the port loads .pt/.pth state dicts; flax "
                "msgpack/orbax checkpoints are not ported yet (ROADMAP, "
                "queue 1: convnet engines)"
            )
        if not os.path.exists(weight_path):
            raise FileNotFoundError(f"weights not found: {weight_path}")
        state = torch.load(weight_path, map_location="cpu", weights_only=True)
        if "state_dict" in state:
            state = state["state_dict"]
        model.load_state_dict(
            {k.removeprefix("module."): v for k, v in state.items()}
        )
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.eval()

    def apply(batch):
        return model(batch)

    return Engine(apply=apply, num_input_channels=num_input_channels,
                  num_output_channels=num_output_channels, model=model)


def create_engine(framework: str, **kwargs) -> Engine:
    if framework == "prebuilt":
        engine = kwargs.get("engine")
        if not isinstance(engine, Engine):
            raise TypeError(
                "framework='prebuilt' needs an Engine instance as engine="
            )
        return engine
    if framework == "identity":
        return create_identity_engine(
            kwargs["input_patch_size"],
            kwargs["output_patch_size"],
            num_output_channels=kwargs.get("num_output_channels", 1),
            num_input_channels=kwargs.get("num_input_channels", 1),
        )
    if framework in ("pytorch", "flax", "jax"):
        if kwargs.get("model_path"):
            raise NotImplementedError(
                "user model files (model_path) are not ported yet; the "
                "port runs the built-in parity UNet3D (ROADMAP, queue 1: "
                "convnet engines)"
            )
        return create_unet3d_engine(
            kwargs.get("weight_path"),
            num_input_channels=kwargs.get("num_input_channels", 1),
            num_output_channels=kwargs.get("num_output_channels", 3),
        )
    if framework == "universal":
        raise NotImplementedError(
            "the universal engine is not ported yet (ROADMAP, queue 1: "
            "convnet engines)"
        )
    raise ValueError(f"unknown inference framework: {framework!r}")
