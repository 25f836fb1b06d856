"""Reference-chunkflow pytorch model files into the port's convnets.

The counterpart of ``chunkflow_tpu/models/migrate.py``. The reference's
pytorch engine contract (patch/pytorch.py:48-83) is a user ``model.py``
that exposes ``InstantiatedModel`` (a constructed torch module) and
optionally ``load_model(weight_path)``, ``pre_process`` and
``post_process``. A chunkflow user points ``--framework pytorch
--model-path model.py --weight-path model.pt`` at the same files: this
module executes the ``model.py``, takes the torch ``state_dict`` it
yields and loads it BY NAME, BatchNorm folded, into the port's mirror
that ``model_variant`` selects (``models/convert.py``).

``pre_process`` and ``post_process`` are ignored, as the JAX package
ignores them: the mirror runs the patch as the rest of the path gives
it. A model that needs them exposes ``create_model`` or uses the
``universal`` engine, which runs the user's own code.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Dict, Optional

import torch
from torch import nn

from chunkflow_tpu_torch.models.convert import state_from_torch_by_name


def load_user_module(path: str, name: str = "chunkflow_user_model"):
    """Execute a user python file as a module (reference
    chunkflow/lib/__init__.py:5-16 ``load_source``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"model file not found: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def state_dict_from_reference_model(
        module, weight_path: Optional[str]) -> Dict[str, torch.Tensor]:
    """The torch state dict of an executed reference ``model.py``.

    Honors ``load_model(weight_path)`` when defined; otherwise uses
    ``InstantiatedModel`` + ``load_state_dict`` (a checkpoint that wraps
    the state dict under a ``"state_dict"`` key is accepted, as at
    patch/pytorch.py:58-60).
    """
    if hasattr(module, "load_model"):
        model = module.load_model(weight_path)
    elif hasattr(module, "InstantiatedModel"):
        model = module.InstantiatedModel
        if weight_path:
            chkpt = torch.load(weight_path, map_location="cpu",
                               weights_only=True)
            if isinstance(chkpt, dict) and "state_dict" in chkpt:
                chkpt = chkpt["state_dict"]
            model.load_state_dict(chkpt)
    else:
        raise ValueError(
            f"{getattr(module, '__file__', module)} defines neither "
            f"load_model nor InstantiatedModel (the reference pytorch "
            f"engine contract)"
        )
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def load_reference_model(module, weight_path: Optional[str],
                         model: nn.Module) -> nn.Module:
    """Load the reference model's weights into ``model`` by name."""
    state = state_dict_from_reference_model(module, weight_path)
    model.load_state_dict(state_from_torch_by_name(state,
                                                   model.state_dict()))
    return model
