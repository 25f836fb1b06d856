"""The program's model, handed over as its users hand it one: a model
file for ``--model-path`` (``Inferencer(model_path=...)``) whose
``create_model`` builds the program's own network of the configuration's
family at the configuration's widths, down factors and compute dtype.
The weights come separately, as a ``.pt`` state dict."""
from __future__ import annotations

import os

TEMPLATE = '''import torch

from chunkflow_tpu_torch.models.{module} import {cls}


def create_model(num_input_channels, num_output_channels):
    return {cls}(num_input_channels, num_output_channels, {widths}={width},
                 down_factors={downs},{extra} dtype=torch.{dtype})
'''


def write(config: dict, directory: str) -> str:
    """Writes ``model.py`` for ``config`` into ``directory``; returns its
    path."""
    downs = tuple(tuple(f) for f in config["down_factors"])
    fields = dict(width=tuple(config["width"]), downs=downs,
                  dtype=config["compute_dtype"], extra="")
    if config["family"] == "rsunet":
        fields.update(module="rsunet", cls="RSUNet", widths="width")
    elif config["family"] == "unet3d":
        fields.update(module="unet3d", cls="UNet3D", widths="feature_maps",
                      extra=f" s2d_factor={tuple(config['s2d'])},")
    else:
        raise ValueError(f"unknown family {config['family']!r}")
    path = os.path.join(directory, "model.py")
    with open(path, "w") as f:
        f.write(TEMPLATE.format(**fields))
    return path
