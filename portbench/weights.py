"""Seeded weights, made on the device in a few large calls.

One normal draw fills every parameter of a configuration at once; each
leaf is then scaled by its kind: convolution kernels He-normal
(``std = sqrt(2 / fan_in)``: input channels x kernel volume for a
convolution, input channels for a transposed one, whose kernel equals
its stride so that each output voxel meets one tap),
biases and norm shifts ``N(0, 0.1)``, norm and affine scales
``1 + N(0, 0.1)``. An RSUNet's scales and shifts are then those of an
inference-time batch norm with its running statistics folded in: one
reference forward over a seeded patch takes each channel's mean and
variance at each norm (eps 1e-5) as its running statistics. A trained
net's folded norms keep its activations at unit scale in the same way;
without them the random residual blocks grow the logits by orders of
magnitude and every output saturates at 0 or 1. The instance norms of
the U-Net normalize by themselves. The tensors are float32, the
parameters' storage type in the program; the program computes in the
configuration's dtype from them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reference import models


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = models.param_spec(config)
    total = sum(int(np.prod(shape)) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    params, at = {}, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        leaf = flat[at:at + n].view(shape)
        at += n
        if kind in ("conv", "convT"):
            fan_in = shape[0] if kind == "convT" \
                else shape[1] * int(np.prod(shape[2:]))
            leaf = leaf * (2.0 / fan_in) ** 0.5
        elif kind == "scale":
            leaf = 1.0 + 0.1 * leaf
        else:
            leaf = 0.1 * leaf
        params[name] = leaf.contiguous()
    if config["family"] == "rsunet":
        shape = (1, config["in_channels"]) + tuple(config["input_patch"])
        x = torch.rand(shape, generator=gen, device=device)
        with torch.no_grad(), models.exact_float32():
            models.forward(config, params, x, _FoldNorms(torch.float32))
    return params


class _FoldNorms(models.Ops):
    """Folds each affine's running statistics, taken from the batch it
    sees, into its scale and shift, in place, on the way through."""

    def affine(self, x, p, name):
        mean = x.mean(dim=(0, 2, 3, 4))
        var = x.var(dim=(0, 2, 3, 4), unbiased=False)
        scale = p[f"{name}.weight"] / torch.sqrt(var + 1e-5)
        p[f"{name}.bias"] = p[f"{name}.bias"] - mean * scale
        p[f"{name}.weight"] = scale
        return super().affine(x, p, name)
