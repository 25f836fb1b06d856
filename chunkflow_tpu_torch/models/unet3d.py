"""3D residual UNet: the convnet of the per-chunk inference path.

The counterpart of ``UNet3D`` and ``ConvBlock`` in
``chunkflow_tpu/models/unet3d.py`` at its reference-class ("parity")
architecture, as NCDHW ``nn.Module``s. Submodule names mirror the flax
ones (``conv_in``, ``enc{i}.conv1`` / ``norm1`` / ..., ``bridge``,
``up{i}``, ``dec{i}``, ``conv_out``), so a reference-style ``.pt`` state
dict loads with ``load_state_dict`` and flax params convert by name
(``models/convert.py``). Equivalences with the flax layers:

- ``GroupNorm(group_size=1, use_fast_variance=False, eps=1e-5)`` is
  ``InstanceNorm3d(affine=True, eps=1e-5)``: mean and biased variance per
  sample and channel;
- flax ``SAME`` padding with an odd kernel is symmetric ``k // 2``;
- ``nn.max_pool`` with window = stride is ``max_pool3d``;
- ``nn.ConvTranspose`` with kernel = stride is ``ConvTranspose3d`` with
  the kernel spatially flipped (done by the converter).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Triple = Tuple[int, int, int]

PARITY_FEATURE_MAPS = (28, 36, 48, 64)
PARITY_DOWN_FACTORS = ((1, 2, 2), (2, 2, 2), (2, 2, 2))


def _same_conv(cin: int, cout: int, kernel: Triple) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, padding=tuple(k // 2 for k in kernel))


class ConvBlock(nn.Module):
    """Two 3x3x3 convs with instance norm + elu, residual add when the
    width is unchanged."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = _same_conv(in_features, features, (3, 3, 3))
        self.norm1 = nn.InstanceNorm3d(features, eps=1e-5, affine=True)
        self.conv2 = _same_conv(features, features, (3, 3, 3))
        self.norm2 = nn.InstanceNorm3d(features, eps=1e-5, affine=True)
        self.residual = in_features == features

    def forward(self, x):
        residual = x
        x = F.elu(self.norm1(self.conv1(x)))
        x = self.norm2(self.conv2(x))
        if self.residual:
            x = x + residual
        return F.elu(x)


class UNet3D(nn.Module):
    """Symmetric residual 3D UNet, ``[B, C, z, y, x]`` in and out.

    ``feature_maps[i]`` is the width at encoder depth i;
    ``down_factors[i]`` the (z, y, x) pooling factor between depth i and
    i+1. The output head is a sigmoid (``final_activation="sigmoid"``) or
    nothing (``"none"``).
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 3,
        feature_maps: Sequence[int] = PARITY_FEATURE_MAPS,
        down_factors: Sequence[Triple] = PARITY_DOWN_FACTORS,
        final_activation: str = "sigmoid",
    ):
        super().__init__()
        if len(down_factors) != len(feature_maps) - 1:
            raise ValueError("need one down factor between each pair of "
                             "feature maps")
        if final_activation not in ("sigmoid", "none"):
            raise ValueError(final_activation)
        self.feature_maps = tuple(feature_maps)
        self.down_factors = tuple(tuple(f) for f in down_factors)
        self.final_activation = final_activation
        fm = self.feature_maps
        depth = len(fm)
        self.conv_in = _same_conv(in_channels, fm[0], (1, 5, 5))
        for i in range(depth - 1):
            self.add_module(f"enc{i}", ConvBlock(fm[i - 1] if i else fm[0],
                                                 fm[i]))
        self.bridge = ConvBlock(fm[-2], fm[-1])
        for i in reversed(range(depth - 1)):
            f = self.down_factors[i]
            self.add_module(f"up{i}",
                            nn.ConvTranspose3d(fm[i + 1], fm[i], f, stride=f))
            self.add_module(f"dec{i}", ConvBlock(fm[i], fm[i]))
        self.conv_out = _same_conv(fm[0], out_channels, (1, 5, 5))

    def forward(self, x):
        depth = len(self.feature_maps)
        x = self.conv_in(x)
        skips = []
        for i in range(depth - 1):
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
            f = self.down_factors[i]
            x = F.max_pool3d(x, kernel_size=f, stride=f)
        x = self.bridge(x)
        for i in reversed(range(depth - 1)):
            x = getattr(self, f"up{i}")(x) + skips[i]
            x = getattr(self, f"dec{i}")(x)
        x = self.conv_out(x)
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> "UNet3D":
        """Seeded initialization in the flax defaults' spirit: conv
        kernels ~ N(0, 1/fan_in) (lecun normal), biases 0, norm scales 1
        and offsets 0. Draws on the CPU from ``generator``, so a seed
        gives the same weights on every device."""
        for module in self.modules():
            if isinstance(module, (nn.Conv3d, nn.ConvTranspose3d)):
                w = module.weight
                # fan_in = input channels x kernel volume, for both layers
                cin = w.shape[0 if isinstance(module, nn.ConvTranspose3d)
                              else 1]
                fan_in = cin * w[0, 0].numel()
                init = torch.empty(w.shape, dtype=w.dtype)
                init.normal_(0.0, fan_in ** -0.5, generator=generator)
                w.copy_(init)
                module.bias.zero_()
            elif isinstance(module, nn.InstanceNorm3d):
                module.weight.fill_(1.0)
                module.bias.zero_()
        return self
