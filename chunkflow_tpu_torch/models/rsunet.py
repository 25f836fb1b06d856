"""RSUNet: the production model family of reference chunkflow users.

The counterpart of ``chunkflow_tpu/models/rsunet.py``, as NCDHW
``nn.Module``s: a DeepEM/emvision "Residual Symmetric U-Net" whose
submodules carry the torch attribute names of such models (``embed``,
``enc{i}``, ``bridge``, ``up{i}``, ``dec{i}``, ``out``; blocks
``conv1/bn1/.../conv3/bn3``). A reference checkpoint therefore pairs by
name (``models/convert.py:state_from_torch_by_name``), with each
``BatchNorm3d``'s running statistics folded into the :class:`Affine` of
the same name.

Compute dtype as in ``models/unet3d.py`` (float32 parameters cast at
use), except that the sigmoid is taken in the compute dtype and the
result cast back to the input's dtype afterwards, as flax's RSUNet does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chunkflow_tpu_torch.models.unet3d import (
    PARITY_DOWN_FACTORS,
    PARITY_FEATURE_MAPS,
    ConvTranspose3d,
    Triple,
    same_conv,
)


class Affine(nn.Module):
    """Per-channel scale, then bias: an inference-time BatchNorm3d with
    its running statistics folded in. ``weight`` and ``bias`` are flax's
    ``scale`` and ``bias``; both are cast to the input's dtype, and the
    two operations round in it one after the other, as in flax."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        shape = (-1,) + (1,) * (x.dim() - 2)
        return (x * self.weight.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


class RSBlock(nn.Module):
    """conv1 (1,3,3) -> conv2 (3,3,3) -> conv3 (3,3,3), each conv -> bn
    -> relu, with the residual taken after conv1 and added before the
    last relu."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = same_conv(in_features, features, (1, 3, 3))
        self.bn1 = Affine(features)
        self.conv2 = same_conv(features, features, (3, 3, 3))
        self.bn2 = Affine(features)
        self.conv3 = same_conv(features, features, (3, 3, 3))
        self.bn3 = Affine(features)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        residual = x
        x = F.relu(self.bn2(self.conv2(x)))
        return F.relu(self.bn3(self.conv3(x)) + residual)


class RSUNet(nn.Module):
    """Residual symmetric U-Net, ``[B, C, z, y, x]`` in and out.

    ``width[i]`` is the feature count at depth i; ``down_factors[i]`` the
    pooling between depths i and i+1. Decoder upsampling is a transposed
    conv with kernel == stride == the down factor, then skip-add and a
    residual block. The head is a 1x1x1 conv and a sigmoid, taken in the
    compute dtype.
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 3,
        width: Sequence[int] = PARITY_FEATURE_MAPS,
        down_factors: Sequence[Triple] = PARITY_DOWN_FACTORS,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if len(down_factors) != len(width) - 1:
            raise ValueError("need one down factor between each pair of "
                             "widths")
        self.width = tuple(width)
        self.down_factors = tuple(tuple(f) for f in down_factors)
        self.dtype = dtype
        depth = len(self.width)
        self.embed = same_conv(in_channels, self.width[0], (1, 5, 5))
        for i in range(depth - 1):
            self.add_module(f"enc{i}", RSBlock(self.width[i - 1] if i
                                               else self.width[0],
                                               self.width[i]))
        self.bridge = RSBlock(self.width[-2], self.width[-1])
        for i in reversed(range(depth - 1)):
            f = self.down_factors[i]
            self.add_module(f"up{i}", ConvTranspose3d(
                self.width[i + 1], self.width[i], f, stride=f))
            self.add_module(f"dec{i}", RSBlock(self.width[i], self.width[i]))
        self.out = same_conv(self.width[0], out_channels, (1, 1, 1))

    def forward(self, x):
        orig_dtype = x.dtype
        x = self.embed(x.to(self.dtype))
        depth = len(self.width)
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
        return torch.sigmoid(self.out(x)).to(orig_dtype)
