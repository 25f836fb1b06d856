"""A reference chunkflow user's ``model.py``, as text, and its checkpoint.

Reference chunkflow loads a user's PyTorch model through a ``model.py``
that defines ``InstantiatedModel`` (``models/migrate.py``); the models
users hold are DeepEM-style RSUNets with ``BatchNorm3d``. :func:`model_py`
writes such a file, its submodules declared decoder-first (the reverse
of execution order), so only pairing by name can load it;
:func:`seed_batchnorm` gives its BatchNorm layers non-trivial running
statistics and affine parameters, so that folding them matters. With
these, ``chip_smoke.py`` and the tests drive the migration path
(``models/convert.py:state_from_torch_by_name``) as a user's checkpoint
would.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from chunkflow_tpu_torch.models.unet3d import PARITY_FEATURE_MAPS

_MODEL_PY = """
import torch
import torch.nn as nn


class RSBlock(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        # declaration order scrambled on purpose
        self.bn3 = nn.BatchNorm3d(c)
        self.conv3 = nn.Conv3d(c, c, (3, 3, 3), padding=(1, 1, 1))
        self.bn2 = nn.BatchNorm3d(c)
        self.conv2 = nn.Conv3d(c, c, (3, 3, 3), padding=(1, 1, 1))
        self.bn1 = nn.BatchNorm3d(c)
        self.conv1 = nn.Conv3d(cin, c, (1, 3, 3), padding=(0, 1, 1))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        residual = x
        x = torch.relu(self.bn2(self.conv2(x)))
        return torch.relu(self.bn3(self.conv3(x)) + residual)


class RSUNet(nn.Module):
    def __init__(self, width=WIDTH, down=((1, 2, 2), (2, 2, 2), (2, 2, 2)),
                 in_channels=1, out_channels=3):
        super().__init__()
        self.down = down
        depth = len(width)
        self.out = nn.Conv3d(width[0], out_channels, 1)
        for i in range(depth - 1):
            setattr(self, f"dec{i}", RSBlock(width[i], width[i]))
            setattr(self, f"up{i}", nn.ConvTranspose3d(
                width[i + 1], width[i], down[i], stride=down[i]))
        self.bridge = RSBlock(width[-2], width[-1])
        for i in reversed(range(depth - 1)):
            setattr(self, f"enc{i}",
                    RSBlock(width[i - 1] if i > 0 else width[0], width[i]))
        self.embed = nn.Conv3d(in_channels, width[0], (1, 5, 5),
                               padding=(0, 2, 2))

    def forward(self, x):
        depth = len(self.down) + 1
        x = self.embed(x)
        skips = []
        for i in range(depth - 1):
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
            x = torch.nn.functional.max_pool3d(x, self.down[i], self.down[i])
        x = self.bridge(x)
        for i in reversed(range(depth - 1)):
            x = getattr(self, f"up{i}")(x)
            x = x + skips[i]
            x = getattr(self, f"dec{i}")(x)
        return torch.sigmoid(self.out(x))


InstantiatedModel = RSUNet()
"""


def model_py(width: Sequence[int] = PARITY_FEATURE_MAPS) -> str:
    """The text of the ``model.py``, its RSUNet ``width[i]`` channels wide
    at depth i (down factors (1,2,2), (2,2,2), ...: four widths)."""
    return _MODEL_PY.replace("WIDTH", repr(tuple(width)))


@torch.no_grad()
def seed_batchnorm(model: nn.Module,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every ``BatchNorm3d``'s running mean and beta (normal, standard
    deviation 0.1), running variance (uniform in [0.5, 1)) and gamma
    (uniform in [0.75, 1.25)) from ``generator``, on the CPU, layer by
    layer in module order."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm3d):
            c = m.num_features
            m.running_mean.copy_(torch.randn(c, generator=generator) * 0.1)
            m.running_var.copy_(torch.rand(c, generator=generator) * 0.5 + 0.5)
            m.weight.copy_(torch.rand(c, generator=generator) * 0.5 + 0.75)
            m.bias.copy_(torch.randn(c, generator=generator) * 0.1)
    return model
