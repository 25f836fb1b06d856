"""3D residual UNet: the convnet of the per-chunk inference path.

The counterpart of ``UNet3D``, ``ConvBlock``, ``space_to_depth`` /
``depth_to_space`` and ``create_tpu_optimized_model`` in
``chunkflow_tpu/models/unet3d.py``, as NCDHW ``nn.Module``s. Submodule
names mirror the flax ones (``conv_in``, ``enc{i}.conv1`` / ``norm1`` /
..., ``bridge``, ``up{i}``, ``dec{i}``, ``conv_out``), so a
reference-style ``.pt`` state dict loads with ``load_state_dict`` and
flax params convert by name (``models/convert.py``). Equivalences with
the flax layers:

- ``GroupNorm(group_size=1, use_fast_variance=False, eps=1e-5)`` is
  ``InstanceNorm3d(affine=True, eps=1e-5)``: mean and biased variance per
  sample and channel;
- flax ``SAME`` padding with an odd kernel is symmetric ``k // 2``;
- ``nn.max_pool`` with window = stride is ``max_pool3d``;
- ``nn.ConvTranspose`` with kernel = stride is ``ConvTranspose3d`` with
  the kernel spatially flipped (done by the converter).

Compute dtype, as flax's ``dtype`` with float32 ``param_dtype``: the
parameters stay float32 and are cast to the activations' dtype where
they are used; the model casts its input to ``dtype``; instance norm
takes its statistics and normalizes in float32 and returns ``dtype``
(flax's ``GroupNorm`` does the same); the output head is cast to float32
BEFORE the sigmoid. In float32 every cast is a no-op.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Triple = Tuple[int, int, int]

PARITY_FEATURE_MAPS = (28, 36, 48, 64)
PARITY_DOWN_FACTORS = ((1, 2, 2), (2, 2, 2), (2, 2, 2))


def _add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The bias added to the rounded convolution in the compute dtype, as
    flax adds it (cuDNN's convolution adds it the same way, after)."""
    return y.add_(bias.to(y.dtype).view((-1,) + (1,) * (y.dim() - 2)))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose parameters are cast to the input's dtype at
    use."""

    def forward(self, x):
        y = F.conv3d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding, self.dilation, self.groups)
        return _add_bias(y, self.bias)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` whose parameters are cast to the input's
    dtype at use."""

    def forward(self, x):
        y = F.conv_transpose3d(x, self.weight.to(x.dtype), None, self.stride,
                               self.padding, self.output_padding, self.groups,
                               self.dilation)
        return _add_bias(y, self.bias)


class InstanceNorm3d(nn.InstanceNorm3d):
    """Instance norm in float32 whatever the input's dtype, returned in
    the input's dtype."""

    def forward(self, x):
        y = x.float()
        if y[0, 0].numel() > 1:
            y = super().forward(y)
        else:
            # one voxel per channel, which F.instance_norm refuses: x -
            # mean is 0, so flax's GroupNorm gives the offset
            y = (y - y) + self.bias.view((-1,) + (1,) * (y.dim() - 2))
        return y.to(x.dtype)


def same_conv(cin: int, cout: int, kernel: Triple) -> Conv3d:
    return Conv3d(cin, cout, kernel, padding=tuple(k // 2 for k in kernel))


def space_to_depth(x: torch.Tensor, factor: Triple) -> torch.Tensor:
    """``[B, C, D, H, W]`` -> ``[B, fz*fy*fx*C, D/fz, H/fy, W/fx]``, with
    flax's channel order: the channel is fastest inside ``(fz, fy, fx,
    c)``, so weights carried across from the JAX package land on the
    channels they were trained for."""
    b, c, d, h, w = x.shape
    fz, fy, fx = factor
    x = x.reshape(b, c, d // fz, fz, h // fy, fy, w // fx, fx)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, fz * fy * fx * c, d // fz, h // fy, w // fx)


def depth_to_space(x: torch.Tensor, factor: Triple) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, c, d, h, w = x.shape
    fz, fy, fx = factor
    cout = c // (fz * fy * fx)
    x = x.reshape(b, fz, fy, fx, cout, d, h, w)
    x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(b, cout, d * fz, h * fy, w * fx)


@torch.no_grad()
def seeded_init(model: nn.Module,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded initialization in the flax defaults' spirit: conv kernels ~
    N(0, 1/fan_in) (lecun normal), biases 0, norm and affine scales
    (any other 1-D ``weight``) 1 and their offsets 0. Draws on the CPU
    from ``generator``, so a seed gives the same weights on every device.
    Parameters of other layers keep what their constructor gave them."""
    for module in model.modules():
        weight = getattr(module, "weight", None)
        bias = getattr(module, "bias", None)
        if isinstance(module, (nn.Conv3d, nn.ConvTranspose3d)):
            # fan_in = input channels x kernel volume, for both layers
            cin = weight.shape[0 if isinstance(module, nn.ConvTranspose3d)
                               else 1]
            fan_in = cin * weight[0, 0].numel()
            init = torch.empty(weight.shape, dtype=weight.dtype)
            init.normal_(0.0, fan_in ** -0.5, generator=generator)
            weight.copy_(init)
        elif isinstance(weight, nn.Parameter) and weight.dim() == 1:
            weight.fill_(1.0)
        else:
            continue
        if bias is not None:
            bias.zero_()
    return model


class ConvBlock(nn.Module):
    """Two 3x3x3 convs with instance norm + elu, residual add when the
    width is unchanged."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = same_conv(in_features, features, (3, 3, 3))
        self.norm1 = InstanceNorm3d(features, eps=1e-5, affine=True)
        self.conv2 = same_conv(features, features, (3, 3, 3))
        self.norm2 = InstanceNorm3d(features, eps=1e-5, affine=True)
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
    nothing (``"none"``). ``dtype`` is the compute dtype (the module
    docstring says where it applies); the output is float32 unless the
    input is bfloat16, as in flax.

    ``s2d_factor`` is the JAX package's space-to-depth stem: the input is
    losslessly :func:`space_to_depth`'d before ``conv_in``, and
    ``conv_out`` emits ``out_channels * prod(s2d_factor)`` channels that
    :func:`depth_to_space` puts back at full resolution.
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 3,
        feature_maps: Sequence[int] = PARITY_FEATURE_MAPS,
        down_factors: Sequence[Triple] = PARITY_DOWN_FACTORS,
        final_activation: str = "sigmoid",
        dtype: torch.dtype = torch.float32,
        s2d_factor: Optional[Triple] = None,
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
        self.dtype = dtype
        self.s2d_factor = tuple(s2d_factor) if s2d_factor else None
        s2d = int(np.prod(self.s2d_factor)) if self.s2d_factor else 1
        fm = self.feature_maps
        depth = len(fm)
        self.conv_in = same_conv(in_channels * s2d, fm[0], (1, 5, 5))
        for i in range(depth - 1):
            self.add_module(f"enc{i}", ConvBlock(fm[i - 1] if i else fm[0],
                                                 fm[i]))
        self.bridge = ConvBlock(fm[-2], fm[-1])
        for i in reversed(range(depth - 1)):
            f = self.down_factors[i]
            self.add_module(f"up{i}",
                            ConvTranspose3d(fm[i + 1], fm[i], f, stride=f))
            self.add_module(f"dec{i}", ConvBlock(fm[i], fm[i]))
        self.conv_out = same_conv(fm[0], out_channels * s2d, (1, 5, 5))

    def forward(self, x):
        orig_dtype = x.dtype
        x = x.to(self.dtype)
        if self.s2d_factor:
            x = space_to_depth(x, self.s2d_factor)
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
        if self.s2d_factor:
            x = depth_to_space(x, self.s2d_factor)
        x = x.float()
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x.to(orig_dtype) if orig_dtype == torch.bfloat16 else x


def create_tpu_optimized_model(
    in_channels: int = 1,
    out_channels: int = 3,
    dtype: torch.dtype = torch.float32,
    s2d_factor: Triple = (1, 2, 2),
) -> UNet3D:
    """The JAX package's flagship model (variants ``tpu``, ``tpu_mxu`` and
    ``tpu_s2d4``): the space-to-depth stem with the reference-class widths
    (28, 36, 48, 64) scaled by sqrt(prod(s2d_factor)): 56-128 channels at
    (1, 2, 2), 112-256 at (1, 4, 4).

    ``tpu_mxu`` is ``tpu`` with every convolution lowered differently by
    XLA (z-decomposed 2D convs and GEMM upsampling, ``MxuConv`` /
    ``MxuConvTranspose``): the same parameters and the same function, so
    here it is this same module.
    """
    scale = int(round(float(np.prod(s2d_factor)) ** 0.5))
    return UNet3D(
        in_channels=in_channels,
        out_channels=out_channels,
        feature_maps=tuple(w * scale for w in PARITY_FEATURE_MAPS),
        down_factors=PARITY_DOWN_FACTORS,
        dtype=dtype,
        s2d_factor=s2d_factor,
    )
