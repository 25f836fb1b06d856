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
parameters stay float32 and each layer casts them, and its input, to the
model's compute dtype where they are used (``compute_dtype``, set on
every layer by the model); instance norm takes its statistics and
normalizes in float32 and returns the compute dtype (flax's
``GroupNorm`` does the same); the output head is cast to float32 BEFORE
the sigmoid. In float32 every cast is a no-op, and so is every cast in
a bfloat16 model on its own bfloat16 activations. The casts matter under
the int8 ``real`` leg (``inference/precision.py``), whose quantized
convolutions return float32: each layer then rounds what it reads and
what it returns as flax does (a bf16 bias added to a float32 product
promotes to float32; the norm returns bf16; the next convolution
quantizes its bf16-rounded input).

``conv_impl="mxu"`` (the ``tpu_mxu`` variant) is the JAX package's
``MxuConv`` / ``MxuConvTranspose`` lowering as modules of their own:
the same parameters and the same function in float32, but other
roundings in bfloat16 (each z slice summed in float32, rounded once
after the bias) and other quantization sites under int8 ``real``
(one activation scale per ``(b, z)`` row of each 2D slice, one weight
scale per slice; the upsample is a matrix product).
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
    """The bias (already in the compute dtype) added to the rounded
    convolution, as flax adds it: in place, in ``y``'s dtype."""
    return y.add_(bias.to(y.dtype).view((-1,) + (1,) * (y.dim() - 2)))


class _Computes:
    """A layer's compute dtype: ``None`` (its input's dtype) until its
    model sets it."""

    compute_dtype: Optional[torch.dtype] = None

    def _dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.compute_dtype or x.dtype


class Conv3d(_Computes, nn.Conv3d):
    """``nn.Conv3d`` that casts its input and parameters to the compute
    dtype at use. ``add_bias=False`` returns the convolution without its
    bias, for a caller that adds it itself (RSUNet's epilogue)."""

    def forward(self, x, add_bias: bool = True):
        dt = self._dtype(x)
        y = F.conv3d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation, self.groups)
        return _add_bias(y, self.bias.to(dt)) if add_bias else y


class ConvTranspose3d(_Computes, nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` that casts its input and parameters to the
    compute dtype at use; ``add_bias`` as :class:`Conv3d`'s."""

    def forward(self, x, add_bias: bool = True):
        dt = self._dtype(x)
        y = F.conv_transpose3d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return _add_bias(y, self.bias.to(dt)) if add_bias else y


class MxuConv(Conv3d):
    """The JAX package's ``MxuConv``: a SAME ``(kz, ky, kx)`` convolution
    as the sum of kz z-shifted 2D convolutions over ``b * d`` rows, each
    summed in float32 (flax's ``preferred_element_type``), the float32
    bias added, rounded to the compute dtype once. Conv3d's parameters and
    names, so checkpoints interchange."""

    def forward(self, x):
        dt = self._dtype(x)
        x = x.to(dt)
        w = self.weight.to(dt)
        b, cin, d, h, wd = x.shape
        kz, ky, kx = self.kernel_size
        if kz > 1:
            # flax SAME padding: lo = (k - 1) // 2, hi = k // 2
            x = F.pad(x, (0, 0, 0, 0, (kz - 1) // 2, kz // 2))
        # [b, cin, z, h, w] -> rows of 2D images [b * d, cin, h, w]
        x = x.transpose(1, 2)
        acc = None
        for dz in range(kz):
            xs = x[:, dz:dz + d].reshape(b * d, cin, h, wd)
            y = F.conv2d(xs.float(), w[:, :, dz].float(), None, 1,
                         ((ky - 1) // 2, (kx - 1) // 2))
            acc = y if acc is None else acc + y
        acc = acc.reshape(b, d, -1, h, wd).transpose(1, 2)
        return (acc + self.bias.float().view(-1, 1, 1, 1)).to(dt)


class MxuConvTranspose(ConvTranspose3d):
    """The JAX package's ``MxuConvTranspose`` (kernel == stride): one
    channel matrix product ``x @ k2`` to ``prod(factor) * F`` channels,
    then depth-to-space, then the bias in the compute dtype.
    ConvTranspose3d's parameters and names (the converter's flipped
    layout)."""

    def forward(self, x):
        dt = self._dtype(x)
        x = x.to(dt)
        b, cin, d, h, w = x.shape
        fz, fy, fx = self.kernel_size
        cout = self.out_channels
        # [cin, F, fz, fy, fx] -> [cin, (fz, fy, fx, F)]
        k2 = self.weight.to(dt).permute(0, 2, 3, 4, 1).reshape(cin, -1)
        y = torch.matmul(x.permute(0, 2, 3, 4, 1), k2)
        y = y.reshape(b, d, h, w, fz, fy, fx, cout)
        y = y.permute(0, 7, 1, 4, 2, 5, 3, 6)
        y = y.reshape(b, cout, d * fz, h * fy, w * fx)
        return y + self.bias.to(dt).view(-1, 1, 1, 1)


class InstanceNorm3d(_Computes, nn.InstanceNorm3d):
    """Instance norm in float32 whatever the input's dtype, returned in
    the compute dtype."""

    def forward(self, x):
        y = x.float()
        if y[0, 0].numel() > 1:
            y = super().forward(y)
        else:
            # one voxel per channel, which F.instance_norm refuses: x -
            # mean is 0, so flax's GroupNorm gives the offset
            y = (y - y) + self.bias.view((-1,) + (1,) * (y.dim() - 2))
        return y.to(self._dtype(x))


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    """Give every layer of ``model`` that casts (``Conv3d``, the mxu
    layers, ``InstanceNorm3d``) the compute dtype."""
    for module in model.modules():
        if isinstance(module, _Computes):
            module.compute_dtype = dtype


def same_conv(cin: int, cout: int, kernel: Triple,
              conv_impl: str = "native") -> Conv3d:
    cls = MxuConv if conv_impl == "mxu" else Conv3d
    return cls(cin, cout, kernel, padding=tuple(k // 2 for k in kernel))


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

    def __init__(self, in_features: int, features: int,
                 conv_impl: str = "native"):
        super().__init__()
        self.conv1 = same_conv(in_features, features, (3, 3, 3), conv_impl)
        self.norm1 = InstanceNorm3d(features, eps=1e-5, affine=True)
        self.conv2 = same_conv(features, features, (3, 3, 3), conv_impl)
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

    ``conv_impl="mxu"`` builds every convolution as :class:`MxuConv` and
    every upsampling as :class:`MxuConvTranspose` (the JAX package's
    ``conv_impl``), with the same parameter names and shapes.
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
        conv_impl: str = "native",
    ):
        super().__init__()
        if len(down_factors) != len(feature_maps) - 1:
            raise ValueError("need one down factor between each pair of "
                             "feature maps")
        if final_activation not in ("sigmoid", "none"):
            raise ValueError(final_activation)
        if conv_impl not in ("native", "mxu"):
            raise ValueError(f"conv_impl must be native or mxu, got "
                             f"{conv_impl!r}")
        self.conv_impl = conv_impl
        self.feature_maps = tuple(feature_maps)
        self.down_factors = tuple(tuple(f) for f in down_factors)
        self.final_activation = final_activation
        self.dtype = dtype
        self.s2d_factor = tuple(s2d_factor) if s2d_factor else None
        s2d = int(np.prod(self.s2d_factor)) if self.s2d_factor else 1
        fm = self.feature_maps
        depth = len(fm)
        impl = conv_impl
        up = MxuConvTranspose if impl == "mxu" else ConvTranspose3d
        self.conv_in = same_conv(in_channels * s2d, fm[0], (1, 5, 5), impl)
        for i in range(depth - 1):
            self.add_module(f"enc{i}", ConvBlock(fm[i - 1] if i else fm[0],
                                                 fm[i], impl))
        self.bridge = ConvBlock(fm[-2], fm[-1], impl)
        for i in reversed(range(depth - 1)):
            f = self.down_factors[i]
            self.add_module(f"up{i}", up(fm[i + 1], fm[i], f, stride=f))
            self.add_module(f"dec{i}", ConvBlock(fm[i], fm[i], impl))
        self.conv_out = same_conv(fm[0], out_channels * s2d, (1, 5, 5), impl)
        set_compute_dtype(self, dtype)

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
    conv_impl: str = "native",
) -> UNet3D:
    """The JAX package's flagship model (variants ``tpu``, ``tpu_mxu`` and
    ``tpu_s2d4``): the space-to-depth stem with the reference-class widths
    (28, 36, 48, 64) scaled by sqrt(prod(s2d_factor)): 56-128 channels at
    (1, 2, 2), 112-256 at (1, 4, 4).

    ``tpu_mxu`` is ``tpu`` with ``conv_impl="mxu"``: z-decomposed 2D
    convolutions and a GEMM upsampling (:class:`MxuConv`,
    :class:`MxuConvTranspose`), the same parameters.
    """
    scale = int(round(float(np.prod(s2d_factor)) ** 0.5))
    return UNet3D(
        in_channels=in_channels,
        out_channels=out_channels,
        feature_maps=tuple(w * scale for w in PARITY_FEATURE_MAPS),
        down_factors=PARITY_DOWN_FACTORS,
        dtype=dtype,
        s2d_factor=s2d_factor,
        conv_impl=conv_impl,
    )


def save_params(weights, path: str) -> str:
    """Write a port model's weights (the model or its state dict, UNet3D
    of any variant or RSUNet) as the JAX package's ``save_params`` writes
    its params: ``flax.serialization.to_bytes`` of the flax tree that
    ``models/convert.py:state_from_flax`` inverts
    (:func:`~chunkflow_tpu_torch.models.convert.flax_from_state`), so a
    JAX worker's ``init_or_load_params`` loads them. Returns ``path``."""
    from chunkflow_tpu_torch.models import flax_msgpack
    from chunkflow_tpu_torch.models.convert import flax_from_state

    state = weights.state_dict() if isinstance(weights, nn.Module) \
        else weights
    return flax_msgpack.dump(flax_from_state(state), path)
