"""Plain float32 forwards of the two convnet families the benchmark runs.

Written from the architectures' descriptions, as functions of a
parameter dict keyed by the program's parameter names, so that one set
of seeded tensors feeds both the program and this reference. Nothing of
the program is imported.

- ``rsunet``: DeepEM's residual symmetric U-Net (Lee et al. 2017,
  arXiv:1706.00120) as chunkflow's users load it. An ``embed`` (1,5,5)
  convolution; per depth a residual block ``conv1`` (1,3,3) -> ``conv2``
  (3,3,3) -> ``conv3`` (3,3,3), each followed by its inference-time batch
  norm (a per-channel scale and bias, ``bn<i>``) and a ReLU, the residual
  taken after the first and added before the last ReLU; max pooling by
  the down factor; a transposed convolution (kernel = stride = the down
  factor) up, a skip addition and a block on the way back; a (1,1,1)
  ``out`` convolution and a sigmoid.
- ``unet3d``: the residual 3D U-Net with a space-to-depth stem. The input
  folds ``s2d`` voxels into channels (the channel fastest inside
  ``(fz, fy, fx, c)``); ``conv_in`` (1,5,5); per depth two (3,3,3)
  convolutions, each followed by instance norm (per sample and channel,
  biased variance, eps 1e-5, then scale and bias) and an ELU, the input
  added before the second ELU where the width is unchanged; pooling,
  transposed convolutions and skips as above; ``conv_out`` (1,5,5) to
  ``out * prod(s2d)`` channels, depth-to-space, sigmoid.

Both compute in the configuration's ``compute_dtype`` as flax defines a
module with ``dtype`` set and float32 ``param_dtype``: the input and each
parameter are cast to it where they are used, a convolution's sum is
rounded to it and its bias then added in it, an affine multiplies and
adds in it; instance norm takes its statistics and normalizes in float32
with float32 parameters and returns the compute dtype. The RSUNet takes
its sigmoid in the compute dtype; the U-Net casts its head to float32
first. A float32 configuration makes every cast a no-op. On the card the
caller turns TF32 off (:func:`exact_float32`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Triple = Tuple[int, int, int]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def param_spec(config: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter, ``kind`` one of
    ``conv`` (a convolution's weight), ``convT`` (a transposed
    convolution's weight, ``[in, out, k]``), ``bias``, ``scale`` (a norm's
    or affine's per-channel scale) and ``shift`` (its bias)."""
    family = config["family"]
    if family == "rsunet":
        return list(_rsunet_spec(config))
    if family == "unet3d":
        return list(_unet3d_spec(config))
    raise ValueError(f"unknown family {family!r}")


def _conv(name, cin, cout, k) -> Iterator[tuple]:
    yield f"{name}.weight", (cout, cin) + tuple(k), "conv"
    yield f"{name}.bias", (cout,), "bias"


def _norm(name, c) -> Iterator[tuple]:
    yield f"{name}.weight", (c,), "scale"
    yield f"{name}.bias", (c,), "shift"


def _rsunet_spec(config) -> Iterator[tuple]:
    width = config["width"]
    downs = config["down_factors"]
    depth = len(width)

    def block(name, cin, c):
        yield from _conv(f"{name}.conv1", cin, c, (1, 3, 3))
        yield from _norm(f"{name}.bn1", c)
        yield from _conv(f"{name}.conv2", c, c, (3, 3, 3))
        yield from _norm(f"{name}.bn2", c)
        yield from _conv(f"{name}.conv3", c, c, (3, 3, 3))
        yield from _norm(f"{name}.bn3", c)

    yield from _conv("embed", config["in_channels"], width[0], (1, 5, 5))
    for i in range(depth - 1):
        yield from block(f"enc{i}", width[i - 1] if i else width[0], width[i])
    yield from block("bridge", width[-2], width[-1])
    for i in reversed(range(depth - 1)):
        f = tuple(downs[i])
        yield f"up{i}.weight", (width[i + 1], width[i]) + f, "convT"
        yield f"up{i}.bias", (width[i],), "bias"
        yield from block(f"dec{i}", width[i], width[i])
    yield from _conv("out", width[0], config["out_channels"], (1, 1, 1))


def _unet3d_spec(config) -> Iterator[tuple]:
    width = config["width"]
    downs = config["down_factors"]
    depth = len(width)
    s2d = _prod(config["s2d"])

    def block(name, cin, c):
        yield from _conv(f"{name}.conv1", cin, c, (3, 3, 3))
        yield from _norm(f"{name}.norm1", c)
        yield from _conv(f"{name}.conv2", c, c, (3, 3, 3))
        yield from _norm(f"{name}.norm2", c)

    yield from _conv("conv_in", config["in_channels"] * s2d, width[0],
                     (1, 5, 5))
    for i in range(depth - 1):
        yield from block(f"enc{i}", width[i - 1] if i else width[0], width[i])
    yield from block("bridge", width[-2], width[-1])
    for i in reversed(range(depth - 1)):
        f = tuple(downs[i])
        yield f"up{i}.weight", (width[i + 1], width[i]) + f, "convT"
        yield f"up{i}.bias", (width[i],), "bias"
        yield from block(f"dec{i}", width[i], width[i])
    yield from _conv("conv_out", width[0], config["out_channels"] * s2d,
                     (1, 5, 5))


def _prod(values) -> int:
    out = 1
    for v in values:
        out *= int(v)
    return out


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Ops:
    """The convolutions and affines the forwards call, in the compute
    dtype, so that a counter (``counts.conv_flops``) or a calibration
    (``weights.make``) can stand in. A layer casts its float32 parameters
    to the compute dtype where it uses them; a convolution's sum is
    rounded to that dtype before its bias is added in it."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def affine(self, x, p, name):
        shape = (1, -1, 1, 1, 1)
        return (x * p[f"{name}.weight"].to(self.dtype).view(shape)
                + p[f"{name}.bias"].to(self.dtype).view(shape))

    def conv(self, x, w, b):
        pad = tuple(k // 2 for k in w.shape[2:])
        y = F.conv3d(x, w.to(self.dtype), None, padding=pad)
        return y + b.to(self.dtype).view(-1, 1, 1, 1)

    def conv_t(self, x, w, b, stride):
        y = F.conv_transpose3d(x, w.to(self.dtype), None,
                               stride=tuple(stride))
        return y + b.to(self.dtype).view(-1, 1, 1, 1)


def forward(config: dict, params: Dict[str, torch.Tensor], x: torch.Tensor,
            ops: Ops = None) -> torch.Tensor:
    """``[B, in, z, y, x]`` float32 -> ``[B, out, z, y, x]`` float32
    probabilities, computed in the configuration's ``compute_dtype``."""
    if ops is None:
        ops = Ops(DTYPES[config["compute_dtype"]])
    x = x.to(ops.dtype)
    if config["family"] == "rsunet":
        return _rsunet(config, params, x, ops)
    return _unet3d(config, params, x, ops)


def _c(x, p, name, ops):
    return ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _rsunet(config, p, x, ops):
    def block(x, n):
        x = F.relu(ops.affine(_c(x, p, f"{n}.conv1", ops), p, f"{n}.bn1"))
        residual = x
        x = F.relu(ops.affine(_c(x, p, f"{n}.conv2", ops), p, f"{n}.bn2"))
        return F.relu(ops.affine(_c(x, p, f"{n}.conv3", ops), p,
                                 f"{n}.bn3") + residual)

    depth = len(config["width"])
    downs = [tuple(f) for f in config["down_factors"]]
    x = _c(x, p, "embed", ops)
    skips = []
    for i in range(depth - 1):
        x = block(x, f"enc{i}")
        skips.append(x)
        x = F.max_pool3d(x, kernel_size=downs[i], stride=downs[i])
    x = block(x, "bridge")
    for i in reversed(range(depth - 1)):
        x = ops.conv_t(x, p[f"up{i}.weight"], p[f"up{i}.bias"], downs[i])
        x = block(x + skips[i], f"dec{i}")
    # the sigmoid in the compute dtype, as flax's RSUNet takes it
    return torch.sigmoid(_c(x, p, "out", ops)).float()


def instance_norm(x, weight, bias, eps: float = 1e-5):
    """Per sample and channel, in float32 with float32 parameters: mean
    and biased variance over z, y, x; returned in ``x``'s dtype."""
    y = x.float()
    mean = y.mean(dim=(2, 3, 4), keepdim=True)
    var = ((y - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    shape = (1, -1, 1, 1, 1)
    y = (y - mean) / torch.sqrt(var + eps) * weight.view(shape) \
        + bias.view(shape)
    return y.to(x.dtype)


def space_to_depth(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    """``[B, C, D, H, W]`` -> ``[B, fz*fy*fx*C, D/fz, H/fy, W/fx]``, the
    channel fastest inside ``(fz, fy, fx, c)``."""
    b, c, d, h, w = x.shape
    fz, fy, fx = factor
    x = x.reshape(b, c, d // fz, fz, h // fy, fy, w // fx, fx)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, fz * fy * fx * c, d // fz, h // fy, w // fx)


def depth_to_space(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    b, c, d, h, w = x.shape
    fz, fy, fx = factor
    cout = c // (fz * fy * fx)
    x = x.reshape(b, fz, fy, fx, cout, d, h, w)
    x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(b, cout, d * fz, h * fy, w * fx)


def _unet3d(config, p, x, ops):
    width = config["width"]
    depth = len(width)
    downs = [tuple(f) for f in config["down_factors"]]
    s2d = tuple(config["s2d"])

    def block(x, n, residual):
        skip = x
        x = _c(x, p, f"{n}.conv1", ops)
        x = F.elu(instance_norm(x, p[f"{n}.norm1.weight"],
                                p[f"{n}.norm1.bias"]))
        x = _c(x, p, f"{n}.conv2", ops)
        x = instance_norm(x, p[f"{n}.norm2.weight"], p[f"{n}.norm2.bias"])
        if residual:
            x = x + skip
        return F.elu(x)

    x = _c(space_to_depth(x, s2d), p, "conv_in", ops)
    skips = []
    for i in range(depth - 1):
        cin = width[i - 1] if i else width[0]
        x = block(x, f"enc{i}", cin == width[i])
        skips.append(x)
        x = F.max_pool3d(x, kernel_size=downs[i], stride=downs[i])
    x = block(x, "bridge", width[-2] == width[-1])
    for i in reversed(range(depth - 1)):
        x = ops.conv_t(x, p[f"up{i}.weight"], p[f"up{i}.bias"], downs[i])
        x = block(x + skips[i], f"dec{i}", True)
    # the head leaves the compute dtype before its sigmoid
    x = depth_to_space(_c(x, p, "conv_out", ops), s2d)
    return torch.sigmoid(x.float())


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and matmul, restored afterwards."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
