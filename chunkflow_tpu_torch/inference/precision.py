"""The forward precision: ``precision=``, ``CHUNKFLOW_PRECISION`` and
``CHUNKFLOW_INT8``.

The counterpart of ``chunkflow_tpu/inference/precision.py``, with its
names, aliases, rules and arithmetic. The wrapper replaces the engine's
forward once, at the inferencer's ``_forward`` seam, so every route (the
per-chunk scatter, the fold blend, the streamed executors, the CLI and
the serving packer) runs the chosen precision. Precision never touches
the blend: the accumulation buffers stay float32 and ``normalize_blend``'s
uint8 contract is unchanged.

- ``float32`` (the default): :func:`wrap_apply` returns the engine's
  ``apply`` itself, the same object, so the default path is bitwise the
  path without this module.
- ``bfloat16``: the batch is narrowed to bfloat16 and every float
  parameter and buffer rounded to bfloat16, as the JAX package casts its
  leaves; the result is cast to float32. A float32 engine then computes
  in float32 on bf16-rounded values, as flax promotes them. The port's
  modules compute in their parameters' storage dtype, so the rounded
  values are kept in it (``.to(bfloat16).to(float32)``) rather than
  narrowed; a bfloat16 engine casts them at use, as before.
- ``int8`` (W8A8), three legs behind ``CHUNKFLOW_INT8``:

  - ``fake`` (the default): the batch is fake-quantized per row (one
    scale per patch) and every float parameter per tensor onto the
    255-level [-127, 127] grid, then the engine runs as it is;
  - ``real``: the engine runs under :class:`Int8Mode`, which replaces
    every convolution and matrix product that an activation reaches by
    int8 operands with exact int32 sums (``ops/int8_conv.py``: the
    hand-written kernel on the card, float64 on the integer grid on the
    CPU), dequantized ``float(acc) * (s_row * s_w)``;
  - ``fakeint``: the same replacement with float32 sums on the same
    integer grid (the real leg's twin: bitwise ``real`` wherever the sums
    stay below 2^24).

  Parameters quantize per tensor and activations PER ROW (one scale per
  batch entry), so quantization commutes with how rows share a batch —
  what the serving packer's bitwise contract rests on.

The JAX package finds the replaced ops by re-evaluating the engine's
jaxpr (``_eval_int8_jaxpr``). The port's counterpart is a
``TorchFunctionMode`` active only around the engine's apply, with the
same taint rule: the patch batch is an activation; parameters and
anything computed from parameters alone (a cast, a flip, a reshape) are
weights; an op with any activation input gives activations. It replaces
``F.conv1d``/``conv2d``/``conv3d``, ``F.conv_transpose1d``/``2d``/``3d``,
``F.linear`` and ``torch.matmul``/``@`` when an operand is an
activation, so a user model built from plain ``nn.Conv3d`` is caught as
the jaxpr walk catches every engine.

Every division divides by a float32 tensor on the operand's device: CUDA
divides by a Python scalar as a multiply by its reciprocal, and the card
leg would stop being bitwise its CPU leg. ``torch.round`` rounds half to
even, as ``jnp.round`` does.

Selection: explicit ``precision`` is strict (an unknown value raises
``ValueError``); otherwise ``CHUNKFLOW_PRECISION`` is read, and an
unknown value prints one note on stderr (once per value) and runs
float32, so a typo never selects a quantized forward. ``CHUNKFLOW_INT8``
is lenient the same way (a typo runs ``fake``). Both are resolved once,
when the inferencer is built. :func:`wrap_stages` wraps a staged engine
(the ``pipeline=N`` mesh's, ``parallel/pipeline.py``) the same way.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from chunkflow_tpu_torch.core import envmode
from chunkflow_tpu_torch.ops import int8_conv

__all__ = ["PRECISIONS", "resolve_precision", "wrap_apply", "int8_mode",
           "precision_tag", "Int8Mode", "wrap_stages"]

PRECISIONS = ("float32", "bfloat16", "int8")

_ALIASES = {"f32": "float32", "fp32": "float32", "bf16": "bfloat16",
            "i8": "int8"}

# the env values each precision answers to ("" is the unset variable)
_ENV_CHOICES = {
    "float32": ("", "float32"),
    "bfloat16": ("bfloat16",),
    "int8": ("int8",),
}

# unknown env values already reported (one note per value per process)
_WARNED_VALUES: set = set()

_INT8_CHOICES = {
    "fake": ("", "fake", "0", "off"),
    "real": ("real", "1", "on"),
    "fakeint": ("fakeint",),
}
_INT8_WARNED: set = set()


def resolve_precision(value: Optional[str] = None) -> str:
    """The effective forward precision: ``float32``, ``bfloat16`` or
    ``int8``."""
    if value is not None:
        v = str(value).lower()
        v = _ALIASES.get(v, v)
        if v not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS} (got {value!r})")
        return v
    return envmode.resolve(
        "CHUNKFLOW_PRECISION", _ENV_CHOICES, "float32",
        "running the float32 default — a typo must not silently select a "
        "quantized forward", _WARNED_VALUES, _ALIASES)


def int8_mode() -> str:
    """``fake`` | ``real`` | ``fakeint``: the ``CHUNKFLOW_INT8`` leg of
    the int8 precision, read when a forward is wrapped."""
    return envmode.resolve(
        "CHUNKFLOW_INT8", _INT8_CHOICES, "fake",
        "running the fake-quant reference leg — a typo must not silently "
        "select the real integer matmul path", _INT8_WARNED)


def precision_tag(precision: str) -> str:
    """The resolved precision as a key component: ``""`` for float32,
    ``"prec-bfloat16"``, or ``"prec-int8-<fake|real|fakeint>"`` with the
    ``CHUNKFLOW_INT8`` leg folded in."""
    if precision == "float32":
        return ""
    if precision == "int8":
        return f"prec-int8-{int8_mode()}"
    return f"prec-{precision}"


# ---------------------------------------------------------------------------
# the quantization arithmetic (the JAX package's expressions, in its order)
# ---------------------------------------------------------------------------
def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device (a divisor CUDA divides
    by exactly), filled there: no copy from the host."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _grid(x: torch.Tensor, amax: torch.Tensor):
    """``(q, scale)``: ``scale = max(amax, 1e-12) / 127``, ``q =
    clip(round(x / scale), -127, 127)`` (float32-valued integers)."""
    scale = torch.clamp_min(amax, 1e-12) / _f32(127.0, amax)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    return q, scale


def _fake_quant_int8(x: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """Symmetric int8 fake quantization in float32: per tensor, or
    ``per_row`` (one scale per leading-axis entry, the activation rule).
    An all-zero tensor or row maps to exact zeros."""
    x = x.float()
    if per_row and x.dim() > 1:
        amax = torch.amax(x.abs(), dim=tuple(range(1, x.dim())),
                          keepdim=True)
    else:
        amax = torch.amax(x.abs())
    q, scale = _grid(x, amax)
    return q * scale


def _quant_rows_axis(x: torch.Tensor, axis: int):
    """Integer grid and scale of an activation operand: one scale per
    index along ``axis``, reduced over every other axis; ``scale`` keeps
    its dims."""
    x = x.float()
    axes = tuple(i for i in range(x.dim()) if i != axis)
    amax = (torch.amax(x.abs(), dim=axes, keepdim=True) if axes
            else x.abs())
    return _grid(x, amax)


def _quant_tensor(x: torch.Tensor):
    """Per-tensor integer grid and 0-d scale (the weight rule)."""
    x = x.float()
    return _grid(x, torch.amax(x.abs()))


def _scale_to_out(scale: torch.Tensor, out_ndim: int,
                  out_axis: int) -> torch.Tensor:
    """A per-row scale reshaped to broadcast along the output's
    ``out_axis``; a single scale becomes 0-d."""
    if scale.numel() == 1:
        return scale.reshape(())
    shape = [1] * out_ndim
    shape[out_axis] = scale.numel()
    return scale.reshape(shape)


def _int8(q: torch.Tensor) -> torch.Tensor:
    """The int8 copy of a grid: an activation image ``[b, c, d, h, w]``
    is written channels-last, each position padded to the Hopper
    kernel's 16-channel pitch (``int8_conv.channels_last_padded``: the
    one copy the kernel reads as it lies); anything else as it is."""
    if q.dim() == 5:
        return int8_conv.channels_last_padded(q)
    return q.to(torch.int8)


def _same_padding(padding, kernel, dilation, nd):
    """Per-axis ``(lo, hi)`` zero padding of ``F.conv*d``'s ``padding``
    (ints, or ``"valid"``/``"same"``)."""
    if isinstance(padding, str):
        if padding == "valid":
            return [(0, 0)] * nd
        if padding != "same":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for k, d in zip(kernel, dilation):
            total = d * (k - 1)
            out.append((total // 2, total - total // 2))
        return out
    pads = _ntuple(padding, nd)
    return [(p, p) for p in pads]


def _ntuple(v, nd):
    if isinstance(v, int):
        return (v,) * nd
    v = tuple(int(e) for e in v)
    return v * nd if len(v) == 1 else v


def _int8_conv(lhs: torch.Tensor, rhs: torch.Tensor, lhs_tainted: bool,
               integer: bool, stride=1, padding=0, dilation=1,
               groups: int = 1) -> torch.Tensor:
    """One convolution (``F.conv{1,2,3}d``'s arguments) at W8A8: an
    activation image quantizes per row over its batch axis, anything else
    and the kernel per tensor. ``integer`` sums int8 operands exactly
    (``ops/int8_conv.conv3d_int8``); otherwise float32 convolves the same
    integer grid. Dequant: ``prod * (s_lhs * s_rhs)``. Returns
    float32."""
    nd = lhs.dim() - 2
    ql, sl = _quant_rows_axis(lhs, 0) if lhs_tainted else _quant_tensor(lhs)
    qr, sr = _quant_tensor(rhs)
    stride = _ntuple(stride, nd)
    dilation = _ntuple(dilation, nd)
    pads = _same_padding(padding, rhs.shape[2:], dilation, nd)
    if any(lo != hi for lo, hi in pads):
        # asymmetric "same": pad the grid with zeros, which add exactly
        flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
        ql = F.pad(ql, flat)
        pads = [(0, 0)] * nd
    sym = tuple(lo for lo, _ in pads)
    # both legs convolve in 3D (a 1D or 2D convolution lifted by singleton
    # axes): cuDNN's 2D float32 algorithms include ones that do not add
    # an integer grid exactly (72 channels at 64x64: 1.2e-6 off)
    lift = (1,) * (3 - nd)
    x5 = ql.reshape(ql.shape[:2] + lift + ql.shape[2:])
    w5 = qr.reshape(qr.shape[:2] + lift + qr.shape[2:])
    args = (lift + stride, (0,) * (3 - nd) + sym, lift + dilation)
    if integer:
        xq = _int8(x5)
        wq = w5.to(torch.int8, memory_format=torch.channels_last_3d)
        cin, cout = xq.shape[1] // groups, wq.shape[0] // groups
        parts = [int8_conv.conv3d_int8(xq[:, g * cin:(g + 1) * cin],
                                       wq[g * cout:(g + 1) * cout], *args)
                 for g in range(groups)]
        acc = parts[0] if groups == 1 else torch.cat(parts, dim=1)
        prod = acc.float()
    else:
        prod = F.conv3d(x5, w5, None, *args, groups)
    prod = prod.reshape(prod.shape[:2] + prod.shape[5 - nd:])
    return prod * (_scale_to_out(sl, prod.dim(), 0) * sr)


def _depth_to_space(y: torch.Tensor, factor) -> torch.Tensor:
    """``[b, prod(factor) * F, *spatial]`` with the channel order
    ``(*factor, F)`` -> ``[b, F, *(spatial * factor)]``."""
    nd = len(factor)
    b, spatial = y.shape[0], y.shape[2:]
    f = y.shape[1] // math.prod(factor)
    y = y.reshape((b,) + tuple(factor) + (f,) + tuple(spatial))
    order = [0, nd + 1]
    for i in range(nd):
        order += [nd + 2 + i, 1 + i]
    y = y.permute(order)
    return y.reshape((b, f) + tuple(s * k for s, k in zip(spatial, factor)))


def _int8_conv_transpose(lhs: torch.Tensor, rhs: torch.Tensor,
                         lhs_tainted: bool, integer: bool, stride=1,
                         padding=0, output_padding=0, groups: int = 1,
                         dilation=1) -> torch.Tensor:
    """One transposed convolution at W8A8 (``F.conv_transpose{1,2,3}d``'s
    arguments; the JAX package's is a convolution with input dilation).
    The decoders' kind, kernel == stride without padding, has output
    windows that never overlap, so it is exactly a 1x1x1 convolution to
    ``Cout * prod(kernel)`` channels followed by depth-to-space: the same
    scales, the same integer sums. Other transposed convolutions
    raise."""
    nd = lhs.dim() - 2
    kernel = tuple(rhs.shape[2:])
    if not (_ntuple(stride, nd) == kernel
            and _ntuple(padding, nd) == (0,) * nd
            and _ntuple(output_padding, nd) == (0,) * nd
            and _ntuple(dilation, nd) == (1,) * nd and groups == 1):
        raise NotImplementedError(
            f"the int8 forward takes transposed convolutions with kernel == "
            f"stride, no padding and one group; got kernel {kernel}, stride "
            f"{stride}, padding {padding}, groups {groups}")
    cin = rhs.shape[0]
    order = tuple(range(2, nd + 2)) + (1, 0)
    w1 = rhs.permute(order).reshape((-1, cin) + (1,) * nd)
    return _depth_to_space(_int8_conv(lhs, w1, lhs_tainted, integer), kernel)


def _dot_general(a: torch.Tensor, b: torch.Tensor, dimension_numbers,
                 integer: bool) -> torch.Tensor:
    """``lax.dot_general`` of two integer grids: batch dims, then ``a``'s
    free dims, then ``b``'s. ``integer`` sums int8 exactly
    (``ops/int8_conv.matmul_int8``, one launch per batch entry);
    otherwise float32."""
    (lc, rc), (lb, rb) = dimension_numbers
    free_a = [i for i in range(a.dim()) if i not in lc and i not in lb]
    free_b = [i for i in range(b.dim()) if i not in rc and i not in rb]
    shape = ([a.shape[i] for i in lb] + [a.shape[i] for i in free_a]
             + [b.shape[i] for i in free_b])

    def size(t, dims):
        n = 1
        for i in dims:
            n *= t.shape[i]
        return n

    nb = size(a, lb)
    m, k, n = size(a, free_a), size(a, lc), size(b, free_b)
    if integer:
        a = _int8(a)
        b = _int8(b)
    a3 = a.permute(list(lb) + free_a + list(lc)).reshape(nb, m, k)
    b3 = b.permute(list(rb) + list(rc) + free_b).reshape(nb, k, n)
    if integer:
        prod = torch.stack([int8_conv.matmul_int8(a3[i], b3[i])
                            for i in range(nb)]).float()
    else:
        prod = torch.matmul(a3, b3)
    return prod.reshape(shape)


def _int8_dot(lhs: torch.Tensor, rhs: torch.Tensor, lhs_tainted: bool,
              rhs_tainted: bool, integer: bool,
              dimension_numbers) -> torch.Tensor:
    """One ``dot_general`` at W8A8: an activation operand quantizes per
    row over its leading axis when that axis is free (neither contracted
    nor batched), else per tensor; a weight per tensor. Dequant ``prod *
    (s_lhs * s_rhs)``, each scale along its axis of the output."""
    (lc, rc), (lb, rb) = dimension_numbers
    free_l = [i for i in range(lhs.dim()) if i not in lc and i not in lb]
    free_r = [i for i in range(rhs.dim()) if i not in rc and i not in rb]

    def quant(x, tainted, free):
        if tainted and x.dim() > 1 and 0 in free:
            return _quant_rows_axis(x, 0)
        return _quant_tensor(x)

    ql, sl = quant(lhs, lhs_tainted, free_l)
    qr, sr = quant(rhs, rhs_tainted, free_r)
    prod = _dot_general(ql, qr, dimension_numbers, integer)
    sl_b = _scale_to_out(
        sl, prod.dim(), len(lb) + (free_l.index(0) if 0 in free_l else 0))
    sr_b = _scale_to_out(
        sr, prod.dim(),
        len(lb) + len(free_l) + (free_r.index(0) if 0 in free_r else 0))
    return prod * (sl_b * sr_b)


def _matmul_numbers(a: torch.Tensor, b: torch.Tensor):
    """``torch.matmul``'s contraction as dot_general dimension numbers:
    ``[..., K] @ [K, N]``, or a batched product with equal batch dims."""
    if a.dim() >= 2 and b.dim() == 2:
        return ((a.dim() - 1,), (0,)), ((), ())
    if a.dim() == b.dim() >= 3 and a.shape[:-2] == b.shape[:-2]:
        batch = tuple(range(a.dim() - 2))
        return ((a.dim() - 1,), (b.dim() - 2,)), (batch, batch)
    raise NotImplementedError(
        f"the int8 forward takes [..., K] @ [K, N] and batched products "
        f"with equal batch dims, got {tuple(a.shape)} @ {tuple(b.shape)}")


# ---------------------------------------------------------------------------
# the activation-taint mode (the jaxpr walk's counterpart)
# ---------------------------------------------------------------------------
_MARK = "_chunkflow_int8_activation"


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


def _bind(args, kwargs, names, defaults):
    """Positional and keyword arguments of a functional call, by name."""
    values = list(args) + [None] * (len(names) - len(args))
    for i, name in enumerate(names):
        if name in kwargs:
            values[i] = kwargs[name]
        elif i >= len(args) and name in defaults:
            values[i] = defaults[name]
    return values


def _with_bias(y: torch.Tensor, bias: Optional[torch.Tensor],
               channel_axis: int) -> torch.Tensor:
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_axis] = -1
    return y + bias.reshape(shape)


_CONV = ("input", "weight", "bias", "stride", "padding", "dilation",
         "groups")
_CONV_DEFAULTS = {"stride": 1, "padding": 0, "dilation": 1, "groups": 1}
_CONVT = ("input", "weight", "bias", "stride", "padding", "output_padding",
          "groups", "dilation")
_CONVT_DEFAULTS = {"stride": 1, "padding": 0, "output_padding": 0,
                   "groups": 1, "dilation": 1}


class Int8Mode(TorchFunctionMode):
    """Replaces the convolutions and matrix products an activation reaches
    by their W8A8 forms (``integer``: exact int32 sums; else the float32
    twin). :meth:`mark` declares the patch batch; every op with a marked
    input marks its outputs (and the tensor an in-place op writes). The
    mark is this mode's own token, so marks left on tensors by another
    call never count."""

    def __init__(self, integer: bool):
        super().__init__()
        self.integer = integer
        self._token = object()

    def mark(self, t: torch.Tensor) -> torch.Tensor:
        setattr(t, _MARK, self._token)
        return t

    def is_activation(self, t) -> bool:
        return (isinstance(t, torch.Tensor)
                and getattr(t, _MARK, None) is self._token)

    def _conv(self, args, kwargs):
        x, w, bias, stride, padding, dilation, groups = _bind(
            args, kwargs, _CONV, _CONV_DEFAULTS)
        y = _int8_conv(x, w, self.is_activation(x), self.integer, stride,
                       padding, dilation, groups)
        return _with_bias(y, bias, 1)

    def _conv_transpose(self, args, kwargs):
        (x, w, bias, stride, padding, output_padding, groups,
         dilation) = _bind(args, kwargs, _CONVT, _CONVT_DEFAULTS)
        y = _int8_conv_transpose(x, w, self.is_activation(x), self.integer,
                                 stride, padding, output_padding, groups,
                                 dilation)
        return _with_bias(y, bias, 1)

    def _linear(self, args, kwargs):
        x, w, bias = _bind(args, kwargs, ("input", "weight", "bias"), {})
        kernel = w.t()
        y = _int8_dot(x, kernel, self.is_activation(x),
                      self.is_activation(w), self.integer,
                      _matmul_numbers(x, kernel))
        return _with_bias(y, bias, -1)

    def _matmul(self, a, b):
        return _int8_dot(a, b, self.is_activation(a), self.is_activation(b),
                         self.integer, _matmul_numbers(a, b))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(self.is_activation(t)
                   for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)
        if func in _CONVS:
            out = self._conv(args, kwargs)
        elif func in _CONV_TRANSPOSES:
            out = self._conv_transpose(args, kwargs)
        elif func is F.linear:
            out = self._linear(args, kwargs)
        elif func in _MATMULS:
            out = self._matmul(*_bind(args, kwargs, ("input", "other"), {}))
        elif func is torch.Tensor.__rmatmul__:
            out = self._matmul(args[1], args[0])
        else:
            out = func(*args, **kwargs)
            name = getattr(func, "__name__", "")
            if args and isinstance(args[0], torch.Tensor) and (
                    name.endswith("_") or name in _WRITES):
                self.mark(args[0])  # an in-place write of activations
            for t in _tensors(kwargs.get("out")):
                self.mark(t)
        for t in _tensors(out):
            self.mark(t)
        return out


_CONVS = (F.conv1d, F.conv2d, F.conv3d)
_CONV_TRANSPOSES = (F.conv_transpose1d, F.conv_transpose2d,
                    F.conv_transpose3d)
_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
_WRITES = ("__setitem__", "__iadd__", "__isub__", "__imul__",
           "__itruediv__")


# ---------------------------------------------------------------------------
# parameters and the wrapper
# ---------------------------------------------------------------------------
def _map_float_leaves(tree, fn):
    """``tree`` with ``fn`` applied to each floating-point tensor: an
    ``nn.Module`` is copied and its float parameters and buffers replaced
    in the copy (the caller's module is untouched); dicts, lists and
    tuples are rebuilt; anything else is kept."""
    if isinstance(tree, nn.Module):
        module = copy.deepcopy(tree)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                if t.is_floating_point():
                    t.data = fn(t.data)
        return module
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _map_float_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_float_leaves(v, fn) for v in tree)
    return tree


def _cast_float_leaves(tree, dtype):
    """Every float leaf rounded to ``dtype`` and kept in its own dtype."""
    return _map_float_leaves(tree, lambda t: t.to(dtype).to(t.dtype))


def _quant_float_leaves(tree):
    """Every float leaf fake-quantized per tensor (float32)."""
    return _map_float_leaves(tree, _fake_quant_int8)


def wrap_apply(apply: Callable, precision: str, params=None,
               call: Optional[Callable] = None) -> Callable:
    """The engine forward ``apply(batch)`` at ``precision``.

    ``float32`` returns ``apply`` itself (the same object). ``params`` and
    ``call`` (``call(params, batch) == apply(batch)``) are the engine's
    parameters — an ``nn.Module`` or a tree of tensors — and its forward
    on given parameters; bfloat16 and int8 ``fake`` round or quantize
    copies of them ONCE, here (the JAX package recomputes the same values
    inside every call). An engine without parameters (the identity
    engine) passes neither. The narrow forwards return float32.
    """
    if precision == "float32":
        return apply
    if precision == "bfloat16":
        if call is not None:
            rounded = _cast_float_leaves(params, torch.bfloat16)

            def run(batch):
                return call(rounded, batch)
        else:
            run = apply

        def bf16_apply(batch):
            return run(batch.to(torch.bfloat16)).float()

        return bf16_apply
    if precision == "int8":
        mode = int8_mode()  # resolved once, at wrap time
        if mode == "fake":
            if call is not None:
                quantized = _quant_float_leaves(params)

                def run(batch):
                    return call(quantized, batch)
            else:
                run = apply

            def int8_apply(batch):
                return run(_fake_quant_int8(batch, per_row=True)).float()

            return int8_apply
        integer = mode == "real"

        def int8_real_apply(batch):
            with Int8Mode(integer) as int8:
                # mark a new handle on the batch, not the caller's tensor
                out = apply(int8.mark(batch.detach()))
            return out.float()

        return int8_real_apply
    raise ValueError(f"unknown precision {precision!r}")


def wrap_stages(stage_bodies, stage_tail, precision: str, params=None):
    """Precision-wrap a staged engine so that the composition of the
    wrapped pieces is bitwise :func:`wrap_apply` of the unwrapped
    composition, what the pipeline mesh's bitwise contract rests on.
    Returns ``(entry, bodies, tail)``:

    - ``entry(x)``: the activation cast, once, on the gathered batch
      before stage 0 (the handoffs then carry one dtype);
    - ``bodies``: each ``(params, x) -> x`` body on the rounded or
      quantized parameters (copied once, here, as :func:`wrap_apply`
      does), the activations untouched;
    - ``tail``: the tail on those parameters, its result cast to float32
      for the blend.

    float32 returns the bodies and the tail themselves. The int8
    ``real`` and ``fakeint`` legs replace operations inside the whole
    forward and cannot be split at stage seams: they return ``(None,
    None, None)``, and a pipeline mesh raises."""
    if stage_bodies is None or stage_tail is None:
        return None, None, None
    if precision == "float32":
        return (lambda x: x), tuple(stage_bodies), stage_tail
    if precision == "bfloat16":
        rounded = _cast_float_leaves(params, torch.bfloat16)

        def entry(x):
            return x.to(torch.bfloat16)

        bodies = tuple((lambda _, x, _b=body: _b(rounded, x))
                       for body in stage_bodies)

        def tail(_, x):
            return stage_tail(rounded, x).float()

        return entry, bodies, tail
    if precision == "int8":
        if int8_mode() != "fake":
            # real/fakeint replace ops of the whole forward: not
            # splittable at stage seams
            return None, None, None
        quantized = _quant_float_leaves(params)

        def entry(x):
            return _fake_quant_int8(x, per_row=True)

        bodies = tuple((lambda _, x, _b=body: _b(quantized, x))
                       for body in stage_bodies)

        def tail(_, x):
            return stage_tail(quantized, x).float()

        return entry, bodies, tail
    raise ValueError(f"unknown precision {precision!r}")
