"""Patch inference engines: batch-forward callables on tensors.

The counterpart of ``chunkflow_tpu/inference/engines.py``. An engine's
``apply`` maps a ``[B, Cin, *in_patch]`` float32 batch to ``[B, Cout,
*out_patch]`` on the batch's device; ``model`` (when there is one) is the
``nn.Module`` the inferencer moves to its device. Frameworks:
``identity`` (the test oracle), ``pytorch`` / ``flax`` / ``jax`` (the
convnet engine: the built-in model families or a user model file — the
names are kept for CLI parity with the JAX package, whose flax engine
serves them all), ``universal`` (a user engine file) and ``prebuilt``
(an ``Engine`` passed in).

A convnet forward runs under :func:`exact_float32`: cuDNN and matmul with
TF32 off, deterministic algorithms and no autotuning, scoped to the call,
so a float32 forward on the card computes the float32 function its
weights define whatever the process's global flags say.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from chunkflow_tpu_torch.models import migrate
from chunkflow_tpu_torch.models.convert import init_or_load_weights
from chunkflow_tpu_torch.models.rsunet import RSUNet
from chunkflow_tpu_torch.models.unet3d import UNet3D, create_tpu_optimized_model

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_VARIANTS = ("parity", "rsunet", "tpu", "tpu_mxu", "tpu_s2d4")


_FLAGS_LOCK = threading.Lock()
_FLAGS_USERS = 0
_FLAGS_SAVED: Optional[tuple] = None


def _flags() -> tuple:
    cudnn = torch.backends.cudnn
    return (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32)


def _set_flags(flags: tuple) -> None:
    cudnn = torch.backends.cudnn
    (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
     torch.backends.cuda.matmul.allow_tf32) = flags


@contextlib.contextmanager
def exact_float32():
    """Run a forward with TF32 off (cuDNN and matmul), deterministic cuDNN
    algorithms and ``benchmark=False``, then put the process's flags back.
    The flags are process-wide, so concurrent forwards (the executors'
    threads) share one scope: the first to enter saves and sets them, the
    last to leave restores them. bfloat16 convolutions do not read the
    TF32 flags; their algorithm choice is pinned the same way."""
    global _FLAGS_USERS, _FLAGS_SAVED
    with _FLAGS_LOCK:
        if _FLAGS_USERS == 0:
            _FLAGS_SAVED = _flags()
            _set_flags((False, True, False, False))
        _FLAGS_USERS += 1
    try:
        yield
    finally:
        with _FLAGS_LOCK:
            _FLAGS_USERS -= 1
            if _FLAGS_USERS == 0:
                _set_flags(_FLAGS_SAVED)
                _FLAGS_SAVED = None


class Engine(NamedTuple):
    apply: Callable  # [B, Cin, *pin] float32 -> [B, Cout, *pout]
    num_input_channels: int
    num_output_channels: int
    model: Optional[nn.Module] = None
    # the forward on given parameters, ``call(params, batch) ==
    # apply(batch)``: the precision wrapper runs it on rounded or
    # quantized copies of ``params`` (an nn.Module or a tree of tensors)
    params: object = None
    call: Optional[Callable] = None
    # the stage protocol (parallel/pipeline.py): an engine that a
    # ``pipeline=N`` mesh can split declares its layer stack as
    # uniform-activation bodies ``(params, x) -> x`` and a tail
    # ``(params, x) -> [B, Cout, *pout]``, with ``apply`` their literal
    # composition on ``params`` (bitwise). None: the forward is opaque,
    # and a pipeline mesh raises
    stage_bodies: Optional[Tuple[Callable, ...]] = None
    stage_tail: Optional[Callable] = None


def create_identity_engine(
    input_patch_size,
    output_patch_size,
    num_output_channels: int = 1,
    num_input_channels: int = 1,
) -> Engine:
    """Crop-and-repeat oracle: output is the input's first channel's
    central crop, repeated across output channels. Identity through the
    whole blend path must reproduce the input exactly. It declares the
    stage protocol: one identity body and the crop-and-repeat tail, whose
    composition is ``apply``."""
    pin = tuple(input_patch_size)
    pout = tuple(output_patch_size)
    margin = tuple((i - o) // 2 for i, o in zip(pin, pout))
    window = tuple(slice(m, m + o) for m, o in zip(margin, pout))

    def stage_body(params, x):
        return x

    def stage_tail(params, batch):
        center = batch[(slice(None), slice(0, 1)) + window]
        return center.expand((batch.shape[0], num_output_channels) + pout)

    def apply(batch):
        return stage_tail(None, stage_body(None, batch))

    return Engine(apply=apply, num_input_channels=num_input_channels,
                  num_output_channels=num_output_channels,
                  stage_bodies=(stage_body,), stage_tail=stage_tail)


def build_model(model_variant: str = "parity", num_input_channels: int = 1,
                num_output_channels: int = 3,
                dtype: str = "float32") -> nn.Module:
    """The built-in model of a family at its full widths: ``parity`` the
    reference-class UNet3D, ``rsunet`` the production RSUNet mirror,
    ``tpu`` the (1, 2, 2) space-to-depth flagship, ``tpu_mxu`` the same
    with z-decomposed 2D convolutions and a GEMM upsampling (the JAX
    package's ``conv_impl="mxu"``: the same parameters) and ``tpu_s2d4``
    its (1, 4, 4) stem."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {dtype!r}")
    kwargs = dict(in_channels=num_input_channels,
                  out_channels=num_output_channels,
                  dtype=COMPUTE_DTYPES[dtype])
    if model_variant in ("tpu", "tpu_mxu", "tpu_s2d4"):
        return create_tpu_optimized_model(
            s2d_factor=(1, 4, 4) if model_variant == "tpu_s2d4"
            else (1, 2, 2),
            conv_impl="mxu" if model_variant == "tpu_mxu" else "native",
            **kwargs)
    if model_variant == "rsunet":
        return RSUNet(**kwargs)
    if model_variant == "parity":
        return UNet3D(**kwargs)
    raise ValueError(f"unknown model_variant {model_variant!r}; one of "
                     f"{MODEL_VARIANTS}")


def create_convnet_engine(
    model_path: str,
    weight_path: Optional[str],
    num_input_channels: int = 1,
    num_output_channels: int = 3,
    dtype: str = "float32",
    model_variant: str = "parity",
) -> Engine:
    """The convnet engine (``create_flax_engine``).

    ``model_path`` may be empty (the built-in model of ``model_variant``,
    see :func:`build_model`), a python file exposing
    ``create_model(num_input_channels, num_output_channels)`` that
    returns an ``nn.Module``, or a reference-chunkflow pytorch
    ``model.py`` (``InstantiatedModel`` / ``load_model``) whose weights
    load by name into the built-in mirror (``models/migrate.py``).
    ``weight_path`` may be a ``.pt`` state dict, a flax ``.msgpack``
    file or an orbax checkpoint directory
    (``models/convert.py:init_or_load_weights``); without one the
    weights are a seeded init. ``dtype`` is the built-in models' compute
    dtype; a ``create_model`` module computes in what it chooses, as in
    the JAX package. The engine returns float32.
    """
    module = migrate.load_user_module(model_path) if model_path else None
    if module is not None and hasattr(module, "create_model"):
        model = module.create_model(num_input_channels, num_output_channels)
    else:
        model = build_model(model_variant, num_input_channels,
                            num_output_channels, dtype)
    if module is not None and not hasattr(module, "create_model"):
        migrate.load_reference_model(module, weight_path, model)
    else:
        init_or_load_weights(model, weight_path)
    model.eval()

    def call(module, batch):
        with exact_float32():
            return module(batch).float()

    def apply(batch):
        return call(model, batch)

    return Engine(apply=apply, num_input_channels=num_input_channels,
                  num_output_channels=num_output_channels, model=model,
                  params=model, call=call)


def create_universal_engine(
    model_path: str,
    weight_path: Optional[str],
    input_patch_size,
    output_patch_size,
    num_input_channels: int = 1,
    num_output_channels: int = 3,
) -> Engine:
    """A user engine file exposing ``create_engine(weight_path,
    input_patch_size, output_patch_size, num_input_channels,
    num_output_channels) -> (params, apply)``, with ``apply(params,
    batch)`` on tensors. When ``params`` is an ``nn.Module`` it is the
    engine's ``model``, which the inferencer moves to its device."""
    module = migrate.load_user_module(model_path,
                                      "chunkflow_universal_engine")
    params, user_apply = module.create_engine(
        weight_path,
        tuple(input_patch_size),
        tuple(output_patch_size),
        num_input_channels,
        num_output_channels,
    )

    def call(user_params, batch):
        with exact_float32():
            return user_apply(user_params, batch)

    def apply(batch):
        return call(params, batch)

    return Engine(apply=apply, num_input_channels=num_input_channels,
                  num_output_channels=num_output_channels,
                  model=params if isinstance(params, nn.Module) else None,
                  params=params, call=call)


def create_engine(framework: str, **kwargs) -> Engine:
    if framework == "prebuilt":
        engine = kwargs.get("engine")
        if not isinstance(engine, Engine):
            raise TypeError(
                "framework='prebuilt' needs an Engine instance as engine="
            )
        return engine
    if framework == "identity":
        return create_identity_engine(
            kwargs["input_patch_size"],
            kwargs["output_patch_size"],
            num_output_channels=kwargs.get("num_output_channels", 1),
            num_input_channels=kwargs.get("num_input_channels", 1),
        )
    if framework in ("pytorch", "flax", "jax"):
        return create_convnet_engine(
            kwargs.get("model_path", ""),
            kwargs.get("weight_path"),
            num_input_channels=kwargs.get("num_input_channels", 1),
            num_output_channels=kwargs.get("num_output_channels", 3),
            dtype=kwargs.get("dtype", "float32"),
            model_variant=kwargs.get("model_variant", "parity"),
        )
    if framework == "universal":
        return create_universal_engine(
            kwargs["model_path"],
            kwargs.get("weight_path"),
            kwargs["input_patch_size"],
            kwargs["output_patch_size"],
            num_input_channels=kwargs.get("num_input_channels", 1),
            num_output_channels=kwargs.get("num_output_channels", 3),
        )
    raise ValueError(f"unknown inference framework: {framework!r}")
