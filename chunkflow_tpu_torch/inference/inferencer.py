"""Per-chunk patch inference on one CUDA device.

The counterpart of ``chunkflow_tpu/inference/inferencer.py`` for the
single-device scatter path: chunk -> patch grid -> raw upload -> per batch
(gather -> convnet forward -> bump-weighted accumulate) -> reciprocal
normalization -> myelin mask and margin crop. The JAX package runs the
loop as one compiled program; here it runs eagerly, each batch as two
hand-written CUDA kernels around the forward (``ops/gather.py``,
``ops/accumulate.py``), and the result is bitwise the JAX package's
wherever the forward is (the identity engine), because every step
repeats its arithmetic in its order.

The entry point runs on the card (``device="cuda"``, the default) and
raises when there is none, unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain PyTorch versions run. Options of the JAX
``Inferencer`` that are not ported raise ``NotImplementedError`` naming
the ROADMAP item that ports them; none is ignored.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType, _as_tensor
from chunkflow_tpu_torch.core.cartesian import Cartesian
from chunkflow_tpu_torch.core.dtypes import numpy_dtype, signed_view
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.inference.bump import bump_map
from chunkflow_tpu_torch.inference.patching import enumerate_patches, pad_to_batch
from chunkflow_tpu_torch.ops import gather
from chunkflow_tpu_torch.ops.blend import build_local_blend, normalize_blend


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — the
    port never carries on on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {device}")
    return device


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP, queue "
                              f"1: {item})")


def _edge_pad(arr: torch.Tensor, run_zyx) -> torch.Tensor:
    """Pad ``[c, z, y, x]`` at the high side up to ``run_zyx`` by
    replicating the boundary plane (index clamping: ``F.pad``'s replicate
    mode takes no integer tensors). Conversion commutes with it, so the
    raw chunk pads exactly as a converted one would."""
    view = signed_view(arr)
    for axis, (run, size) in enumerate(zip(run_zyx, arr.shape[1:]), start=1):
        if run > size:
            index = torch.arange(run, device=arr.device).clamp_(max=size - 1)
            view = view.index_select(axis, index)
    return view.view(arr.dtype)


class Inferencer:
    def __init__(
        self,
        input_patch_size,
        output_patch_size=None,
        output_patch_overlap=(0, 0, 0),
        num_output_channels: int = 1,
        num_input_channels: int = 1,
        framework: str = "identity",
        model_path: str = "",
        weight_path: Optional[str] = None,
        batch_size: int = 1,
        augment: bool = False,
        bump: str = "wu",
        crop_output_margin: bool = True,
        mask_myelin_threshold: Optional[float] = None,
        dtype: str = "float32",
        output_dtype: str = "float32",
        model_variant: str = "parity",
        engine=None,
        sharding: str = "none",
        mesh: Optional[str] = None,
        precision: Optional[str] = None,
        shape_bucket=None,
        blend: str = "auto",
        dry_run: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.input_patch_size = Cartesian.from_collection(input_patch_size)
        self.output_patch_size = (
            Cartesian.from_collection(output_patch_size)
            if output_patch_size is not None
            else self.input_patch_size
        )
        self.output_patch_overlap = Cartesian.from_collection(output_patch_overlap)
        self.crop_margin = (self.input_patch_size - self.output_patch_size) // 2
        self.num_output_channels = num_output_channels
        self.num_input_channels = num_input_channels
        self.batch_size = batch_size
        self.augment = augment
        self.crop_output_margin = crop_output_margin
        self.mask_myelin_threshold = mask_myelin_threshold
        self.dry_run = dry_run
        if output_dtype not in ("float32", "bfloat16", "uint8"):
            raise ValueError(
                f"output_dtype must be float32, bfloat16 or uint8, got "
                f"{output_dtype!r}"
            )
        if output_dtype == "uint8" and mask_myelin_threshold is not None:
            raise ValueError(
                "mask_myelin_threshold compares [0,1] probabilities; "
                "combine it with float output_dtype, not uint8"
            )
        self.output_dtype = output_dtype
        if sharding not in ("none", "patch", "spatial", "spatial2d"):
            raise ValueError(f"unknown sharding mode {sharding!r}")
        if sharding != "none" or mesh is not None:
            _not_ported("multi-device execution (sharding / mesh)",
                        "multi-GPU engine")
        if blend not in ("auto", "scatter", "fold"):
            raise ValueError(f"unknown blend mode {blend!r}")
        if blend == "fold":
            _not_ported("blend='fold'", "fold blend")
        if precision is not None:
            _not_ported("the precision ladder (precision=)",
                        "precision ladder")
        self.shape_bucket = (
            Cartesian.from_collection(shape_bucket)
            if shape_bucket is not None and any(shape_bucket)
            else None
        )
        if self.shape_bucket is not None and not self.shape_bucket.all_positive():
            raise ValueError(
                f"shape_bucket must be all-positive (or all-zero to "
                f"disable), got {tuple(self.shape_bucket)}"
            )
        if bump != "wu":
            raise ValueError(f"only the 'wu' bump is implemented, got {bump!r}")
        if augment and (
            self.input_patch_size.y != self.input_patch_size.x
            or self.output_patch_size.y != self.output_patch_size.x
        ):
            raise ValueError(
                "test-time augmentation needs square yx input AND output patches"
            )

        self.engine = engines.create_engine(
            framework,
            engine=engine,
            input_patch_size=tuple(self.input_patch_size),
            output_patch_size=tuple(self.output_patch_size),
            num_output_channels=num_output_channels,
            num_input_channels=num_input_channels,
            model_path=model_path,
            weight_path=weight_path,
            dtype=dtype,
            model_variant=model_variant,
        )
        if self.engine.model is not None:
            self.engine.model.to(self.device)
        pout = tuple(self.output_patch_size)
        self._local_blend = build_local_blend(
            self._forward,
            num_input_channels,
            num_output_channels,
            tuple(self.input_patch_size),
            pout,
            batch_size,
            torch.tensor(bump_map(pout), device=self.device),
        )

    # ------------------------------------------------------------------
    def _run_shape(self, zyx) -> tuple:
        """The shape actually executed for an incoming chunk shape: the
        bucket multiple (at least one input patch) when bucketing."""
        run = tuple(zyx)[-3:]
        if self.shape_bucket is not None:
            run = tuple((
                Cartesian.from_collection(run).ceildiv(self.shape_bucket)
                * self.shape_bucket
            ).maximum(self.input_patch_size))
        return run

    def patch_grid_shape(self, chunk_shape) -> Tuple[int, int, int]:
        """Patches per axis for a chunk shape (the reference --patch-num
        contract), from the same grid the inference runs."""
        grid = enumerate_patches(
            self._run_shape(chunk_shape),
            self.input_patch_size,
            self.output_patch_size,
            self.output_patch_overlap,
        )
        return tuple(
            int(np.unique(grid.input_starts[:, i]).size) for i in range(3)
        )

    @property
    def compute_device(self) -> str:
        if self.device.type == "cuda":
            return f"cuda:{torch.cuda.get_device_name(self.device)}"
        return "cpu"

    # ------------------------------------------------------------------
    def _forward(self, patches):
        """Engine forward with optional 8-fold test-time augmentation:
        the product of {yx-transpose, y-flip, x-flip}; each variant's
        output is transformed back and the eight are summed in the JAX
        package's order, then divided by 8."""
        apply = self.engine.apply
        if not self.augment:
            return apply(patches)
        acc = None
        for transpose, flip_y, flip_x in itertools.product((False, True),
                                                          repeat=3):
            x = patches
            if flip_y:
                x = torch.flip(x, dims=(-2,))
            if flip_x:
                x = torch.flip(x, dims=(-1,))
            if transpose:
                x = x.transpose(-1, -2)
            y = apply(x.contiguous())
            if transpose:
                y = y.transpose(-1, -2)
            if flip_x:
                y = torch.flip(y, dims=(-1,))
            if flip_y:
                y = torch.flip(y, dims=(-2,))
            acc = y if acc is None else acc + y
        return acc / 8.0

    # ------------------------------------------------------------------
    def __call__(self, chunk: Chunk) -> Chunk:
        """Infer one chunk; the result's payload lies on the inferencer's
        device (``.host()`` brings it back) and is complete on return."""
        result = self._infer(chunk)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return result

    def stream(self, *args, **kwargs):
        _not_ported("Inferencer.stream", "streaming executor")

    def infer_async(self, *args, **kwargs):
        _not_ported("Inferencer.infer_async", "streaming executor")

    @property
    def _out_layer(self):
        return (
            LayerType.AFFINITY_MAP
            if self.num_output_channels == 3
            else LayerType.PROBABILITY_MAP
        )

    def _blank_output(self, chunk: Chunk) -> Chunk:
        """The dry-run / all-zero-input result: a zero host chunk with the
        real path's channel count and dtype."""
        nchan = self.num_output_channels
        if self.mask_myelin_threshold is not None:
            nchan -= 1
        blank_dtype = {
            "float32": np.float32,
            "bfloat16": torch.bfloat16,
            "uint8": np.uint8,
        }[self.output_dtype]
        out = Chunk.from_bbox(chunk.bbox, dtype=blank_dtype, nchannels=nchan,
                              voxel_size=chunk.voxel_size)
        out.layer_type = self._out_layer
        if self.crop_output_margin:
            out = out.crop_margin(self.crop_margin)
        return out

    def _postprocess_result(self, result, chunk: Chunk,
                            orig_zyx, run_zyx) -> Chunk:
        """Crop bucket padding, wrap, myelin-mask and margin-crop a raw
        result."""
        if run_zyx != orig_zyx:
            result = result[:, : orig_zyx[0], : orig_zyx[1], : orig_zyx[2]]
        out = Chunk(
            result,
            voxel_offset=chunk.voxel_offset,
            voxel_size=chunk.voxel_size,
            layer_type=self._out_layer,
        )
        if self.mask_myelin_threshold is not None:
            out = out.mask_using_last_channel(
                threshold=self.mask_myelin_threshold
            )
        if self.crop_output_margin:
            out = out.crop_margin(self.crop_margin)
        return out

    def _upload(self, chunk: Chunk) -> torch.Tensor:
        """The chunk on the device as ``[c, z, y, x]``: RAW where the gather
        converts it (float32, ints up to 32 bits — a uint8 chunk rides at
        1/4 the bytes of float32), else float32 converted exactly as the
        JAX package does (64-bit ints on the host, then the scale multiply
        on the device; other floats rounded to float32)."""
        arr = chunk.array
        dt = numpy_dtype(arr.dtype)
        if isinstance(arr, np.ndarray):
            if dt is not None and not gather.raw_eligible(dt):
                # 64-bit ints and non-float32 floats round to float32 on
                # the host; the int scale multiply follows on the device
                arr = arr.astype(np.float32)
            arr = _as_tensor(arr)
        arr = arr.to(self.device)
        if dt is None or not gather.raw_eligible(dt):
            arr = arr.to(torch.float32)
            scale = gather.int_scale(dt) if dt is not None else None
            if scale is not None:
                arr = arr.mul_(float(scale))
        if arr.dim() == 3:
            arr = arr[None]
        return arr.contiguous()

    def _infer(self, chunk: Chunk) -> Chunk:
        if self.dry_run or chunk.all_zero():
            return self._blank_output(chunk)
        orig_zyx = tuple(chunk.shape[-3:])
        run_zyx = self._run_shape(orig_zyx)
        grid = enumerate_patches(
            run_zyx,
            self.input_patch_size,
            self.output_patch_size,
            self.output_patch_overlap,
        )
        with torch.no_grad():
            arr = self._upload(chunk)
            if run_zyx != orig_zyx:
                # shape-bucket padding replicates the boundary plane so
                # the net sees plausible context instead of a zero wall
                arr = _edge_pad(arr, run_zyx)
            in_starts, out_starts, valid = pad_to_batch(grid, self.batch_size)
            out, weight = self._local_blend(
                arr,
                torch.from_numpy(in_starts),
                torch.from_numpy(out_starts),
                torch.from_numpy(valid).to(self.device),
            )
            result = normalize_blend(out, weight, self.output_dtype)
        return self._postprocess_result(result, chunk, orig_zyx, run_zyx)
