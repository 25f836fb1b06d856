"""Per-chunk patch inference on one CUDA device, serial or streamed.

The counterpart of ``chunkflow_tpu/inference/inferencer.py`` for the
single-device paths. Scatter: chunk -> patch grid -> raw upload -> per
batch (gather -> convnet forward -> bump-weighted accumulate) ->
reciprocal normalization -> myelin mask and margin crop; each batch runs
two hand-written CUDA kernels around the forward (``ops/gather.py``,
``ops/accumulate.py``). Fold (``blend="fold"`` or ``CHUNKFLOW_BLEND=fold``):
the chunk converted to float32, edge-padded to a uniform patch grid and
blended by parity class (``ops/fold_blend.py``). The JAX package runs
each as one compiled program; here it runs eagerly, and the result is
bitwise the JAX package's wherever the forward is (the identity engine),
because every step repeats its arithmetic in its order.

Streaming (:meth:`stage`, :meth:`infer_async`, :meth:`stream`) overlaps
the upload of chunk k+1 and the download of chunk k-1 with the compute of
chunk k. On CUDA each inferencer owns one upload and one download stream;
compute runs on the dispatching thread's current stream, which waits on
each staged chunk's copy event. Nothing on the dispatch path waits for
the device: the blank-input flag is computed on the host at staging
time, the validity column is built on the device, and the result's
download is started, not awaited.

The entry points run on the card (``device="cuda"``, the default) and
raise when there is none, unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain PyTorch versions run. Options of the JAX
``Inferencer`` that are not ported raise ``NotImplementedError`` naming
the ROADMAP item that ports them; none is ignored.
"""
from __future__ import annotations

import itertools
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType, _as_tensor
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.cartesian import Cartesian
from chunkflow_tpu_torch.core.dtypes import numpy_dtype, signed_view
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.inference.bump import bump_map
from chunkflow_tpu_torch.inference.patching import enumerate_patches, pad_to_batch
from chunkflow_tpu_torch.inference.precision import resolve_precision
from chunkflow_tpu_torch.ops import gather
from chunkflow_tpu_torch.ops.blend import (
    build_local_blend,
    normalize_blend,
    stack_budget_bytes,
)
from chunkflow_tpu_torch.ops.fold_blend import (
    build_fold_program,
    fold_grid,
    fold_pad_shape,
)


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


def _host_payload(chunk: Chunk):
    """The chunk's payload as it crosses to the device: RAW where the
    gather converts it (float32, ints up to 32 bits — a uint8 chunk rides
    at 1/4 the bytes of float32), else float32 converted exactly as the
    JAX package does (64-bit ints to float32 on the host, then one float32
    multiply by the int scale; other floats rounded to float32). A tensor
    payload stays where it lies; a caller's array is never written."""
    arr = chunk.array
    dt = numpy_dtype(arr.dtype)
    if isinstance(arr, np.ndarray):
        if dt is not None and not gather.raw_eligible(dt):
            arr = arr.astype(np.float32)
        arr = _as_tensor(arr)
    if dt is None or not gather.raw_eligible(dt):
        arr = arr.to(torch.float32)
        scale = gather.int_scale(dt) if dt is not None else None
        if scale is not None:
            # arr is a fresh float32 copy here (dt is not float32)
            arr = arr.mul_(float(scale))
    return arr


def _device_valid(valid: np.ndarray, device) -> torch.Tensor:
    """``pad_to_batch``'s validity column (ones, then zeros for the padding
    rows) built on the device, not copied there: a copy from pageable
    memory would wait for the device."""
    out = torch.ones(len(valid), dtype=torch.float32, device=device)
    n = int(np.count_nonzero(valid))
    if n < len(valid):
        out[n:] = 0.0
    return out


def resolve_blend(blend: str) -> str:
    """``scatter`` or ``fold``: ``auto`` reads ``CHUNKFLOW_BLEND`` (default
    scatter), as the JAX package does."""
    if blend == "auto":
        blend = os.environ.get("CHUNKFLOW_BLEND", "scatter").lower()
    if blend not in ("scatter", "fold"):
        raise ValueError(f"unknown blend mode {blend!r}")
    return blend


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
        self.blend_mode = resolve_blend(blend)
        if self.blend_mode == "fold" and sharding != "none":
            raise ValueError(
                f"blend='fold' applies to the single-device path only "
                f"(got sharding={sharding!r}); use blend='scatter' or "
                f"sharding='none'"
            )
        if sharding != "none" or mesh is not None:
            _not_ported("multi-device execution (sharding / mesh)",
                        "multi-GPU engine")
        self.precision = resolve_precision(precision)
        if self.precision != "float32":
            # never float32 where the JAX package would quantize
            _not_ported(f"the {self.precision} forward (precision= / "
                        f"CHUNKFLOW_PRECISION)", "precision ladder")
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
        self._bump = torch.tensor(bump_map(pout), device=self.device)
        self._local_blend = build_local_blend(
            self._forward,
            num_input_channels,
            num_output_channels,
            tuple(self.input_patch_size),
            pout,
            batch_size,
            self._bump,
        )
        # the streamed path's copy streams (compute stays on the caller's
        # current stream)
        self._h2d_stream = self._d2h_stream = None
        if self.device.type == "cuda":
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)

    # ------------------------------------------------------------------
    def _run_shape(self, zyx) -> tuple:
        """The shape actually executed for an incoming chunk shape: the
        bucket multiple (at least one input patch) when bucketing, then
        (fold mode) at least one input patch, so thin chunks run in fold
        and in its scatter fallback alike."""
        run = tuple(zyx)[-3:]
        if self.shape_bucket is not None:
            run = tuple((
                Cartesian.from_collection(run).ceildiv(self.shape_bucket)
                * self.shape_bucket
            ).maximum(self.input_patch_size))
        if self.blend_mode == "fold":
            run = tuple(max(length, p)
                        for length, p in zip(run, self.input_patch_size))
        return run

    def patch_grid_shape(self, chunk_shape) -> Tuple[int, int, int]:
        """Patches per axis for a chunk shape (the reference --patch-num
        contract), from the same grid the inference runs."""
        shape = self._run_shape(chunk_shape)
        if self._use_fold(shape):
            return self._fold_geometry(shape)[1]
        grid = enumerate_patches(
            shape,
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
    def _fold_geometry(self, zyx):
        """(padded shape, grid shape) of the fold path: the one place its
        geometry is derived."""
        pin = tuple(self.input_patch_size)
        stride = tuple(self.output_patch_size - self.output_patch_overlap)
        padded = fold_pad_shape(tuple(zyx), pin, stride)
        return padded, fold_grid(padded, pin, stride)

    def _use_fold(self, zyx) -> bool:
        """Fold applies when selected AND its stacks fit the byte budget
        (``CHUNKFLOW_BLEND_STACK_MAX_GB``); larger chunks fall back to
        the per-batch scatter path, as in the JAX package."""
        if self.blend_mode != "fold":
            return False
        padded, grid = self._fold_geometry(zyx)
        n = int(np.prod(grid))
        pin = tuple(self.input_patch_size)
        pout = tuple(self.output_patch_size)
        co = self.num_output_channels
        # per patch: the input stack, the prediction stack, its weighted
        # float32 copy and the weight stack
        per_patch = 4 * (self.num_input_channels * int(np.prod(pin))
                         + (2 * co + 1) * int(np.prod(pout)))
        # the accumulation buffers: two (co+1)-channel float32 volumes
        fixed = 8 * (co + 1) * int(np.prod(padded))
        return n * per_patch + fixed <= stack_budget_bytes()

    def _run_fold(self, arr: torch.Tensor) -> torch.Tensor:
        """Pad a float32 ``[ci, z, y, x]`` chunk to a uniform grid by
        replicating its high faces, fold it, crop back. Voxels within one
        patch of a padded face see edge-replicated context, which is why
        fold is opt-in."""
        zyx = tuple(arr.shape[-3:])
        padded, _ = self._fold_geometry(zyx)
        if padded != zyx:
            arr = _edge_pad(arr, padded)
        program = build_fold_program(
            self._forward,
            self.num_input_channels,
            self.num_output_channels,
            tuple(self.input_patch_size),
            tuple(self.output_patch_size),
            tuple(self.output_patch_size - self.output_patch_overlap),
            self.batch_size,
            self._bump,
            padded,
            out_dtype=self.output_dtype,
        )
        return program(arr)[:, :zyx[0], :zyx[1], :zyx[2]]

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

    def stream(self, chunks, postprocess=None, post_depth: int = 2,
               ring: int = 2, prefetch_depth: int = 2, adaptive=None):
        """Pipelined inference over an iterable of chunks; yields
        host-resident output chunks in input order, bitwise the serial
        path's.

        While chunk k computes, chunk k+1 is staged into a ``ring``-slot
        staging ring and chunk k-1's output downloads. ``postprocess``
        (``Chunk -> T``) runs in a worker thread, at most ``post_depth``
        in flight. By default the adaptive scheduler drives it
        (``flow/scheduler.py``: the iterable's own IO runs
        ``prefetch_depth`` items ahead in a producer thread, and the
        depths widen under telemetry-driven control); ``adaptive=False``
        or ``CHUNKFLOW_SCHED=static`` runs the static double-buffered
        executor (``flow/pipeline.py``) at the depths given."""
        from chunkflow_tpu_torch.flow import scheduler

        if adaptive is None:
            adaptive = scheduler.scheduler_mode() == "adaptive"
        if adaptive:
            return scheduler.schedule_chunks(
                self, chunks, ring=ring, postprocess=postprocess,
                post_depth=post_depth, prefetch_depth=prefetch_depth,
            )
        from chunkflow_tpu_torch.flow.pipeline import pipeline_chunks

        return pipeline_chunks(self, chunks, ring=ring,
                               postprocess=postprocess, post_depth=post_depth)

    def stage(self, chunk: Chunk) -> Chunk:
        """Start the chunk's upload and return the staged chunk: on CUDA
        a device payload whose copy rides the upload stream from pinned
        memory (narrow ints ride narrow; the gather converts them); on
        the CPU the host payload. The blank-input flag is computed here,
        on the host. A chunk already on the device is returned as it
        is."""
        if chunk.is_on_device:
            return chunk
        all_zero = chunk.all_zero()
        staged = chunk._with_array(_host_payload(chunk))
        if self.device.type == "cuda":
            staged = staged.device(self.device, stream=self._h2d_stream)
        staged._all_zero = all_zero
        return staged

    def infer_async(self, chunk: Chunk, crop=None,
                    consume: bool = False) -> Chunk:
        """Enqueue the whole chunk and start its result's download without
        waiting for the device; ``.host()`` materializes it later (in any
        thread). ``crop`` applies an explicit margin crop on the device
        before the download, so cropped voxels never cross. ``consume``
        declares the input a buffer the executor staged itself and will
        not touch again; the port never writes an input chunk, so a
        caller's device-resident chunk survives either way."""
        out = self._infer(chunk)
        if crop is not None:
            out = out.crop_margin(crop)
        if self.device.type == "cuda" and out.is_on_device:
            out = out.copy_to_host_async(self._d2h_stream)
        return out

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
        """The chunk on the device as ``[c, z, y, x]`` (see
        :func:`_host_payload`). A staged chunk's payload is used as it is,
        once the current stream has waited for its copy; any other host
        payload is copied here, synchronously."""
        chunk.await_upload()
        arr = _host_payload(chunk).to(self.device)
        if arr.dim() == 3:
            arr = arr[None]
        return arr.contiguous()

    def _infer(self, chunk: Chunk) -> Chunk:
        if self.dry_run or chunk.all_zero():
            return self._blank_output(chunk)
        orig_zyx = tuple(chunk.shape[-3:])
        run_zyx = self._run_shape(orig_zyx)
        use_fold = self._use_fold(run_zyx)
        if self.blend_mode == "fold" and not use_fold:
            # loud, not silent: this chunk's numbers belong to scatter
            print(
                f"fold blend gated off for shape {run_zyx}: patch stacks "
                f"exceed CHUNKFLOW_BLEND_STACK_MAX_GB; using per-batch "
                f"scatter fallback",
                file=sys.stderr,
            )
        with torch.no_grad():
            arr = self._upload(chunk)
            if use_fold:
                # fold contracts on float32 (the JAX package converts
                # before padding); conversion makes a new tensor for ints
                arr = gather.convert_chunk(arr)
            if run_zyx != orig_zyx:
                # shape-bucket padding replicates the boundary plane so
                # the net sees plausible context instead of a zero wall
                arr = _edge_pad(arr, run_zyx)
            if use_fold:
                result = self._run_fold(arr)
            else:
                grid = enumerate_patches(
                    run_zyx,
                    self.input_patch_size,
                    self.output_patch_size,
                    self.output_patch_overlap,
                )
                in_starts, out_starts, valid = pad_to_batch(
                    grid, self.batch_size)
                out, weight = self._local_blend(
                    arr,
                    torch.from_numpy(in_starts),
                    torch.from_numpy(out_starts),
                    _device_valid(valid, self.device),
                )
                result = normalize_blend(out, weight, self.output_dtype)
        telemetry.inc("inference/chunks")
        return self._postprocess_result(result, chunk, orig_zyx, run_zyx)
