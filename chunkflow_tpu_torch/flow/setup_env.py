"""Capacity planner: the chunk and block geometry of a production run.

The port's copy of ``chunkflow_tpu/flow/setup_env.py``. Given the convnet
patch geometry, a RAM budget and the mip pyramid wanted, search the patch
grid (``patch_num``) whose output chunk

- fits in half the RAM budget (float32, ``channel_num`` channels),
- divides by ``2**max_mip`` in xy after the crop margins (the pyramid
  tiles exactly), and by ``2**mip`` in z,

then derive the output and input chunk sizes, the expand margins and the
storage blocks, create the output and thumbnail volumes' info files, and
emit the task grid. It runs once, on the host, before the workers start.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from chunkflow_tpu_torch.core.bbox import BoundingBoxes

Triple = Tuple[int, int, int]


def _fmt(tp) -> str:
    return " ".join(str(int(i)) for i in tp)


@dataclass
class Plan:
    """The planner's output: every geometry parameter of a production run."""

    patch_num: Triple
    input_chunk_size: Triple
    output_chunk_size: Triple
    expand_margin_size: Triple
    block_size: Triple
    thumbnail_block_size: Triple
    factor: int
    voxel_utilization: float
    bboxes: Optional[BoundingBoxes] = field(default=None, repr=False)

    def print_parameters(self) -> None:
        print(f"--patch-num {_fmt(self.patch_num)}")
        print(f"--input-chunk-size {_fmt(self.input_chunk_size)}")
        print(f"--output-chunk-size {_fmt(self.output_chunk_size)}")
        print(f"--expand-margin-size {_fmt(self.expand_margin_size)}")
        print(f"block size {_fmt(self.block_size)}")
        print(f"thumbnail block size {_fmt(self.thumbnail_block_size)}")
        print(f"voxel utilization: {self.voxel_utilization:.2f}")


def get_optimized_block_size(
    output_patch_size: Triple,
    output_patch_overlap: Triple,
    max_ram_size: float,
    channel_num: int,
    max_mip: int,
    crop_chunk_margin: Triple,
    input_patch_size: Triple,
    mip: int,
    thumbnail_mip: int,
) -> Tuple[Triple, Triple, Triple, Triple, int]:
    """Brute-force the patch grid minimizing RAM-budget deviation subject to
    mip divisibility (reference setup_env.py:20-96).

    Returns (patch_num, output_chunk_size, input_chunk_size, block_size,
    factor).
    """
    assert mip >= 0
    assert output_patch_size[1] == output_patch_size[2], (
        "xy output patch must be square"
    )
    patch_stride = tuple(
        s - o for s, o in zip(output_patch_size, output_patch_overlap)
    )
    patch_voxel_num = int(np.prod(patch_stride))
    # half the RAM budget goes to the float32 output buffer
    ideal_total_patch_num = int(
        max_ram_size * 1e9 / 2 / 4 / channel_num / patch_voxel_num
    )
    patch_num_start = max(1, int(ideal_total_patch_num ** (1.0 / 3.0) / 2))
    patch_num_stop = patch_num_start * 3

    max_factor = 2 ** max_mip
    factor = 2 ** mip
    best_cost = sys.float_info.max
    patch_num: Optional[Triple] = None
    for pnxy in range(patch_num_start, patch_num_stop):
        if (
            pnxy * patch_stride[2]
            + output_patch_overlap[2]
            - 2 * crop_chunk_margin[2]
        ) % max_factor != 0:
            continue
        for pnz in range(patch_num_start, patch_num_stop):
            if (
                pnz * patch_stride[0]
                + output_patch_overlap[0]
                - 2 * crop_chunk_margin[0]
            ) % factor != 0:
                continue
            cost = (pnxy * pnxy * pnz / ideal_total_patch_num - 1) ** 2
            if cost < best_cost:
                best_cost = cost
                patch_num = (pnz, pnxy, pnxy)
    if patch_num is None:
        raise ValueError(
            "no feasible patch grid: relax max_mip / crop margins or raise "
            "the RAM budget"
        )

    output_chunk_size = tuple(
        n * s + o - 2 * c
        for n, s, o, c in zip(
            patch_num, patch_stride, output_patch_overlap, crop_chunk_margin
        )
    )
    input_chunk_size = tuple(
        ocs + 2 * ccm + ips - ops
        for ocs, ccm, ips, ops in zip(
            output_chunk_size, crop_chunk_margin,
            input_patch_size, output_patch_size,
        )
    )
    block_mip = (mip + thumbnail_mip) // 2
    block_factor = 2 ** block_mip
    block_size = (
        output_chunk_size[0] // factor,
        output_chunk_size[1] // block_factor,
        output_chunk_size[2] // block_factor,
    )
    return patch_num, output_chunk_size, input_chunk_size, block_size, factor


def setup_environment(
    dry_run: bool,
    volume_start: Triple,
    volume_stop: Optional[Triple],
    volume_size: Optional[Triple],
    volume_path: str,
    max_ram_size: float,
    output_patch_size: Triple,
    input_patch_size: Optional[Triple],
    channel_num: int,
    dtype: str,
    output_patch_overlap: Optional[Triple],
    crop_chunk_margin: Optional[Triple],
    mip: int,
    thumbnail_mip: int,
    max_mip: int,
    thumbnail: bool,
    encoding: str,
    voxel_size: Triple,
    overwrite_info: bool,
) -> Plan:
    """Plan a production run and (unless dry_run) create the volume info
    files. Returns the Plan including the task bbox grid."""
    assert volume_stop is not None or volume_size is not None
    volume_start = tuple(int(v) for v in volume_start)
    if volume_size is not None:
        volume_stop = tuple(s + z for s, z in zip(volume_start, volume_size))
    else:
        volume_size = tuple(e - s for s, e in zip(volume_start, volume_stop))

    if input_patch_size is None:
        input_patch_size = output_patch_size
    if output_patch_overlap is None:
        output_patch_overlap = tuple(s // 2 for s in output_patch_size)
    if crop_chunk_margin is None:
        crop_chunk_margin = output_patch_overlap
    if thumbnail:
        thumbnail_mip = max(thumbnail_mip, 5)

    (
        patch_num, output_chunk_size, input_chunk_size, block_size, factor
    ) = get_optimized_block_size(
        output_patch_size, output_patch_overlap, max_ram_size,
        channel_num, max_mip, crop_chunk_margin,
        input_patch_size, mip, thumbnail_mip,
    )
    expand_margin_size = tuple(
        (ics - ocs) // 2
        for ics, ocs in zip(input_chunk_size, output_chunk_size)
    )
    thumbnail_factor = 2 ** thumbnail_mip
    thumbnail_block_size = (
        output_chunk_size[0] // factor,
        max(1, output_chunk_size[1] // thumbnail_factor),
        max(1, output_chunk_size[2] // thumbnail_factor),
    )
    voxel_utilization = float(
        np.prod(output_chunk_size)
        / np.prod(patch_num)
        / np.prod(output_patch_size)
    )

    if not dry_run:
        from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

        exists = PrecomputedVolume(volume_path).kv.read_bytes("info") \
            is not None
        if not overwrite_info and not exists:
            raise FileNotFoundError(
                f"no existing info at {volume_path}; pass --overwrite-info "
                "to create it"
            )
        if overwrite_info:
            PrecomputedVolume.create(
                volume_path,
                volume_size=volume_size,
                voxel_size=voxel_size,
                voxel_offset=volume_start,
                num_channels=channel_num,
                dtype=dtype,
                layer_type="image",
                block_size=block_size,
                num_mips=mip + 1,
                encoding=encoding,
            )
            if thumbnail:
                PrecomputedVolume.create(
                    os.path.join(volume_path, "thumbnail"),
                    volume_size=volume_size,
                    voxel_size=voxel_size,
                    voxel_offset=volume_start,
                    num_channels=1,
                    dtype="uint8",
                    layer_type="image",
                    block_size=thumbnail_block_size,
                    num_mips=thumbnail_mip + 1,
                    encoding="raw",
                )

    # the task grid lives at the processing mip: z full-res, xy / factor
    roi_start = (
        volume_start[0], volume_start[1] // factor, volume_start[2] // factor
    )
    roi_size = (
        volume_size[0], volume_size[1] // factor, volume_size[2] // factor
    )
    roi_stop = tuple(s + z for s, z in zip(roi_start, roi_size))
    bboxes = BoundingBoxes.from_manual_setup(
        chunk_size=output_chunk_size,
        roi_start=roi_start,
        roi_stop=roi_stop,
    )

    plan = Plan(
        patch_num=patch_num,
        input_chunk_size=input_chunk_size,
        output_chunk_size=output_chunk_size,
        expand_margin_size=expand_margin_size,
        block_size=block_size,
        thumbnail_block_size=thumbnail_block_size,
        factor=factor,
        voxel_utilization=voxel_utilization,
        bboxes=bboxes,
    )
    plan.print_parameters()
    print(f"total number of tasks: {len(bboxes)}")
    return plan
