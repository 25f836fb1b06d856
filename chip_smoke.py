#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit and no result line:

1. card      device name and count, ``nvidia-smi`` name and power limit
2. build     the CUDA kernels from ``chunkflow_tpu_torch/csrc/``, timed
3. kernels   each kernel against its plain PyTorch version on the card,
             bitwise, at the main path's shapes and on small fixtures
             (every gather dtype at unaligned starts, and a sweep of x
             starts mod 16, px % 4 != 0, two channels and a storage-offset
             view, and rows wider than the gather's shared-memory tile;
             both accumulate flavours on dense overlap with
             validity-0 rows); the gather's registers, shared memory and
             resident blocks; per-launch time, bound and plain-version
             time at the main path's shapes, and the gather's on uint16,
             float32 and unaligned starts
4. identity  ``Inferencer(framework="identity")`` on a 64x512x512 uint8
             chunk (20x256x256 patches, 4x64x64 overlap, 3 channels,
             batch 2) and on a ragged uint16 chunk with an odd patch
             count: kernel path == plain path bitwise, identity oracle
5. unet3d    the full-width parity UNet3D (28, 36, 48, 64), float32 under
             the engine's own flags (TF32 off, deterministic cuDNN; the
             process keeps PyTorch's defaults), on the same chunk: kernel
             path == plain path bitwise, one 8x64x64 patch GPU vs CPU
             within 1e-4 (and the unscoped TF32 forward's gap, printed),
             wall time, Mvox/s and peak memory
6. cli       ``create-chunk ... inference -f identity ... save-npy``
             through the port's CLI, equal to phase 4's result
7. models    every convnet family at full width (parity UNet3D, RSUNet
             through a reference ``model.py`` and a BatchNorm ``.pt``
             checkpoint, the ``tpu`` and ``tpu_s2d4`` flagships; ``tpu_mxu``,
             ``tpu``'s weights with the mxu layers, runs in phase 13), float32 (TF32 off) and bfloat16, on the
             same chunk: kernel path == plain path bitwise, sigmoid maps,
             float32 one 8x64x64 patch GPU vs CPU within 1e-4, bfloat16 vs
             float32 on that patch within 0.02 max-abs and 0.005 mean-abs,
             and on four 8x64x64 crops of the chunk and on the chunk
             within 0.005 mean-abs, wall time, Mvox/s, peak memory,
             forward device time per batch and TFLOP/s
8. stream    six distinct seeded 64x512x512 uint8 chunks through
             ``Inferencer.stream`` (adaptive and static) and the CLI's
             ``inference --async-depth 3`` stage, for ``tpu_s2d4`` in
             bfloat16 and the parity UNet3D in float32: bitwise the serial
             loop, 18 + 18 launches per chunk, the dispatch path (``stage``
             + ``infer_async``) clean under ``torch.cuda``'s sync debug
             mode "error", and at least one download overlapping the next
             chunk's kernels in the device trace; serial and streamed
             s/chunk, Mvox/s, copy overlap and compute idle shares, peak
             memory
9. fold      ``blend="fold"``: the identity engine on the card bitwise the
             CPU port on the 64x512x512 chunk (no kernel launched); the
             parity UNet3D in float32, wall time, Mvox/s and peak memory;
             fold within 1e-5 of scatter on a uniform 68x640x640 chunk,
             where their patch grids coincide
10. volume   the queue-fed worker on local disk: a seeded 128x1024x1024
             uint8 volume written by the port, an output volume and a
             file:// queue of 8 tasks of 56x384x384 (each read as
             64x512x512); ``python -m chunkflow_tpu_torch
             fetch-task-from-queue | load-precomputed | inference |
             save-precomputed --async-write | delete-task-in-queue`` in
             three worker processes (faults raised in the first, the
             second SIGKILLed at its first commit, the third drains):
             the output volume == an in-process reference bitwise, each
             task acked once, the queue empty, the ledger full, 18 + 18
             launches per computed task; then the parity UNet3D (float32)
             and ``tpu_s2d4`` (bfloat16, into a uint8 volume) fault-free
             in process: bitwise, s/task and Mvox/s from disk against
             phase 8's in-memory stream, host ms to cut out, save and
             ack, and the compute idle share from a profiler trace
11. chain    the README's production worker chain in process, on phase
             10's input volume: ``fetch-task-from-queue | load-precomputed
             | prefetch | normalize-contrast | inference`` (``tpu`` at full
             width in bfloat16, flax-layout weights) ``| crop-margin | mask
             | save-precomputed --async-write | delete-task-in-queue``, 8
             tasks of 56x384x384 (input 64x512x512), a 1x16x16-coarser mask
             volume with a zeroed block and task starts off its grid: 18 +
             18 launches per task, the volume bitwise the same chain
             composed from the library calls, each task acked once;
             s/task, Mvox/s, host ms of each operator span, compute idle;
             every operator's card leg bitwise its CPU leg on a task's
             full-size affinity map (and normalize-contrast on its input);
             the identity engine through the chain on the card bitwise the
             CPU port
12. segment  file formats and segmentation legs through the CLI, on the
             card: the README's quick start (``load-h5 | inference``
             ``tpu`` bfloat16 batch 4 ``| save-h5``; without h5py through
             ``load-npy``/``save-npy``) on the 64x512x512 chunk, the file
             bitwise ``Inferencer.__call__``, 9 + 9 launches; its channel 0
             through ``connected-components -t T --device`` and
             ``--host`` and ``downsample`` (the card labels the device
             leg's fixpoint bitwise, the host labels isomorphic, the mode
             pool's card leg its CPU leg), sweeps, ms per leg and the host
             build time; ``gaussian-filter``, ``downsample-upload``,
             ``load-precomputed --validate-mip 2`` and ``save-precomputed
             --create-thumbnail`` on phase 10's volume, every mip bitwise
             the library composition; h5, tif, png, nrrd, mrc and zarr
             round trips at task size from card and host chunks, MB/s
13. precision the precision ladder at full width on the chunk cut to its
             first 20 planes (20x512x512: one patch plane, 9 patches):
             every family (parity, rsunet, tpu, tpu_mxu, tpu_s2d4) on a
             float32 engine at float32, bfloat16 and int8 ``fake``,
             ``fakeint`` and ``real`` (``CHUNKFLOW_INT8``), and ``tpu`` on a
             bfloat16 engine at int8 ``real``: s/chunk, Mvox/s, forward
             device ms per batch, the int8 kernel's and the quantize
             pass's share of the real forward, max-abs and mean-abs
             against the family's float32 (bf16: mean held <= 0.005);
             int8 ``fake`` (max 1e-4) and ``real`` (mean 0.01) against
             the CPU port at the same leg on a crop of the chunk;
             ``real`` bitwise ``fakeint`` where the largest |sum|
             (printed) stays below 2^24; one batch per family, the real
             forward through the kernel bitwise the same forward through
             the plain version (float64 on the card); the kernel bitwise
             its plain version on every shape class (and its weight
             pack its plain version); int8 launches > 0 under ``real``,
             0 under ``fake``, by path (Hopper, generic); the Hopper
             kernel's time against the generic kernel in turns, the
             op's time, the bound, the plain time and cuDNN's float32
             time on the integer grid at the parity enc0 shape and
             ``tpu_s2d4``'s widest, and the same table (but the plain
             time) at every layer shape of the parity and ``tpu_s2d4``
             real forwards
14. packer    the PatchPacker: 12 requests of mixed sizes (one 20x256x256
             patch to 64x512x512) from 4 submitter threads, ``tpu`` bf16
             at batch 4, at float32 and at int8 ``real``: every result
             bitwise its own ``Inferencer.__call__``, pre-weighted
             accumulate launches > 0, occupancy, batches and filler
             slots, requests/s and Mvox/s packed and one by one
15. serve    the serving front end on a real HTTP listener in process
             (``ServingService`` + ``LocalBackend`` + ``start_serving``):
             the full-width parity UNet3D (flax-layout seeded weights,
             ``-f flax``, batch 4) on a float32 engine, at float32 and
             at ``CHUNKFLOW_PRECISION=int8 CHUNKFLOW_INT8=real``; phase
             14's 12 requests, uint8 on the wire, from 4 threads of a
             client process (a remote user's: its JSON and base64 work
             do not share the server's interpreter): every decoded
             response bitwise its ``Inferencer.__call__`` (SHA-256),
             gather and pre-weighted accumulate launches > 0 in both legs,
             ``conv3d_int8`` > 0 only under ``real``; a burst past the
             in-flight bound gets 429 ``inflight``, a 0.001 s deadline a
             504; ``/metrics`` parses and carries ``serving/latency``,
             ``/healthz``, ``/serving`` and ``/alerts`` (an SLO config)
             answer; ``POST /profile?seconds=1`` under load writes a trace
             naming both kernels; requests/s and Mvox/s over HTTP against
             the in-process packer and one by one, client and
             ``serving/latency`` p50/p99, host ms per request to decode,
             encode and compute, batches, filler slots, occupancy. Then
             ``python -m chunkflow_tpu_torch -v serve --port 0 ...`` as a
             subprocess: its bound port, one request answered bitwise, a
             drain on SIGTERM with its ``serve drained:`` line and run
             counters
16. segment-plane  the segmentation plane on channel 0 of phase 10's
             parity output over its roi (112x768x768, kept as ``.npy``),
             thresholded at its 70% quantile: ``segment-volume --device``
             and ``--host`` (56x384x384 chunks, ``-w 4``) through the CLI
             in process, label-isomorphic to each other and to one
             monolithic host labelling, each card chunk the device leg's
             fixpoint; the queue mode on its first 56 slices (a
             coordinator and two workers, one SIGKILLed at
             ``segment/merge``): isomorphic, the queue empty, the ledger
             full; ``mesh --manifest``, ``mesh-manifest`` and
             ``download-mesh`` on the largest objects of two chunks: every
             fragment listed exists, every mesh closed, the ply the sum of
             its fragments; wall s, Mvox/s, ms per stage, sweeps
17. encodings  phase 10's input re-encoded as jpeg (64³ blocks; bytes,
             ratio, encode MB/s); phase 10's worker (parity float32) in
             two subprocesses from the jpeg volume into a sharded raw
             float32 volume (every shard holding chunks of several
             tasks): bitwise the in-process reference on the port's own
             decoded cutouts, 18 + 18 launches per computed task, each
             task acked once, the queue empty; the same chain in process
             (s/task, Mvox/s beside phase 10's from raw, host ms decoding);
             phase 16's segmentation into a sharded
             compressed_segmentation volume (64³ chunks, 8³ blocks,
             murmurhash3, gzip) read back bitwise, MB/s of the host C++
             codec and its numpy plain version; a uint16 png and an rgb
             jpeg volume round-tripped; whether this machine's Pillow
             writes and reads ``tests/data/jpeg_blocks.npz``'s jpeg bytes
             as tensorstore did
18. fleet    ``python -m chunkflow_tpu_torch fleet-run`` (1 to 3 worker
             processes on the card) drains phase 10's 8 tasks with its
             worker (parity float32, visibility timeout 120 s) while the
             phase SIGKILLs a worker holding leases: the output volume
             bitwise ``Inferencer.__call__`` on each cutout, each trace
             committed once (the killed worker's by another worker within
             half the visibility timeout), the queue empty, the ledger
             full, a scale-up, the killed worker reaped, a lease
             force-released, every other worker 18 + 18 launches per
             computed task; ``fleet-status`` during the run,
             ``log-summary --fleet --trace-id`` and ``--export-trace`` on
             the events; wall time and tasks/s beside phase 10's, workers
             over time, kill-to-recommit seconds, per worker its commits,
             dominant stall, host RSS and device peak, the cold start
19. annotations  a synapse-detection worker through the CLI in process
             on phase 10's first task box: ``load-precomputed |
             inference`` (parity float32, 18 + 18 launches) ``| plugin
             detect_pre_synapses`` (channel 0) ``| detect_post_synapses``
             (channel 1, 50 nm) ``| adjust_pre |`` phase 16's
             segmentation ``| detect_duplicate_post | find_tbar_object |
             save-synapses | save-points | load-synapses``: the files read
             back equal, the synapses bitwise the same plugins on a
             ``.host()`` copy of the inference output, T-bars and posts
             found; counts, ms per operator, s/task beside phase 10's.
             Then ``plugin skeletonize`` on two adjacent crops of the
             segmentation, ``aggregate-skeleton-fragments``, ``save-swc``
             and ``load-skeleton``: the aggregated objects the fragments'
             ids, each one tree, each swc read back equal; the cuts,
             objects, nodes, ms per object, cable length
20. cloud    phase 10's worker on the cloud plane, against local fakes of
             GCS, S3, SQS and CloudWatch in a process of their own (SigV4
             checked,
             GCS bearer tokens from a service account's RS256 JWT, 1%
             seeded 503s): phase 10's input copied to
             ``gs://chunkflow-in/img`` (MB/s), phase 17's sharded raw
             float32 output at ``s3://chunkflow-out/aff`` (one shared
             shard answered once with a forced 412), the 8 tasks on
             ``sqs://tasks`` (visibility 8 s, long polls capped at 4
             s by the fake); two worker processes
             (parity float32), one SIGKILLed at its first commit: the
             output volume bitwise ``Inferencer.__call__`` on each cutout,
             each task acked once, the queue and ``tasks-dead`` empty, 18 +
             18 launches per computed task, a 412 on a shared shard; then
             the chain in process: bitwise, s/task and Mvox/s beside phase
             10's, requests by verb per task, bytes, retries, 412s, host
             ms in ``storage/read``, ``storage/write``,
             ``lifecycle/commit``, the drain's wall with the workers' last
             long polls; that run's telemetry snapshot published through
             the ``aws/cloud_watch`` plugin to the CloudWatch fake
             (batches of at most 20, the MetricData count)
21. checkpoints  the committed orbax checkpoint of the seeded parity
             UNet3D (``tests/data/orbax_parity_seed0``: OCDBT, zstd zarr
             v2 arrays) into the full-width parity engine, its weights
             bitwise the seeded tree; one 64x512x512 chunk through ``load-
             npy | inference -f flax -w <dir> | save-npy`` (parity float32,
             batch 2): bitwise ``Inferencer.__call__``, the kernel path
             bitwise the plain path, 18 + 18 launches; the load's ms
             split into OCDBT, zstd and convert; the host C++ zstd and
             blosc decoders' MB/s beside their plain versions' (the
             checkpoint's largest chunk, the committed blosc store
             ``tests/data/blosc_zarr``)
22. mesh     the mesh engine in one process, its shards on this card
             repeated (N shards on one card measure the engine's
             overhead, not multi-GPU scaling), on the 64x512x512 chunk:
             identity at ``data=4``, ``y=4``, ``y=2,x=2`` and
             ``pipeline=4`` and ``y=2,x=2`` under
             ``CHUNKFLOW_SHARD_REPLAY=replicated``; the full-width parity
             UNet3D (phase 5's weights) in float32 at ``data=4`` and
             ``y=2,x=2``; ``tpu_s2d4`` in bfloat16 at ``data=2``: each
             bitwise ``Inferencer.__call__`` on one device, the dispatch
             under ``torch.cuda``'s sync debug mode "error", the gather
             and accumulate launched; identity ``y=2,x=2`` through the
             plain path too, bitwise; the packer under ``data=2`` (four
             requests, parity float32), each bitwise its one-device call;
             s/chunk beside one device, launches, the ``shard/*`` byte
             counters, the padded extents, peak memory beside the
             analytic replay buffers

23. multihost the multi-process engine (``parallel/multihost.py``): two
             rank processes in a gloo world on ``cuda:0`` (ranks sharing a
             card: the backend rule picks gloo): bring-up, the store
             allgather, the broadcast with its sentinel over collectives
             and over the store, the consistency guard on a permuted chunk
             (both transports); the full-width parity UNet3D (phase 5's
             weights) on the 64x512x512 chunk through the psum recipe
             (``sharded_inference_global``, twice, and
             ``Inferencer(sharding="patch")``), within 1e-5 of one
             device's ``Inferencer.__call__``, each rank's gather and
             accumulate launches equal to its share of the padded plan;
             with ``CHUNKFLOW_MULTIHOST_COLLECTIVES=0`` bitwise one
             device; the all-reduce alone; the CLI task loop over two of
             phase 10's tasks (``fetch-task-from-queue | load-precomputed |
             inference -f identity --sharding patch | save-precomputed |
             delete-task-in-queue``): the coordinator alone writes and
             acks, each task once, the volume within 2e-6 of the same
             chain in this process. With two cards or more, an NCCL world
             of min(4, cards) ranks, a card each, on the same chunk.
             s/chunk beside one device's, the all-reduce's ms and bytes
             (``shard/gather_bytes``), each rank's start-up and launches
24. tooling  the checking tools: (a) the shape contracts' microseconds
             per call on card tensors (the accumulate's specs, under
             ``torch.cuda``'s sync debug mode "error", and with
             ``CHUNKFLOW_CONTRACTS=0``), and a float32 starts table on the
             card refused with ``ContractError`` before any launch, the
             buffers untouched; (b) a fresh subprocess that installs the
             lock-order sanitizer (``CHUNKFLOW_LOCKSMITH=1``, raise mode)
             before importing the port, then runs phase 8's adaptive
             stream (``tpu_s2d4`` bfloat16, three chunks, bitwise the
             serial loop) and phase 14's packer fed by four threads (its
             12 requests, bitwise each one-by-one call) on ``cuda:0``: its
             locks, acquires, edges and violations (none allowed); (c) the
             program cost ledger of this process over the parity UNet3D
             main path (18 + 18 launches per chunk), fold, the packer and
             a ``data=2`` mesh on this card repeated: per family calls,
             compile s, exec ms, GFLOP, MB, roofline ms, util and lost s
             against the H100 row; the ``scatter`` FLOPs equal to the
             layers' (``conv_flops``) plus the kernels'; its dispatch wall
             beside the device-synchronized s/chunk of the same calls

The script prints the seconds of each phase and its total. Launch counts are read from each kernel wrapper's counter, set to 0 just
before a main path runs and read just after. The line before the last is
one JSON object with every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# the main path's configuration (bench.py's headline shape)
CHUNK = (64, 512, 512)
PIN = (20, 256, 256)
OVERLAP = (4, 64, 64)
CHANNELS = 3
BATCH = 2
RAGGED = (40, 456, 456)  # 3 x 3 x 3 = 27 patches: one validity-0 row
GATHER_DTYPES = ("uint8", "int8", "uint16", "int16", "int32", "uint32",
                 "float32")

# the H100 SXM's published peaks (NVIDIA data sheet): device memory
# bytes/s and float32 operations/s outside the tensor cores; the bounds
# hold only for the card that reports this name
H100_SXM = "H100 80GB HBM3"
PEAK_BW, PEAK_F32 = 3.35e12, 67e12
# dense bf16 tensor-core operations/s (the same data sheet)
PEAK_BF16 = 989e12

# the convnet families of phase 7, each in both compute dtypes
FAMILIES = ("parity", "rsunet", "tpu", "tpu_s2d4")
# the JAX package's bf16 gates, max-abs and mean-abs vs float32
# (tests/inference/test_precision.py), measured there on ~46 K outputs:
# held here on one 8x64x64 patch (98 K outputs); on the 50 M outputs of a
# chunk the mean is held and the max, the tail of bf16 rounding, printed
BF16_MAX, BF16_MEAN = 0.02, 0.005
# (z, y, x) starts of four 8x64x64 crops of the chunk, on which phase 7
# prints each family's bf16 gap; tests/test_torch_models.py reads the
# JAX package's own gap on the same crops with the same weights
BF16_CROPS = ((0, 0, 0), (0, 192, 192), (16, 64, 320), (40, 384, 96))
CROP = (8, 64, 64)
# phase 8: distinct seeded chunks streamed per family (3 since phase 24
# was added: its time is paid for here); the family whose host-side
# share is the largest, and the parity UNet3D
STREAM_K = 3
STREAM_FAMILIES = (("tpu_s2d4", "bfloat16"), ("parity", "float32"))
# phase 9: a chunk on which the fold and scatter patch grids coincide
UNIFORM = (68, 640, 640)
# phase 10: the worker loop on local disk. The input volume, the output
# volume's roi (start, size), the task, the margin (load-precomputed -e and
# inference --output-crop-margin: each task's input is CHUNK), the output
# blocks (anchored at the roi: every save is block-aligned); each family
# with its compute dtype and its output volume's dtype
VOLUME = (128, 1024, 1024)
VOLUME_BLOCK = (64, 128, 128)
VOXEL_NM = (40, 4, 4)
ROI = ((4, 64, 64), (112, 768, 768))
TASK = (56, 384, 384)
MARGIN = (4, 64, 64)
OUT_BLOCK = (8, 128, 128)
VOLUME_FAMILIES = (("parity", "float32", "float32"),
                   ("tpu_s2d4", "bfloat16", "uint8"))
# phase 16: channel 0 of phase 10's parity output over its roi, kept for
# the segmentation plane; the z slices of its queue mode (half the roi:
# 4 chunks), the workers' visibility timeout (s) and the meshed objects
SEGMENT_INPUT = OUT_DIR / "segment_input.npy"
SEGMENT_QUEUE_Z = 56
SEGMENT_VISIBILITY_S = 4
SEGMENT_MESH_IDS = 16
# phase 17: the stitched segmentation phase 16 keeps; the jpeg-fed
# workers' sharded raw float32 output (murmurhash3 over 64 shards of ~8
# chunks of OUT_BLOCK: every shard holds chunks of 2 or more of the 8
# tasks, which the phase checks); the segmentation's sharded
# compressed_segmentation volume as igneous writes one (64³ chunks, 8³
# blocks, murmurhash3, gzip minishard index and data; 8 shards); the size
# of the png and rgb jpeg round trips; the workers' time limit (s)
SEGMENT_SEG = OUT_DIR / "segmentation.npy"
SHARD_OUT = {"@type": "neuroglancer_uint64_sharded_v1", "preshift_bits": 0,
             "hash": "murmurhash3_x86_128", "minishard_bits": 2,
             "shard_bits": 6, "minishard_index_encoding": "gzip",
             "data_encoding": "raw"}
SHARD_SEG = {"@type": "neuroglancer_uint64_sharded_v1", "preshift_bits": 0,
             "hash": "murmurhash3_x86_128", "minishard_bits": 3,
             "shard_bits": 3, "minishard_index_encoding": "gzip",
             "data_encoding": "gzip"}
SEG_CHUNK = (64, 64, 64)
SEG_BLOCK = (8, 8, 8)
ENCODED_SMALL = (64, 512, 512)
ENCODED_WORKER_S = 300
# phase 18: the fleet supervisor over phase 10's volume and worker: its
# size bounds, the workers' visibility timeout (s: long, so only a
# force-release brings a killed worker's task back soon) and the run's
# time limit (s)
FLEET_WORKERS = (1, 3)
FLEET_VISIBILITY_S = 120
FLEET_RUNTIME_S = 300
# fleet-run's default --term-grace (s): a SIGTERMed worker exits by then
TERM_GRACE_S = 10.0
# the host memory (GiB) a scale-up must leave free: a worker process on
# the card holds 5-7 GiB of host RSS
FLEET_HOST_FLOOR_GB = 16
# phase 19: the synapse worker's post-synapse search radius (nm); the
# skeletons' two adjacent crops of phase 16's segmentation (the halves of
# the synapse task's box), the voxels an object needs to be skeletonized
# (there the percolating object is the only one of 20 or more: the rest
# is dust of a few voxels, each skeletonized too) and the paths each
# skeleton may take (the percolating object would take thousands: ~6 s a
# crop for 200)
SYNAPSE_RADIUS_NM = 50
SKELETON_CROP = (56, 384, 192)
SKELETON_VOXELS = 2
SKELETON_PATHS = 200
# phase 20: the cloud fakes' seeded share of 503s, the queue's visibility
# timeout (s) and the workers' time limit (s)
CLOUD_FAIL_RATE = 0.01
CLOUD_VISIBILITY_S = 8
# the fake's cap on an SQS long poll: a worker with -r 0 ends at its first
# empty receive, which real SQS holds for 20 s
CLOUD_LONG_POLL_S = 4
CLOUD_WORKER_S = 300
# the namespace phase 20 publishes its telemetry snapshot under
CLOUD_WATCH_NAMESPACE = "chunkflow-smoke"
# phase 22: the mesh engine on the card repeated: each family's
# inferencer keywords, its runs (family, CHUNKFLOW_MESH,
# CHUNKFLOW_SHARD_REPLAY), the run also taken through the plain path, and
# the packer's family, mesh and requests
MESH_RUNS = (("identity", "data=4", "sharded"),
             ("identity", "y=4", "sharded"),
             ("identity", "y=2,x=2", "sharded"),
             ("identity", "pipeline=4", "sharded"),
             ("identity", "y=2,x=2", "replicated"),
             ("parity float32", "data=4", "sharded"),
             ("parity float32", "y=2,x=2", "sharded"),
             ("tpu_s2d4 bfloat16", "data=2", "sharded"))
MESH_PLAIN_RUN = ("identity", "y=2,x=2", "sharded")
# phase 23: the psum recipe's tolerance against one device (the port's
# float32 forward's, as for the UNet3D against XLA) and the identity
# chain's (the JAX cross-topology gate); the chain's input volume, which
# holds two of phase 10's tasks (x 64..832 with their margins), and its
# roi; the seconds a world may take
MULTIHOST_TOL = 1e-5
MULTIHOST_CLI_TOL = 2e-6
MULTIHOST_VOLUME = (64, 512, 896)
MULTIHOST_ROI = ((4, 64, 64), (56, 384, 768))
MULTIHOST_WORLD_S = 600
MESH_PACK = ("parity float32", "data=2")
MESH_PACK_SHAPES = ((20, 256, 256), (20, 256, 448), (36, 256, 256),
                    (64, 512, 512))
# phase 11: the README's worker chain on phase 10's input volume; its
# roi starts off the mask's grid (y 72, x 68: not multiples of 16); the
# mask volume's voxels are 1 x 16 x 16 of the image's
# phase 21: the committed orbax checkpoint of the seeded parity UNet3D
# and blosc store (tests/test_torch_orbax.py, tests/test_torch_blosc.py)
CHECKPOINT = ROOT / "tests" / "data" / "orbax_parity_seed0"
# and its use_zarr3 twin: each leaf a sharding_indexed zarr v3 array
CHECKPOINT_ZARR3 = ROOT / "tests" / "data" / "orbax_parity_seed0_zarr3"
# phase 25: the committed sharded zarr v3 store (tensorstore's, written by
# tests/test_torch_zarr3.py from SHARDED_SEED): shards of SHARDED_SHARD,
# zstd inner chunks of SHARDED_INNER, a crc32c index at the shard's end;
# SHARDED_HOLES, one whole shard and one inner chunk, were never written
SHARDED_STORE = ROOT / "tests" / "data" / "sharded_zarr3"
SHARDED_SEED = 20
SHARDED_SHAPE = (16, 64, 64)
SHARDED_SHARD = (8, 32, 32)
SHARDED_INNER = (4, 16, 16)
SHARDED_HOLES = (((8, 16), (32, 64), (0, 32)), ((0, 4), (0, 16), (16, 32)))
# phase 25: CLAHE on the seeded chunk and a ragged crop of it: (shape,
# grid, clip limit); the first is the CLI chain's
CLAHE_CASES = (((64, 512, 512), 8, 2.0), ((61, 509, 503), 16, 0.0))
CLAHE_REPS = 5
CLAHE_SEED = 25
BLOSC_STORE = ROOT / "tests" / "data" / "blosc_zarr"
CODEC_REPS = 5
# a volume worker's task (zyx) as one blosc frame
BLOSC_TASK = (56, 384, 384)
# phase 21's CLI legs: the parity output (its channels stacked in z) saved
# into a store of each compressor, its .zarray as tensorstore writes it
# (tensorstore's default blosc: lz4); the store's chunks (zyx)
SAVE_STORES = (("zstd", {"id": "zstd", "level": 1}),
               ("blosc-lz4", {"blocksize": 0, "clevel": 5, "cname": "lz4",
                              "id": "blosc", "shuffle": -1}))
SAVE_CHUNKS = (64, 256, 256)
# phase 21's created store: save-zarr of the stacked parity output into a
# path with no store; the .zarray tensorstore 0.1.80 creates for that
# shape and dtype (tests/test_torch_zarr_writes.py holds it equal)
CREATED_STORE = (3 * CHUNK[0], CHUNK[1], CHUNK[2])
CREATED_ZARRAY = (
    '{"chunks":[101,101,101],"compressor":{"blocksize":0,"clevel":5,'
    '"cname":"lz4","id":"blosc","shuffle":-1},"dimension_separator":".",'
    '"dtype":"<f4","fill_value":null,"filters":null,"order":"C",'
    '"shape":[192,512,512],"zarr_format":2}')
# phase 21's encoder legs on the task-sized frame: (cname, shuffle)
TASK_ENCODERS = (("lz4", 1), ("lz4", 2), ("lz4hc", 1), ("blosclz", -1),
                 ("snappy", -1))
# a czyx chunk as a zyx one, its channels stacked in z (save-zarr writes
# zyx chunks, in both packages)
STACK_PLUGIN = '''from chunkflow_tpu_torch import Chunk


def execute(chunk):
    """The channels of a czyx chunk stacked in z."""
    array = chunk.array
    return Chunk(array.reshape((-1,) + tuple(array.shape[-2:])),
                 voxel_offset=chunk.voxel_offset,
                 voxel_size=chunk.voxel_size)
'''
CHAIN_ROI = ((4, 72, 68), (112, 768, 768))
MASK_FACTOR = (1, 16, 16)
# phase 12: the README's quick start runs batch 4
QUICK_BATCH = 4
# the workers' visibility timeout (s): a SIGKILLed worker's claims come
# back after it; the lease heartbeat keeps a live worker's claims
VISIBILITY_S = 10
# phase 13: the precision ladder's runs, each (precision, CHUNKFLOW_INT8
# leg) on a float32 engine; the JAX package's max-abs / mean-abs gates
# (tests/inference/test_precision.py), held for bf16 against float32 on
# the chunk (mean) and for int8 real between the card and the CPU port
# on a crop of it (mean; at full width the JAX package's own int8 gap to
# float32 exceeds them: tests/test_torch_precision.py); the int8 tensor-core
# peak (TOP/s, the H100 SXM data sheet); the largest |sum| float32 adds
# exactly
PRECISION_FAMILIES = ("parity", "rsunet", "tpu", "tpu_mxu", "tpu_s2d4")
# the legs run on the chunk's first PRECISION_DEPTH planes (one patch
# plane: 9 patches, where the whole chunk has 36), which pays for phase 23
PRECISION_DEPTH = 20
PRECISION_LEGS = (("float32", None), ("bfloat16", None), ("int8", "fake"),
                  ("int8", "fakeint"), ("int8", "real"))
PRECISION_GATES = {"bfloat16": (0.02, 0.005), "int8": (0.05, 0.01)}
# the fake leg's card vs the CPU port: a float forward's tolerance (phase
# 7's GPU vs CPU)
FAKE_CARD_CPU = 1e-4
PEAK_INT8 = 1979e12
EXACT_F32_SUM = 2 ** 24
# the int8 kernel's shape classes: (x [B, C, D, H, W], w [N, C, k...],
# stride, padding, dilation), from the five families' layers
INT8_CLASSES = (
    ((2, 28, 20, 64, 64), (28, 28, 3, 3, 3), 1, 1, 1),
    ((2, 36, 10, 32, 32), (36, 36, 1, 3, 3), 1, (0, 1, 1), 1),
    ((2, 1, 20, 256, 256), (28, 1, 1, 5, 5), 1, (0, 2, 2), 1),
    ((2, 4, 20, 128, 128), (56, 4, 1, 5, 5), 1, (0, 2, 2), 1),
    ((2, 16, 20, 64, 64), (112, 16, 1, 5, 5), 1, (0, 2, 2), 1),
    ((2, 28, 20, 64, 64), (3, 28, 1, 1, 1), 1, 0, 1),
    ((2, 256, 5, 8, 8), (256, 256, 3, 3, 3), 1, 1, 1),
    ((40, 56, 1, 128, 128), (56, 56, 1, 3, 3), 1, (0, 1, 1), 1),
    ((2, 128, 5, 16, 16), (768, 128, 1, 1, 1), 1, 0, 1),
    ((2, 3, 7, 11, 13), (5, 3, 3, 3, 3), 2, 1, 2),
)
# the kernel timed at the parity enc0 shape (the main path's) and at
# tpu_s2d4's widest layer (its bridge); the families whose every layer
# shape is timed against the generic kernel
INT8_TIMED = (("parity enc0", (2, 28, 20, 256, 256), (28, 28, 3, 3, 3)),
              ("tpu_s2d4 bridge", (2, 256, 5, 8, 8), (256, 256, 3, 3, 3)))
INT8_AB_FAMILIES = ("parity", "tpu_s2d4")
# phase 14: the packer's requests (one patch to the main path's chunk),
# its batch and submitter threads
PACK_SHAPES = ((20, 256, 256), (20, 256, 448), (36, 256, 256),
               (20, 448, 448), (64, 512, 512), (28, 320, 320),
               (20, 256, 256), (40, 448, 320), (36, 384, 384),
               (64, 512, 512), (24, 300, 260), (48, 512, 448))
PACK_BATCH = 4
PACK_THREADS = 4
# phase 15: the serving front end over HTTP on phase 14's requests: the
# in-process lifecycle workers (one per client thread), the admission
# bound and the burst sent past a bound of two, the profile window (s),
# and the serve subprocess's runtime cap (s; it is stopped by SIGTERM
# once it has answered)
SERVE_SEED = 15
SERVE_WORKERS = PACK_THREADS
SERVE_MAX_INFLIGHT = 8
SERVE_BURST = 8
SERVE_PROFILE_S = 1.0
SERVE_RUNTIME_S = 240
# the SLO config phase 15 serves under (the JAX package's defaults but the
# storage objective, which a server reading no volume never feeds)
SERVE_SLO_TOML = "[objective.storage_hit]\nenabled = false\n"
# phase 24: contracted calls timed per measurement, the sanitizer
# subprocess's runtime cap (s), the parity main-path chunks the ledger
# times after its first (the family's compile) call, and the packer
# requests and mesh it runs for the catalog
CONTRACT_CALLS = 20_000
SANITIZER_TIMEOUT_S = 300
SANITIZER_CHUNKS = 3
LEDGER_CHUNKS = 3
LEDGER_PACK = 3
LEDGER_MESH = "data=2"
# profiler sessions taken before a trace counts as lost; the busy-wait
# (GPU clock cycles, ~1 ms on an H100) ahead of a CUDA-event timing
TRACE_TRIES = 4
LEAD_CYCLES = 2_000_000


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def metrics_events(metrics):
    """Every event of the JSONL telemetry files in a ``--metrics-dir``
    (``programs.json``, the cost ledger's catalog, is no event file)."""
    for name in sorted(os.listdir(metrics)):
        if name.endswith(".jsonl"):
            with open(os.path.join(metrics, name)) as f:
                for ln in f:
                    yield json.loads(ln)


def phase(name: str, detail: str) -> None:
    print(f"[{name}] {detail}", flush=True)


class Timer:
    """Device time of CUDA work from the profiler's device trace, with the
    L2 cache flushed before every call (the main path runs the convnet
    between launches, so a kernel finds its operands cold). A trace that
    holds no device time for the work fails the run."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device="cuda")
        # a process's first profiler session can start tracing after the
        # kernels queued in it have run: open one and discard it
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            self.flush.zero_()
            torch.cuda.synchronize()

    def _trace(self, fn, reps, complete):
        """The device events of ``reps`` calls of ``fn``, or None when no
        session's trace was ``complete``: the profiler can drop a
        session's device events (one session traced 0 of 15 launches, one
        3 of 30), so an incomplete trace is discarded and taken again."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.torch.cuda.synchronize()
        for _ in range(TRACE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.zero_()
                    fn()
                self.torch.cuda.synchronize()
            # the flush is a fill kernel (or a memset); nothing timed here
            # fills
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "FillFunctor" not in e.name
                      and "Memset" not in e.name]
            if complete(events):
                return events
            time.sleep(1)
        return None

    def event_ms(self, fn, reps):
        """Median device time of one call of ``fn`` between two CUDA
        events, L2 flushed. A busy-wait kernel ahead of the first event
        keeps the card busy while the host queues the call, so the host's
        launch time is not counted."""
        torch = self.torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def kernel_ms(self, fn, kernel: str, reps: int = 15) -> float:
        """Median device time of one launch of the kernel named
        ``kernel``; ``fn`` launches that kernel and nothing else."""
        events = self._trace(fn, reps, lambda ev: sum(
            kernel in e.name for e in ev) == reps)
        if events is None:
            return self._fallback(fn, reps, f"{reps} launches of {kernel}")
        return statistics.median(e.time_range.elapsed_us() / 1e3
                                 for e in events if kernel in e.name)

    def call_ms(self, fn, reps: int = 5) -> float:
        """Device time of all the kernels one call of ``fn`` runs."""
        events = self._trace(fn, reps, bool)
        if events is None:
            return self._fallback(fn, reps, "any device time")
        return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3

    def _fallback(self, fn, reps, wanted):
        phase("timer", f"the profiler did not trace {wanted} in "
                       f"{TRACE_TRIES} sessions: timed with CUDA events")
        return self.event_ms(fn, reps)


def forward(model, x):
    """One forward of ``model`` under the engine's own settings
    (``engines.exact_float32``), as the Inferencer runs it."""
    import torch

    from chunkflow_tpu_torch.inference import engines

    with torch.no_grad(), engines.exact_float32():
        return model(x)


def conv_flops(model, x) -> int:
    """Multiply-add operations (x2) of the convolutions in one forward of
    ``model`` on ``x``, counted from the layers' shapes."""
    import torch

    total = 0

    def hook(module, inputs, output):
        nonlocal total
        kvol = module.weight[0, 0].numel()
        if isinstance(module, torch.nn.ConvTranspose3d):
            total += 2 * inputs[0].numel() * module.out_channels * kvol
        else:
            total += 2 * output.numel() * module.in_channels * kvol

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return total


# RSUNet of the benchmark's configuration (portbench/configs/rsunet-bf16)
EPILOGUE_WIDTHS = (28, 36, 48, 64, 80)
EPILOGUE_DOWN = ((1, 2, 2),) * 4


def epilogue_phase(torch, timer, note_err) -> dict:
    """RSUNet's convolution epilogue (``csrc/conv_epilogue.cu``) on the
    card: bitwise its plain version in each mode at every depth of the
    benchmark's RSUNet (batch 2 of 20x256x256, bfloat16), its device time
    at depth 0 (2x28x20x256x256) beside its byte bound and its plain
    version, L2 flushed, and one whole forward's launches (32 a batch),
    bitwise and timed against the plain epilogue's; every comparison
    through ``note_err``. Returns the kernel's times for the closing
    ``kernels`` line (the affine mode's); its launches there are the
    main path's (phase 7) and the int8 legs'."""
    from unittest import mock

    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.models.rsunet import RSUNet
    from chunkflow_tpu_torch.models.unet3d import seeded_init
    from chunkflow_tpu_torch.ops import conv_epilogue as ce

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    bf16 = torch.bfloat16
    modes = {"bias": (False, False), "affine": (True, False),
             "residual": (True, True), "skip": (False, True)}

    def operands(c, zyx, mode):
        affine, other = modes[mode]
        y = torch.randn((BATCH, c) + zyx, device=dev, generator=g).to(bf16)
        p = [torch.randn(c, device=dev, generator=g) for _ in range(3)]
        return dict(y=y, bias=p[0], scale=p[1] if affine else None,
                    shift=p[2] if affine else None,
                    other=torch.randn(y.shape, device=dev, generator=g).to(
                        bf16) if other else None)

    checked = 0
    for depth, c in enumerate(EPILOGUE_WIDTHS):
        zyx = (PIN[0], PIN[1] >> depth, PIN[2] >> depth)
        for mode in modes:
            ops = operands(c, zyx, mode)
            y = ops.pop("y")
            ref = ce.conv_epilogue_plain(y.clone(), **ops)
            with torch.no_grad():
                got = ce.conv_epilogue(y, **ops)
            require(torch.equal(got.view(torch.int16), ref.view(torch.int16)),
                    f"conv_epilogue {mode} at depth {depth} ({c} x {zyx}): "
                    f"kernel differs from its plain version")
            note_err("conv_epilogue", got, ref)
            checked += 1
    line = {}
    for mode in modes:
        ops = operands(EPILOGUE_WIDTHS[0], PIN, mode)
        y = ops.pop("y")
        n = y.numel()
        nbytes = n * y.element_size() * (3 if ops["other"] is not None
                                         else 2) + 3 * y.shape[1] * 4
        bound = nbytes / PEAK_BW * 1e3
        with torch.no_grad():
            ms = timer.kernel_ms(lambda: ce.conv_epilogue(y, **ops),
                                 "conv_epilogue_kernel")
        plain_ms = timer.call_ms(lambda: ce.conv_epilogue_plain(y, **ops))
        line[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
        phase("kernels", f"conv_epilogue, {mode}: {ms:.4f} ms/launch "
                         f"(median device time by profiler, L2 flushed), "
                         f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                         f"bytes), {bound / ms:.0%} of bound, plain "
                         f"{plain_ms:.4f} ms")
        del y, ops
    model = RSUNet(1, CHANNELS, width=EPILOGUE_WIDTHS,
                   down_factors=EPILOGUE_DOWN, dtype=bf16).eval()
    seeded_init(model, torch.Generator().manual_seed(26))
    model.to(dev)
    x = torch.rand((BATCH, 1) + PIN, device=dev, generator=g)
    with torch.no_grad(), engines.exact_float32():
        ce.launches = 0
        got = model(x)
        launched = ce.launches
        fwd_ms = timer.call_ms(lambda: model(x), reps=3)
        with mock.patch.object(ce, "conv_epilogue", ce.conv_epilogue_plain):
            ref = model(x)
            plain_fwd_ms = timer.call_ms(lambda: model(x), reps=3)
    require(launched == 32, f"conv_epilogue: {launched} launches in one "
                            f"RSUNet forward, not 32")
    note_err("conv_epilogue", got, ref)
    phase("kernels", f"conv_epilogue == plain bitwise in {checked} "
                     f"mode/depth cases; one rsunet-bf16 forward of "
                     f"{BATCH}x{PIN}: {launched} launches, bitwise the "
                     f"plain epilogue's, {fwd_ms:.2f} ms device time "
                     f"(plain epilogue {plain_fwd_ms:.2f} ms)")
    del model, x, got, ref
    torch.cuda.empty_cache()
    return dict(ms=line["affine"]["ms"],
                plain_ms=line["affine"]["plain_ms"],
                bound_ms=line["affine"]["bound_ms"], bound_by="bytes",
                library_ms=None)


def main() -> int:
    import numpy as np
    import torch

    laps = [("start", time.perf_counter())]

    def lap(label):
        """The start of a phase (or of phases that run in one call)."""
        laps.append((label, time.perf_counter()))

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card")
    sys.path.insert(0, str(ROOT))
    try:
        import chunkflow_tpu_torch
    except ImportError as exc:
        raise SmokeFailure(f"the port is not beside this script ({exc}); "
                           f"run it from a checkout of the repository")
    require(Path(chunkflow_tpu_torch.__file__).resolve().is_relative_to(ROOT),
            f"imported {chunkflow_tpu_torch.__file__}, not this checkout's "
            f"package")
    from chunkflow_tpu_torch import Chunk, _build
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.inference.bump import bump_map
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.models.convert import state_from_flax
    from chunkflow_tpu_torch.models.rsunet import RSBlock
    from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init
    from chunkflow_tpu_torch.ops import (
        accumulate,
        conv_epilogue,
        gather,
        int8_conv,
    )

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    # no automatic profiler captures (a sustained stall, a page alert):
    # one would hold the process's one profiler session while this
    # script's own traces and phase 15's POST /profile take theirs
    os.environ["CHUNKFLOW_PROFILE_ON_ANOMALY"] = "0"
    kernels = {
        "gather": {"module": gather, "plain": gather.gather_patches_plain,
                   "entry": "gather_patches",
                   "source": "chunkflow_tpu_torch/csrc/gather.cu",
                   "replaces": "chunkflow_tpu/ops/pallas_gather.py:241"},
        "accumulate": {"module": accumulate,
                       "plain": accumulate.fused_accumulate_patches_plain,
                       "entry": "fused_accumulate_patches",
                       "source": "chunkflow_tpu_torch/csrc/accumulate.cu",
                       "replaces": "chunkflow_tpu/ops/pallas_blend.py:172"},
        # RSUNet's convolution epilogue (no TPU kernel: XLA fuses it)
        "conv_epilogue": {"module": conv_epilogue,
                          "plain": conv_epilogue.conv_epilogue_plain,
                          "entry": "conv_epilogue",
                          "source": "chunkflow_tpu_torch/csrc/"
                                    "conv_epilogue.cu",
                          "replaces": "none (XLA's fusion of "
                                      "chunkflow_tpu/models/rsunet.py)"},
        # the XLA op of the JAX package's int8 real leg (no Pallas kernel)
        "conv3d_int8": {"module": int8_conv,
                        "plain": int8_conv.conv3d_int8_plain,
                        "entry": "conv3d_int8",
                        "source": "chunkflow_tpu_torch/csrc/conv3d_int8.cu",
                        "replaces": "chunkflow_tpu/inference/precision.py:294"},
    }
    err = {name: 0.0 for name in kernels}
    for k in kernels.values():
        k["launches"] = 0
    # the blend kernels every inference path launches (the float forwards
    # launch no int8 convolution)
    blend = ("gather", "accumulate")

    def reset_counts():
        for k in kernels.values():
            k["module"].launches = 0
        for path in int8_conv.path_launches:
            int8_conv.path_launches[path] = 0

    def counts():
        return {name: kernels[name]["module"].launches for name in blend}

    def counts_all():
        """Every wrapper's count, and the int8 convolution's per path
        (``conv3d_int8 hopper``, ``conv3d_int8 generic``)."""
        out = {name: k["module"].launches for name, k in kernels.items()}
        out.update({f"conv3d_int8 {path}": n
                    for path, n in int8_conv.path_launches.items()})
        return out

    def plain_functions():
        """Patch every kernel wrapper with its plain version: the same
        ops, on the card, through the plain functions."""
        stack = contextlib.ExitStack()
        for k in kernels.values():
            stack.enter_context(
                mock.patch.object(k["module"], k["entry"], k["plain"]))
        return stack

    def note_err(name, a, b):
        diff = (a.double() - b.double()).abs()
        err[name] = max(err[name], float(diff.max()) if diff.numel() else 0.0)
        require(torch.equal(a, b), f"{name}: kernel differs from its plain "
                                   f"version (max abs {err[name]})")

    lap("1-2 card, build")
    # ---- 1. card --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    phase("card", f"{name}, {torch.cuda.device_count()} device(s); torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}, numpy "
                  f"{np.__version__}")
    # name and power limit exactly as nvidia-smi gives them
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("card", "file formats and host build: " + ", ".join(
        f"{label} {_version(module)}" for label, module in (
            ("h5py", "h5py"), ("Pillow", "PIL"), ("scipy", "scipy")))
        + f", g++ {_gxx_version()}")
    require(H100_SXM in name, f"{name} is not an {H100_SXM}: the bounds "
                              f"use that card's peaks")
    phase("card", f"bounds use the H100 SXM peaks: {PEAK_BW / 1e12} TB/s, "
                  f"{PEAK_F32 / 1e12} TFLOP/s float32")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    phase("build", f"{len(paths)} kernels built in "
                   f"{time.perf_counter() - t0:.3f} s into "
                   f"{_build.BUILD_DIR.relative_to(ROOT)}")

    lap("3 kernels")
    # ---- 3. kernels vs plain on the card --------------------------------
    timer = Timer(torch)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    grid = enumerate_patches(CHUNK, PIN, PIN, OVERLAP)
    in_starts, out_starts, valid = pad_to_batch(grid, BATCH)
    first = slice(0, BATCH)
    in_b = torch.from_numpy(in_starts[first])
    out_b = torch.from_numpy(out_starts[first])
    reset_counts()
    # gather: every dtype, main-path chunk size, unaligned starts
    odd = torch.tensor([[3, 7, 13], [41, 250, 255], [0, 1, 2]],
                       dtype=torch.int32)
    big_chunks = {}
    for dt in ("uint8", "uint16", "int32", "float32"):
        chunk = torch.from_numpy(_raw(rng, dt, (1,) + CHUNK)).to(dev)
        if dt in ("uint16", "float32"):
            big_chunks[dt] = chunk
        for starts in (odd, in_b):
            note_err("gather", gather.gather_patches(chunk, starts, PIN),
                     gather.gather_patches_plain(chunk, starts, PIN))
    # gather alignment sweep: every x start mod 16, rows of px % 4 != 0
    # floats, a row pitch (57 elements) that is no multiple of 16 bytes,
    # two channels, and a view one element into its storage; one launch
    sweep = 0
    zyx_a = (2, 6, 20, 57)
    for dt in GATHER_DTYPES:
        n_el = int(np.prod(zyx_a))
        big = torch.from_numpy(_raw(rng, dt, (n_el + 1,))).to(dev)
        for off in (0, 1):
            chunk = big[off:off + n_el].view(zyx_a)
            for px in (16, 18):
                for m in range(16):
                    starts = torch.tensor(
                        [[0, 0, m], [1, 3, 16 + m], [3, 15, 57 - px]],
                        dtype=torch.int32)
                    before = gather.launches
                    got = gather.gather_patches(chunk, starts, (3, 5, px))
                    require(gather.launches == before + 1,
                            "gather: not one launch for 3 rows")
                    note_err("gather", got, gather.gather_patches_plain(
                        chunk, starts, (3, 5, px)))
                    sweep += 1
    # rows wider than one shared-memory tile (24,560 bytes), which the
    # kernel stages in segments: every dtype, unaligned, offset view
    for dt in GATHER_DTYPES:
        px = 50_000 // np.dtype(dt).itemsize + 3
        zyx_w = (3, 4, px + 29)
        n_el = 2 * int(np.prod(zyx_w))
        chunk = torch.from_numpy(_raw(rng, dt, (n_el + 1,))).to(dev)[1:]
        chunk = chunk.view((2,) + zyx_w)
        starts = torch.tensor([[0, 0, 13], [1, 2, 29]], dtype=torch.int32)
        note_err("gather", gather.gather_patches(chunk, starts, (2, 2, px)),
                 gather.gather_patches_plain(chunk, starts, (2, 2, px)))
    # accumulate: dense overlap with validity-0 rows, both flavours
    co, zyx, pout = 3, (5, 32, 40), (3, 12, 16)
    dense = torch.tensor([[0, 0, 0], [1, 6, 8], [2, 12, 16], [1, 6, 8],
                          [0, 0, 0]], dtype=torch.int32)
    preds_s = torch.from_numpy(
        rng.standard_normal((5, co) + pout, dtype=np.float32)).to(dev)
    bump_s = torch.from_numpy(
        (rng.random(pout, dtype=np.float32) * 5 + 1)).to(dev)
    valid_s = torch.tensor([1, 1, 1, 0, 0], dtype=torch.float32, device=dev)
    for pre_weighted in (False, True):
        args = []
        for _ in range(2):
            args.append((torch.zeros((co,) + zyx, device=dev),
                         torch.zeros(zyx, device=dev)))
        got = accumulate.fused_accumulate_patches(
            *args[0], preds_s, valid_s, bump_s, dense, pre_weighted)
        ref = accumulate.fused_accumulate_patches_plain(
            *args[1], preds_s, valid_s, bump_s, dense, pre_weighted)
        note_err("accumulate", got[0], ref[0])
        note_err("accumulate", got[1], ref[1])
    # more rows than one launch takes: the wrappers split the batch
    many = torch.from_numpy(np.stack(
        [rng.integers(0, e - p, 70) for e, p in zip(zyx, pout)],
        axis=1).astype(np.int32))
    chunk = torch.from_numpy(rng.integers(0, 255, (2,) + zyx).astype(
        np.uint8)).to(dev)
    before = gather.launches
    note_err("gather", gather.gather_patches(chunk, many, pout),
             gather.gather_patches_plain(chunk, many, pout))
    require(gather.launches == before + 2, "gather: 70 rows, not 2 launches")
    preds_m = torch.from_numpy(
        rng.standard_normal((70, co) + pout, dtype=np.float32)).to(dev)
    valid_m = torch.from_numpy((rng.random(70) > 0.2).astype(
        np.float32)).to(dev)
    got = accumulate.fused_accumulate_patches(
        torch.zeros((co,) + zyx, device=dev), torch.zeros(zyx, device=dev),
        preds_m, valid_m, bump_s, many)
    ref = accumulate.fused_accumulate_patches_plain(
        torch.zeros((co,) + zyx, device=dev), torch.zeros(zyx, device=dev),
        preds_m, valid_m, bump_s, many)
    note_err("accumulate", got[0], ref[0])
    note_err("accumulate", got[1], ref[1])
    # accumulate at the main path's shapes, onto a non-zero buffer
    bump = torch.tensor(bump_map(PIN), device=dev)
    preds = torch.from_numpy(
        rng.random((BATCH, CHANNELS) + PIN, dtype=np.float32)).to(dev)
    valid_b = torch.from_numpy(valid[first]).to(dev)
    base_out = torch.from_numpy(
        rng.random((CHANNELS,) + CHUNK, dtype=np.float32)).to(dev)
    base_w = torch.from_numpy(rng.random(CHUNK, dtype=np.float32)).to(dev)
    got = accumulate.fused_accumulate_patches(
        base_out.clone(), base_w.clone(), preds, valid_b, bump, out_b)
    ref = accumulate.fused_accumulate_patches_plain(
        base_out.clone(), base_w.clone(), preds, valid_b, bump, out_b)
    note_err("accumulate", got[0], ref[0])
    note_err("accumulate", got[1], ref[1])
    # both kernels at the quick start's batch (phase 12), the same patch:
    # a uint8 chunk in, (QUICK_BATCH, 3, 20, 256, 256) predictions out
    q_rng = np.random.default_rng(12)
    q_in, q_out, q_valid = (
        torch.from_numpy(a[:QUICK_BATCH])
        for a in pad_to_batch(grid, QUICK_BATCH))
    raw_q = torch.from_numpy(_raw(q_rng, "uint8", (1,) + CHUNK)).to(dev)
    note_err("gather", gather.gather_patches(raw_q, q_in, PIN),
             gather.gather_patches_plain(raw_q, q_in, PIN))
    preds_q = torch.from_numpy(q_rng.random(
        (QUICK_BATCH, CHANNELS) + PIN, dtype=np.float32)).to(dev)
    got = accumulate.fused_accumulate_patches(
        base_out.clone(), base_w.clone(), preds_q, q_valid.to(dev), bump,
        q_out)
    ref = accumulate.fused_accumulate_patches_plain(
        base_out.clone(), base_w.clone(), preds_q, q_valid.to(dev), bump,
        q_out)
    note_err("accumulate", got[0], ref[0])
    note_err("accumulate", got[1], ref[1])
    del raw_q, preds_q, got, ref
    torch.cuda.synchronize()
    phase("kernels", f"kernel == plain bitwise, gather alignment sweep "
                     f"{sweep} cases, rows wider than a tile in "
                     f"{len(GATHER_DTYPES)} dtypes, batches {BATCH} and "
                     f"{QUICK_BATCH} at {PIN}; launches in this phase: "
                     f"{counts()}")
    per_sm, sms = gather.occupancy(torch.uint8)
    ptxas = _build.library_path("gather").with_suffix(".log").read_text()
    used = sorted({line.split(":", 1)[1].strip()
                   for line in ptxas.splitlines() if "Used" in line})
    spills = sorted({line.strip() for line in ptxas.splitlines()
                     if "spill" in line})
    phase("kernels", f"gather: {per_sm} resident blocks/SM x {sms} SMs "
                     f"(uint8 instance); ptxas per instance: {used}; "
                     f"{spills}")

    # per-launch times at the main path's shapes
    chunk_u8 = Chunk.create(size=CHUNK, dtype=np.uint8, pattern="sin")
    raw_dev = torch.from_numpy(chunk_u8.array[None].copy()).to(dev)
    out_t = torch.zeros((CHANNELS,) + CHUNK, device=dev)
    w_t = torch.zeros(CHUNK, device=dev)
    P = int(np.prod(PIN))
    covered = np.zeros(CHUNK, dtype=bool)
    for z, y, x in out_starts[first]:
        covered[z:z + PIN[0], y:y + PIN[1], x:x + PIN[2]] = True
    n_cov = int(covered.sum())
    work = {
        "gather": {
            "run": lambda: gather.gather_patches(raw_dev, in_b, PIN),
            "plain": lambda: gather.gather_patches_plain(raw_dev, in_b, PIN),
            # each patch element read once (uint8) and written once (f32);
            # one multiply each
            "bytes": BATCH * P * (1 + 4) + in_b.numel() * 4,
            "ops": BATCH * P,
        },
        "accumulate": {
            "run": lambda: accumulate.fused_accumulate_patches(
                out_t, w_t, preds, valid_b, bump, out_b),
            "plain": lambda: accumulate.fused_accumulate_patches_plain(
                out_t, w_t, preds, valid_b, bump, out_b),
            # predictions, bump, validity and starts read once; every
            # covered out/weight cell read and written once
            "bytes": (BATCH * CHANNELS * P + P + BATCH) * 4
                     + out_b.numel() * 4 + 2 * (CHANNELS + 1) * n_cov * 4,
            # per patch voxel: 2 multiplies + 1 add per channel, then
            # 1 multiply + 1 add for the weight
            "ops": BATCH * P * (3 * CHANNELS + 2),
        },
    }
    for kname, w in work.items():
        k = kernels[kname]
        k["ms"] = timer.kernel_ms(w["run"], f"{kname}_kernel")
        k["plain_ms"] = timer.call_ms(w["plain"])
        t_bytes = w["bytes"] / PEAK_BW * 1e3
        t_ops = w["ops"] / PEAK_F32 * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        k["library_ms"] = None  # no one PyTorch call computes it
        phase("kernels", f"{kname}: {k['ms']:.4f} ms/launch (median "
                         f"device time by profiler, L2 flushed), bound "
                         f"{k['bound_ms']:.4f} ms ({w['bytes'] / 1e6:.1f} MB, "
                         f"{k['bound_by']}), plain {k['plain_ms']:.4f} ms")
    # the gather on other chunk types and on unaligned x starts, same shape
    unaligned = torch.tensor([[0, 0, 13], [0, 192, 200]], dtype=torch.int32)
    for label, chunk, starts in (
            ("uint16", big_chunks["uint16"], in_b),
            ("float32", big_chunks["float32"], in_b),
            ("uint8 at x 13 and 200", raw_dev, unaligned)):
        ms = timer.kernel_ms(
            lambda: gather.gather_patches(chunk, starts, PIN), "gather_kernel")
        plain_ms = timer.call_ms(
            lambda: gather.gather_patches_plain(chunk, starts, PIN))
        nbytes = BATCH * P * (chunk.element_size() + 4) + starts.numel() * 4
        bound = nbytes / PEAK_BW * 1e3
        phase("kernels", f"gather, {label}: {ms:.4f} ms/launch, bound "
                         f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, bytes), "
                         f"{bound / ms:.0%} of bound, plain {plain_ms:.4f} ms")
    del big_chunks, base_out, base_w
    kernels["conv_epilogue"].update(epilogue_phase(torch, timer, note_err))

    lap("4 identity")
    # ---- 4. identity main path ------------------------------------------
    def run_paths(inferencer, chunk, label, epilogues=0):
        """Kernel path (counted) then plain path; bitwise equal.
        ``epilogues``: the conv epilogue launches of one batch's forward
        (RSUNet's convolutions but the head; 0 for every other model),
        which the kernel path makes for each batch of the chunk's patches
        and the plain path never."""
        inferencer(chunk)  # warm-up
        reset_counts()
        t = time.perf_counter()
        got = inferencer(chunk)
        wall = time.perf_counter() - t
        launched = counts()
        for kname, n in launched.items():
            require(n > 0, f"{label}: {kname} kernel never launched")
        batches = -(-enumerate_patches(tuple(chunk.shape[-3:]), PIN, PIN,
                                       OVERLAP).num_patches // BATCH)
        require(conv_epilogue.launches == epilogues * batches,
                f"{label}: {conv_epilogue.launches} conv epilogue launches, "
                f"not {epilogues} x {batches} batches")
        if epilogues:
            launched["conv_epilogue"] = conv_epilogue.launches
        with plain_functions():
            ref = inferencer(chunk)
        require(counts() == {k: launched[k] for k in blend}
                and conv_epilogue.launches == epilogues * batches,
                f"{label}: the plain path launched a kernel")
        a, b = got.array, ref.array
        diff = float((a.double() - b.double()).abs().max())
        require(torch.equal(a, b), f"{label}: kernel path differs from the "
                                   f"plain path, max abs {diff}")
        return got, wall, launched

    ident = Inferencer(
        input_patch_size=PIN, output_patch_overlap=OVERLAP,
        num_output_channels=CHANNELS, framework="identity",
        batch_size=BATCH,
    )
    result, wall, launched = run_paths(ident, chunk_u8, "identity")
    out = result.host().array
    expected = chunk_u8.array.astype(np.float32) * np.float32(1 / 255)
    require(out.shape == (CHANNELS,) + CHUNK and np.isfinite(out).all(),
            f"identity: output shape {out.shape} / non-finite values")
    oracle = float(np.abs(out - expected[None]).max())
    require(oracle <= 1e-5, f"identity oracle max abs {oracle} > 1e-5")
    vox = int(np.prod(CHUNK))
    phase("identity", f"{CHUNK} uint8: {grid.num_patches} patches, "
                      f"launches {launched}, kernel == plain bitwise, oracle "
                      f"max abs {oracle:.3g} <= 1e-5, {wall:.4f} s, "
                      f"{vox / wall / 1e6:.2f} Mvox/s")
    identity_out = out
    # the identity path's host side: the raw upload, and each wrapper's
    # host time per call (back-to-back calls; the device work is shorter)
    upload = []
    for _ in range(5):
        t = time.perf_counter()
        chunk_u8.device(dev)
        torch.cuda.synchronize()
        upload.append(time.perf_counter() - t)
    host_us = {}
    for kname, w in work.items():
        w["run"]()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            w["run"]()
        host_us[kname] = (time.perf_counter() - t) / 50 * 1e6
        torch.cuda.synchronize()
    del out_t, w_t
    phase("identity", f"host side: raw upload "
                      f"{statistics.median(upload) * 1e3:.3f} ms "
                      f"({chunk_u8.array.nbytes / 1e6:.1f} MB), wrapper "
                      f"host time per call: " + ", ".join(
                          f"{k} {v:.1f} us" for k, v in host_us.items()))

    ragged = Chunk.create(size=RAGGED, dtype=np.uint16, pattern="random")
    r_grid = enumerate_patches(RAGGED, PIN, PIN, OVERLAP)
    require(r_grid.num_patches % BATCH == 1, "ragged case lost its padding row")
    r_res, _, r_launched = run_paths(ident, ragged, "identity ragged")
    r_out = r_res.host().array
    r_exp = ragged.array.astype(np.float32) * np.float32(1 / 65535)
    r_oracle = float(np.abs(r_out - r_exp[None]).max())
    require(r_oracle <= 1e-5, f"ragged identity oracle {r_oracle} > 1e-5")
    phase("identity", f"{RAGGED} uint16: {r_grid.num_patches} patches (one "
                      f"validity-0 row), launches {r_launched}, kernel == "
                      f"plain bitwise, oracle max abs {r_oracle:.3g}")

    lap("5 unet3d")
    # ---- 5. UNet3D main path at full width -------------------------------
    # the process keeps PyTorch's global flags (cuDNN TF32 on): the engine
    # scopes its own (TF32 off, deterministic, no autotuning) around every
    # forward, and so does ``forward`` below for the direct model calls
    defaults = engines._flags()
    seeded = seeded_init(UNet3D(in_channels=1, out_channels=CHANNELS),
                         torch.Generator().manual_seed(0))
    flax_tree = _flax_layout(seeded.state_dict())
    state = state_from_flax(flax_tree)
    for key, value in seeded.state_dict().items():
        require(torch.equal(state[key], value),
                f"convert: {key} did not round-trip")
    weights = OUT_DIR / "unet3d_seed0.pt"
    torch.save(state, weights)
    unet = Inferencer(
        input_patch_size=PIN, output_patch_overlap=OVERLAP,
        num_output_channels=CHANNELS, framework="pytorch",
        weight_path=str(weights), batch_size=BATCH,
    )
    model = unet.engine.model
    torch.cuda.reset_peak_memory_stats()
    result, wall, launched = run_paths(unet, chunk_u8, "unet3d")
    peak = torch.cuda.max_memory_allocated()
    require(engines._flags() == defaults and torch.backends.cudnn.allow_tf32,
            f"the engine left the global flags changed: {engines._flags()}")
    out = result.host().array
    require(out.shape == (CHANNELS,) + CHUNK and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 1.0 + 1e-6,
            "unet3d: output not finite sigmoid maps of the chunk's shape")
    for kname, n in launched.items():
        kernels[kname]["launches"] = n
    phase5_launches = dict(launched)
    # where a chunk's time goes: the forward of one batch
    patches = gather.gather_patches(raw_dev, in_b, PIN)
    fwd_ms = timer.call_ms(lambda: forward(model, patches), reps=3)
    flops = conv_flops(model, patches)
    n_batches = len(in_starts) // BATCH
    phase("unet3d", f"widths {model.feature_maps}, float32 (TF32 off): "
                    f"{grid.num_patches} patches, launches {launched}, "
                    f"kernel == plain bitwise (tolerance 0), {wall:.4f} s, "
                    f"{vox / wall / 1e6:.3f} Mvox/s, peak memory "
                    f"{peak / 2**30:.2f} GiB")
    phase("unet3d", f"time per chunk: forward {fwd_ms:.2f} ms/batch "
                    f"(device time, {flops / 1e12:.3f} TFLOP of convolutions "
                    f"= {flops / fwd_ms / 1e9:.1f} TFLOP/s, "
                    f"{flops / fwd_ms / 1e9 / (PEAK_F32 / 1e12):.1%} of the "
                    f"float32 peak) x {n_batches} = "
                    f"{fwd_ms * n_batches:.1f} ms; kernels "
                    f"{sum(kernels[k]['ms'] * launched[k] for k in launched):.2f}"
                    f" ms in {sum(launched.values())} launches")
    x = torch.from_numpy(rng.random((1, 1, 8, 64, 64), dtype=np.float32))
    on_gpu = forward(model, x.to(dev)).cpu()
    with torch.no_grad():
        on_cpu = copy.deepcopy(model).cpu()(x)
        # the fault the engine's scope repairs: the same forward under the
        # process's default flags, cuDNN in TF32
        on_tf32 = model(x.to(dev)).cpu()
    gpu_cpu = float((on_gpu - on_cpu).abs().max())
    require(gpu_cpu <= 1e-4, f"unet3d GPU vs CPU max abs {gpu_cpu} > 1e-4")
    tf32 = (on_tf32 - on_cpu).abs()
    beyond = torch.nonzero(tf32 > 1e-4)
    phase("unet3d", f"one 8x64x64 patch, GPU vs CPU: max abs {gpu_cpu:.3g} "
                    f"<= 1e-4 (the engine's scope); unscoped under the "
                    f"default flags (cuDNN TF32 {defaults[0]}): max abs "
                    f"{float(tf32.max()):.3g}, first index beyond 1e-4 "
                    f"{tuple(beyond[0].tolist()) if len(beyond) else None}")

    lap("6 cli")
    # ---- 6. CLI -----------------------------------------------------------
    npy = OUT_DIR / "cli_identity.npy"
    rc = cli.main([
        "create-chunk", "--size", *map(str, CHUNK), "--dtype", "uint8",
        "--pattern", "sin",
        "inference", "--framework", "identity",
        "--input-patch-size", *map(str, PIN),
        "--output-patch-overlap", *map(str, OVERLAP),
        "--num-output-channels", str(CHANNELS),
        "--batch-size", str(BATCH),
        "save-npy", "--file-name", str(npy),
    ])
    require(rc == 0, f"CLI exit code {rc}")
    require(np.array_equal(np.load(npy), identity_out),
            "CLI result differs from the identity main path")
    phase("cli", "create-chunk | inference -f identity | save-npy == "
                 "phase 4 result")

    lap("7 models")
    # ---- 7. every convnet family, both compute dtypes --------------------
    rsunet_files = _reference_rsunet(torch, OUT_DIR, dev)
    tpu = engines.create_engine("pytorch", model_variant="tpu").model
    mxu = engines.create_engine("pytorch", model_variant="tpu_mxu").model
    require(type(tpu) is type(mxu) and mxu.conv_impl == "mxu" and all(
        k == j and torch.equal(a, b) for (k, a), (j, b) in zip(
            tpu.state_dict().items(), mxu.state_dict().items())),
        "models: tpu_mxu does not build tpu's weights with mxu layers")
    phase("models", "tpu_mxu builds the tpu weights with the MxuConv / "
                    "MxuConvTranspose layers; run in phase 13")
    del tpu, mxu
    gaps = {}
    x_patch = torch.from_numpy(rng.random((1, 1, 8, 64, 64),
                                          dtype=np.float32))
    crops = torch.from_numpy(np.stack([
        np.asarray(chunk_u8.array)[tuple(slice(s, s + n)
                                         for s, n in zip(start, CROP))]
        for start in BF16_CROPS])[:, None].astype(np.float32)
        * np.float32(1 / 255))
    for variant in FAMILIES:
        f32_out = None
        for dtype in ("float32", "bfloat16"):
            label = f"{variant} {dtype}"
            files = rsunet_files if variant == "rsunet" else {}
            inf = Inferencer(
                input_patch_size=PIN, output_patch_overlap=OVERLAP,
                num_output_channels=CHANNELS, framework="pytorch",
                batch_size=BATCH, model_variant=variant, dtype=dtype,
                **files)
            model = inf.engine.model
            # RSUNet: the embedding, three a block, one a transposed conv
            epilogues = (3 * sum(isinstance(m, RSBlock)
                                 for m in model.modules())
                         + len(model.width)) if variant == "rsunet" else 0
            torch.cuda.reset_peak_memory_stats()
            result, wall, launched = run_paths(inf, chunk_u8, label,
                                               epilogues)
            peak = torch.cuda.max_memory_allocated()
            kernels["conv_epilogue"]["launches"] += launched.get(
                "conv_epilogue", 0)
            out = result.array
            require(tuple(out.shape) == (CHANNELS,) + CHUNK
                    and bool(torch.isfinite(out).all())
                    and float(out.min()) >= 0.0
                    and float(out.max()) <= 1.0 + 1e-6,
                    f"{label}: output not finite sigmoid maps of the chunk's "
                    f"shape")
            fwd_ms = timer.call_ms(lambda: forward(model, patches), reps=3)
            flops = conv_flops(model, patches)
            peak_ops = PEAK_BF16 if dtype == "bfloat16" else PEAK_F32
            phase("models", f"{label}: widths {_widths(model)}, "
                            f"{sum(p.numel() for p in model.parameters())} "
                            f"parameters, launches {launched}, kernel == "
                            f"plain bitwise, {wall:.4f} s, "
                            f"{vox / wall / 1e6:.3f} Mvox/s, peak memory "
                            f"{peak / 2**30:.2f} GiB")
            phase("models", f"{label}: forward {fwd_ms:.2f} ms/batch (device "
                            f"time), {flops / 1e12:.3f} TFLOP of "
                            f"convolutions = {flops / fwd_ms / 1e9:.1f} "
                            f"TFLOP/s, {flops / fwd_ms / 1e9 / (peak_ops / 1e12):.1%}"
                            f" of {peak_ops / 1e12:.0f} TFLOP/s; x "
                            f"{n_batches} batches = {fwd_ms * n_batches:.1f} "
                            f"ms")
            on_gpu = forward(model, x_patch.to(dev)).cpu()
            on_crops = forward(model, crops.to(dev)).cpu()
            if dtype == "float32":
                f32_out, f32_patch, f32_crops = out, on_gpu, on_crops
                with torch.no_grad():
                    on_cpu = copy.deepcopy(model).cpu()(x_patch)
                gpu_cpu = float((on_gpu - on_cpu).abs().max())
                require(gpu_cpu <= 1e-4, f"{label}: GPU vs CPU max abs "
                                         f"{gpu_cpu} > 1e-4")
                phase("models", f"{label}: one 8x64x64 patch, GPU vs CPU: "
                                f"max abs {gpu_cpu:.3g} <= 1e-4")
            else:
                on_patch = (on_gpu - f32_patch).abs()
                on_crop = (on_crops - f32_crops).abs()
                on_chunk = (out - f32_out).abs()
                gaps[variant] = {
                    "patch max": float(on_patch.max()),
                    "patch mean": float(on_patch.mean()),
                    "crops mean": float(on_crop.mean()),
                    "chunk mean": float(on_chunk.mean()),
                }
                phase("models", f"{label} vs float32: one 8x64x64 patch max "
                                f"abs {float(on_patch.max()):.4g}, mean abs "
                                f"{float(on_patch.mean()):.4g}; four 8x64x64 "
                                f"crops of the chunk max abs "
                                f"{float(on_crop.max()):.4g}, mean abs "
                                f"{float(on_crop.mean()):.4g}; the chunk max "
                                f"abs {float(on_chunk.max()):.4g}, mean abs "
                                f"{float(on_chunk.mean()):.4g} (gates: max "
                                f"{BF16_MAX} on the patch, mean {BF16_MEAN})")
            del inf, model, result, out
        del f32_out
    for variant, gap in gaps.items():
        require(gap["patch max"] <= BF16_MAX
                and max(gap["patch mean"], gap["crops mean"],
                        gap["chunk mean"]) <= BF16_MEAN,
                f"{variant}: bfloat16 vs float32 {gap} beyond the gates "
                f"(max {BF16_MAX}, mean {BF16_MEAN})")

    lap("8 stream")
    # ---- 8. the streamed worker loop ------------------------------------
    from chunkflow_tpu_torch.flow.runtime import new_task, process_stream

    stream_rng = np.random.default_rng(8)
    stream_chunks = [
        Chunk(stream_rng.integers(0, 256, CHUNK, dtype=np.uint8),
              voxel_offset=(CHUNK[0] * i, 0, 0))
        for i in range(STREAM_K)]
    def consume(results):
        """A worker's loop: take each result on the host and drop it."""
        for _ in results:
            pass

    def per_chunk_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / STREAM_K

    in_memory = {}  # family -> adaptive s/chunk, for phase 10
    for variant, dtype in STREAM_FAMILIES:
        label = f"{variant} {dtype}"
        kwargs = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                      num_output_channels=CHANNELS, batch_size=BATCH)
        inf = Inferencer(framework="pytorch", model_variant=variant,
                         dtype=dtype, **kwargs)
        inf(stream_chunks[0]).host()  # warm-up
        # correctness: every route against the serial loop, bitwise
        serial = [inf(c).host().array for c in stream_chunks]
        streamed = list(inf.stream(iter(stream_chunks)))
        static = list(inf.stream(iter(stream_chunks), adaptive=False))
        # the CLI's inference stage (--async-depth 3), fed the same chunks
        _, cli_stages = cli.build_stages([
            "inference", "--framework", "pytorch", "--model-variant",
            variant, "--dtype", dtype,
            "--input-patch-size", *map(str, PIN),
            "--output-patch-overlap", *map(str, OVERLAP),
            "--num-output-channels", str(CHANNELS),
            "--batch-size", str(BATCH), "--async-depth", "3"])
        via_cli = []

        def source(seed_stream):
            for _seed in seed_stream:
                for c in stream_chunks:
                    task = new_task()
                    task["chunk"] = c
                    yield task

        def sink(task_stream):
            for task in task_stream:
                via_cli.append(task["chunk"].array)
                yield task

        require(process_stream([source, *cli_stages, sink]) == STREAM_K,
                f"stream {label}: the CLI stage lost tasks")
        for route, outs in (("adaptive", [o.array for o in streamed]),
                            ("static", [o.array for o in static]),
                            ("cli", via_cli)):
            require(len(outs) == STREAM_K and all(
                np.array_equal(a, b) for a, b in zip(outs, serial)),
                f"stream {label}: the {route} route differs from the serial "
                f"loop")
        del streamed, static, via_cli
        # the dispatch path never waits for the card
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [inf.infer_async(inf.stage(c), consume=True)
                    for c in stream_chunks[:3]]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        require(all(np.array_equal(o.host().array, s)
                    for o, s in zip(outs, serial)),
                f"stream {label}: the checked dispatch differs")
        del outs, serial
        # host time to stage and to dispatch one chunk, each chunk started
        # on an idle card, and the device time left after the dispatch
        stage_ms, dispatch_ms, rest_ms = [], [], []
        for c in stream_chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = inf.stage(c)
            t1 = time.perf_counter()
            out = inf.infer_async(staged, consume=True)
            t2 = time.perf_counter()
            out.host()
            stage_ms.append((t1 - t0) * 1e3)
            dispatch_ms.append((t2 - t1) * 1e3)
            rest_ms.append((time.perf_counter() - t2) * 1e3)
            del staged, out
        # timed: a worker's loops, results dropped as they come; the
        # adaptive stream is the counted main path
        serial_s = per_chunk_s(
            lambda: consume(inf(c).host() for c in stream_chunks))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stream_s = per_chunk_s(lambda: consume(inf.stream(
            iter(stream_chunks))))
        launched = counts()
        peak = torch.cuda.max_memory_allocated()
        for kname, n in launched.items():
            require(n == 18 * STREAM_K,
                    f"stream {label}: {kname} launched {n} times, not "
                    f"{18 * STREAM_K} (18 per chunk)")
        in_memory[label] = stream_s
        static_s = per_chunk_s(lambda: consume(inf.stream(
            iter(stream_chunks), adaptive=False)))
        # overlap and idle shares from the device trace
        s_trace = _device_trace(torch, lambda: consume(
            inf(c).host() for c in stream_chunks))
        # the chunks twice: twice the chunk-to-chunk hand-overs in which a
        # download can meet the next chunk's kernels
        t_trace = _device_trace(torch, lambda: consume(inf.stream(
            iter(stream_chunks * 2))), downloads=2 * STREAM_K)
        busy_ms = sum(b - a for a, b in _union(
            [(s, e) for n, s, e in s_trace if not n.startswith("Memcpy")]
        )) / STREAM_K / 1e3
        s_idle = _idle_share(s_trace)
        t_idle = _idle_share(t_trace)
        share, d2h_overlapping, n_d2h = _copy_overlap(t_trace)
        require(d2h_overlapping >= 1,
                f"stream {label}: no download overlaps the next chunk's "
                f"kernels ({n_d2h} downloads traced)")
        phase("stream", f"{label}: {STREAM_K} chunks, launches {launched} "
                        f"(18 + 18 per chunk), adaptive, static and CLI "
                        f"routes == serial bitwise, dispatch clean under "
                        f"sync debug mode 'error'")
        phase("stream", f"{label}: per chunk, host: stage "
                        f"{statistics.median(stage_ms):.1f} ms, dispatch "
                        f"{statistics.median(dispatch_ms):.1f} ms, then "
                        f"{statistics.median(rest_ms):.1f} ms to the result "
                        f"on the host; device busy {busy_ms:.1f} ms (kernels "
                        f"in the serial trace)")
        phase("stream", f"{label}: serial loop (with .host()) "
                        f"{serial_s:.4f} s/chunk, {vox / serial_s / 1e6:.3f} "
                        f"Mvox/s; streamed adaptive {stream_s:.4f} s/chunk, "
                        f"{vox / stream_s / 1e6:.3f} Mvox/s; static "
                        f"{static_s:.4f} s/chunk, {vox / static_s / 1e6:.3f} "
                        f"Mvox/s; peak memory {peak / 2**30:.2f} GiB")
        phase("stream", f"{label}: device trace: {share:.1%} of upload and "
                        f"download time overlaps kernels, {d2h_overlapping} "
                        f"of {n_d2h} downloads overlap the next chunk's "
                        f"kernels; compute idle share streamed {t_idle:.1%}, "
                        f"serial {s_idle:.1%}")
        del inf

    lap("9 fold")
    # ---- 9. fold -------------------------------------------------------------
    fold_kw = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                   num_output_channels=CHANNELS, batch_size=BATCH,
                   blend="fold")
    reset_counts()
    on_card = Inferencer(framework="identity", **fold_kw)(chunk_u8)
    require(sum(counts().values()) == 0, "fold launched a kernel")
    on_cpu = Inferencer(framework="identity", device="cpu", **fold_kw)(
        chunk_u8).host().array
    require(np.array_equal(on_card.host().array, on_cpu),
            "fold identity: the card differs from the CPU port")
    del on_card, on_cpu
    fold_unet = Inferencer(framework="pytorch", model_variant="parity",
                           **fold_kw)
    fold_unet(chunk_u8)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    fold_res = fold_unet(chunk_u8)
    fold_s = time.perf_counter() - t
    fold_out = fold_res.host().array
    fold_peak = torch.cuda.max_memory_allocated()
    require(fold_out.shape == (CHANNELS,) + CHUNK
            and np.isfinite(fold_out).all(), "fold unet3d: bad output")
    uniform = Chunk(np.random.default_rng(9).integers(
        0, 256, UNIFORM, dtype=np.uint8))
    scatter_unet = Inferencer(framework="pytorch", model_variant="parity",
                              **dict(fold_kw, blend="scatter"))
    a = fold_unet(uniform).host().array
    b = scatter_unet(uniform).host().array
    fold_gap = float(np.abs(a - b).max())
    require(fold_gap <= 1e-5, f"fold vs scatter on {UNIFORM}: max abs "
                              f"{fold_gap} > 1e-5")
    phase("fold", f"identity on {CHUNK}: card == CPU port bitwise, no "
                  f"kernel launched; parity float32 on {CHUNK} (padded to "
                  f"{fold_unet._fold_geometry(CHUNK)[0]}): {fold_s:.4f} s "
                  f"to the device result, {vox / fold_s / 1e6:.3f} Mvox/s, "
                  f"peak "
                  f"memory {fold_peak / 2**30:.2f} GiB; fold vs scatter on "
                  f"the uniform {UNIFORM}: max abs {fold_gap:.3g} <= 1e-5")
    del fold_unet, scatter_unet, a, b, fold_res, fold_out

    lap("10-12 volume, chain, segment")
    # ---- 10. volume: the worker loop on disk ------------------------------
    torch.cuda.empty_cache()
    # ---- 11. chain: the README's worker chain, on phase 10's volume -------
    # ---- 12. segment: file formats and segmentation legs, on its volume --
    def chain(vol_in, image, tmp):
        torch.cuda.empty_cache()
        launched = chain_phase(
            torch, dict(volume=VOLUME, roi=CHAIN_ROI, task=TASK,
                        margin=MARGIN, out_block=OUT_BLOCK, pin=PIN,
                        overlap=OVERLAP, batch=BATCH,
                        mask_factor=MASK_FACTOR, device="cuda"),
            vol_in, image, tmp, reset_counts, counts)
        torch.cuda.empty_cache()
        for kname, n in segment_phase(
                torch, dict(chunk=CHUNK, task=TASK, pin=PIN, overlap=OVERLAP,
                            quick_batch=QUICK_BATCH, device="cuda"),
                vol_in, image, tmp, reset_counts, counts,
                plain_functions).items():
            launched[kname] += n
        return launched

    volume_s = {}  # family -> s/task from disk, for phase 17
    volume_launches, chain_launches = volume_phase(
        torch, dict(volume=VOLUME, volume_block=VOLUME_BLOCK, roi=ROI,
                    task=TASK, margin=MARGIN, out_block=OUT_BLOCK, pin=PIN,
                    overlap=OVERLAP, batch=BATCH, families=VOLUME_FAMILIES,
                    device="cuda", keep=SEGMENT_INPUT, timings=volume_s),
        weights=state, reset_counts=reset_counts, counts=counts,
        in_memory=in_memory, then=chain)
    for launched in (volume_launches, chain_launches):
        for kname, n in launched.items():
            kernels[kname]["launches"] += n

    lap("13-15 precision, packer, serve")
    # ---- 13. precision: the ladder at full width --------------------------
    torch.cuda.empty_cache()
    int8_paths = {path: 0 for path in int8_conv.path_launches}
    for run_phase in (
            lambda: precision_phase(
                torch, Chunk(chunk_u8.host().array[:PRECISION_DEPTH]),
                timer, kernels, note_err, reset_counts, counts_all),
            # ---- 14. packer: cross-request batches ------------------------
            lambda: packer_phase(torch, reset_counts, counts_all)):
        for kname, n in run_phase().items():
            if kname in kernels:
                kernels[kname]["launches"] += n
            else:
                int8_paths[kname.split()[1]] += n
        torch.cuda.empty_cache()
    # ---- 15. serve: the HTTP front end and the serve command ------------
    for kname, n in serve_phase(torch, weights, reset_counts,
                                counts_all).items():
        if kname in kernels:
            kernels[kname]["launches"] += n
        else:
            int8_paths[kname.split()[1]] += n
    torch.cuda.empty_cache()
    kernels["conv3d_int8"]["launches_by_path"] = int8_paths
    phase("precision", f"conv3d_int8 launches by path over phases 13-15: "
                       f"{int8_paths}")

    lap("16 segment-plane")
    # ---- 16. segment-plane: segment and mesh what phase 10 inferred -----
    reset_counts()
    plane_s = segment_plane_phase(torch, dict(
        input=SEGMENT_INPUT, task=TASK, device="cuda", card=card,
        queue_z=SEGMENT_QUEUE_Z, visibility=SEGMENT_VISIBILITY_S,
        mesh_ids=SEGMENT_MESH_IDS, voxel=VOXEL_NM, keep=SEGMENT_SEG))
    require(counts_all()["gather"] == counts_all()["accumulate"] == 0,
            "segment-plane: a blend kernel launched in the plane")
    phase("segment-plane", f"phase 16 took {plane_s:.1f} s; its input's "
                           f"inference launches are phase 10's")

    lap("17 encodings")
    # ---- 17. encodings: a jpeg-fed worker, sharded outputs --------------
    torch.cuda.empty_cache()
    t = time.perf_counter()
    for kname, n in encodings_phase(torch, dict(
            volume=VOLUME, roi=ROI, task=TASK, margin=MARGIN,
            out_block=OUT_BLOCK, pin=PIN, overlap=OVERLAP, batch=BATCH,
            device="cuda", shard_out=SHARD_OUT, shard_seg=SHARD_SEG,
            seg_chunk=SEG_CHUNK, seg_block=SEG_BLOCK,
            segmentation=SEGMENT_SEG, small=ENCODED_SMALL,
            worker_s=ENCODED_WORKER_S,
            raw_s_per_task=volume_s.get("parity float32")),
            weights=state, reset_counts=reset_counts,
            counts=counts).items():
        kernels[kname]["launches"] += n
    phase("encodings", f"phase 17 took {time.perf_counter() - t:.1f} s")

    lap("18 fleet")
    # ---- 18. fleet: fleet-run drains phase 10's volume through a kill -----
    # the worker processes need the host memory this one no longer uses
    gc.collect()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()  # cached pinned buffers
    t = time.perf_counter()
    fleet_phase(torch, dict(
        volume=VOLUME, volume_block=VOLUME_BLOCK, roi=ROI, task=TASK,
        margin=MARGIN, out_block=OUT_BLOCK, pin=PIN, overlap=OVERLAP,
        batch=BATCH, device="cuda", workers=FLEET_WORKERS,
        visibility=FLEET_VISIBILITY_S, runtime=FLEET_RUNTIME_S,
        inference=["--framework", "pytorch", "--model-variant", "parity",
                   "--dtype", "float32"],
        raw_s_per_task=volume_s.get("parity float32")), weights=state)
    phase("fleet", f"phase 18 took {time.perf_counter() - t:.1f} s")

    lap("19 annotations")
    # ---- 19. annotations: a synapse worker and skeletons ---------------
    torch.cuda.empty_cache()
    for kname, n in annotations_phase(torch, dict(
            volume=VOLUME, volume_block=VOLUME_BLOCK, roi=ROI, task=TASK,
            margin=MARGIN, pin=PIN, overlap=OVERLAP, batch=BATCH,
            device="cuda", segmentation=SEGMENT_SEG,
            inference=["--framework", "pytorch", "--model-variant",
                       "parity", "--dtype", "float32"],
            search_radius=SYNAPSE_RADIUS_NM, skeleton_crop=SKELETON_CROP,
            skeleton_threshold=SKELETON_VOXELS, max_paths=SKELETON_PATHS,
            raw_s_per_task=volume_s.get("parity float32")),
            weights=state, reset_counts=reset_counts,
            counts=counts).items():
        kernels[kname]["launches"] += n

    lap("20 cloud")
    # ---- 20. cloud: phase 10's worker on gs://, s3:// and sqs:// fakes ---
    torch.cuda.empty_cache()
    for kname, n in cloud_phase(torch, dict(
            volume=VOLUME, volume_block=VOLUME_BLOCK, roi=ROI, task=TASK,
            margin=MARGIN, out_block=OUT_BLOCK, pin=PIN, overlap=OVERLAP,
            batch=BATCH, device="cuda", shard_out=SHARD_OUT,
            inference=["--framework", "pytorch", "--model-variant",
                       "parity", "--dtype", "float32"],
            fail_rate=CLOUD_FAIL_RATE, visibility=CLOUD_VISIBILITY_S,
            long_poll=CLOUD_LONG_POLL_S, worker_s=CLOUD_WORKER_S,
            namespace=CLOUD_WATCH_NAMESPACE,
            raw_s_per_task=volume_s.get("parity float32")),
            weights=state, reset_counts=reset_counts,
            counts=counts).items():
        kernels[kname]["launches"] += n

    # ---- 21. checkpoints: an orbax directory on the main path -----------
    lap("21 checkpoints")
    torch.cuda.empty_cache()
    for kname, n in checkpoint_phase(torch, dict(
            chunk=chunk_u8.host().array, pin=PIN, overlap=OVERLAP,
            batch=BATCH, device="cuda", checkpoint=CHECKPOINT,
            checkpoint_zarr3=CHECKPOINT_ZARR3, blosc_store=BLOSC_STORE,
            blosc_task=BLOSC_TASK, reps=CODEC_REPS, weights=str(weights),
            stores=SAVE_STORES, store_chunks=SAVE_CHUNKS,
            created_zarray=CREATED_ZARRAY, task_encoders=TASK_ENCODERS,
            per_chunk=phase5_launches),
            state, reset_counts, counts, plain_functions).items():
        kernels[kname]["launches"] += n

    # ---- 22. mesh: the mesh engine, its shards on this card repeated ----
    lap("22 mesh")
    torch.cuda.empty_cache()
    for kname, n in mesh_phase(torch, dict(
            chunk=chunk_u8.host().array, pin=PIN, overlap=OVERLAP,
            batch=BATCH, device="cuda", card=card, runs=MESH_RUNS,
            families={
                "identity": dict(framework="identity"),
                "parity float32": dict(framework="pytorch",
                                       model_variant="parity",
                                       weight_path=str(weights)),
                "tpu_s2d4 bfloat16": dict(framework="pytorch",
                                          model_variant="tpu_s2d4",
                                          dtype="bfloat16")},
            plain_run=MESH_PLAIN_RUN, pack_family=MESH_PACK[0],
            pack_mesh=MESH_PACK[1], pack_shapes=MESH_PACK_SHAPES),
            reset_counts, counts, plain_functions).items():
        kernels[kname]["launches"] += n

    # ---- 23. multihost: one inference over a world of processes ---------
    lap("23 multihost")
    torch.cuda.empty_cache()
    for kname, n in multihost_phase(
            torch, multihost_cfg(card, chunk_u8.host().array, weights),
            reset_counts, counts).items():
        kernels[kname]["launches"] += n
    # ---- 24. tooling: contracts, the sanitizer, the cost ledger --------
    lap("24 tooling")
    torch.cuda.empty_cache()
    for kname, n in tooling_phase(torch, dict(
            chunks=ledger_chunks(np, Chunk), card=card),
            reset_counts, counts).items():
        kernels[kname]["launches"] += n
    # ---- 25. clahe, stores: the clahe plugin before inference, and the
    # sharded zarr v3 store tensorstore wrote -----------------------------
    lap("25 clahe, stores")
    torch.cuda.empty_cache()
    for kname, n in clahe_stores_phase(torch, dict(
            chunk=chunk_u8.host().array, seed=CLAHE_SEED, cases=CLAHE_CASES,
            reps=CLAHE_REPS,
            pin=PIN, overlap=OVERLAP, batch=BATCH, device="cuda",
            weights=CHECKPOINT_ZARR3, per_chunk=phase5_launches,
            store=SHARDED_STORE, checkpoint=CHECKPOINT), reset_counts,
            counts).items():
        kernels[kname]["launches"] += n
    lap("end")
    spans = {label: round(t1 - t0, 1) for (label, t0), (_, t1)
             in zip(laps[1:-1], laps[2:])}
    last = (spans["20 cloud"] + spans["21 checkpoints"] + spans["22 mesh"]
            + spans["23 multihost"])
    phase("timing", f"seconds per phase: {json.dumps(spans)}; phases 20 "
                    f"to 23 together {last:.1f} s; the script "
                    f"{laps[-1][1] - laps[0][1]:.1f} s")

    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": err[kname], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"],
         **({"launches_by_path": k["launches_by_path"]}
            if "launches_by_path" in k else {})}
        for kname, k in kernels.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def volume_phase(torch, cfg, weights, reset_counts, counts, in_memory,
                 then=None):
    """Phase 10: the queue-fed worker on local disk, as a fleet runs it.

    Writes a seeded uint8 input volume with the port's writer, creates the
    output volume and fills a ``file://`` queue with its task grid
    (``create-info``, ``generate-tasks --volume-path --queue-name``), then
    drives ``python -m chunkflow_tpu_torch fetch-task-from-queue ... |
    load-precomputed | inference | save-precomputed --async-write |
    delete-task-in-queue`` in subprocesses, for the first family: a worker
    whose inference and ack raise once (``CHUNKFLOW_CHAOS``), one
    SIGKILLed at its first commit, one that drains the rest. Each task of
    the output volume must equal, bitwise, its cutout of the input
    through ``Inferencer.__call__``, cropped (quantized as
    ``save-precomputed`` does for a uint8 volume); each task must be acked
    once (the workers' event files), the queue empty and the ledger full.
    Then every family runs fault-free in this process through the CLI's
    stages, counted, timed and traced. ``weights`` is the parity UNet3D's
    state dict, written as a ``.pt`` file for the workers. ``then(vol_in,
    image, tmp)``, when given, runs last on the same input volume. Returns
    the kernels' launches in the counted runs and what ``then``
    returned."""
    import os
    import signal
    import shutil
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import BoundingBox, Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.core.bbox import BoundingBoxes
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import process_stream
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.parallel.lifecycle import FileLedger
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    on_card = cfg["device"] == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    pin, overlap, batch, margin = (cfg["pin"], cfg["overlap"], cfg["batch"],
                                   cfg["margin"])
    roi_start, roi_size = cfg["roi"]
    chunk_in = tuple(t + 2 * m for t, m in zip(cfg["task"], margin))
    per_task = len(pad_to_batch(enumerate_patches(chunk_in, pin, pin,
                                                  overlap), batch)[0]) // batch
    boxes = list(BoundingBoxes.from_manual_setup(
        chunk_size=cfg["task"], roi_start=roi_start, roi_size=roi_size))
    vox_in = int(np.prod(chunk_in))
    total = {"gather": 0, "accumulate": 0}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def nums(triple):
        return [str(v) for v in triple]

    def triple_args(*pairs):
        out = []
        for flag, value in pairs:
            out += [flag, *nums(value)]
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_volume_") as tmp:
        tmp = Path(tmp)
        weights_pt = str(tmp / "unet3d_seed0.pt")
        torch.save(weights, weights_pt)
        # 1. the input volume, written by the port's writer
        image = np.random.default_rng(10).integers(0, 256, cfg["volume"],
                                                   dtype=np.uint8)
        vol_in = str(tmp / "image")
        t = time.perf_counter()
        PrecomputedVolume.create(vol_in, volume_size=cfg["volume"],
                                 voxel_size=VOXEL_NM,
                                 block_size=cfg["volume_block"])
        PrecomputedVolume(vol_in).save(Chunk(image, voxel_size=VOXEL_NM))
        phase("volume", f"input volume {cfg['volume']} uint8, "
                        f"{image.nbytes / 1e6:.0f} MB in blocks of "
                        f"{cfg['volume_block']}, written in "
                        f"{time.perf_counter() - t:.3f} s; {len(boxes)} "
                        f"tasks of {cfg['task']}, input {chunk_in} each "
                        f"({per_task} batches of {batch} patches)")

        def setup(family, name):
            """An output volume and a queue holding its task grid."""
            out = str(tmp / name)
            queue = f"file://{tmp}/{name}-queue"
            shutil.rmtree(tmp / f"{name}-queue", ignore_errors=True)
            require(cli.main(dev_args + [
                "create-info", "-v", out, "-c", "3", "--dtype", family[2],
                *triple_args(("--volume-size", roi_size),
                             ("--voxel-size", VOXEL_NM),
                             ("--voxel-offset", roi_start),
                             ("--block-size", cfg["out_block"]))]) == 0
                    and cli.main(dev_args + [
                        "generate-tasks", "--volume-path", out,
                        "--chunk-size", *nums(cfg["task"]),
                        "--queue-name", queue]) == 0,
                    f"volume: setting up {name} failed")
            require(len(open_queue(queue)) == len(boxes),
                    f"volume: {name}: the queue holds "
                    f"{len(open_queue(queue))} tasks, not {len(boxes)}")
            return out, queue, str(tmp / f"{name}-ledger")

        def worker_args(family, queue, ledger, out, polls, num=None):
            variant, dtype, _ = family
            fetch = ["fetch-task-from-queue", "-q", queue,
                     "--max-retries", "3", "--ledger", ledger,
                     "--visibility-timeout", str(VISIBILITY_S),
                     "--lease-renew", "1", "-r", str(polls),
                     "--poll-interval", "0.5", "--backoff-base", "0.5",
                     "--backoff-cap", "1"]
            if num is not None:
                fetch += ["--num", str(num)]
            return fetch + [
                "load-precomputed", "-v", vol_in, "-e", *nums(margin),
                "inference", "--framework", "pytorch", "--model-variant",
                variant, "--dtype", dtype,
                *(["--weight-path", weights_pt] if variant == "parity"
                  else []),
                *triple_args(("--input-patch-size", pin),
                             ("--output-patch-overlap", overlap),
                             ("--output-crop-margin", margin)),
                "--num-output-channels", "3", "--batch-size", str(batch),
                "--async-depth", "2",
                "save-precomputed", "-v", out, "--async-write",
                "delete-task-in-queue"]

        metrics = str(tmp / "events")

        def run_worker(args, chaos=None, killed=False):
            """One worker, as a user starts it; its run counters."""
            env = {k: v for k, v in os.environ.items()
                   if k != "CHUNKFLOW_CHAOS"}
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
            if chaos:
                env["CHUNKFLOW_CHAOS"] = chaos
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "chunkflow_tpu_torch", *dev_args,
                 "-v", "--metrics-dir", metrics, *args],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            wall = time.perf_counter() - t
            if killed:
                require(proc.returncode == -signal.SIGKILL,
                        f"volume: the worker was to die by SIGKILL, rc "
                        f"{proc.returncode}: {proc.stderr[-3000:]}")
                return None, wall
            require(proc.returncode == 0, f"volume: a worker failed, rc "
                                          f"{proc.returncode}: "
                                          f"{proc.stderr[-3000:]}")
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("run counters: ")]
            require(bool(line), "volume: a worker printed no counters")
            return json.loads(line[-1][len("run counters: "):]), wall

        def reference(family, inferencer, bbox):
            """The task's output through Inferencer.__call__, cropped, as
            the output volume stores it."""
            src = bbox.adjust(margin)
            got = inferencer(Chunk(image[src.slices], voxel_offset=src.start,
                                   voxel_size=VOXEL_NM))
            arr = got.crop_margin(margin).host().array
            if family[2] == "uint8":
                arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
            return arr

        def check_volume(refs, out, what):
            vol = PrecomputedVolume(out)
            for bbox, ref in zip(boxes, refs):
                got = vol.cutout(bbox).array
                require(got.shape == ref.shape and np.array_equal(got, ref),
                        f"volume: {what}: task {bbox.string} differs from "
                        f"its in-process reference")

        for family in cfg["families"]:
            variant, dtype, out_dtype = family
            label = f"{variant} {dtype}"
            ref_inf = Inferencer(
                input_patch_size=pin, output_patch_overlap=overlap,
                num_output_channels=3, framework="pytorch",
                model_variant=variant, dtype=dtype, batch_size=batch,
                weight_path=weights_pt if variant == "parity" else None,
                device=cfg["device"])
            refs = [reference(family, ref_inf, bbox) for bbox in boxes]
            del ref_inf
            if family == cfg["families"][0]:
                # the fleet: a raised fault, a SIGKILL, a resume
                out, queue, ledger = setup(family, "chaos")
                w1, t1 = run_worker(
                    worker_args(family, queue, ledger, out, 30, num=3),
                    chaos="once=scheduler/dispatch,lifecycle/pre_ack")
                _, t2 = run_worker(
                    worker_args(family, queue, ledger, out, 30),
                    chaos="once=lifecycle/pre_ledger:action=kill",
                    killed=True)
                # worker 3 takes what is not in the ledger and ends with
                # its last commit, not after a tail of empty polls
                left = len(boxes) - len(FileLedger(ledger).keys())
                w3, t3 = run_worker(worker_args(family, queue, ledger, out,
                                                3 * VISIBILITY_S, num=left))
                stats = open_queue(queue).stats()
                require(stats["pending"] == stats["inflight"]
                        == stats["dead"] == 0,
                        f"volume: the queue did not drain: {stats}")
                keys = FileLedger(ledger).keys()
                require(sorted(keys) == sorted(b.string for b in boxes),
                        f"volume: the ledger holds {len(keys)} keys")
                acks = {b.string: 0 for b in boxes}
                for event in metrics_events(metrics):
                    if event.get("name") in ("lifecycle/committed",
                                             "lifecycle/ledger_skip"):
                        acks[event["body"]] += 1
                require(set(acks.values()) == {1},
                        f"volume: acks per task {acks}, not one each")
                require(w1.get("chaos/injected") == 2,
                        f"volume: worker 1 injected "
                        f"{w1.get('chaos/injected')} faults, not 2")
                for w in (w1, w3):
                    n = w.get("inference/chunks", 0)
                    for kname in ("gather", "accumulate"):
                        require(not on_card
                                or w[f"kernels/{kname}"] == per_task * n,
                                f"volume: a worker launched {kname} "
                                f"{w[f'kernels/{kname}']} times for {n} "
                                f"computed tasks, not {per_task} each")
                check_volume(refs, out, "the fleet's volume")
                phase("volume", f"{label}: worker 1 (inference and ack "
                                f"raise once, --num 3) {t1:.1f} s: "
                                f"{_brief(w1)}; worker 2 SIGKILLed at its "
                                f"first commit after {t2:.1f} s; worker 3 "
                                f"(--num {left}) {t3:.1f} s: {_brief(w3)}")
                phase("volume", f"{label}: output volume == in-process "
                                f"reference bitwise on all {len(boxes)} "
                                f"tasks; each task acked once; queue "
                                f"{stats}; ledger {len(keys)} keys; "
                                f"{per_task} launches of each kernel per "
                                f"computed task")
                shutil.rmtree(out)
            # fault-free, in this process: counted and timed, then traced
            out, queue, ledger = setup(family, f"{variant}-run")
            _, stages = cli.build_stages(dev_args + worker_args(
                family, queue, ledger, out, 0))
            telemetry.reset()
            reset_counts()
            sync()
            t = time.perf_counter()
            n = process_stream(stages)
            sync()
            wall = time.perf_counter() - t
            launched = counts()
            snap = telemetry.snapshot()
            require(n == len(boxes), f"volume: {label}: {n} tasks drained")
            for kname, k in launched.items():
                require(not on_card or k == per_task * len(boxes),
                        f"volume: {label}: {kname} launched {k} times, not "
                        f"{per_task * len(boxes)}")
                total[kname] += k
            check_volume(refs, out, f"{label} fault-free")
            if cfg.get("keep") and family == cfg["families"][0]:
                # phase 16's input: channel 0 over the roi
                roi = BoundingBox(roi_start, tuple(
                    a + b for a, b in zip(roi_start, roi_size)))
                np.save(cfg["keep"], np.ascontiguousarray(
                    PrecomputedVolume(out).cutout(roi).array[0]))
            shutil.rmtree(out)

            def mean_ms(name):
                h = snap["hists"].get(name)
                return h["mean"] * 1e3 if h else 0.0

            idle = None
            if on_card:
                def traced():
                    setup(family, f"{variant}-run")
                    shutil.rmtree(ledger, ignore_errors=True)
                    process_stream(stages)
                idle = _idle_share(_device_trace(torch, traced))
                shutil.rmtree(out)
            memory = in_memory.get(label) if in_memory else None
            if "timings" in cfg:
                cfg["timings"][label] = wall / len(boxes)
            phase("volume", f"{label}: {len(boxes)} tasks read from disk, "
                            f"{wall / len(boxes):.4f} s/task, "
                            f"{vox_in * len(boxes) / wall / 1e6:.3f} Mvox/s "
                            f"of input; phase 8's in-memory stream "
                            + (f"{memory:.4f} s/chunk, "
                               f"{vox_in / memory / 1e6:.3f} Mvox/s"
                               if memory else "not run")
                            + f"; launches {launched}")
            phase("volume", f"{label}: host ms per task: cutout "
                            f"{mean_ms('op/load-precomputed'):.1f} (block "
                            f"reads {mean_ms('storage/read'):.1f}), save "
                            f"{mean_ms('op/save-precomputed'):.1f} (of which "
                            f"copying and queueing the block writes "
                            f"{mean_ms('storage/write'):.1f}), ack "
                            f"{mean_ms('lifecycle/commit'):.1f} (the wait "
                            f"for durable writes, the ledger, the delete); "
                            f"compute idle "
                            + (f"{idle:.1%}" if idle is not None
                               else "not measured")
                            + " (profiler trace of a fault-free run)")
            del refs, stages
        after = then(vol_in, image, tmp) if then is not None else None
    return total, after


def chain_phase(torch, cfg, vol_in, image, tmp, reset_counts, counts):
    """Phase 11: the README's production worker chain through the port's
    CLI, in process, on phase 10's input volume (then once more with
    ``prefetch --to-device``)::

        fetch-task-from-queue | load-precomputed -e 4 64 64 | prefetch |
        normalize-contrast | inference -f flax --model-variant tpu
        -d bfloat16 ... | crop-margin | mask -v MASK |
        save-precomputed --async-write | delete-task-in-queue

    ``tpu`` at full width in bfloat16, its seeded weights carried through
    the flax layout by ``models/convert.py:state_from_flax``; MASK a seeded
    uint8 volume at 40x64x64 nm (1x16x16 over the image) with a zeroed
    block, and task starts off its grid. Holds: 18 + 18 launches per
    task, the saved volume bitwise the same chain composed in process from
    the library calls, each task acked once; on one task's full-size
    affinity map, the card leg of every operator with one bitwise its CPU
    leg; the identity engine through the whole chain on the card bitwise
    the CPU port on one task. Prints s/task, Mvox/s, the host ms of each
    new ``op/<name>`` span and the compute idle share. Returns the
    kernels' launches in the counted run."""
    import os
    import shutil

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.chunk import AffinityMap, Image
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.core.bbox import BoundingBoxes
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import process_stream
    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.models.convert import state_from_flax
    from chunkflow_tpu_torch.ops import threshold
    from chunkflow_tpu_torch.ops.mask import maskout
    from chunkflow_tpu_torch.parallel.lifecycle import FileLedger
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    dev = cfg["device"]
    on_card = dev == "cuda"
    pin, overlap, batch, margin = (cfg["pin"], cfg["overlap"], cfg["batch"],
                                   cfg["margin"])
    roi_start, roi_size = cfg["roi"]
    chunk_in = tuple(t + 2 * m for t, m in zip(cfg["task"], margin))
    per_task = len(pad_to_batch(enumerate_patches(chunk_in, pin, pin,
                                                  overlap), batch)[0]) // batch
    boxes = list(BoundingBoxes.from_manual_setup(
        chunk_size=cfg["task"], roi_start=roi_start, roi_size=roi_size))
    vox_in = int(np.prod(chunk_in))

    def nums(triple):
        return [str(v) for v in triple]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # the tpu model's seeded weights, through the flax layout and back
    tpu_state = engines.create_engine("pytorch",
                                      model_variant="tpu").model.state_dict()
    weights = str(tmp / "tpu_seed0.pt")
    torch.save(state_from_flax(_flax_layout(tpu_state)), weights)
    del tpu_state

    # the mask volume: 1 x 16 x 16 over the image, a zeroed block
    factor = cfg["mask_factor"]
    mask_nm = tuple(v * f for v, f in zip(VOXEL_NM, factor))
    mask_arr = (np.random.default_rng(11).random(
        tuple(s // f for s, f in zip(cfg["volume"], factor))) > 0.2).astype(
        np.uint8)
    zeroed = (slice(32, 64), slice(16, 32), slice(16, 32))
    mask_arr[zeroed] = 0
    vol_mask = str(tmp / "mask")
    PrecomputedVolume.create(vol_mask, volume_size=mask_arr.shape,
                             voxel_size=mask_nm, block_size=(32, 16, 16))
    PrecomputedVolume(vol_mask).save(Chunk(mask_arr, voxel_size=mask_nm))
    mask_chunk = Chunk(mask_arr, voxel_size=mask_nm)
    off_grid = [b.string for b in boxes
                if any(s % f for s, f in zip(b.start, factor))]
    require(bool(off_grid), "chain: no task starts off the mask's grid")
    blanked = sum(np.any(mask_arr[tuple(
        slice(s // f, -(-e // f)) for s, e, f in zip(b.start, b.stop, factor))]
        == 0) for b in boxes)

    def setup(name, bbox=None):
        """An output volume, and a fresh queue (and ledger) holding the
        roi's tasks or ``bbox``'s."""
        out = str(tmp / name)
        queue = f"file://{tmp}/{name}-queue"
        for stale in (f"{name}-queue", f"{name}-ledger"):
            shutil.rmtree(tmp / stale, ignore_errors=True)
        start, size = ((roi_start, roi_size) if bbox is None
                       else (tuple(bbox.start), tuple(bbox.shape)))
        require(cli.main([
            "create-info", "-v", out, "-c", "3", "--dtype", "float32",
            "--volume-size", *nums(roi_size), "--voxel-size",
            *nums(VOXEL_NM), "--voxel-offset", *nums(roi_start),
            "--block-size", *nums(cfg["out_block"])]) == 0
                and cli.main([
                    "generate-tasks", "--chunk-size", *nums(cfg["task"]),
                    "--roi-start", *nums(start), "--roi-size", *nums(size),
                    "--queue-name", queue]) == 0,
                f"chain: setting up {name} failed")
        return out, queue, str(tmp / f"{name}-ledger")

    def chain(queue, ledger, out, engine, device=dev,
              prefetch=("prefetch",)):
        return ["--device", device, "fetch-task-from-queue", "-q", queue,
                "--max-retries", "3", "--ledger", ledger, "-r", "0",
                "load-precomputed", "-v", vol_in, "-e", *nums(margin),
                *prefetch, "normalize-contrast",
                "inference", *engine, "-p", *nums(pin), "-v", *nums(overlap),
                "-c", "3", "-b", str(batch),
                "crop-margin", "mask", "-v", vol_mask,
                "save-precomputed", "-v", out, "--async-write",
                "delete-task-in-queue"]

    tpu = ["-f", "flax", "--model-variant", "tpu", "-d", "bfloat16", "-w",
           weights]

    def counted(name, **kwargs):
        """One counted, timed run of the tpu chain into a fresh volume:
        (its volume, wall s, launches, host ms per span)."""
        metrics = str(tmp / f"{name}-events")
        out, queue, ledger = setup(name)
        _, stages = cli.build_stages(chain(queue, ledger, out, tpu,
                                           **kwargs))
        telemetry.reset()
        telemetry.configure(metrics)
        reset_counts()
        sync()
        t = time.perf_counter()
        try:
            n = process_stream(stages)
        finally:
            sync()
            wall = time.perf_counter() - t
            telemetry.configure(None)
        launched = counts()
        hists = telemetry.snapshot()["hists"]
        require(n == len(boxes), f"chain: {n} tasks drained, not "
                                 f"{len(boxes)}")
        for kname, k in launched.items():
            require(not on_card or k == per_task * len(boxes),
                    f"chain: {kname} launched {k} times, not {per_task} "
                    f"per task ({per_task * len(boxes)})")
        stats = open_queue(queue).stats()
        require(stats["pending"] == stats["inflight"] == stats["dead"] == 0,
                f"chain: the queue did not drain: {stats}")
        require(sorted(FileLedger(ledger).keys())
                == sorted(b.string for b in boxes),
                "chain: the ledger is short")
        acks = {b.string: 0 for b in boxes}
        for event in metrics_events(metrics):
            if event.get("name") in ("lifecycle/committed",
                                     "lifecycle/ledger_skip"):
                acks[event["body"]] += 1
        require(set(acks.values()) == {1}, f"chain: acks per task {acks}")
        spans = {key: h["mean"] * 1e3 for key, h in hists.items()}
        return out, wall, launched, spans

    out, wall, launched, spans = counted("chain")

    # the same chain composed in process from the library calls
    ref_inf = Inferencer(input_patch_size=pin, output_patch_overlap=overlap,
                         num_output_channels=3, framework="flax",
                         model_variant="tpu", dtype="bfloat16",
                         batch_size=batch, weight_path=weights, device=dev)
    refs = []
    first_aff = first_in = None
    for bbox in boxes:
        src = bbox.adjust(margin)
        img = Image(image[src.slices], voxel_offset=src.start,
                    voxel_size=VOXEL_NM).normalize_contrast()
        aff = ref_inf(img).cutout(bbox)
        if first_aff is None:
            first_aff, first_in = aff, image[src.slices]
        refs.append(maskout(aff, mask_chunk, device=dev).host().array)
    del ref_inf

    def check(out, what):
        vol = PrecomputedVolume(out)
        for bbox, ref in zip(boxes, refs):
            got = vol.cutout(bbox).array
            require(got.shape == ref.shape and np.array_equal(got, ref),
                    f"chain: {what}: task {bbox.string} differs from the "
                    f"library composition")

    def host_ms(spans):
        return ", ".join(f"{name} {spans.get('op/' + name, 0.0):.1f}"
                         for name in ("load-precomputed",
                                      "normalize-contrast", "inference",
                                      "crop-margin", "mask",
                                      "save-precomputed")) \
            + f", ack {spans.get('lifecycle/commit', 0.0):.1f}"

    check(out, "the README chain")
    phase("chain", f"tpu bfloat16 through the README chain: {len(boxes)} "
                   f"tasks of {cfg['task']} (input {chunk_in}), "
                   f"{wall / len(boxes):.4f} s/task, "
                   f"{vox_in * len(boxes) / wall / 1e6:.3f} Mvox/s of input; "
                   f"launches {launched} ({per_task} + {per_task} per task); "
                   f"output == the library composition bitwise on every "
                   f"task; each task acked once; {len(off_grid)} tasks start "
                   f"off the mask's {factor} grid, {blanked} meet the "
                   f"zeroed block")
    phase("chain", f"host ms per task: {host_ms(spans)}")

    def traced():
        shutil.rmtree(out)
        o, q, lg = setup("chain")
        process_stream(cli.build_stages(chain(q, lg, o, tpu))[1])

    if on_card:
        idle = _idle_share(_device_trace(torch, traced))
        phase("chain", f"compute idle {idle:.1%} (profiler trace of a "
                       f"second run)")
    shutil.rmtree(out)

    # the same chain with the image staged to the card by prefetch: the
    # normalization takes its card leg (bitwise the host leg)
    out, wall_d, launched_d, spans_d = counted(
        "chain-to-device", prefetch=("prefetch", "--to-device"))
    check(out, "prefetch --to-device")
    shutil.rmtree(out)
    for kname, n in launched_d.items():
        launched[kname] += n
    del refs
    phase("chain", f"the same chain with prefetch --to-device: "
                   f"{wall_d / len(boxes):.4f} s/task, "
                   f"{vox_in * len(boxes) / wall_d / 1e6:.3f} Mvox/s; output "
                   f"== the library composition bitwise; host ms per task: "
                   f"{host_ms(spans_d)}")

    # every operator's card leg against its CPU leg, at full size
    aff_card = first_aff
    aff_host = aff_card.host()
    checks = []

    def held(name, card_fn, host_fn):
        sync()
        t0 = time.perf_counter()
        card = card_fn()
        sync()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = host_fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        got = card.host().array
        want = np.asarray(host.array)
        require(got.dtype == want.dtype and got.shape == want.shape
                and np.array_equal(got, want),
                f"chain: {name}: the card leg differs from the CPU leg")
        checks.append(f"{name} {card_ms:.1f} vs {host_ms:.1f}")

    held("maskout", lambda: maskout(aff_card, mask_chunk, device=dev),
         lambda: maskout(aff_host, mask_chunk, device="cpu"))
    held("channel_voting", lambda: aff_card.channel_voting(device=dev),
         lambda: aff_host.channel_voting(device="cpu"))
    held("threshold", lambda: threshold.threshold(aff_card, 0.5),
         lambda: threshold.threshold(aff_host, 0.5))
    for mode in ("xy", "z"):
        held(f"quantize {mode}",
             lambda: AffinityMap(aff_card).quantize(mode),
             lambda: AffinityMap(aff_host).quantize(mode))
    held("multiply", lambda: aff_card * aff_card,
         lambda: aff_host * aff_host)
    img_card = Image(torch.from_numpy(first_in.copy()).to(dev))
    img_host = Image(first_in)
    for per_section in (True, False):
        label = "per section" if per_section else "whole"
        held(f"normalize_contrast {label} (affinity map)",
             lambda: Image(aff_card).normalize_contrast(
                 per_section=per_section),
             lambda: Image(aff_host).normalize_contrast(
                 per_section=per_section))
        held(f"normalize_contrast {label} ({chunk_in} uint8)",
             lambda: img_card.normalize_contrast(per_section=per_section),
             lambda: img_host.normalize_contrast(per_section=per_section))
    phase("chain", f"card leg == CPU leg bitwise on a {tuple(aff_card.shape)} "
                   f"affinity map and its {chunk_in} input; card vs CPU "
                   f"ms: " + "; ".join(checks))
    del aff_card, aff_host, img_card, img_host, first_aff

    # the identity engine through the whole chain: card == CPU port
    one = boxes[0]
    vols = {}
    for device in (dev, "cpu"):
        o, q, lg = setup(f"identity-{device}", bbox=one)
        require(cli.main(chain(q, lg, o, ["-f", "identity"], device)) == 0,
                f"chain: the identity chain on {device} failed")
        vols[device] = PrecomputedVolume(o).cutout(one).array.copy()
        shutil.rmtree(o)
    require(np.array_equal(vols[dev], vols["cpu"])
            and vols["cpu"].std() > 0.01,
            "chain: the identity chain on the card differs from the CPU "
            "port")
    phase("chain", f"identity engine through the chain on task "
                   f"{one.string}: card == CPU port bitwise")
    return launched


def segment_phase(torch, cfg, vol_in, image, tmp, reset_counts, counts,
                  plain_functions):
    """Phase 12: the chunk file formats and the segmentation legs, through
    the port's CLI, in process, on the card.

    a. The README's quick start as it types it (plus flax-layout weights,
       as phase 11): ``load-h5 -f image.h5 | inference --framework flax
       --model-variant tpu --dtype bfloat16 --input-patch-size 20 256 256
       --output-patch-overlap 4 64 64 --batch-size 4 | save-h5 -f
       affinity.h5`` on the seeded 64x512x512 ``sin`` chunk: 9 + 9
       launches; the file == ``Inferencer.__call__`` on the same card
       input bitwise, and == the same call under ``plain_functions``
       (every kernel replaced by its plain version, 0 launches) bitwise.
       Without h5py the same chain runs through ``load-npy``/``save-npy``,
       and says so.
    b. ``load-h5 -f affinity.h5 --channels 0 | connected-components -t T
       | downsample -f 1 2 2 | save-h5`` with ``--device`` (label
       propagation on the card) and ``--host`` (the native union-find),
       T the channel's 70th percentile: the card labels == the CPU device
       leg (the unique fixpoint: each component's smallest linear index +
       1, read off the host labels; and the CPU leg itself on a slab), the
       host labels isomorphic, the card's mode pool == its CPU leg.
    c. On phase 10's volume: ``gaussian-filter -s 1`` of a 64x512x512
       cutout staged to the card (card leg == CPU leg), ``downsample-upload``
       into a 4-mip volume, ``load-precomputed --validate-mip 2`` on it, and
       ``save-precomputed --create-thumbnail`` into another: every mip's
       blocks == the library composition on the CPU.
    d. h5, tif, png, nrrd, mrc and zarr (zlib) round trips of a 56x384x384
       uint8 image and a 3x56x384x384 float32 map (its channel 0 through
       the single-channel formats), written from a card chunk and from a
       host chunk: bitwise, with the offset and voxel size each format
       keeps. MB/s each way.

    Returns the kernels' launches in the counted run (a)."""
    import importlib.util
    import shutil

    import numpy as np

    from chunkflow_tpu_torch import BoundingBox, Chunk, _build, native
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import new_task, process_stream
    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.models.convert import state_from_flax
    from chunkflow_tpu_torch.ops import connected_components as cc
    from chunkflow_tpu_torch.ops.downsample import downsample, pyramid
    from chunkflow_tpu_torch.ops.filters import gaussian_filter_2d
    from chunkflow_tpu_torch.segment.merge_table import labels_isomorphic
    from chunkflow_tpu_torch.volume import io_mrc, io_nrrd, io_png
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume
    from chunkflow_tpu_torch.volume.zarr import ZarrArray

    dev = cfg["device"]
    on_card = dev == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    chunk_shape = cfg["chunk"]
    has_h5 = importlib.util.find_spec("h5py") is not None
    has_pil = importlib.util.find_spec("PIL") is not None
    d = tmp / "formats"
    d.mkdir(exist_ok=True)
    pin, overlap, batch = cfg["pin"], cfg["overlap"], cfg["quick_batch"]
    per_chunk = len(pad_to_batch(enumerate_patches(chunk_shape, pin, pin,
                                                   overlap), batch)[0]) // batch
    vox = int(np.prod(chunk_shape))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def nums(triple):
        return [str(v) for v in triple]

    def run(argv, what):
        """One counted, timed CLI run: (wall s, launches, host ms per
        op span)."""
        _, stages = cli.build_stages([*dev_args, *argv])
        telemetry.reset()
        telemetry.configure(str(d / "events"))
        reset_counts()
        sync()
        t = time.perf_counter()
        try:
            n = process_stream(stages)
        finally:
            sync()
            wall = time.perf_counter() - t
            telemetry.configure(None)
        require(n == 1, f"segment: {what} ran {n} tasks, not 1")
        hists = telemetry.snapshot()["hists"]
        return wall, counts(), {k[3:]: h["mean"] * 1e3
                                for k, h in hists.items()
                                if k.startswith("op/")}

    def spans_text(spans, names):
        return ", ".join(f"{n} {spans.get(n, 0.0):.1f}" for n in names)

    # ---- a. the quick start ---------------------------------------------
    weights = tmp / "tpu_seed0.pt"
    if not weights.exists():
        tpu_state = engines.create_engine(
            "pytorch", model_variant="tpu").model.state_dict()
        torch.save(state_from_flax(_flax_layout(tpu_state)), weights)
    sin = Chunk.create(size=chunk_shape, dtype=np.uint8, pattern="sin",
                       voxel_size=VOXEL_NM)
    if has_h5:
        load, save, ext = "load-h5", "save-h5", "h5"
        sin.to_h5(str(d / "image.h5"))
    else:
        load, save, ext = "load-npy", "save-npy", "npy"
        sin.to_npy(str(d / "image.npy"))
    quick = [load, "-f", str(d / f"image.{ext}"),
             "inference", "--framework", "flax", "--model-variant", "tpu",
             "--dtype", "bfloat16", "--input-patch-size", *nums(pin),
             "--output-patch-overlap", *nums(overlap),
             "--batch-size", str(batch), "-w", str(weights),
             save, "-f", str(d / f"affinity.{ext}")]
    # warm-up: the engine's first forward
    process_stream(cli.build_stages([*dev_args, *quick])[1])
    wall, launched, spans = run(quick, "the quick start")
    for kname, n in launched.items():
        require(not on_card or n == per_chunk,
                f"quick start: {kname} launched {n} times, not {per_chunk}")
    read = (Chunk.from_h5 if has_h5 else Chunk.from_npy)
    got = read(str(d / f"affinity.{ext}"))
    ref_inf = Inferencer(input_patch_size=pin, output_patch_overlap=overlap,
                         num_output_channels=3, framework="flax",
                         model_variant="tpu", dtype="bfloat16",
                         batch_size=batch, weight_path=str(weights),
                         device=dev)
    source = read(str(d / f"image.{ext}"))
    ref_inf(source)  # warm-up
    sync()
    t = time.perf_counter()
    ref = ref_inf(source).host()
    infer_s = time.perf_counter() - t
    # the same card input through the plain versions: the kernels held
    # at the quick start's batch and shapes, not only against themselves
    reset_counts()
    with plain_functions():
        plain = ref_inf(source).host()
    plain_launched = counts()
    del ref_inf
    require(not any(plain_launched.values()),
            f"quick start: the plain path launched {plain_launched}")
    require(got.array.shape == (3,) + chunk_shape
            and np.isfinite(got.array).all()
            and np.array_equal(got.array, ref.array),
            "quick start: the file differs from Inferencer.__call__")
    require(np.array_equal(got.array, plain.array),
            "quick start: the file differs from the plain path, max abs "
            f"{float(np.abs(got.array - plain.array).max())}")
    phase("segment", f"quick start ({'' if has_h5 else 'h5py missing: '}"
                     f"{load} | inference tpu bfloat16 batch {batch} | "
                     f"{save}) on {chunk_shape} uint8: {wall:.4f} s per chunk, "
                     f"{vox / wall / 1e6:.3f} Mvox/s (Inferencer.__call__ "
                     f"warm, with its download, {infer_s:.4f} s); launches "
                     f"{launched} ({per_chunk} + {per_chunk}); the file == "
                     f"Inferencer.__call__ bitwise, == the plain path (0 "
                     f"launches) bitwise; host ms: "
                     + spans_text(spans, (load, "inference", save)))

    # ---- b. segmentation of that output ---------------------------------
    t = time.perf_counter()
    built = not _build.library_path(_build.HOST_LIBRARY).exists()
    native.load()
    build_s = time.perf_counter() - t
    affinity = np.ascontiguousarray(got.array[0])
    thr = float(np.quantile(affinity, 0.7))
    fg = affinity > np.float32(thr)
    if has_h5:
        seg_in = [load, "-f", str(d / f"affinity.{ext}"), "--channels", "0"]
    else:  # load-npy has no --channels: the channel as its own file
        np.save(d / "affinity0.npy", affinity)
        seg_in = [load, "-f", str(d / "affinity0.npy"), "--voxel-size",
                  *nums(VOXEL_NM)]
    legs = {}
    for leg in ("--device", "--host"):
        tag = leg.lstrip("-")
        argv = [*seg_in, "connected-components", "-t", repr(thr), leg,
                "-o", "seg", save, "-i", "seg", "-f",
                str(d / f"labels-{tag}.{ext}"),
                "downsample", "-f", "1", "2", "2", "-i", "seg", "-o", "down",
                save, "-i", "down", "-f", str(d / f"down-{tag}.{ext}")]
        cc.sweeps = 0
        wall, _, spans = run(argv, f"segmentation {leg}")
        legs[tag] = dict(wall=wall, spans=spans, sweeps=cc.sweeps,
                         labels=np.asarray(read(
                             str(d / f"labels-{tag}.{ext}")).array),
                         down=np.asarray(read(
                             str(d / f"down-{tag}.{ext}")).array))
    card, host = legs["device"]["labels"], legs["host"]["labels"]
    n_comp = int(host.max())
    # the device leg's unique fixpoint: each component's smallest linear
    # index + 1, read off the host labels
    first = np.full(n_comp + 1, np.iinfo(np.int64).max, dtype=np.int64)
    flat = host.ravel()
    np.minimum.at(first, flat, np.arange(flat.size, dtype=np.int64))
    oracle = np.where(flat > 0, first[flat] + 1, 0).astype(
        np.uint32).reshape(host.shape)
    require(card.dtype == np.uint32 and np.array_equal(card, oracle),
            "segment: the card labels differ from the device leg's "
            "fixpoint")
    require(labels_isomorphic(card, host) and np.array_equal(host > 0, fg),
            "segment: the host labels are not isomorphic to the card's")
    # the CPU device leg itself, on a slab, against the card leg
    slab = torch.from_numpy(np.ascontiguousarray(fg[:8, :256, :256]))
    cc.sweeps = 0
    slab_card = cc.label_binary_device(slab.to(dev)).cpu()
    slab_sweeps = cc.sweeps
    require(torch.equal(slab_card, cc.label_binary_device(slab)),
            "segment: the card leg differs from the CPU leg on a slab")
    down_cpu = downsample(Chunk(torch.from_numpy(card),
                                layer_type="segmentation"), (1, 2, 2))
    require(np.array_equal(legs["device"]["down"], down_cpu.array.numpy())
            and np.array_equal(legs["host"]["down"], downsample(
                Chunk(host, layer_type="segmentation"), (1, 2, 2)).array),
            "segment: the mode pool's card leg differs from its CPU leg")
    phase("segment", f"connected-components of channel 0 at T {thr:.6g} "
                     f"(foreground {fg.mean():.1%}): {n_comp} components; "
                     f"--device {legs['device']['spans']['connected-components']:.1f} "
                     f"ms in {legs['device']['sweeps']} sweeps, --host "
                     f"{legs['host']['spans']['connected-components']:.1f} ms "
                     f"(native build {build_s:.2f} s, "
                     f"{'built' if built else 'cached'}); card labels == "
                     f"the device leg's fixpoint bitwise, == the CPU leg on "
                     f"a {tuple(slab.shape)} slab ({slab_sweeps} sweeps), host "
                     f"labels isomorphic; downsample (mode pool) card == "
                     f"CPU leg bitwise; host ms per leg: "
                     + "; ".join(f"{tag} " + spans_text(
                         leg["spans"], (load, "connected-components", save,
                                        "downsample"))
                         for tag, leg in legs.items()))

    # ---- c. the pyramid on phase 10's volume ----------------------------
    box = BoundingBox((0, 0, 0), chunk_shape)
    pyr, thumb = str(d / "pyramid"), str(d / "thumbnail")
    for path in (pyr, thumb):
        require(cli.main([
            "create-info", "-v", path, "--volume-size", *nums(chunk_shape),
            "--voxel-size", *nums(VOXEL_NM), "--block-size", "16", "64",
            "64", "--max-mip", "3", "--factor", "1", "2", "2"]) == 0,
            f"segment: create-info {path}")
    cut = ["load-precomputed", "-v", vol_in, "--chunk-start", "0", "0", "0",
           "--chunk-size", *nums(chunk_shape), "prefetch", "--to-device",
           "gaussian-filter", "-s", "1"]
    wall_p, _, spans_p = run([*cut, "save-precomputed", "-v", pyr,
                              "--no-upload-log", "downsample-upload", "-v",
                              pyr], "downsample-upload")
    wall_v, _, spans_v = run(["load-precomputed", "-v", pyr, "--chunk-start",
                              "0", "0", "0", "--chunk-size",
                              *nums(chunk_shape),
                              "--validate-mip", "2"], "--validate-mip")
    wall_t, _, spans_t = run([*cut, "save-precomputed", "-v", thumb,
                              "--no-upload-log", "--create-thumbnail"],
                             "--create-thumbnail")
    raw = image[box.slices]
    blur_card = gaussian_filter_2d(Chunk(torch.from_numpy(raw).to(dev)), 1.0)
    sync()
    t = time.perf_counter()
    blur_card = gaussian_filter_2d(Chunk(torch.from_numpy(raw).to(dev)), 1.0)
    sync()
    card_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    blur_cpu = gaussian_filter_2d(Chunk(torch.from_numpy(raw)), 1.0)
    cpu_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    gaussian_filter_2d(Chunk(raw), 1.0)  # the host leg: scipy
    scipy_ms = (time.perf_counter() - t) * 1e3
    require(torch.equal(blur_card.array.cpu(), blur_cpu.array),
            "segment: the gaussian's card leg differs from its CPU leg")
    levels = [Chunk(blur_cpu.array.numpy(), voxel_size=VOXEL_NM)]
    levels += pyramid(levels[0], num_mips=3)
    for path in (pyr, thumb):
        vol = PrecomputedVolume(path)
        for mip, level in enumerate(levels):
            stored = vol.cutout(level.bbox, mip=mip).array
            require(np.array_equal(stored, level.array),
                    f"segment: {path} mip {mip} differs from the library "
                    f"composition")
    phase("segment", f"pyramid of a {chunk_shape} cutout of phase 10's volume, "
                     f"blurred on the card (gaussian card == CPU leg "
                     f"bitwise; {card_ms:.1f} ms card, {cpu_ms:.1f} ms CPU "
                     f"torch, {scipy_ms:.1f} ms scipy): downsample-upload "
                     f"{wall_p:.3f} s, --validate-mip 2 passed {wall_v:.3f} "
                     f"s, --create-thumbnail {wall_t:.3f} s; 4 mips of both "
                     f"volumes == the library composition bitwise; host ms: "
                     + spans_text({**spans_p, **{
                         "validate " + k: v for k, v in spans_v.items()},
                         **{"thumbnail " + k: v for k, v in spans_t.items()}},
                         ("gaussian-filter", "downsample-upload",
                          "validate load-precomputed",
                          "thumbnail save-precomputed")))

    # ---- d. every format round trip at task size ------------------------
    t0 = (4, 64, 64)
    task = tuple(min(a, b) for a, b in zip(cfg["task"], chunk_shape))
    sel = tuple(slice(o, o + n) for o, n in zip(t0, task))
    img = Chunk(np.ascontiguousarray(image[sel]), voxel_offset=t0,
                voxel_size=VOXEL_NM)
    amap = Chunk(np.ascontiguousarray(got.array[(slice(None),) + sel]),
                 voxel_offset=t0, voxel_size=VOXEL_NM)
    ch0 = Chunk(np.ascontiguousarray(amap.array[0]), voxel_offset=t0,
                voxel_size=VOXEL_NM)
    rates, missing = [], []

    def trip(name, chunk, write, read_back, keeps):
        """Write from the card and from the host, read back, hold the
        array (bitwise; mrc widens uint8 to float32) and what the format
        ``keeps`` of the offset and the voxel size."""
        mb = chunk.array.nbytes / 1e6
        for side in ("card", "host"):
            src = chunk.device(dev) if side == "card" else chunk
            sync()
            t = time.perf_counter()
            write(src)
            w = time.perf_counter() - t
            t = time.perf_counter()
            back = read_back()
            r = time.perf_counter() - t
            arr = np.asarray(back.array)
            require(arr.shape == chunk.array.shape
                    and (arr.dtype == chunk.array.dtype or name.startswith("mrc"))
                    and np.array_equal(arr, chunk.array),
                    f"formats: {name} round trip from the {side} differs")
            if "offset" in keeps:
                require(tuple(back.voxel_offset) == t0,
                        f"formats: {name} lost the voxel offset")
            if "size" in keeps:
                require(tuple(back.voxel_size) == VOXEL_NM,
                        f"formats: {name} lost the voxel size")
        rates.append(f"{name} {chunk.array.dtype} {mb / w:.0f}/{mb / r:.0f}")

    def nrrd(path):
        def write(c):
            io_nrrd.save_nrrd(path, c.array, voxel_size=tuple(c.voxel_size),
                              voxel_offset=tuple(c.voxel_offset))

        def read_back():
            arr, header = io_nrrd.load_nrrd(path)
            if arr.ndim == 4:  # NRRD's spacings and offset are per axis
                return Chunk(arr)
            return Chunk(arr, voxel_offset=[int(o) for o in header[
                "chunkflow voxel offset"].split()],
                voxel_size=[float(v) for v in reversed(
                    header["spacings"].split())])
        return write, read_back

    def mrc(path):
        def write(c):
            io_mrc.save_mrc(path, c.array, voxel_size_nm=tuple(c.voxel_size),
                            voxel_offset=tuple(c.voxel_offset))

        def read_back():
            arr, header = io_mrc.load_mrc(path)
            return Chunk(arr, voxel_offset=header["voxel_offset"],
                         voxel_size=header["voxel_size_nm"])
        return write, read_back

    def zarr(path):
        def write(c):
            shutil.rmtree(path, ignore_errors=True)
            stage = cli.build_stages([*dev_args, "save-zarr", "-p",
                                      path])[1][0]
            seed = new_task()
            seed["chunk"] = c
            list(stage(iter([seed])))

        def read_back():
            box = BoundingBox(t0, tuple(o + n for o, n in zip(t0, task)))
            return Chunk(ZarrArray(path).read(box.slices), voxel_offset=t0)
        return write, read_back

    def pngs(path):
        def write(c):
            shutil.rmtree(path, ignore_errors=True)
            io_png.save_pngs(c, path)

        def read_back():
            return io_png.load_pngs(path, voxel_offset=t0)
        return write, read_back

    for label, chunk in (("image", img), ("map", amap), ("map[0]", ch0)):
        stem = str(d / label.replace("[", "").replace("]", ""))
        if has_h5:
            trip(f"h5 {label}", chunk,
                 lambda c, p=f"{stem}.h5": c.to_h5(p),
                 lambda p=f"{stem}.h5": Chunk.from_h5(p), ("offset", "size"))
        trip(f"nrrd {label}", chunk, *nrrd(f"{stem}.nrrd"),
             ("offset", "size") if chunk.ndim == 3 else ())
        if chunk.ndim == 4:
            continue  # the formats below hold one channel, in both packages
        trip(f"mrc {label}", chunk, *mrc(f"{stem}.mrc"), ("offset", "size"))
        trip(f"zarr {label}", chunk, *zarr(f"{stem}.zarr"), ())
        if has_pil:
            trip(f"tif {label}", chunk,
                 lambda c, p=f"{stem}.tif": c.to_tif(p),
                 lambda p=f"{stem}.tif": Chunk.from_tif(p), ())
            if label == "image":  # PNG holds no float map
                trip(f"png {label}", chunk, *pngs(f"{stem}-png"), ())
    if not has_h5:
        missing.append("h5 (no h5py)")
    if not has_pil:
        missing.append("tif and png (no Pillow)")
    phase("segment", f"format round trips of a {img.shape} uint8 image and "
                     f"a {amap.shape} float32 map (channel 0 through the "
                     f"single-channel formats), each written from a card "
                     f"chunk and from a host chunk: bitwise (mrc writes "
                     f"uint8 as float32), offsets and voxel sizes kept "
                     f"where the format holds them (h5, nrrd, mrc); MB/s "
                     f"write/read: " + ", ".join(rates)
                     + (f"; not run: {', '.join(missing)}" if missing
                        else ""))
    shutil.rmtree(d)
    return launched


def precision_phase(torch, chunk, timer, kernels, note_err, reset_counts,
                    counts_all):
    """Phase 13: the precision ladder at full width (module docstring).
    Fills the int8 kernel's numbers in ``kernels``; returns the launches
    of the counted runs (each real-leg chunk)."""
    import os

    import numpy as np
    import torch.nn.functional as F

    from chunkflow_tpu_torch.inference import engines, precision
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.ops import gather, int8_conv

    dev = torch.device("cuda")
    zyx = tuple(chunk.shape[-3:])
    vox = int(np.prod(zyx))
    gen = torch.Generator().manual_seed(13)

    def randint8(shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    # a) the kernel against its plain version on every shape class, the
    # input as the quantize pass lays it out and as a plain NCDHW tensor;
    # the Hopper path's weight pack against its plain version
    paths = {}
    for xs, ws, stride, padding, dilation in INT8_CLASSES:
        x = randint8(xs)
        w = randint8(ws)
        want = int8_conv.conv3d_int8_plain(x, w, stride, padding, dilation)
        for given in (int8_conv.channels_last_padded(x), x):
            note_err("conv3d_int8", int8_conv.conv3d_int8(
                given, w, stride, padding, dilation), want)
        p = int8_conv.plan(xs, ws, stride, padding, dilation)
        paths[p.path] = paths.get(p.path, 0) + 1
        if p.path == "hopper":
            note_err("conv3d_int8", int8_conv.pack_weights(w, p),
                     int8_conv.pack_weights_plain(w.cpu(), p).to(dev))
    a = randint8((3000, 72))
    b = randint8((72, 224))
    note_err("conv3d_int8", int8_conv.matmul_int8(a, b),
             (a.double() @ b.double()).to(torch.int32))
    torch.cuda.synchronize()
    phase("precision", f"conv3d_int8 == plain bitwise on "
                       f"{len(INT8_CLASSES)} shape classes (paths "
                       f"{paths}; the real leg's padded channels-last "
                       f"input and a plain NCDHW one), the Hopper weight "
                       f"pack == its plain version, and the GEMM "
                       f"upsample's product")

    # b) the kernel's time, bound, plain time and cuDNN's on the integer
    # grid (float32, exact below 2^24; under the engine's scope) at the
    # two timed shapes, the Hopper kernel against the generic one in
    # turns (generic, hopper, hopper, generic)
    for label, xs, ws in INT8_TIMED:
        # the operands as the real leg lays them out
        x = int8_conv.channels_last_padded(randint8(xs))
        w = randint8(ws).contiguous(memory_format=torch.channels_last_3d)
        ab = int8_ab(timer, x, w, (1, 1), turns=True)
        plain_ms = timer.event_ms(
            lambda: int8_conv.conv3d_int8_plain(x, w, 1, 1), 3)
        phase("precision", f"conv3d_int8 at {label} {xs} x {ws}: "
                           f"{ab['line']}; plain (float64 cuDNN) "
                           f"{plain_ms:.3f} ms")
        if label == INT8_TIMED[0][0]:
            kernels["conv3d_int8"].update(
                ms=ab["op_ms"], plain_ms=plain_ms, bound_ms=ab["bound_ms"],
                bound_by=ab["bound_by"], library_ms=ab["library_ms"])
        del x, w

    # c) every family at every leg, on the chunk given
    grid = enumerate_patches(zyx, PIN, PIN, OVERLAP)
    in_starts, _, _ = pad_to_batch(grid, BATCH)
    n_batches = len(in_starts) // BATCH
    raw = torch.from_numpy(np.asarray(chunk.array)[None].copy()).to(dev)
    patches = gather.gather_patches(raw, torch.from_numpy(in_starts[:BATCH]),
                                    PIN)
    del raw
    kw = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
              num_output_channels=CHANNELS, framework="pytorch",
              batch_size=BATCH)
    launched_total = {}
    saved_leg = os.environ.get("CHUNKFLOW_INT8")

    def build(variant, prec, leg, dtype="float32"):
        if leg is None:
            os.environ.pop("CHUNKFLOW_INT8", None)
        else:
            os.environ["CHUNKFLOW_INT8"] = leg
        inf = Inferencer(model_variant=variant, precision=prec, dtype=dtype,
                         **kw)
        with torch.no_grad():
            inf._forward(patches)  # warm-up: the forward's first launches
        torch.cuda.synchronize()
        return inf

    def fwd(inf):
        with torch.no_grad():
            return inf._forward(patches)

    def run(inf, label, leg, ref):
        """One counted chunk; its numbers; returns the device result."""
        reset_counts()
        t = time.perf_counter()
        out = inf(chunk).array
        wall = time.perf_counter() - t
        launched = counts_all()
        require(tuple(out.shape) == (CHANNELS,) + zyx
                and bool(torch.isfinite(out).all()),
                f"precision {label}: output not finite maps of the chunk")
        n8 = launched["conv3d_int8"]
        if leg == "real":
            require(n8 > 0, f"precision {label}: conv3d_int8 never launched")
            for name, n in launched.items():
                launched_total[name] = launched_total.get(name, 0) + n
        else:
            require(n8 == 0, f"precision {label}: {n8} int8 launches")
        fwd_ms = timer.call_ms(lambda: fwd(inf), reps=2)
        line = (f"{label}: {wall:.4f} s/chunk, {vox / wall / 1e6:.3f} "
                f"Mvox/s, forward {fwd_ms:.2f} ms/batch (device), launches "
                f"{launched}")
        if ref is not None:
            diff = (out - ref).abs()
            mx, mean = float(diff.max()), float(diff.mean())
            line += f"; vs float32 max abs {mx:.4g}, mean abs {mean:.4g}"
            if leg is None:
                gate = PRECISION_GATES["bfloat16"][1]
                require(mean <= gate, f"precision {label}: mean abs {mean} "
                                      f"vs float32 > {gate}")
                line += f" (mean held <= {gate})"
        phase("precision", line)
        return out, fwd_ms

    # a crop of the chunk, for the card against the CPU port
    crop = torch.from_numpy(np.asarray(chunk.array)[tuple(
        slice(s, s + n) for s, n in zip(BF16_CROPS[1], CROP))][None, None]
        .astype(np.float32) * np.float32(1 / 255))

    def against_cpu(inf, cpu_engine, prec, label, f32_crop, leg):
        """The card's forward on the crop against the CPU port's at the
        same leg, and its gap to float32. ``fake`` quantizes only the
        inputs and parameters, identically on both: held as a float
        forward (FAKE_CARD_CPU). ``real`` quantizes every activation,
        where the last bit of a float op upstream can move an integer
        level (up to ~0.05 at a voxel): held to the JAX mean gate."""
        with torch.no_grad():
            on_card = inf._apply(crop.to(dev)).cpu()
            on_cpu = precision.wrap_apply(cpu_engine.apply, prec,
                                          cpu_engine.params,
                                          cpu_engine.call)(crop)
        gap = (on_card - on_cpu).abs()
        mx, mean = float(gap.max()), float(gap.mean())
        if leg == "fake":
            held = f"max held <= {FAKE_CARD_CPU}"
            require(mx <= FAKE_CARD_CPU, f"precision {label}: card vs CPU "
                                         f"on a crop, max abs {mx}")
        else:
            gate = PRECISION_GATES["int8"][1]
            held = f"mean held <= {gate}"
            require(mean <= gate, f"precision {label}: card vs CPU on a "
                                  f"crop, mean abs {mean}")
        to32 = (on_card - f32_crop).abs()
        phase("precision", f"{label}: one 8x64x64 crop, card vs the CPU "
                           f"port max abs {mx:.4g}, mean abs {mean:.4g} "
                           f"({held}); vs float32 max abs "
                           f"{float(to32.max()):.4g}, mean abs "
                           f"{float(to32.mean()):.4g}")

    for variant in PRECISION_FAMILIES:
        outs = {}
        cpu_engine = engines.create_engine("pytorch", model_variant=variant)
        for prec, leg in PRECISION_LEGS:
            inf = build(variant, prec, leg)
            label = f"{variant} {leg or prec}"
            outs[leg or prec], fwd_ms = run(inf, label, leg,
                                            outs.get("float32"))
            if leg is None and prec == "float32":
                require(all(torch.equal(a.cpu(), b) for a, b in zip(
                    inf.engine.model.state_dict().values(),
                    cpu_engine.model.state_dict().values())),
                    f"precision {variant}: the CPU engine's weights differ")
                with torch.no_grad():
                    f32_crop = inf._apply(crop.to(dev)).cpu()
            if leg in ("fake", "real"):
                against_cpu(inf, cpu_engine, prec, label, f32_crop, leg)
            if leg != "real":
                del inf
                continue
            model = inf.engine.model
            # the largest |sum| of the full-width run, then real == fakeint
            top = []
            kernel = int8_conv.conv3d_int8

            def tracked(*args):
                acc = kernel(*args)
                top.append(acc.abs().max())
                return acc

            with mock.patch.object(int8_conv, "conv3d_int8", tracked):
                again = inf(chunk).array
            largest = int(torch.stack(top).max())
            require(torch.equal(again, outs["real"]),
                    f"precision {label}: two real runs differ")
            if largest < EXACT_F32_SUM:
                require(torch.equal(outs["real"], outs["fakeint"]),
                        f"precision {variant}: real differs from fakeint "
                        f"with sums below 2^24 (largest {largest})")
            # one batch through the kernel and through the plain version
            with torch.no_grad():
                got = inf._apply(patches)
                with mock.patch.object(int8_conv, "conv3d_int8",
                                       int8_conv.conv3d_int8_plain):
                    ref = inf._apply(patches)
            note_err("conv3d_int8", got, ref)
            # the kernel's and the quantize pass's share of the forward,
            # replayed at the shapes one real forward gives the kernel
            shapes = []

            def record(x, w, *args):
                shapes.append((tuple(x.shape), tuple(w.shape), args))
                return kernel(x, w, *args)

            with mock.patch.object(int8_conv, "conv3d_int8", record):
                fwd(inf)
            xs = {s: int8_conv.channels_last_padded(randint8(s))
                  for s, _, _ in shapes}
            ws = {s: randint8(s).contiguous(
                memory_format=torch.channels_last_3d) for _, s, _ in shapes}
            fs = {s: torch.rand(s, device=dev) for s in xs}
            kernel_ms = timer.call_ms(lambda: [
                int8_conv.conv3d_int8(xs[x], ws[w], *args)
                for x, w, args in shapes], reps=3)

            def quantize(unpadded=False):
                for x, _, _ in shapes:
                    q, _ = precision._quant_rows_axis(fs[x], 0)
                    if unpadded:  # the copy without the pitch
                        q.to(torch.int8,
                             memory_format=torch.channels_last_3d)
                    else:
                        precision._int8(q)

            quant_ms = timer.call_ms(quantize, reps=3)
            quant_unpadded_ms = timer.call_ms(lambda: quantize(True), reps=3)
            if variant in INT8_AB_FAMILIES:
                # every distinct layer shape: the Hopper kernel against
                # the generic one, its bound and cuDNN float32 on the grid
                faster = [0, 0]  # the kernel, the op, against generic
                distinct = list(dict.fromkeys(shapes))
                for x, w, args in distinct:
                    ab = int8_ab(timer, xs[x], ws[w], args)
                    faster[0] += ab["ms"] < ab["generic_ms"]
                    faster[1] += ab["op_ms"] < ab["generic_ms"]
                    phase("precision", f"{variant} layer {x} x {w} "
                                       f"{args}: {ab['line']}")
                phase("precision", f"{variant}: faster than the generic "
                                   f"kernel "
                                   f"at {faster[0]} of {len(distinct)} "
                                   f"layer shapes (the Hopper kernel), "
                                   f"{faster[1]} (its op: weight pack and "
                                   f"kernel)")
            del xs, ws, fs
            ops = conv_flops(model, patches)
            phase("precision", f"{label}: largest |sum| {largest} "
                               f"({'<' if largest < EXACT_F32_SUM else '>='} "
                               f"2^24: real == fakeint "
                               f"{'held bitwise' if largest < EXACT_F32_SUM else 'not held'}); "
                               f"one batch through the kernel == through "
                               f"the plain version (float64), bitwise; "
                               f"{len(shapes)} int8 launches/batch = "
                               f"{len(shapes) * n_batches}/chunk; kernel "
                               f"{kernel_ms:.2f} ms/batch "
                               f"({kernel_ms / fwd_ms:.1%} of the forward), "
                               f"quantize pass {quant_ms:.2f} ms/batch "
                               f"({quant_ms / fwd_ms:.1%}; with an "
                               f"unpadded int8 copy {quant_unpadded_ms:.2f}); "
                               f"{ops / fwd_ms / 1e9:.1f} TOP/s, "
                               f"{ops / fwd_ms / 1e9 / (PEAK_INT8 / 1e12):.1%}"
                               f" of the int8 peak")
            del inf, model, got, ref, again
        del outs, cpu_engine
        torch.cuda.empty_cache()

    # d) tpu on a bfloat16 engine at int8 real (the README chain's -d
    # bfloat16 with CHUNKFLOW_PRECISION=int8 CHUNKFLOW_INT8=real)
    base = build("tpu", "float32", None, "bfloat16")
    reference, _ = run(base, "tpu bf16 engine float32", None, None)
    with torch.no_grad():
        f32_crop = base._apply(crop.to(dev)).cpu()
    del base
    real = build("tpu", "int8", "real", "bfloat16")
    run(real, "tpu bf16 engine real", "real", reference)
    against_cpu(real, engines.create_engine(
        "pytorch", model_variant="tpu", dtype="bfloat16"), "int8",
        "tpu bf16 engine real", f32_crop, "real")
    del real, reference, patches
    if saved_leg is None:
        os.environ.pop("CHUNKFLOW_INT8", None)
    else:
        os.environ["CHUNKFLOW_INT8"] = saved_leg
    return launched_total


def int8_ab(timer, x, w, args, turns=False):
    """One int8 layer shape on the card, each time between CUDA events
    with the L2 flushed (in this script's full runs the profiler traced
    none of these calls in phase 13): the Hopper kernel alone (weights
    packed, output zeroed beforehand), the whole op (weight pack, split-K
    zeroing and kernel), the generic kernel alone on the same operands,
    the bound ``max(2 MACs / int8 peak, bytes / bandwidth)`` and cuDNN
    float32 on the integer grid, each operand NCDHW or channels-last,
    whichever is fastest (the yardstick; the port never calls it).
    ``turns``: generic, hopper, hopper, generic."""
    import torch
    import torch.nn.functional as F

    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.ops import int8_conv

    p = int8_conv.plan(x.shape, w.shape, *args)
    shape = int8_conv.output_shape(x.shape, w.shape, *args)
    out_el = math.prod(shape)
    macs = out_el * math.prod(w.shape[1:])
    nbytes = x.numel() + w.numel() + 4 * out_el
    t_ops = 2 * macs / PEAK_INT8 * 1e3
    t_bytes = nbytes / PEAK_BW * 1e3
    wpack = int8_conv.pack_weights(w, p)
    wc = int8_conv.generic_weights(w)
    out = torch.zeros(shape, dtype=torch.int32, device=x.device)
    reps = 15 if turns else 5

    def hopper():
        int8_conv.hopper_kernel(x, wpack, p, out)

    def generic():
        int8_conv.generic_kernel(x, wc, out, *args)

    g = [timer.event_ms(generic, 3)]
    h = [timer.event_ms(hopper, reps)]
    if turns:
        h.append(timer.event_ms(hopper, reps))
        g.append(timer.event_ms(generic, 3))
    op_ms = timer.event_ms(lambda: int8_conv.conv3d_int8(x, w, *args), reps)
    library_ms = math.inf
    formats = (torch.contiguous_format, torch.channels_last_3d)
    for x_fmt, w_fmt in ((a, b) for a in formats for b in formats):
        xf = x.float().contiguous(memory_format=x_fmt)
        wf = w.float().contiguous(memory_format=w_fmt)

        def library():
            with engines.exact_float32():
                F.conv3d(xf, wf, None, *args)

        library_ms = min(library_ms, timer.event_ms(library, 3))
        del xf, wf
    bound = max(t_ops, t_bytes)
    ms = statistics.median(h)
    line = (f"Hopper kernel {', '.join(f'{v:.4f}' for v in h)} ms "
            f"({bound / ms:.1%} of bound; bn {p.bn} x {p.n_tiles}, tile "
            f"{p.bt}x{p.dt}x{p.ht}x{p.wt}, {p.m_tiles} M tiles, split-K "
            f"{p.splits}, {p.gx * p.n_tiles * p.splits} blocks, weights "
            f"{'resident' if p.resident else 'streamed'}, {p.smem} B "
            f"shared), op {op_ms:.4f} ms; the generic kernel "
            f"{', '.join(f'{v:.4f}' for v in g)} ms; bound {bound:.4f} ms "
            f"({macs / 1e9:.3f} G MACs = {t_ops:.4f} ms, "
            f"{nbytes / 1e6:.1f} MB = {t_bytes:.4f} ms); cuDNN float32 "
            f"{library_ms:.4f} ms")
    return {"ms": ms, "op_ms": op_ms, "generic_ms": statistics.median(g),
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "line": line}


def packer_phase(torch, reset_counts, counts_all):
    """Phase 14: the PatchPacker (module docstring); returns the launches
    of the packed runs."""
    import os
    import threading

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.serve import packer as packer_mod

    rng = np.random.default_rng(14)
    chunks = [Chunk(rng.integers(0, 256, s, dtype=np.uint8),
                    voxel_offset=(100 * i, 0, 0))
              for i, s in enumerate(PACK_SHAPES)]
    vox = sum(int(np.prod(s)) for s in PACK_SHAPES)
    saved_leg = os.environ.get("CHUNKFLOW_INT8")
    launched_total = None
    for prec, leg in (("float32", None), ("int8", "real")):
        if leg is None:
            os.environ.pop("CHUNKFLOW_INT8", None)
        else:
            os.environ["CHUNKFLOW_INT8"] = leg
        label = f"tpu bf16 batch {PACK_BATCH} {leg or prec}"
        inf = Inferencer(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                         num_output_channels=CHANNELS, framework="pytorch",
                         model_variant="tpu", dtype="bfloat16",
                         precision=prec, batch_size=PACK_BATCH)
        inf(chunks[0]).host()  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        refs = [inf(c).host().array for c in chunks]
        one_by_one = time.perf_counter() - t
        packer = packer_mod.PatchPacker(inf, max_wait_ms=5.0)
        packer.infer(chunks[0], timeout=300).host()  # the dispatcher's start
        telemetry.reset()
        flavours = []
        plain = packer_mod.accumulate.fused_accumulate_patches

        def counted(*args, pre_weighted=False):
            flavours.append(pre_weighted)
            return plain(*args, pre_weighted=pre_weighted)

        results = [None] * len(chunks)

        def submitter(k):
            handles = [(i, packer.submit(chunks[i]))
                       for i in range(k, len(chunks), PACK_THREADS)]
            for i, handle in handles:
                results[i] = handle.result(timeout=600).host().array

        with mock.patch.object(packer_mod.accumulate,
                               "fused_accumulate_patches", counted):
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            threads = [threading.Thread(target=submitter, args=(k,))
                       for k in range(PACK_THREADS)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
            packed = time.perf_counter() - t
            launched = counts_all()
        packer.close()
        require(all(r is not None for r in results),
                f"packer {label}: a request got no result")
        require(all(np.array_equal(r, ref) for r, ref in zip(results, refs)),
                f"packer {label}: a packed result differs from its "
                f"Inferencer.__call__")
        require(flavours and all(flavours) and launched["accumulate"] > 0,
                f"packer {label}: no pre-weighted accumulate launched")
        require((launched["conv3d_int8"] > 0) == (leg == "real"),
                f"packer {label}: conv3d_int8 launches {launched}")
        counters = telemetry.snapshot()["counters"]
        batches = int(counters.get("serving/batches", 0))
        patches = int(counters.get("serving/packed_patches", 0))
        filler = int(counters.get("serving/filler_slots", 0))
        per_chunk = sum(-(-int(np.prod(inf.patch_grid_shape(s)))
                          // PACK_BATCH) for s in PACK_SHAPES)
        phase("packer", f"{label}: {len(chunks)} requests from "
                        f"{PACK_THREADS} threads, every result == its "
                        f"Inferencer.__call__ bitwise; {batches} batches "
                        f"(one by one: {per_chunk}), {patches} patches, "
                        f"{filler} filler slots, occupancy "
                        f"{patches / max(1, batches * PACK_BATCH):.1%}; "
                        f"pre-weighted accumulate in {len(flavours)} calls; "
                        f"launches {launched}")
        phase("packer", f"{label}: packed {packed:.4f} s = "
                        f"{len(chunks) / packed:.2f} requests/s, "
                        f"{vox / packed / 1e6:.3f} Mvox/s; one by one "
                        f"{one_by_one:.4f} s = {len(chunks) / one_by_one:.2f}"
                        f" requests/s, {vox / one_by_one / 1e6:.3f} Mvox/s")
        if launched_total is None:
            launched_total = launched
        else:
            launched_total = {k: launched_total[k] + n
                              for k, n in launched.items()}
        del inf, packer, refs, results
        torch.cuda.empty_cache()
    if saved_leg is None:
        os.environ.pop("CHUNKFLOW_INT8", None)
    else:
        os.environ["CHUNKFLOW_INT8"] = saved_leg
    return launched_total


# phase 15's client process: it makes phase 15's requests from the same
# seed, posts them from PACK_THREADS threads, and reports each answer's
# SHA-256 and its host times (a remote user's process, so its JSON and
# base64 work do not share the server's interpreter)
SERVE_CLIENT = r"""
import base64, hashlib, json, sys, threading, time
import urllib.error, urllib.request
import numpy as np

args = json.loads(sys.argv[1])
rng = np.random.default_rng(args["seed"])
raws = [rng.integers(0, 256, s, dtype=np.uint8) for s in args["shapes"]]
out = [None] * len(raws)


def call(i):
    t = time.perf_counter()
    body = json.dumps({
        "shape": list(raws[i].shape), "dtype": "uint8",
        "data_b64": base64.b64encode(raws[i].tobytes()).decode(),
        "voxel_offset": args["offsets"][i], "deadline_s": 600.0}).encode()
    encode = time.perf_counter() - t
    req = urllib.request.Request(
        "http://127.0.0.1:%d/infer" % args["port"], data=body, method="POST")
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    send = time.perf_counter() - t
    t = time.perf_counter()
    payload = json.loads(raw)
    data = (base64.b64decode(payload["data_b64"]) if status == 200
            else b"")
    decode = time.perf_counter() - t
    out[i] = {"status": status, "error": payload.get("error"),
              "shape": payload.get("shape"), "dtype": payload.get("dtype"),
              "sha256": hashlib.sha256(data).hexdigest(),
              "encode_s": encode, "send_s": send, "decode_s": decode}


def caller(k):
    for i in range(k, len(raws), args["threads"]):
        call(i)


t = time.perf_counter()
threads = [threading.Thread(target=caller, args=(k,))
           for k in range(args["threads"])]
for thread in threads:
    thread.start()
for thread in threads:
    thread.join()
print(json.dumps({"wall_s": time.perf_counter() - t, "requests": out,
                  "inputs": [hashlib.sha256(r.tobytes()).hexdigest()
                             for r in raws]}))
"""


def http_clients(port):
    """Phase 15's requests from a client process; its report."""
    args = json.dumps({"port": port, "seed": SERVE_SEED,
                       "shapes": [list(s) for s in PACK_SHAPES],
                       "offsets": [[100 * i, 0, 0]
                                   for i in range(len(PACK_SHAPES))],
                       "threads": PACK_THREADS})
    proc = subprocess.run([sys.executable, "-c", SERVE_CLIENT, args],
                          capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0, f"serve: the client process failed: "
                                  f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def serve_phase(torch, weights, reset_counts, counts_all):
    """Phase 15: the serving front end (module docstring); returns the
    launches of the HTTP runs."""
    import base64
    import hashlib
    import os
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import slo, telemetry
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.parallel.restapi import (
        bound_port,
        parse_prometheus,
        serving_stats,
        shutdown_server,
    )
    from chunkflow_tpu_torch.serve import packer as packer_mod
    from chunkflow_tpu_torch.serve.frontend import (
        AdmissionController,
        LocalBackend,
        ServingService,
        start_serving,
    )

    rng = np.random.default_rng(SERVE_SEED)
    raws = [rng.integers(0, 256, s, dtype=np.uint8) for s in PACK_SHAPES]
    offsets = [(100 * i, 0, 0) for i in range(len(raws))]
    vox = sum(int(np.prod(s)) for s in PACK_SHAPES)
    saved = {k: os.environ.get(k)
             for k in ("CHUNKFLOW_PRECISION", "CHUNKFLOW_INT8")}
    tmp = Path(tempfile.mkdtemp(prefix="serve-", dir=OUT_DIR))
    slo_path = tmp / "slo.toml"
    slo_path.write_text(SERVE_SLO_TOML)

    def body(i, deadline_s=600.0):
        return json.dumps({
            "shape": list(raws[i].shape), "dtype": "uint8",
            "data_b64": base64.b64encode(raws[i].tobytes()).decode(),
            "voxel_offset": list(offsets[i]), "deadline_s": deadline_s,
        }).encode()

    def post(port, data):
        """(status, JSON payload) of one ``POST /infer``."""
        req = urllib.request.Request(f"http://127.0.0.1:{port}/infer",
                                     data=data, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    def decode(payload):
        return np.frombuffer(base64.b64decode(payload["data_b64"]),
                             dtype=payload["dtype"]).reshape(
            payload["shape"])

    def get(port, route):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=60) as resp:
            require(resp.status == 200, f"serve: GET {route} {resp.status}")
            return resp.read()

    def pct(values, q):
        return float(np.percentile(np.asarray(values), q))

    def span_s(before, after, name):
        """Seconds in the span ``name`` between two snapshots."""
        return sum(sign * snap["hists"].get(name, {"total": 0.0})["total"]
                   for sign, snap in ((1, after), (-1, before)))

    launched_total = cli_ref = None
    try:
        for prec, leg in (("float32", None), ("int8", "real")):
            os.environ["CHUNKFLOW_PRECISION"] = prec
            if leg is None:
                os.environ.pop("CHUNKFLOW_INT8", None)
            else:
                os.environ["CHUNKFLOW_INT8"] = leg
            label = f"parity f32 engine batch {PACK_BATCH} {leg or prec}"
            # what `serve -f flax -w W -p 20 256 256 --output-patch-overlap
            # 4 64 64 -c 3 -b 4` builds
            inf = Inferencer(input_patch_size=PIN,
                             output_patch_overlap=OVERLAP,
                             num_output_channels=CHANNELS, framework="flax",
                             weight_path=str(weights), batch_size=PACK_BATCH)
            require(inf.precision == prec,
                    f"serve {label}: precision {inf.precision}")
            chunks = [Chunk(r, voxel_offset=o) for r, o in zip(raws, offsets)]
            inf(chunks[0]).host()  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            refs = [inf(c).host().array for c in chunks]
            one_by_one = time.perf_counter() - t

            # the in-process packer on the same model and requests
            packer = packer_mod.PatchPacker(inf, max_wait_ms=2.0)
            packer.infer(chunks[0], timeout=600).host()
            results = [None] * len(chunks)

            def submitter(k):
                handles = [(i, packer.submit(chunks[i]))
                           for i in range(k, len(chunks), PACK_THREADS)]
                for i, handle in handles:
                    results[i] = handle.result(timeout=600).host().array

            t = time.perf_counter()
            threads = [threading.Thread(target=submitter, args=(k,))
                       for k in range(PACK_THREADS)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
            in_process = time.perf_counter() - t
            packer.close()
            require(all(np.array_equal(r, ref)
                        for r, ref in zip(results, refs)),
                    f"serve {label}: an in-process packed result differs")

            # the front end on a real listener, under the SLO plane
            telemetry.reset()
            telemetry.configure(str(tmp / f"metrics-{leg or prec}"))
            evaluator = slo.start_slo(str(slo_path),
                                      pyproject=str(tmp / "none.toml"))
            require(evaluator is not None, "serve: no SLO evaluator")
            backend = LocalBackend(inf, workers=SERVE_WORKERS,
                                   max_wait_ms=2.0)
            service = ServingService(
                backend,
                admission=AdmissionController(SERVE_MAX_INFLIGHT),
                default_deadline_s=600.0)
            server = start_serving(service, host="127.0.0.1", port=0)
            port = bound_port(server)
            flavours = []
            plain = packer_mod.accumulate.fused_accumulate_patches

            def counted(*args, pre_weighted=False):
                flavours.append(pre_weighted)
                return plain(*args, pre_weighted=pre_weighted)

            try:
                status, _ = post(port, body(0))  # the dispatcher's start
                require(status == 200, f"serve {label}: warm-up {status}")
                bodies = [body(0)]
                with mock.patch.object(packer_mod.accumulate,
                                       "fused_accumulate_patches", counted):
                    before = telemetry.snapshot()
                    torch.cuda.synchronize()
                    reset_counts()
                    report = http_clients(port)
                    launched = counts_all()
                    after = telemetry.snapshot()
                over_http = report["wall_s"]
                require(report["inputs"] == [
                    hashlib.sha256(r.tobytes()).hexdigest() for r in raws],
                    f"serve {label}: the client made other requests")
                for i, got in enumerate(report["requests"]):
                    require(got["status"] == 200,
                            f"serve {label}: request {i} answered "
                            f"{got['status']}: {got['error']}")
                    require(got["shape"] == list(refs[i].shape)
                            and got["dtype"] == refs[i].dtype.name
                            and got["sha256"] == hashlib.sha256(
                                refs[i].tobytes()).hexdigest(),
                            f"serve {label}: response {i} differs from its "
                            f"Inferencer.__call__")
                client = {k: [r[k] for r in report["requests"]]
                          for k in ("send_s", "encode_s", "decode_s")}
                require(flavours and all(flavours)
                        and launched["gather"] > 0
                        and launched["accumulate"] > 0,
                        f"serve {label}: launches {launched}, "
                        f"{len(flavours)} accumulate calls "
                        f"({flavours.count(False)} not pre-weighted)")
                require((launched["conv3d_int8"] > 0) == (leg == "real"),
                        f"serve {label}: conv3d_int8 launches {launched}")
                counters = {k: after["counters"].get(k, 0)
                            - before["counters"].get(k, 0)
                            for k in after["counters"]}
                require(counters.get("serving/fallbacks", 0) == 0
                        and counters.get("serving/completed") == len(raws),
                        f"serve {label}: counters {counters}")

                # what the host spent per request, apart from the compute
                n = len(raws)
                ms = {name: span_s(before, after, f"serving/{name}") * 1e3 / n
                      for name in ("decode", "encode", "request", "forward",
                                   "scatter")}
                batches = int(counters.get("serving/batches", 0))
                patches = int(counters.get("serving/packed_patches", 0))
                filler = int(counters.get("serving/filler_slots", 0))
                latency = after["qhists"]["serving/latency"]
                p50 = telemetry.quantile_from_buckets(latency, 0.5)
                p99 = telemetry.quantile_from_buckets(latency, 0.99)
                phase("serve", f"{label}: {n} requests over HTTP from "
                               f"{PACK_THREADS} threads of a client "
                               f"process, {SERVE_WORKERS} lifecycle "
                               f"workers: every response == its "
                               f"Inferencer.__call__ bitwise (SHA-256 of "
                               f"its bytes); launches {launched}; "
                               f"pre-weighted accumulate in "
                               f"{len(flavours)} calls; {batches} batches, "
                               f"{patches} patches, {filler} filler slots, "
                               f"occupancy "
                               f"{patches / max(1, batches * PACK_BATCH):.1%}")
                phase("serve", f"{label}: over HTTP {over_http:.4f} s = "
                               f"{n / over_http:.2f} requests/s, "
                               f"{vox / over_http / 1e6:.3f} Mvox/s; "
                               f"in-process packer {in_process:.4f} s = "
                               f"{n / in_process:.2f} requests/s, "
                               f"{vox / in_process / 1e6:.3f} Mvox/s; one "
                               f"by one {one_by_one:.4f} s = "
                               f"{n / one_by_one:.2f} requests/s, "
                               f"{vox / one_by_one / 1e6:.3f} Mvox/s")
                phase("serve", f"{label}: latency client p50 "
                               f"{pct(client['send_s'], 50):.4f} s, p99 "
                               f"{pct(client['send_s'], 99):.4f} s; "
                               f"serving/latency p50 {p50:.4f} s, p99 "
                               f"{p99:.4f} s (bucket estimates)")
                phase("serve", f"{label}: host ms per request: server "
                               f"decode {ms['decode']:.1f}, encode (download"
                               f", base64, JSON) {ms['encode']:.1f}, "
                               f"request span {ms['request']:.1f} of which "
                               f"the packer's forward {ms['forward']:.1f} "
                               f"and scatter {ms['scatter']:.1f} (summed "
                               f"over its batches); client encode "
                               f"{1e3 * sum(client['encode_s']) / n:.1f}, "
                               f"decode (JSON, base64) "
                               f"{1e3 * sum(client['decode_s']) / n:.1f}")

                # the door: a burst past a bound of two, and a deadline
                service.admission.max_inflight = 2
                gate = threading.Barrier(SERVE_BURST)
                burst = []

                def burster():
                    gate.wait()
                    status, payload = post(port, bodies[0])
                    arr = decode(payload) if status == 200 else None
                    burst.append((status, payload.get("reason"), arr))

                threads = [threading.Thread(target=burster)
                           for _ in range(SERVE_BURST)]
                for thread in threads:
                    thread.start()
                for thread in threads:
                    thread.join()
                service.admission.max_inflight = SERVE_MAX_INFLIGHT
                shed = [r for s_, r, _ in burst if s_ == 429]
                require(shed and all(r == "inflight" for r in shed),
                        f"serve {label}: burst statuses "
                        f"{[(s_, r) for s_, r, _ in burst]}")
                require(all(np.array_equal(a, refs[0])
                            for s_, _, a in burst if s_ == 200),
                        f"serve {label}: a burst response differs")
                status, _ = post(port, body(0, deadline_s=0.001))
                require(status == 504, f"serve {label}: a 0.001 s deadline "
                                       f"answered {status}")
                phase("serve", f"{label}: a burst of {SERVE_BURST} past an "
                               f"in-flight bound of 2: {len(shed)} x 429 "
                               f"inflight, {SERVE_BURST - len(shed)} x 200 "
                               f"bitwise; deadline 0.001 s: 504")

                # the observability routes on the same listener
                text = get(port, "/metrics").decode()
                flat = parse_prometheus(text)
                stats = serving_stats(text)
                require("chunkflow_serving_latency_count" in flat
                        and stats is not None
                        and stats["p99_s"] is not None,
                        f"serve {label}: /metrics carries no serving/latency")
                health = json.loads(get(port, "/healthz"))
                serving = json.loads(get(port, "/serving"))
                evaluator.tick()
                alerts = json.loads(get(port, "/alerts"))
                require(health["status"] == "ok"
                        and serving["deadline_missed"] >= 1
                        and alerts["enabled"]
                        and len(alerts["objectives"]) == 4,
                        f"serve {label}: /healthz {health}, /serving "
                        f"{serving}, /alerts {alerts}")
                phase("serve", f"{label}: /metrics {len(flat)} samples "
                               f"(serving p50 {stats['p50_s']:.4f} s, p99 "
                               f"{stats['p99_s']:.4f} s, rejects "
                               f"{stats['rejects']:g}); /healthz ok; "
                               f"/serving {serving['completed']:g} "
                               f"completed, {serving['deadline_missed']:g} "
                               f"deadline miss(es); /alerts "
                               f"{len(alerts['objectives'])} objectives, "
                               f"firing {alerts['firing']}")
                if leg is None:
                    profile_route(torch, port, post, bodies)
            finally:
                shutdown_server(server)
                backend.close()
                slo.stop_slo()
                telemetry.reset()
            if leg is None:
                cli_ref = refs[-1]
            if launched_total is None:
                launched_total = launched
            else:
                launched_total = {k: launched_total[k] + v
                                  for k, v in launched.items()}
            del inf, refs, results, bodies
            torch.cuda.empty_cache()
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    serve_command(weights, tmp, raws[-1], offsets[-1], cli_ref)
    return launched_total


def profile_route(torch, port, post, bodies):
    """``POST /profile?seconds=N`` while client threads keep requests in
    flight: the trace names the gather and accumulate kernels that the
    lifecycle and dispatcher threads launched. A session whose device
    events were dropped is taken again."""
    import threading
    import urllib.request

    stop = threading.Event()

    def load():
        while not stop.is_set():
            post(port, bodies[0])

    threads = [threading.Thread(target=load) for _ in range(2)]
    for thread in threads:
        thread.start()
    try:
        for attempt in range(1, TRACE_TRIES + 1):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/profile?seconds={SERVE_PROFILE_S}",
                data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                require(resp.status == 200, f"serve: /profile {resp.status}")
                payload = json.loads(resp.read())
            trace = Path(payload["trace_dir"]) / "trace.json"
            events = json.loads(trace.read_text()).get("traceEvents", [])
            kernels = [e.get("name", "") for e in events
                       if e.get("cat") == "kernel"]
            found = {k: sum(k in name for name in kernels)
                     for k in ("gather_kernel", "accumulate_kernel")}
            if all(found.values()):
                break
            phase("timer", f"serve: /profile session {attempt} traced "
                           f"{len(kernels)} kernels ({found}); taken again")
        else:
            raise SmokeFailure(f"serve: no /profile session in "
                               f"{TRACE_TRIES} traced both kernels")
    finally:
        stop.set()
        for thread in threads:
            thread.join()
    phase("serve", f"POST /profile?seconds={SERVE_PROFILE_S:g} under load: "
                   f"{trace} holds {len(kernels)} kernels, gather_kernel x "
                   f"{found['gather_kernel']}, accumulate_kernel x "
                   f"{found['accumulate_kernel']}")


def serve_command(weights, tmp, raw, offset, ref):
    """``python -m chunkflow_tpu_torch -v serve --port 0 ...`` as a user
    starts it: its bound port, the request ``raw`` answered bitwise its
    float32 ``Inferencer.__call__`` ``ref``, then a drain on SIGTERM."""
    import base64
    import os
    import signal
    import threading
    import urllib.request

    import numpy as np

    env = {k: v for k, v in os.environ.items()
           if k not in ("CHUNKFLOW_PRECISION", "CHUNKFLOW_INT8",
                        "CHUNKFLOW_CHAOS")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "chunkflow_tpu_torch", "-v",
           "--metrics-dir", str(tmp / "metrics-cli"), "serve", "--port", "0",
           "--host", "127.0.0.1", "-f", "flax", "-w", str(weights),
           "-p", *map(str, PIN), "--output-patch-overlap", *map(str, OVERLAP),
           "-c", str(CHANNELS), "-b", str(PACK_BATCH),
           "--max-runtime", str(SERVE_RUNTIME_S)]
    log = tmp / "serve-cli.err"
    t = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True)
    lines = []
    try:
        timer = threading.Timer(SERVE_RUNTIME_S, proc.kill)
        timer.start()
        try:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if line.startswith("serving: http://"):
                    break
        finally:
            timer.cancel()
        require(lines and lines[-1].startswith("serving: http://"),
                f"serve command: no serving line: {lines} "
                f"{log.read_text()[-3000:]}")
        port = int(lines[-1].split("/infer")[0].rsplit(":", 1)[1])
        started = time.perf_counter() - t
        data = json.dumps({
            "shape": list(raw.shape), "dtype": "uint8",
            "data_b64": base64.b64encode(raw.tobytes()).decode(),
            "voxel_offset": list(offset), "deadline_s": 300.0}).encode()
        t = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/infer",
                                     data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            payload = json.loads(resp.read())
        answered = time.perf_counter() - t
        got = np.frombuffer(base64.b64decode(payload["data_b64"]),
                            dtype=payload["dtype"]).reshape(payload["shape"])
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += out.splitlines()
    require(proc.returncode == 0, f"serve command: rc {proc.returncode}: "
                                  f"{log.read_text()[-3000:]}")
    require(np.array_equal(got, ref), "serve command: the response differs "
                                      "from Inferencer.__call__")
    drained = [ln for ln in lines if ln.startswith("serve drained: ")]
    counters = [ln for ln in lines if ln.startswith("run counters: ")]
    require("serve: draining on preemption signal" in lines and drained
            and counters, f"serve command: no drain lines: {lines[-12:]}")
    run = json.loads(counters[-1][len("run counters: "):])
    require(run["kernels/gather"] > 0 and run["kernels/accumulate"] > 0
            and run["kernels/conv3d_int8"] == 0,
            f"serve command: run counters {run}")
    phase("serve", f"python -m chunkflow_tpu_torch -v serve --port 0 -f "
                   f"flax: bound port {port} after {started:.1f} s; one "
                   f"{raw.shape} request answered in {answered:.2f} s "
                   f"== Inferencer.__call__ bitwise; SIGTERM: "
                   f"{drained[-1]}; kernels/gather "
                   f"{run['kernels/gather']}, kernels/accumulate "
                   f"{run['kernels/accumulate']}")


def segment_plane_phase(torch, cfg):
    """Phase 16: the segmentation plane on what the card inferred.

    ``cfg["input"]`` is channel 0 of phase 10's parity (float32) output
    volume over its roi, as ``.npy``; it is thresholded at its 70%
    quantile (as phase 12b does) and cut into ``cfg["task"]`` chunks.

    a. ``segment-volume --device`` and then ``--host`` through the port's
       CLI in process (``-w 4``, 26-connectivity): the two exported
       volumes label-isomorphic to each other and to one monolithic host
       labelling; under ``--device`` every chunk's local labels (recorded
       as the run made them) the device leg's fixpoint read off the host
       labels of that chunk. Wall s, Mvox/s, ms per stage (``segment/*``
       spans), sweeps, components and the ``segment/*`` counters.
    b. ``segment-volume -q file://... --ledger ...`` as a coordinator
       subprocess and two worker subprocesses chaining ``label-chunk |
       merge-seg | relabel | delete-task-in-queue`` on ``cfg["device"]``:
       the first killed at ``segment/merge``
       (``CHUNKFLOW_CHAOS=once=segment/merge:action=kill``, rc -9), the
       second started once it is dead; on ``cfg["queue_z"]`` slices of
       the input (the cut is printed): the result label-isomorphic to the
       monolithic labelling of that cut, the queue empty, the ledger
       holding every tree and relabel task.
    c. ``load-npy | mesh --manifest --ids ...`` on two neighbouring chunks
       of (a)'s host-leg volume for the ``cfg["mesh_ids"]`` largest
       objects of the first, then ``mesh-manifest`` and ``download-mesh``
       of the largest: every listed fragment exists, every mesh is
       closed (each edge shared by an even number of faces: two, or four
       where voxels of one object touch only along an edge; those are
       counted), the ply holds the sum of its fragments' faces.

    Labels are compared by a one-dimensional isomorphism check (the ids
    stay below 2^32, which it needs and the phase checks), held against
    ``labels_isomorphic`` on a crop. Returns the phase's wall seconds."""
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np

    from chunkflow_tpu_torch import native
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.mesh import from_precomputed_bytes
    from chunkflow_tpu_torch.ops import connected_components as cc
    from chunkflow_tpu_torch.parallel.lifecycle import FileLedger
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.segment import driver, labels_isomorphic, stages

    t_phase = time.perf_counter()
    dev = cfg["device"]
    dev_args = [] if dev == "cuda" else ["--device", "cpu"]
    task = cfg["task"]
    nums = [str(v) for v in task]
    source = np.load(cfg["input"])
    thr = float(np.quantile(source, 0.7))
    fg = source > np.float32(thr)
    vox = fg.size

    def isomorphic(a, b):
        """(bijective, pairs): ``labels_isomorphic`` on ids below 2^32,
        one sort of packed (a, b) pairs."""
        a, b = a.ravel(), b.ravel()
        nz = a != 0
        if not np.array_equal(nz, b != 0):
            return False, 0
        require(int(a.max(initial=0)) < 1 << 32
                and int(b.max(initial=0)) < 1 << 32,
                "segment-plane: an id reaches 2^32")
        pairs = np.unique((a[nz].astype(np.uint64) << np.uint64(32))
                          | b[nz].astype(np.uint64))
        na = np.unique(pairs >> np.uint64(32)).size
        nb = np.unique(pairs & np.uint64(0xFFFFFFFF)).size
        return na == nb == pairs.size, int(pairs.size)

    t = time.perf_counter()
    mono, n_mono = native.connected_components(fg, 26)
    mono_s = time.perf_counter() - t
    crop = (slice(0, 8), slice(0, 160), slice(0, 160))
    for a, b in ((mono, mono[::-1][::-1]), (mono, (mono > 0).astype(
            np.uint32))):
        require(isomorphic(a[crop], b[crop])[0]
                == labels_isomorphic(a[crop], b[crop]),
                "segment-plane: the isomorphism check disagrees with "
                "labels_isomorphic on a crop")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_segment_") as tmp:
        tmp = Path(tmp)
        npy = tmp / "input.npy"
        np.save(npy, source)

        # ---- a. local mode, both legs ----------------------------------
        local, ctx = {}, threading.local()
        label_chunk, label_local = driver.label_chunk, stages._label_local

        def recording_label_chunk(store, bbox):
            ctx.bbox = bbox
            return label_chunk(store, bbox)

        def recording_label_local(store, src):
            out = label_local(store, src)
            local[ctx.bbox.string] = (ctx.bbox, out.copy())
            return out

        legs = {}
        for leg in ("--device", "--host"):
            job = tmp / f"job{leg}"
            local.clear()
            cc.sweeps = 0
            with mock.patch.object(driver, "label_chunk",
                                   recording_label_chunk), \
                    mock.patch.object(stages, "_label_local",
                                      recording_label_local):
                t = time.perf_counter()
                require(cli.main(dev_args + [
                    "segment-volume", "-i", str(npy), "-d", str(job), "-c",
                    *nums, "-t", repr(thr), "--connectivity", "26", "-w",
                    "4", leg]) == 0, f"segment-plane: segment-volume {leg}")
                wall = time.perf_counter() - t
            snap = telemetry.snapshot()
            store = driver.open_store(str(job), device=dev)
            legs[leg] = dict(
                wall=wall, sweeps=cc.sweeps, counters=snap["counters"],
                spans={k: snap["hists"].get(f"segment/{k}", {})
                       for k in ("label", "merge", "relabel")},
                seg=driver.export_segmentation(store), plan=store.plan,
                local=dict(local))
        dev_seg, host_seg = legs["--device"]["seg"], legs["--host"]["seg"]
        checks = {}
        for what, a, b in (("device ~ host", dev_seg, host_seg),
                           ("device ~ monolithic", dev_seg, mono),
                           ("host ~ monolithic", host_seg, mono)):
            ok, pairs = isomorphic(a, b)
            require(ok and pairs == n_mono,
                    f"segment-plane: {what}: not label-isomorphic "
                    f"({pairs} pairs, {n_mono} components)")
            checks[what] = pairs
        if cfg.get("keep"):  # phase 17's input: the stitched segmentation
            np.save(cfg["keep"], host_seg)
        plan = legs["--device"]["plan"]
        recorded = legs["--device"]["local"]
        require(len(recorded) == len(plan.chunks),
                f"segment-plane: {len(recorded)} chunks labelled, not "
                f"{len(plan.chunks)}")
        for bbox, labels in recorded.values():
            sel = tuple(slice(int(a), int(b))
                        for a, b in zip(bbox.start, bbox.stop))
            host_local, n_local = native.connected_components(fg[sel], 26)
            # the host numbers components by their first voxel in raster
            # order, so a component's first voxel is where the running
            # maximum of the labels steps up
            flat = host_local.ravel()
            steps = np.flatnonzero(flat[1:] > np.maximum.accumulate(
                flat)[:-1]) + 1
            if flat[0]:
                steps = np.concatenate([[0], steps])
            require(steps.size == n_local, "segment-plane: the host "
                                           "numbering is not raster order")
            lut = np.zeros(n_local + 1, dtype=np.int64)
            lut[flat[steps]] = steps + 1
            oracle = lut[flat].astype(np.uint32)
            require(labels.dtype == np.uint32
                    and np.array_equal(labels.ravel(), oracle),
                    f"segment-plane: chunk {bbox.string}: the device labels "
                    f"differ from the device leg's fixpoint")
        top = int(max(dev_seg.max(), host_seg.max()))
        local_s = time.perf_counter() - t_phase
        phase("segment-plane",
              f"{cfg['card']}; input {source.shape} float32 (channel 0 of "
              f"phase 10's parity output over its roi), T {thr:.6g} (70% "
              f"quantile), foreground {fg.mean():.1%}; grid {plan.grid_shape}"
              f" of {task} ({len(plan.chunks)} chunks, "
              f"{len(plan.chunks) - 1} merge nodes); the largest global id "
              f"{top} < 2^32 (ids are chunk index x {plan.id_stride} + "
              f"local); monolithic host labelling {n_mono} components in "
              f"{mono_s:.3f} s")
        for leg, r in legs.items():
            c = r["counters"]
            stage_ms = ", ".join(
                f"{k} {h.get('total', 0.0) * 1e3:.1f} ms over "
                f"{h.get('count', 0)} ({h.get('mean', 0.0) * 1e3:.1f} each)"
                for k, h in r["spans"].items())
            phase("segment-plane",
                  f"segment-volume {leg} -w 4: {r['wall']:.3f} s, "
                  f"{vox / r['wall'] / 1e6:.3f} Mvox/s; {stage_ms}; "
                  f"sweeps {r['sweeps']}; components {n_mono}; "
                  f"segment/merges_applied "
                  f"{c.get('segment/merges_applied', 0):g}, "
                  f"segment/voxels_relabeled "
                  f"{c.get('segment/voxels_relabeled', 0):g}, "
                  f"segment/edges_found {c.get('segment/edges_found', 0):g}")
        phase("segment-plane",
              f"label-isomorphic: {', '.join(checks)}; every device chunk's "
              f"local labels == the device leg's fixpoint of its host "
              f"labels ({len(recorded)} chunks)")

        # ---- b. queue mode with a kill ---------------------------------
        t_queue = time.perf_counter()
        cut = source[:cfg["queue_z"]]
        cut_npy = tmp / "cut.npy"
        np.save(cut_npy, cut)
        cut_mono, n_cut = native.connected_components(
            cut > np.float32(thr), 26)
        job, qdir, ledger = tmp / "qjob", tmp / "queue", tmp / "ledger"
        env = {k: v for k, v in os.environ.items() if k != "CHUNKFLOW_CHAOS"}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        port = [sys.executable, "-m", "chunkflow_tpu_torch", *dev_args]
        worker = [*port, "fetch-task-from-queue", "-q", f"file://{qdir}",
                  "-v", str(cfg["visibility"]), "--lease-renew", "1",
                  "-r", "120", "--poll-interval", "0.05", "--max-retries",
                  "3",
                  "--ledger", str(ledger),
                  "label-chunk", "-d", str(job), "merge-seg", "-d", str(job),
                  "relabel", "-d", str(job), "delete-task-in-queue"]
        procs = []
        t = time.perf_counter()
        try:
            coordinator = subprocess.Popen(
                [*port, "segment-volume", "-i", str(cut_npy), "-d", str(job),
                 "-c", *nums, "-t", repr(thr), "--connectivity", "26",
                 "--device", "-q", f"file://{qdir}", "--ledger",
                 str(ledger), "--timeout", "300"],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            procs.append(coordinator)
            deadline = time.monotonic() + 120
            while not (job / "spec.json").exists():
                require(coordinator.poll() is None
                        and time.monotonic() < deadline,
                        "segment-plane: the coordinator wrote no spec")
                time.sleep(0.05)
            killed = subprocess.Popen(
                worker, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                env=dict(env, CHUNKFLOW_CHAOS="once=segment/merge:"
                                              "action=kill"))
            procs.append(killed)
            rc_killed = killed.wait(timeout=240)
            require(rc_killed in (-signal.SIGKILL, 137),
                    f"segment-plane: the first worker was to die by "
                    f"SIGKILL at segment/merge, rc {rc_killed}: "
                    f"{killed.communicate()[0][-2000:]}")
            killed_s = time.perf_counter() - t
            drain = subprocess.Popen(
                worker, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            procs.append(drain)
            out, _ = coordinator.communicate(timeout=300)
            require(coordinator.returncode == 0,
                    f"segment-plane: the coordinator failed: {out[-2000:]}")
            drain_out, _ = drain.communicate(timeout=120)
            require(drain.returncode == 0,
                    f"segment-plane: the draining worker failed: "
                    f"{drain_out[-2000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        queue_s = time.perf_counter() - t
        store = driver.open_store(str(job), device=dev)
        ok, _ = isomorphic(driver.export_segmentation(store), cut_mono)
        require(ok, "segment-plane: the queue mode's volume is not "
                    "label-isomorphic to the monolithic labelling of the cut")
        qplan = store.plan
        want = {qplan.node_body(n) for n in qplan.make_tree().walk()}
        want |= {qplan.relabel_body(c) for c in qplan.chunks}
        keys = FileLedger(str(ledger)).keys()
        require(sorted(keys) == sorted(want),
                f"segment-plane: the ledger holds {len(keys)} keys, not "
                f"{len(want)}")
        stats = open_queue(f"file://{qdir}").stats()
        require(stats["pending"] == stats["inflight"] == stats["dead"] == 0,
                f"segment-plane: the queue did not drain: {stats}")
        phase("segment-plane",
              f"queue mode on the first {cfg['queue_z']} z slices "
              f"({cut.shape}: {len(qplan.chunks)} chunks, "
              f"{len(qplan.chunks) - 1} merge nodes; cut to fit the phase's "
              f"budget): coordinator + a worker killed at segment/merge "
              f"(rc {rc_killed}, {killed_s:.1f} s after the start) + a "
              f"draining worker, {queue_s:.1f} s; label-isomorphic to the "
              f"monolithic labelling of the cut ({n_cut} components); "
              f"queue {stats}; ledger {len(keys)} keys (every tree and "
              f"relabel task)")

        queue_total_s = time.perf_counter() - t_queue

        # ---- c. meshes -------------------------------------------------
        t_mesh = time.perf_counter()
        mesh_dir = tmp / "mesh"
        # the largest object percolates through the roi (a 30% foreground
        # does): its mesh alone holds tens of millions of faces, so it is
        # left out and its size printed
        sizes_mono = np.bincount(mono.ravel())
        sizes_mono[0] = 0
        giant = int(host_seg.ravel()[np.flatnonzero(
            mono.ravel() == sizes_mono.argmax())[0]])
        first = plan.chunks[0]
        second = next(c for c in plan.chunks
                      if int(c.start[2]) == int(first.stop[2])
                      and int(c.start[0]) == int(first.start[0])
                      and int(c.start[1]) == int(first.start[1]))
        sel0 = tuple(slice(int(a), int(b))
                     for a, b in zip(first.start, first.stop))
        ids, sizes = np.unique(host_seg[sel0], return_counts=True)
        keep = (ids != 0) & (ids != giant)
        sizes, ids = sizes[keep], ids[keep]
        chosen = ids[np.argsort(sizes, kind="stable")[::-1][:cfg["mesh_ids"]]]
        id_text = ",".join(str(int(i)) for i in chosen)
        t = time.perf_counter()
        for chunk in (first, second):
            sel = tuple(slice(int(a), int(b))
                        for a, b in zip(chunk.start, chunk.stop))
            path = tmp / f"seg-{chunk.string}.npy"
            np.save(path, host_seg[sel])
            require(cli.main(dev_args + [
                "load-npy", "-f", str(path), "--voxel-offset",
                *[str(int(v)) for v in chunk.start], "--voxel-size",
                *[str(v) for v in cfg["voxel"]], "mesh", "-o",
                str(mesh_dir), "--manifest", "--ids", id_text]) == 0,
                    "segment-plane: mesh failed")
        mesh_s = time.perf_counter() - t
        mesh_ms = {h: telemetry.snapshot()["hists"].get(h, {}).get(
            "mean", 0.0) * 1e3 for h in ("op/mesh",)}
        require(cli.main(dev_args + ["mesh-manifest", "-d",
                                     str(mesh_dir)]) == 0,
                "segment-plane: mesh-manifest failed")
        big = int(chosen[0])
        require(cli.main(dev_args + [
            "download-mesh", "-v", str(mesh_dir), "-i", str(big), "-o",
            str(tmp / "obj_"), "-f", "ply"]) == 0,
                "segment-plane: download-mesh failed")
        fragments = faces_total = nonmanifold = 0
        big_faces = 0
        for obj in chosen:
            with open(mesh_dir / f"{int(obj)}:0") as f:
                listed = json.load(f)["fragments"]
            require(bool(listed), f"segment-plane: object {obj}: an empty "
                                  f"manifest")
            for frag in listed:
                require((mesh_dir / frag).exists(),
                        f"segment-plane: manifest of {obj} lists a missing "
                        f"fragment {frag}")
                vertices, faces = from_precomputed_bytes(
                    (mesh_dir / frag).read_bytes())
                edges = np.sort(np.concatenate(
                    [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                    axis=1).astype(np.int64)
                _, uses = np.unique(edges[:, 0] * (vertices.shape[0] + 1)
                                    + edges[:, 1], return_counts=True)
                require(bool((uses % 2 == 0).all()),
                        f"segment-plane: fragment {frag} is not closed "
                        f"(an edge of {sorted(set(uses.tolist()))} faces)")
                nonmanifold += int((uses > 2).sum())
                fragments += 1
                faces_total += faces.shape[0]
                if int(obj) == big:
                    big_faces += faces.shape[0]
        with open(tmp / f"obj_{big}.ply") as f:
            header = [next(f) for _ in range(9)]
        ply_faces = int(next(ln for ln in header
                             if ln.startswith("element face")).split()[-1])
        require(ply_faces == big_faces,
                f"segment-plane: download-mesh's ply holds {ply_faces} "
                f"faces, its fragments {big_faces}")
        phase("segment-plane",
              f"mesh --manifest on chunks {first.string} and "
              f"{second.string} of the host-leg volume, the "
              f"{len(chosen)} largest objects of the first (capped at "
              f"{cfg['mesh_ids']}: surface nets scan a chunk once per "
              f"object; the roi's largest object, {giant}, "
              f"{int(sizes_mono.max())} voxels, "
              f"{sizes_mono.max() / max(1, int(fg.sum())):.1%} of the "
              f"foreground, left out): {fragments} fragments, "
              f"{faces_total} faces, "
              f"{mesh_s:.3f} s ({mesh_s * 1e3 / (2 * len(chosen)):.1f} ms "
              f"per object and chunk; op/mesh "
              f"{mesh_ms['op/mesh']:.1f} ms per chunk); every listed "
              f"fragment exists, every mesh closed ({nonmanifold} edges "
              f"shared by 4 faces, where an object's voxels touch only "
              f"along an edge); download-mesh {big}: {ply_faces} faces, "
              f"the sum of its fragments'")
        shutil.rmtree(mesh_dir)
        phase("segment-plane",
              f"phase parts: input, both local legs and their checks "
              f"{local_s:.1f} s; queue mode with its checks "
              f"{queue_total_s:.1f} s; meshes with their checks "
              f"{time.perf_counter() - t_mesh:.1f} s")
    return time.perf_counter() - t_phase


def encodings_phase(torch, cfg, weights, reset_counts, counts):
    """Phase 17: the precomputed encodings on the worker's path.

    a. Phase 10's seeded input volume re-encoded as ``jpeg`` in
       ``create-info``'s default 64³ blocks (bytes on disk, the ratio to
       ``raw``, encode MB/s). Phase 10's queue-fed worker (``fetch-task-
       from-queue | load-precomputed | inference | save-precomputed
       --async-write | delete-task-in-queue``, the parity UNet3D in
       float32) in two worker subprocesses at once, reading the jpeg
       volume and writing a sharded ``raw`` float32 volume whose every
       shard holds chunks of more than one task (checked; the parameters
       printed). Every task of the output is bitwise its in-process
       reference (``Inferencer.__call__`` on the port's own decoded
       cutout, cropped); each worker launched each kernel ``per_task``
       times per computed task; each task acked once; the queue empty.
       The same chain in this process, counted and timed (s/task, Mvox/s,
       host ms per task decoding jpeg blocks), and bitwise the reference.
    b. ``cfg["segmentation"]`` (phase 16's stitched global segmentation,
       uint64) into a sharded ``compressed_segmentation`` volume as
       igneous writes segmentations (64³ chunks, 8³ blocks, murmurhash3,
       gzip minishard index and data), read back bitwise; MB/s of the
       volume's save and cutout, and of the host C++ codec and its numpy
       plain version on one chunk; bytes on disk and the ratio.
    c. A uint16 ``png`` volume and a 3-channel uint8 ``jpeg`` volume,
       written and read back: the png bitwise, the jpeg bitwise the
       blocks' own decoding (and, through the write-through cache, the
       array saved). Whether this machine's Pillow encodes the blocks of
       ``tests/data/jpeg_blocks.npz`` into the bytes tensorstore wrote
       there, and decodes those bytes as tensorstore decoded them, is
       printed.

    Returns the kernels' launches in the counted in-process run."""
    import itertools
    import shutil
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import BoundingBox, Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.core.bbox import BoundingBoxes
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import process_stream
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.volume import codecs, storage
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume
    from chunkflow_tpu_torch.volume.sharding import (
        ShardingSpec,
        compressed_morton_code,
    )

    on_card = cfg["device"] == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    pin, overlap, batch, margin = (cfg["pin"], cfg["overlap"], cfg["batch"],
                                   cfg["margin"])
    roi_start, roi_size = cfg["roi"]
    task = cfg["task"]
    chunk_in = tuple(t + 2 * m for t, m in zip(task, margin))
    per_task = len(pad_to_batch(enumerate_patches(chunk_in, pin, pin,
                                                  overlap), batch)[0]) // batch
    boxes = list(BoundingBoxes.from_manual_setup(
        chunk_size=task, roi_start=roi_start, roi_size=roi_size))
    vox_in = int(np.prod(chunk_in))

    def nums(triple):
        return [str(v) for v in triple]

    def disk_bytes(path):
        return sum(os.path.getsize(os.path.join(root, n))
                   for root, _, names in os.walk(path) for n in names
                   if not n.endswith(".lock"))

    def shard_tasks(spec, block):
        """shard -> the tasks whose output chunks it holds."""
        grid = [r // b for r, b in zip(roi_size, block)]
        held = {}
        for z, y, x in itertools.product(*map(range, grid)):
            cid = compressed_morton_code((x, y, z), grid[::-1])
            owner = tuple(i * b // t for i, b, t in zip((z, y, x), block,
                                                           task))
            held.setdefault(spec.locate(cid)[0], set()).add(owner)
        return held

    def sync():
        if on_card:
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_encodings_") as tmp:
        tmp = Path(tmp)
        weights_pt = str(tmp / "unet3d_seed0.pt")
        torch.save(weights, weights_pt)
        # ---- a. the jpeg-fed worker ------------------------------------
        image = np.random.default_rng(10).integers(0, 256, cfg["volume"],
                                                   dtype=np.uint8)
        vol_in = str(tmp / "image-jpeg")
        require(cli.main(dev_args + [
            "create-info", "-v", vol_in, "-s", *nums(cfg["volume"]),
            "--voxel-size", *nums(VOXEL_NM), "-e", "jpeg"]) == 0,
            "encodings: create-info -e jpeg failed")
        t = time.perf_counter()
        PrecomputedVolume(vol_in).save(Chunk(image, voxel_size=VOXEL_NM))
        enc_s = time.perf_counter() - t
        jpeg_bytes = disk_bytes(os.path.join(vol_in, "4_4_40"))
        # the write-through cache holds the blocks saved, not their jpeg
        # decoding (the JAX package's behaviour): every read below decodes
        storage.reset_shared_cache()
        block_in = PrecomputedVolume(vol_in).block_size(0)
        phase("encodings", f"input {cfg['volume']} uint8 re-encoded as jpeg "
                           f"(quality {codecs.JPEG_QUALITY}) in blocks of "
                           f"{tuple(block_in)}: {jpeg_bytes} bytes on disk, "
                           f"{jpeg_bytes / image.nbytes:.4f} of raw "
                           f"({image.nbytes}); encode {enc_s:.3f} s, "
                           f"{image.nbytes / enc_s / 1e6:.1f} MB/s")
        spec_out = dict(cfg["shard_out"])
        held = shard_tasks(ShardingSpec(spec_out), cfg["out_block"])
        require(min(len(v) for v in held.values()) > 1,
                f"encodings: a shard of the output holds chunks of one task "
                f"only under {spec_out}")

        def output_volume(name):
            out = str(tmp / name)
            PrecomputedVolume.create(
                out, volume_size=roi_size, voxel_size=VOXEL_NM,
                voxel_offset=roi_start, num_channels=3, dtype="float32",
                block_size=cfg["out_block"], sharding=spec_out)
            queue = f"file://{tmp}/{name}-queue"
            require(cli.main(dev_args + [
                "generate-tasks", "--volume-path", out, "--chunk-size",
                *nums(task), "--queue-name", queue]) == 0,
                f"encodings: generate-tasks for {name} failed")
            return out, queue, str(tmp / f"{name}-ledger")

        def worker_args(queue, ledger, out, polls):
            return ["fetch-task-from-queue", "-q", queue, "--max-retries",
                    "3", "--ledger", ledger, "--visibility-timeout",
                    str(VISIBILITY_S), "--lease-renew", "1", "-r",
                    str(polls), "--poll-interval", "0.5",
                    "load-precomputed", "-v", vol_in, "-e", *nums(margin),
                    "inference", "--framework", "pytorch",
                    "--model-variant", "parity", "--dtype", "float32",
                    "--weight-path", weights_pt,
                    "--input-patch-size", *nums(pin),
                    "--output-patch-overlap", *nums(overlap),
                    "--output-crop-margin", *nums(margin),
                    "--num-output-channels", "3", "--batch-size",
                    str(batch), "--async-depth", "2",
                    "save-precomputed", "-v", out, "--async-write",
                    "delete-task-in-queue"]

        inferencer = Inferencer(
            input_patch_size=pin, output_patch_overlap=overlap,
            num_output_channels=3, framework="pytorch",
            model_variant="parity", dtype="float32", batch_size=batch,
            weight_path=weights_pt, device=cfg["device"])
        reader = PrecomputedVolume(vol_in)
        refs = []
        for bbox in boxes:
            src = reader.cutout(bbox.adjust(margin))
            refs.append(inferencer(src).crop_margin(margin).host().array)
        del inferencer

        def check_volume(out, what):
            vol = PrecomputedVolume(out)
            for bbox, ref in zip(boxes, refs):
                got = vol.cutout(bbox).array
                require(got.shape == ref.shape and np.array_equal(got, ref),
                        f"encodings: {what}: task {bbox.string} differs "
                        f"from its in-process reference")

        out, queue, ledger = output_volume("out-workers")
        metrics = str(tmp / "events")
        env = {k: v for k, v in os.environ.items() if k != "CHUNKFLOW_CHAOS"}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "chunkflow_tpu_torch", *dev_args, "-v",
             "--metrics-dir", metrics, *worker_args(queue, ledger, out, 4)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for _ in range(2)]
        results = []
        try:
            for proc in procs:
                stdout, stderr = proc.communicate(timeout=cfg["worker_s"])
                results.append((proc.returncode, stdout, stderr))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t
        counters = []
        for rc, stdout, stderr in results:
            require(rc == 0, f"encodings: a worker failed, rc {rc}: "
                             f"{stderr[-3000:]}")
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("run counters: ")]
            require(bool(line), "encodings: a worker printed no counters")
            counters.append(json.loads(line[-1][len("run counters: "):]))
        computed = [c.get("inference/chunks", 0) for c in counters]
        require(sum(computed) == len(boxes),
                f"encodings: the workers computed {computed} tasks, not "
                f"{len(boxes)} in all")
        for c, n in zip(counters, computed):
            for kname in ("gather", "accumulate"):
                require(not on_card or c.get(f"kernels/{kname}") == per_task
                        * n, f"encodings: a worker launched {kname} "
                             f"{c.get(f'kernels/{kname}')} times for {n} "
                             f"tasks, not {per_task} each")
        stats = open_queue(queue).stats()
        require(stats["pending"] == stats["inflight"] == stats["dead"] == 0,
                f"encodings: the queue did not drain: {stats}")
        acks = {b.string: 0 for b in boxes}
        for event in metrics_events(metrics):
            if event.get("name") in ("lifecycle/committed",
                                     "lifecycle/ledger_skip"):
                acks[event["body"]] += 1
        require(set(acks.values()) == {1},
                f"encodings: acks per task {acks}, not one each")
        check_volume(out, "the two workers' sharded volume")
        shards = sorted(n for n in os.listdir(os.path.join(out, "4_4_40"))
                        if n.endswith(".shard"))
        phase("encodings", f"two workers (parity float32) from the jpeg "
                           f"volume into a sharded raw float32 volume "
                           f"({spec_out}; {len(shards)} shards of "
                           f"{tuple(cfg['out_block'])} chunks, each holding "
                           f"chunks of {min(len(v) for v in held.values())}-"
                           f"{max(len(v) for v in held.values())} tasks): "
                           f"{wall:.1f} s for {len(boxes)} tasks with start-"
                           f"up, tasks per worker {computed}; output == "
                           f"in-process reference bitwise; {per_task} + "
                           f"{per_task} launches per computed task; each "
                           f"task acked once; queue {stats}")
        shutil.rmtree(out)

        # the same chain in this process: counted and timed
        out, queue, ledger = output_volume("out-run")
        _, stages = cli.build_stages(dev_args + worker_args(queue, ledger,
                                                            out, 0))
        decode_s = [0.0]
        jpeg_decode = codecs.JpegCodec.decode

        def timed_decode(self, data, shape):
            t0 = time.perf_counter()
            try:
                return jpeg_decode(self, data, shape)
            finally:
                decode_s[0] += time.perf_counter() - t0

        storage.reset_shared_cache()
        telemetry.reset()
        with mock.patch.object(codecs.JpegCodec, "decode", timed_decode):
            reset_counts()
            sync()
            t = time.perf_counter()
            n = process_stream(stages)
            sync()
            run_s = time.perf_counter() - t
            launched = counts()
        snap = telemetry.snapshot()
        require(n == len(boxes), f"encodings: {n} tasks drained")
        for kname, k in launched.items():
            require(not on_card or k == per_task * len(boxes),
                    f"encodings: {kname} launched {k} times, not "
                    f"{per_task * len(boxes)}")
        check_volume(out, "the in-process run's sharded volume")

        def mean_ms(name):
            h = snap["hists"].get(name)
            return h["mean"] * 1e3 if h else 0.0

        phase("encodings", f"the same chain in process: "
                           f"{run_s / len(boxes):.4f} s/task, "
                           f"{vox_in * len(boxes) / run_s / 1e6:.3f} Mvox/s "
                           f"of input (phase 10 from raw: "
                           + (f"{cfg['raw_s_per_task']:.4f} s/task"
                              if cfg.get("raw_s_per_task") else "not run")
                           + f"); host ms per task: decoding jpeg blocks "
                           f"{decode_s[0] * 1e3 / len(boxes):.1f}, cutout "
                           f"{mean_ms('op/load-precomputed'):.1f} (block "
                           f"reads {mean_ms('storage/read'):.1f}), save "
                           f"{mean_ms('op/save-precomputed'):.1f}, ack "
                           f"{mean_ms('lifecycle/commit'):.1f}; launches "
                           f"{launched}; output == reference bitwise")
        shutil.rmtree(out)
        del refs, stages, image

        # ---- b. the segmentation as compressed_segmentation ---------------
        seg = np.load(cfg["segmentation"])
        require(seg.shape == tuple(roi_size),
                f"encodings: the segmentation is {seg.shape}, not "
                f"{tuple(roi_size)}")
        seg = seg.astype(np.uint64, copy=False)
        seg_vol = str(tmp / "segmentation")
        PrecomputedVolume.create(
            seg_vol, volume_size=roi_size, voxel_size=VOXEL_NM,
            voxel_offset=roi_start, dtype="uint64",
            layer_type="segmentation", block_size=cfg["seg_chunk"],
            encoding="compressed_segmentation", sharding=cfg["shard_seg"],
            compressed_segmentation_block_size=cfg["seg_block"])
        t = time.perf_counter()
        PrecomputedVolume(seg_vol).save(Chunk(seg, voxel_offset=roi_start,
                                              voxel_size=VOXEL_NM))
        save_s = time.perf_counter() - t
        storage.reset_shared_cache()
        roi = BoundingBox(roi_start, tuple(a + b for a, b in
                                           zip(roi_start, roi_size)))
        t = time.perf_counter()
        back = PrecomputedVolume(seg_vol).cutout(roi).array
        read_s = time.perf_counter() - t
        require(back.dtype == np.uint64 and np.array_equal(back, seg),
                "encodings: the compressed_segmentation volume does not "
                "read back bitwise")
        seg_bytes = disk_bytes(seg_vol) - len(open(
            os.path.join(seg_vol, "info"), "rb").read())
        one = np.ascontiguousarray(seg[None, :cfg["seg_chunk"][0],
                                       :cfg["seg_chunk"][1],
                                       :cfg["seg_chunk"][2]])
        from chunkflow_tpu_torch import native
        rates = {}
        for label, enc, dec in (
                ("host C++", native.compressed_segmentation_encode,
                 native.compressed_segmentation_decode),
                ("numpy plain", codecs.encode_compressed_segmentation_plain,
                 codecs.decode_compressed_segmentation_plain)):
            t = time.perf_counter()
            data = enc(one, cfg["seg_block"])
            enc_s = time.perf_counter() - t
            t = time.perf_counter()
            dec_one = dec(data, one.shape, np.uint64, cfg["seg_block"])
            dec_s = time.perf_counter() - t
            require(np.array_equal(dec_one, one),
                    f"encodings: the {label} codec does not round-trip")
            rates[label] = (one.nbytes / enc_s / 1e6,
                            one.nbytes / dec_s / 1e6, data)
        require(rates["host C++"][2] == rates["numpy plain"][2],
                "encodings: the host C++ codec's bytes are not its numpy "
                "plain version's")
        phase("encodings", f"segmentation {seg.shape} uint64 "
                           f"({len(np.unique(seg[::4, ::16, ::16]))} ids in a "
                           f"sample) into sharded compressed_segmentation "
                           f"(chunks {tuple(cfg['seg_chunk'])}, blocks "
                           f"{tuple(cfg['seg_block'])}, {cfg['shard_seg']}): "
                           f"{seg_bytes} bytes on disk, "
                           f"{seg_bytes / seg.nbytes:.5f} of raw; save "
                           f"{save_s:.3f} s ({seg.nbytes / save_s / 1e6:.1f} "
                           f"MB/s), cutout {read_s:.3f} s "
                           f"({seg.nbytes / read_s / 1e6:.1f} MB/s); read "
                           f"back bitwise")
        phase("encodings", "one chunk " + str(tuple(one.shape[1:])) + ": "
              + "; ".join(f"{label} encode {r[0]:.1f} MB/s, decode "
                          f"{r[1]:.1f} MB/s" for label, r in rates.items())
              + f"; {len(rates['host C++'][2])} bytes, the same from both")
        del seg, back

        # ---- c. png and the card's jpeg ------------------------------------
        rng = np.random.default_rng(17)
        size = cfg["small"]
        for name, encoding, dtype, channels in (
                ("png", "png", "uint16", 1), ("rgb", "jpeg", "uint8", 3)):
            path = str(tmp / name)
            PrecomputedVolume.create(path, volume_size=size,
                                     voxel_size=VOXEL_NM,
                                     num_channels=channels, dtype=dtype,
                                     encoding=encoding)
            shape = ((channels,) if channels > 1 else ()) + tuple(size)
            data = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
            vol = PrecomputedVolume(path)
            vol.save(Chunk(data))
            box = BoundingBox((0, 0, 0), size)
            cached = vol.cutout(box).array
            storage.reset_shared_cache()
            t = time.perf_counter()
            back = PrecomputedVolume(path).cutout(box).array
            read_s = time.perf_counter() - t
            require(np.array_equal(cached, data),
                    f"encodings: {name}: the write-through cache does not "
                    f"return the array saved")
            if encoding == "png":
                require(np.array_equal(back, data),
                        "encodings: the png volume does not read back "
                        "bitwise")
                what = "bitwise"
            else:
                codec = codecs.JpegCodec()
                scale = os.path.join(path, "4_4_40")
                for fname in os.listdir(scale):
                    (x0, x1), (y0, y1), (z0, z1) = (
                        map(int, part.split("-"))
                        for part in fname.split("_"))
                    with open(os.path.join(scale, fname), "rb") as f:
                        blk = codec.decode(f.read(), (3, z1 - z0, y1 - y0,
                                                      x1 - x0))
                    require(np.array_equal(back[:, z0:z1, y0:y1, x0:x1],
                                           blk),
                            f"encodings: rgb: block {fname} reads "
                            f"otherwise than it decodes")
                what = (f"each block as it decodes, max abs to the input "
                        f"{int(np.abs(back.astype(int) - data).max())}")
            phase("encodings", f"{name}: {shape} {dtype} {encoding}, "
                               f"{disk_bytes(path)} bytes on disk, read in "
                               f"{read_s:.3f} s: {what}")
        fixture = np.load(ROOT / "tests" / "data" / "jpeg_blocks.npz")
        same = {}
        for name in ("gray", "rgb"):
            block = fixture[name]
            stored = fixture[f"{name}_jpeg"].tobytes()
            decoded = codecs.JpegCodec().decode(stored, block.shape)
            same[name] = (codecs.JpegCodec().encode(block) == stored,
                          bool(np.array_equal(decoded,
                                              fixture[f"{name}_decoded"])))
        import PIL
        phase("encodings", f"this machine's Pillow {PIL.__version__}: the "
                           f"jpeg bytes tensorstore wrote for "
                           f"tests/data/jpeg_blocks.npz (1, 3 channels) "
                           f"{same['gray'][0]}, {same['rgb'][0]}; their "
                           f"decoding as tensorstore's "
                           f"{same['gray'][1]}, {same['rgb'][1]}")
    return {kname: int(k) for kname, k in launched.items()}


def fleet_phase(torch, cfg, weights=None):
    """Phase 18: ``fleet-run`` drains phase 10's volume through a SIGKILL.

    Phase 10's seeded input volume and output volume, and a ``file://``
    queue of its 8 tasks filled by ``generate-tasks`` with this process's
    telemetry on (the traces begin here). ``python -m chunkflow_tpu_torch
    -v --metrics-dir M fleet-run`` runs as a subprocess with ``--min-workers
    1 --max-workers 3`` and a short interval; each worker runs phase 10's
    chain (``cfg["inference"]``; ``weights`` as a ``.pt`` file; a CPU
    rehearsal may slow it with ``cfg["extra_stages"]``) with a
    visibility timeout of ``cfg["visibility"]`` seconds. Once a worker's
    ``/healthz`` (found through its endpoint file) reports the same leases
    over more than a supervisor tick, the phase SIGKILLs it; ``fleet-status``
    answers during the run; then it SIGTERMs another worker holding
    leases, which must exit 143 within the supervisor's grace. Required: every task of the output volume
    bitwise ``Inferencer.__call__`` on its cutout, cropped; the queue empty,
    no dead letters, the ledger full; each trace committed once, the killed
    worker's unfinished traces by other workers well inside the visibility
    timeout; a scale-up, the killed worker reaped as a death, a lease
    force-released (``fleet/leases_nacked``); each other worker launched
    each kernel ``per_task`` times per computed task (its run counters);
    ``log-summary --fleet --trace-id`` and ``--export-trace`` show the hop
    (one process per worker, the trace as a flow). Printed: the wall time
    with start-up and tasks/s against phase 10's in-process worker, the
    worker count over time, kill-to-recommit seconds, per worker its
    commits, dominant stall, largest host RSS and device peak, and the
    cold start."""
    import shutil
    import signal
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core.bbox import BoundingBoxes
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.log_summary import (
        load_telemetry_dir,
        summarize_fleet,
    )
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.parallel import restapi
    from chunkflow_tpu_torch.parallel.fleet import (
        _proc_rss_gb,
        host_available_gb,
    )
    from chunkflow_tpu_torch.parallel.lifecycle import FileLedger
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    on_card = cfg["device"] == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    pin, overlap, batch, margin = (cfg["pin"], cfg["overlap"], cfg["batch"],
                                   cfg["margin"])
    roi_start, roi_size = cfg["roi"]
    task = cfg["task"]
    chunk_in = tuple(t + 2 * m for t, m in zip(task, margin))
    per_task = len(pad_to_batch(enumerate_patches(chunk_in, pin, pin,
                                                  overlap), batch)[0]) // batch
    boxes = list(BoundingBoxes.from_manual_setup(
        chunk_size=task, roi_start=roi_start, roi_size=roi_size))

    def nums(triple):
        return [str(v) for v in triple]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        tmp = Path(tmp)
        inference = list(cfg["inference"])
        if weights is not None:
            weights_pt = str(tmp / "unet3d_seed0.pt")
            torch.save(weights, weights_pt)
            inference += ["--weight-path", weights_pt]
        image = np.random.default_rng(10).integers(0, 256, cfg["volume"],
                                                   dtype=np.uint8)
        vol_in, out = str(tmp / "image"), str(tmp / "out")
        PrecomputedVolume.create(vol_in, volume_size=cfg["volume"],
                                 voxel_size=VOXEL_NM,
                                 block_size=cfg["volume_block"])
        PrecomputedVolume(vol_in).save(Chunk(image, voxel_size=VOXEL_NM))
        metrics, ledger = tmp / "events", str(tmp / "ledger")
        queue = f"file://{tmp}/queue"
        require(cli.main(dev_args + [
            "create-info", "-v", out, "-c", "3", "--dtype", "float32",
            "--volume-size", *nums(roi_size), "--voxel-size",
            *nums(VOXEL_NM), "--voxel-offset", *nums(roi_start),
            "--block-size", *nums(cfg["out_block"])]) == 0
            and cli.main(dev_args + [
                "--metrics-dir", str(metrics), "generate-tasks",
                "--volume-path", out, "--chunk-size", *nums(task),
                "--queue-name", queue]) == 0,
            "fleet: setting up the volumes and the queue failed")
        require(len(open_queue(queue)) == len(boxes),
                f"fleet: the queue holds {len(open_queue(queue))} tasks")

        # the reference: Inferencer.__call__ on each task's cutout
        framework = inference[inference.index("--framework") + 1]
        variant = (inference[inference.index("--model-variant") + 1]
                   if "--model-variant" in inference else None)
        inferencer = Inferencer(
            input_patch_size=pin, output_patch_overlap=overlap,
            num_output_channels=3, framework=framework,
            model_variant=variant, batch_size=batch,
            weight_path=weights_pt if weights is not None else None,
            device=cfg["device"])
        refs = []
        for bbox in boxes:
            src = bbox.adjust(margin)
            got = inferencer(Chunk(image[src.slices], voxel_offset=src.start,
                                   voxel_size=VOXEL_NM))
            refs.append(got.crop_margin(margin).host().array)
        del inferencer
        if on_card:
            torch.cuda.empty_cache()

        stages = " ".join(
            ["load-precomputed", "-v", vol_in, "-e", *nums(margin),
             *cfg.get("extra_stages", ()), "inference", *inference, "--input-patch-size", *nums(pin),
             "--output-patch-overlap", *nums(overlap),
             "--output-crop-margin", *nums(margin),
             "--num-output-channels", "3", "--batch-size", str(batch),
             "--async-depth", "2", "save-precomputed", "-v", out,
             "--async-write", "delete-task-in-queue"])
        env = {k: v for k, v in os.environ.items() if k != "CHUNKFLOW_CHAOS"}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        # a page alert's automatic profiler capture would slow one worker
        env["CHUNKFLOW_PROFILE_ON_ANOMALY"] = "0"
        lo, hi = cfg["workers"]
        cmd = [sys.executable, "-m", "chunkflow_tpu_torch", *dev_args, "-v",
               "--metrics-dir", str(metrics), "fleet-run", "-q", queue,
               "--min-workers", str(lo), "--max-workers", str(hi),
               # probation of 3 s: a drained worker's listener closes
               # before it exits
               "--interval", "0.25", "--probe-misses", "12",
               "--scale-up-backlog", "2", "--idle-ticks", "2",
               "-v", str(cfg["visibility"]), "-r", "20",
               "--mem-watermark-gb", str(FLEET_HOST_FLOOR_GB),
               "--poll-interval", "0.25", "--max-retries", "3",
               "--ledger", ledger, "--max-runtime", str(cfg["runtime"]),
               "-w", stages]
        available = [host_available_gb()]
        phase("fleet", f"host memory available "
                       f"{available[0] or float('nan'):.1f} GiB, this "
                       f"process's RSS "
                       f"{_proc_rss_gb(os.getpid()) or float('nan'):.2f} GiB; "
                       f"scale-ups keep {FLEET_HOST_FLOOR_GB} GiB free")
        started = time.time()
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        log = []
        reader = threading.Thread(target=lambda: log.extend(proc.stdout),
                                  daemon=True)
        reader.start()
        rss, victim, killed_at, status, drained = {}, None, None, None, None

        def endpoints():
            records = []
            for path in metrics.glob("endpoint-fleet-w*.json"):
                try:
                    records.append(json.loads(path.read_text()))
                except ValueError:
                    pass
            return records

        def run(args):
            """A command of the port's CLI in this process: its stdout."""
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main(dev_args + args)
            require(rc == 0, f"fleet: {args} failed, rc {rc}")
            return text.getvalue()

        def handles(record):
            sample = restapi.scrape_worker(
                f"127.0.0.1:{record['metrics_port']}", timeout=1.0)
            return (sample.get("healthz") or {}).get("inflight_handles")

        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > cfg["runtime"] + 60:
                    raise SmokeFailure("fleet: fleet-run outlived its "
                                       "--max-runtime")
                available.append(host_available_gb())
                for record in endpoints():
                    gb = _proc_rss_gb(record["pid"])
                    if gb is not None:
                        rss[record["worker"]] = max(
                            gb, rss.get(record["worker"], 0.0))
                if victim is None:
                    for record in endpoints():
                        held = handles(record)
                        if held:
                            time.sleep(0.4)  # more than one tick
                            if handles(record) == held:
                                os.kill(record["pid"], signal.SIGKILL)
                                killed_at, victim = time.time(), record
                                break
                elif status is None and len(endpoints()) > 1:
                    status = run(["--metrics-dir", str(metrics),
                                  "fleet-status", "-q", queue, "--timeout",
                                  "2"])
                elif drained is None:
                    # a preemption notice to a busy worker: it must nack,
                    # flush and exit 143 within the supervisor's grace
                    for record in endpoints():
                        if record["worker"] != victim["worker"] \
                                and handles(record):
                            os.kill(record["pid"], signal.SIGTERM)
                            drained = (record["worker"], time.time())
                            break
                time.sleep(0.2)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            reader.join(timeout=10)
        wall = time.perf_counter() - t0
        out_text = "".join(log)
        require(proc.returncode == 0 and "fleet drained:" in out_text,
                f"fleet: fleet-run failed, rc {proc.returncode}: "
                f"{out_text[-3000:]}")
        require(victim is not None, "fleet: no worker held a lease to kill")
        require(status is not None and "fleet " in status
                and "target=" in status and "leases=" in status,
                f"fleet: fleet-status during the run answered {status!r}")

        # the queue, the ledger, the volume
        stats = open_queue(queue).stats()
        require(stats["pending"] == stats["inflight"] == stats["dead"] == 0,
                f"fleet: the queue did not drain: {stats}")
        require(open_queue(queue).dead_letters() == [],
                "fleet: dead letters")
        keys = FileLedger(ledger).keys()
        require(sorted(keys) == sorted(b.string for b in boxes),
                f"fleet: the ledger holds {len(keys)} keys")
        vol = PrecomputedVolume(out)
        for bbox, ref in zip(boxes, refs):
            got = vol.cutout(bbox).array
            require(got.shape == ref.shape and np.array_equal(got, ref),
                    f"fleet: task {bbox.string} differs from its "
                    f"in-process reference")

        # the events: each trace committed once, the hop, the decisions
        events = load_telemetry_dir(str(metrics))
        commits = {}
        for e in events:
            if e.get("name") == "lifecycle/committed":
                commits.setdefault(e["trace_id"], []).append(e)
        require(len(commits) == len(boxes)
                and all(len(v) == 1 for v in commits.values()),
                f"fleet: commits per trace "
                f"{sorted(len(v) for v in commits.values())}")
        vid = victim["worker"]
        held = {e["trace_id"] for e in events if e.get("worker") == vid
                and e.get("name") == "lifecycle/claimed"}
        hopped = sorted(t for t in held if commits[t][0]["worker"] != vid)
        require(bool(hopped), "fleet: the killed worker held no unfinished "
                              "task")
        recommit_s = max(commits[t][0]["t"] for t in hopped) - killed_at
        require(recommit_s < cfg["visibility"] / 2,
                f"fleet: the killed worker's tasks came back after "
                f"{recommit_s:.1f} s (visibility {cfg['visibility']} s)")
        fleet_events = [e for e in events if e.get("kind") == "fleet"]
        require(any(e["name"] == "fleet/scale" and e.get("direction") == "up"
                    for e in fleet_events), "fleet: no scale-up")
        reaped = [e for e in fleet_events if e["name"] == "fleet/exit"
                  and e.get("fleet_worker") == vid]
        require(bool(reaped) and reaped[0]["exit_code"] == -signal.SIGKILL
                and not reaped[0]["expected"],
                f"fleet: the killed worker was not reaped as a death: "
                f"{reaped}")
        require(drained is not None, "fleet: no busy worker to SIGTERM")
        did, termed_at = drained
        exits = [e for e in fleet_events if e["name"] == "fleet/exit"
                 and e.get("fleet_worker") == did]
        drain_s = exits[0]["t"] - termed_at if exits else None
        require(bool(exits) and exits[0]["exit_code"] == 143
                and drain_s < TERM_GRACE_S,
                f"fleet: the SIGTERMed worker {did} exited "
                f"{exits[0]['exit_code'] if exits else None} after "
                f"{drain_s} s, not 143 within {TERM_GRACE_S} s")
        supervisor = [e for e in events if e.get("kind") == "snapshot"
                      and not str(e.get("worker")).startswith("fleet-w")
                      and "fleet/spawns" in (e.get("counters") or {})]
        counters = supervisor[-1]["counters"] if supervisor else {}
        require(counters.get("fleet/leases_nacked", 0) >= 1,
                f"fleet: no lease force-released: {counters}")

        # each worker's launches, from its run counters
        computed, cut = {}, None
        for path in sorted(metrics.glob("worker-fleet-w*.log")):
            wid = path.name[len("worker-"):-len(".log")]
            lines = [ln for ln in path.read_text().splitlines()
                     if ln.startswith("run counters: ")]
            if wid == vid or not lines:
                require(wid == vid or not any(
                    e.get("worker") == wid and e.get("name")
                    == "lifecycle/claimed" for e in events),
                    f"fleet: worker {wid} claimed tasks and printed no run "
                    f"counters")
                continue
            c = json.loads(lines[-1][len("run counters: "):])
            n = c.get("inference/chunks", 0)
            computed[wid] = n
            launched = {k: c.get(f"kernels/{k}", 0)
                        for k in ("gather", "accumulate")}
            if wid == did:
                # the drain may cut forwards short: up to the two tasks
                # of --async-depth 2 were in flight
                cut = launched
                ok = all(per_task * n <= k <= per_task * (n + 2)
                         for k in launched.values())
            else:
                ok = all(k == per_task * n for k in launched.values())
            require(not on_card or ok,
                    f"fleet: worker {wid} launched {launched} for {n} "
                    f"finished tasks, not {per_task} each")

        # log-summary reconstructs the hop
        trace = hopped[0]
        text = run(["log-summary", "--metrics-dir", str(metrics), "--fleet",
                    "--trace-id", trace])
        timeline = text[text.index(f"trace {trace}:"):]
        require(f"[{vid}] task:lifecycle/claimed" in timeline
                and f"[{commits[trace][0]['worker']}] "
                    f"task:lifecycle/committed" in timeline,
                f"fleet: log-summary --trace-id shows no hop: {timeline}")
        export = tmp / "fleet-trace.json"
        text = run(["log-summary", "--metrics-dir", str(metrics),
                    "--export-trace", str(export)])
        require("trace validation" not in text,
                f"fleet: the exported trace is invalid: {text}")
        chrome = json.loads(export.read_text())
        names = {e["args"]["name"] for e in chrome["traceEvents"]
                 if e.get("name") == "process_name"}
        workers = sorted({e["worker"] for e in events
                          if str(e.get("worker")).startswith("fleet-w")})
        require({f"worker {w}" for w in workers} <= names,
                f"fleet: the trace lacks worker processes: {names}")
        flow = [e["ph"] for e in chrome["traceEvents"]
                if e.get("cat") == "task_flow"
                and e["args"].get("trace_id") == trace]
        require(flow[:1] == ["s"] and flow[-1:] == ["f"],
                f"fleet: the hop of {trace} is no flow: {flow}")

        # what the run was
        fleet = summarize_fleet(events)
        sizes, last = [], None
        for e in events:
            if e.get("kind") == "gauge" and e.get("name") == "fleet/workers" \
                    and e["value"] != last:
                last = e["value"]
                sizes.append(f"{e['t'] - started:.1f}s:{last:g}")
        peaks = {}
        for e in events:
            if e.get("kind") == "gauge" and e.get("name") == "device/peak_bytes":
                peaks[e["worker"]] = max(e["value"], peaks.get(e["worker"], 0))
        first = {}
        for name in ("fleet/start", "lifecycle/claimed",
                     "lifecycle/committed"):
            ts = [e["t"] for e in events if e.get("name") == name]
            first[name] = min(ts) - started if ts else float("nan")
        published = [r["t"] - started for r in endpoints()]
        build = [ln for ln in log if ln.startswith("fleet: CUDA kernels")]
        raw = cfg.get("raw_s_per_task")
        phase("fleet", f"fleet-run ({lo}..{hi} workers, interval 0.25 s) "
                       f"drained {len(boxes)} tasks of {task} in {wall:.2f} "
                       f"s with start-up, {len(boxes) / wall:.3f} tasks/s "
                       f"(phase 10's in-process worker: "
                       + (f"{1 / raw:.3f} tasks/s" if raw else "not run")
                       + f"); workers over time {' '.join(sizes)}; "
                       + [ln for ln in log
                          if ln.startswith("fleet drained:")][-1].strip())
        require(cut is not None, f"fleet: the drained worker {did} printed "
                                 f"no run counters")
        phase("fleet", f"SIGTERMed {did} holding leases: exit 143 "
                       f"{drain_s:.2f} s after (grace {TERM_GRACE_S} s), "
                       f"{computed[did]} task(s) finished and launches "
                       f"{cut} ("
                       + ("a forward cut short" if any(
                           k != per_task * computed[did]
                           for k in cut.values()) else "none cut short")
                       + "), its tasks handed back and committed by others")
        phase("fleet", f"SIGKILLed {vid} holding {len(hopped)} unfinished "
                       f"task(s); recommitted by "
                       f"{sorted({commits[t][0]['worker'] for t in hopped})} "
                       f"{recommit_s:.2f} s after the kill (visibility "
                       f"{cfg['visibility']} s); force-released "
                       f"{counters.get('fleet/leases_nacked', 0):g} lease(s); "
                       f"output == in-process reference bitwise; each trace "
                       f"committed once; queue {stats}; "
                       f"{per_task} + {per_task} launches per computed task "
                       f"in {sorted(computed.items())}")
        for wid in workers:
            info = fleet.get(wid, {})
            peak = peaks.get(wid)
            phase("fleet", f"{wid}: committed {info.get('committed', 0):g}, "
                           f"dominant stall {info.get('dominant')}, host RSS "
                           + (f"{rss[wid]:.2f} GiB" if wid in rss
                              else "not sampled")
                           + ", device peak "
                           + (f"{peak / 2**30:.2f} GiB" if peak
                              else "not reported"))
        phase("fleet", f"cold start: "
                       + (build[-1].strip() if build else "no kernel build")
                       + f"; least host memory available during the run "
                       + (f"{min(a for a in available if a is not None):.1f}"
                          f" GiB" if any(a is not None for a in available)
                          else "not read")
                       + f"; from launch, the supervisor's first tick "
                       f"{first['fleet/start']:.2f} s, first endpoint "
                       f"published {min(published):.2f} s, first claim "
                       f"{first['lifecycle/claimed']:.2f} s, first commit "
                       f"{first['lifecycle/committed']:.2f} s; fleet-status "
                       f"answered during the run; log-summary --trace-id "
                       f"and --export-trace ({len(names)} processes) show "
                       f"the hop")
        shutil.rmtree(out, ignore_errors=True)


CHANNEL_PLUGIN = '''from chunkflow_tpu_torch import Chunk


def execute(chunk, channel=1):
    """One channel of a czyx chunk, kept where it lies."""
    return Chunk(chunk.array[channel:channel + 1],
                 voxel_offset=chunk.voxel_offset,
                 voxel_size=chunk.voxel_size)
'''
PRE_SITES_PLUGIN = '''def execute(synapses):
    """The T-bars as a point cloud."""
    return synapses.pre_point_cloud
'''
SKELETONS_PLUGIN = '''import os

from chunkflow_tpu_torch.annotations.skeleton import Skeleton


def execute(path=""):
    """The aggregated skeletons in ``path``, by object id."""
    out = {}
    for name in sorted(os.listdir(path), key=int):
        with open(os.path.join(path, name), "rb") as f:
            out[int(name)] = Skeleton.from_precomputed_bytes(f.read())
    return out
'''


def annotations_phase(torch, cfg, weights, reset_counts, counts):
    """Phase 19: a synapse-detection worker and skeletons, through the
    port's CLI in process.

    a. Phase 10's seeded input over the first task box of its roi (and
       the margin) as a precomputed volume, then one chain: ``create-bbox
       | load-precomputed -e margin | inference`` (``cfg["inference"]``,
       ``weights`` as a ``.pt`` file, cropped to the task) ``| plugin
       detect_pre_synapses`` (channel 0) ``| plugin`` (channel 1, a plugin
       of the phase) ``| plugin detect_post_synapses`` (search radius
       ``cfg["search_radius"]`` nm) ``| plugin adjust_pre | load-npy``
       (``cfg["segmentation"]``, phase 16's stitched labels of the roi,
       over the same box) ``| plugin detect_duplicate_post | plugin
       find_tbar_object | save-synapses`` (json) ``| save-points`` (the
       T-bars, npy) ``| load-synapses``. Required: ``per_task`` launches
       of each blend kernel; the synapses read back equal to those saved,
       the npy their T-bars; the chain's synapses and T-bar ids bitwise
       the same plugins on a ``.host()`` copy of the inference output;
       T-bars and posts found. Printed: the counts, ms per operator
       (``op/<name>`` spans) and s/task beside phase 10's.
    b. ``plugin skeletonize`` (``cfg["skeleton_threshold"]`` voxels,
       ``cfg["max_paths"]`` paths) on two adjacent ``cfg["skeleton_crop"]``
       crops of the segmentation, writing fragments;
       ``aggregate-skeleton-fragments``; the aggregated skeletons
       (a plugin of the phase reads them) through ``save-swc`` and each
       back through ``load-skeleton``. Required: the aggregated objects
       are the union of the fragments' ids, each one tree, and each swc
       read back holds its skeleton's nodes and parents. Printed: the
       cuts, objects, nodes, ms per object, cable length.

    Returns the blend kernels' launches in (a)."""
    import shutil
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import BoundingBox, Cartesian, Chunk
    from chunkflow_tpu_torch.annotations.skeleton import Skeleton
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.plugin import load_plugin
    from chunkflow_tpu_torch.flow.runtime import new_task
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    t_phase = time.perf_counter()
    on_card = cfg["device"] == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    pin, overlap, batch, margin = (cfg["pin"], cfg["overlap"], cfg["batch"],
                                   cfg["margin"])
    roi_start = cfg["roi"][0]
    box = BoundingBox.from_delta(roi_start, cfg["task"])
    src = box.adjust(margin)
    per_task = len(pad_to_batch(enumerate_patches(tuple(src.shape), pin, pin,
                                                  overlap), batch)[0]) // batch

    def nums(triple):
        return [str(v) for v in triple]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run_chain(argv):
        """The chain's tasks, through the CLI's stages in this process."""
        _, stages = cli.build_stages(dev_args + argv)
        chain = iter([new_task()])
        for stage in stages:
            chain = stage(chain)
        return [task for task in chain if task is not None]

    def span_ms(snap, name):
        h = snap["hists"].get(f"op/{name}")
        return h["total"] * 1e3 if h else 0.0

    def same(a, b):
        """Two synapse sets (or id arrays) hold the same arrays."""
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        fields = ("pre", "post", "pre_confidence", "post_confidence")
        return tuple(a.resolution) == tuple(b.resolution) and all(
            (getattr(a, f) is None) == (getattr(b, f) is None)
            and (getattr(a, f) is None or same(getattr(a, f), getattr(b, f)))
            for f in fields)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_annotations_") as tmp:
        tmp = Path(tmp)
        weights_pt = str(tmp / "unet3d_seed0.pt")
        torch.save(weights, weights_pt)
        for name, text in (("channel.py", CHANNEL_PLUGIN),
                           ("pre_sites.py", PRE_SITES_PLUGIN),
                           ("skeletons.py", SKELETONS_PLUGIN)):
            (tmp / name).write_text(text)
        # ---- a. the synapse worker --------------------------------------
        image = np.random.default_rng(10).integers(0, 256, cfg["volume"],
                                                   dtype=np.uint8)
        vol_in = str(tmp / "image")
        PrecomputedVolume.create(vol_in, volume_size=cfg["volume"],
                                 voxel_size=VOXEL_NM,
                                 block_size=cfg["volume_block"])
        PrecomputedVolume(vol_in).save(Chunk(
            image[src.slices], voxel_offset=src.start, voxel_size=VOXEL_NM))
        del image
        labels = np.load(cfg["segmentation"], mmap_mode="r")
        seg_npy = str(tmp / "seg_task.npy")
        np.save(seg_npy, np.ascontiguousarray(
            labels[box.translate(-Cartesian(*roi_start)).slices]))
        out = tmp / "synapses"
        out.mkdir()
        radius = cfg["search_radius"]
        argv = [
            "create-bbox", "-s", *nums(box.start), "--size", *nums(box.shape),
            "load-precomputed", "-v", vol_in, "-e", *nums(margin),
            "inference", *cfg["inference"], "--weight-path", weights_pt,
            "--input-patch-size", *nums(pin),
            "--output-patch-overlap", *nums(overlap),
            "--output-crop-margin", *nums(margin),
            "--num-output-channels", "3", "--batch-size", str(batch),
            "-o", "prob",
            "plugin", "-n", "detect_pre_synapses", "-i", "prob", "-o",
            "synapses",
            "plugin", "-n", str(tmp / "channel.py"), "-i", "prob", "-o",
            "post_prob", "-a", "channel=1",
            "plugin", "-n", "detect_post_synapses", "-i",
            "synapses,post_prob", "-o", "synapses", "-a",
            f"search_radius={radius}",
            "plugin", "-n", "adjust_pre", "-i", "synapses,prob", "-o",
            "synapses",
            "load-npy", "-f", seg_npy, "--voxel-offset", *nums(box.start),
            "--voxel-size", *nums(VOXEL_NM), "-o", "seg",
            "plugin", "-n", "detect_duplicate_post", "-i", "synapses,seg",
            "-o", "synapses",
            "plugin", "-n", "find_tbar_object", "-i", "synapses,seg", "-o",
            "tbar_ids",
            "plugin", "-n", str(tmp / "pre_sites.py"), "-i", "synapses",
            "-o", "pre_sites",
            "save-synapses", "-f", str(out / "synapses.json"),
            "save-points", "-i", "pre_sites", "-f", str(out / "pre.npy"),
            "load-synapses", "-f", str(out / "synapses.json"), "-o",
            "loaded"]
        telemetry.reset()
        reset_counts()
        printed = io.StringIO()
        sync()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            tasks = run_chain(argv)
        sync()
        wall = time.perf_counter() - t
        launched = counts()
        snap = telemetry.snapshot()
        require(len(tasks) == 1, f"annotations: {len(tasks)} tasks came out")
        task = tasks[0]
        for kname, n in launched.items():
            require(not on_card or n == per_task,
                    f"annotations: {kname} launched {n} times, not "
                    f"{per_task}")
        prob = task["prob"]
        require(prob.is_on_device == on_card and prob.bbox == box,
                f"annotations: the inference output {prob!r} is not the "
                f"task's on {cfg['device']}")
        syn, ids = task["synapses"], task["tbar_ids"]
        require(same(task["loaded"], syn),
                "annotations: the synapses read back differ from those "
                "saved")
        require(same(np.load(out / "pre.npy"), syn.pre.copy()),
                "annotations: the saved T-bar points differ")
        # the same plugins on a host copy of the inference output
        host = prob.host()
        run = {name: load_plugin(name) for name in (
            "detect_pre_synapses", "detect_post_synapses", "adjust_pre",
            "detect_duplicate_post", "find_tbar_object")}
        with contextlib.redirect_stdout(io.StringIO()):
            ref = run["detect_pre_synapses"](host)
            ref = run["detect_post_synapses"](
                ref, Chunk(host.array[1:2], voxel_offset=host.voxel_offset,
                           voxel_size=host.voxel_size), search_radius=radius)
            ref = run["adjust_pre"](ref, host)
            ref = run["detect_duplicate_post"](ref, task["seg"])
            ref_ids = run["find_tbar_object"](ref, task["seg"])
        require(same(syn, ref) and same(ids, ref_ids),
                "annotations: the chain's synapses differ from the same "
                "plugins on a host copy of the inference output")
        require(syn.pre_num > 0 and syn.post_num > 0,
                f"annotations: {syn.pre_num} T-bars, {syn.post_num} posts")
        ops = list(task["log"]["timer"])
        raw = cfg.get("raw_s_per_task")
        phase("annotations", f"19a: task {box.string} ({cfg['inference']}, "
                             f"{' '.join(printed.getvalue().split())}): "
                             f"{syn.pre_num} T-bars, {syn.post_num} "
                             f"post-synapses on {syn.pre_with_post_num} of "
                             f"them, {int(np.count_nonzero(ids))} T-bars on "
                             f"labelled objects; launches {launched}; "
                             f"synapses == the plugins on a host copy "
                             f"bitwise; json and npy read back equal")
        phase("annotations", f"19a: {wall:.4f} s/task (phase 10's worker "
                             + (f"{raw:.4f}" if raw else "not run")
                             + "); ms per operator: " + ", ".join(
                                 f"{name.replace(str(tmp) + os.sep, '')} "
                                 f"{span_ms(snap, name):.1f}"
                                 for name in ops))
        del task, tasks, prob, host
        # ---- b. skeletons -----------------------------------------------
        crop = cfg["skeleton_crop"]
        frags, agg, swc = tmp / "frags", tmp / "agg", tmp / "swc"
        swc.mkdir()
        telemetry.reset()
        made = {}
        for k in range(2):
            rel = BoundingBox.from_delta((0, 0, k * crop[2]), crop)
            crop_npy = str(tmp / f"crop{k}.npy")
            np.save(crop_npy, np.ascontiguousarray(labels[rel.slices]))
            with contextlib.redirect_stdout(printed):
                (task,) = run_chain([
                    "load-npy", "-f", crop_npy, "--voxel-offset",
                    *nums(rel.translate(Cartesian(*roi_start)).start),
                    "--voxel-size", *nums(VOXEL_NM), "-o", "seg",
                    "plugin", "-n", "skeletonize", "-i", "seg", "-o",
                    "skels", "-a",
                    f"voxel_num_threshold={cfg['skeleton_threshold']};"
                    f"max_paths={cfg['max_paths']};output_path={frags}"])
            made[k] = task["skels"]
        del labels
        skel_ms = span_ms(telemetry.snapshot(), "plugin-skeletonize")
        frag_ids = {name.split(":")[0] for name in os.listdir(frags)}
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            require(cli.main(dev_args + [
                "aggregate-skeleton-fragments", "-f", str(frags), "-o",
                str(agg)]) == 0, "annotations: aggregation failed")
        agg_ms = (time.perf_counter() - t) * 1e3
        require(set(os.listdir(agg)) == frag_ids and frag_ids,
                f"annotations: {len(os.listdir(agg))} aggregated objects, "
                f"{len(frag_ids)} fragment ids")
        ids = sorted(int(i) for i in frag_ids)
        argv = ["plugin", "-n", str(tmp / "skeletons.py"), "-i", "", "-o",
                "skels", "-a", f"path={agg}",
                "save-swc", "-i", "skels", "-f", str(swc / "obj-")]
        for obj_id in ids:
            argv += ["load-skeleton", "-f", str(swc / f"obj-{obj_id}.swc"),
                     "-o", f"swc-{obj_id}"]
        telemetry.reset()
        (task,) = run_chain(argv)
        snap = telemetry.snapshot()
        nodes = cable = 0
        for obj_id in ids:
            merged, back = task["skels"][obj_id], task[f"swc-{obj_id}"]
            require(int((merged.parents == -1).sum()) == 1,
                    f"annotations: aggregated skeleton {obj_id} is not one "
                    f"tree")
            require(isinstance(back, Skeleton) and len(back) == len(merged)
                    and np.array_equal(back.parents, merged.parents)
                    and np.array_equal(back.nodes, merged.nodes),
                    f"annotations: the swc of {obj_id} reads back "
                    f"different")
            nodes += len(merged)
            cable += merged.cable_length()
        spans = sum(len(made[k]) for k in made)
        phase("annotations", f"19b: cuts: two adjacent {crop} crops of "
                             f"phase 16's segmentation, "
                             f"voxel_num_threshold "
                             f"{cfg['skeleton_threshold']}, max_paths "
                             f"{cfg['max_paths']}: {len(made[0])} + "
                             f"{len(made[1])} skeletons "
                             f"({skel_ms:.1f} ms, "
                             f"{skel_ms / max(spans, 1):.1f} ms per object), "
                             f"{len(ids)} objects aggregated in "
                             f"{agg_ms:.1f} ms, {nodes} nodes, one tree "
                             f"each, cable {cable / 1e3:.1f} um; save-swc "
                             f"{span_ms(snap, 'save-swc'):.1f} ms, "
                             f"load-skeleton "
                             f"{span_ms(snap, 'load-skeleton'):.1f} ms; each "
                             f"swc read back equal")
        shutil.rmtree(frags)
    phase("annotations", f"phase 19 took {time.perf_counter() - t_phase:.1f}"
                         f" s")
    return launched


def cloud_phase(torch, cfg, weights, reset_counts, counts):
    """Phase 20: phase 10's worker on the cloud plane, against local fakes
    of GCS, S3, SQS and CloudWatch in a process of their own
    (``python -m chunkflow_tpu_torch.testing.cloud_fakes``: SigV4 checked
    on S3 and SQS, GCS bearer tokens from a service-account file's JWT on
    the fake's token endpoint, ``cfg["fail_rate"]`` seeded 503s).

    Phase 10's seeded uint8 input is copied to ``gs://chunkflow-in/img``
    through the port's ``GCSKV`` (MB/s); ``s3://chunkflow-out/aff`` is
    created as phase 17's sharded raw float32 output (shards holding
    chunks of several tasks, one of which the S3 fake answers once with a
    forced 412); the task grid goes to ``sqs://tasks`` (visibility
    ``cfg["visibility"]`` s). Two worker processes run ``fetch-task-from-
    queue -q sqs://tasks | load-precomputed -v gs://... | inference |
    save-precomputed -v s3://... --async-write | delete-task-in-queue``;
    one is SIGKILLed at its first commit, the other drains the queue,
    taking the killed worker's tasks when their leases lapse (a third
    worker takes them when the survivor's last long poll, which the SQS
    fake caps at ``cfg["long_poll"]`` s, ended first). Required: the output volume bitwise
    ``Inferencer.__call__`` on each cutout, each task acked once, the
    queue and ``tasks-dead`` empty, ``per_task`` launches of each kernel
    per computed task in the survivor's run counters, a 412 on a shared
    shard. Then the same chain in this process, into a fresh output and
    queue: bitwise, counted and timed: s/task, Mvox/s, requests by verb
    per task, bytes, retries, 412s, host ms in ``storage/read``,
    ``storage/write`` and ``lifecycle/commit``; and that run's telemetry
    snapshot published through the ``aws/cloud_watch`` plugin (the port's
    own SigV4 ``PutMetricData`` client) to the CloudWatch fake under
    ``cfg["namespace"]``: batches of at most 20, each datum with its
    ``worker`` dimension, the count printed.

    Returns the kernels' launches in the in-process run."""
    import itertools
    import signal
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.core.bbox import BoundingBoxes
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import process_stream
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.parallel.queues import SQSQueue
    from chunkflow_tpu_torch.testing import cloud_fakes
    from chunkflow_tpu_torch.volume import storage
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume
    from chunkflow_tpu_torch.volume.sharding import (
        ShardingSpec,
        compressed_morton_code,
    )

    t_phase = time.perf_counter()
    on_card = cfg["device"] == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    pin, overlap, batch, margin = (cfg["pin"], cfg["overlap"], cfg["batch"],
                                   cfg["margin"])
    roi_start, roi_size = cfg["roi"]
    task = cfg["task"]
    chunk_in = tuple(t + 2 * m for t, m in zip(task, margin))
    per_task = len(pad_to_batch(enumerate_patches(chunk_in, pin, pin,
                                                  overlap), batch)[0]) // batch
    boxes = list(BoundingBoxes.from_manual_setup(
        chunk_size=task, roi_start=roi_start, roi_size=roi_size))
    vox_in = int(np.prod(chunk_in))
    vol_in = "gs://chunkflow-in/img"
    spec = ShardingSpec(cfg["shard_out"])
    key = ROOT / "tests" / "data" / "gcs_test_key.pem"

    def nums(triple):
        return [str(v) for v in triple]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # the shards of the output and the tasks whose chunks each holds
    grid = [r // b for r, b in zip(roi_size, cfg["out_block"])]
    held = {}
    for z, y, x in itertools.product(*map(range, grid)):
        cid = compressed_morton_code((x, y, z), grid[::-1])
        owner = tuple(i * b // t for i, b, t in zip((z, y, x),
                                                     cfg["out_block"], task))
        held.setdefault(spec.locate(cid)[0], set()).add(owner)
    require(min(len(v) for v in held.values()) > 1,
            "cloud: a shard of the output holds one task's chunks only")
    shared = min(held, key=lambda s: (-len(held[s]), s))
    scale_key = "_".join(str(v) for v in VOXEL_NM[::-1])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cloud_") as tmp:
        tmp = Path(tmp)
        env = {k: v for k, v in os.environ.items() if k != "CHUNKFLOW_CHAOS"}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        fakes, urls = cloud_fakes.spawn(str(tmp / "fakes.json"), sigv4=True,
                                        key=str(key),
                                        fail_rate=cfg["fail_rate"], seed=20,
                                        env=env)
        saved_env = dict(os.environ)
        try:
            sa = cloud_fakes.service_account_file(
                str(tmp / "sa.json"), str(key), urls["gcs"] + "/token")
            os.environ.update(cloud_fakes.cloud_env(
                gcs=urls["gcs"], s3=urls["s3"], sqs=urls["sqs"],
                credentials=sa, cloudwatch=urls["cloudwatch"]))
            os.environ["HOME"] = str(tmp / "home")
            env = {k: v for k, v in os.environ.items()
                   if k != "CHUNKFLOW_CHAOS"}
            env["CHUNKFLOW_PROFILE_ON_ANOMALY"] = "0"

            def stats(name):
                return cloud_fakes.control(urls[name])

            # a worker with -r 0 ends at its first empty long poll
            long_poll = cfg.get("long_poll", 20)
            cloud_fakes.control(urls["sqs"], max_wait_s=long_poll)

            # ---- the input, the output, the queue ------------------------
            image = np.random.default_rng(10).integers(
                0, 256, cfg["volume"], dtype=np.uint8)
            t = time.perf_counter()
            PrecomputedVolume.create(vol_in, volume_size=cfg["volume"],
                                     voxel_size=VOXEL_NM,
                                     block_size=cfg["volume_block"])
            PrecomputedVolume(vol_in).save(Chunk(image,
                                                 voxel_size=VOXEL_NM))
            up_s = time.perf_counter() - t
            storage.reset_shared_cache()
            gcs_up = stats("gcs")
            phase("cloud", f"fakes at {urls['gcs']}, {urls['s3']}, "
                           f"{urls['sqs']}, {urls['cloudwatch']} (SigV4 "
                           f"checked, bearer tokens "
                           f"from a service account's JWT, "
                           f"{cfg['fail_rate']:.0%} seeded 503s); input "
                           f"{cfg['volume']} uint8 to {vol_in} in blocks of "
                           f"{cfg['volume_block']}: {up_s:.3f} s, "
                           f"{image.nbytes / up_s / 1e6:.1f} MB/s "
                           f"({gcs_up['requests']} requests, "
                           f"{gcs_up['faults_503']} 503s retried)")

            def output(name, queue):
                out = f"s3://chunkflow-out/{name}"
                PrecomputedVolume.create(
                    out, volume_size=roi_size, voxel_size=VOXEL_NM,
                    voxel_offset=roi_start, num_channels=3,
                    dtype="float32", block_size=cfg["out_block"],
                    sharding=cfg["shard_out"])
                SQSQueue(queue, visibility_timeout=cfg["visibility"]) \
                    .send_messages([b.string for b in boxes])
                cloud_fakes.control(urls["s3"], race=[
                    f"{name}/{scale_key}/{spec.shard_name(shared)}"])
                return out, f"sqs://{queue}"

            inference = list(cfg["inference"])
            weights_pt = None
            if weights is not None:
                weights_pt = str(tmp / "unet3d_seed0.pt")
                torch.save(weights, weights_pt)
                inference += ["--weight-path", weights_pt]

            def worker_args(queue, out, polls, num=-1):
                return ["fetch-task-from-queue", "-q", queue,
                        "--max-retries", "3", "--visibility-timeout",
                        str(cfg["visibility"]), "--lease-renew", "1",
                        "-r", str(polls), "--poll-interval", "0.5",
                        "--num", str(num),
                        "load-precomputed", "-v", vol_in, "-e",
                        *nums(margin), "inference", *inference,
                        "--input-patch-size", *nums(pin),
                        "--output-patch-overlap", *nums(overlap),
                        "--output-crop-margin", *nums(margin),
                        "--num-output-channels", "3", "--batch-size",
                        str(batch), "--async-depth", "2",
                        "save-precomputed", "-v", out, "--async-write",
                        "delete-task-in-queue"]

            # ---- the reference --------------------------------------------
            framework = inference[inference.index("--framework") + 1]
            variant = (inference[inference.index("--model-variant") + 1]
                       if "--model-variant" in inference else None)
            inferencer = Inferencer(
                input_patch_size=pin, output_patch_overlap=overlap,
                num_output_channels=3, framework=framework,
                model_variant=variant, batch_size=batch,
                weight_path=weights_pt, device=cfg["device"])
            refs = []
            for bbox in boxes:
                src = bbox.adjust(margin)
                got = inferencer(Chunk(image[src.slices],
                                       voxel_offset=src.start,
                                       voxel_size=VOXEL_NM))
                refs.append(got.crop_margin(margin).host().array)
            del inferencer
            if on_card:
                torch.cuda.empty_cache()

            def check_volume(out, what):
                storage.reset_shared_cache()
                vol = PrecomputedVolume(out)
                for bbox, ref in zip(boxes, refs):
                    got = vol.cutout(bbox).array
                    require(got.shape == ref.shape
                            and np.array_equal(got, ref),
                            f"cloud: {what}: task {bbox.string} differs "
                            f"from its in-process reference")

            def drained(queue):
                q = SQSQueue(queue[len("sqs://"):],
                             visibility_timeout=cfg["visibility"])
                got = q.stats()
                require(got["pending"] == got["inflight"] == got["dead"]
                        == 0, f"cloud: {queue} did not drain: {got}")
                return got

            # ---- two worker processes, one SIGKILLed ----------------------
            out, queue = output("aff", "tasks")
            metrics = str(tmp / "events")
            for name in ("s3", "sqs"):
                cloud_fakes.control(urls[name], reset_stats=True)
            cmd = [sys.executable, "-m", "chunkflow_tpu_torch", *dev_args,
                   "-v", "--metrics-dir", metrics]
            t = time.perf_counter()
            def start(chaos=None):
                return subprocess.Popen(
                    cmd + worker_args(queue, out, 0), cwd=ROOT,
                    env=dict(env, **({"CHUNKFLOW_CHAOS": chaos}
                                     if chaos else {})),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)

            def finish(proc, what):
                """A worker's run counters once it has drained."""
                try:
                    stdout, stderr = proc.communicate(
                        timeout=cfg["worker_s"])
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                require(proc.returncode == 0, f"cloud: {what} failed, rc "
                                              f"{proc.returncode}: "
                                              f"{stderr[-3000:]}")
                line = [ln for ln in stdout.splitlines()
                        if ln.startswith("run counters: ")]
                require(bool(line), f"cloud: {what} printed no counters")
                return json.loads(line[-1][len("run counters: "):])

            # the other worker starts once this one holds a task, so that
            # it has one to die with at its first commit
            killed = start("once=lifecycle/pre_ledger:action=kill")
            watch = SQSQueue(queue[len("sqs://"):],
                             visibility_timeout=cfg["visibility"])
            while not watch.stats()["inflight"]:
                require(killed.poll() is None
                        and time.perf_counter() - t < cfg["worker_s"],
                        "cloud: the first worker claimed no task")
                time.sleep(0.2)
            survivor = start()
            try:
                _, k_err = killed.communicate(timeout=cfg["worker_s"])
            finally:
                if killed.poll() is None:
                    killed.kill()
                    killed.wait()
            kill_s = time.perf_counter() - t
            require(killed.returncode == -signal.SIGKILL,
                    f"cloud: the worker was to die by SIGKILL, rc "
                    f"{killed.returncode}: {k_err[-3000:]}")
            runs = [finish(survivor, "the surviving worker")]
            # the survivor ends at its first empty long poll; had it
            # begun before the killed worker's leases lapsed, a third
            # worker takes what they held
            q_left = watch.stats()
            if q_left["pending"] or q_left["inflight"]:
                runs.append(finish(start(), "the third worker"))
            wall = time.perf_counter() - t
            counters = runs[0]
            n = sum(c.get("inference/chunks", 0) for c in runs)
            for c in runs:
                for kname in ("gather", "accumulate"):
                    k = c.get("inference/chunks", 0)
                    require(not on_card
                            or c.get(f"kernels/{kname}") == per_task * k,
                            f"cloud: a worker launched {kname} "
                            f"{c.get(f'kernels/{kname}')} times for {k} "
                            f"tasks, not {per_task} each")
            acks = {b.string: 0 for b in boxes}
            for event in metrics_events(metrics):
                if event.get("name") == "lifecycle/committed":
                    acks[event["body"]] += 1
            require(set(acks.values()) == {1},
                    f"cloud: acks per task {acks}, not one each")
            left = drained(queue)
            check_volume(out, "the two workers' volume")
            s3_run, sqs_run = stats("s3"), stats("sqs")
            s3_412 = s3_run["status"].get("412", 0)
            require(s3_412 >= 1, "cloud: no 412 on a shared shard")
            label = " ".join(v for v in (framework, variant) if v)
            phase("cloud", f"two workers ({label}), one "
                           f"SIGKILLed at its first commit after "
                           f"{kill_s:.1f} s; the survivor"
                           + (" and a third worker" if len(runs) > 1
                              else "")
                           + f" computed {n} of {len(boxes)} tasks, drained "
                             f"in {wall:.1f} s with start-up and the last "
                             f"{long_poll} s long poll (leases of "
                             f"{cfg['visibility']} s); output == in-process "
                             f"reference "
                           f"bitwise; each task acked once; queue {left}; "
                           f"{per_task} + {per_task} launches per computed "
                           f"task; S3 answered {s3_412} 412s "
                           f"({s3_run['forced_412']} forced) and "
                           f"{s3_run['faults_503']} 503s, SQS "
                           f"{sqs_run['faults_503']}; the survivor's "
                           f"storage/http: retries "
                           f"{counters.get('storage/http/retries', 0):g}, "
                           f"412 {counters.get('storage/http/412', 0):g}, "
                           f"shard conflicts "
                           f"{counters.get('storage/shard_conflicts', 0):g}")

            # ---- the same chain in this process ---------------------------
            out, queue = output("aff-run", "tasks-run")
            _, stages = cli.build_stages(
                dev_args + worker_args(queue, out, 0, num=len(boxes)))
            for name in ("gcs", "s3", "sqs"):
                cloud_fakes.control(urls[name], reset_stats=True)
            storage.reset_shared_cache()
            telemetry.reset()
            reset_counts()
            sync()
            t = time.perf_counter()
            done = process_stream(stages)
            sync()
            run_s = time.perf_counter() - t
            launched = counts()
            snap = telemetry.snapshot()
            require(done == len(boxes), f"cloud: {done} tasks drained")
            for kname, k in launched.items():
                require(not on_card or k == per_task * len(boxes),
                        f"cloud: {kname} launched {k} times, not "
                        f"{per_task * len(boxes)}")
            drained(queue)
            check_volume(out, "the in-process run")
            c = snap["counters"]
            require(c.get("storage/shard_conflicts", 0) >= 1,
                    "cloud: the forced race was not retried")

            def per(prefix):
                verbs = {k.rsplit("/", 1)[-1]: v / len(boxes)
                         for k, v in c.items()
                         if k.startswith(f"{prefix}/requests/")}
                return ", ".join(f"{v} {verbs[v]:.1f}"
                                 for v in sorted(verbs))

            def mean_ms(name):
                h = snap["hists"].get(name)
                return h["mean"] * 1e3 if h else 0.0

            mb = (c.get("storage/http/bytes_sent", 0)
                  + c.get("storage/http/bytes_received", 0)) / 1e6
            phase("cloud", f"in process: "
                           f"{run_s / len(boxes):.4f} s/task, "
                           f"{vox_in * len(boxes) / run_s / 1e6:.3f} "
                           f"Mvox/s of input (phase 10 from disk: "
                           + (f"{cfg['raw_s_per_task']:.4f} s/task"
                              if cfg.get("raw_s_per_task")
                              else "not run")
                           + f"); requests per task: storage "
                             f"{per('storage/http')}, queue "
                             f"{per('queue/http')}; storage MB per "
                             f"task {mb / len(boxes):.1f}; retries "
                             f"{c.get('storage/http/retries', 0):g} "
                             f"storage, "
                             f"{c.get('queue/http/retries', 0):g} "
                             f"queue; 412s "
                             f"{c.get('storage/http/412', 0):g} (shard "
                             f"conflicts "
                             f"{c.get('storage/shard_conflicts', 0):g})"
                             f"; host ms per task: storage/read "
                             f"{mean_ms('storage/read'):.1f} (a span "
                             f"per cutout), storage/write "
                             f"{mean_ms('storage/write'):.1f}, "
                             f"lifecycle/commit "
                             f"{mean_ms('lifecycle/commit'):.1f}; "
                             f"launches {launched}; output == "
                             f"reference bitwise")

            # ---- the run's telemetry to CloudWatch ------------------------
            from chunkflow_tpu_torch.plugins.aws import cloud_watch

            t = time.perf_counter()
            cloud_watch.execute(log={"timer": {"inference": run_s}},
                                name=cfg["namespace"])
            publish_ms = (time.perf_counter() - t) * 1e3
            calls = stats("cloudwatch")["calls"]
            data = [d for _, batch in calls for d in batch]
            worker = [{"Name": "worker", "Value": telemetry.worker_id()}]
            require(calls and all(ns == cfg["namespace"]
                                  and 0 < len(batch) <= 20
                                  for ns, batch in calls)
                    and all(d["Dimensions"] == worker for d in data),
                    f"cloud: the CloudWatch fake recorded {calls!r:.300}")
            names = {d["MetricName"] for d in data}
            require({"inference/chunks", "inference-time",
                     "storage/http/requests/GET"} <= names,
                    "cloud: the published snapshot lacks the run's metrics")
            phase("cloud", f"aws/cloud_watch: {len(data)} MetricData in "
                           f"{len(calls)} PutMetricData calls (at most 20 "
                           f"each, SigV4 checked) to the CloudWatch fake "
                           f"under {cfg['namespace']!r}, {publish_ms:.1f} "
                           f"ms")
        finally:
            os.environ.clear()
            os.environ.update(saved_env)
            fakes.terminate()
            fakes.wait(timeout=30)
            storage.reset_shared_cache()
    phase("cloud", f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return launched


def checkpoint_phase(torch, cfg, state, reset_counts, counts,
                     plain_functions):
    """Phase 21: an orbax checkpoint on the main path.

    ``cfg["checkpoint"]`` (the committed full-width parity checkpoint of
    the seeded tree) loads into the parity engine through
    ``create_convnet_engine``, its state dict bitwise ``state``; so does
    ``cfg["checkpoint_zarr3"]`` (the same tree saved with ``use_zarr3``),
    and one chunk through the CLI with it is bitwise the same. One chunk
    (``cfg["chunk"]``, host uint8) goes through the CLI's ``load-npy |
    inference -f flax -w <dir> | save-npy``: bitwise
    ``Inferencer.__call__`` with the same weights, whose kernel path is
    bitwise its plain path (``plain_functions``); ``cfg["per_chunk"]``
    launches of each kernel. Printed: the one load's ms split, by the
    telemetry spans it records, into OCDBT (``orbax/open``: the manifest;
    ``zarr/kv_read``: nodes and ranged reads), zstd (``zarr/decode``),
    convert (``weights/convert``: ``state_from_flax`` and the state dict)
    and the rest, which sum to the load; and the host C++ zstd and blosc
    decoders' MB/s beside their plain versions' on the checkpoint's
    largest chunk, ``cfg["blosc_store"]``'s lz4 chunks and one task-sized
    frame (``cfg["chunk"]``'s corner of ``cfg["blosc_task"]``) that the
    port's ``blosc.compress`` encodes. The encoders on the largest chunk:
    the host C++ zstd at the store's level (its MB/s no lower than
    ``zlib.compress`` at level 1's, its frame's size against the
    committed frame's, the plain twin's bytes on its first 64 KiB, a
    round trip through both decoders) and LZ4 (its MB/s, the plain twin's
    bytes, both decoders). Then ``load-npy | inference -f pytorch -w
    cfg["weights"] | plugin -n <stack channels> | save-zarr`` into a
    store of each of ``cfg["stores"]`` (a ``.zarray`` as tensorstore
    writes it, chunks ``cfg["store_chunks"]``), ``cfg["per_chunk"]``
    launches each, read back through ``load-zarr`` bitwise
    ``Inferencer.__call__``, each chunk file of the store's compressor.
    Then the legs that take no inference: ``load-npy | save-zarr`` of that
    output into a path with no store (its ``.zarray``
    ``cfg["created_zarray"]``, read back bitwise); the task-sized frame in
    each of ``cfg["task_encoders"]`` (cname, shuffle), its MB/s both ways,
    the encoders' and the bit shuffle's bytes their plain twins', every
    frame decoded bitwise; and ``save_params`` of ``state`` read back
    bitwise by ``init_or_load_weights``.

    Returns the kernels' launches in the CLI runs."""
    import statistics
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.models import orbax
    from chunkflow_tpu_torch.models.convert import init_or_load_weights
    from chunkflow_tpu_torch.models.unet3d import UNet3D
    from chunkflow_tpu_torch.volume import blosc, zstd
    from chunkflow_tpu_torch.volume.zarr import ZarrArray

    t_phase = time.perf_counter()
    on_card = cfg["device"] == "cuda"
    path = str(cfg["checkpoint"])

    def ms(fn):
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3

    # ---- the load, end to end and in its parts --------------------------
    parts = ("orbax/open", "zarr/kv_read", "zarr/decode", "weights/convert")
    require(telemetry.enabled(), "checkpoints: telemetry is off, so the "
                                 "load cannot be split")
    model = UNet3D(in_channels=1, out_channels=3)
    before = telemetry.hist_totals(parts)
    _, load_ms = ms(lambda: init_or_load_weights(model, path))
    after = telemetry.hist_totals(parts)
    split = {k: (after[k] - before[k]) * 1e3 for k in parts}
    ocdbt_ms = split["orbax/open"] + split["zarr/kv_read"]
    rest_ms = load_ms - sum(split.values())
    with open(os.path.join(path, orbax.METADATA)) as f:
        metadata = json.load(f)
    frames = dict(orbax.open_store(path, metadata).items())
    arrays = {}
    for key in frames:
        if key.endswith("/.zarray"):
            meta = json.loads(frames[key])
            arrays[key[:-len("/.zarray")]] = (
                int(np.prod(meta["shape"])) * np.dtype(meta["dtype"]).itemsize)
    chunks = {k: v for k, v in frames.items() if not k.endswith(".zarray")}
    require(len(chunks) == len(arrays), f"checkpoints: {len(chunks)} chunks "
                                        f"for {len(arrays)} arrays")
    engine = engines.create_convnet_engine("", path, model_variant="parity")
    loaded = engine.model.state_dict()
    require(set(loaded) == set(state)
            and all(torch.equal(loaded[k], state[k]) for k in state),
            "checkpoints: the engine's weights differ from the seeded tree")
    engine.model.to(cfg["device"])
    require(all(torch.equal(v.cpu(), state[k])
                for k, v in engine.model.state_dict().items()),
            "checkpoints: the weights changed on the way to the device")
    del engine
    phase("checkpoints", f"{path[len(str(ROOT)) + 1:]}: {len(arrays)} "
                         f"arrays, {sum(arrays.values()) / 1e6:.2f} MB of "
                         f"float32, {sum(map(len, chunks.values())) / 1e6:.2f}"
                         f" MB of zstd frames; load {load_ms:.1f} ms = "
                         f"OCDBT {ocdbt_ms:.1f} ms (manifest "
                         f"{split['orbax/open']:.1f}, nodes and reads "
                         f"{split['zarr/kv_read']:.1f}) + zstd "
                         f"{split['zarr/decode']:.1f} ms + convert "
                         f"{split['weights/convert']:.1f} ms + the rest "
                         f"{rest_ms:.1f} ms (metadata, the tree); the "
                         f"parity engine's weights == the seeded tree "
                         f"bitwise")

    # ---- one chunk through the CLI --------------------------------------
    chunk = cfg["chunk"]
    pin, overlap, batch = cfg["pin"], cfg["overlap"], cfg["batch"]

    def cli_argv(weights, src, dst):
        return ([] if on_card else ["--device", "cpu"]) + [
            "load-npy", "--file-name", src,
            "inference", "--framework", "flax", "--model-variant", "parity",
            "--weight-path", weights,
            "--input-patch-size", *map(str, pin),
            "--output-patch-overlap", *map(str, overlap),
            "--num-output-channels", "3", "--batch-size", str(batch),
            "save-npy", "--file-name", dst]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        src, dst = os.path.join(tmp, "in.npy"), os.path.join(tmp, "out.npy")
        np.save(src, chunk)
        reset_counts()
        t = time.perf_counter()
        rc = cli.main(cli_argv(path, src, dst))
        cli_s = time.perf_counter() - t
        launched = counts()
        require(rc == 0, f"checkpoints: CLI exit code {rc}")
        got = np.load(dst)
    for kname, n in launched.items():
        if on_card:
            require(n == cfg["per_chunk"][kname],
                    f"checkpoints: {kname} launched {n} times, not "
                    f"{cfg['per_chunk'][kname]}")
    inferencer = Inferencer(
        input_patch_size=pin, output_patch_overlap=overlap,
        num_output_channels=3, framework="flax", model_variant="parity",
        weight_path=path, batch_size=batch, device=cfg["device"])
    ref = inferencer(Chunk(chunk)).host().array
    with plain_functions():
        plain = inferencer(Chunk(chunk)).host().array
    del inferencer
    require(got.shape == (3,) + tuple(chunk.shape) and np.isfinite(got).all(),
            f"checkpoints: output {got.shape}, or not finite")
    require(np.array_equal(got, ref), "checkpoints: the CLI's output differs "
                                      "from Inferencer.__call__")
    require(np.array_equal(ref, plain), "checkpoints: the kernel path "
                                        "differs from the plain path")
    phase("checkpoints", f"load-npy | inference -f flax -w <orbax dir> | "
                         f"save-npy on {tuple(chunk.shape)} uint8 (parity "
                         f"float32, batch {batch}): {cli_s:.2f} s with the "
                         f"engine's build; == Inferencer.__call__ bitwise, "
                         f"kernel == plain bitwise; launches {launched}")

    # ---- the same tree saved with use_zarr3 (sharding_indexed leaves) ----
    path3 = str(cfg["checkpoint_zarr3"])
    with open(os.path.join(path3, orbax.METADATA)) as f:
        require(json.load(f).get("use_zarr3") is True,
                f"checkpoints: {path3} is not a use_zarr3 save")
    model3 = UNet3D(in_channels=1, out_channels=3)
    _, load3_ms = ms(lambda: init_or_load_weights(model3, path3))
    loaded3 = model3.state_dict()
    require(set(loaded3) == set(state)
            and all(torch.equal(loaded3[k], state[k]) for k in state),
            "checkpoints: the zarr3 checkpoint's weights differ from the "
            "seeded tree")
    del model3, loaded3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt3_") as tmp:
        src, dst = os.path.join(tmp, "in.npy"), os.path.join(tmp, "out.npy")
        np.save(src, chunk)
        reset_counts()
        t = time.perf_counter()
        rc = cli.main(cli_argv(path3, src, dst))
        cli3_s = time.perf_counter() - t
        launched3 = counts()
        require(rc == 0, f"checkpoints: zarr3 CLI exit code {rc}")
        got3 = np.load(dst)
    for kname, n in launched3.items():
        if on_card:
            require(n == cfg["per_chunk"][kname],
                    f"checkpoints: zarr3: {kname} launched {n} times, not "
                    f"{cfg['per_chunk'][kname]}")
        launched[kname] += n
    require(np.array_equal(got3, ref), "checkpoints: the zarr3 "
                                       "checkpoint's CLI output differs "
                                       "from Inferencer.__call__")
    phase("checkpoints", f"{path3[len(str(ROOT)) + 1:]} (use_zarr3: each "
                         f"leaf a sharding_indexed zarr v3 array, zstd inner "
                         f"chunks, a crc32c index): load {load3_ms:.1f} ms, "
                         f"weights == the seeded tree bitwise; the same CLI "
                         f"with -w <it>: {cli3_s:.2f} s, == "
                         f"Inferencer.__call__ bitwise (the same weights); "
                         f"launches {launched3}")

    # ---- the decoders' rates --------------------------------------------
    def rate(fn, nbytes, reps):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return nbytes / statistics.median(times) / 1e6

    key = max(chunks, key=lambda k: len(chunks[k]))
    size = arrays[key.split("/")[0]]
    frame = chunks[key]
    cpp = rate(lambda: zstd.decompress(frame, size), size, cfg["reps"])
    plain_rate = rate(lambda: zstd.decompress_plain(frame), size, 1)
    require(zstd.decompress(frame, size) == zstd.decompress_plain(frame),
            "checkpoints: the zstd decoders differ")
    store = ZarrArray(str(cfg["blosc_store"]))
    names = sorted(n for n in os.listdir(cfg["blosc_store"])
                   if not n.startswith("."))
    blosc_frames = [store.kv.read_bytes(n) for n in names]
    raw = sum(int.from_bytes(f[4:8], "little") for f in blosc_frames)
    b_cpp = rate(lambda: [blosc.decompress(f) for f in blosc_frames], raw,
                 cfg["reps"] * 20)
    b_plain = rate(lambda: [blosc.decompress_plain(f)
                            for f in blosc_frames], raw, 1)
    require(all(blosc.decompress(f) == blosc.decompress_plain(f)
                for f in blosc_frames), "checkpoints: the blosc decoders "
                                        "differ")
    task = np.ascontiguousarray(chunk[tuple(slice(0, s)
                                            for s in cfg["blosc_task"])])
    task_frame = blosc.compress(task.tobytes(), task.dtype.itemsize,
                                cname="lz4")
    t_cpp = rate(lambda: blosc.decompress(task_frame), task.nbytes,
                 cfg["reps"])
    t_plain = rate(lambda: blosc.decompress_plain(task_frame), task.nbytes, 1)
    require(blosc.decompress(task_frame) == blosc.decompress_plain(
        task_frame) == task.tobytes(), "checkpoints: the blosc decoders "
                                       "differ on the task-sized frame")
    phase("checkpoints", f"host C++ zstd on the largest chunk ({key}, "
                         f"{len(frame)} -> {size} bytes): {cpp:.1f} MB/s "
                         f"(median of {cfg['reps']}), plain {plain_rate:.3f}"
                         f" MB/s; blosc lz4 shuffle on the committed store "
                         f"({len(blosc_frames)} frames, {raw} bytes): "
                         f"{b_cpp:.1f} MB/s, plain {b_plain:.3f} MB/s; "
                         f"blosc lz4 on a {tuple(task.shape)} uint8 frame "
                         f"the port encodes ({len(task_frame)} -> "
                         f"{task.nbytes} bytes): {t_cpp:.1f} MB/s, plain "
                         f"{t_plain:.1f} MB/s")
    # ---- the encoders on the largest chunk -----------------------------
    import zlib

    from chunkflow_tpu_torch import native

    data = zstd.decompress(frame, size)
    level = json.loads(frames[key.split("/")[0] + "/.zarray"])[
        "compressor"]["level"]
    ours = zstd.compress(data, level)
    z_rate = rate(lambda: zstd.compress(data, level), size, cfg["reps"])
    lz4_rate = rate(lambda: native.lz4_compress(data), size, cfg["reps"])
    zlib_rate = rate(lambda: zlib.compress(data, 1), size, cfg["reps"])
    head = data[:64 * 1024]
    require(zstd.compress_plain(head, level) == zstd.compress(head, level),
            "checkpoints: the zstd encoder's bytes differ from its plain "
            "twin's on the first 64 KiB")
    require(zstd.decompress(ours) == data
            and zstd.decompress_plain(ours) == data,
            "checkpoints: the port's zstd frame does not decode to its "
            "chunk")
    block = native.lz4_compress(data)
    require(blosc.lz4_compress_plain(head) == native.lz4_compress(head),
            "checkpoints: the LZ4 encoder's bytes differ from its plain "
            "twin's on the first 64 KiB")
    require(blosc._lz4(block, size) == data, "checkpoints: the port's LZ4 "
                                            "block does not decode")
    require(z_rate >= zlib_rate, f"checkpoints: the zstd encoder at level "
                                 f"{level} ({z_rate:.1f} MB/s) is slower "
                                 f"than zlib at level 1 ({zlib_rate:.1f})")
    phase("checkpoints", f"encoders on the largest chunk ({size} bytes): "
                         f"host C++ zstd level {level} {z_rate:.1f} MB/s, "
                         f"{len(ours)} bytes ({len(ours) / len(frame):.4f} "
                         f"of the committed frame's {len(frame)}); host C++ "
                         f"LZ4 {lz4_rate:.1f} MB/s, {len(block)} bytes; "
                         f"zlib level 1 {zlib_rate:.1f} MB/s (median of "
                         f"{cfg['reps']}); the plain twins' bytes equal on "
                         f"64 KiB, both decoders bitwise")

    # ---- the CLI into a store of each compressor ------------------------
    stacked = (3 * chunk.shape[0],) + tuple(chunk.shape[1:])
    for label, compressor in cfg["stores"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_save_") as tmp:
            src = os.path.join(tmp, "in.npy")
            dst = os.path.join(tmp, "out.npy")
            store = os.path.join(tmp, "aff.zarr")
            stack = os.path.join(tmp, "stack.py")
            np.save(src, chunk)
            with open(stack, "w") as f:
                f.write(STACK_PLUGIN)
            os.makedirs(store)
            with open(os.path.join(store, ".zarray"), "w") as f:
                json.dump({"chunks": list(cfg["store_chunks"]),
                           "compressor": compressor,
                           "dimension_separator": ".", "dtype": "<f4",
                           "fill_value": None, "filters": None,
                           "order": "C", "shape": list(stacked),
                           "zarr_format": 2}, f, separators=(",", ":"))
            reset_counts()
            t = time.perf_counter()
            rc = cli.main(([] if on_card else ["--device", "cpu"]) + [
                "load-npy", "--file-name", src,
                "inference", "--framework", "pytorch",
                "--model-variant", "parity", "--weight-path", cfg["weights"],
                "--input-patch-size", *map(str, pin),
                "--output-patch-overlap", *map(str, overlap),
                "--num-output-channels", "3", "--batch-size", str(batch),
                "plugin", "--name", stack, "--input-names", "chunk",
                "--output-names", "chunk",
                "save-zarr", "--store-path", store])
            write_s = time.perf_counter() - t
            leg = counts()
            require(rc == 0, f"checkpoints: {label}: CLI exit code {rc}")
            for kname, n in leg.items():
                if on_card:
                    require(n == cfg["per_chunk"][kname],
                            f"checkpoints: {label}: {kname} launched {n} "
                            f"times, not {cfg['per_chunk'][kname]}")
                launched[kname] += n
            names = sorted(n for n in os.listdir(store)
                           if not n.startswith("."))
            stored = sum(os.path.getsize(os.path.join(store, n))
                         for n in names)
            with open(os.path.join(store, names[0]), "rb") as f:
                first = f.read(16)
            if compressor["id"] == "zstd":
                require(first[:4] == b"\x28\xb5\x2f\xfd",
                        f"checkpoints: {label}: a chunk that is no zstd "
                        f"frame")
            else:
                require(first[2] >> 5 == blosc.WRITES[compressor["cname"]],
                        f"checkpoints: {label}: a blosc frame of codec "
                        f"{first[2] >> 5}")
            t = time.perf_counter()
            rc = cli.main(([] if on_card else ["--device", "cpu"]) + [
                "load-zarr", "--store-path", store,
                "save-npy", "--file-name", dst])
            read_s = time.perf_counter() - t
            require(rc == 0, f"checkpoints: {label}: load-zarr exit code "
                             f"{rc}")
            back = np.load(dst)
        require(back.shape == stacked and np.array_equal(
            back.reshape(ref.shape), ref), f"checkpoints: {label}: the "
                                           f"store read back differs "
                                           f"from Inferencer.__call__")
        phase("checkpoints", f"load-npy | inference -f pytorch -w <.pt> | "
                             f"plugin -n <stack> | save-zarr into a {label} "
                             f"store ({compressor}, chunks "
                             f"{tuple(cfg['store_chunks'])}): "
                             f"{write_s:.2f} s, {len(names)} chunk files "
                             f"of {stored / 1e6:.1f} MB for "
                             f"{back.nbytes / 1e6:.1f} MB of float32; "
                             f"load-zarr | save-npy {read_s:.2f} s; == "
                             f"Inferencer.__call__ bitwise; launches "
                             f"{leg}")
    created_store_legs(torch, cfg, state, ref, task, rate,
                       lambda: UNet3D(in_channels=1, out_channels=3))
    phase("checkpoints", f"phase 21 took {time.perf_counter() - t_phase:.1f}"
                         f" s")
    return launched


def created_store_legs(torch, cfg, state, output, task, rate, model):
    """Phase 21's legs that take no inference, on the host.

    ``load-npy | save-zarr`` of ``output`` (czyx float32, its channels
    stacked in z) into a path with no store: its ``.zarray`` is
    ``cfg["created_zarray"]``, its frames blosc lz4 byte-shuffled, and
    ``load-zarr`` reads it back bitwise. The uint8 ``task`` as one blosc
    frame of each of ``cfg["task_encoders"]`` (cname, shuffle): MB/s to
    encode and decode (``rate``, median of ``cfg["reps"]``), the cname's
    codec in the flags, decoded bitwise by the host C++ (and the frame of
    its first block by the plain decoder); the host C++ blosclz, snappy,
    LZ4 and LZ4 HC encoders give their plain twins' bytes on its first
    block,
    the bit shuffle on all of it. ``save_params`` of ``state`` read back
    by ``init_or_load_weights`` into ``model()``, bitwise."""
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import native
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.models.convert import init_or_load_weights
    from chunkflow_tpu_torch.models.unet3d import save_params
    from chunkflow_tpu_torch.volume import blosc

    on_card = cfg["device"] == "cuda"
    t_legs = time.perf_counter()
    stacked = (-1,) + tuple(output.shape[-2:])

    def ms(fn):
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3

    # ---- save-zarr into a path with no store ----------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_create_") as tmp:
        src = os.path.join(tmp, "in.npy")
        dst = os.path.join(tmp, "out.npy")
        store = os.path.join(tmp, "created.zarr")
        stacked_ref = np.ascontiguousarray(output.reshape(stacked))
        np.save(src, stacked_ref)
        t = time.perf_counter()
        rc = cli.main(([] if on_card else ["--device", "cpu"]) + [
            "load-npy", "--file-name", src,
            "save-zarr", "--store-path", store])
        create_s = time.perf_counter() - t
        require(rc == 0, f"checkpoints: created store: CLI exit code {rc}")
        with open(os.path.join(store, ".zarray")) as f:
            zarray = f.read()
        require(json.loads(zarray) == json.loads(cfg["created_zarray"]),
                f"checkpoints: the created store's .zarray {zarray} is not "
                f"tensorstore's")
        names = sorted(n for n in os.listdir(store) if not n.startswith("."))
        stored = sum(os.path.getsize(os.path.join(store, n)) for n in names)
        with open(os.path.join(store, names[0]), "rb") as f:
            first = f.read(16)
        require(first[2] >> 5 == blosc.WRITES["lz4"] and first[2] & 0x05
                == 0x01, f"checkpoints: created store: a frame of flags "
                         f"{first[2]:#x}, not byte-shuffled lz4")
        t = time.perf_counter()
        rc = cli.main(([] if on_card else ["--device", "cpu"]) + [
            "load-zarr", "--store-path", store,
            "save-npy", "--file-name", dst])
        read_s = time.perf_counter() - t
        require(rc == 0, f"checkpoints: created store: load-zarr exit code "
                         f"{rc}")
        back = np.load(dst)
    require(np.array_equal(back, stacked_ref), "checkpoints: the created "
                                               "store read back differs")
    phase("checkpoints", f"load-npy | save-zarr into a path with no store "
                         f"({tuple(stacked_ref.shape)} float32, "
                         f"{stacked_ref.nbytes / 1e6:.1f} MB): {create_s:.2f}"
                         f" s, the .zarray tensorstore creates (chunks "
                         f"{tuple(json.loads(zarray)['chunks'])}, blosc lz4 "
                         f"shuffle -1), {len(names)} chunk files of "
                         f"{stored / 1e6:.1f} MB; load-zarr | save-npy "
                         f"{read_s:.2f} s, bitwise")

    # ---- the encoders of every blosc cname on the task-sized frame -----
    raw = task.tobytes()
    head = raw[:blosc.BLOCK]
    depth = blosc.hc_depth(5)
    twins = {"blosclz": (native.blosclz_compress,
                         blosc.blosclz_compress_plain),
             "snappy": (native.snappy_compress, blosc.snappy_compress_plain),
             "lz4": (native.lz4_compress, blosc.lz4_compress_plain),
             "lz4hc": (lambda d: native.lz4hc_compress(d, depth),
                       lambda d: blosc.lz4hc_compress_plain(d, depth))}
    for cname, (cpp_fn, plain_fn) in twins.items():
        require(cpp_fn(head) == plain_fn(head), f"checkpoints: the {cname} "
                                                f"encoder's bytes differ "
                                                f"from its plain twin's")
    require(native.bitshuffle(raw, 1) == blosc.bitshuffle_plain(raw, 1),
            "checkpoints: the bit shuffle differs from its plain twin")
    encoded = []
    for cname, shuffle in cfg["task_encoders"]:
        enc = rate(lambda: blosc.compress(raw, 1, 5, cname, shuffle),
                   len(raw), cfg["reps"])
        task_frame = blosc.compress(raw, 1, 5, cname, shuffle)
        dec = rate(lambda: blosc.decompress(task_frame), len(raw),
                   cfg["reps"])
        require(task_frame[2] >> 5 == blosc.WRITES[cname]
                and blosc.decompress(task_frame) == raw,
                f"checkpoints: the {cname} frame (shuffle {shuffle}) does "
                f"not decode to the task")
        first_block = blosc.compress(head, 1, 5, cname, shuffle)
        require(blosc.decompress_plain(first_block) == head,
                f"checkpoints: the plain decoder differs on the {cname} "
                f"frame's first block")
        encoded.append(f"{cname} shuffle {shuffle} {len(task_frame)} bytes, "
                       f"encode {enc:.1f} MB/s, decode {dec:.1f} MB/s")
    phase("checkpoints", f"blosc frames of a {tuple(task.shape)} uint8 task "
                         f"({len(raw)} bytes; median of {cfg['reps']}): "
                         f"{'; '.join(encoded)}; C++ == the plain twins on "
                         f"its first {len(head)} bytes, the bit shuffle on "
                         f"all of it; every frame decodes bitwise")

    # ---- the weights through save_params and back -----------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_params_") as tmp:
        target = os.path.join(tmp, "parity.msgpack")
        _, save_ms = ms(lambda: save_params(state, target))
        size_mb = os.path.getsize(target) / 1e6
        reloaded = model()
        _, load_back_ms = ms(lambda: init_or_load_weights(reloaded, target))
    back_state = reloaded.state_dict()
    require(set(back_state) == set(state)
            and all(torch.equal(back_state[k], state[k]) for k in state),
            "checkpoints: save_params read back differs from the seeded "
            "tree")
    phase("checkpoints", f"save_params of the parity weights: "
                         f"{save_ms:.1f} ms for {size_mb:.2f} MB of flax "
                         f"msgpack, read back by init_or_load_weights in "
                         f"{load_back_ms:.1f} ms, bitwise; the added legs "
                         f"took {time.perf_counter() - t_legs:.1f} s")


def clahe_stores_phase(torch, cfg, reset_counts, counts):
    """Phase 25: the ``clahe`` plugin ahead of inference, and the sharded
    zarr v3 store.

    The host C++ CLAHE (``ops/clahe.py:clahe``) is held bitwise against
    its numpy plain version on each of ``cfg["cases"]`` (a shape cut from
    the corner of ``cfg["chunk"]``, a grid, a clip limit), and both are
    timed; the chunk is ``cfg["chunk"]`` with noise of ``cfg["seed"]``
    added. ``python -m chunkflow_tpu_torch --device <device> load-npy |
    plugin -n clahe | inference -f flax --model-variant parity -w
    <cfg["weights"]> | save-npy`` runs in process on the first case's
    chunk: bitwise ``Inferencer.__call__`` on the host C++ CLAHE of it,
    ``cfg["per_chunk"]`` launches of each kernel. ``cfg["store"]`` (the
    committed sharded zarr v3 store) reads through ``load-zarr --driver
    zarr3`` and through the ``load_tensorstore`` plugin as
    :func:`sharded_array`. Then ``load_tensorstore`` reads a sub-box of
    grayscale and RGB sections of the chunk through the ``png`` and
    ``tiff`` drivers (and ``webp`` and ``avif`` where this machine's
    Pillow decodes them), a leaf of ``cfg["checkpoint"]`` through an
    ``ocdbt`` kvstore with its ``path``, and the sharded store through a
    ``zip`` kvstore of it, the ``auto`` driver over that zip and an
    ``http`` kvstore on a local ``http.server``: each equal to the file
    read. Returns the kernels' launches in the CLI run."""
    import statistics
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.ops.clahe import clahe, clahe_plain

    t_phase = time.perf_counter()
    on_card = cfg["device"] == "cuda"
    noise = np.random.default_rng(cfg["seed"]).integers(
        -20, 21, cfg["chunk"].shape)
    chunk = np.clip(cfg["chunk"] + noise, 0, 255).astype(np.uint8)

    # ---- the host C++ against its plain version -----------------------
    for shape, grid, clip in cfg["cases"]:
        arr = np.ascontiguousarray(chunk[tuple(slice(0, n) for n in shape)])
        times = []
        for _ in range(cfg["reps"]):
            t = time.perf_counter()
            got = clahe(arr, clip, grid)
            times.append(time.perf_counter() - t)
        cpp_ms = statistics.median(times) * 1e3
        t = time.perf_counter()
        want = clahe_plain(arr, clip, grid)
        plain_ms = (time.perf_counter() - t) * 1e3
        require(np.array_equal(got, want), f"clahe: the host C++ differs "
                                           f"from its plain version on "
                                           f"{shape}, grid {grid}, clip "
                                           f"{clip}")
        phase("clahe", f"{shape} uint8, grid {grid}x{grid}, clip {clip:g}: "
                       f"host C++ {cpp_ms:.2f} ms ({arr.nbytes / cpp_ms / 1e3:.1f}"
                       f" MB/s, median of {cfg['reps']}, "
                       f"{os.cpu_count()} cores), numpy plain "
                       f"{plain_ms:.1f} ms ({arr.nbytes / plain_ms / 1e3:.1f} "
                       f"MB/s); == bitwise")

    # ---- the CLI chain: clahe, then the parity UNet3D ------------------
    shape, grid, clip = cfg["cases"][0]
    image = np.ascontiguousarray(chunk[tuple(slice(0, n) for n in shape)])
    weights = str(cfg["weights"])
    pin, overlap, batch = cfg["pin"], cfg["overlap"], cfg["batch"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clahe_") as tmp:
        src, dst = os.path.join(tmp, "in.npy"), os.path.join(tmp, "out.npy")
        np.save(src, image)
        reset_counts()
        t = time.perf_counter()
        rc = cli.main([
            "--device", cfg["device"], "load-npy", "--file-name", src,
            "plugin", "--name", "clahe", "--args",
            f"clip_limit={clip};tile_size={grid}",
            "inference", "--framework", "flax", "--model-variant", "parity",
            "--weight-path", weights,
            "--input-patch-size", *map(str, pin),
            "--output-patch-overlap", *map(str, overlap),
            "--num-output-channels", "3", "--batch-size", str(batch),
            "save-npy", "--file-name", dst])
        cli_s = time.perf_counter() - t
        launched = counts()
        require(rc == 0, f"clahe: CLI exit code {rc}")
        got = np.load(dst)
    for kname, n in launched.items():
        if on_card:
            require(n == cfg["per_chunk"][kname],
                    f"clahe: {kname} launched {n} times, not "
                    f"{cfg['per_chunk'][kname]}")
    inferencer = Inferencer(
        input_patch_size=pin, output_patch_overlap=overlap,
        num_output_channels=3, framework="flax", model_variant="parity",
        weight_path=weights, batch_size=batch, device=cfg["device"])
    ref = inferencer(Chunk(clahe(image, clip, grid))).host().array
    del inferencer
    require(got.shape == (3,) + tuple(shape) and np.isfinite(got).all(),
            f"clahe: output {got.shape}, or not finite")
    require(np.array_equal(got, ref), "clahe: the CLI's output differs from "
                                      "Inferencer.__call__ on the CLAHE'd "
                                      "chunk")
    phase("clahe", f"--device {cfg['device']} load-npy | plugin -n clahe | "
                   f"inference -f flax --model-variant parity -w "
                   f"{weights[len(str(ROOT)) + 1:]} | save-npy on {shape} "
                   f"uint8: {cli_s:.2f} s with the engine's build; == "
                   f"Inferencer.__call__ on the CLAHE'd chunk bitwise; "
                   f"launches {launched}")

    # ---- the sharded zarr v3 store ---------------------------------------
    store = str(cfg["store"])
    want = want_store = sharded_array(np)
    size = [str(n) for n in want.shape]
    reads = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zarr3_") as tmp:
        dst = os.path.join(tmp, "out.npy")
        for label, argv in (
                ("load-zarr --driver zarr3",
                 ["load-zarr", "--store-path", store, "--driver", "zarr3"]),
                ("plugin -n load_tensorstore",
                 ["create-bbox", "--start", "0", "0", "0", "--size", *size,
                  "plugin", "--name", "load_tensorstore", "--input-names",
                  "bbox", "--args", f"driver=zarr3;kvstore=file://{store}"])):
            t = time.perf_counter()
            rc = cli.main(["--device", cfg["device"], *argv, "save-npy",
                           "--file-name", dst])
            reads[label] = (time.perf_counter() - t) * 1e3
            require(rc == 0, f"stores: {label}: CLI exit code {rc}")
            got = np.load(dst)
            require(got.dtype == want.dtype and np.array_equal(got, want),
                    f"stores: {label} read the sharded zarr v3 store "
                    f"otherwise than it was written")
    phase("stores", f"{store[len(str(ROOT)) + 1:]} ({tuple(want.shape)} "
                    f"uint8, shards {SHARDED_SHARD}, zstd inner chunks "
                    f"{SHARDED_INNER}, a crc32c index at the end; one shard "
                    f"and one inner chunk never written): "
                    + ", ".join(f"{k} {v:.1f} ms" for k, v in reads.items())
                    + " (each a whole CLI run), == the seeded array bitwise")

    # ---- load_tensorstore: image drivers and the other kvstores ---------
    import functools
    import http.server
    import socket
    import threading
    import zipfile

    from PIL import Image, features

    from chunkflow_tpu_torch import BoundingBox
    from chunkflow_tpu_torch.flow.plugin import load_plugin
    from chunkflow_tpu_torch.models import orbax
    from chunkflow_tpu_torch.plugins import load_tensorstore
    from chunkflow_tpu_torch.volume.storage import serial_cutout

    load = load_plugin("load_tensorstore")
    decodes = {f: features.check(f) for f in ("webp", "avif")}
    timed = {}

    def read(label, box, want, **args):
        t = time.perf_counter()
        got = load(BoundingBox(*box), **args).array
        timed[label] = (time.perf_counter() - t) * 1e3
        require(got.dtype == want.dtype and np.array_equal(got, want),
                f"stores: load_tensorstore over {label} differs from the "
                f"file read")

    section = np.ascontiguousarray(chunk[0])
    rgb = np.ascontiguousarray(chunk[:3].transpose(1, 2, 0))

    class Quiet(http.server.SimpleHTTPRequestHandler):
        """Keep-alive, each answer sent at once (no Nagle wait between
        its header and body writes), no log."""

        protocol_version = "HTTP/1.1"

        def setup(self):
            self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)
            super().setup()

        def log_message(self, *args):
            pass

    with tempfile.TemporaryDirectory(prefix="chip_smoke_kv_") as tmp:
        for driver in ("png", "tiff") + tuple(d for d, ok in decodes.items()
                                              if ok):
            for kind, pixels in (("gray", section), ("rgb", rgb)):
                path = os.path.join(tmp, f"{kind}.{driver}")
                Image.fromarray(pixels).save(path)
                with Image.open(path) as image:
                    want = np.asarray(image)
                want = want[..., None] if want.ndim == 2 else want
                box = ((5, 7, 0), (want.shape[0] - 3, want.shape[1] - 11,
                                   want.shape[2]))
                read(f"{driver} {kind}", box, want[5:-3, 7:-11],
                     driver=driver, kvstore=f"file://{path}")
        # a leaf is 5-D, which no chunk holds: the plugin's dataset read
        # whole on the storage plane
        leaf = "bridge.conv2.kernel"
        kernel = orbax.load_params(str(cfg["checkpoint"]))["bridge"][
            "conv2"]["kernel"]
        t = time.perf_counter()
        dataset = load_tensorstore.open_dataset("zarr", {
            "driver": "ocdbt", "base": f"file://{cfg['checkpoint']}/",
            "path": f"{leaf}/"})
        got = serial_cutout(dataset, *dataset.domain)
        timed["ocdbt"] = (time.perf_counter() - t) * 1e3
        require(got.dtype == kernel.dtype and np.array_equal(got, kernel),
                "stores: the checkpoint's leaf over an ocdbt kvstore "
                "differs from the orbax read")
        archive = os.path.join(tmp, "store.zip")
        with zipfile.ZipFile(archive, "w") as zf:
            for dirpath, _, files in os.walk(store):
                for name in files:
                    full = os.path.join(dirpath, name)
                    zf.write(full, os.path.relpath(full, store))
        want_shape = tuple(want_store.shape)
        box = ((0, 0, 0), want_shape)
        read("zip", box, want_store, driver="zarr3",
             kvstore={"driver": "zip", "base": f"file://{archive}"})
        read("auto over the zip", box, want_store, driver="auto",
             kvstore=f"file://{archive}")
        server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), functools.partial(
                Quiet, directory=os.path.dirname(store)))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            read("http", box, want_store, driver="zarr3", kvstore={
                "driver": "http", "base_url": f"http://127.0.0.1:"
                f"{server.server_address[1]}/{os.path.basename(store)}/"})
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
    phase("stores", f"load_tensorstore (each == the file read, ms a read): "
                    + ", ".join(f"{k} {v:.1f}" for k, v in timed.items())
                    + f"; {want_shape} zarr3 over zip and http, the "
                      f"checkpoint's {leaf} {tuple(kernel.shape)} over "
                      f"ocdbt; this Pillow decodes {decodes}")
    phase("clahe", f"phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return launched


def mesh_expected_launches(spec, replay, zyx, pin, overlap, batch):
    """``(gather, accumulate)``: the launches one chunk of shape ``zyx``
    takes under the mesh ``spec``, from the engine's partition and replay
    plans. Each shard gathers its rows in batches of ``batch`` (the
    pipeline: its first stage gathers every micro-batch) and replays in
    batches of ``batch`` its plan's ``r`` rows (sharded) or every
    reference row (replicated)."""
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.parallel.engine import (
        axis_geometry,
        partition_for_mesh,
        replay_plan_1d,
        replay_plan_spatial,
    )

    grid = enumerate_patches(zyx, pin, pin, overlap)
    pout = tuple(grid.output_patch_size)
    n = spec.n_devices
    sharded = replay == "sharded"

    def batches(rows):
        return -(-rows // batch)

    n_ref = batches(grid.num_patches) * batch
    if spec.kind == "spatial":
        ny, nx = spec.shape
        gy = axis_geometry(zyx[1], ny, pin[1], pout[1])
        gx = axis_geometry(zyx[2], nx, pin[2], pout[2])
        part = partition_for_mesh(grid, (ny, nx), batch, gy[0], gx[0],
                                  gy[1], gx[1])
        rows = (replay_plan_spatial(part, pout, (ny, nx), gy[0], gx[0],
                                    batch).r
                if sharded else len(part.valid))
        return n * batches(part.per_dev), n * batches(rows)
    if spec.kind == "data":
        _, out_starts, valid = pad_to_batch(grid, batch * n)
        gather = n * batches(len(valid) // n)
    else:
        _, out_starts, valid = pad_to_batch(grid, batch)
        gather = batches(len(valid))
    if not sharded:
        return gather, n * batches(n_ref)
    plan = replay_plan_1d(out_starts, valid, n_ref, len(valid), pout, n,
                          -(-zyx[1] // n), batch)
    return gather, n * batches(plan.r)


def mesh_phase(torch, cfg, reset_counts, counts, plain_functions):
    """Phase 22: the mesh engine (``parallel/engine.py``) in one process,
    its shards on ``cfg["device"]`` repeated (``Inferencer._mesh``): N
    shards queued on one card measure the engine's overhead, not
    multi-GPU scaling.

    ``cfg["chunk"]`` (host uint8) goes through each family of
    ``cfg["families"]`` on one device, then through each of its meshes in
    ``cfg["runs"]`` (``CHUNKFLOW_MESH`` and ``CHUNKFLOW_SHARD_REPLAY`` per
    run, read per chunk), each run as ``stage`` + ``infer_async`` with the
    dispatch under ``torch.cuda.set_sync_debug_mode("error")`` after a
    warm-up (the warm-up carries the sampled readiness probe, which
    syncs). Required: every mesh bitwise the family's one device
    (``torch.equal`` on the host copies); gather and accumulate launched
    exactly as often as the plans say (:func:`mesh_expected_launches`), so
    a shard that ran a plain version shows; the peak memory at least the
    N shards' analytic replay buffers (``shard/replay_buffer_bytes``, or
    the full chunk's under ``replicated``), and a sharded replay's peak
    below the replicated replay's of the same family and mesh;
    the first run of ``cfg["plain_run"]`` bitwise again with every kernel
    wrapper patched to its plain version (no launch); the packer under
    ``cfg["pack_mesh"]`` on ``cfg["pack_family"]``, each of the
    ``cfg["pack_shapes"]`` requests bitwise its own one-device call.
    Printed beside ``cfg["card"]``: s/chunk of each mesh and of the one
    device, the launches, the ``shard/*`` byte counters, the padded
    extents, and the peak memory against the analytic replay buffers.
    The packer's launches depend on how its batches fill, so there
    gather and accumulate are only required to launch.

    Returns the kernels' launches in the counted runs."""
    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.parallel.engine import (
        axis_geometry,
        parse_mesh_spec,
    )
    from chunkflow_tpu_torch.serve.packer import PatchPacker

    t_phase = time.perf_counter()
    on_card = cfg["device"] == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = cfg["card"]
    pin, overlap, batch = cfg["pin"], cfg["overlap"], cfg["batch"]
    chunk = Chunk(cfg["chunk"])
    _, y, x = chunk.shape[-3:]
    vox = int(np.prod(chunk.shape[-3:]))
    widest = max(parse_mesh_spec(mesh).n_devices
                 for _, mesh, _ in cfg["runs"] + ((cfg["pack_family"],
                                                   cfg["pack_mesh"], ""),))
    devices = [dev] * widest
    keys = ("CHUNKFLOW_MESH", "CHUNKFLOW_SHARD_REPLAY")
    saved = {k: os.environ.get(k) for k in keys}
    launched_total = {}
    peaks = {}  # (family, mesh, replay) -> GiB

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0

    def infer(inf, checked):
        """One chunk, staged then dispatched (under the sync check when
        ``checked``), then read back: (host array, s)."""
        sync()
        t = time.perf_counter()
        staged = inf.stage(chunk)
        if checked and on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = inf.infer_async(staged, consume=True)
        finally:
            if checked and on_card:
                torch.cuda.set_sync_debug_mode(0)
        host = out.host().array
        return host, time.perf_counter() - t

    def extents(spec, replay):
        """The padded y/x extents a mesh computes on, and its slabs."""
        if spec.kind == "spatial":
            gy = axis_geometry(y, spec.shape[0], pin[1], pin[1])
            gx = axis_geometry(x, spec.shape[1], pin[2], pin[2])
            return (f"slab {gy[0]}x{gx[0]}, halos y {gy[1]}+{gy[2]} x "
                    f"{gx[1]}+{gx[2]}, padded to {gy[3]}x{gx[3]} (from "
                    f"{y}x{x}; the pad is zeros)")
        if replay == "sharded":
            slab = -(-y // spec.n_devices)
            return (f"replay slab y {slab} + 2 x {pin[1]} margin, padded to "
                    f"{slab * spec.n_devices}x{x}")
        return f"full {y}x{x} replay on every shard"

    try:
        for family, kwargs in cfg["families"].items():
            runs = [(mesh, replay) for fam, mesh, replay in cfg["runs"]
                    if fam == family]
            inf = Inferencer(input_patch_size=pin,
                             output_patch_overlap=overlap,
                             num_output_channels=3, batch_size=batch,
                             device=cfg["device"], **kwargs)
            inf._mesh = devices
            os.environ["CHUNKFLOW_MESH"] = "1"
            os.environ.pop("CHUNKFLOW_SHARD_REPLAY", None)
            infer(inf, False)  # warm-up
            peak_reset()
            ref, single_s = infer(inf, True)
            single_peak = peak()
            require(ref.shape == (3,) + tuple(chunk.shape[-3:])
                    and np.isfinite(ref).all(),
                    f"mesh {family}: one device gave {ref.shape}")
            phase("mesh", f"{family} one device: {single_s:.4f} s/chunk, "
                          f"{vox / single_s / 1e6:.2f} Mvox/s, peak "
                          f"{single_peak:.2f} GiB ({card})")
            for mesh, replay in runs:
                os.environ["CHUNKFLOW_MESH"] = mesh
                os.environ["CHUNKFLOW_SHARD_REPLAY"] = replay
                label = f"{family} {mesh} {replay}"
                infer(inf, False)  # warm-up: the sampled readiness probe
                telemetry.reset()
                reset_counts()
                peak_reset()
                got, mesh_s = infer(inf, True)
                launched = counts()
                mesh_peak = peak()
                snap = telemetry.snapshot()
                require(np.array_equal(got, ref),
                        f"mesh {label}: differs from one device, max abs "
                        f"{np.abs(got.astype(np.float64) - ref).max()}")
                spec = parse_mesh_spec(mesh)
                want = dict(zip(("gather", "accumulate"),
                                mesh_expected_launches(
                                    spec, replay, tuple(chunk.shape[-3:]),
                                    pin, overlap, batch)))
                require(not on_card or launched == want,
                        f"mesh {label}: launches {launched}, the plans "
                        f"give {want}")
                for kname, n in launched.items():
                    launched_total[kname] = launched_total.get(kname, 0) + n
                if (family, mesh, replay) == cfg["plain_run"]:
                    with plain_functions():
                        plain, _ = infer(inf, False)
                    require(counts() == launched,
                            f"mesh {label}: the plain path launched")
                    require(np.array_equal(plain, got),
                            f"mesh {label}: the plain path differs")
                    phase("mesh", f"{label}: the kernel path == the plain "
                                  f"path bitwise ({card})")
                c, g = snap["counters"], snap["gauges"]
                nbytes = {k: c.get(f"shard/{k}", 0.0) / 1e6
                          for k in ("halo_bytes", "gather_bytes",
                                    "replay_strip_bytes", "handoff_bytes")}
                buf = g.get("shard/replay_buffer_bytes")
                # the analytic blend buffers (outputs and weight, float32)
                # of the N shards: a slab+margin each, or the full chunk
                bufs = spec.n_devices * (buf if buf else
                                         (3 + 1) * 4 * vox) / 2**30
                require(not on_card or mesh_peak >= bufs,
                        f"mesh {label}: peak {mesh_peak:.3f} GiB below the "
                        f"{spec.n_devices} shards' replay buffers "
                        f"{bufs:.3f} GiB")
                peaks[(family, mesh, replay)] = mesh_peak
                phase("mesh", f"{label}: bitwise one device; {mesh_s:.4f} "
                              f"s/chunk against {single_s:.4f} "
                              f"({mesh_s / single_s:.2f}x; "
                              f"{spec.n_devices} shards on one card: the "
                              f"engine's overhead, not multi-GPU scaling); "
                              f"launches {launched}; shard MB "
                              + ", ".join(f"{k} {v:.1f}"
                                          for k, v in nbytes.items())
                              + f"; {extents(spec, replay)}; peak "
                                f"{mesh_peak:.2f} GiB (one device "
                                f"{single_peak:.2f}), replay buffers "
                              + (f"{buf / 2**30:.3f} GiB a shard x "
                                 f"{spec.n_devices}" if buf else
                                 f"full chunk x {spec.n_devices}")
                              + f", {bufs:.3f} GiB for {spec.n_devices}: "
                                f"{mesh_peak - bufs:.3f} GiB above them "
                                f"({card})")
            del inf
            if on_card:
                torch.cuda.empty_cache()

        for (family, mesh, replay), gib in peaks.items():
            full = peaks.get((family, mesh, "replicated"))
            if replay == "sharded" and full is not None:
                require(not on_card or gib < full,
                        f"mesh {family} {mesh}: the sharded replay peaks at "
                        f"{gib:.3f} GiB, the replicated at {full:.3f}")
                phase("mesh", f"{family} {mesh}: peak {gib:.2f} GiB sharded "
                              f"against {full:.2f} replicated ({card})")

        # ---- the packer under a mesh ------------------------------------
        rng = np.random.default_rng(22)
        requests = [Chunk(rng.integers(0, 256, shape, dtype=np.uint8),
                          voxel_offset=(100 * i, 0, 0))
                    for i, shape in enumerate(cfg["pack_shapes"])]
        inf = Inferencer(input_patch_size=pin, output_patch_overlap=overlap,
                         num_output_channels=3, batch_size=batch,
                         device=cfg["device"],
                         **cfg["families"][cfg["pack_family"]])
        inf._mesh = devices
        os.environ["CHUNKFLOW_MESH"] = "1"
        os.environ.pop("CHUNKFLOW_SHARD_REPLAY", None)
        refs = [inf(r).host().array for r in requests]
        os.environ["CHUNKFLOW_MESH"] = cfg["pack_mesh"]
        packer = PatchPacker(inf, max_wait_ms=20.0)
        try:
            packer.infer(requests[0], timeout=300).host()  # warm-up
            telemetry.reset()
            reset_counts()
            sync()
            t = time.perf_counter()
            handles = [packer.submit(r) for r in requests]
            outs = [h.result(timeout=600).host().array for h in handles]
            packed_s = time.perf_counter() - t
            launched = counts()
        finally:
            packer.close()
        snap = telemetry.snapshot()
        require(all(np.array_equal(o, r) for o, r in zip(outs, refs)),
                f"mesh packer {cfg['pack_mesh']}: a result differs from "
                f"its one-device call")
        for kname, n in launched.items():
            require(not on_card or n > 0,
                    f"mesh packer: {kname} never launched")
            launched_total[kname] = launched_total.get(kname, 0) + n
        chips = snap["gauges"].get("serving/chips")
        require(chips == parse_mesh_spec(cfg["pack_mesh"]).n_devices,
                f"mesh packer: serving/chips {chips}")
        phase("mesh", f"packer, {cfg['pack_family']} under "
                      f"{cfg['pack_mesh']}: {len(requests)} requests "
                      f"{[tuple(r.shape) for r in requests]} bitwise each "
                      f"one-device call; {packed_s:.4f} s, "
                      f"{snap['counters'].get('serving/batches', 0):g} "
                      f"batches of {batch} x {chips:g} slots, "
                      f"{snap['counters'].get('serving/filler_slots', 0):g}"
                      f" filler slots; launches {launched} ({card})")
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    phase("mesh", f"phase 22 took {time.perf_counter() - t_phase:.1f} s; "
                  f"launches in its counted runs {launched_total}")
    return launched_total


# ---------------------------------------------------------------------------
# phase 23: the multi-process engine
# ---------------------------------------------------------------------------

def multihost_rank(cfg_path, pid, launched_at):
    """One rank of phase 23's worlds, in a process of its own: joins the
    world (``multihost.initialize``) and runs ``cfg["legs"]`` in order,
    writing its numbers to ``<out>/rank<pid>.json``. The parent
    (:func:`multihost_phase`) checks them."""
    import zlib

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import telemetry
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.ops import accumulate, gather
    from chunkflow_tpu_torch.parallel import multihost, queues
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    cfg = json.loads(Path(cfg_path).read_text())
    pin, overlap, batch = (tuple(cfg["pin"]), tuple(cfg["overlap"]),
                           cfg["batch"])
    t0 = time.perf_counter()
    multihost.initialize(cfg["coord"], cfg["world"], pid,
                         device=cfg["device"])
    init_s = time.perf_counter() - t0
    dev = multihost.process_device()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def launches():
        return dict(gather=gather.launches, accumulate=accumulate.launches)

    def reset():
        gather.launches = accumulate.launches = 0

    def leg_env(collectives):
        if collectives:
            os.environ.pop("CHUNKFLOW_MULTIHOST_COLLECTIVES", None)
        else:
            os.environ["CHUNKFLOW_MULTIHOST_COLLECTIVES"] = "0"

    res = dict(rank=pid, world=multihost.process_count(),
               backend=multihost.backend(), device=str(dev), init_s=init_s,
               mesh=[str(g.device) for g in multihost.global_mesh()])
    legs = cfg["legs"]
    if "exchange" in legs:
        res["allgather"] = [b.decode() for b in
                            multihost.allgather_bytes(b"rank-%d" % pid)]
        for label, collectives in (("broadcast", True),
                                   ("broadcast_store", False)):
            leg_env(collectives)
            res[label] = [
                multihost.broadcast_string(f"task-{label}" if pid == 0
                                           else None),
                multihost.broadcast_string(None)]
        leg_env(True)
    if "guard" in legs:
        # a permutation of the same values on rank 1: equal plain sums,
        # different digests, over both transports
        rng = np.random.default_rng(23)
        small = rng.random((8, 64, 64)).astype(np.float32)
        if pid == 1:
            small = np.ascontiguousarray(small[::-1])
        small_pin = (4, 16, 16)
        identity = engines.create_identity_engine(small_pin, small_pin, 3)
        res["guard"] = {}
        for label, collectives in (("collectives", True), ("store", False)):
            leg_env(collectives)
            try:
                multihost.sharded_inference_global(
                    small, identity, small_pin, small_pin, (2, 8, 8),
                    batch_size=batch)
            except ValueError as exc:
                res["guard"][label] = str(exc).splitlines()[0]
            else:
                res["guard"][label] = None
        leg_env(True)
    net = dict(cfg["net"], input_patch_size=pin, output_patch_size=pin,
               num_output_channels=3)
    if "psum" in legs or "fallback" in legs:
        raw = np.load(cfg["chunk"])
        zyx = raw.shape
        # the float32 chunk the one-device gather converts the raw one to
        x = gather.convert_chunk(torch.from_numpy(raw)[None].to(dev))
        ref = torch.from_numpy(np.load(cfg["reference"])).to(dev)
        engine = engines.create_engine(**net)
        # a first op on the device, with every kernel library loaded
        gather.gather_patches(x, torch.zeros((1, 3), dtype=torch.int32),
                              pin)
        sync()
        res["ready_s"] = time.time() - launched_at

        def run(collectives):
            leg_env(collectives)
            reset()
            sync()
            t = time.perf_counter()
            with torch.no_grad():
                out = multihost.sharded_inference_global(
                    x, engine, pin, pin, overlap, batch_size=batch)
            sync()
            return out, time.perf_counter() - t, launches()

        def held(out):
            diff = (out.double() - ref.double()).abs()
            return dict(max_abs=float(diff.max()),
                        bitwise=bool(torch.equal(out, ref)),
                        finite=bool(torch.isfinite(out).all()),
                        shape=list(out.shape))

    if "psum" in legs:
        runs = [run(True) for _ in range(2)]
        out = runs[-1][0]
        res["psum"] = dict(held(out), s=[r[1] for r in runs],
                           launches=[r[2] for r in runs])
        # replica agreement: every rank's digest of its copy
        digest = np.asarray(multihost._chunk_digest(out), np.float64)
        crc = zlib.crc32(out.cpu().numpy().tobytes())
        rows = multihost.allgather_bytes(
            digest.tobytes() + crc.to_bytes(4, "little"))
        res["replicas"] = dict(
            sums=[float(np.frombuffer(r[:-4], np.float64)[0]) for r in rows],
            bitwise=len({r[-4:] for r in rows}) == 1)
        del out, runs
        # the same through Inferencer(sharding="patch"), the user's entry
        telemetry.reset()
        inf = Inferencer(input_patch_size=pin, output_patch_overlap=overlap,
                         batch_size=batch, sharding="patch",
                         crop_output_margin=False, device=dev,
                         **{k: v for k, v in net.items()
                            if k not in ("input_patch_size",
                                         "output_patch_size")})
        chunk = Chunk(raw)
        reset()
        sync()
        t = time.perf_counter()
        got = inf(chunk).array
        inf_s = time.perf_counter() - t
        snap = telemetry.snapshot()
        res["inferencer"] = dict(
            held(got), s=inf_s, launches=launches(),
            gather_bytes=snap["counters"].get("shard/gather_bytes", 0.0),
            all_reduce_s=snap["hists"].get("shard/all_reduce", {}).get(
                "total", 0.0),
            dispatch_s=snap["hists"].get("shard/dispatch", {}).get(
                "total", 0.0))
        del inf, got
        # the all-reduce alone: the recipe's two buffers, ranks aligned
        bufs = (torch.zeros((3,) + zyx, device=dev),
                torch.zeros(zyx, device=dev))
        times = []
        for _ in range(3):
            dist.barrier()
            sync()
            t = time.perf_counter()
            for b in bufs:
                dist.all_reduce(b)
            sync()
            times.append(time.perf_counter() - t)
        res["all_reduce"] = dict(
            ms=[1e3 * t for t in times],
            bytes=sum(b.numel() * b.element_size() for b in bufs))
        del bufs
    if "fallback" in legs:
        out, s, launched = run(False)
        res["fallback"] = dict(held(out), s=s, launches=launched)
        leg_env(True)
        del out
    if "cli" in legs:
        counts = dict(writes=0, acks=0)

        def counted(fn, key):
            def call(*args, **kwargs):
                counts[key] += 1
                return fn(*args, **kwargs)
            return call

        PrecomputedVolume.save = counted(PrecomputedVolume.save, "writes")
        queues.FileQueue.delete = counted(queues.FileQueue.delete, "acks")
        t = time.perf_counter()
        rc = cli.main(cfg["cli"])
        res["cli"] = dict(rc=rc, s=time.perf_counter() - t, **counts)
    Path(cfg["out"], f"rank{pid}.json").write_text(json.dumps(res))
    # no rank leaves while a peer may still use the store rank 0 serves
    dist.barrier()
    print("RANK_OK", pid, flush=True)


def _multihost_world(cfg, tmp, name, world, timeout):
    """Start ``world`` rank processes of :func:`multihost_rank` on
    ``cfg`` (one coordinator port on 127.0.0.1); waits for all, kills the
    others when one fails, returns each rank's numbers."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = dict(cfg, coord=f"127.0.0.1:{port}", world=world, out=str(tmp))
    cfg_path = tmp / f"{name}.json"
    cfg_path.write_text(json.dumps(cfg))
    env = dict(os.environ, CHUNKFLOW_MULTIHOST_TIMEOUT_S="120")
    env.pop("CHUNKFLOW_MULTIHOST_COLLECTIVES", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    logs = [tmp / f"{name}-rank{pid}.log" for pid in range(world)]
    procs = []
    for pid in range(world):
        with open(logs[pid], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.multihost_rank("
                 f"{str(cfg_path)!r}, {pid}, {time.time()!r})"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + timeout
        pending = dict(enumerate(procs))
        while pending:
            require(time.monotonic() < deadline,
                    f"multihost {name}: ranks {sorted(pending)} still "
                    f"running after {timeout} s")
            for pid, p in list(pending.items()):
                if p.poll() is None:
                    continue
                text = logs[pid].read_text()
                require(p.returncode == 0 and f"RANK_OK {pid}" in text,
                        f"multihost {name}: rank {pid} failed (rc "
                        f"{p.returncode}):\n{text[-4000:]}")
                del pending[pid]
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads((tmp / f"rank{pid}.json").read_text())
            for pid in range(world)]


def multihost_phase(torch, cfg, reset_counts, counts):
    """Phase 23: the multi-process engine (``parallel/multihost.py``).

    One card: two rank processes join a gloo world on ``cfg["device"]``
    (shared: the backend rule picks gloo) and run the bring-up, the store
    allgather, the broadcast with its sentinel (collectives and store),
    the consistency guard on a permuted chunk (both transports), then the
    psum recipe at full width (``sharded_inference_global``, twice, and
    ``Inferencer(sharding="patch")``) on ``cfg["chunk"]`` with
    ``cfg["net"]``, within ``MULTIHOST_TOL`` of one device's
    ``Inferencer.__call__`` (computed here first), each rank launching
    exactly its share of the padded plan; the same chunk with
    ``CHUNKFLOW_MULTIHOST_COLLECTIVES=0``, bitwise one device; the
    all-reduce alone; then the CLI task loop (``fetch-task-from-queue |
    load-precomputed | inference -f identity --sharding patch |
    save-precomputed | delete-task-in-queue``) over two tasks, where only
    the coordinator writes and acks, its volume within the identity
    recipe's tolerance of the same chain in this process. With two cards
    or more: an NCCL world of min(4, cards) ranks, one a card, on the same
    chunk. Printed beside ``cfg["card"]``: s/chunk of each leg beside one
    device's, the all-reduce's ms and bytes, each rank's start-up and
    launches.

    Returns the kernels' launches in this process's counted runs (the
    one-device reference and the in-process chain); the ranks count
    theirs."""
    import shutil
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import BoundingBox, Chunk
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import (
        enumerate_patches,
        pad_to_batch,
    )
    from chunkflow_tpu_torch.parallel.engine import MeshSpec
    from chunkflow_tpu_torch.parallel.queues import open_queue
    from chunkflow_tpu_torch.volume import storage
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    t_phase = time.perf_counter()
    on_card = cfg["device"] != "cpu"
    card = cfg["card"]
    pin, overlap, batch = cfg["pin"], cfg["overlap"], cfg["batch"]
    raw = np.ascontiguousarray(cfg["chunk"])
    zyx = tuple(raw.shape)
    vox = int(np.prod(zyx))
    launched_total = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def share(n):
        """Each rank's gather and accumulate launches in the psum recipe
        over ``n`` ranks of one device: its rows of the plan padded to
        n x batch, in batches."""
        rows = len(pad_to_batch(enumerate_patches(zyx, pin, pin, overlap),
                                batch * n)[2]) // n
        return dict(gather=rows // batch, accumulate=rows // batch)

    def nums(triple):
        return [str(v) for v in triple]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_multihost_") as tmp:
        tmp = Path(tmp)
        np.save(tmp / "chunk.npy", raw)
        # one device: the reference every leg is held to
        inf = Inferencer(input_patch_size=pin, output_patch_overlap=overlap,
                         batch_size=batch, crop_output_margin=False,
                         device=cfg["device"], num_output_channels=3,
                         **cfg["net"])
        chunk = Chunk(raw)
        inf(chunk)  # warm-up
        reset_counts()
        sync()
        t = time.perf_counter()
        ref = inf(chunk).array
        single_s = time.perf_counter() - t
        for kname, n in counts().items():
            launched_total[kname] = launched_total.get(kname, 0) + n
        np.save(tmp / "reference.npy", ref.cpu().numpy())
        require(tuple(ref.shape) == (3,) + zyx
                and bool(torch.isfinite(ref).all()),
                f"multihost: one device gave {tuple(ref.shape)}")
        del inf, ref
        phase("multihost", f"one device: {single_s:.4f} s/chunk, "
                           f"{vox / single_s / 1e6:.2f} Mvox/s on {zyx} "
                           f"({card})")

        # the CLI task loop's volumes: two tasks, each queued twice (the
        # world's and this process's chain)
        vol = cfg["volume"]
        roi_start, roi_size = cfg["roi"]
        image = np.random.default_rng(23).integers(0, 256, vol,
                                                   dtype=np.uint8)
        vol_in = str(tmp / "image")
        PrecomputedVolume.create(vol_in, volume_size=vol,
                                 voxel_size=VOXEL_NM,
                                 block_size=cfg["volume_block"])
        PrecomputedVolume(vol_in).save(Chunk(image, voxel_size=VOXEL_NM))
        dev_args = [] if on_card else ["--device", "cpu"]
        chains = {}
        for name in ("world", "process"):
            out = str(tmp / f"out-{name}")
            queue = f"file://{tmp}/queue-{name}"
            require(cli.main(dev_args + [
                "create-info", "-v", out, "-c", "3", "--dtype", "float32",
                "--volume-size", *nums(roi_size),
                "--voxel-size", *nums(VOXEL_NM),
                "--voxel-offset", *nums(roi_start),
                "--block-size", *nums(cfg["out_block"])]) == 0
                and cli.main(dev_args + [
                    "generate-tasks", "--volume-path", out, "--chunk-size",
                    *nums(cfg["task"]), "--queue-name", queue]) == 0,
                f"multihost: setting up the {name} chain failed")
            require(len(open_queue(queue)) == 2,
                    f"multihost: the {name} queue holds "
                    f"{len(open_queue(queue))} tasks, not 2")
            chains[name] = (out, queue, dev_args + [
                "fetch-task-from-queue", "-q", queue, "-r", "0",
                "load-precomputed", "-v", vol_in, "-e",
                *nums(cfg["margin"]),
                "inference", "--framework", "identity",
                "--input-patch-size", *nums(pin),
                "--output-patch-overlap", *nums(overlap),
                "--output-crop-margin", *nums(cfg["margin"]),
                "--num-output-channels", "3", "--batch-size", str(batch),
                "--sharding", "patch",
                "save-precomputed", "-v", out,
                "delete-task-in-queue"])

        # ---- two ranks on one card, gloo ----------------------------------
        rank_cfg = dict(pin=pin, overlap=overlap, batch=batch,
                        net=cfg["net"], chunk=str(tmp / "chunk.npy"),
                        reference=str(tmp / "reference.npy"),
                        device=cfg["rank_device"])
        t = time.perf_counter()
        ranks = _multihost_world(
            dict(rank_cfg, legs=["exchange", "guard", "psum", "fallback",
                                 "cli"], cli=chains["world"][2]),
            tmp, "gloo", 2, cfg["timeout"])
        world_s = time.perf_counter() - t
        want_psum = share(2)
        grid = enumerate_patches(zyx, pin, pin, overlap)
        want_fallback = dict(zip(("gather", "accumulate"),
                                 mesh_expected_launches(
                                     MeshSpec("data", (1,)), "sharded", zyx,
                                     pin, overlap, batch)))
        for r in ranks:
            pid = r["rank"]
            require(r["world"] == 2 and r["backend"] == "gloo"
                    and r["mesh"] == [cfg["rank_device"]] * 2,
                    f"multihost: rank {pid} joined {r['world']} ranks on "
                    f"{r['backend']}, mesh {r['mesh']}")
            require(r["allgather"] == ["rank-0", "rank-1"]
                    and r["broadcast"] == ["task-broadcast", None]
                    and r["broadcast_store"] == ["task-broadcast_store",
                                                None],
                    f"multihost: rank {pid}'s exchanges gave "
                    f"{r['allgather']}, {r['broadcast']}, "
                    f"{r['broadcast_store']}")
            for transport, msg in r["guard"].items():
                require(msg is not None and "checksums differ" in msg,
                        f"multihost: rank {pid}'s guard over {transport} "
                        f"did not fire: {msg}")
            for label in ("psum", "inferencer"):
                leg = r[label]
                require(leg["finite"] and leg["shape"] == [3, *zyx]
                        and leg["max_abs"] <= MULTIHOST_TOL,
                        f"multihost: rank {pid} {label}: max abs "
                        f"{leg['max_abs']} against one device (> "
                        f"{MULTIHOST_TOL})")
            for launched in r["psum"]["launches"] + [
                    r["inferencer"]["launches"]]:
                require(not on_card or launched == want_psum,
                        f"multihost: rank {pid} psum launches {launched}, "
                        f"its share of the plan is {want_psum}")
            require(r["fallback"]["bitwise"],
                    f"multihost: rank {pid} without collectives differs "
                    f"from one device, max abs {r['fallback']['max_abs']}")
            require(not on_card or r["fallback"]["launches"]
                    == want_fallback,
                    f"multihost: rank {pid} fallback launches "
                    f"{r['fallback']['launches']}, the plan gives "
                    f"{want_fallback}")
            require(r["cli"]["rc"] == 0, f"multihost: rank {pid}'s chain "
                                         f"returned {r['cli']['rc']}")
        sums = ranks[0]["replicas"]["sums"]
        require(abs(sums[0] - sums[1]) <= 1e-6 * abs(sums[0]),
                f"multihost: replica sums {sums} differ beyond rtol 1e-6")
        require([(r["cli"]["writes"], r["cli"]["acks"]) for r in ranks]
                == [(2, 2), (0, 0)],
                f"multihost: writes and acks by rank "
                f"{[(r['cli']['writes'], r['cli']['acks']) for r in ranks]}"
                f", only the coordinator's 2 and 2 are allowed")
        out_world, queue_world, _ = chains["world"]
        require(len(open_queue(queue_world)) == 0,
                "multihost: the world's queue is not empty")
        # the same chain in this process (a world of one)
        reset_counts()
        t = time.perf_counter()
        require(cli.main(chains["process"][2]) == 0,
                "multihost: the in-process chain failed")
        chain_s = time.perf_counter() - t
        for kname, n in counts().items():
            launched_total[kname] = launched_total.get(kname, 0) + n
        storage.reset_shared_cache()
        roi = BoundingBox(roi_start, tuple(a + b for a, b in
                                           zip(roi_start, roi_size)))
        a = PrecomputedVolume(out_world).cutout(roi).host().array
        b = PrecomputedVolume(chains["process"][0]).cutout(roi).host().array
        vol_err = float(np.abs(a.astype(np.float64) - b).max())
        require(a.shape == b.shape and vol_err <= MULTIHOST_CLI_TOL,
                f"multihost: the world's volume is {vol_err} from the "
                f"in-process chain's (> {MULTIHOST_CLI_TOL})")
        for r in ranks:
            p, inf_leg, fb = r["psum"], r["inferencer"], r["fallback"]
            ar = r["all_reduce"]
            phase("multihost", f"gloo rank {r['rank']} on "
                               f"{cfg['rank_device']} (2 ranks, one card): "
                               f"initialize {r['init_s']:.3f} s, ready "
                               f"{r['ready_s']:.2f} s after launch; psum "
                               f"sharded_inference_global "
                               f"{', '.join(f'{s:.4f}' for s in p['s'])} "
                               f"s/chunk (first, second), max abs "
                               f"{p['max_abs']:.3g} against one device "
                               f"{single_s:.4f}; Inferencer(sharding="
                               f"'patch') {inf_leg['s']:.4f} s/chunk, max "
                               f"abs {inf_leg['max_abs']:.3g}, "
                               f"shard/gather_bytes "
                               f"{inf_leg['gather_bytes'] / 1e6:.1f} MB, "
                               f"all-reduce span {inf_leg['all_reduce_s']:.4f}"
                               f" s; the all-reduce alone of "
                               f"{ar['bytes'] / 1e6:.1f} MB "
                               f"{', '.join(f'{ms:.1f}' for ms in ar['ms'])}"
                               f" ms; launches {p['launches'][-1]} (its "
                               f"share {want_psum}); without collectives "
                               f"{fb['s']:.4f} s/chunk, bitwise one device, "
                               f"launches {fb['launches']}; chain "
                               f"{r['cli']['s']:.2f} s, writes "
                               f"{r['cli']['writes']}, acks "
                               f"{r['cli']['acks']} ({card})")
        phase("multihost", f"gloo world: guard fired on both ranks over "
                           f"both transports; replicas bitwise "
                           f"{ranks[0]['replicas']['bitwise']} (sums "
                           f"{sums[0]!r}, {sums[1]!r}); chain volume "
                           f"{vol_err:.3g} from the in-process chain's "
                           f"({chain_s:.2f} s), queue empty, each task "
                           f"acked once by the coordinator; {grid.num_patches}"
                           f" patches; the world took {world_s:.1f} s")

        # ---- one rank a card, NCCL ----------------------------------------
        n_cards = torch.cuda.device_count() if on_card else 0
        if n_cards >= 2:
            n = min(4, n_cards)
            t = time.perf_counter()
            ranks = _multihost_world(
                dict(rank_cfg, device="cuda", legs=["exchange", "psum"]),
                tmp, "nccl", n, cfg["timeout"])
            nccl_s = time.perf_counter() - t
            want = share(n)
            for r in ranks:
                pid = r["rank"]
                require(r["backend"] == "nccl" and r["world"] == n
                        and r["device"] == f"cuda:{pid}",
                        f"multihost nccl: rank {pid} on {r['backend']}, "
                        f"{r['device']}")
                require(r["allgather"] == [f"rank-{k}" for k in range(n)]
                        and r["broadcast"] == ["task-broadcast", None],
                        f"multihost nccl: rank {pid}'s exchanges")
                for label in ("psum", "inferencer"):
                    require(r[label]["max_abs"] <= MULTIHOST_TOL
                            and r[label]["finite"],
                            f"multihost nccl: rank {pid} {label} max abs "
                            f"{r[label]['max_abs']}")
                for launched in r["psum"]["launches"]:
                    require(launched == want,
                            f"multihost nccl: rank {pid} launches "
                            f"{launched}, its share is {want}")
                p, ar = r["psum"], r["all_reduce"]
                phase("multihost", f"nccl rank {pid} on {r['device']} ({n} "
                                   f"ranks, a card each): initialize "
                                   f"{r['init_s']:.3f} s, ready "
                                   f"{r['ready_s']:.2f} s; psum "
                                   f"{', '.join(f'{s:.4f}' for s in p['s'])}"
                                   f" s/chunk, max abs {p['max_abs']:.3g}; "
                                   f"Inferencer "
                                   f"{r['inferencer']['s']:.4f} s/chunk, "
                                   f"shard/gather_bytes "
                                   f"{r['inferencer']['gather_bytes'] / 1e6:.1f}"
                                   f" MB; the all-reduce alone "
                                   f"{', '.join(f'{ms:.1f}' for ms in ar['ms'])}"
                                   f" ms; launches {p['launches'][-1]} "
                                   f"({card})")
            phase("multihost", f"nccl world of {n} took {nccl_s:.1f} s")
        else:
            phase("multihost", f"{n_cards} card(s): no NCCL world (it needs "
                               f"two cards or more)")
        shutil.rmtree(tmp, ignore_errors=True)
    phase("multihost", f"phase 23 took {time.perf_counter() - t_phase:.1f} "
                       f"s; launches in its counted runs {launched_total}")
    return launched_total


def multihost_cfg(card, chunk, weights):
    """Phase 23's configuration as main() runs it: the full-width parity
    UNet3D (``weights``, phase 5's) on ``chunk``, two ranks on ``cuda:0``,
    and the chain's two tasks."""
    return dict(
        chunk=chunk, pin=PIN, overlap=OVERLAP, batch=BATCH, device="cuda",
        rank_device="cuda:0", card=card,
        net=dict(framework="pytorch", model_variant="parity",
                 weight_path=str(weights)),
        volume=MULTIHOST_VOLUME, volume_block=VOLUME_BLOCK,
        roi=MULTIHOST_ROI, task=TASK, margin=MARGIN, out_block=OUT_BLOCK,
        timeout=MULTIHOST_WORLD_S)


def multihost_alone() -> int:
    """Phase 23 alone at full size, as main() runs it (on a machine with
    two cards or more it adds the NCCL world): ``python3 -c "import
    chip_smoke; chip_smoke.multihost_alone()"``. Builds the kernels and
    phase 5's weights, prints the card and phase 23's lines, and no
    result line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card")
    sys.path.insert(0, str(ROOT))
    from chunkflow_tpu_torch import Chunk, _build
    from chunkflow_tpu_torch.models.convert import state_from_flax
    from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init
    from chunkflow_tpu_torch.ops import accumulate, gather

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(smi.stdout.strip(), flush=True)
    phase("card", f"{torch.cuda.get_device_name(0)}, "
                  f"{torch.cuda.device_count()} device(s); torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_all()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    seeded = seeded_init(UNet3D(in_channels=1, out_channels=CHANNELS),
                         torch.Generator().manual_seed(0))
    weights = OUT_DIR / "unet3d_seed0.pt"
    torch.save(state_from_flax(_flax_layout(seeded.state_dict())), weights)
    chunk = Chunk.create(size=CHUNK, dtype=np.uint8, pattern="sin")

    def reset_counts():
        gather.launches = accumulate.launches = 0

    def counts():
        return dict(gather=gather.launches, accumulate=accumulate.launches)

    multihost_phase(torch, multihost_cfg(card, chunk.host().array, weights),
                    reset_counts, counts)
    return 0


def _brief(counters):
    keys = ("inference/chunks", "tasks/committed", "tasks/retried",
            "tasks/surrendered", "ledger/skips", "pipeline/chain_rebuilds",
            "chaos/injected", "kernels/gather", "kernels/accumulate")
    return ", ".join(f"{k} {counters[k]:g}" for k in keys if k in counters)


def _device_trace(torch, fn, downloads=0):
    """The device events (kernels, memsets, copies) of one call of ``fn``,
    as ``(name, start_us, end_us)``. A trace with no kernel or fewer than
    ``downloads`` device-to-host copies was dropped by the profiler (see
    ``Timer._trace``): ``fn`` runs again in a new session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA]
        if (any(not n.startswith("Memcpy") for n, _, _ in events)
                and sum("DtoH" in n for n, _, _ in events) >= downloads):
            return events
        time.sleep(1)
    raise SmokeFailure(f"the profiler traced no kernels or fewer than "
                       f"{downloads} downloads in {TRACE_TRIES} sessions")


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _overlap(start, end, union):
    return sum(max(0.0, min(end, b) - max(start, a)) for a, b in union)


def _idle_share(events):
    """The share of the traced window (first device event to last) in
    which no kernel ran: the compute stream's idle share (copies run on
    their own streams)."""
    busy = _union([(s, e) for n, s, e in events if not n.startswith("Memcpy")])
    window = (max(e for _, _, e in events) - min(s for _, s, _ in events))
    return 1.0 - sum(b - a for a, b in busy) / window


def _copy_overlap(events):
    """(share of upload + download time overlapping kernels, downloads
    that overlap a kernel, downloads). A download starts after its chunk's
    compute-done event, so a kernel beside it belongs to a later chunk."""
    busy = _union([(s, e) for n, s, e in events if not n.startswith("Memcpy")])
    copies = [(n, s, e) for n, s, e in events
              if n.startswith("Memcpy") and ("HtoD" in n or "DtoH" in n)]
    total = sum(e - s for _, s, e in copies)
    overlapped = sum(_overlap(s, e, busy) for _, s, e in copies)
    d2h = [(s, e) for n, s, e in copies if "DtoH" in n]
    return (overlapped / total if total else 0.0,
            sum(_overlap(s, e, busy) > 0 for s, e in d2h), len(d2h))


def _raw(rng, dtype, shape):
    """Random values of a chunk dtype over its whole range, or floats in
    [0, 1)."""
    import numpy as np

    if dtype == "float32":
        return rng.random(shape, dtype=np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape,
                        endpoint=True).astype(dtype)


def _version(module: str) -> str:
    """An installed package's version, or "missing"."""
    import importlib

    try:
        return importlib.import_module(module).__version__
    except ImportError:
        return "missing"


def _gxx_version() -> str:
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except OSError:
        return "missing"
    return out.splitlines()[0].split()[-1] if out else "missing"


def _widths(model):
    return getattr(model, "feature_maps", None) or model.width


def _reference_rsunet(torch, out_dir, dev):
    """A reference ``model.py`` and its ``{"state_dict": ...}`` checkpoint,
    with seeded weights and non-trivial BatchNorm statistics; the port's
    migrated RSUNet is checked against the reference model itself on one
    8x64x64 patch on the card. Returns the Inferencer's file arguments."""
    import numpy as np

    from chunkflow_tpu_torch.inference import engines
    from chunkflow_tpu_torch.models import migrate, reference_rsunet
    from chunkflow_tpu_torch.models.unet3d import seeded_init

    model_py = out_dir / "rsunet_model.py"
    model_py.write_text(reference_rsunet.model_py())
    ref = migrate.load_user_module(str(model_py)).InstantiatedModel
    gen = torch.Generator().manual_seed(0)
    reference_rsunet.seed_batchnorm(seeded_init(ref, gen), gen)
    ckpt = out_dir / "rsunet_seed0.pt"
    torch.save({"state_dict": ref.state_dict()}, ckpt)
    files = {"model_path": str(model_py), "weight_path": str(ckpt)}
    port = engines.create_engine("pytorch", model_variant="rsunet",
                                 **files).model
    x = torch.from_numpy(np.random.default_rng(1).random(
        (1, 1, 8, 64, 64), dtype=np.float32)).to(dev)
    with torch.no_grad(), engines.exact_float32():
        diff = float((port.to(dev)(x) - ref.eval().to(dev)(x)).abs().max())
    require(diff <= 1e-4, f"rsunet: migrated model vs the reference model "
                          f"max abs {diff} > 1e-4")
    phase("models", f"rsunet: reference model.py + BatchNorm .pt migrated by "
                    f"name (BatchNorm folded); vs the reference model on one "
                    f"8x64x64 patch on the card: max abs {diff:.3g} <= 1e-4")
    return files


def ledger_chunks(np, chunk_cls):
    """Phase 24's main-path chunks: phase 8's seed, ``LEDGER_CHUNKS + 1``
    of them (the first is the family's compile call)."""
    rng = np.random.default_rng(8)
    return [chunk_cls(rng.integers(0, 256, CHUNK, dtype=np.uint8),
                      voxel_offset=(CHUNK[0] * i, 0, 0))
            for i in range(LEDGER_CHUNKS + 1)]


def tooling_phase(torch, cfg, reset_counts, counts):
    """Phase 24: the checking tools (module docstring). ``cfg``:
    ``chunks`` (main-path chunks, ``LEDGER_CHUNKS + 1`` of them) and
    ``card`` (the ``nvidia-smi`` line). Returns the launches of the
    counted ledger run."""
    import tempfile

    import numpy as np

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.core import profiling, telemetry
    from chunkflow_tpu_torch.core.contracts import ContractError, contract
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.inference.patching import enumerate_patches
    from chunkflow_tpu_torch.ops import accumulate
    from chunkflow_tpu_torch.serve import PatchPacker

    dev = torch.device("cuda")
    card = cfg["card"]
    # ---- a. contracts -----------------------------------------------------
    P = int(np.prod(PIN))
    out = torch.zeros((CHANNELS,) + CHUNK, device=dev)
    weight = torch.zeros(CHUNK, device=dev)
    preds = torch.ones((BATCH, CHANNELS) + PIN, device=dev)
    valid = torch.ones(BATCH, device=dev)
    bump = torch.ones(PIN, device=dev)
    starts = torch.zeros((BATCH, 3), dtype=torch.int32)
    specs = accumulate.fused_accumulate_patches.__contract__["args"]

    def bare(out, weight, preds, valid, bump, out_starts):
        return out

    checked = contract(**specs)(bare)
    args = (out, weight, preds, valid, bump, starts)

    def per_call_us(fn):
        t = time.perf_counter()
        for _ in range(CONTRACT_CALLS):
            fn(*args)
        return (time.perf_counter() - t) / CONTRACT_CALLS * 1e6

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bare_us = min(per_call_us(bare) for _ in range(3))
        checked_us = min(per_call_us(checked) for _ in range(3))
        os.environ["CHUNKFLOW_CONTRACTS"] = "0"
        try:
            off_us = min(per_call_us(checked) for _ in range(3))
        finally:
            del os.environ["CHUNKFLOW_CONTRACTS"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    phase("tooling", f"contracts: {checked_us - bare_us:.2f} us per "
                     f"contracted call on card tensors (the accumulate's "
                     f"six specs; {checked_us:.2f} us against "
                     f"{bare_us:.2f} us undecorated, under sync debug mode "
                     f"'error'); with CHUNKFLOW_CONTRACTS=0 "
                     f"{off_us - bare_us:.2f} us; {card}")
    before = accumulate.launches
    try:
        accumulate.fused_accumulate_patches(
            out, weight, preds, valid, bump,
            torch.zeros((BATCH, 3), dtype=torch.float32, device=dev))
        raise SmokeFailure("a float32 starts table reached the accumulate")
    except ContractError as exc:
        refusal = str(exc)
    require("int32" in refusal and accumulate.launches == before,
            f"the float32 starts table: {refusal!r}, launches "
            f"{accumulate.launches - before}")
    require(not bool(out.any()) and not bool(weight.any()),
            "the refused call wrote the buffers")
    phase("tooling", f"contracts: a float32 starts table on the card "
                     f"refused before any launch: {refusal}")
    del out, weight, preds, valid, bump

    # ---- b. the lock-order sanitizer in a fresh process --------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_locksmith_") as tmp:
        tmp = Path(tmp)
        cfg_path = tmp / "sanitizer.json"
        cfg_path.write_text(json.dumps({"out": str(tmp / "report.json")}))
        env = dict(os.environ, CHUNKFLOW_LOCKSMITH="1",
                   CHUNKFLOW_LOCKSMITH_MODE="raise")
        for var in ("CHUNKFLOW_LOCKSMITH_SCOPE", "CHUNKFLOW_LOCKSMITH_HOLD_MS",
                    "CHUNKFLOW_SCHED", "CHUNKFLOW_SERVE", "CHUNKFLOW_INT8",
                    "CHUNKFLOW_PRECISION", "CHUNKFLOW_MESH"):
            env.pop(var, None)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.sanitizer_child("
             f"{str(cfg_path)!r})"],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=SANITIZER_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        require(proc.returncode == 0 and "SANITIZER_OK" in proc.stdout,
                f"the sanitizer subprocess failed (rc {proc.returncode}):\n"
                f"{text[-4000:]}")
        rep = json.loads((tmp / "report.json").read_text())
    for line in proc.stdout.splitlines():
        if line.startswith("[sanitizer]"):
            print(line, flush=True)
    require(rep["violations"] == 0 and rep["locks"] > 0,
            f"the sanitizer: {rep}")
    phase("tooling", f"locksmith (raise mode, scope chunkflow_tpu_torch): "
                     f"{rep['locks']} locks, {rep['acquires']} acquires, "
                     f"{rep['edges']} order edges, {rep['violations']} "
                     f"violations, {rep['hold_violations']} hold records, "
                     f"over phase 8's adaptive stream ({SANITIZER_CHUNKS} "
                     f"chunks) and phase 14's packer ({len(PACK_SHAPES)} "
                     f"requests, {PACK_THREADS} threads); the subprocess "
                     f"took {child_s:.1f} s")

    # ---- c. the program cost ledger -----------------------------------------
    telemetry.reset()  # this phase's own catalog
    chunks = cfg["chunks"]
    require(len(chunks) == LEDGER_CHUNKS + 1,
            f"the ledger needs {LEDGER_CHUNKS + 1} chunks")
    kwargs = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                  num_output_channels=CHANNELS, batch_size=BATCH)
    inf = Inferencer(framework="pytorch", model_variant="parity",
                     dtype="float32", **kwargs)
    torch.cuda.synchronize()
    reset_counts()
    inf(chunks[0])  # the family's first call: counted, timed as compile
    synced = []
    for c in chunks[1:]:
        t = time.perf_counter()
        inf(c)  # __call__ waits for the card
        synced.append(time.perf_counter() - t)
    launched = counts()
    for kname, n in launched.items():
        require(n == 18 * (LEDGER_CHUNKS + 1),
                f"ledger run: {kname} launched {n} times, not "
                f"{18 * (LEDGER_CHUNKS + 1)} (18 per chunk)")
    per_batch = conv_flops(inf.engine.model,
                           torch.zeros((BATCH, 1) + PIN, device=dev))
    n_patches = enumerate_patches(CHUNK, PIN, PIN, OVERLAP).num_patches
    n_batches = -(-n_patches // BATCH)
    # the JAX kernels' cost functions: one multiply per gathered uint8
    # voxel; per patch voxel *bump, *valid and + per channel, + weight
    kernel_flops = n_batches * (BATCH * P + BATCH * (2 * CHANNELS + 1) * P)
    # the other families, once each, for the catalog
    fold = Inferencer(framework="identity", blend="fold", **kwargs)
    fold(chunks[0])
    fold(chunks[1])
    rng = np.random.default_rng(24)
    requests = [Chunk(rng.integers(0, 256, s, dtype=np.uint8))
                for s in PACK_SHAPES[:LEDGER_PACK]]
    packer = PatchPacker(inf, max_wait_ms=5.0)
    try:
        for r in requests:
            packer.infer(r, timeout=300).host()
    finally:
        packer.close()
    mesh = Inferencer(framework="identity", mesh=LEDGER_MESH, **kwargs)
    mesh._mesh = [dev] * 2
    mesh(chunks[0])
    mesh(chunks[1])
    torch.cuda.synchronize()
    entries = profiling.catalog()
    scatter = [e for e in entries if e["family"] == "scatter"]
    require(len(scatter) == 1 and scatter[0]["calls"] == LEDGER_CHUNKS + 1,
            f"the ledger's scatter records: {scatter}")
    scatter = scatter[0]
    expected = n_batches * per_batch + kernel_flops
    require(scatter["flops"] == expected,
            f"the ledger's scatter FLOPs {scatter['flops']} != conv_flops "
            f"x {n_batches} + the kernels' {expected}")
    require(scatter["device_kind"] and "h100" in
            scatter["device_kind"].lower(),
            f"the ledger's device {scatter['device_kind']!r}")
    families = sorted({e["family"] for e in entries})
    require(set(families) >= {"scatter", "fold", "serve_gather",
                              "serve_forward", "serve_overlay",
                              "serve_scatter", "shard"},
            f"the ledger's families: {families}")
    for e in sorted(entries, key=lambda e: (e["family"], e["key"])):
        exec_s = e["exec_mean_s"]
        phase("tooling", f"ledger {e['family']} [{e['key']}]: "
                         f"{e['calls']} calls, compile {e['compile_s']:.3f} s, "
                         f"exec {exec_s * 1e3 if exec_s else 0.0:.3f} ms, "
                         f"{(e['flops'] or 0.0) / 1e9:.3f} GFLOP, "
                         f"{(e['bytes_accessed'] or 0.0) / 1e6:.1f} MB, "
                         f"roofline {(e['roofline_s'] or 0.0) * 1e3:.3f} ms, "
                         f"util {e['roofline_util']}, lost {e['lost_s']} s, "
                         f"h2d {e['h2d_bytes']}, hbm_i "
                         f"{e['hbm_intermediate_bytes']}, collective "
                         f"{e['collective_bytes']} ({e['device_kind']}, "
                         f"{e['peak_source']})")
    gauges = telemetry.snapshot()["gauges"]
    phase("tooling", f"ledger scatter (parity float32 main path): "
                     f"{scatter['flops'] / 1e12:.4f} TFLOP a chunk == "
                     f"conv_flops {per_batch / 1e12:.4f} TFLOP x "
                     f"{n_batches} batches + the kernels' "
                     f"{kernel_flops / 1e9:.4f} GFLOP; roofline "
                     f"{scatter['roofline_s'] * 1e3:.3f} ms against the "
                     f"dispatch wall {scatter['exec_mean_s'] * 1e3:.3f} ms "
                     f"(util {scatter['roofline_util']}, an upper bound) and "
                     f"the device-synchronized {statistics.mean(synced):.4f} "
                     f"s/chunk of the same {LEDGER_CHUNKS} calls "
                     f"({[round(x, 4) for x in synced]}); compile call "
                     f"{scatter['compile_s']:.3f} s; mesh {LEDGER_MESH} "
                     f"split: compute {gauges.get('shard/compute_s_est')} s, "
                     f"collective {gauges.get('shard/collective_s_est')} s, "
                     f"share {gauges.get('shard/collective_share_est')}; "
                     f"{card}")
    del inf, fold, mesh, packer
    telemetry.reset()
    return launched


def sanitizer_child(cfg_path):
    """Phase 24's subprocess: the lock-order sanitizer installed before the
    port is imported, then phase 8's adaptive stream and phase 14's
    packer on ``cuda:0``; writes the sanitizer's report and prints
    ``SANITIZER_OK``."""
    cfg = json.loads(Path(cfg_path).read_text())
    sys.path.insert(0, str(ROOT))
    from chunkflow_tpu_torch.testing import locksmith

    require(locksmith.install(), "CHUNKFLOW_LOCKSMITH is off")
    import numpy as np
    import torch

    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.ops import accumulate, gather
    from chunkflow_tpu_torch.serve import PatchPacker

    kwargs = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                  num_output_channels=CHANNELS)
    variant, dtype = STREAM_FAMILIES[0]
    rng = np.random.default_rng(8)
    chunks = [Chunk(rng.integers(0, 256, CHUNK, dtype=np.uint8),
                    voxel_offset=(CHUNK[0] * i, 0, 0))
              for i in range(SANITIZER_CHUNKS)]
    inf = Inferencer(framework="pytorch", model_variant=variant,
                     dtype=dtype, batch_size=BATCH, **kwargs)
    serial = [inf(c).host().array for c in chunks]
    gather.launches = accumulate.launches = 0
    streamed = [o.array for o in inf.stream(iter(chunks), adaptive=True)]
    require(all(np.array_equal(a, b) for a, b in zip(streamed, serial)),
            "the adaptive stream under the sanitizer differs from the "
            "serial loop")
    require(gather.launches == accumulate.launches == 18 * SANITIZER_CHUNKS,
            f"stream launches {gather.launches}, {accumulate.launches}")
    print(f"[sanitizer] {variant} {dtype}: {SANITIZER_CHUNKS} chunks "
          f"streamed (adaptive) bitwise the serial loop, 18 + 18 launches "
          f"per chunk", flush=True)
    del inf
    rng = np.random.default_rng(14)
    requests = [Chunk(rng.integers(0, 256, s, dtype=np.uint8),
                      voxel_offset=(100 * i, 0, 0))
                for i, s in enumerate(PACK_SHAPES)]
    inf = Inferencer(framework="pytorch", model_variant="tpu",
                     dtype="bfloat16", batch_size=PACK_BATCH, **kwargs)
    refs = [inf(c).host().array for c in requests]
    packer = PatchPacker(inf, max_wait_ms=5.0)
    results = [None] * len(requests)

    def submitter(k):
        handles = [(i, packer.submit(requests[i]))
                   for i in range(k, len(requests), PACK_THREADS)]
        for i, handle in handles:
            results[i] = handle.result(timeout=600).host().array

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(PACK_THREADS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        packer.close()
    require(all(r is not None and np.array_equal(r, ref)
                for r, ref in zip(results, refs)),
            "the packer under the sanitizer differs from one-by-one calls")
    print(f"[sanitizer] tpu bfloat16 packer: {len(requests)} requests from "
          f"{PACK_THREADS} threads, each bitwise its one-by-one call",
          flush=True)
    rep = locksmith.report()
    for v in rep["violations"]:
        print(f"[sanitizer] violation: {v['detail']}", flush=True)
    summary = {"locks": rep["locks"], "acquires": rep["acquires"],
               "edges": rep["edges"], "violations": len(rep["violations"]),
               "hold_violations": len(rep["hold_violations"])}
    Path(cfg["out"]).write_text(json.dumps(summary))
    require(not rep["violations"], f"lock-order violations: {summary}")
    print("SANITIZER_OK", flush=True)


def sharded_array(np):
    """The values of ``SHARDED_STORE``: the seeded array, 0 (the fill
    value) where nothing was written."""
    arr = np.random.default_rng(SHARDED_SEED).integers(
        1, 256, SHARDED_SHAPE, dtype=np.uint8)
    for hole in SHARDED_HOLES:
        arr[tuple(slice(a, b) for a, b in hole)] = 0
    return arr


def _flax_layout(state):
    """A torch ``UNet3D`` state dict as the flax param tree (numpy) the
    JAX package's ``UNet3D`` holds — the converter's input layout."""
    tree = {}
    for key, value in state.items():
        *module, leaf = key.split(".")
        value = value.detach().cpu().numpy()
        if leaf == "weight" and value.ndim == 5:
            if module[-1].startswith("up"):  # ConvTranspose3d [I, O, ...]
                value = value.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
            else:  # Conv3d [O, I, ...]
                value = value.transpose(2, 3, 4, 1, 0)
            leaf = "kernel"
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for part in module:
            node = node.setdefault(part, {})
        node[leaf] = value.copy()
    return tree


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
    except Exception:
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED with an exception", file=sys.stderr)
        sys.exit(1)
