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
             checkpoint, the ``tpu`` and ``tpu_s2d4`` flagships; ``tpu_mxu``
             is ``tpu``'s module), float32 (TF32 off) and bfloat16, on the
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

Launch counts are read from each kernel wrapper's counter, set to 0 just
before a main path runs and read just after. The line before the last is
one JSON object with every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
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
# phase 8: distinct seeded chunks streamed per family; the family whose
# host-side share is the largest, and the parity UNet3D
STREAM_K = 6
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
# the workers' visibility timeout (s): a SIGKILLed worker's claims come
# back after it; the lease heartbeat keeps a live worker's claims
VISIBILITY_S = 10
# profiler sessions taken before a trace counts as lost; the busy-wait
# (GPU clock cycles, ~1 ms on an H100) ahead of a CUDA-event timing
TRACE_TRIES = 4
LEAD_CYCLES = 2_000_000


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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

    def _event_ms(self, fn, reps):
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
        return self._event_ms(fn, reps)


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


def main() -> int:
    import numpy as np
    import torch

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
    from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init
    from chunkflow_tpu_torch.ops import accumulate, gather

    OUT_DIR.mkdir(parents=True, exist_ok=True)
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
    }
    err = {name: 0.0 for name in kernels}

    def reset_counts():
        for k in kernels.values():
            k["module"].launches = 0

    def counts():
        return {name: k["module"].launches for name, k in kernels.items()}

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

    # ---- 1. card --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    phase("card", f"{name}, {torch.cuda.device_count()} device(s); torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}")
    # name and power limit exactly as nvidia-smi gives them
    print(smi.stdout.strip().splitlines()[0], flush=True)
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
    torch.cuda.synchronize()
    phase("kernels", f"kernel == plain bitwise, gather alignment sweep "
                     f"{sweep} cases, rows wider than a tile in "
                     f"{len(GATHER_DTYPES)} dtypes; launches in this phase: "
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

    # ---- 4. identity main path ------------------------------------------
    def run_paths(inferencer, chunk, label):
        """Kernel path (counted) then plain path; bitwise equal."""
        inferencer(chunk)  # warm-up
        reset_counts()
        t = time.perf_counter()
        got = inferencer(chunk)
        wall = time.perf_counter() - t
        launched = counts()
        for kname, n in launched.items():
            require(n > 0, f"{label}: {kname} kernel never launched")
        with plain_functions():
            ref = inferencer(chunk)
        require(counts() == launched,
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
                    f"{sum(kernels[k]['ms'] * launched[k] for k in kernels):.2f}"
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

    # ---- 7. every convnet family, both compute dtypes --------------------
    rsunet_files = _reference_rsunet(torch, OUT_DIR, dev)
    tpu = engines.create_engine("pytorch", model_variant="tpu").model
    mxu = engines.create_engine("pytorch", model_variant="tpu_mxu").model
    require(type(tpu) is type(mxu) and all(
        k == j and torch.equal(a, b) for (k, a), (j, b) in zip(
            tpu.state_dict().items(), mxu.state_dict().items())),
        "models: tpu_mxu does not build tpu's module and weights")
    phase("models", "tpu_mxu builds the tpu module with the same seeded "
                    "weights (one module: the variants differ only in the "
                    "JAX package's XLA lowering); not timed twice")
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
            torch.cuda.reset_peak_memory_stats()
            result, wall, launched = run_paths(inf, chunk_u8, label)
            peak = torch.cuda.max_memory_allocated()
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

    # ---- 10. volume: the worker loop on disk ------------------------------
    torch.cuda.empty_cache()
    volume_launches = volume_phase(
        torch, dict(volume=VOLUME, volume_block=VOLUME_BLOCK, roi=ROI,
                    task=TASK, margin=MARGIN, out_block=OUT_BLOCK, pin=PIN,
                    overlap=OVERLAP, batch=BATCH, families=VOLUME_FAMILIES,
                    device="cuda"),
        weights=state, reset_counts=reset_counts, counts=counts,
        in_memory=in_memory)
    for kname, n in volume_launches.items():
        kernels[kname]["launches"] += n

    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": err[kname], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"]}
        for kname, k in kernels.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def volume_phase(torch, cfg, weights, reset_counts, counts, in_memory):
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
    state dict, written as a ``.pt`` file for the workers. Returns the
    kernels' launches in the counted runs."""
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
                    chaos="once=op/inference,lifecycle/pre_ack")
                _, t2 = run_worker(
                    worker_args(family, queue, ledger, out, 30),
                    chaos="once=lifecycle/pre_ledger:action=kill",
                    killed=True)
                w3, t3 = run_worker(worker_args(family, queue, ledger, out,
                                                3 * VISIBILITY_S))
                stats = open_queue(queue).stats()
                require(stats["pending"] == stats["inflight"]
                        == stats["dead"] == 0,
                        f"volume: the queue did not drain: {stats}")
                keys = FileLedger(ledger).keys()
                require(sorted(keys) == sorted(b.string for b in boxes),
                        f"volume: the ledger holds {len(keys)} keys")
                acks = {b.string: 0 for b in boxes}
                for name in os.listdir(metrics):
                    with open(os.path.join(metrics, name)) as f:
                        for ln in f:
                            event = json.loads(ln)
                            if event["name"] in ("lifecycle/committed",
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
                                f"{t3:.1f} s: {_brief(w3)}")
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
    return total


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
