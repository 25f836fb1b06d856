#!/usr/bin/env python3
"""Where the Hopper int8 convolution kernel spends its time, on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 int8_ablation.py

It builds ``chunkflow_tpu_torch/csrc/conv3d_int8.cu`` as it stands and
copies of it with one part taken out, each made by replacing a piece of
the source text (the script fails if a piece is not found):

- ``no_epilogue``: the products but no staging and no stores;
- ``no_products``: the halo and A-fragment loads and the epilogue, but
  no ``wgmma``;
- ``no_a_loads``: no ``ldmatrix`` after a tile's first K group, so the
  products reuse the first group's A fragments;
- ``no_halo_loads``: the producer arrives on the halo barrier without
  loading, so the products read whatever the buffers hold.

Each is timed at the layer shapes below in turns (base, the variants,
then the same in reverse), between CUDA events with the L2 cache flushed
(``chip_smoke.Timer``). Only the base's sums are right: it is checked
against the plain version; the variants are for timing alone. One more
copy takes ``clock64`` stamps at each phase of block 0's first tiles
(warps 0 and 3 of warpgroup 0) and prints the median cycles of each
phase. The ``nvcc -Xptxas -v`` report (registers, spills) of each build
is printed too, then one JSON line with every time. Needs about a
minute of the card.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ablation"
# (label, x [B, C, D, H, W], w [N, C, kz, ky, kx], (stride, padding))
SHAPES = (
    ("parity enc0", (2, 28, 20, 256, 256), (28, 28, 3, 3, 3), (1, 1)),
    ("parity conv_in", (2, 1, 20, 256, 256), (28, 1, 1, 5, 5), (1, (0, 2, 2))),
    ("parity head", (2, 28, 20, 256, 256), (3, 28, 1, 5, 5), (1, (0, 2, 2))),
    ("tpu_s2d4 112", (2, 112, 20, 64, 64), (112, 112, 3, 3, 3), (1, 1)),
    ("tpu_s2d4 bridge", (2, 256, 5, 8, 8), (256, 256, 3, 3, 3), (1, 1)),
)
STAMPED = ("parity enc0", "parity conv_in")
PHASES = ("halo wait", "products issued", "products done", "tile_of",
          "staged", "barrier", "stored", "barrier")


def replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"int8_ablation: the kernel source changed; not "
                         f"found once: {old[:60]!r}")
    return src.replace(old, new)


def no_epilogue(src: str) -> str:
    start = src.index("    // epilogue. Element j of the accumulator")
    end = src.index("\n  }\n}\n", start)
    # keep the accumulators live, so the products are not optimised away
    return (src[:start] + "    if (acc[0] == 0x7fffffff && acc[kAcc - 1] "
            "== 0x7fffffff) out[0] = 1;" + src[end:])


def no_products(src: str) -> str:
    return replace(src, "  wgmma_fence();\n  mma_steps<BN, kF>(acc, f, wb, "
                   "ls);\n  wgmma_commit();",
                   "  wgmma_fence();\n  wgmma_commit();")


def no_a_loads(src: str) -> str:
    return replace(src, "    load_a<kF>(g, t + kF, lrow, table, half);\n",
                   "")


def no_halo_loads(src: str) -> str:
    start = src.index("      mbar_expect_tx(&halo_full[hb], halo_tx);")
    end = src.index("      if (p.resident) continue;", start)
    return src[:start] + "      mbar_arrive(&halo_full[hb]);\n" + src[end:]


def stamped(src: str) -> str:
    """clock64 at each phase of the first 16 tiles of block (0, 0, 0),
    threads 0 and 96, into a device array read back by stamps_read."""
    def at(k):
        return (f"if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0"
                f" && (threadIdx.x == 0 || threadIdx.x == 96) && i < 16) "
                f"g_stamps[(threadIdx.x / 96) * 256 + i * 16 + {k}] = "
                f"clock64();")
    src = src.replace("namespace {\n",
                      "__device__ long long g_stamps[512];\nnamespace {\n",
                      1)
    src = replace(src, "    if (p.resident) mbar_wait(&w_full[0], 0);\n",
                  f"    {at(0)}\n    if (p.resident) mbar_wait(&w_full[0],"
                  f" 0);\n")
    src = replace(src, "    const uint32_t lrow = hbase + (i16 >> 3) * "
                  "p.sbo + (i16 & 7) * 16;\n",
                  f"    {at(1)}\n    const uint32_t lrow = hbase + (i16 >> "
                  f"3) * p.sbo + (i16 & 7) * 16;\n")
    src = replace(src, "    wgmma_wait<0>();\n    fence_acc(acc);\n",
                  f"    {at(2)}\n    wgmma_wait<0>();\n    fence_acc(acc);"
                  f"\n    {at(3)}\n")
    src = replace(src, "    const Pos tl = tile_of(mt, p);\n    if (add) {",
                  f"    const Pos tl = tile_of(mt, p);\n    {at(4)}\n    "
                  f"if (add) {{")
    src = replace(src, "        stage_wg[col * kStagePitch + r] = acc[jj];\n"
                  "      }\n      named_sync(1 + wg);\n",
                  f"        stage_wg[col * kStagePitch + r] = acc[jj];\n  "
                  f"    }}\n      {at(5)}\n      named_sync(1 + wg);\n      "
                  f"{at(6)}\n")
    src = replace(src, "      named_sync(1 + wg);\n    }\n  }\n}",
                  f"      {at(7)}\n      named_sync(1 + wg);\n      "
                  f"{at(8)}\n    }}\n  }}\n}}")
    return src + ('\nextern "C" int stamps_read(long long* host) {\n'
                  '  return static_cast<int>(cudaMemcpyFromSymbol(\n'
                  '      host, g_stamps, sizeof(g_stamps)));\n}\n')


def build(name: str, src: str):
    from chunkflow_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    lib_path = OUT / f"lib{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"int8_ablation: {name} failed to build:\n"
                         f"{proc.stdout}{proc.stderr}")
    # ptxas's report (on stderr): per kernel instance, its spills and its
    # registers
    per_kernel, current = [], "pack"
    for line in (proc.stdout + proc.stderr).splitlines():
        found = re.search(r"Compiling entry function '.*?kernel(ILi(\d+))?",
                          line)
        if found:
            current = f"BN={found.group(2)}" if found.group(2) else "pack"
        elif "spill stores" in line:
            spill = line.split(",")[1].strip().split()[0]
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            per_kernel.append(f"{current} {regs} registers, {spill} B "
                              f"spilled")
    print(f"[build] {name}: {'; '.join(per_kernel)}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv3d_int8_pack_launch.argtypes = [p, p] + [i] * 5 + [q] * 5 \
        + [i] * 4 + [p]
    lib.conv3d_int8_pack_launch.restype = i
    lib.conv3d_int8_launch.argtypes = [p, p, p, p, i, p]
    lib.conv3d_int8_launch.restype = i
    lib.conv3d_int8_error_string.argtypes = [i]
    lib.conv3d_int8_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_ablation: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from chunkflow_tpu_torch import _build
    from chunkflow_tpu_torch.ops import int8_conv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    base = (_build.CSRC / "conv3d_int8.cu").read_text()
    variants = {"base": base, "no_epilogue": no_epilogue(base),
                "no_products": no_products(base),
                "no_a_loads": no_a_loads(base),
                "no_halo_loads": no_halo_loads(base)}
    libs = {name: build(name, src) for name, src in variants.items()}
    stamp_lib = build("stamped", stamped(base))
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator().manual_seed(9)
    order = list(libs) + list(libs)[::-1]
    result = {}
    for label, xs, ws, args in SHAPES:
        x = int8_conv.channels_last_padded(torch.randint(
            -127, 128, xs, generator=gen, dtype=torch.int8).cuda())
        w = torch.randint(-127, 128, ws, generator=gen,
                          dtype=torch.int8).cuda().contiguous(
            memory_format=torch.channels_last_3d)
        p = int8_conv.plan(xs, ws, *args)
        wpack = int8_conv.pack_weights(w, p)
        out = torch.zeros(int8_conv.output_shape(xs, ws, *args),
                          dtype=torch.int32, device="cuda")
        times = {name: [] for name in libs}
        for name in order:
            int8_conv._libs["conv3d_int8"] = libs[name]
            times[name].append(timer.event_ms(
                lambda: int8_conv.hopper_kernel(x, wpack, p, out), 5))
        int8_conv._libs["conv3d_int8"] = libs["base"]
        out.zero_()
        int8_conv.hopper_kernel(x, wpack, p, out)
        if not torch.equal(out, int8_conv.conv3d_int8_plain(x, w, *args)):
            raise SystemExit(f"int8_ablation: the base kernel differs from "
                             f"the plain version at {label}")
        result[label] = {name: statistics.median(t)
                         for name, t in times.items()}
        print(f"[time] {label}: " + ", ".join(
            f"{name} {', '.join(f'{v:.4f}' for v in t)} ms"
            for name, t in times.items()), flush=True)
        if label in STAMPED:
            int8_conv._libs["conv3d_int8"] = stamp_lib
            for _ in range(2):
                int8_conv.hopper_kernel(x, wpack, p, out)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 512)()
            _build.check(stamp_lib, "conv3d_int8", stamp_lib.stamps_read(buf))
            spans = {ph: [] for ph in range(len(PHASES) + 1)}
            for warp in range(2):
                for tile in range(2, 12):  # past the pipeline's start
                    s = buf[warp * 256 + tile * 16:warp * 256 + tile * 16 + 9]
                    nxt = buf[warp * 256 + (tile + 1) * 16]
                    for k in range(len(PHASES)):
                        spans[k].append(s[k + 1] - s[k])
                    spans[len(PHASES)].append(nxt - s[8])
            med = {name: statistics.median(spans[k]) for k, name in
                   enumerate(PHASES + ("to the next tile",))}
            result[label]["cycles per tile"] = med
            print(f"[stamps] {label}, block 0, cycles per tile (median of "
                  f"20): " + ", ".join(f"{k} {v:.0f}"
                                       for k, v in med.items()), flush=True)
            int8_conv._libs["conv3d_int8"] = libs["base"]
        del x, w, wpack, out
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
