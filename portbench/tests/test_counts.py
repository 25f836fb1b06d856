"""The yardstick's arithmetic against counts made by hand at the main
path's shapes: 20x256x256 patches, 4x64x64 overlap, batches of 2, one
64x512x512 uint8 chunk."""
import json

import numpy as np

from reference import blend, counts
from tiny import BENCH

CHUNK = (64, 512, 512)


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_rsunet_convolutions():
    v0 = 20 * 256 * 256
    v1, v2, v3, v4 = v0 // 4, v0 // 16, v0 // 64, v0 // 256
    w0, w1, w2, w3, w4 = 28, 36, 48, 64, 80

    def block(v, cin, c):  # (1,3,3) then two (3,3,3)
        return 2 * v * c * (cin * 9 + c * 27 + c * 27)

    flops = (2 * v0 * w0 * 1 * 25
             + block(v0, w0, w0) + block(v1, w0, w1) + block(v2, w1, w2)
             + block(v3, w2, w3) + block(v4, w3, w4)
             + 2 * w4 * v4 * w3 * 4 + block(v3, w3, w3)
             + 2 * w3 * v3 * w2 * 4 + block(v2, w2, w2)
             + 2 * w2 * v2 * w1 * 4 + block(v1, w1, w1)
             + 2 * w1 * v1 * w0 * 4 + block(v0, w0, w0)
             + 2 * v0 * 3 * w0)
    assert counts.conv_flops(config("rsunet-bf16"), (20, 256, 256)) == flops


def test_unet3d_s2d4_convolutions():
    u0 = 20 * 64 * 64
    u1, u2, u3 = u0 // 4, u0 // 32, u0 // 256
    w0, w1, w2, w3 = 112, 144, 192, 256

    def block(u, cin, c):  # two (3,3,3)
        return 2 * u * c * 27 * (cin + c)

    flops = (2 * u0 * w0 * 16 * 25
             + block(u0, w0, w0) + block(u1, w0, w1) + block(u2, w1, w2)
             + block(u3, w2, w3)
             + 2 * w3 * u3 * w2 * 8 + block(u2, w2, w2)
             + 2 * w2 * u2 * w1 * 8 + block(u1, w1, w1)
             + 2 * w1 * u1 * w0 * 4 + block(u0, w0, w0)
             + 2 * u0 * 48 * w0 * 25)
    assert counts.conv_flops(config("tpu_s2d4-bf16"), (20, 256, 256)) \
        == flops


def test_patches_of_a_chunk():
    starts = blend.patch_starts(CHUNK, (20, 256, 256), (4, 64, 64))
    zs, ys, xs = (sorted(set(starts[:, i])) for i in range(3))
    assert (zs, ys, xs) == ([0, 16, 32, 44], [0, 192, 256], [0, 192, 256])
    assert counts.patches_per_chunk(CHUNK, (20, 256, 256), (4, 64, 64)) \
        == 36


def _union_of_two(a, b, patch):
    inter = 1
    for i in range(3):
        lo, hi = max(a[i], b[i]), min(a[i], b[i]) + patch[i]
        inter *= max(0, hi - lo)
    return 2 * int(np.prod(patch)) - inter


def test_kernel_bytes_and_bounds():
    patch = (20, 256, 256)
    p = int(np.prod(patch))
    costs = counts.chunk_costs(CHUNK, patch, (4, 64, 64), 2, 1, 3)
    starts = blend.patch_starts(CHUNK, patch, (4, 64, 64))
    gather = 18 * (2 * p * (1 + 4) + 2 * 12)
    accumulate = sum(
        (2 * 3 * p + p + 2) * 4 + 2 * 12
        + 2 * 4 * 4 * _union_of_two(starts[i], starts[i + 1], patch)
        for i in range(0, 36, 2))
    assert costs["gather"]["launches"] == costs["accumulate"]["launches"] \
        == 18
    assert costs["gather"]["bytes"] == gather
    assert costs["accumulate"]["bytes"] == accumulate
    # both are bound by bytes at these shapes
    assert np.isclose(costs["gather"]["bound_s"], gather / 3.35e12)
    assert np.isclose(costs["accumulate"]["bound_s"], accumulate / 3.35e12)
