"""The int8 convolution's plan and layouts on the CPU (no card needed).

``ops/int8_conv.plan`` picks the kernel of a shape and tiles the Hopper
kernel's work; these tests hold it on every shape class of the card
tests and every layer shape of the five families at full width:

- the path is a function of the shape alone: stride-1, dilation-1 layers
  take the Hopper kernel, the rest the generic one;
- the M tiles cover every output position once, the N tiles every output
  channel, the K steps every (16-channel slab, tap) pair once, and the
  split-K ranges partition the steps; the padded channel count is the
  16-byte pitch the kernel's TMA loads need, and the shared memory fits;
- split-K is exact: the plain convolution of each split's channels and
  taps, summed in the plan's order, is ``torch.equal`` to
  ``conv3d_int8_plain``;
- an emulation of the kernel's own indexing in numpy (the halo tile with
  its zero fill, the per-sub-step offset table, the packed weights, the
  tile's rows and their stores) equals the plain version;
- the quantize pass's padded int8 image gives the same real-leg result,
  bitwise, as the unpadded channels-last copy it replaced.
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.inference import engines, precision
from chunkflow_tpu_torch.ops import int8_conv
from tests.test_torch_cuda import INT8_CONV_CASES, INT8_HOPPER_CASES

torch.set_num_threads(1)

FAMILIES = ("parity", "rsunet", "tpu", "tpu_mxu", "tpu_s2d4")


def _record(variant, size, device="cpu"):
    """The (x shape, w shape, args) of every int8 convolution one real
    forward of ``variant`` at full width gives the kernel, on a batch of
    2 x ``size``; on the meta device nothing is computed."""
    engine = engines.create_engine("pytorch", model_variant=variant)
    engine.model.to(device)
    shapes = []

    def record(x, w, *args):
        shapes.append((tuple(x.shape), tuple(w.shape), args))
        if device == "meta":
            return torch.zeros(int8_conv.output_shape(x.shape, w.shape,
                                                      *args),
                               dtype=torch.int32, device=device)
        return int8_conv.conv3d_int8_plain(x, w, *args)

    batch = torch.rand((2, 1) + size, generator=torch.Generator()
                       .manual_seed(0)).to(device)
    with mock.patch.dict(os.environ, {"CHUNKFLOW_INT8": "real"}), \
            mock.patch.object(int8_conv, "conv3d_int8", record), \
            torch.no_grad():
        precision.wrap_apply(engine.apply, "int8", engine.params,
                             engine.call)(batch)
    return shapes


@pytest.fixture(scope="module")
def family_shapes():
    """Every distinct layer shape of the five families' real forwards at
    full width: on a small CPU input, and on the main path's 20 x 256 x
    256 patches by shape alone."""
    found = {}
    for variant in FAMILIES:
        for size, device in (((4, 32, 32), "cpu"),
                             ((20, 256, 256), "meta")):
            for s in _record(variant, size, device):
                found.setdefault(s, variant)
    return found


def _cases():
    for name, (xs, ws, st, pd, dl) in INT8_CONV_CASES.items():
        yield name, xs, ws, (st, pd, dl)
    for name, (xs, ws, pd) in INT8_HOPPER_CASES.items():
        yield name, xs, ws, (1, pd, 1)


def _all_shapes(family_shapes):
    shapes = [(xs, ws, args) for _, xs, ws, args in _cases()]
    return shapes + list(family_shapes)


def _positions(p):
    """The output positions of every (M tile, live row), in tile order."""
    nx, ny = -(-p.Wo // p.wt), -(-p.Ho // p.ht)
    nz = -(-p.Do // p.dt)
    m = np.arange(int8_conv.TILE_ROWS)
    dx, dy = m % p.wt, m // p.wt % p.ht
    dz, db = m // (p.wt * p.ht) % p.dt, m // (p.wt * p.ht * p.dt)
    out = []
    for mt in range(p.m_tiles):
        tx, r = mt % nx, mt // nx
        ty, r = r % ny, r // ny
        tz, tb = r % nz, r // nz
        out.append(np.stack([tb * p.bt + db, tz * p.dt + dz,
                             ty * p.ht + dy, tx * p.wt + dx], axis=1))
    return np.concatenate(out)


def _halo_rows(p):
    """The byte offset of each tile row's position in a halo slab."""
    Dh, Hh, Wh = p.dt + p.kz - 1, p.ht + p.ky - 1, p.wt + p.kx - 1
    m = np.arange(int8_conv.TILE_ROWS)
    assert p.bt * p.dt * p.ht * p.wt == m.size
    dx, dy = m % p.wt, m // p.wt % p.ht
    dz, db = m // (p.wt * p.ht) % p.dt, m // (p.wt * p.ht * p.dt)
    return (((db * Dh + dz) * Hh + dy) * Wh + dx) * 16


def _logical(p, packed):
    """The packed weights unswizzled: ``[n_tiles, packed_steps, 2, bn,
    16]``, K step by K step."""
    g = p.packed_steps // int8_conv.GROUP
    t = packed.reshape(p.n_tiles, g, p.bn, 8, 16)
    n = torch.arange(p.bn).reshape(-1, 1)
    t = t[:, :, n, torch.arange(8).reshape(1, -1) ^ (n % 8)]
    t = t.reshape(p.n_tiles, g, p.bn, int8_conv.GROUP, 2, 16)
    return t.permute(0, 1, 3, 4, 2, 5).reshape(p.n_tiles, -1, 2, p.bn, 16)


def _substeps(p, s0, s1):
    u = np.arange(2 * s0, min(2 * s1, p.substeps))
    return u // p.taps, u % p.taps  # (slab, tap)


def test_the_path_is_a_function_of_the_shape(family_shapes):
    for xs, ws, args in _all_shapes(family_shapes):
        first = int8_conv.plan(xs, ws, *args)
        assert first == int8_conv.plan(list(xs), list(ws), *args)
        stride = args[0] if args else 1
        dilation = args[2] if len(args) > 2 else 1
        unit = int8_conv._triple(stride, "s") == (1, 1, 1) and \
            int8_conv._triple(dilation, "d") == (1, 1, 1)
        assert first.path == ("hopper" if unit else "generic"), (xs, ws)
    assert int8_conv.plan(*INT8_CONV_CASES["c3_strided_dilated"][:2], 2, 1,
                          2).path == "generic"


def test_every_family_layer_plans_the_hopper_kernel(family_shapes):
    for (xs, ws, args), variant in family_shapes.items():
        p = int8_conv.plan(xs, ws, *args)
        assert p.path == "hopper", (variant, xs, ws, args)
        assert p.smem <= int8_conv.BLOCK_SMEM
        assert p.cp == -(-xs[1] // 16) * 16 and p.cp % 16 == 0
        assert p.bn in int8_conv.WIDTHS
        assert 2 <= p.stages <= int8_conv.MAX_STAGES or p.resident
        assert max(p.dt + p.kz, p.ht + p.ky, p.wt + p.kx) - 1 <= 256


@pytest.mark.parametrize("which", ["cases", "families"])
def test_tiles_and_splits_cover_the_work_once(family_shapes, which):
    shapes = ([(xs, ws, a) for _, xs, ws, a in _cases()]
              if which == "cases" else list(family_shapes))
    for xs, ws, args in shapes:
        p = int8_conv.plan(xs, ws, *args)
        if p.path != "hopper":
            continue
        pos = _positions(p)
        inside = ((pos[:, 0] < p.B) & (pos[:, 1] < p.Do)
                  & (pos[:, 2] < p.Ho) & (pos[:, 3] < p.Wo))
        flat = np.ravel_multi_index(pos[inside].T, (p.B, p.Do, p.Ho, p.Wo))
        assert np.array_equal(np.sort(flat), np.arange(p.B * p.Do * p.Ho
                                                       * p.Wo)), (xs, ws)
        assert p.bn * p.n_tiles >= p.N > p.bn * (p.n_tiles - 1)
        # each warpgroup's 64 rows: 8 groups of 8 positions, 16 bytes
        # apart within a group and p.sbo apart between groups in the halo
        # (the rows ldmatrix reads for it)
        rows = _halo_rows(p)
        i = np.arange(64)
        for wg in range(rows.size // 64):
            assert np.array_equal(rows[64 * wg + i], rows[64 * wg]
                                  + i // 8 * p.sbo + i % 8 * 16), (xs, ws)
        ranges = p.split_ranges()
        assert len(ranges) == p.splits and ranges[0][0] == 0
        assert ranges[-1][1] == p.steps
        assert all(a[1] == b[0] and a[0] < a[1]
                   for a, b in zip(ranges, ranges[1:]))
        seen = np.zeros((p.cp // 16, p.taps), dtype=int)
        for s0, s1 in ranges:
            slab, tap = _substeps(p, s0, s1)
            np.add.at(seen, (slab, tap), 1)
            lo, hi = p.split_slabs(s0, s1)
            assert lo == slab.min() and hi == slab.max()
            assert (hi - lo + 1) * p.slab_bytes <= p.halo_bytes
        assert (seen == 1).all(), (xs, ws)


def _split_sum(x, w, p, args):
    """The plain convolution of each split's (slab, tap) pairs, summed in
    the plan's split order."""
    N, C = w.shape[:2]
    total = None
    for s0, s1 in p.split_ranges():
        mask = torch.zeros((p.cp, p.taps), dtype=torch.int8)
        slab, tap = _substeps(p, s0, s1)
        for sl, t in zip(slab, tap):
            mask[16 * sl:16 * sl + 16, t] = 1
        wm = w * mask[:C].reshape((1, C) + tuple(w.shape[2:]))
        part = int8_conv.conv3d_int8_plain(x, wm, *args)
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("name", [n for n, xs, ws, a in _cases()
                                  if n != "c3_strided_dilated"])
def test_split_k_is_exact(name):
    xs, ws, args = next((x, w, a) for n, x, w, a in _cases() if n == name)
    p = int8_conv.plan(xs, ws, *args)
    g = torch.Generator().manual_seed(len(name))
    x = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8)
    assert torch.equal(_split_sum(x, w, p, args),
                       int8_conv.conv3d_int8_plain(x, w, *args))


def test_split_k_of_the_bridge_is_exact():
    """The split-K layer of the card tests (``3x3x3_256``) at the
    ``tpu_s2d4`` bridge's real shape, where the plan splits K 22 ways."""
    xs, ws = (2, 256, 5, 8, 8), (256, 256, 3, 3, 3)
    p = int8_conv.plan(xs, ws, 1, 1)
    assert p.splits > 8 and p.gx * p.splits * p.n_tiles > 100
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8)
    assert torch.equal(_split_sum(x, w, p, (1, 1)),
                       int8_conv.conv3d_int8_plain(x, w, 1, 1))


def _emulate(x, w, p):
    """The Hopper kernel's indexing, in numpy: per split and M tile, the
    halo box (zero outside the input), each sub-step's offset in it from
    the table, 16 bytes per output row, times the packed weights."""
    B, C, D, H, W = x.shape
    xl = np.zeros((B, D, H, W, p.cp), dtype=np.int64)
    xl[..., :C] = x.permute(0, 2, 3, 4, 1).numpy()
    wpack = _logical(p, int8_conv.pack_weights_plain(w, p)).numpy()
    wpack = wpack.astype(np.int64)
    Dh, Hh, Wh = p.dt + p.kz - 1, p.ht + p.ky - 1, p.wt + p.kx - 1
    box = p.bt * Dh * Hh * Wh * 16
    out = np.zeros((B, p.n_tiles * p.bn, p.Do, p.Ho, p.Wo), dtype=np.int64)
    rowbase = _halo_rows(p)
    pos = _positions(p).reshape(p.m_tiles, -1, 4)
    for s0, s1 in p.split_ranges():
        sl0, sl1 = p.split_slabs(s0, s1)
        u = np.minimum(np.arange(2 * s0, 2 * s1), p.substeps - 1)
        slab, tap = u // p.taps, u % p.taps
        tz, ty, tx = (tap // (p.ky * p.kx), tap // p.kx % p.ky,
                      tap % p.kx)
        table = ((slab - sl0) * p.slab_bytes
                 + ((tz * Hh + ty) * Wh + tx) * 16)
        for mt in range(p.m_tiles):
            b0, z0, y0, x0 = pos[mt, 0]
            halo = np.zeros((sl1 - sl0 + 1) * p.slab_bytes, dtype=np.int64)
            for k, sl in enumerate(range(sl0, sl1 + 1)):
                bb, zz, yy, xx = np.meshgrid(
                    b0 + np.arange(p.bt), z0 - p.pz + np.arange(Dh),
                    y0 - p.py + np.arange(Hh), x0 - p.px + np.arange(Wh),
                    indexing="ij")
                ok = ((bb < B) & (zz >= 0) & (zz < D) & (yy >= 0)
                      & (yy < H) & (xx >= 0) & (xx < W))
                vals = np.zeros(bb.shape + (16,), dtype=np.int64)
                vals[ok] = xl[bb[ok], zz[ok], yy[ok], xx[ok],
                              16 * sl:16 * sl + 16]
                halo[k * p.slab_bytes:k * p.slab_bytes + box] = vals.ravel()
            acc = np.zeros((p.n_tiles, rowbase.size, p.bn), dtype=np.int64)
            for i, t in enumerate(range(s0, s1)):
                for h in range(2):
                    rows = (rowbase[:, None] + table[2 * i + h]
                            + np.arange(16))
                    acc += halo[rows] @ wpack[:, t, h].transpose(0, 2, 1)
            for r in range(rowbase.size):
                b, z, y, xq = pos[mt, r]
                if b < B and z < p.Do and y < p.Ho and xq < p.Wo:
                    out[b, :, z, y, xq] += acc[:, r].reshape(-1)
    return torch.from_numpy(out[:, :p.N].astype(np.int32))


@pytest.mark.parametrize("name", [n for n, xs, ws, a in _cases()
                                  if n != "c3_strided_dilated"])
def test_the_kernels_indexing_emulated_is_the_plain_version(name):
    xs, ws, args = next((x, w, a) for n, x, w, a in _cases() if n == name)
    p = int8_conv.plan(xs, ws, *args)
    g = torch.Generator().manual_seed(7)
    x = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8)
    assert torch.equal(_emulate(x, w, p),
                       int8_conv.conv3d_int8_plain(x, w, *args))


def test_packed_weights_layout():
    g = torch.Generator().manual_seed(1)
    w = torch.randint(-127, 128, (40, 20, 1, 3, 3), generator=g,
                      dtype=torch.int8)
    p = int8_conv.plan((1, 20, 4, 8, 8), w.shape, 1, (0, 1, 1))
    assert (p.cp, p.taps, p.substeps, p.steps) == (32, 9, 18, 9)
    raw = int8_conv.pack_weights_plain(w, p)
    assert raw.numel() == p.n_tiles * p.packed_steps * 2 * p.bn * 16
    packed = _logical(p, raw)
    # chunk (s, h) of channel n lies at 16-byte chunk (2 (s % 4) + h) ^ (n
    # % 8) of the channel's 128-byte row of its group of 4 steps
    rows = raw.reshape(p.n_tiles, -1, p.bn, 8, 16)
    assert torch.equal(rows[0, 1, 5, (2 * 2 + 1) ^ 5], packed[0, 6, 1, 5])
    for nt, s, h, n, j in [(0, 0, 0, 0, 0), (0, 4, 1, 39, 3),
                           (0, 8, 1, 7, 15), (0, 5, 0, 12, 4)]:
        u = 2 * s + h
        slab, tap = divmod(u, p.taps)
        c, nn = 16 * slab + j, nt * p.bn + n
        want = w[nn, c, 0, tap // 3, tap % 3] if c < 20 and nn < 40 else 0
        assert packed[nt, s, h, n, j] == want
    assert packed[:, :, :, 40:].eq(0).all()  # past N
    by_u = packed.reshape(p.n_tiles, 2 * p.packed_steps, p.bn, 16)
    assert by_u[:, 9:, :, 4:].eq(0).all()  # slab 1 past C


def test_channels_last_padded_is_the_kernels_layout():
    q = torch.randint(-127, 128, (2, 28, 3, 5, 6)).float()
    v = int8_conv.channels_last_padded(q)
    assert v.shape == q.shape and v.dtype == torch.int8
    assert torch.equal(v, q.to(torch.int8))
    assert v.stride() == (3 * 5 * 6 * 32, 1, 5 * 6 * 32, 6 * 32, 32)
    assert int8_conv._pitch(v, 32, 16) == 32
    assert int8_conv._pitch(q.to(torch.int8), 32, 16) is None
    cl = q.to(torch.int8, memory_format=torch.channels_last_3d)
    assert int8_conv._pitch(cl, 28, 4) == 28 and \
        int8_conv._pitch(cl, 32, 16) is None
    # a [M, K] operand's rows, as matmul_int8 hands them over
    a = torch.zeros((10, 48), dtype=torch.int8)
    assert int8_conv._pitch(a.t()[None, :, None, None, :], 48, 16) == 48


@pytest.mark.parametrize("variant", ["parity", "tpu_mxu"])
def test_padded_int8_image_keeps_the_real_leg_bitwise(monkeypatch, variant):
    """The real forward with the padded int8 image equals the one with
    the unpadded channels-last copy the quantize pass wrote before."""
    engine = engines.create_engine("pytorch", model_variant=variant)
    batch = torch.rand((2, 1, 4, 32, 32),
                       generator=torch.Generator().manual_seed(2))
    monkeypatch.setenv("CHUNKFLOW_INT8", "real")

    def run():
        with torch.no_grad():
            return precision.wrap_apply(engine.apply, "int8", engine.params,
                                        engine.call)(batch)

    padded = run()
    monkeypatch.setattr(precision, "_int8", lambda q: q.to(
        torch.int8, memory_format=torch.channels_last_3d)
        if q.dim() == 5 else q.to(torch.int8))
    assert torch.equal(padded, run())
