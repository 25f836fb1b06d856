"""int8 x int8 -> int32 convolution: the integer op of the real int8 leg.

The JAX package's ``CHUNKFLOW_INT8=real`` leg runs every activation-touched
convolution as one XLA op with int8 operands and int32 sums
(``chunkflow_tpu/inference/precision.py:294-298``). No PyTorch call on the
card does that in 3D (cuDNN takes no int8 3D convolution,
``torch.ops.quantized.conv3d`` is a CPU op that requantizes, and
``torch._int_mm`` would need the im2col materialised), so
:func:`conv3d_int8` launches a hand-written kernel for CUDA operands and
runs the plain PyTorch version :func:`conv3d_int8_plain` for CPU operands
— dispatch by device only, no fallback. Both give the exact integer sums:
the plain version convolves in float64 on the integer grid (exact below
2^53; the largest sum here is 127 * 127 * 6912 < 2^27) and casts to
int32.

Two kernels, chosen by :func:`plan` from the shape alone:

- ``"hopper"`` (``csrc/conv3d_int8.cu``): stride 1, dilation 1, every
  layer the families run. TMA halo tiles, ``wgmma`` s8, split-K for the
  layers with few output tiles; its input is channels-last with the
  position pitch a multiple of 16 (:func:`channels_last_padded`, which
  the quantize pass writes), its weights packed per launch by a small
  kernel (:func:`pack_weights_plain` is its plain version).
- ``"generic"`` (``csrc/conv3d_int8_generic.cu``): any stride and
  dilation, on ``mma.sync``.

:func:`matmul_int8` is the integer matrix product of the GEMM upsample
(``MxuConvTranspose``) and of ``F.linear`` under the real leg: on the
card it is the same kernel as a 1x1x1 convolution of one batch row.

The quantize pass before these and the dequant after them stay torch ops
(``inference/precision.py``), as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from chunkflow_tpu_torch import _build

# kernel launches since the last reset (chip_smoke.py reads it to show
# the main path went through the kernel), and the same split by path
launches = 0
path_launches: Dict[str, int] = {"hopper": 0, "generic": 0}

IntOr3 = Union[int, Sequence[int]]

# the H100's SMs and the shared memory of one SM and of one block (bytes)
SMS = 132
SM_SMEM = 233472
BLOCK_SMEM = 232448
# output positions per tile (two warpgroups of 64 rows); the wgmma widths
# a tile of output channels takes; the channels one K sub-step reads
TILE_ROWS = 128
WIDTHS = (8, 16, 32, 64, 128, 256)
SLAB = 16
# the epilogue stages 32 channels of 64 rows per warpgroup, 68 words apart
STAGE_COLS, STAGE_PITCH = 32, 68
# the weights of GROUP K steps form one 128-byte-swizzled row per output
# channel (wgmma's B layout); streamed weights: about 16 KB a chunk (whole
# groups), 2-4 chunks in the ring; a split of K keeps at least 8 steps
GROUP = 4
CHUNK_BYTES = 16384
MAX_STAGES = 4
MAX_HALO_BUFFERS = 2
MIN_SPLIT_STEPS = 8
# the launcher's Plan struct, field for field
PLAN_FIELDS = (
    "B", "D", "H", "W", "pitch", "cp", "N", "kz", "ky", "kx", "Do", "Ho",
    "Wo", "pz", "py", "px", "bn", "n_tiles", "bt", "dt", "ht", "wt",
    "m_tiles", "splits", "sps", "steps", "kc", "stages", "resident", "gx",
    "sbo", "halo_buffers", "slab_bytes", "halo_bytes", "stage_bytes",
    "staging_bytes", "table_bytes", "smem")


def _triple(v: IntOr3, name: str) -> Tuple[int, int, int]:
    t = (int(v),) * 3 if isinstance(v, int) else tuple(int(e) for e in v)
    if len(t) != 3:
        raise ValueError(f"{name} must be an int or 3 ints, got {v!r}")
    return t


def output_shape(x_shape, w_shape, stride: IntOr3 = 1, padding: IntOr3 = 0,
                 dilation: IntOr3 = 1) -> Tuple[int, ...]:
    """``[B, N, Do, Ho, Wo]`` of the convolution of ``x_shape`` ``[B, C,
    D, H, W]`` by ``w_shape`` ``[N, C, kz, ky, kx]`` (``F.conv3d``'s)."""
    st, pd, dl = (_triple(stride, "stride"), _triple(padding, "padding"),
                  _triple(dilation, "dilation"))
    spatial = tuple((n + 2 * p - d * (k - 1) - 1) // s + 1
                    for n, k, s, p, d in zip(x_shape[2:], w_shape[2:], st,
                                             pd, dl))
    return (x_shape[0], w_shape[0]) + spatial


def _check(x: torch.Tensor, w: torch.Tensor, stride, padding, dilation):
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if t.dim() != 5:
            raise ValueError(f"{name} must be 5-D, got {tuple(t.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, w takes "
                         f"{w.shape[1]}")
    shape = output_shape(x.shape, w.shape, stride, padding, dilation)
    if min(shape) < 1:
        raise ValueError(f"empty output {shape} for x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}")
    if min(_triple(stride, "stride") + _triple(dilation, "dilation")) < 1 \
            or min(_triple(padding, "padding")) < 0:
        raise ValueError("stride and dilation must be >= 1, padding >= 0")
    return shape


def conv3d_int8_plain(x: torch.Tensor, w: torch.Tensor, stride: IntOr3 = 1,
                      padding: IntOr3 = 0, dilation: IntOr3 = 1
                      ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on whatever device the
    operands lie: ``F.conv3d`` in float64 on the integer grid, cast to
    int32."""
    _check(x, w, stride, padding, dilation)
    return F.conv3d(x.double(), w.double(), None, stride, padding,
                    dilation).to(torch.int32)


# ---------------------------------------------------------------------------
# the plan: the path and the Hopper kernel's tiling, from the shape alone
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Plan:
    """How :func:`conv3d_int8` runs one shape. ``path`` is ``"hopper"``
    or ``"generic"``; the other fields (``PLAN_FIELDS``) are the Hopper
    kernel's: ``cp`` the channels padded to a slab, ``bn`` x ``n_tiles``
    the output channels, ``bt`` x ``dt`` x ``ht`` x ``wt`` the output
    tile, ``splits`` ranges of ``sps`` of the ``steps`` K steps, weights
    ``resident`` or streamed ``kc`` steps a chunk through ``stages``,
    ``gx`` persistent blocks per (N tile, split), ``sbo`` the bytes
    between a warpgroup's 8-row groups of A in the halo, ``halo_buffers``
    (2: the next tile's halo loads during this one's products), and the
    shared memory layout in bytes. ``pitch`` is 0 until the input is known."""

    path: str
    B: int = 0
    D: int = 0
    H: int = 0
    W: int = 0
    pitch: int = 0
    cp: int = 0
    N: int = 0
    kz: int = 0
    ky: int = 0
    kx: int = 0
    Do: int = 0
    Ho: int = 0
    Wo: int = 0
    pz: int = 0
    py: int = 0
    px: int = 0
    bn: int = 0
    n_tiles: int = 0
    bt: int = 0
    dt: int = 0
    ht: int = 0
    wt: int = 0
    m_tiles: int = 0
    splits: int = 0
    sps: int = 0
    steps: int = 0
    kc: int = 0
    stages: int = 0
    resident: int = 0
    gx: int = 0
    sbo: int = 0
    halo_buffers: int = 0
    slab_bytes: int = 0
    halo_bytes: int = 0
    stage_bytes: int = 0
    staging_bytes: int = 0
    table_bytes: int = 0
    smem: int = 0

    @property
    def taps(self) -> int:
        return self.kz * self.ky * self.kx

    @property
    def packed_steps(self) -> int:
        """The K steps the packed weights hold: whole swizzle groups."""
        return _round(self.steps, GROUP)

    @property
    def substeps(self) -> int:
        """U: the (slab, tap) pairs, slab-major."""
        return self.cp // SLAB * self.taps

    def split_ranges(self) -> List[Tuple[int, int]]:
        """The K steps ``[s0, s1)`` of each split, in blockIdx.z order."""
        return [(s, min(self.steps, s + self.sps))
                for s in range(0, self.steps, self.sps)]

    def split_slabs(self, s0: int, s1: int) -> Tuple[int, int]:
        """The first and last slab a split's halo holds."""
        return (2 * s0 // self.taps,
                (min(2 * s1, self.substeps) - 1) // self.taps)

    def fields(self) -> Tuple[int, ...]:
        return tuple(getattr(self, f) for f in PLAN_FIELDS)


def channel_pitch(channels: int) -> int:
    """The channels the Hopper kernel reads per position: ``channels``
    rounded up to a 16-byte slab (a TMA stride must be a multiple of 16
    bytes, and a K sub-step reads one slab)."""
    return -(-channels // SLAB) * SLAB


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round(n: int, unit: int) -> int:
    return _cdiv(n, unit) * unit


def _n_tiling(n: int) -> Tuple[int, int]:
    """``(bn, n_tiles)``: the wgmma width and count covering ``n`` output
    channels with the least padding, a tile costing 32 channels more."""
    return min(((w, _cdiv(n, w)) for w in WIDTHS),
               key=lambda t: (t[0] * t[1] + 32 * (t[1] - 1), t[1]))


def plan(x_shape, w_shape, stride: IntOr3 = 1, padding: IntOr3 = 0,
         dilation: IntOr3 = 1) -> Plan:
    """The path and tiling of the convolution of ``x_shape`` ``[B, C, D,
    H, W]`` by ``w_shape`` ``[N, C, kz, ky, kx]``: a function of the
    shapes and arguments alone (no device, no environment). Stride-1,
    dilation-1 convolutions whose halo fits a block take the Hopper
    kernel; the rest the generic kernel."""
    st, pd, dl = (_triple(stride, "stride"), _triple(padding, "padding"),
                  _triple(dilation, "dilation"))
    B, C, D, H, W = (int(v) for v in x_shape)
    N, _, kz, ky, kx = (int(v) for v in w_shape)
    _, _, Do, Ho, Wo = output_shape(x_shape, w_shape, st, pd, dl)
    if st != (1, 1, 1) or dl != (1, 1, 1):
        return Plan("generic")
    cp = channel_pitch(C)
    taps = kz * ky * kx
    steps = _cdiv(cp // SLAB * taps, 2)
    bn, n_tiles = _n_tiling(N)
    # A warpgroup's 64 rows are 8 groups of 8 positions along W, a uniform
    # stride apart in the halo (wgmma's A layout): a run of 64 x (groups 8
    # positions apart; two warpgroups on two rows, or on one run of 128
    # when there is one row), or an 8 x 8 block of x by y (groups a halo
    # row apart) where the output is narrower than 64
    if Wo >= 64:
        wt = 128 if Wo >= 128 and Ho == 1 else 64
        ht = min(TILE_ROWS // wt, _pow2ceil(Ho))
        sbo = 8 * SLAB
    else:
        wt = 8
        ht = 16 if Ho > 8 else 8
        sbo = (wt + kx - 1) * SLAB
    dt = min(TILE_ROWS // (wt * ht), _pow2ceil(Do))
    bt = TILE_ROWS // (wt * ht * dt)
    halo = (bt, dt + kz - 1, ht + ky - 1, wt + kx - 1)
    if max(halo) > 256:  # a TMA box dimension
        return Plan("generic")
    slab_bytes = _round(SLAB * halo[0] * halo[1] * halo[2] * halo[3], 128)
    m_tiles = (_cdiv(B, bt) * _cdiv(Do, dt) * _cdiv(Ho, ht)
               * _cdiv(Wo, wt))
    base = Plan("hopper", B=B, D=D, H=H, W=W, cp=cp, N=N, kz=kz, ky=ky,
                kx=kx, Do=Do, Ho=Ho, Wo=Wo, pz=pd[0], py=pd[1], px=pd[2],
                bn=bn, n_tiles=n_tiles, bt=bt, dt=dt, ht=ht, wt=wt,
                m_tiles=m_tiles, steps=steps, sbo=sbo, slab_bytes=slab_bytes,
                staging_bytes=2 * min(bn, STAGE_COLS) * STAGE_PITCH * 4)
    # split K while the M x N tiles leave SMs idle
    splits = 1
    if m_tiles * n_tiles < SMS:
        splits = max(1, min(_cdiv(SMS, m_tiles * n_tiles),
                            steps // MIN_SPLIT_STEPS))
    occupancy = 2 if bn <= 64 else 1
    while True:
        sps = _round(_cdiv(steps, splits), GROUP)
        fitted = _fit(dataclasses.replace(base, sps=sps,
                                          splits=_cdiv(steps, sps)),
                      occupancy)
        if fitted is not None:
            return fitted
        if sps == GROUP:
            return Plan("generic")
        splits = _cdiv(steps, sps // 2)


def _fit(p: Plan, occupancy: int):
    """``p`` with its halo buffers, weight ring and shared memory laid
    out, at ``occupancy`` blocks per SM or one; None if no layout fits.
    Preferred in order: two halo buffers, then one; resident weights,
    then streamed."""
    slabs = max(b - a + 1 for a, b in (p.split_slabs(s0, s1)
                                       for s0, s1 in p.split_ranges()))
    halo_bytes = slabs * p.slab_bytes
    table_bytes = _round(2 * p.sps * 4, 16)
    kc = max(GROUP, min(p.sps, CHUNK_BYTES // (p.bn * 32)) // GROUP * GROUP)
    weights = [(1, p.sps, 1, p.sps * p.bn * 32),  # resident
               (0, kc, min(MAX_STAGES, max(2, _cdiv(p.sps, kc))),
                kc * p.bn * 32)]
    for occ in sorted({occupancy, 1}, reverse=True):
        budget = min(BLOCK_SMEM, SM_SMEM // occ - 1024)
        for buffers in (2, 1):
            for resident, kc, stages, stage_bytes in weights:
                smem = (buffers * halo_bytes + stages * stage_bytes
                        + p.staging_bytes + table_bytes
                        + (2 * MAX_HALO_BUFFERS + 2 * stages) * 8)
                if smem > budget:
                    continue
                per_sm = min(occ, SM_SMEM // (smem + 1024))
                gx = min(p.m_tiles, max(1, _cdiv(per_sm * SMS,
                                                  p.n_tiles * p.splits)))
                return dataclasses.replace(
                    p, kc=kc, stages=stages, resident=resident, gx=gx,
                    halo_buffers=buffers, halo_bytes=halo_bytes,
                    stage_bytes=stage_bytes, table_bytes=table_bytes,
                    smem=smem)
    return None


def pack_weights_plain(w: torch.Tensor, p: Plan) -> torch.Tensor:
    """The plain version of the pack kernel: ``w`` ``[N, C, kz, ky, kx]``
    as the Hopper kernel's K steps read it, int8 ``[n_tiles,
    packed_steps / 4, bn, 128]`` flattened. Logically ``[nt, s, h, n,
    j]`` is ``w[nt * bn + n, 16 * slab + j, tap]`` of sub-step ``u = 2 s
    + h = slab * T + tap`` (zero past N, C or U); each output channel's
    4 steps are one 128-byte row whose 16-byte chunk ``c = 2 (s % 4) +
    h`` lies at ``c ^ (n % 8)`` (wgmma's 128-byte swizzle)."""
    N, C = w.shape[:2]
    taps = p.taps
    slabs = p.cp // SLAB
    steps = p.packed_steps
    wt = w.reshape(N, C, taps)
    wt = F.pad(wt, (0, 0, 0, p.cp - C, 0, p.n_tiles * p.bn - N))
    # [Np, slabs, 16, T] -> [Np, slabs, T, 16] -> [Np, U, 16]
    wt = wt.reshape(-1, slabs, SLAB, taps).transpose(2, 3)
    wt = wt.reshape(-1, slabs * taps, SLAB)
    wt = F.pad(wt, (0, 0, 0, 2 * steps - slabs * taps))
    # [nt, n, groups, 8 chunks, 16] -> [nt, groups, n, 8, 16], swizzled
    wt = wt.reshape(p.n_tiles, p.bn, steps // GROUP, 2 * GROUP, SLAB)
    wt = wt.permute(0, 2, 1, 3, 4)
    n = torch.arange(p.bn).reshape(-1, 1)
    chunk = torch.arange(2 * GROUP).reshape(1, -1) ^ (n % 8)
    wt = wt[:, :, n, chunk]
    return wt.contiguous().reshape(-1)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------
def channels_last_padded(t: torch.Tensor) -> torch.Tensor:
    """An int8 copy of the integer-valued ``[B, C, D, H, W]`` ``t``, laid
    out as the Hopper kernel reads it: channels-last with the position
    pitch :func:`channel_pitch` ``(C)``. Returned as the ``[B, C, D, H,
    W]`` view of that buffer; the pad channels are left unwritten (the
    kernel multiplies them by zero weights). One copy: the quantize pass
    writes its int8 image this way, so the wrapper pads nothing."""
    B, C, D, H, W = t.shape
    buf = torch.empty((B, D, H, W, channel_pitch(C)), dtype=torch.int8,
                      device=t.device)
    view = buf[..., :C].permute(0, 4, 1, 2, 3)
    view.copy_(t)
    return view


def _pitch(x: torch.Tensor, channels: int, unit: int):
    """The position pitch (elements) if ``x`` ``[B, C, D, H, W]`` lies
    channels-last with channels contiguous, a pitch that is a multiple of
    ``unit``, ``channels`` readable at every position and a ``unit``-byte
    aligned start; else None."""
    B, C, D, H, W = x.shape
    if C > 1 and x.stride(1) != 1:
        return None
    sizes = (B, D, H, W)
    dims = (0, 2, 3, 4)
    inner = [D * H * W, H * W, W, 1]
    pitch = next((x.stride(d) // n for d, s, n in
                  zip(reversed(dims), reversed(sizes), reversed(inner))
                  if s > 1), channels)
    if pitch % unit or pitch < channels or x.data_ptr() % unit:
        return None
    if any(s > 1 and x.stride(d) != pitch * n
           for d, s, n in zip(dims, sizes, inner)):
        return None
    end = x.storage_offset() + (B * D * H * W - 1) * pitch + channels
    if end > x.untyped_storage().nbytes():
        return None
    return pitch


def _channels_last(t: torch.Tensor, channels: int) -> torch.Tensor:
    """``[n, c, d, h, w]`` -> contiguous ``[n, d, h, w, channels]``, the
    channels zero-padded to ``channels``."""
    cl = t.permute(0, 2, 3, 4, 1)
    if channels != t.shape[1]:
        cl = F.pad(cl, (0, channels - t.shape[1]))
    return cl.contiguous()


def generic_weights(w: torch.Tensor) -> torch.Tensor:
    """The generic kernel's weights: ``[N, kz, ky, kx, C4]`` contiguous,
    the channels zero-padded to a multiple of 4 (its 4-byte loads)."""
    return _channels_last(w, -(-w.shape[1] // 4) * 4)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
_libs: Dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "conv3d_int8":
            lib.conv3d_int8_pack_launch.argtypes = (
                [p, p] + [i] * 5 + [q] * 5 + [i] * 4 + [p])
            lib.conv3d_int8_pack_launch.restype = i
            lib.conv3d_int8_launch.argtypes = [p, p, p, p, i, p]
            lib.conv3d_int8_launch.restype = i
        else:
            lib.conv3d_int8_generic_launch.argtypes = [p, p, p] + [i] * 22 \
                + [p]
            lib.conv3d_int8_generic_launch.restype = i
        getattr(lib, f"{name}_error_string").argtypes = [i]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _pack(w: torch.Tensor, p: Plan, stream) -> torch.Tensor:
    lib = _library("conv3d_int8")
    wpack = torch.empty(p.n_tiles * p.packed_steps * 2 * p.bn * SLAB,
                        dtype=torch.int8, device=w.device)
    N, C, kz, ky, kx = w.shape
    _build.check(lib, "conv3d_int8", lib.conv3d_int8_pack_launch(
        w.data_ptr(), wpack.data_ptr(), N, C, kz, ky, kx, *w.stride(),
        p.cp, p.packed_steps, p.bn, p.n_tiles, stream))
    return wpack


def pack_weights(w: torch.Tensor, p: Plan) -> torch.Tensor:
    """The Hopper kernel's packed weights of int8 ``w`` under plan
    ``p``: the pack kernel on the card (part of every :func:`conv3d_int8`
    launch, uncounted), :func:`pack_weights_plain` on the CPU."""
    if w.device.type == "cpu":
        return pack_weights_plain(w, p)
    with torch.cuda.device(w.device):
        return _pack(w, p, torch.cuda.current_stream().cuda_stream)


def hopper_kernel(x: torch.Tensor, wpack: torch.Tensor, p: Plan,
                  out: torch.Tensor) -> None:
    """The Hopper kernel alone: ``x`` in its layout (:func:`_pitch`),
    ``wpack`` from :func:`pack_weights`, into ``out`` (which a split of K
    adds to: zero it first). Uncounted and unchecked beyond the layout:
    :func:`conv3d_int8` runs it, and ``chip_smoke.py`` times it alone."""
    pitch = _pitch(x, p.cp, SLAB)
    if pitch is None:
        raise ValueError("x is not in the Hopper kernel's layout")
    lib = _library("conv3d_int8")
    fields = dataclasses.replace(p, pitch=pitch).fields()
    with torch.cuda.device(x.device):
        _build.check(lib, "conv3d_int8", lib.conv3d_int8_launch(
            x.data_ptr(), wpack.data_ptr(), out.data_ptr(),
            (ctypes.c_int * len(fields))(*fields), len(fields),
            torch.cuda.current_stream().cuda_stream))


def _hopper(x: torch.Tensor, w: torch.Tensor, p: Plan, shape, stream):
    if _pitch(x, p.cp, SLAB) is None:
        x = channels_last_padded(x)
    wpack = _pack(w, p, stream)
    # split-K adds its ranges into zeros
    out = (torch.zeros if p.splits > 1 else torch.empty)(
        shape, dtype=torch.int32, device=x.device)
    hopper_kernel(x, wpack, p, out)
    return out


def generic_kernel(x: torch.Tensor, wc: torch.Tensor, out: torch.Tensor,
                   stride: IntOr3 = 1, padding: IntOr3 = 0,
                   dilation: IntOr3 = 1) -> None:
    """The generic kernel alone: ``x`` channels-last with a pitch of a
    multiple of 4 channels, ``wc`` from :func:`generic_weights`, into
    ``out``. Uncounted: :func:`conv3d_int8` runs it, and ``chip_smoke.py``
    times it alone."""
    B, _, D, H, W = x.shape
    n, kz, ky, kx, C = wc.shape
    pitch = _pitch(x, C, 4)
    if pitch is None:
        raise ValueError("x is not in the generic kernel's layout")
    lib = _library("conv3d_int8_generic")
    with torch.cuda.device(x.device):
        _build.check(lib, "conv3d_int8_generic",
                     lib.conv3d_int8_generic_launch(
                         x.data_ptr(), wc.data_ptr(), out.data_ptr(), B, D,
                         H, W, C, pitch, n, kz, ky, kx, *out.shape[2:],
                         *_triple(stride, "stride"),
                         *_triple(padding, "padding"),
                         *_triple(dilation, "dilation"),
                         torch.cuda.current_stream().cuda_stream))


def _generic(x, w, shape, stride, padding, dilation):
    C = -(-x.shape[1] // 4) * 4
    if _pitch(x, C, 4) is None:
        x = _channels_last(x, C).permute(0, 4, 1, 2, 3)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    generic_kernel(x, generic_weights(w), out, stride, padding, dilation)
    return out


def conv3d_int8(x: torch.Tensor, w: torch.Tensor, stride: IntOr3 = 1,
                padding: IntOr3 = 0, dilation: IntOr3 = 1) -> torch.Tensor:
    """Exact int32 sums of the convolution of int8 ``x`` ``[B, C, D, H,
    W]`` by int8 ``w`` ``[N, C, kz, ky, kx]``: ``F.conv3d``'s arguments
    and output ``[B, N, Do, Ho, Wo]`` (symmetric zero padding, one
    group).

    CUDA operands launch the kernel :func:`plan` picks from the shape.
    The input is read where it lies when it is channels-last with a
    position pitch the kernel takes (what :func:`channels_last_padded`,
    and so the quantize pass, writes: a multiple of 16 channels for the
    Hopper kernel, of 4 for the generic one); any other layout is copied
    once into one. CPU operands run the plain version.
    """
    if x.device.type == "cpu":
        return conv3d_int8_plain(x, w, stride, padding, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_int8 runs on cuda or cpu, not {x.device}")
    shape = _check(x, w, stride, padding, dilation)
    p = plan(x.shape, w.shape, stride, padding, dilation)
    global launches
    with torch.cuda.device(x.device):
        if p.path == "hopper":
            out = _hopper(x, w, p, shape,
                          torch.cuda.current_stream().cuda_stream)
        else:
            out = _generic(x, w, shape, stride, padding, dilation)
        launches += 1
        path_launches[p.path] += 1
    return out


def conv3d_int8_generic(x: torch.Tensor, w: torch.Tensor,
                        stride: IntOr3 = 1, padding: IntOr3 = 0,
                        dilation: IntOr3 = 1) -> torch.Tensor:
    """The generic kernel on CUDA operands of any shape (uncounted):
    the yardstick ``chip_smoke.py`` times the Hopper kernel against."""
    shape = _check(x, w, stride, padding, dilation)
    with torch.cuda.device(x.device):
        return _generic(x, w, shape, stride, padding, dilation)


def matmul_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 ``a`` ``[M, K]`` and ``b`` ``[K,
    N]``: the kernel as a 1x1x1 convolution of ``M`` positions by ``N``
    filters (one launch) on the card, the plain version on the CPU."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_int8 takes [M, K] @ [K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    x = a.t()[None, :, None, None, :]   # [1, K, 1, 1, M]
    w = b.t()[:, :, None, None, None]   # [N, K, 1, 1, 1]
    y = conv3d_int8(x, w)               # [1, N, 1, 1, M]
    return y[0, :, 0, 0, :].t()
