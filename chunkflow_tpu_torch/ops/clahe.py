"""Contrast-limited adaptive histogram equalization (CLAHE) of uint8
sections: the port's counterpart of the JAX ``clahe`` plugin's
``cv2.createCLAHE(clipLimit, tileGridSize=(t, t)).apply`` per z section.

:func:`clahe` runs the host C++ (``csrc/host/clahe.cpp``, sections on
threads); :func:`clahe_plain` is the same arithmetic in numpy, which the
tests and ``chip_smoke.py`` hold it against bitwise. Both follow
OpenCV's algorithm step for step, so both equal cv2 bit for bit:

1. A section whose height or width is not a multiple of the grid ``t``
   is padded for the histograms only, reflect-101, at the bottom by
   ``t - h % t`` and at the right by ``t - w % t`` (so a side that
   divides still gets ``t``, as OpenCV pads).
2. Each of the ``t x t`` tiles gets a 256-bin histogram. With
   ``clip_limit > 0`` each bin is capped at
   ``max(int(clip_limit * area / 256), 1)``; the excess goes back
   ``excess // 256`` to every bin and the residual one count each at bins
   ``0, s, 2s, ...`` (``s = max(256 // residual, 1)``).
3. The tile's lookup table is ``round(float32(cdf) * float32(255 /
   area))``, saturated to uint8, ties to even.
4. Each pixel of the section (not of the padding) mixes the tables of its
   four nearest tiles bilinearly, in float32 and without fused
   multiply-adds, and rounds to uint8 the same way.
"""
from __future__ import annotations

import numpy as np

BINS = 256


def _check(sections: np.ndarray, tile_size: int) -> np.ndarray:
    sections = np.asarray(sections)
    if sections.dtype != np.uint8 or sections.ndim != 3:
        raise ValueError(f"CLAHE takes uint8 sections [z, y, x], not "
                         f"{sections.dtype} {sections.shape}")
    if int(tile_size) < 1:
        raise ValueError(f"tile_size must be at least 1, got {tile_size}")
    return np.ascontiguousarray(sections)


def clahe(sections: np.ndarray, clip_limit: float = 2.0,
          tile_size: int = 8) -> np.ndarray:
    """CLAHE of each z section of a uint8 ``[z, y, x]`` array (host
    C++)."""
    from chunkflow_tpu_torch import native

    sections = _check(sections, tile_size)
    return native.clahe(sections, float(clip_limit), int(tile_size))


def reflect_101(n: int, pad: int) -> np.ndarray:
    """The source index of each of ``n + pad`` positions, the last
    ``pad`` reflected without repeating the edge (OpenCV's
    ``borderInterpolate`` with ``BORDER_REFLECT_101``)."""
    out = np.arange(n + pad)
    if n == 1:
        return np.zeros_like(out)
    for i in range(n, n + pad):
        p = i
        while not 0 <= p < n:
            p = -p if p < 0 else 2 * n - 2 - p
        out[i] = p
    return out


def _luts(padded: np.ndarray, t: int, clip_limit: float) -> np.ndarray:
    """The ``[t, t, 256]`` uint8 lookup tables of one padded section."""
    th, tw = padded.shape[0] // t, padded.shape[1] // t
    area = th * tw
    tiles = padded.reshape(t, th, t, tw).transpose(0, 2, 1, 3).reshape(
        t * t, area)
    index = tiles.astype(np.int64) + (np.arange(t * t) * BINS)[:, None]
    hist = np.bincount(index.ravel(), minlength=t * t * BINS).reshape(
        t * t, BINS)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / BINS), 1)
        excess = np.maximum(hist - limit, 0).sum(axis=1)
        hist = np.minimum(hist, limit) + (excess // BINS)[:, None]
        residual = (excess % BINS)[:, None]
        step = np.maximum(BINS // np.maximum(residual, 1), 1)
        bins = np.arange(BINS)[None, :]
        hist = hist + ((residual > 0) & (bins % step == 0)
                       & (bins // step < residual))
    scale = np.float32(BINS - 1) / np.float32(area)
    lut = np.rint(np.cumsum(hist, axis=1).astype(np.float32) * scale)
    return np.clip(lut, 0, 255).astype(np.uint8).reshape(t, t, BINS)


def _weights(n: int, tile: int, t: int):
    """(first tile, second tile, weight of the first, weight of the
    second) of each of ``n`` pixels along one axis, in float32."""
    f = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(tile)) \
        - np.float32(0.5)
    first = np.floor(f).astype(np.int64)
    a = f - first.astype(np.float32)
    return (np.maximum(first, 0), np.minimum(first + 1, t - 1),
            np.float32(1.0) - a, a)


def clahe_section_plain(section: np.ndarray, clip_limit: float,
                        t: int) -> np.ndarray:
    """CLAHE of one uint8 section ``[y, x]`` in numpy."""
    h, w = section.shape
    if h % t or w % t:
        rows = reflect_101(h, t - h % t)
        cols = reflect_101(w, t - w % t)
        padded = section[rows][:, cols]
    else:
        padded = section
    lut = _luts(padded, t, clip_limit).astype(np.float32)
    y1, y2, ya1, ya = _weights(h, padded.shape[0] // t, t)
    x1, x2, xa1, xa = _weights(w, padded.shape[1] // t, t)
    v = section.astype(np.int64)
    y1, y2, ya1, ya = y1[:, None], y2[:, None], ya1[:, None], ya[:, None]
    res = ((lut[y1, x1, v] * xa1 + lut[y1, x2, v] * xa) * ya1
           + (lut[y2, x1, v] * xa1 + lut[y2, x2, v] * xa) * ya)
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def clahe_plain(sections: np.ndarray, clip_limit: float = 2.0,
                tile_size: int = 8) -> np.ndarray:
    """:func:`clahe` in numpy, section by section."""
    sections = _check(sections, tile_size)
    out = np.empty_like(sections)
    for z, section in enumerate(sections):
        out[z] = clahe_section_plain(section, float(clip_limit),
                                     int(tile_size))
    return out
