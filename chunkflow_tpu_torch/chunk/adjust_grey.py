"""Grey-value adjustment library: a copy of ``chunkflow_tpu/chunk/adjust_grey.py``.

clip_percentile, window_level, rescale, normalize (meanstd / fill),
adjust_gamma, grey_augment and normalize_shang, vectorized numpy on the
host (the JAX package computes them on the host too). Host-side
grey-level statistics (histogram CDFs, mean/std) accumulate in float64
on purpose.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "clip_percentile",
    "window_level",
    "rescale",
    "get_voxels_for_stats",
    "normalize",
    "adjust_gamma",
    "grey_augment",
    "normalize_shang",
]


def clip_percentile(
    img: np.ndarray,
    percentile_low: float = 0.01,
    percentile_high: float = 0.01,
) -> np.ndarray:
    """Histogram-based percentile contrast stretch for uint8 images.

    Finds the lowest/highest bins holding the clip fractions of voxels
    (reference adjust_grey.py:12-33) and linearly stretches the remaining
    range back to [0, 255].
    """
    assert img.dtype == np.uint8
    hist = np.bincount(img.ravel(), minlength=256).astype(np.float64)
    total = img.size
    cdf = np.cumsum(hist)
    # first bin where the cumulative count reaches the low fraction; the
    # reference's while-loop post-increments, landing one past the bin that
    # crossed the threshold
    lower_bound = int(np.searchsorted(cdf, percentile_low * total)) + 1
    rcdf = np.cumsum(hist[::-1])
    upper_bound = 254 - int(np.searchsorted(rcdf, percentile_high * total))
    alpha = 255.0 / max(upper_bound - lower_bound, 1)
    beta = -lower_bound * alpha
    return np.clip(img * alpha + beta, 0, 255).astype(np.uint8)


def window_level(img: np.ndarray, half_window: float, level: float) -> np.ndarray:
    """Map level -> 0 and level +/- half_window -> +/-1, in place."""
    if half_window <= 0:
        raise ValueError("half_window must be positive")
    img -= level
    img *= 1.0 / half_window
    return img


def rescale(img: np.ndarray, old_range, new_range=(-1, 1)) -> np.ndarray:
    """Linearly remap values in old_range to new_range, in place."""
    if np.array_equal(old_range, new_range):
        return img
    img -= old_range[0]
    img *= (new_range[1] - new_range[0]) / (old_range[1] - old_range[0])
    img += new_range[0]
    return img


def get_voxels_for_stats(
    img: np.ndarray, min_max_invalid: Sequence[bool] = (True, True)
) -> np.ndarray:
    """Voxels used for statistics, excluding the (possibly padded/invalid)
    extreme values when requested (reference adjust_grey.py:63-85)."""
    min_invalid, max_invalid = min_max_invalid
    mask = None
    if min_invalid:
        mask = img != np.min(img)
    if max_invalid:
        m = img != np.max(img)
        mask = m if mask is None else np.logical_and(mask, m)
    return img if mask is None else img[mask]


def normalize(
    img: np.ndarray,
    method,
    target_scale=(-1, 1),
    min_max_invalid: Sequence[bool] = (True, True),
    do_clipping: bool = False,
    make_copy: bool = True,
) -> np.ndarray:
    """Float normalization: 'meanstd' (z-score) or 'fill' (min/max rescale),
    statistics drawn from valid voxels only."""
    if img.size == 0:
        return np.copy(img) if make_copy else img
    stat_img = get_voxels_for_stats(img, min_max_invalid=min_max_invalid)
    if stat_img.size == 0:
        # blank / near-constant input (e.g. a padded all-255 section): the
        # invalid-extreme filter removed everything. Fall back to all
        # voxels so clipping still enforces the output contract; the
        # degenerate-range guards below skip the actual rescale/z-score.
        stat_img = img
    if make_copy:
        img = np.copy(img)

    if method in (1, "meanstd"):
        sd = np.std(stat_img)
        if sd > 0:
            img -= np.mean(stat_img)
            img /= sd
        if do_clipping:
            np.clip(img, -2, 2, img)
    elif method in (2, "fill"):
        mi = np.min(stat_img)
        ma = np.max(stat_img)
        if ma > mi:
            img = rescale(img, (mi, ma), new_range=target_scale)
        if do_clipping:
            np.clip(img, *target_scale, img)
    else:
        raise ValueError(f"unknown normalization method: {method}")
    return img


def adjust_gamma(img: np.ndarray, gamma: float, auto_rescale: bool = False) -> np.ndarray:
    """Gamma adjustment on [0, 1] float images, in place."""
    if auto_rescale:
        mi, ma = np.min(img), np.max(img)
        if mi != ma:
            img -= mi
            img /= ma - mi
    np.clip(img, 0, 1, img)
    img **= gamma
    return img


def grey_augment(
    img: np.ndarray,
    max_level_change: float = 0.15,
    max_window_change: float = 0.15,
    max_log2gamma_change: float = 1.0,
    level_prob: float = 1.0,
    window_prob: float = 0.8,
    gamma_prob: float = 0.3,
    value_range=(-1, 1),
    make_copy: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random window/level + gamma augmentation (training-time intensity
    augmentation, reference adjust_grey.py:154-207)."""
    if rng is None:
        rng = np.random.default_rng()
    if make_copy:
        img = np.copy(img)

    change_level = rng.random() < level_prob
    change_window = rng.random() < window_prob
    change_gamma = rng.random() < gamma_prob

    level = (value_range[0] + value_range[1]) / 2
    half_window = (value_range[1] - value_range[0]) / 2
    log2gamma = 0.0
    if change_level:
        level += 2 * (rng.random() - 0.5) * max_level_change
    if change_window:
        half_window += 2 * (rng.random() - 0.5) * max_window_change / 2
    if change_gamma:
        log2gamma += 2 * (rng.random() - 0.5) * max_log2gamma_change

    if change_level or change_window or change_gamma:
        target_range = (0, 1) if change_gamma else value_range
        img = rescale(
            img, (level - half_window, level + half_window), target_range
        )
        np.clip(img, *target_range, img)
        if change_gamma:
            img = adjust_gamma(img, 2.0 ** log2gamma)
            img = rescale(img, (0, 1), value_range)
    return img


def normalize_shang(
    image: np.ndarray,
    nominalmin: Optional[float],
    nominalmax: Optional[float],
    clipvalues: bool,
) -> np.ndarray:
    """Shang's slice-wise min/max normalization to a nominal range
    (reference adjust_grey.py:209-255): per z-section 'fill' rescale with
    invalid-extreme exclusion; returns float32."""
    original_dtype = image.dtype
    arr = np.asarray(image).astype(np.float32)

    nbits = np.dtype(original_dtype).itemsize * 8
    if nominalmin is None:
        nominalmin = 0.0
    if nominalmax is None:
        nominalmax = float(2 ** nbits - 1)
    assert nominalmin < nominalmax

    for zz in range(arr.shape[0]):
        normalize(
            arr[zz, :, :],
            "fill",
            target_scale=(nominalmin, nominalmax),
            min_max_invalid=(True, True),
            do_clipping=clipvalues,
            make_copy=False,
        )
    return arr
