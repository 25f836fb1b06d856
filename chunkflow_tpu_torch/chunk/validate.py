"""Black-box corruption detector: a copy of ``chunkflow_tpu/chunk/validate.py``.

Detects 3D "black boxes" (zeroed cuboids from failed reads) by matching
6 axis-aligned step-edge templates (7x7x2 and rotations, one half true)
against the binarized image; >=5 orientations each matching >=100
positions at NCC > 0.9 means a box with visible faces on both sides in
every axis: the chunk is invalid. The normalized cross-correlation is
three FFT convolutions (scipy.signal) on the host, accumulated in float64
on purpose (the FFT sums cancel catastrophically in float32).
"""
from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve

SCORE_THRESHOLD = 0.9
NUM_THRESHOLD = 100


def match_template_ncc(img: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Normalized cross-correlation of a small template over ``img``
    ('valid' positions only), matching skimage.feature.match_template."""
    img = np.ascontiguousarray(img, dtype=np.float64)
    template = np.ascontiguousarray(template, dtype=np.float64)
    n = template.size
    t_mean = template.mean()
    t_ssd = ((template - t_mean) ** 2).sum()

    flipped = template[::-1, ::-1, ::-1]
    cross = fftconvolve(img, flipped, mode="valid")
    ones = np.ones_like(template)
    s1 = fftconvolve(img, ones, mode="valid")
    s2 = fftconvolve(img ** 2, ones, mode="valid")

    numerator = cross - s1 * t_mean
    img_var = np.maximum(s2 - s1 ** 2 / n, 0.0)
    denominator = np.sqrt(img_var * t_ssd)
    out = np.zeros_like(numerator)
    np.divide(numerator, denominator, out=out, where=denominator > 1e-12)
    return out


def _step_templates():
    for axis in range(3):
        for side in range(2):
            shape = [7, 7, 7]
            shape[axis] = 2
            template = np.zeros(shape, dtype=bool)
            index = [slice(None)] * 3
            index[axis] = side
            template[tuple(index)] = True
            yield template


def validate_by_template_matching(img: np.ndarray) -> bool:
    """True if the chunk looks valid, False if a black box is detected."""
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    if np.issubdtype(img.dtype, np.floating):
        # float images lack the exact-zero box signature; skip validation
        return True
    binary = img.astype(bool)
    if binary.shape < (2, 7, 7):
        return True

    evidence = 0
    for template in _step_templates():
        if any(s < t for s, t in zip(binary.shape, template.shape)):
            continue
        score = match_template_ncc(binary, template)
        if np.count_nonzero(score > SCORE_THRESHOLD) > NUM_THRESHOLD:
            evidence += 1
    return evidence <= 4
