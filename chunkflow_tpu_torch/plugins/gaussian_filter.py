"""Per-section 2D gaussian blur (the JAX package's
``plugins/gaussian_filter.py``)."""


def execute(chunk, sigma: float = 1.0):
    return chunk.gaussian_filter_2d(sigma=sigma)
