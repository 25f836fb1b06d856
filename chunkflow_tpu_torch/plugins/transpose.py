"""Reverse the spatial axes, zyx -> xyz (the JAX package's
``plugins/transpose.py``)."""


def execute(chunk):
    return chunk.transpose()
