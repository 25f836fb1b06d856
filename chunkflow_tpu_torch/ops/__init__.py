"""Chunk operators and the CUDA kernels' wrappers."""
