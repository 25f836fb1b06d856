"""Segmentation: what the chunk operators need of the segmentation plane."""
