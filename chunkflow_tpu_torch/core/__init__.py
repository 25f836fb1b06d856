"""Geometry: zyx triples and bounding boxes."""
