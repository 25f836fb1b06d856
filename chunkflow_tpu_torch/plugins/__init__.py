"""The bundled plugins of the ``plugin`` command (``flow/plugin.py``):
the port's copies of the JAX package's ``chunkflow_tpu/plugins/`` whose
imports the port can satisfy."""
