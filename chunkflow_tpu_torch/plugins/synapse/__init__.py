"""The synapse-detection plugins (the counterparts of
``chunkflow_tpu/plugins/synapse/``): T-bars from a probability map, their
post-synaptic partners, and edits against a segmentation. Each reads a
chunk once to the host with ``.host()``."""
