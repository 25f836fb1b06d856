"""Serving: the cross-request patch packer (``serve/packer.py``).

The counterpart of ``chunkflow_tpu/serve/``. The HTTP front end
(``frontend.py``) and the ``serve`` command are not ported yet (ROADMAP,
queue 1: serving packer).
"""
from chunkflow_tpu_torch.serve.packer import (
    PackerClosed,
    PatchPacker,
    PendingResult,
    RequestExpired,
    serve_enabled,
)

__all__ = ["serve_enabled", "RequestExpired", "PackerClosed",
           "PendingResult", "PatchPacker"]
