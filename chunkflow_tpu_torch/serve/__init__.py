"""Serving: the HTTP front end (``serve/frontend.py``) and the
cross-request patch packer (``serve/packer.py``).

The counterpart of ``chunkflow_tpu/serve/``. ``POST /infer`` requests
pass admission control (an in-flight bound and the scheduler's memory
watermark), become supervised tasks with leases, retries and a
completion ledger, and compute through one :class:`PatchPacker`, whose
gather and pre-weighted accumulate kernels batch the patches of every
request in flight; the ``serve`` command runs it
(``python -m chunkflow_tpu_torch serve ...``).
"""
from chunkflow_tpu_torch.serve.frontend import (
    AdmissionController,
    AdmissionRejected,
    LocalBackend,
    ServingRequest,
    ServingService,
    SpoolBackend,
    start_serving,
)
from chunkflow_tpu_torch.serve.packer import (
    PackerClosed,
    PatchPacker,
    PendingResult,
    RequestExpired,
    serve_enabled,
)

__all__ = ["serve_enabled", "RequestExpired", "PackerClosed",
           "PendingResult", "PatchPacker", "AdmissionRejected",
           "AdmissionController", "ServingRequest", "LocalBackend",
           "SpoolBackend", "ServingService", "start_serving"]
