"""Fault injection for the worker loop's stage boundaries (``chaos.py``)
and local fakes of GCS, S3 and SQS for tests (``cloud_fakes.py``)."""
