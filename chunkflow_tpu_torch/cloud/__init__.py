"""The port's own cloud clients, on the standard library: HTTP
(``http.py``), AWS signing and credentials (``aws.py``), Google
credentials (``google.py``), the ``gs://`` and ``s3://`` KV planes
(``gcs.py``, ``s3.py``) and the SQS client (``sqs.py``)."""
