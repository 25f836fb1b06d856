"""A CloudWatch ``PutMetricData`` client over the AWS Query protocol,
with boto3's method and keyword names, for the ``aws/cloud_watch``
plugin.

Each call is ``POST /`` to ``https://monitoring.{region}.amazonaws.com``
(or ``AWS_ENDPOINT_URL_CLOUDWATCH`` / ``AWS_ENDPOINT_URL``) with a
form-encoded body (``Action=PutMetricData``, ``Version=2010-08-01``,
``Namespace``, ``MetricData.member.N.MetricName`` / ``.Value`` /
``.Unit`` / ``.Dimensions.member.M.Name`` / ``.Value``) and a SigV4
signature for service ``monitoring`` (unsigned without credentials),
the credentials and region resolved as boto3 resolves them
(``cloud/aws.py``). Retries are ``cloud/http.py``'s; an answer other
than 2xx after them raises :class:`CloudWatchError` with the service's
error code.
"""
from __future__ import annotations

import urllib.parse
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

from chunkflow_tpu_torch.cloud import aws
from chunkflow_tpu_torch.cloud.http import HTTPClient, HTTPError
from chunkflow_tpu_torch.cloud.s3 import shared_chain, signer

__all__ = ["CloudWatchClient", "CloudWatchError", "metric_data_params",
           "VERSION"]

VERSION = "2010-08-01"


class CloudWatchError(IOError):
    def __init__(self, code: str, message: str, status: int):
        self.code = code
        self.status = status
        super().__init__(f"CloudWatch {code} ({status}): {message}")


def metric_data_params(namespace: str,
                       metric_data: Sequence[dict]) -> List[Tuple[str, str]]:
    """The Query protocol's fields of one ``PutMetricData`` call, in
    boto3's order: the action, the version, the namespace, then each
    datum's name, value, unit and dimensions (members counted from 1)."""
    params = [("Action", "PutMetricData"), ("Version", VERSION),
              ("Namespace", namespace)]
    for i, datum in enumerate(metric_data, 1):
        prefix = f"MetricData.member.{i}"
        params.append((f"{prefix}.MetricName", datum["MetricName"]))
        for j, dim in enumerate(datum.get("Dimensions") or (), 1):
            params.append((f"{prefix}.Dimensions.member.{j}.Name",
                           dim["Name"]))
            params.append((f"{prefix}.Dimensions.member.{j}.Value",
                           dim["Value"]))
        if "Value" in datum:
            params.append((f"{prefix}.Value", repr(float(datum["Value"]))))
        if "Unit" in datum:
            params.append((f"{prefix}.Unit", datum["Unit"]))
    return params


def _error(body: bytes) -> Tuple[str, str]:
    """(code, message) of a Query protocol ``ErrorResponse``."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        return "Unknown", body[:300].decode("utf-8", "replace")
    code = message = ""
    for el in root.iter():
        tag = el.tag.rsplit("}", 1)[-1]
        if tag == "Code" and not code:
            code = el.text or ""
        elif tag == "Message" and not message:
            message = el.text or ""
    return code or "Unknown", message


class CloudWatchClient:
    """``put_metric_data(Namespace=..., MetricData=[...])``: boto3's
    keywords in, its response dict's ``ResponseMetadata`` out."""

    def __init__(self, endpoint: Optional[str] = None):
        region = aws.region()
        self.endpoint = (endpoint or aws.endpoint("cloudwatch")
                         or f"https://monitoring.{region}.amazonaws.com")
        self.http = HTTPClient(counter_prefix="cloudwatch/http")
        self._sign = signer(shared_chain(), region, "monitoring")

    def put_metric_data(self, Namespace, MetricData, **kw):
        if kw:
            raise TypeError(f"put_metric_data takes Namespace and "
                            f"MetricData, not {sorted(kw)}")
        body = urllib.parse.urlencode(
            metric_data_params(Namespace, MetricData)).encode()
        try:
            got = self.http.request(
                "POST", self.endpoint + "/", body=body,
                headers={"Content-Type": "application/x-www-form-urlencoded;"
                                         " charset=utf-8"},
                prepare=self._sign)
        except HTTPError as exc:
            code, message = _error(exc.body)
            raise CloudWatchError(code, message, exc.status) from None
        if not 200 <= got.status < 300:
            code, message = _error(got.body)
            raise CloudWatchError(code, message, got.status)
        return {"ResponseMetadata": {"HTTPStatusCode": got.status}}
