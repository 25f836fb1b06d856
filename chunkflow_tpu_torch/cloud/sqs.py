"""An SQS client over the AWS JSON 1.0 protocol, with boto3's method and
keyword names and response dicts, for the port's ``SQSQueue``.

Each call is ``POST /`` to ``https://sqs.{region}.amazonaws.com`` (or
``AWS_ENDPOINT_URL_SQS`` / ``AWS_ENDPOINT_URL``) with
``X-Amz-Target: AmazonSQS.<Action>``,
``Content-Type: application/x-amz-json-1.0`` and a SigV4 signature for
service ``sqs`` (unsigned without credentials). An error answer raises
:class:`SQSError` with the service's error code.
"""
from __future__ import annotations

import json
from typing import Optional

from chunkflow_tpu_torch.cloud import aws
from chunkflow_tpu_torch.cloud.http import HTTPClient, HTTPError
from chunkflow_tpu_torch.cloud.s3 import shared_chain, signer

__all__ = ["SQSClient", "SQSError"]


class SQSError(IOError):
    def __init__(self, code: str, message: str, status: int):
        self.code = code
        self.status = status
        super().__init__(f"SQS {code} ({status}): {message}")


class SQSClient:
    """``create_queue``, ``send_message``, ``send_message_batch``,
    ``receive_message``, ``delete_message``, ``change_message_visibility``,
    ``get_queue_attributes``: boto3's keywords in, its dicts out."""

    def __init__(self, endpoint: Optional[str] = None):
        region = aws.region()
        self.endpoint = (endpoint or aws.endpoint("sqs")
                         or f"https://sqs.{region}.amazonaws.com")
        self.http = HTTPClient(counter_prefix="queue/http")
        self._sign = signer(shared_chain(), region, "sqs")

    def _call(self, action: str, params: dict) -> dict:
        try:
            got = self.http.request(
                "POST", self.endpoint + "/",
                body=json.dumps(params).encode(),
                headers={"X-Amz-Target": f"AmazonSQS.{action}",
                         "Content-Type": "application/x-amz-json-1.0"},
                prepare=self._sign)
        except HTTPError as exc:
            try:
                doc = json.loads(exc.body)
            except ValueError:
                raise exc from None
            code = str(doc.get("__type", "")).rsplit("#", 1)[-1]
            raise SQSError(code or "Unknown", doc.get("message")
                           or doc.get("Message", ""), exc.status) from None
        if got.status != 200:
            raise SQSError("NotFound" if got.status == 404 else
                           "PreconditionFailed", got.body[:300].decode(
                               "utf-8", "replace"), got.status)
        return json.loads(got.body) if got.body else {}

    def create_queue(self, QueueName, Attributes=None, **kw):
        return self._call("CreateQueue", dict(
            kw, QueueName=QueueName, **({"Attributes": Attributes}
                                        if Attributes else {})))

    def send_message(self, QueueUrl, MessageBody, **kw):
        return self._call("SendMessage", dict(kw, QueueUrl=QueueUrl,
                                              MessageBody=MessageBody))

    def send_message_batch(self, QueueUrl, Entries, **kw):
        return self._call("SendMessageBatch", dict(kw, QueueUrl=QueueUrl,
                                                   Entries=list(Entries)))

    def receive_message(self, QueueUrl, **kw):
        return self._call("ReceiveMessage", dict(kw, QueueUrl=QueueUrl))

    def delete_message(self, QueueUrl, ReceiptHandle, **kw):
        return self._call("DeleteMessage", dict(
            kw, QueueUrl=QueueUrl, ReceiptHandle=ReceiptHandle))

    def change_message_visibility(self, QueueUrl, ReceiptHandle,
                                  VisibilityTimeout, **kw):
        return self._call("ChangeMessageVisibility", dict(
            kw, QueueUrl=QueueUrl, ReceiptHandle=ReceiptHandle,
            VisibilityTimeout=int(VisibilityTimeout)))

    def get_queue_attributes(self, QueueUrl, AttributeNames=(), **kw):
        return self._call("GetQueueAttributes", dict(
            kw, QueueUrl=QueueUrl, AttributeNames=list(AttributeNames)))
