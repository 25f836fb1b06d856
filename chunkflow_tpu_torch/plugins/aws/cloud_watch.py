"""Publish the telemetry registry's snapshot as CloudWatch metrics.

The counterpart of ``chunkflow_tpu/plugins/aws/cloud_watch.py``: the
same metric data, units, 20-datum batches and ``worker`` dimension
(``telemetry.worker_id()``), namespace ``chunkflow-tpu``:

* counters as Count (Seconds for a name ending in ``_seconds``);
* gauges as None, Bytes for ``device/bytes_in_use`` and
  ``device/peak_bytes``, Count for the fleet's sizing gauges;
* each span histogram's total as ``<name>-total`` in Seconds, with each
  stall phase's share (``stall-share/<phase>``) and the dominant one's
  (``stall/dominant_share``);
* each quantile histogram's p50 and p99 (``telemetry.
  quantile_from_buckets``) in Milliseconds;
* a task log's ``timer`` dict as ``<op>-time`` in Seconds.

``execute(client=None)`` publishes through the port's own
``PutMetricData`` client (``cloud/cloudwatch.py``: SigV4, boto3's
endpoint, credential and region settings); a caller may pass any object
with boto3's ``put_metric_data``.
"""
from typing import List, Optional

from chunkflow_tpu_torch.core import telemetry

DEFAULT_NAMESPACE = "chunkflow-tpu"

#: the plugin's cap on MetricData entries per call
_BATCH = 20

#: gauges measured in bytes
_BYTE_GAUGES = ("device/bytes_in_use", "device/peak_bytes")

#: gauges that count discrete things (workers, queued tasks)
_COUNT_GAUGES = ("fleet/workers", "fleet/target", "fleet/pending",
                 "fleet/inflight")


def snapshot_metric_data(snap: Optional[dict] = None,
                         log: Optional[dict] = None) -> List[dict]:
    """The registry's snapshot (and a task log's timers) as a CloudWatch
    MetricData list."""
    from chunkflow_tpu_torch.flow.log_summary import STALL_PHASES

    if snap is None:
        snap = telemetry.snapshot()
    dimensions = [{"Name": "worker", "Value": telemetry.worker_id()}]
    data: List[dict] = []

    def add(name: str, value: float, unit: str) -> None:
        data.append({
            "MetricName": name,
            "Value": float(value),
            "Unit": unit,
            "Dimensions": dimensions,
        })

    for name, value in sorted((snap.get("counters") or {}).items()):
        unit = "Seconds" if name.endswith("_seconds") else "Count"
        add(name, value, unit)
    for name, value in sorted((snap.get("gauges") or {}).items()):
        if name in _BYTE_GAUGES:
            unit = "Bytes"
        elif name in _COUNT_GAUGES:
            unit = "Count"
        else:
            unit = "None"
        add(name, value, unit)
    hists = snap.get("hists") or {}
    for name, h in sorted(hists.items()):
        add(f"{name}-total", h["total"], "Seconds")
    for name, h in sorted((snap.get("qhists") or {}).items()):
        for q, label in ((0.5, "p50"), (0.99, "p99")):
            value = telemetry.quantile_from_buckets(h, q)
            if value is not None:
                add(f"{name}-{label}", value * 1000.0, "Milliseconds")
    totals = {p: hists[p]["total"] for p in STALL_PHASES if p in hists}
    window = sum(totals.values())
    if window > 0:
        for phase, total in totals.items():
            add(f"stall-share/{phase}", total / window, "None")
        dominant = max(totals, key=totals.get)
        add("stall/dominant_share", totals[dominant] / window, "None")
    for key, value in (log or {}).get("timer", {}).items():
        add(f"{key}-time", value, "Seconds")
    return data


def execute(log: Optional[dict] = None, name: str = DEFAULT_NAMESPACE,
            client=None):
    if client is None:
        from chunkflow_tpu_torch.cloud.cloudwatch import CloudWatchClient

        client = CloudWatchClient()
    metric_data = snapshot_metric_data(log=log)
    for i in range(0, len(metric_data), _BATCH):
        client.put_metric_data(
            Namespace=name, MetricData=metric_data[i:i + _BATCH]
        )
