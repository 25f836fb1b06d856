"""The port's ``aws/cloud_watch`` plugin and its ``PutMetricData`` client
against the JAX plugin, on the CPU.

The MetricData list of one seeded snapshot and task log is the JAX
``snapshot_metric_data``'s; with a recording client both ``execute``s make
the same calls; without one the port publishes through its own client
(``cloud/cloudwatch.py``) to the local CloudWatch fake, which checks
SigV4 and records the batches. No test reaches an outside host: the
JAX plugin always gets a recording client (its own default is boto3).
"""
import numpy as np
import pytest
import torch

from chunkflow_tpu.core import telemetry as jax_telemetry
from chunkflow_tpu.plugins.aws import cloud_watch as jax_cloud_watch
from chunkflow_tpu_torch.cloud.cloudwatch import (
    CloudWatchClient,
    CloudWatchError,
)
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.plugins.aws import cloud_watch
from chunkflow_tpu_torch.testing import cloud_fakes

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

LOG = {"timer": {"load-precomputed": 0.25, "inference": 1.5,
                 "save-precomputed": 0.125}}


class Recorder:
    """boto3's ``put_metric_data``, recorded."""

    def __init__(self):
        self.calls = []

    def put_metric_data(self, Namespace, MetricData):
        self.calls.append((Namespace, MetricData))


@pytest.fixture
def registries(monkeypatch):
    """Both packages' registries, empty, with one worker id."""
    monkeypatch.setenv("CHUNKFLOW_WORKER_ID", "worker-7")
    for reg in (telemetry, jax_telemetry):
        reg.reset()
    yield
    for reg in (telemetry, jax_telemetry):
        reg.reset()


def _seed(reg, n_counters=6, seed=0):
    """The same seeded counters, gauges and quantile observations in a
    registry (spans are timed, so the shared-snapshot case has them)."""
    rng = np.random.default_rng(seed)
    for i in range(n_counters):
        reg.inc(f"c/{i}", float(rng.integers(1, 50)))
    reg.inc("tasks/committed", 4)
    reg.inc("program/compile_seconds", 2.5)
    reg.gauge("device/bytes_in_use", 2048)
    reg.gauge("fleet/workers", 3)
    reg.gauge("scheduler/depth/ring", 2)
    for v in rng.gamma(2.0, 0.01, 60):
        reg.observe_quantile("serving/latency", float(v))


def _spans():
    for name, reps in (("pipeline/drain", 3), ("pipeline/stage", 2),
                       ("inference/infer", 1)):
        for _ in range(reps):
            with telemetry.span(name):
                pass


@pytest.mark.parametrize("log", [None, LOG], ids=["no-log", "task-log"])
def test_metric_data_of_one_snapshot_equals_the_jax_plugins(registries,
                                                            log):
    _seed(telemetry)
    _spans()
    snap = telemetry.snapshot()
    got = cloud_watch.snapshot_metric_data(snap, log)
    ref = jax_cloud_watch.snapshot_metric_data(snap, log)
    assert got == ref
    names = {d["MetricName"]: d["Unit"] for d in got}
    assert names["program/compile_seconds"] == "Seconds"
    assert names["device/bytes_in_use"] == "Bytes"
    assert names["fleet/workers"] == "Count"
    assert names["serving/latency-p99"] == "Milliseconds"
    assert names["stall/dominant_share"] == "None"


@pytest.mark.parametrize("n_counters, namespace", [
    (3, None), (40, None), (40, "my-fleet")],
    ids=["one-batch", "three-batches", "namespace"])
def test_both_executes_call_for_call(registries, n_counters, namespace):
    """Each package's own registry, seeded alike: the same calls, batches
    of at most 20."""
    kw = {} if namespace is None else {"name": namespace}
    for reg in (telemetry, jax_telemetry):
        _seed(reg, n_counters)
    got, ref = Recorder(), Recorder()
    cloud_watch.execute(LOG, client=got, **kw)
    jax_cloud_watch.execute(LOG, client=ref, **kw)
    assert got.calls == ref.calls
    assert [len(batch) for _, batch in got.calls][:-1] == \
        [20] * (len(got.calls) - 1)
    assert {ns for ns, _ in got.calls} == {namespace or "chunkflow-tpu"}


@pytest.fixture
def fake_cloudwatch(monkeypatch):
    with cloud_fakes.FakeCloudWatch(
            secrets={cloud_fakes.ACCESS_KEY: cloud_fakes.SECRET_KEY}) as fake:
        for key, value in cloud_fakes.cloud_env(cloudwatch=fake.url).items():
            monkeypatch.setenv(key, value)
        yield fake


def test_the_ports_own_client_publishes_to_the_fake(registries,
                                                   fake_cloudwatch):
    for reg in (telemetry, jax_telemetry):
        _seed(reg, 30)
    cloud_watch.execute(LOG)
    ref = Recorder()
    jax_cloud_watch.execute(LOG, client=ref)
    fake = fake_cloudwatch
    assert fake.stats["auth_refused"] == 0
    assert fake.stats["requests"] == {"POST": len(ref.calls)}
    assert [tuple(call) for call in fake.calls] == ref.calls
    # the fake's stats carry the calls for a fake in another process
    assert cloud_fakes.control(fake.url)["calls"] == [
        [ns, data] for ns, data in ref.calls]


def test_the_fake_refuses_a_bad_signature_and_a_21st_datum(
        registries, fake_cloudwatch, monkeypatch):
    datum = {"MetricName": "m", "Value": 1.0, "Unit": "Count",
             "Dimensions": [{"Name": "worker", "Value": "w"}]}
    client = CloudWatchClient()
    with pytest.raises(CloudWatchError) as info:
        client.put_metric_data(Namespace="n", MetricData=[datum] * 21)
    assert info.value.status == 400
    assert info.value.code == "InvalidParameterValue"
    assert client.put_metric_data(Namespace="n", MetricData=[datum] * 20) \
        == {"ResponseMetadata": {"HTTPStatusCode": 200}}
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "not-the-secret")
    with pytest.raises(CloudWatchError) as info:
        CloudWatchClient().put_metric_data(Namespace="n",
                                           MetricData=[datum])
    assert info.value.status == 403
    assert info.value.code == "SignatureDoesNotMatch"
    assert fake_cloudwatch.stats["auth_refused"] == 1
    assert fake_cloudwatch.calls == [["n", [datum] * 20]]


def test_the_plugin_command_publishes_through_the_port_cli(
        registries, fake_cloudwatch):
    """``plugin -n aws/cloud_watch -i log`` after an inference: the
    task's log timers and the registry go out in batches of 20."""
    rc = cli.main(["--device", "cpu", "create-chunk", "--size", "4", "16",
                   "16", "inference", "-f", "identity", "-p", "4", "16",
                   "16", "plugin", "-n", "aws/cloud_watch", "-i", "log",
                   "-o", "", "-a", "name=smoke"])
    assert rc == 0
    calls = fake_cloudwatch.calls
    assert calls and all(ns == "smoke" and 0 < len(data) <= 20
                         for ns, data in calls)
    names = {d["MetricName"] for _, data in calls for d in data}
    assert {"inference/chunks", "inference-time"} <= names
