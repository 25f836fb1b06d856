"""``sqs://`` queues: the port's ``SQSQueue`` against the JAX package's,
its ``SQSClient`` against the JAX tests' ``FakeSQSClient``, and a port
worker draining a local SQS fake.

* With the JAX tests' ``FakeSQSClient`` injected into both ``SQSQueue``
  classes, the same call sequence gives the same results: batch retry,
  the partial-failure message, an md5 mismatch, ``renew``, ``nack``,
  receive counts, dead letters, listing, ``requeue_dead``, ``stats`` and
  trace ids through every hop.
* The port's ``SQSClient`` against ``FakeSQS`` (the AWS JSON 1.0
  protocol, SigV4 checked) gives, for a seeded call sequence, what
  ``FakeSQSClient`` gives, in the fields ``FakeSQSClient`` answers with
  (the service adds message ids, md5s, and its own receipt handles).
* ``SQSQueue`` on ``FakeSQS``'s real visibility semantics, the JAX class
  included (the port's client injected).
* ``fetch-task-from-queue -q sqs://...`` through the port CLI drains a
  queue through a raised fault and its retry into a ``gs://`` volume,
  equal to the same worker's on a ``file://`` queue.
"""
import json
import os
import random
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from chunkflow_tpu.parallel import queues as jax_queues
from chunkflow_tpu_torch import BoundingBox, Chunk
from chunkflow_tpu_torch.cloud.sqs import SQSClient, SQSError
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.parallel import queues
from chunkflow_tpu_torch.testing import chaos, cloud_fakes
from chunkflow_tpu_torch.volume import storage
from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume
from tests.parallel.test_queues import FakeSQSClient

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SECRETS = {cloud_fakes.ACCESS_KEY: cloud_fakes.SECRET_KEY}


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    for name in ("AWS_PROFILE", "AWS_SESSION_TOKEN", "AWS_ENDPOINT_URL",
                 "GOOGLE_APPLICATION_CREDENTIALS", "CLOUDSDK_CONFIG",
                 "CHUNKFLOW_CHAOS"):
        monkeypatch.delenv(name, raising=False)
    for key, value in cloud_fakes.cloud_env().items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    chaos.reset()
    telemetry.reset()
    storage.reset_shared_cache()
    yield
    chaos.reset()


def _wire(body: str, trace: str) -> str:
    """A task envelope with a fixed trace id (sent as is by both)."""
    return queues.pack_task(body, trace_id=trace)


class _BadMD5(FakeSQSClient):
    def receive_message(self, QueueUrl, MaxNumberOfMessages=1, **kw):
        resp = super().receive_message(QueueUrl, MaxNumberOfMessages, **kw)
        for msg in resp.get("Messages", []):
            msg["MD5OfBody"] = "0" * 32
        return resp


# ---------------------------------------------------------------------------
# one call sequence, both SQSQueue classes, the JAX tests' fake client
# ---------------------------------------------------------------------------
def _batch_retry(cls):
    client = FakeSQSClient(fail_batches=1, fail_ids={"1"})
    q = cls("jobs", client=client)
    q.send_messages([_wire(b, f"t{b}") for b in "abc"])
    return [client.send_batch_calls,
            sorted(client.queues[q.queue_url]["messages"])]


def _batch_raises(cls):
    client = FakeSQSClient(fail_batches=2, fail_ids={"0"})
    q = cls("jobs", client=client)
    with pytest.raises(IOError) as err:
        q.send_messages(["a", "b"])
    return [str(err.value), client.send_batch_calls]


def _many_batches(cls):
    client = FakeSQSClient()
    q = cls("jobs", client=client)
    q.send_messages([_wire(str(i), f"t{i}") for i in range(23)])
    return [client.send_batch_calls, q.stats(),
            len(client.queues[q.queue_url]["messages"])]


def _md5_mismatch(cls):
    q = cls("jobs", client=_BadMD5())
    q.send_messages([_wire("task", "t1")])
    with pytest.raises(IOError) as err:
        q.receive()
    return [str(err.value)]


def _receive(cls):
    client = FakeSQSClient()
    q = cls("jobs", client=client)
    q.send_messages([_wire("task", "t1"), "plain"])
    out = []
    for _ in range(3):
        got = q.receive()
        out.append(None if got is None else
                   [got, q.receive_count(got[0]), q.trace_id(got[0])])
    return out


def _renew_nack(cls):
    client = FakeSQSClient()
    q = cls("jobs", client=client, visibility_timeout=300)
    q.send_messages([_wire("task", "t1")])
    handle, _ = q.receive()
    seen = []
    for call in (lambda: q.renew(handle), lambda: q.renew(handle, 25),
                 lambda: q.nack(handle), lambda: q.nack(handle,
                                                        refund=False)):
        seen.append([call(), client.last_visibility])
    seen.append(q.receive())
    return seen


def _dead_letters(cls):
    client = FakeSQSClient()
    q = cls("jobs", client=client)
    q.send_messages([_wire("poison", "t9"), _wire("ok", "t8")])
    handle, _ = q.receive()
    q.dead_letter(handle, reason="boom")
    q.dead_letter("not-received", reason="ignored")
    listed = [{k: v for k, v in e.items() if k != "t"}
              for e in q.dead_letters()]
    return [listed, q.dead_letters(), q.stats()]


def _requeue(cls):
    client = FakeSQSClient()
    q = cls("jobs", client=client)
    q.send_messages([_wire("poison", "t9")])
    handle, _ = q.receive()
    q.dead_letter(handle, reason="boom")
    moved = q.requeue_dead()
    got = q.receive()
    return [moved, got, q.trace_id(got[0]), q.stats()]


def _stats(cls):
    client = FakeSQSClient()
    q = cls("jobs", client=client)
    empty = q.stats()
    q.send_messages([_wire(str(i), f"t{i}") for i in range(5)])
    handle, _ = q.receive()
    q.receive()
    q.delete(handle)
    return [empty, q.stats()]


def _traces(cls):
    """A trace id through send, receive, dead letter, listing, requeue
    and receive again; plain bodies get a fresh one."""
    client = FakeSQSClient()
    q = cls("jobs", client=client)
    q.send_messages(["plain"])
    wire = client.queues[q.queue_url]["messages"][0]
    handle, body = q.receive()
    trace = q.trace_id(handle)
    q.dead_letter(handle, reason="r")
    listed = q.dead_letters()
    assert q.requeue_dead() == 0   # listing consumed the fake's entry
    return [body, trace == jax_queues.unpack_task(wire)[1],
            listed[0]["trace_id"] == trace, len(trace)]


SCENARIOS = [_batch_retry, _batch_raises, _many_batches, _md5_mismatch,
             _receive, _renew_nack, _dead_letters, _requeue, _stats, _traces]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[1:] for s in SCENARIOS])
def test_the_same_calls_give_the_jax_packages_results(scenario,
                                                      monkeypatch):
    def run(cls):
        # the same fresh trace ids in both runs
        ids = (uuid.UUID(int=i) for i in range(1, 1000))
        monkeypatch.setattr(uuid, "uuid4", lambda: next(ids))
        return scenario(cls)

    assert run(queues.SQSQueue) == run(jax_queues.SQSQueue)


# ---------------------------------------------------------------------------
# the port's SQSClient on the SQS fake, against FakeSQSClient
# ---------------------------------------------------------------------------
def _project(action, resp):
    """The fields FakeSQSClient answers with."""
    if action == "create_queue":
        return resp["QueueUrl"].rsplit("/", 1)[-1]
    if action == "send_message_batch":
        return sorted((f["Id"], f["Code"]) for f in resp.get("Failed", []))
    if action == "receive_message":
        return [(m["Body"], m["Attributes"]["ApproximateReceiveCount"])
                for m in resp.get("Messages", [])]
    if action == "get_queue_attributes":
        return resp["Attributes"]
    return resp


def _sequence(client, rng_seed):
    rng = random.Random(rng_seed)
    out, url, held = [], None, []
    resp = client.create_queue(QueueName="seq",
                               Attributes={"VisibilityTimeout": "300"})
    url = resp["QueueUrl"]
    out.append(_project("create_queue", resp))
    n = 0
    for _ in range(12):
        action = rng.choice(["batch", "batch", "send", "receive", "receive",
                             "delete", "attrs"])
        if action == "batch":
            k = rng.randint(1, 10)
            entries = [{"Id": str(j), "MessageBody": f"m{n + j}"}
                       for j in range(k)]
            n += k
            out.append(_project("send_message_batch",
                                client.send_message_batch(
                                    QueueUrl=url, Entries=entries)))
        elif action == "send":
            client.send_message(QueueUrl=url, MessageBody=f"s{n}")
            out.append("sent")
            n += 1
        elif action == "receive":
            resp = client.receive_message(
                QueueUrl=url, MaxNumberOfMessages=rng.randint(1, 10),
                AttributeNames=["ApproximateReceiveCount"])
            held += [m["ReceiptHandle"] for m in resp.get("Messages", [])]
            out.append(_project("receive_message", resp))
        elif action == "delete" and held:
            client.delete_message(QueueUrl=url, ReceiptHandle=held.pop(
                rng.randrange(len(held))))
            out.append("deleted")
        elif action == "attrs":
            out.append(_project("get_queue_attributes",
                                client.get_queue_attributes(
                                    QueueUrl=url, AttributeNames=[
                                        "ApproximateNumberOfMessages",
                                        "ApproximateNumberOfMessages"
                                        "NotVisible"])))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_client_answers_as_the_fake_client(seed):
    with cloud_fakes.FakeSQS(secrets=SECRETS, fail_ids={"1"},
                             fail_batches=1) as fake:
        port = _sequence(SQSClient(endpoint=fake.url), seed)
        assert fake.snapshot()["auth_refused"] == 0
    assert port == _sequence(FakeSQSClient(fail_batches=1, fail_ids={"1"}),
                             seed)


def test_an_unknown_queue_raises_the_service_error():
    with cloud_fakes.FakeSQS(secrets=SECRETS) as fake:
        client = SQSClient(endpoint=fake.url)
        with pytest.raises(SQSError) as err:
            client.send_message(QueueUrl=f"{fake.url}/0/none",
                                MessageBody="x")
        assert err.value.code == "QueueDoesNotExist" and err.value.status \
            == 400


# ---------------------------------------------------------------------------
# SQSQueue on the fake's visibility semantics
# ---------------------------------------------------------------------------
@pytest.fixture
def sqs(monkeypatch):
    with cloud_fakes.FakeSQS(secrets=SECRETS) as fake:
        monkeypatch.setenv("AWS_ENDPOINT_URL_SQS", fake.url)
        yield fake


@pytest.mark.parametrize("cls", [queues.SQSQueue, jax_queues.SQSQueue],
                         ids=["port", "jax"])
def test_visibility_receive_counts_and_nack(sqs, cls):
    kw = {} if cls is queues.SQSQueue else {"client": SQSClient()}
    q = cls("vis", visibility_timeout=1, **kw)
    q.send_messages(["a"])
    handle, body = q.receive()
    assert (body, q.receive_count(handle)) == ("a", 1)
    assert q.stats()["inflight"] == 1 and q.stats()["pending"] == 0
    q.nack(handle)                       # visible at once
    handle, _ = q.receive()
    assert q.receive_count(handle) == 2
    t = time.time()
    handle, _ = q.receive()              # back after the 1 s visibility
    assert q.receive_count(handle) == 3 and time.time() - t < 10
    q.renew(handle, 30)
    q.delete(handle)
    # the receive counts of the handles this client still holds (the JAX
    # class keeps a nacked delivery's)
    assert q.stats() == {"pending": 0, "inflight": 0, "dead": 0,
                         "receives": 1 + 2}


def test_a_long_poll_returns_when_a_task_arrives(sqs):
    q = queues.SQSQueue("poll")
    got = []
    thread = threading.Thread(target=lambda: got.append(q.receive()))
    t = time.time()
    thread.start()
    time.sleep(0.3)
    queues.SQSQueue("poll").send_messages(["late"])
    thread.join(timeout=25)
    assert not thread.is_alive() and got[0][1] == "late"
    assert time.time() - t < 10


def test_dead_letters_on_the_service(sqs):
    q = queues.SQSQueue("dl")
    q.send_messages(["poison", "fine"])
    handle, body = q.receive()
    q.dead_letter(handle, reason="boom")
    assert q.stats()["dead"] == 1
    assert q.requeue_dead() == 1
    bodies = sorted(q.receive()[1] for _ in range(2))
    assert bodies == ["fine", "poison"]
    assert q.stats()["pending"] == 0
    # listing receives the entries: they hide for the dead queue's 300 s
    q.send_messages(["again"])
    handle, _ = q.receive()
    q.dead_letter(handle, reason="r2")
    listed = q.dead_letters()
    assert [(e["body"], e["reason"], e["receives"]) for e in listed] == [
        ("again", "r2", 1)]
    assert q.dead_letters() == [] and q.stats()["dead"] == 0


def test_one_package_drains_the_others_queue(sqs):
    queues.SQSQueue("shared").send_messages([_wire("0-4_0-4_0-4", "abc")])
    jax_q = jax_queues.SQSQueue("shared", client=SQSClient())
    handle, body = jax_q.receive()
    assert (body, jax_q.trace_id(handle)) == ("0-4_0-4_0-4", "abc")
    jax_q.delete(handle)
    assert queues.SQSQueue("shared").stats()["pending"] == 0


# ---------------------------------------------------------------------------
# a worker through the CLI
# ---------------------------------------------------------------------------
IN_SIZE = (16, 96, 96)
ROI = ((2, 16, 16), (12, 64, 64))
TASK = (6, 32, 32)


def _worker(queue, vol_in, vol_out, num, metrics):
    return ["--device", "cpu", "--metrics-dir", metrics,
            "fetch-task-from-queue", "-q", queue, "--max-retries", "3",
            "--backoff-base", "0.05", "--num", str(num), "-r", "0",
            "load-precomputed", "-v", vol_in, "-e", "2", "8", "8",
            "inference", "-f", "identity", "-p", "4", "16", "16", "-v", "2",
            "8", "8", "-c", "3", "-b", "2", "--output-crop-margin", "2", "8",
            "8", "save-precomputed", "-v", vol_out, "--async-write",
            "delete-task-in-queue"]


def _commits(metrics):
    acks = {}
    for name in os.listdir(metrics):
        with open(os.path.join(metrics, name)) as f:
            for line in f:
                event = json.loads(line)
                if event.get("name") == "lifecycle/committed":
                    acks[event["body"]] = acks.get(event["body"], 0) + 1
    return acks


def test_a_worker_drains_an_sqs_queue_into_a_gs_volume(sqs, tmp_path,
                                                       monkeypatch):
    with cloud_fakes.FakeGCS() as gcs:
        monkeypatch.setenv("TENSORSTORE_GCS_HTTP_URL", gcs.url)
        image = np.random.default_rng(3).integers(0, 256, IN_SIZE,
                                                  dtype=np.uint8)
        runs = {}
        for tag, vol_in, vol_out, queue in (
                ("cloud", "gs://chunkflow-in/img", "gs://chunkflow-out/aff",
                 "sqs://tasks"),
                ("local", str(tmp_path / "img"), str(tmp_path / "aff"),
                 f"file://{tmp_path}/q")):
            PrecomputedVolume.create(vol_in, volume_size=IN_SIZE,
                                     voxel_size=(40, 4, 4),
                                     block_size=(8, 32, 32))
            PrecomputedVolume(vol_in).save(Chunk(image))
            PrecomputedVolume.create(vol_out, volume_size=ROI[1],
                                     voxel_offset=ROI[0],
                                     voxel_size=(40, 4, 4), num_channels=3,
                                     dtype="float32", block_size=TASK)
            assert cli.main(["--device", "cpu", "generate-tasks",
                             "--volume-path", vol_out, "-c", *map(str, TASK),
                             "--queue-name", queue]) == 0
            storage.reset_shared_cache()
            chaos.reset()
            monkeypatch.setenv("CHUNKFLOW_CHAOS", "once=lifecycle/pre_ack")
            metrics = str(tmp_path / f"events-{tag}")
            # --num counts the tasks that went through: the 8, not the
            # delivery the raised fault sent back
            assert cli.main(_worker(queue, vol_in, vol_out, 8, metrics)) == 0
            monkeypatch.delenv("CHUNKFLOW_CHAOS")
            assert telemetry.snapshot()["counters"]["chaos/injected"] == 1
            acks = _commits(metrics)
            assert len(acks) == 8 and set(acks.values()) == {1}
            stats = queues.open_queue(queue).stats()
            assert (stats["pending"], stats["inflight"], stats["dead"]) \
                == (0, 0, 0)
            storage.reset_shared_cache()
            runs[tag] = PrecomputedVolume(vol_out).cutout(
                BoundingBox(ROI[0], tuple(a + b for a, b in zip(*ROI))))
            telemetry.reset()
        assert np.array_equal(runs["cloud"].array, runs["local"].array)
        # the gs:// objects are the local files, byte for byte
        with gcs.lock:
            objects = {name[len("aff/"):]: data for (bucket, name), (data, _)
                       in gcs.objects.items() if bucket == "chunkflow-out"}
        files = {os.path.relpath(os.path.join(d, n), tmp_path / "aff"):
                 open(os.path.join(d, n), "rb").read()
                 for d, _, names in os.walk(tmp_path / "aff") for n in names}
        # save-precomputed's timing logs stay local (--upload-log is on by
        # default, and a cloud volume keeps none, as in the JAX package)
        logs = {n for n in files if n.startswith("log/")}
        assert len(logs) == 8
        assert objects == {n: files[n] for n in files if n not in logs}


def test_dead_letter_and_fleet_status_commands_on_sqs(sqs, capsys):
    q = queues.SQSQueue("cmd")
    q.send_messages(["0-4_0-4_0-4"])
    handle, _ = q.receive()
    q.dead_letter(handle, reason="boom")
    assert cli.main(["fleet-status", "-q", "sqs://cmd"]) == 0
    out = capsys.readouterr().out
    assert "queue cmd: pending=0 in-flight=0 dead=1 receives=?" in out
    assert cli.main(["dead-letter", "-q", "sqs://cmd", "--requeue"]) == 0
    out = capsys.readouterr().out
    assert "1 dead-letter task(s) in sqs://cmd" in out
    assert "requeued 0 task(s)" in out   # listing hid the entry, as in JAX
