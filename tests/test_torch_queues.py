"""The port's task queues against the JAX package's.

The same operation sequence drives the port's and the JAX package's
``MemoryQueue`` and ``FileQueue``: sends, receives and their counts,
refunded and unrefunded nacks, renewals, a visibility timeout that
expires, dead-letters, ``requeue_dead`` and ``stats``. Task ids come from
``uuid.uuid4``, patched here to one deterministic sequence per run, so
both packages see the same handles (a ``FileQueue`` receives in name
order). A ``FileQueue`` directory either package filled, claimed and
dead-lettered drains in the other.
"""
import json
import time
import uuid

import pytest
import torch

from chunkflow_tpu.parallel import queues as jax_queues
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel import queues

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

TIMEOUT = 1.0  # a visibility timeout short enough to watch it expire


@pytest.fixture(autouse=True)
def clean():
    telemetry.reset()
    queues.MemoryQueue._registry.clear()
    jax_queues.MemoryQueue._registry.clear()
    yield
    queues.MemoryQueue._registry.clear()
    jax_queues.MemoryQueue._registry.clear()


def _deterministic_uuid(monkeypatch):
    counter = iter(range(1, 10**6))
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(counter) * 7919))


def _drive(q):
    """One operation sequence; the log of everything observable."""
    log = []

    def receive():
        item = q.receive()
        if item is None:
            log.append(("empty",))
            return None
        handle, body = item
        log.append(("receive", body, q.receive_count(handle),
                    q.trace_id(handle) is not None))
        return handle

    q.send_messages(["0-4_0-4_0-4", "4-8_0-4_0-4", "8-12_0-4_0-4", "poison"])
    a = receive()
    b = receive()
    log.append(("nack refunded", q.nack(a), q.receive_count(a)))
    log.append(("nack again", q.nack(a)))
    c = receive()
    log.append(("stats", q.stats()))
    q.renew(b, 60.0)  # b stays invisible past the timeout
    d = receive()
    q.dead_letter(d, reason="ValueError: bad")
    log.append(("dead", [(e["body"], e["reason"], e["receives"],
                          "trace_id" in e) for e in q.dead_letters()]))
    log.append(("stats", q.stats()))
    time.sleep(TIMEOUT * 1.5)  # c's claim expires; b's was renewed
    e = receive()
    log.append(("stats", q.stats()))
    log.append(("nack unrefunded", q.nack(e, refund=False),
                q.receive_count(e)))
    f = receive()
    log.append(("requeue", q.requeue_dead()))
    log.append(("stats", q.stats()))
    q.delete(b)
    q.delete(f)
    q.max_empty_retries, q.retry_sleep = 0, 0.01
    for handle, body in q:
        log.append(("drain", body, q.receive_count(handle)))
        q.delete(handle)
    receive()
    log.append(("stats", q.stats()))
    return log


@pytest.mark.parametrize("backend", ["memory", "file"])
def test_the_same_sequence_gives_the_same_observations(tmp_path, monkeypatch,
                                                       backend):
    logs = []
    for name, module in (("jax", jax_queues), ("port", queues)):
        _deterministic_uuid(monkeypatch)
        if backend == "memory":
            q = module.MemoryQueue.open(f"seq-{name}", TIMEOUT)
        else:
            q = module.FileQueue(str(tmp_path / name), TIMEOUT)
        logs.append(_drive(q))
    assert logs[1] == logs[0]
    kinds = [entry[0] for entry in logs[1]]
    assert kinds.count("drain") == 2
    assert logs[1][-1][1] == {"pending": 0, "inflight": 0, "dead": 0,
                              "receives": 0}


@pytest.mark.parametrize("filler", ["jax", "port"])
def test_a_file_queue_filled_by_one_package_drains_in_the_other(tmp_path,
                                                                filler):
    fill, drain = ((jax_queues, queues) if filler == "jax"
                   else (queues, jax_queues))
    bodies = [f"{i}-{i + 4}_0-8_0-8" for i in range(0, 24, 4)]
    q = fill.FileQueue(str(tmp_path / "q"))
    q.send_messages(bodies)
    handle, body = q.receive()  # one claimed...
    q.dead_letter(handle, reason="poison")  # ...and dead-lettered
    claimed = q.receive()  # one left claimed
    other = drain.FileQueue(str(tmp_path / "q"))
    assert other.stats() == q.stats() == {"pending": 4, "inflight": 1,
                                          "dead": 1, "receives": 1}
    dead = other.dead_letters()
    assert [(e["body"], e["reason"], e["receives"]) for e in dead] == \
        [(body, "poison", 1)]
    traces = set()
    other.max_empty_retries, other.retry_sleep = 0, 0.01
    drained = []
    for handle, got in other:
        drained.append(got)
        traces.add(other.trace_id(handle))
        other.delete(handle)
    assert len(traces) == 4 and None not in traces
    assert sorted(drained + [body, claimed[1]]) == sorted(bodies)
    assert other.nack(claimed[0])  # the claim the filler still holds
    assert other.requeue_dead() == 1
    left = sorted(other.receive()[1] for _ in range(2))
    assert left == sorted([body, claimed[1]])


def test_envelopes_are_the_jax_packages():
    wire = queues.pack_task("0-4_0-4_0-4", trace_id="abc")
    assert jax_queues.unpack_task(wire) == ("0-4_0-4_0-4", "abc")
    assert queues.pack_task(wire) == wire  # idempotent
    jax_wire = jax_queues.pack_task("body", trace_id="xyz")
    assert queues.unpack_task(jax_wire) == ("body", "xyz")
    assert json.loads(wire) == json.loads(
        jax_queues.pack_task("0-4_0-4_0-4", trace_id="abc"))
    assert queues.unpack_task("plain") == ("plain", None)


def test_open_queue_specs(tmp_path, monkeypatch):
    assert isinstance(queues.open_queue("memory://x"), queues.MemoryQueue)
    assert queues.open_queue("memory://x") is queues.open_queue("memory://x")
    for spec in (f"file://{tmp_path / 'a'}", str(tmp_path / "b")):
        q = queues.open_queue(spec, visibility_timeout=5)
        assert isinstance(q, queues.FileQueue) and q.visibility_timeout == 5
    # sqs:// opens an SQSQueue over the port's SQS client, here a stand-in
    # (tests/test_torch_sqs.py drives it against a fake service)
    from chunkflow_tpu_torch.cloud import sqs
    from tests.parallel.test_queues import FakeSQSClient

    monkeypatch.setattr(sqs, "SQSClient", FakeSQSClient)
    q = queues.open_queue("sqs://tasks", visibility_timeout=20)
    assert isinstance(q, queues.SQSQueue) and q.visibility_timeout == 20
    assert q.queue_url == "fake://tasks" and q.name == "tasks"


def test_queue_counters():
    q = queues.MemoryQueue.open("counted")
    q.send_messages(["a", "b"])
    q.receive()
    counters = telemetry.snapshot()["counters"]
    assert counters["queue/sent"] == 2 and counters["queue/receives"] == 1
