"""The port's task lifecycle and chaos harness against the JAX package's.

Retry with backoff and dead-letter past ``max_retries``, ledger resume
from a ledger directory the JAX package wrote, lease renewal, SIGTERM
handing the in-flight task back, the surrender of claimed tasks a broken
chain's executors held (the same sequence through the JAX package ends in
the same queue), and the chaos plans of ``tests/testing/test_chaos.py``,
which both packages must strike alike.
"""
import os
import random
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from chunkflow_tpu.flow import cli as jax_cli
from chunkflow_tpu.flow import runtime as jax_runtime
from chunkflow_tpu.parallel import lifecycle as jax_lifecycle
from chunkflow_tpu.parallel import queues as jax_queues
from chunkflow_tpu.testing import chaos as jax_chaos
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.flow.runtime import operator, process_stream
from chunkflow_tpu_torch.parallel import lifecycle, queues
from chunkflow_tpu_torch.testing import chaos

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

BODIES = [f"{z}-{z + 4}_0-8_0-8" for z in range(0, 24, 4)]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for var in ("CHUNKFLOW_CHAOS", "CHUNKFLOW_SCHED", "CHUNKFLOW_TELEMETRY"):
        monkeypatch.delenv(var, raising=False)
    for module in (chaos, jax_chaos):
        module.reset()
    telemetry.reset()
    queues.MemoryQueue._registry.clear()
    lifecycle.MemoryLedger._registry.clear()
    yield
    for module in (chaos, jax_chaos):
        module.reset()
    for lc in lifecycle.inflight():
        lifecycle._unregister(lc)


# ---------------------------------------------------------------------------
# classification, backoff, retries and dead-letter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exc", [
    ValueError("x"), KeyError("k"), NotImplementedError("n"), OSError("io"),
    RuntimeError("r"), TimeoutError("t"),
    lifecycle.TransientTaskError("t"), lifecycle.PermanentTaskError("p"),
    chaos.ChaosError("c"),
])
def test_classify_error_is_the_jax_packages(exc):
    as_jax = {lifecycle.TransientTaskError: jax_lifecycle.TransientTaskError,
              lifecycle.PermanentTaskError: jax_lifecycle.PermanentTaskError,
              chaos.ChaosError: jax_chaos.ChaosError}
    jax_exc = as_jax.get(type(exc), type(exc))(*exc.args)
    assert lifecycle.classify_error(exc) == \
        jax_lifecycle.classify_error(jax_exc)


def test_backoff_is_the_jax_packages():
    for attempt in range(1, 9):
        got = lifecycle.backoff_delay(attempt, 0.5, 10.0, random.Random(7))
        want = jax_lifecycle.backoff_delay(attempt, 0.5, 10.0,
                                           random.Random(7))
        assert got == want and 0 <= got <= min(10.0, 0.5 * 2 ** (attempt - 1))


@pytest.mark.parametrize("errors", [
    ("RuntimeError", "RuntimeError", "RuntimeError"),  # transient: budget
    ("RuntimeError", "ValueError"),                    # permanent at once
])
def test_retry_then_dead_letter_as_the_jax_package(errors):
    """The same failures on the same queue sequence: the same outcomes,
    receive counts and dead-letter reason in both packages."""
    results = []
    for pkg_lifecycle, pkg_queues in ((jax_lifecycle, jax_queues),
                                      (lifecycle, queues)):
        q = pkg_queues.MemoryQueue(f"retry-{len(results)}",
                                   visibility_timeout=60)
        q.retry_sleep = 0.01
        q.send_messages(["0-4_0-4_0-4"])
        sup = pkg_lifecycle.LifecycleSupervisor(
            q, max_retries=3, backoff_base=0.01, backoff_cap=0.02, seed=0)
        outcomes = []
        for name in errors:
            item = None
            while item is None:  # the backoff re-claims the visibility
                item = q.receive()
                time.sleep(0.01)
            lc = sup.claim(*item)
            outcomes.append((lc.receives, lc.release(
                {"RuntimeError": RuntimeError, "ValueError": ValueError}[
                    name](f"{name} at receive {lc.receives}"))))
            if outcomes[-1][1] == "dead":
                break
        dead = q.dead_letters()
        results.append((outcomes, [(d["body"], d["reason"], d["receives"])
                                   for d in dead], q.stats()))
    assert results[1] == results[0]
    assert results[1][0][-1][1] == "dead"
    counters = telemetry.snapshot()["counters"]
    assert counters["tasks/dead_lettered"] == 1
    assert counters.get("tasks/retried", 0) == len(results[1][0]) - 1


def test_claim_dead_letters_a_crash_loop():
    q = queues.MemoryQueue("loop", visibility_timeout=0.05)
    q.send_messages(["0-4_0-4_0-4"])
    sup = lifecycle.LifecycleSupervisor(q, max_retries=2)
    for _ in range(2):  # two deliveries die without recording a failure
        lc = sup.claim(*q.receive())
        lifecycle._unregister(lc)
        time.sleep(0.1)
    assert sup.claim(*q.receive()) is None
    assert "crash loop" in q.dead_letters()[0]["reason"]


# ---------------------------------------------------------------------------
# ledger
# ---------------------------------------------------------------------------
def test_ledger_written_by_the_jax_package_resumes_the_port(tmp_path):
    ledger_dir = str(tmp_path / "ledger")
    jax_ledger = jax_lifecycle.open_ledger(f"file://{ledger_dir}")
    for body in BODIES[:3]:
        jax_ledger.mark_done(body)
    port_ledger = lifecycle.open_ledger(ledger_dir)
    assert port_ledger.keys() == sorted(BODIES[:3]) and len(port_ledger) == 3
    port_ledger.mark_done(BODIES[3])
    port_ledger.mark_done(BODIES[3])  # idempotent
    assert sorted(os.listdir(ledger_dir)) == sorted(
        f"{b}.done" for b in BODIES[:4])
    assert jax_lifecycle.FileLedger(ledger_dir).keys() == sorted(BODIES[:4])
    # a supervised run over the whole grid skips the four done tasks
    queue = f"file://{tmp_path / 'q'}"
    queues.open_queue(queue).send_messages(BODIES)
    marker = tmp_path / "m" / "done-"
    assert cli.main(["--device", "cpu", "fetch-task-from-queue", "-q", queue,
                     "-r", "0", "--ledger", ledger_dir,
                     "mark-complete", "-p", str(marker),
                     "delete-task-in-queue"]) == 0
    assert sorted(os.listdir(tmp_path / "m")) == sorted(
        f"done-{b}.done" for b in BODIES[4:])
    assert telemetry.snapshot()["counters"]["ledger/skips"] == 4
    assert len(queues.open_queue(queue)) == 0
    assert lifecycle.open_ledger(ledger_dir).keys() == sorted(BODIES)
    memory = lifecycle.open_ledger("memory://x")
    memory.mark_done("a")
    assert lifecycle.open_ledger("memory://x").is_done("a")


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------
def test_lease_renewer_keeps_a_slow_task_claimed():
    q = queues.MemoryQueue("lease", visibility_timeout=0.3)
    q.send_messages(["task"])
    handle, _ = q.receive()
    renewer = lifecycle.LeaseRenewer(q, handle, interval=0.05).start()
    try:
        time.sleep(0.8)
        assert q.receive() is None  # still claimed: renewed
    finally:
        renewer.stop()
    assert renewer.renewals >= 3
    assert telemetry.snapshot()["counters"]["lease/renewals"] >= 3
    time.sleep(0.4)
    assert q.receive()[1] == "task"  # the lease lapsed without renewals


def test_supervisor_heartbeat_holds_every_claim(tmp_path):
    q = queues.FileQueue(str(tmp_path / "q"), visibility_timeout=0.3)
    q.send_messages(["a", "b"])
    sup = lifecycle.LifecycleSupervisor(q, lease_renew=0.05)
    claims = sup.tasks()
    first, second = next(claims), next(claims)
    time.sleep(0.8)
    assert q.receive() is None
    assert telemetry.snapshot()["counters"]["lease/renewals"] >= 6
    first.commit()
    second.commit()
    claims.close()
    assert q.stats() == {"pending": 0, "inflight": 0, "dead": 0,
                         "receives": 0}


# ---------------------------------------------------------------------------
# preemption and surrender
# ---------------------------------------------------------------------------
def test_sigterm_hands_the_in_flight_task_back(tmp_path, monkeypatch):
    """SIGTERM mid-task (the worker runs in the main thread): the task is
    nacked at once with its receive refunded, the run exits with 143."""
    monkeypatch.setenv("CHUNKFLOW_SCHED", "static")
    queue = f"file://{tmp_path / 'q'}"
    queues.open_queue(queue).send_messages(BODIES[:2])

    @operator
    def sigterm(task):
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(1.0)  # the handler raises on the next bytecode
        return task

    _, stages = cli.build_stages(["--device", "cpu", "fetch-task-from-queue",
                                  "-q", queue, "--max-retries", "3",
                                  "-r", "0"])
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        process_stream(stages + [sigterm(_name="sigterm")])
    assert exc.value.code == 143
    assert signal.getsignal(signal.SIGTERM) == previous
    assert queues.open_queue(queue).stats() == {
        "pending": 2, "inflight": 0, "dead": 0, "receives": 0}
    assert telemetry.snapshot()["counters"]["tasks/preempted"] == 1


def _breaker(runtime_operator):
    """An operator that waits until the upstream executor holds claimed
    tasks, then ends the run as a preemption would."""

    @runtime_operator
    def stage(task):
        time.sleep(0.5)
        raise KeyboardInterrupt

    return stage(_name="breaker")


def _jax_stages(queue, holder):
    fetch = jax_cli.fetch_task_cmd.callback(
        queue_name=queue, visibility_timeout=1800, retry_times=0,
        poll_interval=None, num=-1, max_retries=3, lease_renew=0.0,
        ledger=None, backoff_base=0.5, backoff_cap=60.0)
    hold = jax_cli.prefetch_cmd.callback(depth=3, to_device=False)
    return [fetch, hold, _breaker(jax_runtime.operator)]


def _port_stages(queue, holder):
    argv = ["--device", "cpu", "fetch-task-from-queue", "-q", queue,
            "--max-retries", "3", "-r", "0"]
    if holder == "prefetch":
        argv += ["prefetch", "--depth", "3"]
    else:  # the adaptive executor's own prefetch queue and ring
        argv += ["create-chunk", "--size", "4", "8", "8", "inference",
                 "-f", "identity", "-p", "4", "8", "8", "-c", "1",
                 "--async-depth", "2", "--prefetch-depth", "3"]
    return cli.build_stages(argv)[1] + [_breaker(operator)]


@pytest.mark.parametrize("holder", ["prefetch", "scheduler"])
def test_a_broken_chain_surrenders_every_claimed_task(tmp_path, holder):
    """The chain dies while an executor's thread holds claimed tasks:
    afterwards every task is visible in the queue again and no receive
    is charged, as in the JAX package on the same sequence."""
    stats = {}
    for name in ("jax", "port"):
        if name == "jax" and holder != "prefetch":
            continue  # the JAX stages are built from its CLI's prefetch
        queue = f"file://{tmp_path / name}"
        queues.open_queue(queue).send_messages(BODIES)
        build, run = ((_jax_stages, jax_runtime.process_stream)
                      if name == "jax" else
                      (_port_stages, process_stream))
        with pytest.raises(KeyboardInterrupt):
            run(build(queue, holder))
        time.sleep(0.2)  # a prefetch thread's last claim is handed back
        stats[name] = queues.open_queue(queue).stats()
    want = {"pending": len(BODIES), "inflight": 0, "dead": 0, "receives": 0}
    assert all(s == want for s in stats.values()), stats
    assert not lifecycle.inflight()
    counters = telemetry.snapshot()["counters"]
    assert counters["tasks/preempted"] + counters.get(
        "tasks/surrendered", 0) >= 2


def test_a_failed_task_is_charged_and_the_chain_rebuilt(tmp_path):
    """A transient failure mid-run: the culprit retries with backoff, the
    tasks the executor held surrender, the chain is built again and the
    queue drains with every task committed once."""
    queue = f"file://{tmp_path / 'q'}"
    queues.open_queue(queue).send_messages(BODIES)
    failed = []

    @operator
    def flaky(task):
        if not failed:
            failed.append(task["task_body"])
            raise OSError("storage blip")
        return task

    _, stages = cli.build_stages([
        "--device", "cpu", "fetch-task-from-queue", "-q", queue,
        "--max-retries", "3", "-r", "20", "--poll-interval", "0.05",
        "--backoff-base", "0.05", "--backoff-cap", "0.1",
        "prefetch", "--depth", "2"])
    commit = cli.build_stages(["delete-task-in-queue"])[1]
    assert process_stream(stages + [flaky(_name="flaky")] + commit) == \
        len(BODIES)
    counters = telemetry.snapshot()["counters"]
    assert counters["pipeline/chain_rebuilds"] == 1
    assert counters["tasks/retried"] == 1
    assert counters["tasks/committed"] == len(BODIES)
    assert queues.open_queue(queue).stats()["pending"] == 0


# ---------------------------------------------------------------------------
# chaos plans (tests/testing/test_chaos.py), struck alike in both packages
# ---------------------------------------------------------------------------
def _strikes(module, spec, points):
    module.configure(spec)
    out = []
    for point in points:
        try:
            module.chaos_point(point)
            out.append(False)
        except module.ChaosError:
            out.append(True)
    return out, module.injections()


@pytest.mark.parametrize("spec, points", [
    ("once=a/b,c/d", ["a/b", "a/b", "c/d", "c/d", "x/y"]),
    ("seed=42:rate=0.5:points=op/*", ["op/load-h5"] * 32),
    ("seed=1:rate=1.0:points=op/*", ["lifecycle/claim", "op/save-h5"]),
    ("seed=1:rate=1.0:points=op/*:max=2", ["op/x"] * 4),
    ("seed=7:rate=0.5:points=lifecycle/claim,op/*:max=3",
     ["lifecycle/claim", "op/a", "op/b"] * 6),
])
def test_chaos_plans_strike_as_the_jax_package(spec, points):
    got = _strikes(chaos, spec, points)
    assert got == _strikes(jax_chaos, spec, points)
    assert any(got[0])


def test_chaos_inactive_env_and_bad_specs(monkeypatch):
    assert not chaos.active()
    chaos.chaos_point("lifecycle/claim")
    assert chaos.injections() == {}
    monkeypatch.setenv("CHUNKFLOW_CHAOS", "once=env/point")
    with pytest.raises(chaos.ChaosError):
        chaos.chaos_point("env/point")
    chaos.configure(None)  # detached from the environment
    chaos.chaos_point("env/point")
    with pytest.raises(ValueError, match="bad CHUNKFLOW_CHAOS field"):
        chaos.configure("bogus=1")
    with pytest.raises(ValueError, match="bad CHUNKFLOW_CHAOS action"):
        chaos.configure("once=a/b:action=explode")
    assert lifecycle.classify_error(chaos.ChaosError("c")) == "transient"


def test_chaos_kill_is_a_sigkill():
    prog = ("from chunkflow_tpu_torch.testing import chaos\n"
            "chaos.configure('once=op/x:action=kill')\n"
            "chaos.chaos_point('op/other')\n"
            "try:\n"
            "    chaos.chaos_point('op/x')\n"
            "finally:\n"
            "    print('FINALLY RAN')\n")
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=60,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode in (-9, 137), (proc.returncode, proc.stderr)
    assert "FINALLY RAN" not in proc.stdout


def test_num_caps_a_run_across_rebuilds(tmp_path):
    """--num counts claimed tasks over the whole run, not per chain."""
    queue = f"file://{tmp_path / 'q'}"
    queues.open_queue(queue).send_messages(BODIES)
    assert cli.main(["--device", "cpu", "fetch-task-from-queue", "-q", queue,
                     "--max-retries", "3", "--num", "4", "-r", "0",
                     "delete-task-in-queue"]) == 0
    assert queues.open_queue(queue).stats()["pending"] == len(BODIES) - 4
    unsupervised = ["--device", "cpu", "fetch-task-from-queue", "-q", queue,
                    "--num", "1", "-r", "0", "delete-task-in-queue"]
    assert cli.main(unsupervised) == 0
    assert queues.open_queue(queue).stats()["pending"] == len(BODIES) - 5


def test_dead_letter_command_lists_and_requeues(tmp_path, capsys):
    queue = f"file://{tmp_path / 'q'}"
    q = queues.open_queue(queue)
    q.send_messages(["NOT_A_BBOX", BODIES[0]])
    assert cli.main(["--device", "cpu", "fetch-task-from-queue", "-q", queue,
                     "--max-retries", "3", "-r", "0",
                     "delete-task-in-queue"]) == 0
    assert cli.main(["dead-letter", "-q", queue]) == 0
    out = capsys.readouterr().out
    assert "1 dead-letter task(s)" in out and "NOT_A_BBOX" in out
    assert "ValueError" in out
    assert cli.main(["dead-letter", "-q", queue, "--requeue"]) == 0
    assert "requeued 1 task(s)" in capsys.readouterr().out
    assert q.stats()["pending"] == 1 and not q.dead_letters()
    with pytest.raises(NotImplementedError, match="fleet supervisor"):
        cli.main(["fleet-run", "-q", queue])
    assert threading.active_count() >= 1
