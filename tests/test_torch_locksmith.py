"""The port's lock-order sanitizer (``chunkflow_tpu_torch/testing/
locksmith.py``): every case of ``tests/testing/test_locksmith.py`` on the
port's module, and the port's threads under it.

The suite's conftest installs the JAX package's sanitizer before any
import, and its default scope covers the port's sources too. Each case
here runs with the JAX sanitizer uninstalled and the port's graph fresh
(the ``fresh`` fixture), and reinstalls the JAX one after, so a seeded
inversion is the port's sanitizer's to catch. One case shows the port's
proxies wrap the interpreter's own locks while the JAX sanitizer is
installed; one runs the adaptive stream and the packer under the port's
sanitizer in raise mode.
"""
import _thread
import importlib
import queue
import threading
import time

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.testing import locksmith

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)


def _jax_locksmith():
    """The JAX package's sanitizer module (it imports no JAX)."""
    return importlib.import_module("chunkflow_tpu.testing.locksmith")


def own_violations(rep):
    """Violations whose lock sites live in THIS file: daemon threads of
    earlier tests (packer dispatchers, heartbeats) may still record into
    the global graph while these tests run."""
    return [v for v in rep["violations"]
            if "test_torch_locksmith" in v.get("detail", "")]


@pytest.fixture
def fresh(monkeypatch):
    jax_ls = _jax_locksmith()
    jax_was = jax_ls.installed()
    jax_ls.uninstall()
    was_installed = locksmith.installed()
    locksmith.uninstall()
    locksmith.reset_state()
    monkeypatch.setenv("CHUNKFLOW_LOCKSMITH", "1")
    monkeypatch.delenv("CHUNKFLOW_LOCKSMITH_MODE", raising=False)
    monkeypatch.delenv("CHUNKFLOW_LOCKSMITH_HOLD_MS", raising=False)
    monkeypatch.delenv("CHUNKFLOW_LOCKSMITH_SCOPE", raising=False)
    yield locksmith
    locksmith.uninstall()
    locksmith.reset_state()
    # a case may have turned the switch off: the reinstalls need it on
    monkeypatch.setenv("CHUNKFLOW_LOCKSMITH", "1")
    if was_installed:
        locksmith.install()
    if jax_was:
        jax_ls.install()


def test_detects_seeded_ab_ba_inversion(fresh):
    """Thread 1 takes A then B, thread 2 takes B then A: deterministic
    (sequential threads), no real contention, and the second thread's
    inner acquire must raise BEFORE acquiring."""
    assert fresh.install()
    a = threading.Lock()
    b = threading.Lock()
    caught = []

    def t1():
        with a:
            with b:
                pass

    def t2():
        try:
            with b:
                with a:  # closes the cycle: must raise here
                    pytest.fail("inverted acquire went through")
        except locksmith.LockOrderError as exc:
            caught.append(exc)

    th1 = threading.Thread(target=t1)
    th1.start()
    th1.join(timeout=10)
    th2 = threading.Thread(target=t2)
    th2.start()
    th2.join(timeout=10)
    assert len(caught) == 1
    assert "cycle" in str(caught[0])
    assert not a.locked() and not b.locked()  # clean unwinding
    mine = own_violations(fresh.report())
    assert mine and mine[0]["kind"] == "lock-order-cycle"


def test_transitive_cycle_through_three_locks(fresh):
    fresh.install()
    a, b, c = threading.Lock(), threading.Lock(), threading.Lock()
    caught = []

    def run(first, second):
        def body():
            try:
                with first:
                    with second:
                        pass
            except locksmith.LockOrderError as exc:
                caught.append(exc)
        t = threading.Thread(target=body)
        t.start()
        t.join(timeout=10)

    run(a, b)
    run(b, c)
    run(c, a)  # a -> b -> c -> a
    assert len(caught) == 1


def test_single_thread_both_orders_not_flagged(fresh):
    """One thread running A->B then B->A sequentially cannot deadlock
    against itself."""
    fresh.install()
    a, b = threading.Lock(), threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert own_violations(fresh.report()) == []


def test_rlock_reentrancy_not_flagged(fresh):
    fresh.install()
    r = threading.RLock()
    with r:
        with r:
            with r:
                pass
    assert own_violations(fresh.report()) == []


def test_plain_lock_self_deadlock_detected(fresh):
    fresh.install()
    lk = threading.Lock()
    lk.acquire()
    with pytest.raises(locksmith.LockOrderError, match="re-acquires"):
        lk.acquire()
    lk.release()


def test_proxy_transparency(fresh):
    fresh.install()
    lk = threading.Lock()
    assert lk.acquire(timeout=0.5) is True
    assert lk.locked()
    lk.release()
    assert not lk.locked()
    assert lk.acquire(False) is True  # non-blocking
    lk.release()
    with lk:
        assert lk.locked()
    assert not lk.locked()
    r = threading.RLock()
    with r:
        assert r.acquire(timeout=0.1) is True
        r.release()
    assert own_violations(fresh.report()) == []


def test_condition_wait_notify_across_threads(fresh):
    """Condition over a proxied lock: wait shows as release + reacquire,
    the handoff works, and no violation is recorded."""
    fresh.install()
    cv = threading.Condition()
    shared_cv = threading.Condition(threading.Lock())
    items = []

    def consumer():
        with cv:
            while not items:
                cv.wait(timeout=5)
            items.pop()

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)
    with cv:
        items.append(1)
        cv.notify()
    t.join(timeout=10)
    assert not t.is_alive()
    with shared_cv:  # plain-lock condition path
        assert shared_cv.wait(timeout=0.01) is False
    assert own_violations(fresh.report()) == []


@pytest.mark.parametrize("value", ["0", None], ids=["0", "unset"])
def test_kill_switch_creates_no_proxies(fresh, monkeypatch, value):
    if value is None:
        monkeypatch.delenv("CHUNKFLOW_LOCKSMITH")
    else:
        monkeypatch.setenv("CHUNKFLOW_LOCKSMITH", value)
    sites = len(locksmith._registry.lock_sites)
    assert locksmith.install() is False
    assert threading.Lock is locksmith._ORIG_LOCK
    assert threading.Condition is locksmith._ORIG_CONDITION
    lk = threading.Lock()
    assert not hasattr(lk, "_ls_id")
    assert not locksmith.installed()
    # no proxy, no state
    assert len(locksmith._registry.lock_sites) == sites


def test_out_of_scope_construction_gets_real_locks(fresh):
    # stdlib frames (queue.Queue internals) must never be proxied
    fresh.install()
    q = queue.Queue()
    assert not hasattr(q.mutex, "_ls_id")
    lk = threading.Lock()  # this file IS in scope (tests/)
    assert hasattr(lk, "_ls_id")


def test_hold_ceiling_records_violation(fresh, monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_LOCKSMITH_HOLD_MS", "10")
    fresh.install()
    lk = threading.Lock()
    with lk:
        time.sleep(0.05)
    mine = [h for h in fresh.report()["hold_violations"]
            if "test_torch_locksmith" in h["lock"]]
    assert mine
    assert mine[0]["held_s"] >= 0.01


def test_log_mode_records_without_raising(fresh, monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_LOCKSMITH_MODE", "log")
    fresh.install()
    a, b = threading.Lock(), threading.Lock()

    def order(first, second):
        def body():
            with first:
                with second:
                    pass
        t = threading.Thread(target=body)
        t.start()
        t.join(timeout=10)

    order(a, b)
    order(b, a)  # would raise in raise mode; log mode records
    assert len(own_violations(fresh.report())) == 1


def test_report_and_publish_counters(fresh):
    fresh.install()
    telemetry.reset()
    lk = threading.Lock()
    with lk:
        pass
    rep = fresh.report()
    assert rep["enabled"] and rep["locks"] >= 1 and rep["acquires"] >= 1
    locksmith.publish()
    gauges = telemetry.snapshot()["gauges"]
    assert gauges["locksmith/locks"] >= 1
    assert gauges["locksmith/acquires"] >= 1
    telemetry.reset()


def test_thread_tokens_never_reused(fresh):
    """``threading.get_ident()`` is recycled after a thread exits, which
    would make two sequential threads look like one and hide a genuine
    inversion. The registry's own tokens are monotonic and never
    reused."""
    fresh.install()
    tokens = []

    def grab():
        tokens.append(locksmith._registry._thread_token())

    for _ in range(3):
        t = threading.Thread(target=grab)
        t.start()
        t.join(timeout=10)
    assert len(set(tokens)) == 3


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------
def test_proxies_wrap_interpreter_locks_not_the_jax_sanitizer(monkeypatch):
    """With the JAX sanitizer installed (as the suite's conftest leaves
    it), the port's sanitizer wraps ``_thread`` locks and a real
    ``Condition``, not JAX proxies, and its uninstall hands the JAX
    factories back."""
    jax_ls = _jax_locksmith()
    monkeypatch.setenv("CHUNKFLOW_LOCKSMITH", "1")
    jax_was = jax_ls.installed()
    assert jax_ls.install()
    jax_factories = (threading.Lock, threading.RLock, threading.Condition)
    assert hasattr(threading.Lock(), "_ls_id")  # a JAX proxy, this file
    locksmith.uninstall()
    locksmith.reset_state()
    try:
        assert locksmith.install()
        lk, rl, cv = threading.Lock(), threading.RLock(), threading.Condition()
        assert isinstance(lk, locksmith._LockProxy)
        assert type(lk._inner) is type(_thread.allocate_lock())
        assert isinstance(rl, locksmith._RLockProxy)
        assert type(rl._inner) is _thread.RLock
        assert type(cv) is locksmith._ORIG_CONDITION
        assert isinstance(cv._lock, locksmith._RLockProxy)
        assert type(cv._lock._inner) is _thread.RLock
        with lk, cv:
            pass
        assert locksmith.report()["acquires"] >= 2
    finally:
        locksmith.uninstall()
        locksmith.reset_state()
    assert (threading.Lock, threading.RLock, threading.Condition) \
        == jax_factories
    if not jax_was:
        jax_ls.uninstall()


def test_stream_and_packer_under_the_sanitizer(fresh, monkeypatch):
    """The adaptive stream over three identity chunks and the packer fed
    by four submitting threads, under the port's sanitizer in raise
    mode: bitwise the serial results, and no violation anywhere."""
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.serve import PatchPacker

    monkeypatch.setenv("CHUNKFLOW_LOCKSMITH_MODE", "raise")
    monkeypatch.setenv("CHUNKFLOW_SCHED", "adaptive")
    assert fresh.install()
    inf = Inferencer((4, 16, 16), output_patch_overlap=(2, 8, 8),
                     num_output_channels=3, framework="identity",
                     batch_size=2, crop_output_margin=False, device="cpu")
    rng = np.random.default_rng(5)
    chunks = [Chunk(rng.random((8, 32, 32), dtype=np.float32))
              for _ in range(3)]
    serial = [np.asarray(inf(c).host().array) for c in chunks]
    streamed = [np.asarray(c.array) for c in inf.stream(iter(chunks))]
    assert all(np.array_equal(a, b) for a, b in zip(streamed, serial))

    requests = [Chunk(rng.random((8, 24 + 8 * (i % 2), 32),
                                 dtype=np.float32)) for i in range(8)]
    expected = [np.asarray(inf(c).host().array) for c in requests]
    packer = PatchPacker(inf, max_wait_ms=2.0)
    results = [None] * len(requests)

    def submit(k):
        for i in range(k, len(requests), 4):
            out = packer.submit(requests[i]).result(timeout=60)
            results[i] = np.asarray(out.host().array)

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    packer.close()
    assert all(np.array_equal(a, b) for a, b in zip(results, expected))
    rep = locksmith.report()
    assert rep["violations"] == []
    assert rep["locks"] > 0 and rep["acquires"] > 0
