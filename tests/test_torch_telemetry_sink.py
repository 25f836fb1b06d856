"""The telemetry sink on the CPU, port against JAX.

Both packages write the same JSONL event stream: span events with their
attributes, a ``snapshot`` event every
``CHUNKFLOW_TELEMETRY_SNAPSHOT_EVERY`` claimed tasks, and a file that
rotates past ``CHUNKFLOW_TELEMETRY_MAX_MB`` into the same generations.
Events are compared by kind, name and attribute keys, in order.
"""
import json
import os

import pytest
import torch

pytest.importorskip("tensorstore")

from chunkflow_tpu.core import telemetry as jax_telemetry
from chunkflow_tpu.parallel import lifecycle as jax_lifecycle
from chunkflow_tpu.parallel import queues as jax_queues
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.parallel import lifecycle
from chunkflow_tpu_torch.parallel import queues
from tests.test_torch_worker import _jax, _port, _run, clean, image  # noqa: F401

torch.set_num_threads(1)

PACKAGES = {"jax": (jax_telemetry, jax_queues, jax_lifecycle),
            "port": (telemetry, queues, lifecycle)}


@pytest.fixture(autouse=True)
def sink_env(monkeypatch):
    for var in ("CHUNKFLOW_TELEMETRY_SNAPSHOT_EVERY",
                "CHUNKFLOW_TELEMETRY_MAX_MB", "CHUNKFLOW_TELEMETRY_KEEP",
                "CHUNKFLOW_WORKER_ID"):
        monkeypatch.delenv(var, raising=False)
    jax_telemetry.reset()
    telemetry.reset()
    yield
    jax_telemetry.reset()
    telemetry.reset()


def _shape(events):
    """(kind, name, attribute keys) per event, in order."""
    return [(e["kind"], e.get("name"),
             tuple(sorted(k for k in e if k != "t"))) for e in events]


#: what the port's span events carry beyond the JAX package's: each
#: span's start ``t0`` and, on the executors' spans, the chunk's id; and
#: the executors' spans the JAX package has not
PORT_SPAN_KEYS = ("t0", "chunk")
PORT_SPANS = ("inference/prepare", "scheduler/wait_result")


def _jax_view(events):
    """The port's events as the JAX package writes them: its own spans and
    span keys left out, once every span is seen to carry its start."""
    out = []
    for e in events:
        if e["kind"] == "span":
            assert e["t0"] <= e["t"]
            if e["name"] in PORT_SPANS:
                continue
            e = {k: v for k, v in e.items() if k not in PORT_SPAN_KEYS}
        out.append(e)
    return out


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _claim_loop(pkg, tmp_path):
    """ROADMAP's fixture: 16 tasks on a ``memory://`` queue, each
    lifecycle committed, the file read before the end-of-run flush."""
    tel, q_mod, lc_mod = PACKAGES[pkg]
    path = tel.configure(str(tmp_path / pkg))
    q = q_mod.open_queue(f"memory://sink-{pkg}-{tmp_path.name}")
    q.retry_sleep = 0.01
    q.send_messages([json.dumps({"i": i}) for i in range(16)])
    for lc in lc_mod.LifecycleSupervisor(q, max_retries=2).tasks():
        lc.commit()
    events = _read(path)
    tel.reset()
    return events


def test_claim_loop_events_are_the_jax_packages(tmp_path):
    jax_events = _claim_loop("jax", tmp_path)
    port_events = _claim_loop("port", tmp_path)
    kinds = [e["kind"] for e in jax_events]
    assert (len(kinds), kinds.count("task"), kinds.count("span"),
            kinds.count("snapshot")) == (82, 48, 32, 2)
    assert _shape(_jax_view(port_events)) == _shape(jax_events)


@pytest.mark.parametrize("every, snapshots", [("0", 0), ("4", 4), ("", 2)])
def test_snapshot_interval(tmp_path, monkeypatch, every, snapshots):
    monkeypatch.setenv("CHUNKFLOW_TELEMETRY_SNAPSHOT_EVERY", every)
    assert telemetry.snapshot_interval() == jax_telemetry.snapshot_interval()
    events = _claim_loop("port", tmp_path)
    assert [e["kind"] for e in events].count("snapshot") == snapshots
    assert _shape(_jax_view(events)) == _shape(_claim_loop("jax", tmp_path))


def test_span_attributes_reach_the_file(tmp_path):
    for tel in (jax_telemetry, telemetry):
        path = tel.configure(str(tmp_path / tel.__name__))
        with tel.span("storage/read", mode="serial") as sp:
            pass
        tel.configure(None)
        (event,) = _read(path)
        assert event["kind"] == "span" and event["mode"] == "serial"
        assert event["dur_s"] == sp.duration
        assert event["pid"] == os.getpid()


def _rotate(tel, directory, lines):
    tel.configure(directory)
    for i in range(lines):
        tel.event("task", "x", pad="p" * 200, i=i)
    tel.configure(None)
    return {name: [json.loads(ln)["i"] for ln in open(os.path.join(
        directory, name))] for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("keep, names", [
    ("", ["", ".1"]),
    ("1", ["", ".2"]),     # the sweep stops at the first missing suffix
    ("3", ["", ".1", ".2"]),
])
def test_rotation_keeps_the_jax_generations(tmp_path, monkeypatch, keep,
                                            names):
    """~250-byte events at a 4 KB limit, with a stale ``.2`` left beside
    the file: each generation holds the same events under the same file
    name in both packages."""
    monkeypatch.setenv("CHUNKFLOW_WORKER_ID", "w0")
    monkeypatch.setenv("CHUNKFLOW_TELEMETRY_MAX_MB", str(4096 / (1 << 20)))
    monkeypatch.setenv("CHUNKFLOW_TELEMETRY_KEEP", keep)
    got = {}
    for tel in (jax_telemetry, telemetry):
        directory = tmp_path / tel.__name__
        directory.mkdir()
        (directory / "telemetry-w0.jsonl.2").write_text("")
        tel.reset()
        got[tel] = _rotate(tel, str(directory), 70)
    assert got[telemetry] == got[jax_telemetry]
    assert sorted(got[telemetry]) == [f"telemetry-w0.jsonl{n}"
                                      for n in names]
    assert got[telemetry]["telemetry-w0.jsonl"][-1] == 69


def _cli_events(directory):
    """The worker's events but the JAX package's XLA compile records
    (``compile`` and ``programs`` events, ``compile_cache/*`` spans),
    which have no counterpart without a compiler."""
    (name,) = [n for n in os.listdir(directory) if n.endswith(".jsonl")]
    return [e for e in _read(os.path.join(directory, name))
            if e["kind"] not in ("compile", "programs")
            and not str(e.get("name")).startswith("compile_cache/")]


def _is_decision(shape) -> bool:
    """An event the adaptive depth controller writes when it widens a
    knob: ``depth_change`` with its ``scheduler/depth/<knob>`` gauge, and
    the ``storage/read_concurrency`` gauge of the ``storage`` knob."""
    kind, name, _keys = shape
    return kind == "depth_change" or (kind == "gauge" and (
        name.startswith("scheduler/depth/")
        or name == "storage/read_concurrency"))


def _decisions_are_well_formed(shape) -> bool:
    """Each ``depth_change`` of a knob comes with one gauge of its depth,
    with the JAX package's attribute keys."""
    changes = [name.split("/")[-1] for kind, name, keys in shape
               if kind == "depth_change"
               and keys == ("dominant", "kind", "name", "new", "old",
                            "share", "tasks", "worker")]
    gauges = [name.split("/")[-1] for kind, name, _ in shape
              if kind == "gauge" and name.startswith("scheduler/depth/")]
    return (sorted(changes) == sorted(gauges)
            and len(changes) == sum(kind == "depth_change"
                                    for kind, _, _ in shape))


@pytest.mark.parametrize("sched", ["static", "adaptive"])
def test_worker_events_through_both_clis(tmp_path, monkeypatch, image,
                                         sched):
    """``tests/test_torch_worker.py``'s worker with ``--metrics-dir``:
    the static executor writes the same events in the same order. The
    adaptive one stages in a producer thread, whose events interleave
    with the dispatching thread's as the threads run, so there the
    events are compared as a multiset; and its depth controller widens a
    knob when one phase's share of the measured time passes its
    threshold, which the two runs' clocks decide apart (on a loaded
    machine one run widens ``post`` and ``write`` where the other does
    not). So the controller's decision events are left out of the
    comparison and held, in each run, to their own form. The port's own
    spans and span keys (``_jax_view``) are left out too."""
    monkeypatch.setenv("CHUNKFLOW_SCHED", sched)
    engine = ["-f", "identity"]
    shapes = {}
    for tag, runner in (("jax", _jax), ("port", _port)):
        metrics = str(tmp_path / f"events-{tag}")
        _run(tmp_path, tag, image, engine, runner, metrics=metrics)
        events = _cli_events(metrics)
        shapes[tag] = _shape(_jax_view(events) if tag == "port" else events)
    if sched == "adaptive":
        assert all(map(_decisions_are_well_formed, shapes.values()))
        shapes = {tag: sorted((s for s in shape if not _is_decision(s)),
                              key=repr)
                  for tag, shape in shapes.items()}
    assert shapes["port"] == shapes["jax"]
