"""``BENCHMARK.json`` against the format rules of a benchmark manifest,
and a cell, a configuration, a traffic mix and a per-layer metric added
as new files alone."""
import hashlib
import json
import re

import harness
import tiny
from tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keeps_its_format():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    m = json.loads(raw)
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert 1 <= len(m["command"]) <= 32 and all(line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    configs = {c["name"]: c for c in m["configs"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    cells = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
        cells.add(w["name"])
    assert len(cells) == len(m["workloads"])
    assert {(w["config"], w["traffic"]) for w in m["workloads"]}.__len__() \
        == len(m["workloads"])
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
        assert set(metric.get("workloads", [])) <= cells
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert p["moves"] in e2e and line(p["layer"])
    for name in cells:
        cell = harness.Cell(name)
        reported = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert all(p["moves"] in reported for p in cell.per_layer)


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    root = tiny.make(tmp_path)
    bench = root / "portbench"
    before = _digests(root)
    cfg = json.loads((bench / "configs" / "rsunet-bf16.json").read_text())
    cfg.update(name="rsunet-f32", compute_dtype="float32")
    (bench / "configs" / "rsunet-f32.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "stream.json").read_text())
    traffic.update(chunk=[8, 96, 64], pool=3)
    (bench / "traffic" / "stream-wide.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "rsunet-f32.stream-wide.json").write_text(
        json.dumps({"sample": 1,
                    "limits": {"mean_abs_gap": 1e-5, "max_abs_gap": 1e-4}}))
    (bench / "metrics" / "tasks_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.tasks)\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "rsunet-f32", "source": "https://arxiv.org/abs/1706.00120",
        "file": "portbench/configs/rsunet-f32.json", "reduced": [],
        "why": "float32"})
    manifest["workloads"].append({
        "name": "rsunet-f32.stream-wide", "config": "rsunet-f32",
        "traffic": "stream-wide", "chips": 1, "why": "wider chunks"})
    manifest["per_layer"].append({
        "name": "tasks_in_window", "unit": "tasks", "better": "higher",
        "source": "host_clock", "layer": "the whole step", "moves": "mvox_s",
        "workloads": ["rsunet-f32.stream-wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.Cell("rsunet-f32.stream-wide", root, bench)
    traced = harness.execute(cell, 7, 1.0, True, device="cpu",
                             tmp_root=str(tmp_path))
    plain = harness.execute(cell, 7, 1.0, False, device="cpu",
                            tmp_root=str(tmp_path))
    assert traced["metrics"]["tasks_in_window"]["value"] > 0
    assert traced["metrics"]["tasks_in_window"]["unit"] == "tasks"
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert plain["correct"] and traced["correct"], plain["checked"]
    # 8x96x64 chunks: their voxels, not the first cell's
    assert plain["metrics"]["mvox_s"]["value"] > 0
    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {root / "BENCHMARK.json"}
