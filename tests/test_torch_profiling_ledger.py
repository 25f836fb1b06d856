"""The port's program cost ledger and roofline (``chunkflow_tpu_torch/
core/profiling.py``), on the CPU.

The counterparts of ``tests/core/test_profiling.py``'s ledger cases (a
family's first call recorded, attribute forwarding, the peak table and
its env overrides, the DEVICE PROGRAMS table and its lost-seconds
ranking, a stamp, the counters through the CloudWatch plugin, the kill
switch); the kernels' analytic costs against the JAX functions' FLOPs
and the work's bytes; an identity and a small UNet3D run whose
``programs.json`` both packages' ``log-summary`` read; and a ``data=2``
mesh on two CPU devices with its collective-vs-compute split gauges.
JAX is imported only inside the cases that compare with it.
"""
import importlib
import json

import numpy as np
import pytest
import torch

import chip_smoke
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.core import profiling, telemetry
from chunkflow_tpu_torch.inference import engines
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.inference.patching import (
    enumerate_patches,
    pad_to_batch,
)
from chunkflow_tpu_torch.models.unet3d import UNet3D
from chunkflow_tpu_torch.ops import accumulate, blend, gather

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (4, 16, 16)
OVERLAP = (2, 8, 8)
IDENTITY = dict(input_patch_size=PIN, output_patch_overlap=OVERLAP,
                num_output_channels=3, framework="identity", batch_size=2,
                crop_output_margin=False, device="cpu")


@pytest.fixture
def clean_plane(monkeypatch):
    for var in ("CHUNKFLOW_TELEMETRY", "CHUNKFLOW_PEAK_FLOPS",
                "CHUNKFLOW_PEAK_BW", "CHUNKFLOW_MESH", "CHUNKFLOW_BLEND"):
        monkeypatch.delenv(var, raising=False)
    telemetry.reset()  # the reset hook clears the ledger
    yield monkeypatch
    telemetry.reset()


def _chunks(n, shape=(8, 32, 32), seed=0):
    rng = np.random.default_rng(seed)
    return [Chunk(rng.random(shape, dtype=np.float32)) for _ in range(n)]


def _unet_inferencer(**extra):
    torch.manual_seed(0)
    model = UNet3D(in_channels=1, out_channels=3, feature_maps=(4, 6, 8),
                   down_factors=((1, 2, 2), (2, 2, 2))).eval()
    engine = engines.Engine(apply=model, num_input_channels=1,
                            num_output_channels=3, model=model)
    kwargs = dict(IDENTITY, framework="prebuilt", engine=engine)
    kwargs.update(extra)
    return Inferencer(**kwargs), model


# ---------------------------------------------------------------------------
# the JAX ledger cases' counterparts
# ---------------------------------------------------------------------------
def test_scatter_family_records_cost_ledger_entry(clean_plane, tmp_path):
    """A family's first call is recorded: compile seconds, the analytic
    FLOPs and bytes, the calls, the roofline, the ``program/*`` counters,
    ``programs.json``, the ``compile`` and ``programs`` events and
    ``/metrics``."""
    telemetry.configure(str(tmp_path))
    inferencer = Inferencer(**IDENTITY)
    for chunk in _chunks(2):
        inferencer(chunk)

    entries = profiling.catalog()
    assert len(entries) == 1
    entry = entries[0]
    assert entry["family"] == "scatter"
    assert entry["key"] == "(8, 32, 32)"
    assert entry["compile_s"] > 0
    assert entry["flops"] > 0  # the accumulate's weighting
    assert entry["bytes_accessed"] > 0
    assert entry["vmem_bytes"] is None
    assert entry["calls"] == 2
    assert entry["platform"] == "cpu" and entry["device_kind"] == "cpu"
    assert entry["roofline_s"] > 0
    assert entry["roofline_util"] is not None
    assert entry["peak_source"] == "table:cpu"

    counters = telemetry.snapshot()["counters"]
    assert counters["program/builds"] == 1
    assert counters["program/compile_seconds"] > 0
    assert counters["program/flops_total"] == entry["flops"]

    telemetry.flush()
    payload = json.loads((tmp_path / "programs.json").read_text())
    assert payload["programs"][0]["family"] == "scatter"

    kinds = {}
    with open(telemetry.configured_path()) as f:
        for line in f:
            record = json.loads(line)
            kinds.setdefault(record["kind"], []).append(record)
    assert len(kinds["compile"]) == 1
    compile_ev = kinds["compile"][0]
    assert compile_ev["name"] == "program/scatter"
    assert compile_ev["compile_s"] > 0
    assert kinds["programs"][0]["programs"]

    from chunkflow_tpu_torch.parallel.restapi import (
        parse_prometheus,
        render_prometheus,
    )

    metrics = parse_prometheus(render_prometheus())
    assert metrics["chunkflow_program_builds_total"] == 1
    assert metrics["chunkflow_program_compile_seconds_total"] > 0
    assert metrics["chunkflow_program_flops_total_total"] == entry["flops"]
    telemetry.configure(None)


def test_instrument_program_passthrough_for_non_programs(clean_plane):
    """Non-callables pass through untouched; the port wraps any callable
    (it has no jit programs to recognise), and the wrapper calls it."""
    assert profiling.instrument_program("tag", ("k",)) == "tag"
    assert profiling.catalog() == []
    wrapped = profiling.instrument_program(lambda: 1, ("k",))
    assert wrapped() == 1
    assert [e["family"] for e in profiling.catalog()] == ["k"]


def test_instrumented_program_forwards_attributes(clean_plane):
    def program(x):
        return x * 2

    program.geometry = (8, 16, 16)
    wrapped = profiling.instrument_program(program, ("fold", (8, 16, 16)),
                                           label="t")
    out = wrapped(torch.ones((4, 4)))
    assert float(out[0, 0]) == 2.0
    assert wrapped.geometry == (8, 16, 16)  # attribute access forwards
    entry = profiling.catalog()[0]
    assert entry["family"] == "fold"
    assert entry["key"] == "(8, 16, 16)"


def test_device_peaks_env_override_and_table(monkeypatch):
    monkeypatch.delenv("CHUNKFLOW_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("CHUNKFLOW_PEAK_BW", raising=False)
    h100 = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["flops_per_s"] == 989e12 and h100["bytes_per_s"] == 3.35e12
    assert h100["source"] == "table:h100"
    assert profiling.device_peaks("weird accelerator")["source"] \
        == "fallback"
    assert profiling.device_peaks("cpu")["source"] == "table:cpu"
    # the port's table holds the card and the host, no TPU
    assert [row[0] for row in profiling.DEVICE_PEAKS] == ["h100", "cpu"]
    assert profiling.device_peaks("TPU v5 lite")["source"] == "fallback"
    monkeypatch.setenv("CHUNKFLOW_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("CHUNKFLOW_PEAK_BW", "2e11")
    got = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert got == {"flops_per_s": 1e12, "bytes_per_s": 2e11,
                   "source": "env"}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_log_summary_renders_device_programs_table(pkg, clean_plane,
                                                   tmp_path, capsys):
    log_summary = importlib.import_module(
        ("chunkflow_tpu" if pkg == "jax" else "chunkflow_tpu_torch")
        + ".flow.log_summary")
    events = [
        {"kind": "compile", "name": "program/fold", "family": "fold",
         "key": "(8, 32, 32)", "compile_s": 0.5, "flops": 2e9,
         "bytes_accessed": 3e8, "device": "cpu", "worker": "w1",
         "t": 1.0},
        {"kind": "programs", "name": "program/catalog", "worker": "w1",
         "t": 2.0, "programs": [
             {"family": "fold", "key": "(8, 32, 32)", "compile_s": 0.5,
              "flops": 2e9, "bytes_accessed": 3e8, "exec_mean_s": 0.01,
              "roofline_util": 0.42, "device_kind": "cpu"},
             {"family": "scatter", "key": "", "compile_s": 0.2,
              "flops": 1e9, "bytes_accessed": 1e8, "exec_mean_s": 0.02,
              "roofline_util": 0.04, "device_kind": "cpu"},
         ]},
    ]
    programs = log_summary.summarize_programs(events)
    # the catalog event wins over raw compile events for the same worker
    assert len(programs) == 2
    assert programs[0]["family"] == "fold"  # sorted by compile_s
    assert programs[0]["roofline_util"] == 0.42

    with open(tmp_path / "telemetry-w1.jsonl", "w") as f:
        for record in events:
            f.write(json.dumps(record) + "\n")
    log_summary.print_telemetry_summary(str(tmp_path))
    out = capsys.readouterr().out
    assert "device programs" in out
    assert "fold" in out and "scatter" in out
    assert "42.0%" in out


def test_device_programs_rank_by_lost_seconds(clean_plane):
    from chunkflow_tpu_torch.flow.log_summary import summarize_programs

    events = [
        {"kind": "programs", "name": "program/catalog", "worker": "w1",
         "t": 2.0, "programs": [
             {"family": "fold", "key": "", "compile_s": 9.0,
              "exec_mean_s": 0.010, "roofline_s": 0.009,
              "lost_s": 0.01, "roofline_util": 0.9},
             {"family": "scatter", "key": "", "compile_s": 0.2,
              "exec_mean_s": 0.050, "roofline_s": 0.005,
              "lost_s": 4.5, "roofline_util": 0.1},
             {"family": "mystery", "key": "", "compile_s": 1.0},
         ]},
    ]
    programs = summarize_programs(events)
    assert [p["family"] for p in programs] == \
        ["scatter", "fold", "mystery"]


def test_stamp_cost_wins_over_the_count(clean_plane, tmp_path):
    """A stamp's fields are what the ledger scores; lost_s derives from
    them."""
    telemetry.configure(str(tmp_path))
    try:
        cache = {}
        program = profiling.cached_program(
            cache, ("stamped_family",),
            lambda: profiling.stamp_cost(lambda x: x * 2.0, flops=123.0,
                                         bytes_accessed=4.5e8))
        program(torch.ones(4))
        program(torch.ones(4))
        entry = {e["family"]: e for e in profiling.catalog()}[
            "stamped_family"]
        assert entry["flops"] == 123.0
        assert entry["bytes_accessed"] == 4.5e8
        assert entry["roofline_s"] is not None
        assert entry["lost_s"] is not None and entry["lost_s"] >= 0.0
        assert cache[("stamped_family",)] is program
    finally:
        telemetry.flush()
        telemetry.configure(None)


def test_program_counters_reach_cloud_watch(clean_plane):
    from chunkflow_tpu_torch.plugins.aws.cloud_watch import (
        snapshot_metric_data,
    )

    telemetry.inc("program/builds", 2)
    telemetry.inc("program/compile_seconds", 1.5)
    telemetry.inc("transfer/h2d_bytes", 4096)
    data = {d["MetricName"]: d for d in snapshot_metric_data()}
    assert data["program/builds"]["Value"] == 2
    assert data["program/builds"]["Unit"] == "Count"
    assert data["program/compile_seconds"]["Unit"] == "Seconds"
    assert data["transfer/h2d_bytes"]["Value"] == 4096


def test_kill_switch_creates_nothing(tmp_path, monkeypatch):
    """``CHUNKFLOW_TELEMETRY=0``: no wrapper, no record, no counter, no
    file, however the families run."""
    monkeypatch.setenv("CHUNKFLOW_TELEMETRY", "0")
    telemetry.reset()
    try:
        def program(x):
            return x + 1

        assert profiling.instrument_program(program, ("a",)) is program
        cache = {}
        assert profiling.cached_program(cache, ("a",),
                                        lambda: program) is program
        inferencer = Inferencer(**IDENTITY)
        inferencer(_chunks(1)[0])
        profiling.note_h2d(1024, key=("scatter",))
        profiling.note_collective(1024, key=("shard",))
        profiling.note_hbm_intermediate(1024, key=("serve_forward",))
        assert profiling.catalog() == []
        assert profiling.h2d_by_family() == {}
        assert profiling.write_catalog(str(tmp_path)) is None
        assert list(tmp_path.iterdir()) == []
        assert telemetry.snapshot()["counters"] == {}
    finally:
        monkeypatch.delenv("CHUNKFLOW_TELEMETRY")
        telemetry.reset()


# ---------------------------------------------------------------------------
# the kernels' analytic costs
# ---------------------------------------------------------------------------
MAIN_PATH = dict(chunk=(64, 512, 512), pin=(20, 256, 256),
                 overlap=(4, 64, 64), B=2, ci=1, co=3)


def _first_batch(chunk, pin, overlap, B):
    grid = enumerate_patches(chunk, pin, pin, overlap)
    _, out_starts, _ = pad_to_batch(grid, B)
    return out_starts[:B]


@pytest.mark.parametrize("B, ci, co, pin, dtype", [
    (2, 1, 3, (20, 256, 256), "uint8"),
    (2, 1, 3, (4, 16, 16), "float32"),
    (3, 2, 1, (2, 8, 12), "uint16"),
])
def test_cost_functions_flops_are_the_jax_functions(B, ci, co, pin, dtype):
    from chunkflow_tpu.ops import blend as jax_blend
    from chunkflow_tpu.ops import pallas_blend, pallas_gather

    assert gather.gather_kernel_cost(B, ci, pin, dtype)["flops"] \
        == pallas_gather.gather_kernel_cost(B, ci, pin, dtype)["flops"]
    assert accumulate.fused_kernel_cost(B, co, pin)["flops"] \
        == pallas_blend.fused_kernel_cost(B, co, pin)["flops"]
    port = blend.pipeline_kernel_cost(B, ci, co, pin, pin, dtype)
    ref = jax_blend.pipeline_kernel_cost(B, ci, co, pin, pin, dtype)
    assert port["flops"] == ref["flops"]
    assert port["hbm_intermediate_bytes"] == ref["hbm_intermediate_bytes"]
    assert port["vmem_bytes"] is None


def test_cost_functions_bytes_are_the_work():
    """Each input byte read once and each output byte written once, as
    the bounds of PERF.md's kernel table count them: 13.1 MB for the
    gather and 110.1 MB for the accumulate at the main path's shape
    (the first batch's two windows overlap by 64 in x)."""
    m = MAIN_PATH
    P = int(np.prod(m["pin"]))
    g = gather.gather_kernel_cost(m["B"], m["ci"], m["pin"], "uint8")
    assert g["bytes_accessed"] == m["B"] * P * (1 + 4) + m["B"] * 3 * 4
    assert round(g["bytes_accessed"] / 1e6, 1) == 13.1
    starts = _first_batch(m["chunk"], m["pin"], m["overlap"], m["B"])
    covered = accumulate.covered_cells(starts, m["pin"])
    assert covered == 2 * P - m["pin"][0] * m["pin"][1] * 64
    a = accumulate.fused_kernel_cost(m["B"], m["co"], m["pin"], covered)
    assert a["bytes_accessed"] == (
        (m["B"] * m["co"] * P + P + m["B"]) * 4 + m["B"] * 3 * 4
        + 2 * (m["co"] + 1) * covered * 4)
    assert round(a["bytes_accessed"] / 1e6, 1) == 110.1
    # disjoint windows by default
    assert accumulate.fused_kernel_cost(2, 3, (2, 4, 4))["bytes_accessed"] \
        == (6 * 32 + 32 + 2) * 4 + 24 + 2 * 4 * 64 * 4


def test_covered_cells_is_the_union_volume():
    rng = np.random.default_rng(11)
    pout = (3, 5, 4)
    for _ in range(20):
        starts = rng.integers(0, 6, size=(int(rng.integers(1, 6)), 3))
        grid = np.zeros((12, 12, 12), dtype=bool)
        for z, y, x in starts:
            grid[z:z + pout[0], y:y + pout[1], x:x + pout[2]] = True
        assert accumulate.covered_cells(starts, pout) == int(grid.sum())


# ---------------------------------------------------------------------------
# port runs: programs.json through both log-summaries, the mesh split
# ---------------------------------------------------------------------------
def test_unet_scatter_flops_are_the_layers_and_the_kernels(clean_plane):
    """The scatter family's FLOPs: the convolutions counted from the
    layers' shapes (``chip_smoke.conv_flops`` on one batch, times the
    batches) plus the kernels' analytic FLOPs; the stamp carries the JAX
    inter-stage formula."""
    inferencer, model = _unet_inferencer()
    chunk = _chunks(1, seed=3)[0]
    inferencer(chunk)
    (entry,) = profiling.catalog()
    grid = enumerate_patches((8, 32, 32), PIN, PIN, OVERLAP)
    in_starts, out_starts, _ = pad_to_batch(grid, 2)
    n_batches = len(in_starts) // 2
    per_batch = chip_smoke.conv_flops(model, torch.zeros((2, 1) + PIN))
    kernels = sum(
        gather.gather_kernel_cost(2, 1, PIN, "float32")["flops"]
        + accumulate.fused_kernel_cost(2, 3, PIN)["flops"]
        for _ in range(n_batches))
    assert entry["flops"] == n_batches * per_batch + kernels
    step = blend.pipeline_kernel_cost(2, 1, 3, PIN, PIN)
    assert entry["hbm_intermediate_bytes"] == \
        n_batches * step["hbm_intermediate_bytes"]


@pytest.mark.parametrize("net", ["identity", "unet"])
def test_port_run_programs_json_read_by_both_log_summaries(net, clean_plane,
                                                           tmp_path,
                                                           capsys):
    from chunkflow_tpu.flow import log_summary as jax_log_summary
    from chunkflow_tpu_torch.flow import log_summary

    clean_plane.setenv("CHUNKFLOW_WORKER_ID", f"port-{net}")
    telemetry.configure(str(tmp_path))
    inferencer = (Inferencer(**IDENTITY) if net == "identity"
                  else _unet_inferencer()[0])
    fold = Inferencer(**dict(IDENTITY, blend="fold"))
    for chunk in _chunks(2, seed=4):
        inferencer(chunk)
        fold(chunk)
    telemetry.flush()
    telemetry.configure(None)
    payload = json.loads((tmp_path / "programs.json").read_text())
    families = sorted(e["family"] for e in payload["programs"])
    assert families == ["fold", "scatter"]
    assert all(e["calls"] == 2 for e in payload["programs"])

    printed = {}
    for pkg, mod in (("port", log_summary), ("jax", jax_log_summary)):
        mod.print_telemetry_summary(str(tmp_path))
        printed[pkg] = capsys.readouterr().out
        assert "device programs" in printed[pkg]
        assert "scatter" in printed[pkg] and "fold" in printed[pkg]
    # the catalog each reads is the file's entries, rendered alike
    event = [{"kind": "programs", "name": "program/catalog",
              "worker": payload["worker"], "t": payload["t"],
              "programs": payload["programs"]}]
    assert log_summary.summarize_programs(event) \
        == jax_log_summary.summarize_programs(event)
    for pkg, mod in (("port", log_summary), ("jax", jax_log_summary)):
        mod.print_program_summary(mod.summarize_programs(event))
        table = capsys.readouterr().out
        assert table and table in printed[pkg]


def test_data_mesh_records_the_collective_split(clean_plane):
    """``data=2`` over two CPU devices: the ``shard`` family's record and
    the split gauges, from the dispatch's counted FLOPs and its analytic
    all_gather bytes."""
    inferencer, _ = _unet_inferencer(mesh="data=2")
    inferencer._mesh = [torch.device("cpu")] * 2
    chunk = _chunks(1, seed=6)[0]
    mesh_out = inferencer(chunk)
    one = _unet_inferencer()[0](chunk)
    assert torch.equal(torch.as_tensor(mesh_out.array),
                       torch.as_tensor(one.array))
    entries = [e for e in profiling.catalog() if e["family"] == "shard"]
    assert len(entries) == 1 and entries[0]["flops"] > 0
    assert entries[0]["key"].startswith("data,2,(1, 8, 32, 32)")
    assert entries[0]["collective_bytes"] > 0
    gauges = telemetry.snapshot()["gauges"]
    flops, nbytes = entries[0]["flops"], entries[0]["collective_bytes"]
    peaks = profiling.device_peaks("cpu")
    assert gauges["shard/compute_s_est"] == flops / peaks["flops_per_s"]
    assert gauges["shard/collective_s_est"] == \
        nbytes / peaks["bytes_per_s"]
    assert 0.0 < gauges["shard/collective_share_est"] < 1.0
    counters = telemetry.snapshot()["counters"]
    assert counters["shard/collective_bytes"] == nbytes


def test_packer_families(clean_plane):
    """The packer's four families, each once per key: gather, forward,
    overlay, and the replay per chunk shape."""
    from chunkflow_tpu_torch.serve import PatchPacker

    inferencer = Inferencer(**IDENTITY)
    packer = PatchPacker(inferencer, max_wait_ms=1.0)
    try:
        for chunk in _chunks(3, seed=8):
            packer.infer(chunk, timeout=60)
    finally:
        packer.close()
    by_family = {e["family"]: e for e in profiling.catalog()}
    assert sorted(by_family) == ["serve_forward", "serve_gather",
                                 "serve_overlay", "serve_scatter"]
    assert by_family["serve_scatter"]["key"] == "(8, 32, 32)"
    assert by_family["serve_scatter"]["calls"] == 3
    assert by_family["serve_scatter"]["flops"] > 0
    assert by_family["serve_overlay"]["bytes_accessed"] > 0
    # the overlays write each chunk's 27 forwarded rows into its stack;
    # the replay re-reads the stack, padded to 28 rows
    row = 3 * int(np.prod(PIN)) * 4
    assert by_family["serve_forward"]["hbm_intermediate_bytes"] == \
        3 * 27 * row
    assert by_family["serve_scatter"]["hbm_intermediate_bytes"] == \
        3 * 28 * row
