"""The port's chunk-operator commands against the JAX CLI, on the CPU.

Each chunk-operator command (and each annotation command) is parsed
by each CLI from the same argument list (the JAX options' names and defaults) and run on the same
task: the port's stage (``--device cpu``) and the JAX command's stage
get equal inputs (seeded numpy chunks, one per package) and must leave
equal tasks behind: chunks BITWISE with the same dtype and metadata,
skips, markers and files the same. Whole command lines run through both
CLIs too. The registry: the port has every command the JAX CLI has,
with its options; a chain whose weights the JAX restore refuses raises
``ValueError`` in both CLIs.
"""
import json
import os

import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
from chunkflow_tpu.flow import cli as jax_cli
from chunkflow_tpu.flow.cli import main as jax_main
from chunkflow_tpu.flow.runtime import new_task as jax_new_task
from chunkflow_tpu_torch import BoundingBox, Chunk
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.flow.runtime import new_task
from tests.test_torch_chunk import assert_same_chunk, plain

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

OFFSET, VSIZE = (4, 8, 40), (40, 4, 4)
BOX = ((5, 10, 42), (7, 22, 54))


def _arrays():
    rng = np.random.default_rng(21)
    seg = (rng.integers(0, 12, (4, 16, 16)) * 5).astype(np.uint32)
    seg[:, :3] = 1
    return {
        "chunk": rng.integers(0, 256, (4, 16, 16)).astype(np.uint8),
        "aff": rng.random((3, 4, 16, 16)).astype(np.float32),
        "prob": rng.random((4, 16, 16)).astype(np.float32),
        "other": rng.integers(0, 256, (4, 16, 16)).astype(np.uint8),
        "seg": seg,
        "gt": seg // 10 + (seg % 3 == 0),
        "zero": np.zeros((4, 16, 16), np.uint8),
    }


def _tasks():
    """The same task for each package: chunks, a bbox and a plain var."""
    jax_task, port_task = jax_new_task(), new_task()
    for name, arr in _arrays().items():
        jax_task[name] = JaxChunk(arr.copy(), voxel_offset=OFFSET,
                                  voxel_size=VSIZE)
        port_task[name] = Chunk(arr.copy(), voxel_offset=OFFSET,
                                voxel_size=VSIZE)
    jax_task["bbox"], port_task["bbox"] = JaxBox(*BOX), BoundingBox(*BOX)
    jax_task["note"] = port_task["note"] = {"k": [1, 2]}
    return jax_task, port_task


def jax_stage(args):
    """The JAX command's stage, parsed by click as its CLI parses it."""
    name, *rest = args
    cmd = jax_main.commands[name]
    ctx = cmd.make_context(name, list(rest))
    with ctx:
        return ctx.invoke(cmd.callback, **ctx.params)


def port_stage(args):
    _, stages = cli.build_stages(["--device", "cpu", *args])
    assert len(stages) == 1
    return stages[0]


def run_both(args, tasks=None):
    """(JAX tasks out, port tasks out) of one command on one task."""
    jax_task, port_task = tasks or _tasks()
    return (list(jax_stage(args)(iter([jax_task]))),
            list(port_stage(args)(iter([port_task]))))


def assert_same_tasks(got_tasks, ref_tasks):
    assert len(got_tasks) == len(ref_tasks)
    for got, ref in zip(got_tasks, ref_tasks):
        if ref is None:
            assert got is None
            continue
        assert sorted(k for k in got if k != "log") == \
            sorted(k for k in ref if k != "log")
        for key, value in ref.items():
            if key == "log":
                continue
            if isinstance(value, JaxChunk):
                assert_same_chunk(got[key], value)
            else:
                assert plain(got[key]) == plain(value), key


@pytest.fixture
def volumes(tmp_path):
    """A mask volume at 40x16x16 nm (1x4x4 over the chunks' 40x4x4),
    written by the port, read by both packages."""
    pytest.importorskip("tensorstore")
    from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

    path = str(tmp_path / "mask")
    mask = (np.random.default_rng(22).random((12, 8, 20)) > 0.3).astype(
        np.uint8)
    PrecomputedVolume.create(path, volume_size=mask.shape,
                             voxel_size=(40, 16, 16), block_size=(4, 4, 8))
    PrecomputedVolume(path).save(Chunk(mask, voxel_size=(40, 16, 16)))
    return path


CHUNK_COMMANDS = {
    "crop-margin": ["crop-margin", "-m", "1", "2", "3"],
    "crop-margin-to-bbox": ["crop-margin", "-i", "aff", "-o", "out"],
    "threshold": ["threshold", "-i", "prob", "-o", "bin"],
    "threshold-0.3-on-aff": ["threshold", "-t", "0.3", "-i", "aff"],
    "channel-voting": ["channel-voting", "-i", "aff", "-o", "vote"],
    "normalize-contrast": ["normalize-contrast"],
    "normalize-contrast-whole": [
        "normalize-contrast", "-l", "0.05", "-u", "0.1", "--minval", "0",
        "--maxval", "200", "--whole", "-o", "norm"],
    "normalize-intensity": ["normalize-intensity", "-o", "f"],
    "normalize-section-shang": ["normalize-section-shang"],
    "normalize-section-shang-clipped": [
        "normalize-section-shang", "--nominalmin", "10", "--nominalmax",
        "100", "--clipvalues", "true", "-i", "other", "-o", "shang"],
    "multiply-two": ["multiply", "-i", "aff,prob", "-o", "prod"],
    "multiply-by": ["multiply", "-i", "aff,prob", "-m", "chunk"],
    "multiply-default": ["multiply", "-i", "chunk,other"],
    "mask-out-objects": ["mask-out-objects", "-i", "seg", "-d", "40",
                         "-s", "1,5,10,15"],
    "mask-out-objects-dust": ["mask-out-objects", "-i", "seg", "-o", "clean",
                              "-d", "60"],
    "quantize": ["quantize", "-i", "aff", "-o", "thumb"],
    "quantize-z": ["quantize", "--mode", "z", "-i", "aff"],
    "adjust-bbox": ["adjust-bbox", "--corner-offset", "-1", "2", "3"],
    "delete-var": ["delete-var", "-v", "aff, prob"],
    "copy-var": ["copy-var", "-f", "seg", "-t", "seg2"],
    "skip-none-passes": ["skip-none", "-i", "chunk"],
    "skip-all-zero-passes": ["skip-all-zero"],
}


@pytest.mark.parametrize("name", sorted(CHUNK_COMMANDS))
def test_command_matches_jax(name):
    ref, got = run_both(CHUNK_COMMANDS[name])
    assert_same_tasks(got, ref)


@pytest.mark.parametrize("args", [
    ["mask"],
    ["mask", "--inverse", "-i", "aff,prob", "-o", "a2,p2"],
    ["mask", "--mip", "0", "--no-fill-missing", "-i", "chunk"],
], ids=["default", "inverse-two-chunks", "no-fill-missing"])
def test_mask_matches_jax(volumes, args):
    ref, got = run_both([args[0], "-v", volumes, *args[1:]])
    assert_same_tasks(got, ref)
    assert (np.asarray(got[0]["chunk"].array) == 0).any()


def test_mask_multiply_names_must_pair():
    for args in (["multiply", "-i", "a,b,c"],
                 ["multiply", "-i", "a,b", "-m", "c", "-o", "x"]):
        with pytest.raises(cli.UsageError):
            port_stage(args)


@pytest.mark.parametrize("mode", ["skip-all-zero", "skip-none"])
@pytest.mark.parametrize("marker", [False, True])
def test_skips_and_markers_match_jax(tmp_path, mode, marker):
    outs = []
    for tag in ("jax", "port"):
        prefix = str(tmp_path / tag) + "/m-"
        os.makedirs(tmp_path / tag)
        args = ([mode, "-i", "zero"] if mode == "skip-all-zero"
                else [mode, "-i", "missing"])
        if marker:
            args += ["-p", prefix, "-s", ".done"]
            if mode == "skip-all-zero":
                args += ["-a", "1", "--task-bbox"]
        outs.append((args, sorted(os.listdir(tmp_path / tag))))
    jax_args, port_args = outs[0][0], outs[1][0]
    jax_task, port_task = _tasks()
    ref = list(jax_stage(jax_args)(iter([jax_task])))
    got = list(port_stage(port_args)(iter([port_task])))
    assert ref == got == [None]
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "port"))
    assert len(os.listdir(tmp_path / "port")) == int(marker)


@pytest.mark.parametrize("mode", ["exist", "missing", "empty"])
def test_skip_task_by_file_matches_jax(tmp_path, mode):
    boxes = [((0, 0, 0), (2, 4, 4)), ((2, 0, 0), (4, 4, 4)),
             ((0, 4, 0), (2, 8, 4))]
    # the first has a marker, the second an empty one, the third none
    for i, box in enumerate(boxes[:2]):
        with open(tmp_path / f"m-{BoundingBox(*box).adjust(1).string}.h5",
                  "w") as f:
            f.write("x" if i == 0 else "")
    args = ["skip-task-by-file", "-p", str(tmp_path / "m-"), "-m", mode,
            "-a", "1"]
    jax_tasks = [dict(jax_new_task(), bbox=JaxBox(*b)) for b in boxes]
    port_tasks = [dict(new_task(), bbox=BoundingBox(*b)) for b in boxes]
    ref = list(jax_stage(args)(iter(jax_tasks)))
    got = list(port_stage(args)(iter(port_tasks)))
    assert [t is None for t in got] == [t is None for t in ref]


@pytest.mark.parametrize("mode", ["exist", "empty", "not-empty"])
@pytest.mark.parametrize("with_bbox", [True, False])
def test_cleanup_matches_jax(tmp_path, mode, with_bbox):
    left = []
    for tag, stage, task in (("jax", jax_stage, jax_new_task()),
                             ("port", port_stage, new_task())):
        d = tmp_path / tag
        d.mkdir()
        for name, text in ((f"{BoundingBox(*BOX).string}.h5", "x"),
                           ("a.h5", ""), ("b.h5", "y"), ("c.txt", "")):
            (d / name).write_text(text)
        if with_bbox:
            task["bbox"] = (JaxBox if tag == "jax" else BoundingBox)(*BOX)
        list(stage(["cleanup", "-d", str(d), "--mode", mode])(iter([task])))
        left.append(sorted(os.listdir(d)))
    assert left[0] == left[1]


def test_load_json_matches_jax(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"a": [1, 2.5, None], "b": {"c": "d"}}))
    ref, got = run_both(["load-json", "-f", str(path), "-o", "cfg"])
    assert_same_tasks(got, ref)
    ref, got = run_both(["load-json", "--file-path", str(path)])
    assert got[0]["json"] == ref[0]["json"]


def test_evaluate_segmentation_matches_jax(tmp_path, capsys):
    records = []
    for tag in ("jax", "port"):
        out = tmp_path / f"{tag}.jsonl"
        args = ["evaluate-segmentation", "-s", "seg", "-g", "gt", "-o",
                str(out)]
        jax_task, port_task = _tasks()
        if tag == "jax":
            task = list(jax_stage(args)(iter([jax_task])))[0]
        else:
            task = list(port_stage(args)(iter([port_task])))[0]
        records.append((task["evaluation"],
                        json.loads(out.read_text().splitlines()[0])))
    (ref, ref_line), (got, got_line) = records
    assert got.keys() == ref.keys() and got_line.keys() == ref_line.keys()
    assert got_line["bbox"] == ref_line["bbox"]
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-12, abs=0)
        assert got_line[key] == pytest.approx(ref_line[key], rel=1e-12,
                                              abs=0)
    assert capsys.readouterr().out.count("segmentation evaluation:") == 2


def test_debug_breaks_once_per_task(monkeypatch):
    calls = []
    monkeypatch.setattr("builtins.breakpoint", lambda: calls.append(1))
    ref, got = run_both(["debug"])
    assert_same_tasks(got, ref)
    assert calls == [1, 1]


def test_dry_run_touches_no_marker(tmp_path):
    stages = cli.build_stages(["--device", "cpu", "--dry-run",
                               "skip-all-zero", "-i", "zero", "-p",
                               str(tmp_path / "m-")])[1]
    assert list(stages[0](iter([_tasks()[1]]))) == [None]
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# whole command lines through both CLIs
# ---------------------------------------------------------------------------
CHAINS = {
    "normalize-threshold": [
        "create-chunk", "--size", "8", "32", "32", "--pattern", "random",
        "normalize-contrast", "--whole", "threshold", "-t", "128"],
    "normalize-intensity-multiply": [
        "create-chunk", "--size", "8", "32", "32", "--voxel-offset", "1",
        "2", "3", "normalize-intensity", "-o", "f", "copy-var", "-f", "f",
        "-t", "g", "multiply", "-i", "f,g", "delete-var", "-v", "f,g"],
    "shang-crop": [
        "create-chunk", "--size", "8", "32", "32", "--pattern", "random",
        "normalize-section-shang", "--nominalmax", "1",
        "crop-margin", "-m", "1", "4", "4"],
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_command_line_matches_the_jax_cli(tmp_path, name):
    from click.testing import CliRunner

    outs = {tag: str(tmp_path / f"{tag}.npy") for tag in ("jax", "port")}
    assert cli.main(["--device", "cpu", *CHAINS[name], "save-npy", "-f",
                     outs["port"]]) == 0
    result = CliRunner().invoke(jax_main, [*CHAINS[name], "save-npy", "-f",
                                           outs["jax"]],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    got, ref = np.load(outs["port"]), np.load(outs["jax"])
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


# ---------------------------------------------------------------------------
# the command registry
# ---------------------------------------------------------------------------
JAX_COMMANDS = sorted(jax_main.commands)


def test_the_port_names_every_jax_command():
    assert len(JAX_COMMANDS) == 71
    assert sorted(cli.COMMANDS) == JAX_COMMANDS
    not_ported = [c for items in cli.NOT_PORTED.values() for c in items]
    assert not_ported == [] and cli.NOT_PORTED == {}
    assert sum(1 for v in cli.COMMANDS.values() if v[0] is not None) == 71
    assert "annotations and plugins" not in cli.NOT_PORTED
    assert "segmentation plane" not in cli.NOT_PORTED
    assert "fleet supervisor" not in cli.NOT_PORTED


@pytest.mark.parametrize("command", JAX_COMMANDS)
def test_every_jax_command_runs_or_names_its_item(command):
    """A ported command builds its stage from the JAX CLI's option names
    (its required options given); an unported one raises naming its
    queue-1 item, whatever follows it."""
    item = next((i for i, names in cli.NOT_PORTED.items()
                 if command in names), None)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            cli.build_stages(["--device", "cpu", command, "--bogus", "1"])
        return
    add_options, _, help_text = cli.COMMANDS[command]
    jax_options = {opt for param in jax_main.commands[command].params
                   for opt in param.opts + param.secondary_opts}
    import argparse

    parser = argparse.ArgumentParser(prog=command)
    add_options(parser)
    port_options = {opt for action in parser._actions
                    for opt in action.option_strings} - {"-h", "--help"}
    assert jax_options <= port_options, sorted(jax_options - port_options)
    assert help_text


def test_an_unported_command_in_a_chain_raises_naming_its_item(
        tmp_path, monkeypatch):
    """Every command is ported. A chain whose inference loads weights the
    JAX restore refuses (an orbax OCDBT checkpoint whose root manifest was
    never merged) raises ``ValueError`` in both CLIs, and the chain's
    ``save-h5`` ahead of it writes its file in the port where it does in
    the JAX CLI. A mesh wider than the devices (``--mesh data=2`` over one
    device, in both CLIs) raises the JAX package's ``ValueError`` at the
    task."""
    import jax

    from chunkflow_tpu.models import unet3d
    from tests.test_torch_orbax import unmerged

    refused = unmerged(tmp_path / "orbax")
    # the JAX template's shapes traced, not compiled (as jax_state does)
    real = unet3d.init_params
    monkeypatch.setattr(unet3d, "init_params", lambda *a, **k: jax.eval_shape(
        lambda: real(*a, **k)))
    written = {}
    for name, run in (("jax", lambda argv: jax_main.main(
            argv, standalone_mode=False)), ("port", lambda argv: cli.main(
            ["--device", "cpu", *argv]))):
        out = tmp_path / f"{name}.h5"
        with pytest.raises(ValueError):
            run(["create-chunk", "--size", "4", "16", "16", "save-h5", "-f",
                 str(out), "inference", "-f", "pytorch", "-w", refused, "-p",
                 "4", "16", "16", "-v", "2", "8", "8"])
        written[name] = os.path.exists(out)
    assert written["port"] == written["jax"]

    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    args = ["inference", "-f", "identity", "--mesh", "data=2", "-p", "4",
            "16", "16", "-v", "2", "8", "8"]
    with pytest.raises(ValueError) as ref:
        list(jax_stage(args)(iter([_tasks()[0]])))
    with pytest.raises(ValueError) as got:
        list(port_stage(args)(iter([_tasks()[1]])))
    assert str(got.value) == str(ref.value)
    assert "needs 2 devices, only 1 available" in str(got.value)


def test_inference_with_an_orbax_directory_matches_the_jax_cli():
    """``inference -w <orbax dir>`` (the committed full-width parity
    checkpoint) in both CLIs on one task: float32 within the forward
    gate, 1e-5."""
    from tests.test_torch_orbax import FIXTURE

    args = ["inference", "-f", "flax", "-w", str(FIXTURE), "-p", "4", "16",
            "16", "-v", "2", "8", "8", "-c", "3", "-b", "2"]
    jax_out, port_out = run_both(args)
    ref = np.asarray(jax_out[0]["chunk"].array, np.float64)
    got = np.asarray(port_out[0]["chunk"].host().array, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5


def test_threshold_after_create_chunk_parses():
    """``-t`` belongs to ``threshold`` (it used to be read as
    create-chunk's ``--voxel-offset``)."""
    _, stages = cli.build_stages(["--device", "cpu", "create-chunk",
                                  "--size", "4", "16", "16", "threshold",
                                  "-t", "0.5"])
    assert len(stages) == 2


@pytest.mark.parametrize("argv, commands", [
    (["create-info", "-v", "mask", "-s", "4", "4", "4", "mask", "-v",
      "mask"], ["create-info", "mask"]),
    (["create-chunk", "-o", "threshold", "multiply", "-i", "a,b", "-m",
      "mask", "--name", "debug"], ["create-chunk", "multiply"]),
    (["adjust-bbox", "--corner-offset", "-1", "mask", "3", "threshold"],
     ["adjust-bbox", "threshold"]),
    (["threshold", "--threshold=0.2", "mask", "-v", "m"],
     ["threshold", "mask"]),
], ids=["volume-named-mask", "chunk-names", "three-values", "equals-form"])
def test_a_value_named_like_a_command_is_a_value(argv, commands):
    """click reads an option's values before it looks for the next
    command; so does the port's splitter."""
    head, segments = cli._split(argv)
    assert head == [] and [name for name, _ in segments] == commands


def test_jax_cli_module_is_the_reference():
    assert jax_cli.DEFAULT_CHUNK_NAME == "chunk"


# ---------------------------------------------------------------------------
# the annotation and viewer commands
# ---------------------------------------------------------------------------
def _box_synapses(ns):
    """Seeded synapses around the task bbox ``BOX``: some inside it."""
    from tests.test_torch_annotations import synapses

    rng = np.random.default_rng(23)
    pre = (rng.integers(0, 5, (12, 3)) * (1, 4, 4)
           + (4, 8, 40)).astype(np.int32)
    post = np.concatenate([np.arange(12).repeat(2)[:, None],
                           pre.repeat(2, axis=0) + rng.integers(
                               -1, 2, (24, 3))], axis=1).astype(np.int32)
    return synapses(ns, pre=pre, post=post,
                    pre_confidence=rng.random(12).astype(np.float32),
                    post_confidence=rng.random(24).astype(np.float32))


def _annotated_tasks():
    """``_tasks()`` with synapses, a dict of skeletons and points of each
    package."""
    from tests.test_torch_annotations import (
        JAX,
        PORT,
        point_cloud,
        skeleton,
    )

    tasks = _tasks()
    for task, ns in zip(tasks, (JAX, PORT)):
        task["synapses"] = _box_synapses(ns)
        task["skels"] = {5: skeleton(ns), 9: skeleton(ns, n=7, seed=3)}
        task["skeleton"] = skeleton(ns, n=4, seed=4)
        task["points"] = point_cloud(ns)
        task["bare_points"] = np.arange(12).reshape(4, 3)
    return tasks


def assert_same_annotated_tasks(got_tasks, ref_tasks):
    """Chunks bitwise, annotations by their arrays, the rest as data."""
    from tests.test_torch_annotations import canon

    assert len(got_tasks) == len(ref_tasks)
    for got, ref in zip(got_tasks, ref_tasks):
        assert sorted(k for k in got if k != "log") == \
            sorted(k for k in ref if k != "log")
        for key, value in ref.items():
            if key == "log":
                continue
            if isinstance(value, JaxChunk):
                assert_same_chunk(got[key], value)
            else:
                assert canon(got[key]) == canon(value), key


def _files(root):
    return {name: (root / name).read_bytes()
            for name in sorted(os.listdir(root))}


def _each(tmp_path, make_args, tasks=None):
    """Run one command per package, each writing under its own directory:
    (JAX tasks, port tasks, JAX directory, port directory)."""
    jax_task, port_task = tasks or _annotated_tasks()
    dirs = {tag: tmp_path / tag for tag in ("jax", "port")}
    for d in dirs.values():
        d.mkdir(exist_ok=True)
    ref = list(jax_stage(make_args(dirs["jax"]))(iter([jax_task])))
    got = list(port_stage(make_args(dirs["port"]))(iter([port_task])))
    return ref, got, dirs["jax"], dirs["port"]


@pytest.mark.parametrize("suffix", [".json", ".h5"])
@pytest.mark.parametrize("how", ["file", "directory", "resolution"])
def test_load_synapses_matches_jax(tmp_path, suffix, how):
    if suffix == ".h5":
        pytest.importorskip("h5py")
    from tests.test_torch_annotations import JAX

    src = tmp_path / "src"
    src.mkdir()
    path = src / (f"{JaxBox(*BOX).string}{suffix}" if how == "directory"
                  else f"syn{suffix}")
    _box_synapses(JAX).to_file(str(path))
    args = ["load-synapses", "-f", str(src if how == "directory" else path),
            "-o", "loaded"]
    if how == "directory":
        args += ["-s", suffix]
    if how == "resolution":
        args += ["--resolution", "8", "16", "32"]
    ref, got = run_both(args, _annotated_tasks())
    assert_same_annotated_tasks(got, ref)
    loaded = got[0]["loaded"]
    assert 0 < loaded.pre_num < 12 and loaded.post_num > 0
    assert BoundingBox(*BOX).contains(tuple(loaded.pre.max(axis=0)))


def test_load_synapses_directory_needs_a_bbox(tmp_path):
    import click

    tasks = _annotated_tasks()
    for task in tasks:
        del task["bbox"]
    args = ["load-synapses", "-f", str(tmp_path)]
    with pytest.raises(click.UsageError) as ref:
        list(jax_stage(args)(iter([tasks[0]])))
    with pytest.raises(cli.UsageError) as got:
        list(port_stage(args)(iter([tasks[1]])))
    assert str(got.value) == ref.value.message


@pytest.mark.parametrize("suffix", [".json", ".h5"])
def test_save_synapses_matches_jax(tmp_path, suffix):
    if suffix == ".h5":
        pytest.importorskip("h5py")
    from chunkflow_tpu.annotations.synapses import Synapses as JaxSynapses
    from chunkflow_tpu_torch.annotations import Synapses
    from tests.test_torch_annotations import canon

    ref, got, jdir, pdir = _each(tmp_path, lambda d: [
        "save-synapses", "-f", str(d / f"s{suffix}")])
    assert_same_annotated_tasks(got, ref)
    if suffix == ".json":
        assert _files(pdir) == _files(jdir)
    for path in (jdir / f"s{suffix}", pdir / f"s{suffix}"):
        assert canon(Synapses.from_file(str(path))) == \
            canon(JaxSynapses.from_file(str(path)))


@pytest.mark.parametrize("key, suffix", [
    ("points", ".npy"), ("bare_points", ".npy"), ("points", ".h5"),
    ("bare_points", ".h5")])
def test_save_points_matches_jax(tmp_path, key, suffix):
    if suffix == ".h5":
        pytest.importorskip("h5py")
    from chunkflow_tpu.annotations.point_cloud import PointCloud as JaxPC
    from chunkflow_tpu_torch.annotations import PointCloud
    from tests.test_torch_annotations import canon

    ref, got, jdir, pdir = _each(tmp_path, lambda d: [
        "save-points", "-i", key, "-f", str(d / f"p{suffix}")])
    assert_same_annotated_tasks(got, ref)
    if suffix == ".npy":
        assert _files(pdir) == _files(jdir)
    else:
        for path in (jdir / "p.h5", pdir / "p.h5"):
            assert canon(PointCloud.from_h5(str(path))) == \
                canon(JaxPC.from_h5(str(path)))


@pytest.mark.parametrize("offset", [None, ("1", "2", "3")])
@pytest.mark.parametrize("size", [None, ("40", "4", "4")])
def test_load_skeleton_matches_jax(tmp_path, offset, size):
    from tests.test_torch_annotations import JAX, skeleton

    path = str(tmp_path / "s.swc")
    skeleton(JAX).to_swc(path)
    args = ["load-skeleton", "-f", path, "-o", "loaded"]
    if offset:
        args += ["--voxel-offset", *offset]
    if size:
        args += ["--voxel-size", *size]
    ref, got = run_both(args, _annotated_tasks())
    assert_same_annotated_tasks(got, ref)


@pytest.mark.parametrize("key, name", [
    ("skels", "prefix-"), ("skeleton", "one.swc"), ("skeleton", "bare"),
    ("single", "only.swc")])
def test_save_swc_matches_jax(tmp_path, key, name):
    tasks = _annotated_tasks()
    for task in tasks:
        task["single"] = {3: task["skeleton"]}
    ref, got, jdir, pdir = _each(tmp_path, lambda d: [
        "save-swc", "-i", key, "-f", str(d / name)], tasks)
    assert_same_annotated_tasks(got, ref)
    assert _files(pdir) == _files(jdir) and _files(pdir)


def test_save_swc_of_several_to_one_file_is_a_usage_error(tmp_path):
    import click

    jax_task, port_task = _annotated_tasks()
    args = ["save-swc", "-i", "skels", "-f", str(tmp_path / "all.swc")]
    with pytest.raises(click.UsageError) as ref:
        list(jax_stage(args)(iter([jax_task])))
    with pytest.raises(cli.UsageError) as got:
        list(port_stage(args)(iter([port_task])))
    assert str(got.value) == ref.value.message
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("by_prefix", [False, True])
def test_aggregate_skeleton_fragments_matches_jax(tmp_path, by_prefix):
    """Fragments of two adjacent crops (the JAX plugin's), aggregated by
    each CLI: no task comes out, the same files go in."""
    from chunkflow_tpu.chunk.segmentation import Segmentation
    from chunkflow_tpu.plugins import skeletonize
    from tests.test_torch_skeletonize import _labels

    frags = tmp_path / "frags"
    seg = _labels(5, (8, 24, 48))
    for x0 in (0, 24):
        skeletonize.execute(Segmentation(seg[..., x0:x0 + 24].copy(),
                                         voxel_offset=(0, 0, x0),
                                         voxel_size=(40, 4, 4)),
                            voxel_num_threshold=10, output_path=str(frags))
    ids = {n.split(":")[0] for n in os.listdir(frags)}
    prefix = min(ids)[0] if by_prefix else None
    ref, got, jdir, pdir = _each(tmp_path, lambda d: [
        "aggregate-skeleton-fragments", "-f", str(frags), "-o", str(d)]
        + (["-p", prefix] if prefix else []))
    assert ref == got == []
    assert _files(pdir) == _files(jdir) and _files(pdir)
    assert set(_files(pdir)) == {i for i in ids
                                 if not prefix or i.startswith(prefix)}


def test_view_stage_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    ref, got, jdir, pdir = _each(tmp_path, lambda d: [
        "view", "--segmentation-chunk-name", "seg", "--screenshot",
        str(d / "v.png")])
    assert_same_annotated_tasks(got, ref)
    assert _files(pdir) == _files(jdir)


def _viewer_stubs(monkeypatch):
    """Stub ``neuroglancer`` and ``napari`` modules recording what each
    stage hands them."""
    import sys
    import types

    from tests.test_torch_viewers import _Record, _Txn

    seen = []
    ng = types.ModuleType("neuroglancer")
    for name in ("CoordinateSpace", "LocalVolume", "LocalAnnotationLayer",
                 "AnnotationPropertySpec", "PointAnnotation",
                 "LineAnnotation"):
        setattr(ng, name, type(name, (_Record,), {}))

    class _NgViewer:
        def txn(self):
            import contextlib

            @contextlib.contextmanager
            def cm():
                seen.append(_Txn())
                yield seen[-1]

            return cm()

        def get_viewer_url(self):
            return "http://stub"

    ng.Viewer = _NgViewer
    ng.set_server_bind_address = lambda **kw: seen.append(kw)
    napari = types.ModuleType("napari")

    class _NapariViewer:
        def add_labels(self, arr, name=None):
            seen.append(("labels", name, arr))

        def add_image(self, arr, name=None):
            seen.append(("image", name, arr))

    napari.Viewer = _NapariViewer
    napari.run = lambda: seen.append("run")
    monkeypatch.setitem(sys.modules, "neuroglancer", ng)
    monkeypatch.setitem(sys.modules, "napari", napari)
    monkeypatch.setattr("builtins.input", lambda prompt="": "")
    return seen


@pytest.mark.parametrize("args", [
    ["neuroglancer", "-c", "chunk,seg,aff,synapses,points,missing", "-p",
     "7", "--voxel-size", "40", "8", "8"],
    ["napari", "-c", "chunk,seg,prob"]], ids=["neuroglancer", "napari"])
def test_viewer_commands_match_jax(monkeypatch, args):
    from tests.test_torch_viewers import _Txn, record

    seen = _viewer_stubs(monkeypatch)
    ref, got = run_both(args, _annotated_tasks())
    assert_same_annotated_tasks(got, ref)
    seen = [s.layers.entries if isinstance(s, _Txn) else s for s in seen]
    half = len(seen) // 2
    assert half > 0
    assert record(seen[half:]) == record(seen[:half])
