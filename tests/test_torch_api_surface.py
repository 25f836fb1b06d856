"""The port's public names against the JAX package's, by parsing both.

Every ``.py`` file of ``chunkflow_tpu/`` and ``chunkflow_tpu_torch/`` is
parsed with ``ast``; neither package is imported, so this runs wherever
the sources are. For each JAX module, every public top-level function
and class, and every public method of a top-level class, must have a
counterpart of the same name in the port's module of the same path
(``PATHS`` maps the one that moved): a top-level name the port defines,
assigns or imports there, or a member of the port's class of that name
(its own, or a base class's defined in that module or imported from
another port module). What the port leaves out on purpose is a row of
``BY_DESIGN`` with its reason, and a JAX module with no port module is a
row of ``NO_MODULE``. A row goes stale, and fails, when the JAX module no
longer has the name or the port now has it.
"""
import ast
from functools import lru_cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "chunkflow_tpu"
PORT = ROOT / "chunkflow_tpu_torch"

#: a JAX module whose port counterpart lives at another path
PATHS = {"native/__init__.py": "native.py"}

_CLI_TEST = ("click function; the command is held by tests/"
             "test_torch_cli_ops.py::test_every_jax_command_runs_or_names_"
             "its_item")
_COMMANDS = (
    "generate_tasks", "setup_env", "fetch_task_from_file", "debug",
    "prefetch", "fetch_task", "delete_task", "dead_letter", "fleet_status",
    "fleet_run", "serve", "create_chunk", "load_h5", "save_h5", "load_tif",
    "save_tif", "create_info", "load_precomputed", "save_precomputed",
    "log_summary", "load_synapses", "save_synapses", "save_points",
    "load_skeleton", "save_swc", "load_npy", "save_npy", "load_json",
    "load_zarr", "save_zarr", "create_bbox", "cleanup", "skip_all_zero",
    "skip_none", "skip_task_by_file", "skip_task_by_blocks",
    "mark_complete", "adjust_bbox", "delete_var", "copy_var", "inference",
    "crop_margin", "threshold", "connected_components", "channel_voting",
    "normalize_contrast", "normalize_intensity", "normalize_section_shang",
    "mask", "multiply", "mask_out_objects", "quantize", "downsample",
    "downsample_upload", "gaussian_filter", "plugin", "save_pngs",
    "load_png", "mesh", "mesh_manifest", "download_mesh",
    "aggregate_skeleton_fragments", "save_nrrd", "view", "neuroglancer",
    "napari", "evaluate_segmentation", "label_chunk", "merge_seg",
    "relabel", "segment_volume")
_XLA_TAG = ("XLA program tag: a ProgramCache key component; the port "
            "launches its CUDA kernels and caches no XLA programs")

#: "path:name" -> why the port has no name of that spelling there
BY_DESIGN = {
    **{f"flow/cli.py:{name}_cmd": _CLI_TEST for name in _COMMANDS},
    "flow/cli.py:cartesian_option": (
        "click option decorator; the port's argparse helper is _triple"),
    "flow/cli.py:name_option": (
        "click option decorator; the port's argparse helper is _name"),
    "flow/cli.py:run_pipeline": (
        "click result callback; the port's main() runs the parsed chain"),
    "flow/runtime.py:PipelineState": (
        "the click group's shared flags; the port's main() hands them to "
        "each stage as a dict"),
    "core/envmode.py:recognized_values": (
        "a helper of the JAX env-mode tests, which enumerate the values to "
        "hold that none warns; no path of either package calls it"),
    "core/profiling.py:note_retrace": (
        "XLA retrace watchdog; a torch forward is not traced, and the "
        "port's ledger counts its builds in cached_program"),
    "inference/engines.py:create_flax_engine": (
        "a flax module engine; the port's -f flax loads flax weights into "
        "its torch mirror (create_convnet_engine)"),
    "models/rsunet.py:RSBlock.setup": (
        "flax setup; the port's torch modules build in __init__"),
    "models/rsunet.py:RSUNet.setup": (
        "flax setup; the port's torch modules build in __init__"),
    "models/unet3d.py:init_params": (
        "flax template: a jax.random init of a flax module; the port seeds "
        "its torch modules (seeded_init), so no values would match"),
    "models/unet3d.py:init_or_load_params": (
        "flax template: returns a flax tree for a flax module; the port "
        "loads into its torch module (convert.init_or_load_weights) and "
        "writes the tree with save_params"),
    "inference/bump.py:normalized_patch_mask": (
        "a pre-normalized patch mask that only its own JAX test calls; no "
        "path of either package blends with it (both blend with bump_map)"),
    "native/__init__.py:build": (
        "the JAX package's build hook for its C extension; the port builds "
        "its host library on first use (native.load through _build), and a "
        "failed build raises there"),
    "native/__init__.py:available": (
        "a probe that lets a JAX caller fall back to numpy when its C "
        "extension is missing; the port has no such fallback, so "
        "native.load raises instead"),
    "ops/blend.py:stacked_scatter_enabled": (
        "an XLA scatter choice (CHUNKFLOW_BLEND_STACKED); the port always "
        "launches csrc/accumulate.cu"),
    "ops/blend.py:fused_pipeline_mode": (
        "the Pallas pipeline switch (CHUNKFLOW_FUSED_PIPELINE); the port "
        "always launches its two CUDA kernels"),
    "ops/blend.py:pipeline_tag": _XLA_TAG,
    "ops/blend.py:pipeline_key": _XLA_TAG,
    "ops/blend.py:replay_tag": _XLA_TAG,
    "ops/blend.py:replay_key": _XLA_TAG,
    "ops/blend.py:kernel_tag": _XLA_TAG,
    "parallel/distributed.py:make_mesh": (
        "JAX sharding: a jax.sharding.Mesh of devices; the port's engine "
        "takes a mesh spec (parallel/engine.py)"),
    "volume/storage.py:TensorStoreBackend": (
        "tensorstore handle; the port's own KV plane (PrecomputedBackend "
        "on KVBackend)"),
    "volume/storage.py:TensorStoreKV": (
        "tensorstore handle; the port's own KV plane (KVBackend)"),
}

#: a JAX module with no port module -> why
NO_MODULE = {
    "core/compile_cache.py": (
        "XLA's persistent compilation cache and retrace watchdog; the "
        "port builds its kernels with _build.py"),
    "models/converter.py": (
        "torch state dicts into flax params; the port's models are torch "
        "modules, so models/convert.py holds the pairing rules and the "
        "inverse layout"),
    "ops/pallas_blend.py": (
        "Pallas TPU kernel; ported as csrc/accumulate.cu under "
        "ops/accumulate.py"),
    "ops/pallas_gather.py": (
        "Pallas TPU kernel; ported as csrc/gather.cu under ops/gather.py"),
    "parallel/_shard_map.py": (
        "a shim over jax.shard_map across JAX versions"),
    "testing/kernelcheck.py": (
        "holds Pallas kernels in interpret mode against XLA; the port holds "
        "its CUDA kernels against their plain versions (chip_smoke.py "
        "phase 3, tests/test_torch_cuda.py)"),
}


def _modules(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


@lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public(node) -> bool:
    return not node.name.startswith("_")


def jax_names(rel: str):
    """The public top-level functions and classes of a JAX module, and
    ``Class.method`` for the public methods of its top-level classes."""
    names = []
    for node in _tree(JAX / rel).body:
        defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        if isinstance(node, defs) and _public(node):
            names.append(node.name)
        if isinstance(node, ast.ClassDef):
            names += [f"{node.name}.{item.name}" for item in node.body
                      if isinstance(item, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                      and _public(item)]
    return names


def _targets(node):
    """The names an assignment, a definition or an import binds."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                      ast.Name):
        return [node.target.id]
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names]
    return []


@lru_cache(maxsize=None)
def port_top(rel: str) -> frozenset:
    """The top-level names a port module binds."""
    return frozenset(name for node in _tree(PORT / rel).body
                     for name in _targets(node))


def _imported_class(rel: str, name: str):
    """(the port module, the class name) that ``name`` is imported as in
    the port module ``rel``, or None."""
    for node in _tree(PORT / rel).body:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("chunkflow_tpu_torch."):
            for alias in node.names:
                if (alias.asname or alias.name) == name:
                    module = node.module.split(".", 1)[1].replace(".", "/")
                    for candidate in (f"{module}.py", f"{module}/__init__.py"):
                        if (PORT / candidate).exists():
                            return candidate, alias.name
    return None


def _class(rel: str, name: str):
    """(module, node) of the port class ``name`` as the port module
    ``rel`` sees it: defined there, or imported from another port
    module; None where it is neither."""
    for node in _tree(PORT / rel).body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return rel, node
    found = _imported_class(rel, name)
    return _class(*found) if found is not None else None


def port_members(rel: str, cls: str, depth: int = 0) -> frozenset:
    """The members of the port's class ``cls`` as module ``rel`` sees it:
    its own and its bases' (in that module or imported from the port)."""
    found = _class(rel, cls)
    if found is None or depth > 8:
        return frozenset()
    where, node = found
    members = {name for item in node.body for name in _targets(item)}
    for base in node.bases:
        if isinstance(base, ast.Name):
            members |= port_members(where, base.id, depth + 1)
    return frozenset(members)


def missing(rel: str):
    """The JAX module's public names that its port module lacks."""
    port_rel = PATHS.get(rel, rel)
    out = []
    for name in jax_names(rel):
        cls, _, member = name.partition(".")
        if not member:
            present = name in port_top(port_rel)
        elif not cls.startswith("_") and cls not in port_top(port_rel):
            continue  # the class's own row covers its methods
        else:
            present = member in port_members(port_rel, cls)
        if not present:
            out.append(name)
    return out


JAX_MODULES = _modules(JAX)
PORTED = [rel for rel in JAX_MODULES if (PORT / PATHS.get(rel, rel)).exists()]


@pytest.mark.parametrize("rel", PORTED)
def test_jax_public_names_have_port_counterparts(rel):
    unlisted = [name for name in missing(rel)
                if f"{rel}:{name}" not in BY_DESIGN]
    assert not unlisted, (
        f"{rel}: the port's {PATHS.get(rel, rel)} lacks {unlisted}; port "
        f"them or add BY_DESIGN rows with their reasons")


def test_jax_modules_without_a_port_module_are_listed():
    absent = {rel for rel in JAX_MODULES if rel not in PORTED}
    assert absent == set(NO_MODULE), (
        f"unlisted: {sorted(absent - set(NO_MODULE))}; stale: "
        f"{sorted(set(NO_MODULE) - absent)}")


def test_no_by_design_row_is_stale():
    """Each row names a JAX public name that the port still lacks, and
    gives a reason."""
    stale = []
    for row, reason in BY_DESIGN.items():
        rel, name = row.split(":")
        if not (JAX / rel).exists() or name not in jax_names(rel):
            stale.append(f"{row}: the JAX module has no such name")
        elif name not in missing(rel):
            stale.append(f"{row}: the port has it now")
        elif len(reason.split()) < 4:
            stale.append(f"{row}: no reason given")
    assert not stale, stale


def test_the_scan_sees_inherited_and_missing_names(tmp_path, monkeypatch):
    """The scan on two small trees: a method a port class inherits from
    a base imported from another port module counts; a method that no
    class of the chain defines is missing."""
    jax, port = tmp_path / "chunkflow_tpu", tmp_path / "chunkflow_tpu_torch"
    (jax / "volume").mkdir(parents=True)
    (port / "volume").mkdir(parents=True)
    (jax / "volume" / "a.py").write_text(
        "def f(): pass\n"
        "def _private(): pass\n"
        "class C:\n"
        "    def own(self): pass\n"
        "    def inherited(self): pass\n"
        "    def absent(self): pass\n"
        "    def _hidden(self): pass\n")
    (port / "volume" / "base.py").write_text(
        "class Base:\n    def inherited(self): pass\n")
    (port / "volume" / "a.py").write_text(
        "from chunkflow_tpu_torch.volume.base import Base\n"
        "f = None\n"
        "class C(Base):\n    def own(self): pass\n")
    monkeypatch.setitem(globals(), "JAX", jax)
    monkeypatch.setitem(globals(), "PORT", port)
    port_top.cache_clear()
    try:
        assert jax_names("volume/a.py") == ["f", "C", "C.own", "C.inherited",
                                            "C.absent"]
        assert missing("volume/a.py") == ["C.absent"]
    finally:
        port_top.cache_clear()
