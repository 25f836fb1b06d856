"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

Checked two ways: an AST scan of every source of ``chunkflow_tpu_torch``
(and ``chip_smoke.py``), and a fresh interpreter that imports every
module of the package and then looks at ``sys.modules``. Also pins the
kernel build recipe, the packaging of the CUDA sources, and that
``chip_smoke.py`` refuses to report without a card or without the
repository beside it.
"""
import ast
import json
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from chunkflow_tpu_torch import _build
from chunkflow_tpu_torch.ops import accumulate, conv_epilogue, gather, int8_conv

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "chunkflow_tpu_torch"
# and the cloud packages: the port speaks HTTP, SigV4 and RS256 itself,
# with what the card machine has; and the compression packages: the port
# decodes zstd, blosc and lz4 in its own host C++; and OpenCV: the port's
# CLAHE is its own host C++
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "chunkflow_tpu", "tensorstore", "click", "boto3", "botocore",
             "google", "requests", "urllib3", "cryptography", "zstandard",
             "lz4", "blosc", "numcodecs", "cv2")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax():
    script = (
        "import importlib, json, pkgutil, sys\n"
        "preloaded = set(sys.modules)\n"
        "import chunkflow_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps({'imported': mods,\n"
        "                  'loaded': sorted(set(sys.modules) - preloaded)}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("inference.inferencer", "flow.cli", "flow.setup_env",
                 "volume.storage", "volume.precomputed", "parallel.queues",
                 "parallel.lifecycle", "testing.chaos", "core.telemetry",
                 "core.profiling", "core.slo", "parallel.task_tree",
                 "parallel.restapi", "serve.frontend", "serve.packer",
                 "parallel.fleet", "flow.log_summary", "flow.trace_export",
                 "flow.profile_summary", "flow.plugin",
                 "plugins.agglomerate", "plugins.load_n5",
                 "annotations", "annotations.synapses",
                 "annotations.point_cloud", "annotations.skeleton",
                 "flow.viewers", "plugins.skeletonize",
                 "plugins.aggregate_skeleton_fragments",
                 "plugins.synapse.detect_pre_synapses",
                 "plugins.synapse.detect_post_synapses",
                 "plugins.synapse.adjust_pre",
                 "plugins.synapse.detect_duplicate_post",
                 "plugins.synapse.find_tbar_object", "cloud.http",
                 "cloud.aws", "cloud.google", "cloud.gcs", "cloud.s3",
                 "cloud.sqs", "testing.cloud_fakes", "volume.zstd",
                 "volume.blosc", "volume.compressors", "volume.ocdbt",
                 "models.orbax", "plugins.load_tensorstore",
                 "ops.clahe", "plugins.clahe", "plugins.czann_inference",
                 "plugins.napari_pixel_classifier", "volume.crc32c",
                 "parallel.engine", "parallel.pipeline", "core.envmode",
                 "parallel.distributed", "parallel.spatial",
                 "parallel.spatial2d", "cloud.cloudwatch",
                 "plugins.aws.cloud_watch", "volume.kvstores"):
        assert f"chunkflow_tpu_torch.{name}" in report["imported"]
    # what the interpreter loads before the first line (a site-packages
    # .pth file may pre-import a namespace package such as ``google``) is
    # not the port's doing
    leaked = [m for m in report["loaded"] if _forbidden(m)]
    assert not leaked, leaked


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted((PACKAGE / "cloud").glob("*.py"))
                         + [PACKAGE / "testing" / "cloud_fakes.py"],
                         ids=lambda p: p.name)
def test_the_cloud_clients_and_fakes_need_only_the_standard_library(path):
    """What the cloud plane and its fakes import: the standard library,
    numpy, torch and the port itself."""
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch",
                                              "chunkflow_tpu_torch"}
    bad = [n for n in _imports(path) if n.split(".")[0] not in allowed]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_fleet_spawns_the_port_and_reads_no_tools():
    """Workers are ``python -m chunkflow_tpu_torch``; no source names the
    JAX CLI's module or the repository's ``tools/``."""
    fleet = (PACKAGE / "parallel" / "fleet.py").read_text()
    assert '"-m", "chunkflow_tpu_torch"' in fleet
    for path in _sources():
        text = path.read_text()
        for name in ("chunkflow_tpu.flow.cli", "tools.trace_export",
                     "tools.analyze_trace"):
            assert name not in text, f"{path.relative_to(ROOT)}: {name}"


def test_every_kernel_has_a_source_and_a_launcher():
    for name, module, launcher in (
            ("gather", gather, "gather_patches_launch"),
            ("accumulate", accumulate, "accumulate_patches_launch"),
            ("conv3d_int8", int8_conv, "conv3d_int8_launch"),
            ("conv3d_int8_generic", int8_conv,
             "conv3d_int8_generic_launch"),
            ("conv_epilogue", conv_epilogue, "conv_epilogue_launch")):
        assert name in _build.KERNELS
        source = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {launcher}(' in source
        assert "atomicAdd(" not in source  # fixed summation order
        assert "launches" in vars(module)


def test_nvcc_recipe(monkeypatch):
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    out = _build.library_path("accumulate")
    cmd = _build.nvcc_command("accumulate", out)
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-std=c++17", "-O3", "-fmad=false", "-shared"):
        assert flag in cmd
    assert cmd[-1] == str(_build.CSRC / "accumulate.cu")
    # the build lands under build/ (git-ignored) and is keyed by content
    assert out.parent == ROOT / "build" / "torch_kernels"
    assert out != _build.library_path("gather")


def test_build_without_nvcc_fails_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_cuda_sources_are_packaged():
    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = config["tool"]["setuptools"]["package-data"]
    assert "csrc/*.cu" in data["chunkflow_tpu_torch"]
    assert any("chunkflow_tpu*" == p for p in
               config["tool"]["setuptools"]["packages"]["find"]["include"])


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "FAILED" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
