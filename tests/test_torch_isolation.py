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

from chunkflow_tpu_torch import _build
from chunkflow_tpu_torch.ops import accumulate, gather

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "chunkflow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "chunkflow_tpu")


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
        "import chunkflow_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps({'imported': mods, 'loaded': sorted(sys.modules)}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "chunkflow_tpu_torch.inference.inferencer" in report["imported"]
    assert "chunkflow_tpu_torch.flow.cli" in report["imported"]
    leaked = [m for m in report["loaded"] if _forbidden(m)]
    assert not leaked, leaked


def test_every_kernel_has_a_source_and_a_launcher():
    for name, module, launcher in (
            ("gather", gather, "gather_patches_launch"),
            ("accumulate", accumulate, "accumulate_patches_launch")):
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
