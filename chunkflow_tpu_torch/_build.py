"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel family behind a plain ``extern
"C"`` launcher. It is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root, at
first use, and bound with ``ctypes``; the hash is the source's, so an
edited kernel rebuilds and a stale library is never loaded. The build
reads only the sources in ``csrc/`` and includes no PyTorch header, which
keeps it at seconds per file. ``-fmad=false`` keeps the compiler from
contracting a multiply and an add into one FMA: the kernels' sums must
round exactly as their plain PyTorch versions' do.

Nothing here runs at import: the CPU test box has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNELS = ("gather", "accumulate")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (on PATH or under CUDA_HOME): the CUDA kernels "
        "cannot be built on this machine"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together; returns name -> library path. Each
    library lands under a temporary name and is renamed into place, so a
    cut build never leaves a loadable half-written file. The compiler's
    resource report (``-Xptxas -v``) is kept beside it as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = []
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(name, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise on a non-zero ``cudaError_t`` a launcher returned (a launch
    the card refused never runs, and no later synchronize reports it)."""
    if code:
        message = getattr(lib, f"{prefix}_error_string")(code)
        raise RuntimeError(
            f"{prefix} kernel launch failed: CUDA error {code} "
            f"({message.decode() if message else 'unknown'})"
        )
