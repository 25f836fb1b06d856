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

The host C++ of the segmentation legs and plane (``csrc/host/``:
connected components, id remapping, watershed and agglomeration,
surface-nets meshing; the port's copies of the JAX package's
``native/src/``), the precomputed block codecs that run per voxel
(``compressed_segmentation``, the PNG row filters), the zstd and
blosc decoders and the CRC-32C of the zarr, N5 and OCDBT stores, and
the ``clahe`` plugin's equalization is one more library,
``HOST_LIBRARY``: the same build compiles it with ``g++``, keyed by the
hash of all its sources.

Nothing here runs at import: the CPU test box has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNELS = ("gather", "accumulate", "conv3d_int8", "conv3d_int8_generic",
           "conv_epilogue")
HOST = CSRC / "host"
HOST_LIBRARY = "chunkflow_host"
HOST_SOURCES = ("cc3d.cpp", "remap.cpp", "watershed.cpp",
                "surface_nets.cpp", "compressed_segmentation.cpp", "zstd.cpp",
                "blosc.cpp", "clahe.cpp", "crc32c.cpp")
HOST_HEADERS = ("zslab.h",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

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
    digest = hashlib.sha256()
    if name == HOST_LIBRARY:
        for source in HOST_SOURCES + HOST_HEADERS:
            digest.update(source.encode())
            digest.update((HOST / source).read_bytes())
    else:
        digest.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def gxx_command(out: Path) -> List[str]:
    return [gxx(), *GXX_FLAGS, *(str(HOST / s) for s in HOST_SOURCES),
            "-o", str(out)]


def build_all(names=KERNELS) -> Dict[str, Path]:
    """Compile every named library that is not built yet (a kernel with
    ``nvcc``, ``HOST_LIBRARY`` with ``g++``), all compilers started
    together; returns name -> library path. Each library lands under a
    temporary name and is renamed into place, so a cut build never leaves
    a loadable half-written file. The compiler's report (for a kernel,
    ``-Xptxas -v``'s resources) is kept beside it as ``.log``. One
    process builds at a time (a file lock beside the build directory), so
    test workers starting together compile a library once. A failed
    build raises: nothing falls back to another leg."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lock = BUILD_DIR.with_name(BUILD_DIR.name + ".lock")
    with open(lock, "a") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        return _build_missing(names)


def _build_missing(names) -> Dict[str, Path]:
    paths = {name: library_path(name) for name in names}
    running = []
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        host = name == HOST_LIBRARY
        proc = subprocess.Popen(
            gxx_command(tmp) if host else nvcc_command(name, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, "host C++" if host else "CUDA kernel", path,
                        tmp, proc))
    failures = []
    for name, what, path, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{what} build failed: {name} (exit "
                            f"{proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a kernel or ``HOST_LIBRARY``), built
    first if needed."""
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


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the host C++ of the "
                           "segmentation legs cannot be built")
    return found
