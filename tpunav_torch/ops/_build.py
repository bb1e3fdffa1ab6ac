"""Builds and loads the port's CUDA kernels.

Modelled on ``tpunav/native/lib.py`` (the hash-keyed g++ build of the
native library). ``nvcc`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``)
into one shared library with a plain ``extern "C"`` interface, at first
use, into ``ops/build/`` (git-ignored); the file name carries a hash of
the sources and flags, so an edit rebuilds. ``ctypes`` loads it. With no
``nvcc``, or a failed compile, :func:`load` raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libtpunav_torch_kernels-{h.hexdigest()[:16]}.so"


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.environ.get("PATH", "") + os.pathsep + str(Path(cuda_home) / "bin")
    nvcc = shutil.which("nvcc", path=path)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of tpunav_torch cannot be built")
    return nvcc


def _compile(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    # Build under a temporary name and rename, so a concurrent loader never
    # sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *_NVCC_FLAGS, f"-I{_CSRC}", *cu, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.tpunav_mppi_solve.restype = ctypes.c_int
    lib.tpunav_mppi_solve.argtypes = [vp] * 10
    lib.tpunav_cuda_error_string.restype = ctypes.c_char_p
    lib.tpunav_cuda_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
