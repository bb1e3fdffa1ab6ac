"""Builds and loads the port's CUDA kernels.

Modelled on ``tpunav/native/lib.py`` (the hash-keyed g++ build of the
native library). ``nvcc`` compiles each ``csrc/*.cu`` for Hopper
(``sm_90a``), all sources at once in parallel, and links one shared library
with a plain ``extern "C"`` interface, at first use, into ``ops/build/``
(git-ignored); the file name carries a hash of
the sources and flags, so an edit rebuilds. ``ctypes`` loads it. With no
``nvcc``, or a failed compile, :func:`load` raises: there is no fallback.
Also the checks every kernel wrapper makes around a launch.
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

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib: Optional[ctypes.CDLL] = None
_ptxas_log = ""             # ptxas -v report of a build made by this process


def _sources():
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS + _LINK_FLAGS).encode())
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


def _check(proc: subprocess.Popen, cmd) -> str:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    return err


def _compile(so: Path) -> str:
    """Build the library at ``so``; returns ptxas's resource report."""
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cu = [p for p in _sources() if p.suffix == ".cu"]
    # One nvcc per source, all started together, then one link. Build
    # under temporary names and rename, so a concurrent loader never sees
    # a half-written library.
    tmpdir = Path(tempfile.mkdtemp(dir=so.parent))
    try:
        objs = [tmpdir / f"{src.stem}.o" for src in cu]
        cmds = [[nvcc, *_NVCC_FLAGS, f"-I{_CSRC}", "-c", str(src), "-o",
                 str(obj)] for src, obj in zip(cu, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        try:
            report = "".join(_check(proc, cmd)
                             for proc, cmd in zip(procs, cmds))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp = tmpdir / so.name
        cmd = [nvcc, *_LINK_FLAGS, *map(str, objs), "-o", str(tmp)]
        _check(subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True), cmd)
        os.replace(tmp, so)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return report


def ptxas_report() -> str:
    """ptxas's per-kernel registers, shared memory and spills, if this
    process built the library ("" if it loaded an earlier build)."""
    return _ptxas_log


def check_tensors(named, device) -> None:
    """Raise unless each (name, tensor, shape) in ``named`` is a contiguous
    float32 tensor of that shape on ``device``, as a kernel takes it."""
    for name, t, shape in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_shared_memory(lib: ctypes.CDLL, need: int, what: str) -> None:
    """Raise if a block needs more dynamic shared memory than this card
    lets one block opt in to."""
    limit = lib.tpunav_max_dynamic_smem()
    if need > limit:
        raise ValueError(f"{what} needs {need} bytes of shared memory per "
                         f"block; this card allows {limit}")


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error."""
    if err != 0:
        msg = lib.tpunav_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, _ptxas_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _ptxas_log = _compile(so)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    for name, nargs in [("tpunav_mppi_solve", 11),
                        ("tpunav_likelihood_field", 6),
                        ("tpunav_map_update", 9), ("tpunav_edt", 4)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp] * nargs
    lib.tpunav_max_dynamic_smem.restype = ctypes.c_int
    lib.tpunav_max_dynamic_smem.argtypes = []
    lib.tpunav_cuda_error_string.restype = ctypes.c_char_p
    lib.tpunav_cuda_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
