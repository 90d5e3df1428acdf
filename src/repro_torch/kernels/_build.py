"""Build ``csrc/*.cu`` at first use and load each result through ``ctypes``.

Every source has a plain C interface (no PyTorch headers), so ``nvcc``
compiles it in seconds.  Sources may include the shared headers
``csrc/*.cuh``.  Each source becomes its own shared library in
``<package>/_build`` (listed in ``.gitignore``); :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.  A library
newer than its source and every header is reused.  ``nvcc`` is looked up under
``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then on ``PATH``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    inputs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (all by default) in parallel; returns each
    one's ``nvcc`` log (``-Xptxas -v``: registers, shared memory, spills),
    empty for a library that was already up to date."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: "" for name in names}
    failed = []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
