"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``.  Libraries go to ``kernels/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one is reused.  nvcc's output
(ptxas' registers, shared memory and spills) is kept beside the library as
``<library>.log`` and read back into ``PTXAS_LOG`` when the library is
reused.  Nothing builds at import time: the first call that needs a kernel
builds it.  ``build_all``
starts one nvcc per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_library", "build_all", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}   # name -> wall seconds of its nvcc run
PTXAS_LOG: Dict[str, str] = {}         # name -> nvcc/ptxas output of its build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin or PATH): the CUDA kernels build "
            "only on a machine with the CUDA toolkit"
        )
    return found


def _lib_path(name: str, flags: Sequence[str]) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str, flags: Sequence[str]):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(out, tmp, proc, t0)`` or ``None`` when there is nothing to build."""
    out = _lib_path(name, flags)
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        PTXAS_LOG[name] = log.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc, time.perf_counter()


def _finish(name: str, job) -> None:
    out, tmp, proc, t0 = job
    stdout, stderr = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    PTXAS_LOG[name] = stdout + stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{stdout}{stderr}"
        )
    out.with_suffix(".log").write_text(PTXAS_LOG[name])
    os.replace(tmp, out)


def build_all(names: Sequence[str], flags: Sequence[str] = NVCC_FLAGS) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` that is not built yet, all nvcc runs
    started together; raises after all have ended if any failed."""
    jobs = {n: _start(n, flags) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _lib_path(n, flags) for n in names}


def build_library(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already built; returns the library's path."""
    return build_all([name], flags)[name]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        _LOADED[name] = lib
    return lib
