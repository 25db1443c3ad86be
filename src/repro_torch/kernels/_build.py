"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; it may
include the headers in ``kernels/csrc/``. It is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) the
first time it is needed, and loaded with ``ctypes``. The library name
carries a hash of the source, the shared headers and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. A failed build raises; nothing is
downloaded.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
HEADERS_DIR = KERNELS_DIR / "csrc"     # headers the sources include
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: seconds each kernel's nvcc took in this process (0.0 when reused)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _target(name: str) -> Path:
    h = hashlib.sha1(_source(name).read_bytes())
    for header in sorted(HEADERS_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict[str, ctypes.CDLL]:
    """Build (in parallel, one ``nvcc`` per source) and load the kernels
    ``names``; returns ``{name: CDLL}``. Already-loaded kernels are reused."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for n in todo:
            out = _target(n)
            if out.exists():
                build_seconds[n] = 0.0
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(n))]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out, time.perf_counter())
        errors = []
        for n, (p, tmp, out, t0) in procs.items():
            log, _ = p.communicate()
            build_seconds[n] = time.perf_counter() - t0
            if p.returncode != 0:
                errors.append(f"nvcc failed for {_source(n)}:\n{log}")
                continue
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_target(n)))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build([name])[name]
