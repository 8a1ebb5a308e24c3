"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each source ``repro_torch/csrc/<name>.cu`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  Libraries land in ``build/kernels/`` at the
repo root (listed in ``.gitignore``), named by a hash of the source and the
flags: the first use builds, a rerun on the same sources loads the
existing library.  Several sources build at once, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module on a
box that has no ``nvcc``.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.RLock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output of the last build (ptxas register and shared
    memory use per kernel), or '' if the library was built earlier."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Compile every named source that has no library yet, all at once.

    Returns the seconds spent; raises with the compiler output on failure."""
    t0 = time.monotonic()
    with _LOCK:
        todo = [n for n in names if not lib_path(n).exists()]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for n in todo:
            out = lib_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            jobs.append((n, out, tmp, log,
                         subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT)))
        failed = []
        for n, out, tmp, log, proc in jobs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n} (rc {rc}):\n{build_log(n)}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
        return _LIBS[name]
