"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each source ``repro_torch/csrc/<name>.cu`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  Libraries land in ``build/kernels/`` at the
repo root (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags: the first use builds, a
rerun on the same sources loads the existing library.  Several sources,
and several ``-D`` variants of one, build at once, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module on a
box that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("flash_attention", "ssd_scan", "decode_attention",
                  "optimizer", "train_attention", "norm_rope",
                  "moe_dispatch", "gated_mlp", "cross_entropy")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.RLock()
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The library of ``csrc/<name>.cu`` built with ``-D`` ``defines``,
    named by a hash of the source, the shared headers and the flags."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    flags = " ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_log(name: str, defines: Tuple[str, ...] = ()) -> str:
    """The compiler's output of the last build (ptxas register and shared
    memory use per kernel), or '' if the library was built earlier."""
    log = lib_path(name, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _kernel_name(mangled: str) -> str:
    """'flash_mma_kernel<128,64,32>' from an Itanium-mangled kernel name:
    the last identifier of the nested name, with its integer and bool
    template arguments."""
    pos, ident = 3 if mangled.startswith("_ZN") else 2, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        ident = mangled[pos + len(n):pos + len(n) + int(n)]
        pos += len(n) + int(n)
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[pos:])
    if args:
        ident += "<" + ",".join(re.findall(r"L[ib](-?\d+)E",
                                           args.group(1))) + ">"
    return ident


def ptxas_summary(name: str, defines: Tuple[str, ...] = ()) -> List[dict]:
    """Per kernel of the last build's log: its name with template
    arguments, registers, spill bytes (stores + loads, ptxas -v) and the
    ptxas warnings that name it (e.g. wgmma serialised, setmaxnreg
    ignored)."""
    out: List[dict] = []
    mangled: Dict[str, dict] = {}
    for line in build_log(name, defines).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        named = re.search(r"function '(\w+)'", line)
        if entry:
            out.append({"kernel": _kernel_name(entry.group(1)),
                        "registers": None, "spill_bytes": 0, "warnings": []})
            mangled[entry.group(1)] = out[-1]
        elif named and named.group(1) in mangled:
            mangled[named.group(1)]["warnings"].append(
                line.split(":", 1)[-1].strip())
        elif out and "spill" in line:
            out[-1]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif out and "registers" in line:
            out[-1]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def build(names: Iterable[str] = KERNEL_SOURCES,
          defines: Tuple[str, ...] = (),
          variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()) -> float:
    """Compile every named source (with ``defines``) and every (source,
    defines) of ``variants`` that has no library yet, all at once.

    Returns the seconds spent; raises with the compiler output on failure."""
    t0 = time.monotonic()
    with _LOCK:
        todo = [(n, tuple(d)) for n, d in
                [(n, defines) for n in names] + list(variants)
                if not lib_path(n, tuple(d)).exists()]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for n, defs in todo:
            out = lib_path(n, defs)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defs), "-o",
                   str(tmp), str(CSRC / f"{n}.cu")]
            jobs.append((n, defs, out, tmp, log,
                         subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT)))
        failed = []
        for n, defs, out, tmp, log, proc in jobs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n} {list(defs)} (rc {rc}):\n"
                              f"{build_log(n, defs)}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (with ``-D`` ``defines``),
    built first if needed."""
    key = (name, tuple(defines))
    with _LOCK:
        if key not in _LIBS:
            build([name], key[1])
            _LIBS[key] = ctypes.CDLL(str(lib_path(name, key[1])))
        return _LIBS[key]


def launch(device, fn, *args) -> int:
    """``fn(*args, stream)``: a C entry point called with ``device`` (a
    CUDA ``torch.device``) current and its current stream, with no device
    switch when it is current already.  Returns what ``fn`` returns (the
    launch's ``cudaError_t``)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
