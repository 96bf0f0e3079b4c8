"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``). The library's file name carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt and an unchanged one is loaded as
it is. Nothing here runs when the module is
imported: the CPU tests import every module, and this host need not have
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return str(path)


def _target(name: str) -> Path:
    """The library's path, keyed by the source, every shared header
    (``csrc/*.cuh``, which any source may include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Writes each compiler
    log beside its library. Returns the wall seconds spent; raises with the
    log of the first source that fails."""
    names = list(sources() if names is None else names)
    todo = [n for n in names if not _target(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        log = open(_target(n).with_suffix(".log"), "w")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, _target(n))
        else:
            failed.append(n)
    if failed:
        n = failed[0]
        raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n"
                           + _target(n).with_suffix(".log").read_text())
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) for the current build of ``name``, or '' if it was not built
    by this checkout."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs[name]
