"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` at the root of the checkout (the hash is
of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds). Nothing is
built when a module is imported: the first call that needs a kernel
builds it. ``build_all`` starts one nvcc per source at once, so several
kernels build in the time of the slowest.

No fallback: a failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header, so an edited header rebuilds too
    for fn in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                      if f.endswith(".cuh")):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all nvcc processes
    running together. Returns {name: ptxas report} for what was built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if os.path.isfile(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    reports, failed = {}, []
    for name, (p, tmp, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        return lib
