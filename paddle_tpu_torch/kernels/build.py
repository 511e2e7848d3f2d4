"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so``; the hash covers the source, the
headers beside it and the flags, so an edited kernel rebuilds and an
unchanged one loads straight from disk. The build runs at first use
(``load``) or for every source at once, in parallel (``build_all``).
nvcc comes from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or
``PATH``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_all",
           "device_launches", "load", "ptxas_report", "sources"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels build only where the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    deps = [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for p in deps:
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def _start(name: str):
    """Launch nvcc for one source into a staging file; returns
    (process, staging path, final path)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _lib_path(name)
    tmp = "%s.tmp.%d" % (out, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc failed for %s.cu (exit %d):\n%s"
                           % (name, proc.returncode, log))
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all() -> Dict[str, float]:
    """Compile every source that has no current build, one nvcc process
    per source, all started together. Returns seconds per kernel built
    (an empty dict when everything was current)."""
    with _LOCK:
        todo = [n for n in sources() if not os.path.exists(_lib_path(n))]
        t0 = time.perf_counter()
        started = [(n, _start(n)) for n in todo]
        took = {}
        errors = []
        for n, (proc, tmp, out) in started:
            try:
                _finish(n, proc, tmp, out)
            except RuntimeError as e:  # let the other builds finish first
                errors.append(str(e))
            took[n] = time.perf_counter() - t0
        if errors:
            raise RuntimeError("\n".join(errors))
        return took


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiling it first if
    needed. The caller declares argtypes and restype."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not os.path.exists(path):
            _finish(name, *_start(name))
        lib = _LOADED[name] = ctypes.CDLL(path)
        return lib


def device_launches(name: str, slots: int) -> List[int]:
    """The launches of ``csrc/<name>.cu``'s kernels the card has run, per
    slot of its ``g_launches`` (the source says which kernel counts in
    which): each kernel counts itself on the device
    (``csrc/launch_count.cuh``), so the launches a CUDA graph's replay
    makes, where no host code runs, count too. Read after the card has
    finished the work to count."""
    out = (ctypes.c_ulonglong * slots)()
    err = getattr(load(name), name + "_device_launches")(out)
    if err:
        raise RuntimeError("reading %s's launch counters failed with "
                           "cudaError %d" % (name, err))
    return list(out)


def ptxas_report(name: str) -> str:
    """What ``-Xptxas=-v`` said when this kernel was built (registers,
    shared memory and spills per kernel), or '' before a build."""
    log = _lib_path(name) + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()
