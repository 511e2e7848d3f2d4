"""Host-side native pieces of the port.

``tensor_store`` reads and writes the JAX package's checkpoint format in
pure Python. ``datafeed.cc`` (the threaded MultiSlot parser behind
``data_feed.MultiSlotDataFeed``) is the port's own copy of the C++
source: at first use ``load`` compiles it with the host's C++ compiler
(``$CXX``, else ``g++``, else ``c++``) into ``paddle_tpu_torch/_build/``,
named by a hash of the source and the flags (``CXX_FLAGS``: the C++
runtime linked in and kept private), and checks its exported symbols.
The port loads no shared library of the JAX package and builds
nothing beside its sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

__all__ = ["BUILD_DIR", "CXX_FLAGS", "lib_path", "load"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# The library carries its own C++ runtime: libstdc++ and libgcc linked
# statically, their symbols kept local (--exclude-libs), and its own
# template instantiations bound to itself (-Bsymbolic), so the stream and
# locale code it runs is the code its headers were compiled against,
# whichever C++ runtime the host process (PyTorch) loaded first and however
# the compiler links by default. A compiler that linked the whole runtime
# into the library and exported it put two runtimes in one process, and
# the parser's number extraction overflowed a reader thread's stack.
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL",
             "-Wl,-Bsymbolic")
# the C API each library must export
_SYMBOLS = {"datafeed": ("mdf_create", "mdf_start", "mdf_next_batch",
                         "mdf_batch_rows", "mdf_batch_data",
                         "mdf_batch_free", "mdf_destroy")}
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, g++ or c++ on PATH): "
                       "the native data feed is built from "
                       "paddle_tpu_torch/native/datafeed.cc at first use")


def lib_path(name: str) -> str:
    """Where ``load(name)`` builds ``native/<name>.cc``: a file of
    ``BUILD_DIR`` named by a hash of the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(_DIR, name + ".cc"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:16]))


def _build(name: str) -> str:
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp.%d" % (out, os.getpid())
    cmd = [_compiler(), *CXX_FLAGS, os.path.join(_DIR, name + ".cc"),
           "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("building native/%s.cc failed (%s):\n%s" % (
            name, " ".join(cmd), (r.stdout + r.stderr)[-4000:]))
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cc``, built at first use, with its
    C API checked."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(_build(name))
            missing = [s for s in _SYMBOLS.get(name, ())
                       if not hasattr(lib, s)]
            if missing:
                raise RuntimeError("%s exports no %s" % (lib._name,
                                                         missing))
            _LIBS[name] = lib
    return _LIBS[name]
