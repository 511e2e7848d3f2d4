"""Combined-tensor checkpoint file (PTCK), read and written in pure Python.

The same on-disk format as paddle_tpu/native/tensor_store.cc, so a
directory either package writes loads in the other. Little-endian:

    magic "PTCK" | u32 format_version (1) | u32 n_tensors
    per tensor: u32 name_len | name | u8 dtype | u8 ndim | i64 dims[ndim]
                | u64 nbytes | raw data

Dtype codes are the JAX package's table (native/dtypes.py); bfloat16
(code 5) has no numpy dtype here and is refused. Writes go to a staging
file renamed into place, so a failed save never clobbers a good file;
the ``checkpoint.write`` fault site sits between a complete staging file
and its rename, and each save first removes the staging files that dead
writers left for the same target (the JAX package's
``_clean_orphan_tmps``).
"""

from __future__ import annotations

import glob as _glob
import itertools
import os
import struct
from typing import Dict

import numpy as np

__all__ = ["MAGIC", "save_tensors", "load_tensors"]

MAGIC = b"PTCK"
_VERSION = 1
_TMP_SEQ = itertools.count(1)

_CODE_OF_DTYPE = {
    np.dtype("float32"): 0,
    np.dtype("int64"): 1,
    np.dtype("float64"): 2,
    np.dtype("int32"): 3,
    np.dtype("uint8"): 4,
    np.dtype("bool"): 6,
    np.dtype("float16"): 7,
    np.dtype("int8"): 8,
    np.dtype("uint32"): 9,
    np.dtype("int16"): 10,
}
_DTYPE_OF_CODE = {c: d for d, c in _CODE_OF_DTYPE.items()}


def _code_of(dtype) -> int:
    code = _CODE_OF_DTYPE.get(np.dtype(dtype))
    if code is None:
        raise TypeError("dtype %s is not serializable (known: %s)"
                        % (dtype, sorted(str(d) for d in _CODE_OF_DTYPE)))
    return code


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        # EPERM etc: the pid exists but isn't ours — treat as alive
        return True
    return True


def _clean_orphan_tmps(path: str) -> None:
    """Remove staging files for THIS target left by DEAD writer pids — a
    SIGKILLed/power-lost writer dies between the tmp write and the
    rename, and nothing else ever collects its litter. Live pids (a
    concurrent writer in another process) are never touched; neither is
    this process's own staging (same-path writes serialize in io.py, so
    any same-pid tmp seen here belongs to an in-flight writer)."""
    for tmp in _glob.glob(_glob.escape(path) + ".tmp.*"):
        parts = tmp[len(path):].split(".")  # ['', 'tmp', '<pid>', '<seq>']
        try:
            pid = int(parts[2])
        except (IndexError, ValueError):
            continue
        if pid == os.getpid() or _pid_alive(pid):
            continue
        try:
            os.remove(tmp)
        except OSError:
            continue
        from ..observe.families import RESILIENCE_ORPHANS_CLEANED

        RESILIENCE_ORPHANS_CLEANED.inc()


def save_tensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    _clean_orphan_tmps(path)
    prepared = []
    for name, arr in tensors.items():
        a = np.asarray(arr)
        if not a.flags["C_CONTIGUOUS"]:  # (ascontiguousarray makes 0-d 1-d)
            a = np.ascontiguousarray(a).reshape(a.shape)
        prepared.append((name.encode(), a, _code_of(a.dtype)))
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), next(_TMP_SEQ))
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC + struct.pack("<II", _VERSION, len(prepared)))
            for name, a, code in prepared:
                f.write(struct.pack("<I", len(name)) + name)
                f.write(struct.pack("<BB", code, a.ndim))
                f.write(struct.pack("<%dq" % a.ndim, *a.shape))
                f.write(struct.pack("<Q", a.nbytes))
                f.write(a.astype(a.dtype.newbyteorder("<"), copy=False)
                        .tobytes())
        # fault-injection site, EXACTLY in the crash window that matters:
        # the staged tmp is complete, the rename has not happened — a
        # 'crash' here leaves the litter a real power loss leaves
        # (previous checkpoint intact, orphaned tmp on disk, collected by
        # the next save); a 'raise' surfaces like any transient write
        # error (the finally below removes the staging file)
        from ..resilience.faults import fault_point

        fault_point("checkpoint.write")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_tensors(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC or len(data) < 12:
        raise IOError("cannot read checkpoint %s (missing or bad header)"
                      % path)
    version, count = struct.unpack_from("<II", data, 4)
    if version != _VERSION:
        raise IOError("checkpoint %s has format version %d, expected %d"
                      % (path, version, _VERSION))
    pos = 12
    out: Dict[str, np.ndarray] = {}
    try:
        for _ in range(count):
            (nlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            name = data[pos:pos + nlen].decode()
            pos += nlen
            code, ndim = struct.unpack_from("<BB", data, pos)
            pos += 2
            shape = struct.unpack_from("<%dq" % ndim, data, pos)
            pos += 8 * ndim
            (nbytes,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            if code not in _DTYPE_OF_CODE:
                raise TypeError("tensor %r in %s has dtype code %d, which "
                                "this reader does not support"
                                % (name, path, code))
            dt = _DTYPE_OF_CODE[code].newbyteorder("<")
            if pos + nbytes > len(data):
                raise IOError("checkpoint %s is truncated" % path)
            arr = np.frombuffer(data, dtype=dt, count=nbytes // dt.itemsize,
                                offset=pos).reshape(shape)
            out[name] = arr.astype(dt.newbyteorder("="))
            pos += nbytes
    except struct.error as e:
        raise IOError("checkpoint %s is truncated: %s" % (path, e)) from None
    return out
