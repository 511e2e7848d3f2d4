"""dataset.common (reference python/paddle/dataset/common.py): cache
management, md5-verified downloads, and the pickle split/cluster-reader
utilities distributed training consumes.

Zero-egress adaptation: DATA_HOME comes from PADDLE_TPU_DATA_HOME
(default ~/.cache/paddle_tpu/dataset); download() serves md5-verified
files already present in the cache and supports file:// URLs (local
mirrors), but raises a clear error instead of reaching the network —
the dataset modules' synthetic surrogates remain the offline path.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
import shutil
from typing import Callable, List

__all__ = ["DATA_HOME", "data_home", "md5file", "must_mkdirs", "download",
           "split", "cluster_files_reader"]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                 "dataset"))


def data_home() -> str:
    """The data root, honoring PADDLE_TPU_DATA_HOME set AFTER import
    (tests, notebooks); falls back to the cached default. Loaders use
    this, not the import-time DATA_HOME constant."""
    return os.environ.get("PADDLE_TPU_DATA_HOME", DATA_HOME)


def must_mkdirs(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def md5file(fname: str) -> str:
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url: str, module_name: str, md5sum: str,
             save_name: str = None) -> str:
    """Return the cached, md5-verified path for `url` (reference :67).
    file:// URLs copy from the local filesystem; a cache hit with the
    right md5 is served as-is; anything needing network raises (this
    environment has no egress — see the module docstring)."""
    dirname = os.path.join(data_home(), module_name)
    must_mkdirs(dirname)
    filename = os.path.join(
        dirname, save_name or url.split("/")[-1])
    if os.path.exists(filename) and (not md5sum
                                     or md5file(filename) == md5sum):
        return filename
    if url.startswith("file://"):
        src = url[len("file://"):]
        shutil.copyfile(src, filename)
        if md5sum and md5file(filename) != md5sum:
            raise RuntimeError("md5 mismatch for %s (got %s, want %s)"
                               % (src, md5file(filename), md5sum))
        return filename
    raise RuntimeError(
        "%s is not cached under %s and this environment has no network "
        "egress; place the file there (or set PADDLE_TPU_DATA_HOME), or "
        "use the dataset module's synthetic surrogate" % (url, dirname))


def split(reader: Callable, line_count: int, suffix: str = "%05d.pickle",
          dumper=pickle.dump) -> List[str]:
    """Chunk a reader's samples into pickled files of `line_count`
    samples each (reference :137). Returns the written paths."""
    if not callable(reader):
        raise TypeError("reader must be callable")
    if "%" not in suffix:
        raise ValueError("suffix must contain a %d-style placeholder")
    out, lines, index = [], [], 0
    for sample in reader():
        lines.append(sample)
        if len(lines) == line_count:
            path = suffix % index
            with open(path, "wb") as f:
                dumper(lines, f)
            out.append(path)
            lines, index = [], index + 1
    if lines:
        path = suffix % index
        with open(path, "wb") as f:
            dumper(lines, f)
        out.append(path)
    return out


def cluster_files_reader(files_pattern: str, trainer_count: int,
                         trainer_id: int, loader=pickle.load) -> Callable:
    """Round-robin this trainer's share of the split files (reference
    :175): file i belongs to trainer (i % trainer_count)."""

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, path in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(path, "rb") as f:
                    for sample in loader(f):
                        yield sample

    return reader
