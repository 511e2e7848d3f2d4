"""ctr_reader: file-driven feeding for CTR models.

Reference: python/paddle/fluid/contrib/reader/ctr_reader.py:53 — a
reader over csv/svm click logs (gzip or plain) that feeds the program's
data vars asynchronously while Executor.run consumes batches. Here it
returns a PyReader (layers/io.py: producer thread + staged, stream-
ordered copy to the card — the C++ ctr_reader_op's queue/threads subsumed by that and
by the native MultiSlotDataFeed for the multi-slot format).

Formats (reference docstring):
  csv:  label dense,dense,... sparse,sparse,...
  svm:  label slot:sign slot:sign ...
"""

from __future__ import annotations

import gzip
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ...layers.io import PyReader

__all__ = ["ctr_reader"]


def _open(path: str, file_type: str):
    if file_type == "gzip":
        return gzip.open(path, "rt")
    return open(path, "r")


def _parse_csv(line: str, dense_slot_index: Sequence[int],
               sparse_slot_index: Sequence[int]):
    """`label dense,dense sparse,sparse` — the space-separated columns
    are picked by position: column i (1-based after the label) is dense
    (float32) if i is in dense_slot_index, sparse (int64) if in
    sparse_slot_index. One field per column, in column order, so the
    sample binds positionally to feed_dict no matter how dense and
    sparse columns interleave."""
    cols = line.split()
    out: List[np.ndarray] = [np.array([int(cols[0])], dtype=np.int64)]
    for i, col in enumerate(cols[1:], start=1):
        vals = col.split(",")
        if i in dense_slot_index:
            out.append(np.array([float(v) for v in vals], dtype=np.float32))
        elif i in sparse_slot_index:
            out.append(np.array([int(v) for v in vals], dtype=np.int64))
    return tuple(out)


def _parse_svm(line: str, slots: Sequence[int]):
    """`label slot:sign slot:sign ...` — one int64 id list per slot id
    in ``slots`` order (empty slots yield [0])."""
    cols = line.split()
    label = np.array([int(cols[0])], dtype=np.int64)
    by_slot = {int(s): [] for s in slots}
    for col in cols[1:]:
        sid, sign = col.split(":", 1)
        sid = int(sid)
        if sid in by_slot:
            by_slot[sid].append(int(sign))
    out = [label]
    for s in slots:
        ids = by_slot[int(s)] or [0]
        out.append(np.array(ids, dtype=np.int64))
    return tuple(out)


def _batch(samples: List[tuple]):
    """Stack a list of per-sample tuples field-wise, padding ragged
    int64 id fields to the batch max width."""
    fields = []
    for i in range(len(samples[0])):
        vals = [s[i] for s in samples]
        width = max(v.shape[0] for v in vals)
        if any(v.shape[0] != width for v in vals):
            vals = [np.pad(v, (0, width - v.shape[0])) for v in vals]
        fields.append(np.stack(vals))
    return tuple(fields)


def ctr_reader(feed_dict, file_type, file_format, dense_slot_index,
               sparse_slot_index, capacity, thread_num, batch_size,
               file_list: Iterable[str], slots: Sequence[int],
               name: Optional[str] = None, places=None) -> PyReader:
    """Build the reader (reference signature, :53). Returns a PyReader
    bound to ``feed_dict`` (the data vars, in sample-field order); call
    it to iterate feed dicts while a producer thread parses files and
    prefetches batches to the device: the card, unless ``places`` is
    ``CPUPlace()`` (``PyReader.decorate_batch_generator``'s argument).
    ``thread_num`` is accepted for API parity — the producer is the
    PyReader thread (parsing is far cheaper than the train step it
    overlaps)."""
    if file_type not in ("gzip", "plain"):
        raise ValueError("file_type must be 'gzip' or 'plain', got %r"
                         % file_type)
    if file_format not in ("csv", "svm"):
        raise ValueError("file_format must be 'csv' or 'svm', got %r"
                         % file_format)

    files = list(file_list)

    def gen():
        buf: List[tuple] = []
        for path in files:
            with _open(path, file_type) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if file_format == "csv":
                        sample = _parse_csv(line, dense_slot_index,
                                            sparse_slot_index)
                    else:
                        sample = _parse_svm(line, slots)
                    if len(sample) != len(feed_dict):
                        raise ValueError(
                            "sample has %d fields but feed_dict binds %d "
                            "vars" % (len(sample), len(feed_dict)))
                    buf.append(sample)
                    if len(buf) == batch_size:
                        yield _batch(buf)
                        buf = []
        if buf:
            yield _batch(buf)

    reader = PyReader(feed_list=list(feed_dict), capacity=capacity)
    reader.decorate_batch_generator(gen, places=places)
    return reader
