"""MultiSlotDataFeed: Python wrapper over the native threaded reader.

Reference analog: framework/data_feed.h:224 (MultiSlotDataFeed) configured
by data_feed.proto and driven by AsyncExecutor's worker threads
(async_executor.cc:236). Here the C++ threads parse and batch; Python
iterates numpy batches ready to feed the Executor (or wraps them with
reader.double_buffer for device prefetch).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from . import load

__all__ = ["MultiSlotDataFeed", "SlotDesc"]


class SlotDesc:
    """One slot: name, dtype ('int64'|'float32'), fixed width (pad/trunc).
    data_feed.proto analog."""

    def __init__(self, name: str, dtype: str, width: int):
        assert dtype in ("int64", "float32")
        self.name = name
        self.dtype = dtype
        self.width = width


class MultiSlotDataFeed:
    def __init__(self, files: Sequence[str], slots: Sequence[SlotDesc],
                 batch_size: int, n_threads: int = 2, epochs: int = 1,
                 pad_value: int = 0, queue_capacity: int = 64):
        self._lib = load("datafeed")
        self._lib.mdf_create.restype = ctypes.c_void_p
        self._lib.mdf_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        self._lib.mdf_start.argtypes = [ctypes.c_void_p]
        self._lib.mdf_next_batch.restype = ctypes.c_void_p
        self._lib.mdf_next_batch.argtypes = [ctypes.c_void_p]
        self._lib.mdf_batch_rows.argtypes = [ctypes.c_void_p]
        self._lib.mdf_batch_data.restype = ctypes.c_void_p
        self._lib.mdf_batch_data.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int]
        self._lib.mdf_batch_free.argtypes = [ctypes.c_void_p]
        self._lib.mdf_destroy.argtypes = [ctypes.c_void_p]

        self.slots = list(slots)
        self.batch_size = batch_size
        types = (ctypes.c_int * len(slots))(
            *[0 if s.dtype == "int64" else 1 for s in slots])
        widths = (ctypes.c_int * len(slots))(*[s.width for s in slots])
        self._h = self._lib.mdf_create(
            ",".join(files).encode(), batch_size, len(slots), types, widths,
            n_threads, epochs, pad_value, queue_capacity)
        self._started = False

    def start(self):
        if not self._started:
            self._lib.mdf_start(self._h)
            self._started = True

    def __iter__(self) -> Iterator[List[np.ndarray]]:
        from ..observe import mark_batch_produced
        from ..observe.families import DATA_BATCHES

        batches = DATA_BATCHES.labels(source="datafeed")
        self.start()
        while True:
            b = self._lib.mdf_next_batch(self._h)
            if not b:
                return
            rows = self._lib.mdf_batch_rows(b)
            out = []
            for i, s in enumerate(self.slots):
                is_int = 1 if s.dtype == "int64" else 0
                ptr = self._lib.mdf_batch_data(b, i, is_int)
                n = rows * s.width
                ctype = ctypes.c_int64 if is_int else ctypes.c_float
                buf = (ctype * n).from_address(ptr)
                arr = np.ctypeslib.as_array(buf).reshape(rows, s.width).copy()
                out.append(arr)
            self._lib.mdf_batch_free(b)
            batches.inc()
            mark_batch_produced()
            yield out

    def feed_dict(self) -> Iterator[dict]:
        for arrs in self:
            yield {s.name: a for s, a in zip(self.slots, arrs)}

    def close(self):
        if self._h:
            self._lib.mdf_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
