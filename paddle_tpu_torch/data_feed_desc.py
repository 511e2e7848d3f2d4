"""DataFeedDesc (reference python/paddle/fluid/data_feed_desc.py:21).

The reference wraps a protobuf-text data_feed.proto config consumed by
the C++ DataFeed. The port's native reader (native/datafeed.cc)
takes its slot schema programmatically (SlotDesc), so DataFeedDesc here
parses the same proto-text format into that schema and keeps the
reference's mutators (set_batch_size, set_use_slots, set_dense_slots).

    desc = DataFeedDesc('data.proto')
    desc.set_batch_size(128)
    feed = desc.create_feed(file_list)   # native MultiSlotDataFeed
"""

from __future__ import annotations

import re
from typing import List, Optional

__all__ = ["DataFeedDesc"]

_KV = re.compile(r"(\w+)\s*:\s*(\"[^\"]*\"|\S+)")


class _Slot:
    def __init__(self):
        self.name = ""
        self.type = "uint64"
        self.is_dense = False
        self.is_used = False
        self.dim = 1


class DataFeedDesc:
    def __init__(self, proto_file, batch_size: int = 32):
        """``proto_file``: a proto-text path (reference signature), or a
        list of native SlotDesc for programmatic construction (the
        AsyncExecutor idiom this repo already shipped)."""
        import os

        self.batch_size = batch_size
        self.name = "MultiSlotDataFeed"
        self.slots: List[_Slot] = []
        if isinstance(proto_file, (str, os.PathLike)):
            self._parse(os.fspath(proto_file))
        else:
            for sd in proto_file:
                s = _Slot()
                s.name = sd.name
                s.type = "float" if sd.dtype == "float32" else "uint64"
                s.is_dense = sd.dtype == "float32"
                s.is_used = True
                s.dim = sd.width
                self.slots.append(s)

    @property
    def slot_descs(self):
        """Native SlotDesc list of the used slots (AsyncExecutor feeds
        these to native/datafeed.cc)."""
        from .native.data_feed import SlotDesc

        used = [s for s in self.slots if s.is_used]
        if not used:
            raise ValueError("no used slots: call set_use_slots first")
        return [SlotDesc(s.name,
                         "float32" if s.type in ("float", "float32")
                         else "int64", s.dim)
                for s in used]

    # --------------------------------------------------------- proto text
    def _parse(self, path: str):
        cur: Optional[_Slot] = None
        depth_slot = 0
        with open(path) as f:
            lines = f.readlines()
        for raw in lines:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("slots") and "{" in line:
                cur = _Slot()
                depth_slot = 1
                line = line.split("{", 1)[1]
            if cur is not None:
                depth_slot += line.count("{") - line.count("}")
                for k, v in _KV.findall(line):
                    v = v.strip('"')
                    if k == "name":
                        cur.name = v
                    elif k == "type":
                        cur.type = v
                    elif k == "is_dense":
                        cur.is_dense = v.lower() == "true"
                    elif k == "is_used":
                        cur.is_used = v.lower() == "true"
                    elif k == "dim":
                        cur.dim = int(v)
                if depth_slot <= 0:
                    self.slots.append(cur)
                    cur = None
                continue
            for k, v in _KV.findall(line):
                v = v.strip('"')
                if k == "batch_size":
                    self.batch_size = int(v)
                elif k == "name":
                    self.name = v

    # ---------------------------------------------------------- mutators
    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_use_slots(self, use_slots_name: List[str]):
        wanted = set(use_slots_name)
        unknown = wanted - {s.name for s in self.slots}
        if unknown:
            raise ValueError("unknown slots %s" % sorted(unknown))
        for s in self.slots:
            s.is_used = s.name in wanted

    def set_dense_slots(self, dense_slots_name: List[str]):
        wanted = set(dense_slots_name)
        unknown = wanted - {s.name for s in self.slots}
        if unknown:
            raise ValueError("unknown slots %s" % sorted(unknown))
        for s in self.slots:
            s.is_dense = s.name in wanted

    def desc(self) -> str:
        """Round-trip back to proto text (reference .proto_desc print)."""
        lines = ["name: \"%s\"" % self.name,
                 "batch_size: %d" % self.batch_size]
        for s in self.slots:
            lines += ["slots {",
                      "  name: \"%s\"" % s.name,
                      "  type: \"%s\"" % s.type,
                      "  is_dense: %s" % str(s.is_dense).lower(),
                      "  is_used: %s" % str(s.is_used).lower(),
                      "  dim: %d" % s.dim,
                      "}"]
        return "\n".join(lines) + "\n"

    # --------------------------------------------------- native bridge
    def create_feed(self, files: List[str], n_threads: int = 2,
                    epochs: int = 1):
        """Instantiate the native MultiSlotDataFeed over the used slots
        (the C++ analog consumed this desc directly)."""
        from .native.data_feed import MultiSlotDataFeed

        return MultiSlotDataFeed(files, self.slot_descs, self.batch_size,
                                 n_threads=n_threads, epochs=epochs)
