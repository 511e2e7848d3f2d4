"""DataFeeder: minibatch list -> feed dict of dense arrays.

Analog of the reference's python/paddle/fluid/data_feeder.py:100. The
reference converts to LoDTensors; here ragged samples are padded to the
batch max (static-shape contract) — LoD survives as an optional lengths
array per slot.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.feed_vars = feed_list
        self.place = place

    def feed(self, iterable: Sequence[Sequence]) -> Dict[str, np.ndarray]:
        cols: List[List] = [[] for _ in self.feed_vars]
        for row in iterable:
            for i, item in enumerate(row):
                cols[i].append(np.asarray(item))
        out = {}
        for var, col in zip(self.feed_vars, cols):
            arrs = col
            shapes = {a.shape for a in arrs}
            if len(shapes) == 1:
                batch = np.stack(arrs)
            else:
                # ragged: pad to per-dim max (LoD -> padded dense)
                nd = arrs[0].ndim
                maxs = [max(a.shape[d] for a in arrs) for d in range(nd)]
                batch = np.zeros((len(arrs), *maxs), dtype=arrs[0].dtype)
                for j, a in enumerate(arrs):
                    sl = tuple(slice(0, s) for s in a.shape)
                    batch[(j, *sl)] = a
            want = np.dtype(var.dtype) if var.dtype != "bool" else np.bool_
            if batch.dtype != want:
                batch = batch.astype(want)
            shape = var.shape
            if shape and len(shape) == batch.ndim + 1 and shape[-1] == 1:
                batch = batch[..., None]  # paddle-style trailing label dim
            out[var.name] = batch
        return out
