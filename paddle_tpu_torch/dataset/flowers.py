"""Oxford-102 flowers schema dataset (reference:
python/paddle/dataset/flowers.py).

Samples are (float32 image [3*224*224] flattened in [0,1], label 0..101)
— the reference's default mapper emits the transformed image array. The
surrogate renders class-specific colored radial blobs so a small CNN can
separate classes. use_xmap is accepted for signature parity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "valid"]

NUM_CLASSES = 102
_HW = 224


_GRID = None


def _grid():
    global _GRID
    if _GRID is None:
        y, x = np.mgrid[0:_HW, 0:_HW].astype("float32") / _HW - 0.5
        _GRID = (x, y)
    return _GRID


def _render(label, rng):
    x, y = _grid()
    cx, cy = (label % 10 - 4.5) / 12.0, (label // 10 - 4.5) / 12.0
    r2 = (x - cx) ** 2 + (y - cy) ** 2
    blob = np.exp(-r2 * (20 + label % 7 * 8)).astype("float32")
    base = np.stack([
        blob * ((label * 37 % 97) / 97.0),
        blob * ((label * 61 % 89) / 89.0),
        blob * ((label * 17 % 83) / 83.0),
    ])
    img = base + 0.08 * rng.rand(3, _HW, _HW).astype("float32")
    return np.clip(img, 0.0, 1.0).reshape(-1)


def _reader(n, seed, cycle=False):
    def reader():
        rng = np.random.RandomState(seed)
        while True:
            for _ in range(n):
                label = int(rng.randint(NUM_CLASSES))
                yield _render(label, rng), label
            if not cycle:
                return

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(1024, seed=61, cycle=cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(128, seed=63, cycle=cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(128, seed=67)
