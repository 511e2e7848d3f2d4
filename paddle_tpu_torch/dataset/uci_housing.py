"""UCI-housing-schema dataset (reference: python/paddle/dataset/uci_housing.py).
Samples: (13-float feature vector, 1-float price). Synthetic linear+noise."""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "feature_range"]

_W = None


def _gen(n, seed):
    global _W
    if _W is None:
        _W = np.random.RandomState(99).randn(13).astype("float32")

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            x = rng.rand(13).astype("float32")
            y = float(x @ _W + 0.1 * rng.randn())
            yield x, np.array([y], "float32")

    return reader


def train(n=404):
    return _gen(n, seed=0)


def test(n=102):
    return _gen(n, seed=1)


def feature_range():
    return np.zeros(13), np.ones(13)
