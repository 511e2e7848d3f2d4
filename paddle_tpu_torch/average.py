"""WeightedAverage (reference python/paddle/fluid/average.py:40): a tiny
host-side running average over fetched batch values — kept because user
training loops port it directly (`avg.add(value=loss_v, weight=bs)`)."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _to_scalar_and_weight(value, weight):
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0 or arr.size == 1:
        return float(arr.reshape(-1)[0]), float(weight if weight is not None
                                                else 1.0)
    # a matrix averages over its rows, weighted by row count, matching
    # the reference's _is_number_or_matrix_ handling
    return float(arr.mean()), float(weight if weight is not None
                                    else arr.shape[0])


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight=None):
        if value is None:
            return
        v, w = _to_scalar_and_weight(value, weight)
        self.numerator += v * w
        self.denominator += w

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "WeightedAverage has accumulated nothing: add() values "
                "before eval()")
        return self.numerator / self.denominator
