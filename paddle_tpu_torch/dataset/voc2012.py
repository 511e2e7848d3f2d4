"""PASCAL VOC2012 segmentation schema dataset (reference:
python/paddle/dataset/voc2012.py).

Samples are (image float32 [3, H, W] in [0,1], label int32 [H, W] with
class ids 0..20 and 255=ignore border) — the reference yields the
decoded image and its segmentation mask. The surrogate paints one or two
class rectangles per image with matching mask, border-marked 255.
"""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "val"]

NUM_CLASSES = 21
_HW = 128


def _sample(rng):
    img = 0.1 * rng.rand(3, _HW, _HW).astype("float32")
    mask = np.zeros((_HW, _HW), "int32")
    for _ in range(int(rng.randint(1, 3))):
        c = int(rng.randint(1, NUM_CLASSES))
        x1, y1 = rng.randint(0, _HW - 32, 2)
        w, h = rng.randint(24, min(64, _HW - max(x1, y1)), 2)
        color = np.array([(c * 37 % 97) / 97.0, (c * 61 % 89) / 89.0,
                          (c * 17 % 83) / 83.0], "float32")
        img[:, y1:y1 + h, x1:x1 + w] = color[:, None, None]
        mask[y1:y1 + h, x1:x1 + w] = c
        # border ignore ring, like VOC's 255-labeled object boundaries
        mask[y1, x1:x1 + w] = 255
        mask[min(y1 + h - 1, _HW - 1), x1:x1 + w] = 255
        mask[y1:y1 + h, x1] = 255
        mask[y1:y1 + h, min(x1 + w - 1, _HW - 1)] = 255
    return np.clip(img, 0, 1), mask


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield _sample(rng)

    return reader


def train():
    return _reader(512, seed=91)


def test():
    return _reader(64, seed=93)


def val():
    return _reader(64, seed=97)
