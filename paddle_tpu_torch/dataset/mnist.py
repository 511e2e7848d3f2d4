"""MNIST-schema dataset (reference: python/paddle/dataset/mnist.py).

Samples are (784-float image in [-1,1], int label). Without real data on
disk, synthesizes digits as class-specific low-frequency templates + noise —
linearly separable enough that book-test convergence targets transfer.
Set PADDLE_TPU_DATA_HOME/mnist/{train,t10k}-* to use the real corpus.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["train", "test", "IMAGE_SIZE", "NUM_CLASSES"]

IMAGE_SIZE = 784
NUM_CLASSES = 10


def _templates():
    rng = np.random.RandomState(1234)
    t = rng.randn(NUM_CLASSES, IMAGE_SIZE).astype("float32")
    # low-pass: smooth templates so conv nets have spatial structure to find
    t = t.reshape(NUM_CLASSES, 28, 28)
    kernel = np.ones((5, 5), np.float32) / 25.0
    out = np.zeros_like(t)
    for c in range(NUM_CLASSES):
        padded = np.pad(t[c], 2, mode="edge")
        for i in range(28):
            for j in range(28):
                out[c, i, j] = float((padded[i:i + 5, j:j + 5] * kernel).sum())
    out /= np.abs(out).max()
    return out.reshape(NUM_CLASSES, IMAGE_SIZE)


_TEMPLATES = None


def _real_path(split):
    from .common import data_home

    home = data_home()
    name = {"train": "train", "test": "t10k"}[split]
    img = os.path.join(home, "mnist", "%s-images-idx3-ubyte" % name)
    lbl = os.path.join(home, "mnist", "%s-labels-idx1-ubyte" % name)
    if os.path.exists(img) and os.path.exists(lbl):
        return img, lbl
    return None


def _reader(split, n, seed):
    real = _real_path(split)
    if real is None:
        if n is None:
            n = 8192 if split == "train" else 1024
    if real:
        img_path, lbl_path = real

        def real_reader():
            with open(img_path, "rb") as f:
                f.read(16)
                imgs = np.frombuffer(f.read(), np.uint8).reshape(-1, IMAGE_SIZE)
            with open(lbl_path, "rb") as f:
                f.read(8)
                lbls = np.frombuffer(f.read(), np.uint8)
            stop = len(lbls) if n is None else min(n, len(lbls))
            for i in range(stop):
                yield imgs[i].astype("float32") / 127.5 - 1.0, int(lbls[i])

        return real_reader

    def synth_reader():
        global _TEMPLATES
        if _TEMPLATES is None:
            _TEMPLATES = _templates()
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(NUM_CLASSES))
            img = _TEMPLATES[label] + 0.35 * rng.randn(IMAGE_SIZE).astype("float32")
            yield np.clip(img, -1.0, 1.0).astype("float32"), label

    return synth_reader


def train(n=None):
    """n=None reads the whole corpus on the real-data path (synthetic
    surrogate defaults to 8192 samples)."""
    return _reader("train", n, seed=42)


def test(n=None):
    return _reader("test", n, seed=7)
