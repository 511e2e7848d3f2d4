"""CIFAR-schema dataset (reference: python/paddle/dataset/cifar.py).
Samples: (3072-float image, int label). Synthetic class-template
surrogate by default; point PADDLE_TPU_DATA_HOME/cifar/ at the real
``cifar-10-python.tar.gz`` / ``cifar-100-python.tar.gz`` archives (the
reference's pickled-batch format, cifar.py:49 reader_creator) to train
on the actual corpus — the archive parse path is CI-tested against a
fixture archive in tests/test_dataset_real_parse.py."""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]

_T = {}


def _archive(num_classes):
    from .common import data_home

    name = ("cifar-10-python.tar.gz" if num_classes == 10
            else "cifar-100-python.tar.gz")
    path = os.path.join(data_home(), "cifar", name)
    return path if os.path.exists(path) else None


def _archive_reader(path, num_classes, split, n):
    """The reference's pickled-batch format: members named
    *data_batch* / *train* hold train data, *test_batch* / *test* hold
    test data; each unpickles to {b'data': uint8 [N,3072],
    b'labels'|b'fine_labels': [N]}. Images scale to [-1, 1] float32
    (matching the synthetic surrogate's range)."""
    want = ("data_batch", "train") if split == "train" else ("test",)
    label_key = b"labels" if num_classes == 10 else b"fine_labels"

    def reader():
        count = 0
        with tarfile.open(path, "r:gz") as tf:
            for member in tf.getmembers():
                base = os.path.basename(member.name)
                if not any(w in base for w in want):
                    continue
                batch = pickle.load(tf.extractfile(member),
                                    encoding="bytes")
                for img, lbl in zip(batch[b"data"], batch[label_key]):
                    if n is not None and count >= n:
                        return
                    yield (img.astype("float32") / 127.5 - 1.0, int(lbl))
                    count += 1

    return reader


def _reader(num_classes, n, seed, split):
    arch = _archive(num_classes)
    if arch:
        return _archive_reader(arch, num_classes, split, n)
    if n is None:
        n = 4096 if split == "train" else 512

    def reader():
        if num_classes not in _T:
            _T[num_classes] = np.random.RandomState(5).randn(
                num_classes, 3072).astype("float32") * 0.5
        t = _T[num_classes]
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(num_classes))
            img = np.clip(t[label] + 0.5 * rng.randn(3072), -1, 1).astype("float32")
            yield img, label

    return reader


def train10(n=None):
    """n=None reads the whole corpus on the archive path (synthetic
    surrogate defaults to 4096 samples)."""
    return _reader(10, n, seed=0, split="train")


def test10(n=None):
    return _reader(10, n, seed=1, split="test")


def train100(n=None):
    return _reader(100, n, seed=0, split="train")


def test100(n=None):
    return _reader(100, n, seed=1, split="test")
