"""MQ2007 learning-to-rank schema dataset (reference:
python/paddle/dataset/mq2007.py).

train/test take format in {"pointwise", "pairwise", "listwise"}:
    pointwise: (relevance_score, feature[46])
    pairwise:  (label=1, better_feature[46], worse_feature[46])
    listwise:  (score_list [L], feature_list [L, 46])
Relevance in the surrogate comes from a fixed linear model over the 46
LETOR features (+ noise, discretized to 0/1/2), so rankers train.
"""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]

FEATURE_DIM = 46
_W = None


def _w():
    global _W
    if _W is None:
        _W = np.random.RandomState(81).randn(FEATURE_DIM).astype("float32")
    return _W


def _queries(n, seed):
    rng = np.random.RandomState(seed)
    w = _w()
    for _ in range(n):
        docs = int(rng.randint(5, 15))
        feats = rng.rand(docs, FEATURE_DIM).astype("float32")
        raw = feats @ w + 0.2 * rng.randn(docs).astype("float32")
        qs = np.quantile(raw, [0.5, 0.85])
        scores = np.digitize(raw, qs).astype("float32")  # 0/1/2
        yield scores, feats


def _reader(n, seed, format):
    def pointwise():
        for scores, feats in _queries(n, seed):
            for s, f in zip(scores, feats):
                yield float(s), np.array(f)

    def pairwise():
        rng = np.random.RandomState(seed + 1)
        for scores, feats in _queries(n, seed):
            order = np.argsort(-scores)
            for i in range(len(order)):
                for j in range(i + 1, len(order)):
                    hi, lo = order[i], order[j]
                    if scores[hi] == scores[lo]:
                        continue
                    if rng.rand() < 0.25:  # subsample pairs
                        yield (np.array(1.0, "float32"),
                               np.array(feats[hi]), np.array(feats[lo]))

    def listwise():
        for scores, feats in _queries(n, seed):
            yield np.array(scores), np.array(feats)

    table = {"pointwise": pointwise, "pairwise": pairwise,
             "listwise": listwise}
    if format not in table:
        raise ValueError("format must be pointwise/pairwise/listwise, got %r"
                         % format)
    return table[format]


def train(format="pairwise"):
    return _reader(256, seed=83, format=format)


def test(format="pairwise"):
    return _reader(64, seed=87, format=format)
