"""Movie-review sentiment schema dataset (reference:
python/paddle/dataset/sentiment.py — NLTK movie_reviews corpus).

Samples are (word_id_list, polarity) with polarity 0=negative,
1=positive. The surrogate plants class-marker words with class-dependent
frequency so bag-of-words/LSTM classifiers separate it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "get_word_dict"]

_VOCAB = 2048
_NEG_MARKERS = list(range(10, 40))
_POS_MARKERS = list(range(40, 70))


def get_word_dict():
    """Sorted word->id dict (reference sentiment.get_word_dict)."""
    return {"w%04d" % i: i for i in range(_VOCAB)}


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            pol = int(rng.randint(2))
            ln = int(rng.randint(8, 40))
            ids = rng.randint(70, _VOCAB, ln)
            markers = _POS_MARKERS if pol else _NEG_MARKERS
            k = max(1, ln // 4)
            pos = rng.choice(ln, k, replace=False)
            ids[pos] = rng.choice(markers, k)
            yield [int(i) for i in ids], pol

    return reader


def train():
    return _reader(4096, seed=41)


def test():
    return _reader(512, seed=43)
