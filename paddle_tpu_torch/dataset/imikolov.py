"""imikolov (PTB) schema dataset (reference:
python/paddle/dataset/imikolov.py).

build_dict() -> word->id (with <unk>, and <s>/<e> added by the readers);
train/test yield n-gram tuples (DataType.NGRAM) or (src_seq, trg_seq)
pairs (DataType.SEQ). The surrogate samples from a fixed first-order
Markov chain so n-gram models have real structure to learn.
"""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "build_dict", "DataType"]

_VOCAB = 200


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    """word -> id; <s>=0, <e>=1, <unk>=2 follow the reference readers'
    convention of reserving these entries."""
    d = {"<s>": 0, "<e>": 1, "<unk>": 2}
    for i in range(3, _VOCAB):
        d["w%03d" % i] = i
    return d


_CHAIN = None


def _chain():
    global _CHAIN
    if _CHAIN is None:
        rng = np.random.RandomState(55)
        # sparse-ish row-stochastic transition matrix
        logits = rng.randn(_VOCAB, _VOCAB) * 2.0
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        _CHAIN = e / e.sum(axis=1, keepdims=True)
    return _CHAIN

def _sentences(n, seed):
    chain = _chain()
    rng = np.random.RandomState(seed)
    for _ in range(n):
        ln = int(rng.randint(5, 20))
        w = int(rng.randint(3, _VOCAB))
        sent = [w]
        for _ in range(ln - 1):
            w = int(rng.choice(_VOCAB, p=chain[w]))
            sent.append(max(w, 2))
        yield sent


def _reader(word_idx, n, data_type, count, seed):
    def reader():
        for sent in _sentences(count, seed):
            l = [0] + sent + [1]
            if data_type == DataType.NGRAM:
                if len(l) >= n:
                    l = [min(w, len(word_idx) - 1) for w in l]
                    for i in range(n, len(l) + 1):
                        yield tuple(l[i - n:i])
            elif data_type == DataType.SEQ:
                l = [min(w, len(word_idx) - 1) for w in l]
                yield l[:-1], l[1:]
            else:
                raise ValueError("Unknown data_type %r" % data_type)

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, 2048, seed=51)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, 256, seed=53)
