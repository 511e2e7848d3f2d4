"""IMDB-schema dataset (reference: python/paddle/dataset/imdb.py).
Samples: (word-id sequence, 0/1 label). Synthetic sentiment-by-lexicon
by default; point PADDLE_TPU_DATA_HOME/imdb/aclImdb.tar.gz at the real
archive (the reference's layout: aclImdb/{train,test}/{pos,neg}/*.txt,
imdb.py:36 tokenize) — the parse path is CI-tested against a fixture
archive in tests/test_dataset_real_parse.py."""

from __future__ import annotations

import os
import re
import tarfile

import numpy as np

__all__ = ["train", "test", "word_dict"]

VOCAB = 5148  # reference vocab size ballpark


def _archive():
    from .common import data_home

    path = os.path.join(data_home(), "imdb", "aclImdb.tar.gz")
    return path if os.path.exists(path) else None


def _tokenize(text: str):
    # reference imdb.py tokenize(): lowercase, strip punctuation, split
    return re.sub(r"[^a-z0-9\s]", "", text.lower()).split()


_DICT_CACHE = {}  # (path, mtime) -> word dict


def _build_word_dict(path):
    """Frequency-ranked vocabulary over the train split (reference
    build_dict), byte keys for API parity, b'<unk>' appended at
    len(words) exactly as the reference does — OOV ids stay inside an
    embedding table sized by len(word_dict()). Cached per archive
    (building it decompresses and tokenizes the whole train split)."""
    key = (path, os.path.getmtime(path))
    if key in _DICT_CACHE:
        return _DICT_CACHE[key]
    freq = {}
    pat = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
    with tarfile.open(path, "r:gz") as tf:
        for member in tf.getmembers():
            if not pat.search(member.name):
                continue
            text = tf.extractfile(member).read().decode("utf-8", "replace")
            for w in _tokenize(text):
                freq[w] = freq.get(w, 0) + 1
    ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    d = {w.encode(): i for i, (w, _) in enumerate(ranked)}
    d[b"<unk>"] = len(d)
    _DICT_CACHE.clear()
    _DICT_CACHE[key] = d
    return d


def word_dict():
    arch = _archive()
    if arch:
        return _build_word_dict(arch)
    return {("w%d" % i).encode(): i for i in range(VOCAB)}


def _archive_reader(path, split, word_idx, n):
    if b"<unk>" not in word_idx:
        raise ValueError(
            "word_idx must contain b'<unk>' (imdb.word_dict() provides "
            "it); silently aliasing OOV words onto a real id would "
            "corrupt training")
    unk = word_idx[b"<unk>"]

    def reader():
        # Read texts in MEMBER order (gzip streams have no random
        # access: seeking backward re-decompresses from byte 0, so an
        # interleaved extractfile() order would be quadratic), then
        # interleave the decoded samples: tar members group by directory
        # (all neg/ then all pos/), and a truncated read (n < corpus)
        # must still see a balanced label distribution.
        pat = re.compile(r"aclImdb/%s/(pos|neg)/.*\.txt$" % split)
        pos, neg = [], []
        with tarfile.open(path, "r:gz") as tf:
            for member in tf.getmembers():
                m = pat.search(member.name)
                if m is None:
                    continue
                text = tf.extractfile(member).read().decode(
                    "utf-8", "replace")
                ids = [word_idx.get(w.encode(), unk)
                       for w in _tokenize(text)]
                (pos if m.group(1) == "pos" else neg).append(ids)
        order = [s for pair in zip(pos, neg)
                 for s in ((pair[0], 1), (pair[1], 0))]
        order += [(s, 1) for s in pos[len(neg):]]
        order += [(s, 0) for s in neg[len(pos):]]
        for count, sample in enumerate(order):
            if n is not None and count >= n:
                return
            yield sample

    return reader


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        pos_words = np.arange(100, 600)
        neg_words = np.arange(600, 1100)
        for _ in range(n):
            label = int(rng.randint(2))
            length = int(rng.randint(20, 120))
            base = pos_words if label else neg_words
            sentiment = rng.choice(base, size=length // 2)
            noise = rng.randint(1100, VOCAB, size=length - length // 2)
            seq = np.concatenate([sentiment, noise])
            rng.shuffle(seq)
            yield seq.astype("int64").tolist(), label

    return reader


def train(word_idx=None, n=None):
    """n=None reads the whole corpus on the archive path (synthetic
    surrogate defaults to 4096 samples)."""
    arch = _archive()
    if arch:
        return _archive_reader(arch, "train", word_idx or word_dict(), n)
    return _reader(4096 if n is None else n, seed=3)


def test(word_idx=None, n=None):
    arch = _archive()
    if arch:
        return _archive_reader(arch, "test", word_idx or word_dict(), n)
    return _reader(512 if n is None else n, seed=4)
