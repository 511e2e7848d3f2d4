"""WMT14 en-de schema dataset (reference: python/paddle/dataset/wmt14.py).

Samples are (src_ids, trg_ids, trg_ids_next): source sequence wrapped in
<s>/<e>, target sequence prefixed <s>, next-target suffixed <e>, ids with
the reference's reserved slots (<s>=0, <e>=1, <unk>=2). Without the real
tarball the module synthesizes a deterministic toy translation task — the
target is the source sequence reversed under a fixed vocabulary bijection
— which a seq2seq model can actually learn, so book-test convergence
checks transfer. Point PADDLE_TPU_DATA_HOME/wmt14/ at
{train,test}.tsv + src.dict + trg.dict (tab-separated parallel text) for
the real corpus.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["train", "test", "get_dict"]

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2
_RESERVED = 3
_MAX_LEN = 80


def _data_dir():
    from .common import data_home

    d = os.path.join(data_home(), "wmt14")
    return d if os.path.isdir(d) else None


def _load_dict(path, size):
    d = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i >= size:
                break
            d[line.strip()] = i
    return d


def _file_reader(split, dict_size):
    d = _data_dir()
    src_dict = _load_dict(os.path.join(d, "src.dict"), dict_size)
    trg_dict = _load_dict(os.path.join(d, "trg.dict"), dict_size)

    def reader():
        with open(os.path.join(d, split + ".tsv"), encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                src = [src_dict.get(w, UNK_IDX)
                       for w in [START] + parts[0].split() + [END]]
                trg = [trg_dict.get(w, UNK_IDX) for w in parts[1].split()]
                if len(src) > _MAX_LEN or len(trg) > _MAX_LEN:
                    continue
                yield src, [trg_dict[START]] + trg, trg + [trg_dict[END]]

    return reader


def _synth_reader(n, dict_size, seed):
    def reader():
        rng = np.random.RandomState(seed)
        hi = max(dict_size, _RESERVED + 2)
        for _ in range(n):
            ln = int(rng.randint(3, 12))
            words = rng.randint(_RESERVED, hi, ln)
            # toy translation: reverse + fixed vocabulary bijection
            trg = [int(_RESERVED + (w * 7 + 3) % (hi - _RESERVED))
                   for w in words[::-1]]
            src = [0] + [int(w) for w in words] + [1]
            yield src, [0] + trg, trg + [1]

    return reader


def train(dict_size):
    if _data_dir():
        return _file_reader("train", dict_size)
    return _synth_reader(4096, dict_size, seed=11)


def test(dict_size):
    if _data_dir():
        return _file_reader("test", dict_size)
    return _synth_reader(512, dict_size, seed=13)


def get_dict(dict_size, reverse=True):
    """Word<->id dicts. Synthetic vocab uses "w<i>" surface forms with the
    reference's reserved entries."""
    d = _data_dir()
    if d:
        src = _load_dict(os.path.join(d, "src.dict"), dict_size)
        trg = _load_dict(os.path.join(d, "trg.dict"), dict_size)
    else:
        names = [START, END, UNK] + [
            "w%d" % i for i in range(_RESERVED, dict_size)]
        src = {w: i for i, w in enumerate(names)}
        trg = dict(src)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg
