"""WMT16 en-de schema dataset (reference: python/paddle/dataset/wmt16.py).

Same (src_ids, trg_ids, trg_ids_next) triple as wmt14 but with separate
per-language dict sizes, a validation() split, and get_dict(lang, size).
Reserved ids follow the reference: <s>=0, <e>=1, <unk>=2. The offline
surrogate reuses wmt14's learnable reversed-bijection toy task. Point
PADDLE_TPU_DATA_HOME/wmt16/ at {train,test,val}.tsv (en<TAB>de per line)
+ en.dict + de.dict for the real corpus.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["train", "test", "validation", "get_dict"]

_RESERVED = 3
_UNK_IDX = 2


def _data_dir():
    from .common import data_home

    d = os.path.join(data_home(), "wmt16")
    return d if os.path.isdir(d) else None


def _load_dict(lang, size):
    d = {}
    with open(os.path.join(_data_dir(), lang + ".dict"),
              encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i >= size:
                break
            d[line.strip()] = i
    return d


def _file_reader(split, src_dict_size, trg_dict_size, src_lang):
    src_col = 0 if src_lang == "en" else 1
    sd = _load_dict(src_lang, src_dict_size)
    td = _load_dict("de" if src_lang == "en" else "en", trg_dict_size)

    def reader():
        with open(os.path.join(_data_dir(), split + ".tsv"),
                  encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                src_words = parts[src_col].split()
                trg_words = parts[1 - src_col].split()
                src = [sd.get(w, _UNK_IDX)
                       for w in ["<s>"] + src_words + ["<e>"]]
                trg = [td.get(w, _UNK_IDX) for w in trg_words]
                yield src, [td["<s>"]] + trg, trg + [td["<e>"]]

    return reader


def _synth(n, src_size, trg_size, seed):
    def reader():
        rng = np.random.RandomState(seed)
        shi = max(src_size, _RESERVED + 2)
        thi = max(trg_size, _RESERVED + 2)
        for _ in range(n):
            ln = int(rng.randint(3, 12))
            words = rng.randint(_RESERVED, shi, ln)
            trg = [int(_RESERVED + (w * 5 + 1) % (thi - _RESERVED))
                   for w in words[::-1]]
            yield ([0] + [int(w) for w in words] + [1],
                   [0] + trg, trg + [1])

    return reader


def _check_lang(src_lang):
    if src_lang not in ("en", "de"):
        raise ValueError("src_lang must be 'en' or 'de', got %r" % src_lang)


def train(src_dict_size, trg_dict_size, src_lang="en"):
    _check_lang(src_lang)
    if _data_dir():
        return _file_reader("train", src_dict_size, trg_dict_size, src_lang)
    return _synth(4096, src_dict_size, trg_dict_size, seed=21)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    _check_lang(src_lang)
    if _data_dir():
        return _file_reader("test", src_dict_size, trg_dict_size, src_lang)
    return _synth(512, src_dict_size, trg_dict_size, seed=23)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    _check_lang(src_lang)
    if _data_dir():
        return _file_reader("val", src_dict_size, trg_dict_size, src_lang)
    return _synth(512, src_dict_size, trg_dict_size, seed=25)


def get_dict(lang, dict_size, reverse=False):
    _check_lang(lang)
    if _data_dir():
        d = _load_dict(lang, dict_size)
    else:
        names = ["<s>", "<e>", "<unk>"] + [
            "%s%d" % (lang, i) for i in range(_RESERVED, dict_size)]
        d = {w: i for i, w in enumerate(names)}
    if reverse:
        d = {v: k for k, v in d.items()}
    return d
