"""CoNLL-2005 SRL schema dataset (reference:
python/paddle/dataset/conll05.py).

test() yields the 9-slot SRL tuple the book test consumes:
    (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids, mark, labels)
where the five ctx_* slots are the predicate-context word repeated over
the sentence, mark flags the predicate position, and labels are BIO tags.
get_dict() returns (word_dict, verb_dict, label_dict); get_embedding()
returns a deterministic [len(word_dict), 32] float32 matrix. The
surrogate tags a window around the predicate so a tagger can learn it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["test", "get_dict", "get_embedding"]

_WORDS = 512
_VERBS = 64
_LABELS = ["O", "B-A0", "I-A0", "B-A1", "I-A1", "B-V"]


def get_dict():
    word_dict = {"w%03d" % i: i for i in range(_WORDS)}
    verb_dict = {"v%02d" % i: i for i in range(_VERBS)}
    label_dict = {l: i for i, l in enumerate(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = np.random.RandomState(71)
    return (rng.randn(_WORDS, 32) * 0.1).astype("float32")


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(6, 25))
            words = [int(w) for w in rng.randint(0, _WORDS, ln)]
            vpos = int(rng.randint(1, ln - 1))
            verb = int(rng.randint(_VERBS))
            ctx = [words[max(vpos - 2, 0)], words[max(vpos - 1, 0)],
                   words[vpos], words[min(vpos + 1, ln - 1)],
                   words[min(vpos + 2, ln - 1)]]
            mark = [1 if i == vpos else 0 for i in range(ln)]
            # learnable rule: B-V at the predicate, A0 spans left, A1 right
            labels = [0] * ln
            labels[vpos] = 5
            if vpos >= 2:
                labels[vpos - 2] = 1
                labels[vpos - 1] = 2
            if vpos + 2 < ln:
                labels[vpos + 1] = 3
                labels[vpos + 2] = 4
            yield (words,
                   [ctx[0]] * ln, [ctx[1]] * ln, [ctx[2]] * ln,
                   [ctx[3]] * ln, [ctx[4]] * ln,
                   [verb] * ln, mark, labels)

    return reader


def test():
    return _reader(512, seed=73)
