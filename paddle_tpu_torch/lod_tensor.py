"""LoDTensor utilities (reference: python/paddle/fluid/lod_tensor.py +
framework/lod_tensor.h).

The compute path here is masked-dense (padded [B, T, ...] + length
vectors — layers/sequence.py), so LoDTensor is a host-side container:
it carries the flattened data plus recursive sequence lengths with the
reference's validation and offset conversion, and adds `to_padded()` to
bridge into the dense contract. create_lod_tensor /
create_random_int_lodtensor mirror the reference constructors.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["Tensor", "LoDTensor", "LoDTensorArray",
           "create_lod_tensor", "create_random_int_lodtensor"]


def _lengths_to_offsets(recursive_seq_lens):
    lod = []
    for lens in recursive_seq_lens:
        offsets = [0]
        for l in lens:
            offsets.append(offsets[-1] + int(l))
        lod.append(offsets)
    return lod


class Tensor:
    """Plain host tensor (reference core.Tensor): a named-free data
    holder with set()/shape()/__array__; LoDTensor extends it with LoD
    bookkeeping."""

    def __init__(self, data=None):
        self._array = None if data is None else np.asarray(data)

    def set(self, data, place=None):
        self._array = np.asarray(data)

    def shape(self):
        return () if self._array is None else self._array.shape

    def __array__(self, dtype=None):
        a = self._array
        return a if dtype is None else a.astype(dtype)


class LoDTensor(Tensor):
    """Data + level-of-detail offsets (lod_tensor.h:58)."""

    def __init__(self, data=None, recursive_seq_lens=None):
        self._array = None if data is None else np.asarray(data)
        self._seq_lens: List[List[int]] = [
            [int(x) for x in level] for level in (recursive_seq_lens or [])]

    # ---- reference API surface
    def set(self, data, place=None):
        self._array = np.asarray(data)

    def set_recursive_sequence_lengths(self, recursive_seq_lens):
        self._seq_lens = [[int(x) for x in level]
                          for level in recursive_seq_lens]

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [list(l) for l in self._seq_lens]

    def lod(self) -> List[List[int]]:
        """Offset-based LoD (converted from the length-based form)."""
        return _lengths_to_offsets(self._seq_lens)

    def has_valid_recursive_sequence_lengths(self) -> bool:
        if self._array is None:
            return False
        total = self._array.shape[0]
        for level in reversed(self._seq_lens):
            s = sum(level)
            if s != total:
                return False
            total = len(level)
        return True

    def shape(self):
        return () if self._array is None else self._array.shape

    def __array__(self, dtype=None):
        a = self._array
        return a if dtype is None else a.astype(dtype)

    # ---- masked-dense bridge (this repo's sequence contract)
    def to_padded(self, pad_value=0):
        """(padded [B, T, ...], lengths [B]) for the innermost level."""
        lens = self._seq_lens[-1]
        B = len(lens)
        T = max(lens) if lens else 0
        trailing = self._array.shape[1:]
        out = np.full((B, T) + trailing, pad_value, self._array.dtype)
        off = 0
        for i, l in enumerate(lens):
            out[i, :l] = self._array[off:off + l]
            off += l
        return out, np.asarray(lens, np.int64)

    def __repr__(self):
        return "LoDTensor(shape=%s, recursive_seq_lens=%s)" % (
            self.shape(), self._seq_lens)


class LoDTensorArray(list):
    """A list of LoDTensors (framework::LoDTensorArray)."""


def create_lod_tensor(data, recursive_seq_lens, place=None) -> LoDTensor:
    """reference lod_tensor.py:23 — from numpy array, nested list, or an
    existing LoDTensor."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(np.asarray(data), recursive_seq_lens, place)
    if isinstance(data, list):
        # nested list of sequences: flatten, derive the innermost lengths
        flat = [np.asarray(seq).reshape(len(seq), -1) for seq in data]
        lens = [f.shape[0] for f in flat]
        if recursive_seq_lens and recursive_seq_lens[-1] != lens:
            raise ValueError(
                "the provided recursive_seq_lens %s do not match the input "
                "list lengths %s" % (recursive_seq_lens[-1], lens))
        data = np.concatenate(flat, axis=0)
        recursive_seq_lens = (recursive_seq_lens
                              or [[f.shape[0] for f in flat]])
    t = LoDTensor(np.asarray(data), recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError(
            "the provided recursive_seq_lens are invalid for data of "
            "shape %s" % (t.shape(),))
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1) -> LoDTensor:
    """reference lod_tensor.py — random ints shaped by the innermost
    sequence lengths."""
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             (total,) + tuple(base_shape)).astype(np.int64)
    return create_lod_tensor(data, recursive_seq_lens, place)
