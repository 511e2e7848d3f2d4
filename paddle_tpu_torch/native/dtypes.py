"""The ONE dtype-code table shared by every native serde surface:
ps_service.cc (RPC wire), the checkpoint files, and their Python
wrappers. Adding a code here is the only step needed to keep the wire
and file formats in agreement.

The port's copy of paddle_tpu/native/dtypes.py, with the same codes.
numpy has no bfloat16 without ``ml_dtypes``, which the port does not
use: code 5 maps to ``BF16``, a two-byte structured dtype whose one
field holds the raw bits, distinct from every dtype that has a code.
``bf16_encode`` rounds float32 to those bits (round to nearest even, a
NaN to the quiet NaN of its sign, as ``ml_dtypes`` rounds) and
``bf16_decode`` widens them back, so the bytes on the wire are the JAX
package's bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BF16", "CODE_OF_DTYPE", "DTYPE_OF_CODE", "bf16_decode",
           "bf16_encode", "code_of", "dtype_of"]

# the raw bits of a bfloat16, as numpy carries them on the wire
BF16 = np.dtype([("bfloat16", "<u2")])

CODE_OF_DTYPE = {
    np.dtype("float32"): 0,
    np.dtype("int64"): 1,
    np.dtype("float64"): 2,
    np.dtype("int32"): 3,
    np.dtype("uint8"): 4,
    BF16: 5,
    np.dtype("bool"): 6,
    np.dtype("float16"): 7,
    np.dtype("int8"): 8,
    np.dtype("uint32"): 9,
    np.dtype("int16"): 10,
}

DTYPE_OF_CODE = {c: d for d, c in CODE_OF_DTYPE.items()}


def code_of(dtype) -> int:
    dt = np.dtype(dtype)
    code = CODE_OF_DTYPE.get(dt)
    if code is None:
        raise TypeError(
            "dtype %s is not serializable (known: %s)"
            % (dt, sorted(str(d) for d in CODE_OF_DTYPE)))
    return code


def dtype_of(code: int) -> np.dtype:
    dt = DTYPE_OF_CODE.get(code)
    if dt is None:
        raise TypeError("unknown serialized dtype code %d" % code)
    return dt


def bf16_encode(values) -> np.ndarray:
    """A ``BF16`` array of float32 ``values``, each rounded to the
    nearest bfloat16, ties to even; a NaN becomes 0x7FC0, or 0xFFC0
    with its sign bit set."""
    f32 = np.asarray(values, dtype=np.float32)
    u32 = np.ascontiguousarray(f32).view(np.uint32)
    lsb = (u32 >> np.uint32(16)) & np.uint32(1)
    rounded = ((u32 + np.uint32(0x7FFF) + lsb) >> np.uint32(16)) \
        .astype(np.uint16)
    nan = np.where(u32 >> np.uint32(31), np.uint16(0xFFC0),
                   np.uint16(0x7FC0))
    bits = np.where(np.isnan(f32), nan, rounded).astype(np.uint16)
    return np.ascontiguousarray(bits).view(BF16).reshape(f32.shape)


def bf16_decode(bits) -> np.ndarray:
    """The float32 values of a ``BF16`` array (exact: a bfloat16 is the
    upper half of a float32)."""
    bits = np.asarray(bits)
    raw = np.ascontiguousarray(bits).view(np.uint16)
    return (raw.astype(np.uint32) << np.uint32(16)).view(np.float32) \
        .reshape(bits.shape)
