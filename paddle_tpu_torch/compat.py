"""py2/3 compatibility helpers (reference python/paddle/compat.py).

The reference straddled python 2 and 3; user code imported these
helpers, so the surface survives (python-3-only semantics: to_text /
to_bytes convert str/bytes and containers in place or by copy; round is
banker's-free rounding; floor_division is //; get_exception_message
formats an exception).
"""

from __future__ import annotations

import math

__all__ = ["to_text", "to_bytes", "round", "floor_division",
           "get_exception_message"]


def _convert(obj, fn, inplace):
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_convert(v, fn, False) for v in obj]
            return obj
        return [_convert(v, fn, False) for v in obj]
    if isinstance(obj, set):
        new = {_convert(v, fn, False) for v in obj}
        if inplace:
            obj.clear()
            obj.update(new)
            return obj
        return new
    if isinstance(obj, dict):
        new = {_convert(k, fn, False): _convert(v, fn, False)
               for k, v in obj.items()}
        if inplace:
            obj.clear()
            obj.update(new)
            return obj
        return new
    return fn(obj)


def to_text(obj, encoding="utf-8", inplace=False):
    """bytes -> str (recursively through list/set/dict), reference :36."""
    def one(v):
        return v.decode(encoding) if isinstance(v, bytes) else v

    return _convert(obj, one, inplace)


def to_bytes(obj, encoding="utf-8", inplace=False):
    """str -> bytes (recursively through list/set/dict), reference :106."""
    def one(v):
        return v.encode(encoding) if isinstance(v, str) else v

    return _convert(obj, one, inplace)


def round(x, d=0):  # noqa: A001 - reference shadows the builtin on purpose
    """Half-away-from-zero rounding (python2 semantics the reference
    preserved; python3's builtin banker-rounds), reference :179."""
    p = 10 ** d
    if x > 0:
        return float(math.floor((x * p) + 0.5)) / p
    if x < 0:
        return float(math.ceil((x * p) - 0.5)) / p
    return 0.0


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    """reference :222 — the stringified exception."""
    return str(exc)
