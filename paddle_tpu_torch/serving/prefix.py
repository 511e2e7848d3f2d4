"""Prefix/KV-cache reuse: prefill a shared prompt prefix ONCE.

Fleet traffic is dominated by shared prompt heads — a system prompt,
a few-shot preamble — yet the decode engine's admission prefills every
request's full prompt from scratch. The :class:`PrefixStore` closes
that gap: admission registers the reusable boundary of a prompt
(``submit(prefix_len=...)``), the store keeps those prefixes' per-layer
K/V rows host-side, and every later prompt that starts with a stored
prefix splices the cached rows through the engine's existing
one-dispatch donated cache-splice and prefills only its suffix
(``gpt.build_multi_token_decode_step``). Outputs stay bitwise the
uncached path's: K/V rows at position p depend only on tokens <= p
(causal attention), so the spliced rows are exactly what a full
prefill would recompute, and the suffix program's per-position
attention is the decode step's bit for bit.

Keying is exact-prefix (hash on the token tuple) with longest-match
lookup over the store's distinct lengths — the trie's longest-prefix
semantics at dict cost, which fits the workload (a bounded set of
shared heads, each hit in O(distinct lengths) hashes). Entries are
host numpy (no device memory held hostage), capped by total bytes with
LRU eviction.

Telemetry: ``paddle_serving_prefix_{hits,misses,tokens_saved,
inserts,evictions}_total`` + ``paddle_serving_prefix_{entries,bytes}``
gauges (docs/SERVING.md has the fleet-tier table).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["PrefixStore"]


class _Entry:
    __slots__ = ("rows", "nbytes")

    def __init__(self, rows: List[np.ndarray]):
        # own the arrays: callers hand scope-backed views whose buffers
        # the next prefill dispatch overwrites
        self.rows = [np.ascontiguousarray(r) for r in rows]
        self.nbytes = sum(r.nbytes for r in self.rows)


class PrefixStore:
    """Byte-capped, LRU, thread-safe store of prefilled prompt-prefix
    K/V rows.

    One store may back any number of engine replicas built from the
    SAME model config (entries are keyed by tokens only — rows from a
    different architecture would silently corrupt attention, so share
    a store across replicas of one model, never across models). The
    router does exactly that: one store, N replicas, a prefix
    prefilled on any replica hits on all of them.
    """

    def __init__(self, max_bytes: int = 64 << 20):
        if max_bytes < 1:
            raise ValueError("PrefixStore max_bytes must be >= 1; got %r"
                             % (max_bytes,))
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[int, ...], _Entry]" = OrderedDict()
        self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    # ------------------------------------------------------------- lookup
    def lookup(self, prompt) -> Optional[Tuple[int, List[np.ndarray]]]:
        """Longest stored prefix of ``prompt`` with length <= P - 1
        (the last prompt position must prefill live — its logits seed
        the first sampled token). Returns ``(L, rows)`` — rows are the
        per-layer [1, n_kv, L, Dh] K/V slabs in cache-name order — or
        None, counting a miss. A hit refreshes LRU recency and counts
        hit + L tokens saved."""
        from ..observe.families import (SERVING_PREFIX_HITS,
                                        SERVING_PREFIX_MISSES,
                                        SERVING_PREFIX_TOKENS_SAVED)

        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        with self._lock:
            lengths = sorted({len(k) for k in self._entries}, reverse=True)
            for L in lengths:
                if L > len(toks) - 1:
                    continue
                ent = self._entries.get(toks[:L])
                if ent is None:
                    continue
                self._entries.move_to_end(toks[:L])
                SERVING_PREFIX_HITS.inc()
                SERVING_PREFIX_TOKENS_SAVED.inc(L)
                return L, ent.rows
        SERVING_PREFIX_MISSES.inc()
        return None

    def contains(self, prefix) -> bool:
        toks = tuple(int(t) for t in np.asarray(prefix).reshape(-1))
        with self._lock:
            return toks in self._entries

    # ------------------------------------------------------------- insert
    def insert(self, prefix, rows: List[np.ndarray]) -> bool:
        """Store ``rows`` (per-layer [1, n_kv, L, Dh] K/V slabs, cache-
        name order) under the token tuple ``prefix``. Idempotent for an
        existing key (first write wins — re-prefilled rows are bitwise
        identical by the causality argument above, so overwriting buys
        nothing). Evicts least-recently-used entries until the byte cap
        holds; an entry larger than the whole cap is refused. Returns
        True when stored."""
        from ..observe.families import (SERVING_PREFIX_BYTES,
                                        SERVING_PREFIX_ENTRIES,
                                        SERVING_PREFIX_EVICTIONS,
                                        SERVING_PREFIX_INSERTS)

        toks = tuple(int(t) for t in np.asarray(prefix).reshape(-1))
        if not toks:
            raise ValueError("cannot store an empty prefix")
        ent = _Entry(rows)
        if any(r.shape[2] != len(toks) for r in ent.rows):
            raise ValueError(
                "prefix rows disagree with the key: %d tokens vs row "
                "lengths %s" % (len(toks),
                                sorted({r.shape[2] for r in ent.rows})))
        with self._lock:
            if toks in self._entries:
                return False
            if ent.nbytes > self.max_bytes:
                return False  # would evict everything and still not fit
            evicted = 0
            while self._bytes + ent.nbytes > self.max_bytes:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                evicted += 1
            self._entries[toks] = ent
            self._bytes += ent.nbytes
            n, b = len(self._entries), self._bytes
        if evicted:
            SERVING_PREFIX_EVICTIONS.inc(evicted)
        SERVING_PREFIX_INSERTS.inc()
        SERVING_PREFIX_ENTRIES.set(n)
        SERVING_PREFIX_BYTES.set(b)
        return True

    def clear(self) -> None:
        from ..observe.families import (SERVING_PREFIX_BYTES,
                                        SERVING_PREFIX_ENTRIES)

        with self._lock:
            self._entries.clear()
            self._bytes = 0
        SERVING_PREFIX_ENTRIES.set(0)
        SERVING_PREFIX_BYTES.set(0)
