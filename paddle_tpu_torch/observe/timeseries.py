"""Bounded time-series rings over registry samples: rate/ewma/delta.

The registry (metrics.py) is a point-in-time surface — counters only
ever tell you "how many so far". The live plane (export.py, fleet.py,
tools/fleet_top.py) and the SLO monitor (slo.py) need *derivatives*:
steps/sec, tokens/sec, error rate over the last window. This module is
the one place those derivatives are computed:

* :class:`Ewma` — THE shared exponentially-weighted moving average.
  The serving router's token-rate estimate (serving/router.py) uses
  this class instead of a hand-rolled inline blend, so any consumer
  that wants "the router's smoothing" gets the identical arithmetic.
* :class:`TimeSeriesStore` — per-series bounded rings of (t, value)
  points fed by :meth:`TimeSeriesStore.sample`, which walks a registry
  snapshot (this process's live one by default, or any saved/scraped
  snapshot dict) and appends one point per scalar series. Histograms
  contribute their ``_count`` and ``_sum`` series so ``rate()`` over a
  latency histogram's count is requests/sec.

Rings are bounded (``capacity`` points per series) so a long-lived
exporter never grows without bound; the clock is injectable so tests
pin rates deterministically.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Ewma", "TimeSeriesStore", "series_key"]


class Ewma:
    """Exponentially-weighted moving average with first-sample seeding:
    the first ``update()`` (or an explicit ``initial``) sets the value
    outright, later updates blend ``(1-alpha)*old + alpha*new``."""

    def __init__(self, alpha: float = 0.2,
                 initial: Optional[float] = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]; got %r" % (alpha,))
        self.alpha = float(alpha)
        self._value = float(initial) if initial is not None else None

    def update(self, value: float) -> float:
        value = float(value)
        if self._value is None:
            self._value = value
        else:
            self._value += self.alpha * (value - self._value)
        return self._value

    @property
    def value(self) -> Optional[float]:
        return self._value

    def reset(self) -> None:
        self._value = None


def series_key(name: str, labels: dict) -> str:
    """Canonical per-series key ``name{l=v,...}`` — same shape as
    tools/stats_dump.py's table keys, so the two never drift apart."""
    if not labels:
        return name
    return name + "{%s}" % ",".join(
        "%s=%s" % kv for kv in sorted(labels.items()))


class TimeSeriesStore:
    """Bounded per-series rings of (t, value) samples.

    ``sample()`` appends one point per scalar series in a snapshot;
    ``rate``/``delta``/``ewma``/``latest`` read a window back out. All
    methods are thread-safe (the exporter's sampler thread may race a
    dashboard reader)."""

    def __init__(self, capacity: int = 512,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (rate needs two "
                             "points); got %r" % (capacity,))
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {}

    # ------------------------------------------------------------ writing
    def _append(self, key: str, t: float, value: float) -> None:
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(maxlen=self.capacity)
        ring.append((t, float(value)))

    def record(self, key: str, value: float,
               now: Optional[float] = None) -> None:
        """Append one point to one series (ad-hoc series that don't
        come from a registry snapshot — e.g. a parsed remote scrape)."""
        with self._lock:
            self._append(key, self._clock() if now is None else now, value)

    def sample(self, snap: Optional[dict] = None,
               now: Optional[float] = None) -> int:
        """Append one point per scalar series in ``snap`` (default: the
        process-wide registry's live snapshot). Histogram series land
        as ``name_count{...}`` and ``name_sum{...}``. Returns the
        number of points appended."""
        if snap is None:
            from . import REGISTRY
            snap = REGISTRY.snapshot()
        t = self._clock() if now is None else now
        n = 0
        with self._lock:
            for name, m in snap["metrics"].items():
                for s in m["samples"]:
                    if m["type"] == "histogram":
                        self._append(series_key(name + "_count",
                                                s["labels"]), t, s["count"])
                        self._append(series_key(name + "_sum",
                                                s["labels"]), t, s["sum"])
                        n += 2
                    else:
                        self._append(series_key(name, s["labels"]), t,
                                     s["value"])
                        n += 1
        return n

    # ------------------------------------------------------------ reading
    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def _window(self, key: str,
                window_s: Optional[float]) -> List[Tuple[float, float]]:
        with self._lock:
            ring = self._rings.get(key)
            if not ring:
                return []
            pts = list(ring)
        if window_s is None:
            return pts
        cutoff = pts[-1][0] - float(window_s)
        return [p for p in pts if p[0] >= cutoff]

    def latest(self, key: str) -> Optional[float]:
        with self._lock:
            ring = self._rings.get(key)
            return ring[-1][1] if ring else None

    def delta(self, key: str,
              window_s: Optional[float] = None) -> Optional[float]:
        """last - first over the window (None with <2 points)."""
        pts = self._window(key, window_s)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, key: str,
             window_s: Optional[float] = None) -> Optional[float]:
        """(last - first) / elapsed over the window — the counter
        derivative (None with <2 points or zero elapsed)."""
        pts = self._window(key, window_s)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / dt

    def ewma(self, key: str, alpha: float = 0.2,
             window_s: Optional[float] = None) -> Optional[float]:
        """Ewma of the windowed values (None while empty) — the same
        arithmetic as the router's rate smoothing, over stored points."""
        pts = self._window(key, window_s)
        if not pts:
            return None
        e = Ewma(alpha=alpha)
        for _, v in pts:
            e.update(v)
        return e.value

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
