"""Pipelined execution: feeds copied to the card ahead of the step loop,
fetches handed out as handles resolved later.

The port's counterpart of paddle_tpu/core/pipeline.py. ``Executor.run``
converts every feed on the caller's thread and waits for the card at the
end of every step (its fetches' copy to the host), so the host's work for
step N+1 (feed conversion and copies, the generators' re-seeding, the
scope check) runs while the card idles. ``Executor.run_pipelined`` and
``train_loop`` compose the three pieces below so that it runs under step
N's CUDA graph instead:

* ``DevicePrefetcher`` wraps any reader of feed dicts and runs ONE
  bounded background thread that converts each batch (dtype coercion,
  int64 range-checked narrowing: ``feeds_to_device``) and copies it to
  the card: staged in pinned host memory, copied ``non_blocking`` on the
  prefetcher's own CUDA stream, with an event recorded after the copy.
  The consumer makes its stream wait on that event and marks each tensor
  as used on its stream (``record_stream``), so the caching allocator
  never hands the memory out again while the step still reads it. The
  pinned staging memory comes from PyTorch's caching host allocator,
  which reuses a block only once the copy that read it has completed.
* ``ConstFeedCache``: feeds that repeat across steps (the same ndarray
  object, or a name the caller marks constant) skip the copy. The cache
  keys unmarked arrays by (name, object identity) and HOLDS a reference,
  so an id is never reused by another array while cached; mutating a
  cached array IN PLACE is unspecified until ``invalidate(arr)``. Marked
  names are cached by NAME and copied once, later values ignored until
  ``invalidate(name=...)``. Lookups are guarded by device and shape.
* ``FetchHandle``: one step's (or window's) fetches. On the card the
  executor copies each fetched tensor on the compute stream right after
  the step, before the next step is enqueued (a replay overwrites its
  outputs, and K6/K7 update state in place): into pinned host memory
  with a ``non_blocking`` copy when numpy values are wanted, else a
  device clone, and records an event. ``wait()`` synchronizes that event,
  never the device; ``result()`` converts and applies the
  FLAGS_check_nan_inf check.

A CUDA graph is captured (core/cuda_graph.py) in ``thread_local`` mode,
so the fill thread's allocations and copies on its own stream are legal
while the step loop captures a plan.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..observe import trace as _tr
from ..resilience.faults import fault_point
from .place import default_place, require_device

__all__ = ["DevicePrefetcher", "ConstFeedCache", "FetchHandle",
           "WindowFeed"]

_END = object()


class WindowFeed:
    """K per-step host batches stacked into ONE feed on the device by the
    prefetch thread (``reader.stack_feed_window``'s [K, ...] layout, one
    copy per feed per WINDOW instead of per batch). ``feeds`` maps name
    -> stacked tensor, ``steps`` is K. Only a windowed prefetcher emits
    these; ragged tails (reader dry / shape change mid-window) degrade to
    plain per-step feed dicts, which the pipelined loop dispatches
    through the per-step path."""

    __slots__ = ("feeds", "steps")

    def __init__(self, feeds: Dict[str, Any], steps: int):
        self.feeds = feeds
        self.steps = steps


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return int(getattr(value, "nbytes", 0))


def _tensors(item):
    feeds = item.feeds if isinstance(item, WindowFeed) else item
    return [v for v in feeds.values() if isinstance(v, torch.Tensor)]


class ConstFeedCache:
    """Device-resident dedup cache for feeds that repeat across steps.

    Two tiers:
    * unmarked arrays key on ``(feed name, id(arr))`` — the name matters
      because the SAME host array fed under two names converts to two
      different tensors (per-var dtype coercion); a hit requires the
      cached host object to BE the fed object (the cache holds a strong
      reference, so a live entry's id can never be recycled by a
      different array). Bounded LRU — and the prefetcher only stores an
      unmarked array on its SECOND sighting, so ordinary fresh-per-step
      batches never pin host or device memory here (dedup then kicks in
      from the third repeat onward).
    * ``mark_constant(name)`` names key on the feed NAME: the first value
      transfers, every later value is ignored (the user's promise of
      constancy) until ``invalidate(name=...)``.

    Mutating a cached ndarray in place is UNSPECIFIED until the caller
    invalidates: the cache keeps serving its copy, which is stale. Call
    ``invalidate(arr)`` after any in-place update.
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError("ConstFeedCache capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        # (feed name, id(arr)) -> (host_ref, device tensor); LRU order
        self._by_id: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._by_name: Dict[str, Any] = {}
        self._const_names: set = set()

    def mark_constant(self, *names: str) -> None:
        with self._lock:
            self._const_names.update(names)

    def is_const(self, name: str) -> bool:
        with self._lock:
            return name in self._const_names

    def lookup(self, name: str, val, device=None,
               shape=None) -> Optional[Any]:
        """The device copy of (name, val) if cached, else None. ``device``
        (when given) guards a cache shared by prefetchers on different
        devices: an entry resident elsewhere is a MISS. ``shape`` (when
        given) guards the by-name tier across dispatch modes: a windowed
        loop stores the K-stacked copy under the name, which must never
        serve a per-step dispatch (or the reverse); a mismatch is a MISS
        (no hit counted) and the new copy overwrites the entry."""
        from ..observe.families import (PIPELINE_CONST_BYTES_SAVED,
                                        PIPELINE_CONST_HITS)

        with self._lock:
            if name in self._const_names:
                dev = self._by_name.get(name)
            else:
                key = (name, id(val))
                entry = self._by_id.get(key)
                if entry is None or entry[0] is not val:
                    return None
                self._by_id.move_to_end(key)
                dev = entry[1]
        if dev is not None and device is not None \
                and getattr(dev, "device", device) != device:
            return None
        if dev is not None and shape is not None \
                and tuple(getattr(dev, "shape", ())) != tuple(shape):
            return None
        if dev is not None:
            PIPELINE_CONST_HITS.inc()
            PIPELINE_CONST_BYTES_SAVED.inc(_nbytes(dev))
        return dev

    def store(self, name: str, val, dev) -> None:
        with self._lock:
            if name in self._const_names:
                self._by_name[name] = dev
                return
            if not isinstance(val, np.ndarray):
                return  # lists/scalars have no stable identity worth caching
            key = (name, id(val))
            self._by_id[key] = (val, dev)
            self._by_id.move_to_end(key)
            while len(self._by_id) > self.capacity:
                self._by_id.popitem(last=False)

    def invalidate(self, val=None, name: Optional[str] = None) -> None:
        """Drop one entry (by array or name) or, with no args, everything."""
        with self._lock:
            if val is None and name is None:
                self._by_id.clear()
                self._by_name.clear()
                return
            if val is not None:
                for key in [k for k in self._by_id if k[1] == id(val)]:
                    del self._by_id[key]
            if name is not None:
                self._by_name.pop(name, None)


class DevicePrefetcher:
    """Background-thread prefetch to the device: wraps a reader of feed
    dicts and yields feed dicts of tensors already on the device.

    ``reader``: a zero-arg callable returning an iterable of feed dicts
    (the repo's reader convention), or an iterable of feed dicts.
    ``place``: the executor's Place; ``None`` means the card,
    ``CUDAPlace(0)``, as for every entry point (pass ``CPUPlace()`` for
    the CPU). Resolving it touches no device; iterating raises when the
    card is asked for and absent.
    ``program``: optional — its global block supplies var dtypes so the
    conversion matches ``Executor.run``'s (int64 ids narrow with a range
    check).
    ``depth``: max batches (in window mode: windows) converted ahead of
    the consumer (bounds device memory: depth * batch bytes).
    ``const_feed_names``: names cached by NAME in the dedup cache (see
    ``ConstFeedCache``); unmarked repeat arrays dedup automatically by
    object identity unless ``const_dedup=False`` — pass that when the
    reader refills ONE preallocated ndarray in place each step.

    On the card each batch is staged in pinned memory and copied on the
    prefetcher's own stream; the consumer's stream waits on the copy's
    event before the step reads it (module doc). The fill thread stops
    promptly when the consumer abandons iteration (``close()``, ``with``
    exit, or generator GC) — the put is stop-aware. A reader exception
    is re-raised in the consumer at the point of iteration. A prefetcher
    is SINGLE-USE: once closed or fully consumed, iterating again raises.
    """

    def __init__(self, reader, place=None, program=None, depth: int = 2,
                 const_feed_names: Sequence[str] = (),
                 const_cache: Optional[ConstFeedCache] = None,
                 const_dedup: bool = True, window_resolver=None):
        if depth < 1:
            raise ValueError("DevicePrefetcher depth must be >= 1")
        self._reader = reader
        self._depth = depth
        # run_pipelined's hook: called ONCE with the first HOST batch,
        # returns (K, source). K > 1 switches the fill thread to window
        # mode (K host batches stacked into ONE WindowFeed, one copy per
        # feed per window). The result lands in ``resolved_window``
        # BEFORE the first hand-off (the queue is the happens-before
        # edge the consumer reads it after).
        self._window_resolver = window_resolver
        self.resolved_window = None  # (K, source) once resolved
        self._dedup_unmarked = const_dedup
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.const_cache = const_cache or ConstFeedCache()
        if const_feed_names:
            self.const_cache.mark_constant(*const_feed_names)
        self._var_lookup = (program.global_block().vars.get
                            if program is not None else lambda _n: None)
        self._device = (default_place() if place is None
                        else place).torch_device()
        self._stream = None  # the copies' CUDA stream, made at iter()
        # trace hand-off: run_pipelined pins its context here before
        # iter() starts the thread, so the fill thread's spans join the
        # step loop's trace
        self.trace_ctx = None
        self._thread = threading.Thread(
            target=self._fill, name="DevicePrefetcher", daemon=True)
        self._started = False
        self._closed = False
        # (name, id) seen once (weakrefs: pins nothing) — an unmarked
        # array only enters the const cache on its SECOND sighting
        self._seen: "OrderedDict[tuple, weakref.ref]" = OrderedDict()

    # ------------------------------------------------------------ thread
    def _to_device(self, feeds: Dict[str, Any]) -> tuple:
        """``feeds_to_device`` on the prefetcher's stream: (dict, bytes)."""
        from .executor import feeds_to_device

        return feeds_to_device(feeds, self._var_lookup, self._device,
                               stream=self._stream)

    def _convert(self, feed: Dict[str, Any]) -> tuple:
        """One batch -> tensors on the device; returns (dict, h2d_bytes)."""
        cached, rest = {}, {}
        with _tr.trace_span("pipeline.const_lookup", feeds=len(feed)):
            for n, v in feed.items():
                dev = self.const_cache.lookup(n, v, device=self._device,
                                              shape=np.shape(v)) \
                    if (self._dedup_unmarked or
                        self.const_cache.is_const(n)) \
                    else None
                if dev is not None:
                    cached[n] = dev
                else:
                    rest[n] = v
        out, nbytes = self._to_device(rest)
        for n, dev in out.items():
            if self.const_cache.is_const(n) or \
                    (self._dedup_unmarked and self._repeat(n, feed[n])):
                self.const_cache.store(n, feed[n], dev)
        out.update(cached)
        return out, nbytes

    def _repeat(self, name, v) -> bool:
        """True iff this exact array object was fed under this name
        before (fill thread only, so no lock). Tracks candidates by
        weakref: a fresh batch costs one dict slot, never a pinned
        array."""
        if not isinstance(v, np.ndarray):
            return False
        k = (name, id(v))
        ref = self._seen.get(k)
        if ref is not None and ref() is v:
            self._seen.move_to_end(k)
            return True
        try:
            self._seen[k] = weakref.ref(v)
        except TypeError:
            return False
        self._seen.move_to_end(k)
        while len(self._seen) > max(32, 4 * self._depth):
            self._seen.popitem(last=False)
        return False

    def _put(self, item) -> bool:
        """Stop-aware bounded put; False if the consumer went away."""
        from ..observe.families import PIPELINE_PREFETCH_DEPTH
        from ..reader import _stop_aware_put

        if not _stop_aware_put(self._q, item, self._stop):
            return False
        PIPELINE_PREFETCH_DEPTH.set(self._q.qsize())
        return True

    def _convert_window(self, buf) -> tuple:
        """K host batches -> ONE stacked WindowFeed on the device; returns
        (WindowFeed, h2d_bytes). Host-side ``np.stack`` per feed
        (``reader.stack_feed_window``'s layout), then one copy per feed
        for the whole window. Const-MARKED names keep their by-name tier
        (the stacked window transfers once); the identity tier is
        skipped in window mode (each stacked array is a fresh object)."""
        from ..reader import stack_feed_window

        stacked = stack_feed_window(buf)
        cached, rest = {}, {}
        with _tr.trace_span("pipeline.const_lookup", feeds=len(stacked)):
            for n, v in stacked.items():
                dev = self.const_cache.lookup(n, v, device=self._device,
                                              shape=np.shape(v)) \
                    if self.const_cache.is_const(n) else None
                if dev is not None:
                    cached[n] = dev
                else:
                    rest[n] = v
        out, nbytes = self._to_device(rest)
        for n in out:
            if self.const_cache.is_const(n):
                self.const_cache.store(n, stacked[n], out[n])
        out.update(cached)
        return WindowFeed(out, len(buf)), nbytes

    def _emit(self, item, nbytes, t0, batches, k: int = 1) -> bool:
        """Wait (in THIS thread) until the copies are done, record the H2D
        telemetry (one observation per hand-off unit), hand off with the
        copies' event; False if the consumer went away."""
        from ..observe.families import (PIPELINE_H2D_BYTES,
                                        PIPELINE_H2D_SECONDS)

        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
            # the histogram records real transfer latency, not an
            # asynchronous hand-off
            event.synchronize()
        PIPELINE_H2D_SECONDS.observe(time.perf_counter() - t0)
        PIPELINE_H2D_BYTES.inc(nbytes)
        batches.inc(k)
        return self._put((item, event))

    def _flush_ragged(self, buf, batches) -> bool:
        """Hand a partial window's batches off individually (per-step
        conversion — the pipelined loop's ragged fallback path)."""
        for feed in buf:
            t0 = time.perf_counter()
            with _tr.trace_span("pipeline.prefetch"):
                dev, nbytes = self._convert(feed)
                if not self._emit(dev, nbytes, t0, batches):
                    return False
        return True

    def _fill(self):
        from ..observe.families import DATA_BATCHES

        batches = DATA_BATCHES.labels(source="device_prefetcher")
        try:
            it = self._reader() if callable(self._reader) \
                else iter(self._reader)
            with _tr.attach(self.trace_ctx):
                win = 1
                buf: list = []    # host batches awaiting a full window
                sig = None        # per-feed shape signature of the window
                for feed in it:
                    if self._stop.is_set():
                        return
                    # fault-injection site, once per batch pulled: an
                    # injected raise lands in self._error and re-raises
                    # in the consumer, as a real reader failure does
                    fault_point("reader.next")
                    if self._window_resolver is not None:
                        k, src = self._window_resolver(feed)
                        win = max(1, int(k))
                        self.resolved_window = (win, src)
                        self._window_resolver = None
                    if win <= 1:
                        t0 = time.perf_counter()
                        with _tr.trace_span("pipeline.prefetch"):
                            dev, nbytes = self._convert(feed)
                            if not self._emit(dev, nbytes, t0, batches):
                                return
                        continue
                    fsig = {n: np.shape(v) for n, v in feed.items()}
                    if buf and fsig != sig:
                        # a shape change breaks the window in progress:
                        # the buffered batches go per step (stacking
                        # never mixes shapes)
                        if not self._flush_ragged(buf, batches):
                            return
                        buf = []
                    sig = fsig
                    buf.append(feed)
                    if len(buf) == win:
                        t0 = time.perf_counter()
                        with _tr.trace_span("pipeline.prefetch",
                                            window=win):
                            wf, nbytes = self._convert_window(buf)
                            if not self._emit(wf, nbytes, t0, batches,
                                              win):
                                return
                        buf = []
                # ragged final window: the reader ran dry mid-window
                if buf and not self._flush_ragged(buf, batches):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._error = e
        finally:
            self._put((_END, None))

    # ---------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        # NOT a generator: the single-use check must fire at iter() time
        # (run_pipelined's eager-validation contract), not at first next()
        if self._closed:
            # the _END sentinel is consumed by the first pass, so a second
            # one would block in q.get() forever — fail fast instead
            raise RuntimeError(
                "DevicePrefetcher is single-use: it was already closed or "
                "fully consumed; construct a new one per epoch")
        if not self._started:
            require_device(self._device)
            if self._device.type == "cuda":
                self._stream = torch.cuda.Stream(self._device)
            self._started = True
            self._thread.start()
        return self._consume()

    def _consume(self) -> Iterator[Dict[str, Any]]:
        from ..observe import mark_batch_produced
        from ..observe.families import PIPELINE_PREFETCH_DEPTH

        try:
            while True:
                try:
                    item, event = self._q.get(timeout=0.1)
                except queue.Empty:
                    if self._stop.is_set():
                        return  # close()d from another thread mid-iteration
                    continue
                PIPELINE_PREFETCH_DEPTH.set(self._q.qsize())
                if item is _END:
                    if self._error is not None:
                        raise self._error
                    return
                if event is not None:
                    # the step reads the batch on this thread's stream:
                    # order it after the copy, and keep the allocator
                    # from reusing the memory before that stream is done
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(event)
                    for t in _tensors(item):
                        if t.device.type == "cuda":
                            t.record_stream(stream)
                # stamp at HAND-OFF (not host production): the executor's
                # feed->run gap then measures exactly the latency left on
                # the critical path
                mark_batch_produced()
                yield item
        finally:
            self.close()

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the fill thread and release queued batches. Idempotent;
        called automatically when iteration ends or is abandoned."""
        self._closed = True
        self._stop.set()
        if self._started:
            from ..reader import _drain

            # drain so a put-blocked producer wakes, sees stop, exits
            _drain(self._q)
            self._thread.join(timeout=timeout)
        from ..observe.families import PIPELINE_PREFETCH_DEPTH

        PIPELINE_PREFETCH_DEPTH.set(0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class FetchHandle:
    """Future over one dispatched step's (or window's) fetches.

    The executor hands these out WITHOUT waiting for the card: on the
    card ``fetches`` are copies still being made (pinned host tensors
    filled by a ``non_blocking`` copy, or device clones) and ``block_on``
    holds the event recorded after them; on the CPU the step has already
    run. ``result()`` materializes (and caches) the values — numpy when
    the dispatching call asked for it, with the FLAGS_check_nan_inf check
    applied at that point; ``wait()`` waits for the event without
    converting; ``done()`` polls. A handle with no fetches still waits on
    its step's event, so the in-flight window bounds dispatch.
    """

    __slots__ = ("step", "steps", "window", "fetch_names", "_fetches",
                 "_return_numpy", "_values", "_materialized",
                 "_completion", "_block_on", "_window_obs")

    def __init__(self, step: int, fetch_names: Sequence[str], fetches,
                 return_numpy: bool = True, completion=None, block_on=(),
                 steps: int = 1, window_obs=None, window=None):
        self.step = step
        # train steps this handle resolves: 1 for a per-step dispatch, K
        # for a window (step is then the window's LAST step index);
        # train_loop sums these
        self.steps = steps
        # the loop's RESOLVED window width K (>= 1): a ragged fallback
        # dispatch in a K > 1 loop carries steps=1, window=K
        self.window = steps if window is None else window
        self.fetch_names = tuple(fetch_names)
        self._fetches = list(fetches)
        self._return_numpy = return_numpy
        self._values = None
        self._materialized = False
        # (steady, site, t0) from _record_dispatch: the `complete` phase
        # is observed once, when the host first waits on this step
        self._completion = completion
        # the events recorded after the step's copies (the card) or
        # nothing (the CPU); released by the first wait
        self._block_on = block_on
        self._window_obs = window_obs

    def done(self) -> bool:
        return all(e.query() for e in self._block_on)

    def _record_complete(self) -> None:
        # no fetches -> no result the host waited for
        if self._completion is None or not self._fetches:
            return
        steady, site, t0 = self._completion
        self._completion = None
        from .executor import _record_completion

        dt = time.perf_counter() - t0
        _record_completion(steady, site, dt)
        if self._window_obs is not None:
            self._window_obs(dt)
            self._window_obs = None

    def wait(self) -> "FetchHandle":
        """Wait for the step's event, under the heartbeat's
        ``executor.wait`` stamp (a wedged card hangs here)."""
        from .executor import _wait_guard

        with _wait_guard(self.step):
            self._sync()
        return self

    def _sync(self) -> None:
        for e in self._block_on:
            e.synchronize()
        self._block_on = ()  # released once done
        self._record_complete()

    def result(self):
        """Wait and return the fetch values (numpy when the dispatching
        call used return_numpy=True). Idempotent. The wait and the copy
        to numpy run under one ``executor.wait`` heartbeat stamp."""
        if self._materialized:
            return self._values
        from .executor import _check_fetches_finite, _wait_guard, to_numpy

        with _wait_guard(self.step):
            self._sync()
            if self._return_numpy and self._fetches:
                out = [to_numpy(v) for v in self._fetches]
            else:
                out = list(self._fetches)
        if self._return_numpy and self._fetches:
            _check_fetches_finite(self.fetch_names, out,
                                  " at pipelined step %d" % self.step)
        self._values = out
        self._materialized = True
        self._fetches = out
        return out
