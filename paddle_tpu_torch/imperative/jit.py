"""``imperative.jit``: compile eager functions into cached Programs.

The port of paddle_tpu/imperative/jit.py. The decorator is the user
surface of the capture subsystem (``capture.py``): the FIRST call with a
given input signature runs the function eagerly — every ``trace_op``
dispatch ALSO records into a real ``Program`` — and subsequent calls
replay that Program through the Executor's plan, inheriting everything
the static tier built: shape/dtype verification with eager-source
provenance, the TV-checked pass pipeline, the plan cache, and the
inference ``Predictor``.

Replays: with ``exact_numerics=True`` (the default) the captured
program runs the executor's eager step, the eager dispatch sequence op
for op, so a replay is bitwise the eager call (losses, params and the
generator chain). With ``exact_numerics=False`` it runs at level 2 and,
on the card, as the plan's CUDA graph (core/cuda_graph.py): the fused
layer norm (K4) and the grouped optimizer update (K6) launch, and the
numbers agree with the eager ones to float tolerance. The JAX package's
``autotune=True`` (``PADDLE_TPU_CAPTURE_AUTOTUNE=1``) needs its
``kernels/autotune.py``, which the port has not (ROADMAP A7): asking for
it raises ``NotImplementedError``.

Cache discipline (the executor plan cache's rules, applied one level
up):

* keyed by input signature — bucketed shapes/dtypes + a fingerprint of
  the non-tensor arguments — PLUS ``passes.config_key()`` and
  ``kernels.config_key()``, so flipping an optimization knob re-captures
  instead of serving a stale plan;
* Python control flow = per-branch entries under one key: every
  ``bool()``/``int()``/``float()`` the trace forced on a captured value
  is recorded as a guard, replays re-evaluate the guards (a pruned
  slice of the program, throwaway scope) and a mismatch re-traces the
  new branch;
* dynamic batch via bucketed re-trace: the lead dim rounds up to a
  bucket (``PADDLE_TPU_CAPTURE_BUCKETS``), feeds pad and fetches slice
  back, and each NEW bucket is priced against the device HBM budget
  from the FIRST trace's ``MemoryAnalysis`` polynomials — no re-analysis,
  OOM-before-compile holds for eager code too;
* LRU capped by ``PADDLE_TPU_CAPTURE_CACHE_SIZE`` total entries,
  evictions counted in ``paddle_imperative_cache_evictions_total``.

RNG contract: under an active ``imperative.guard`` a replay seeds the
program's chain from the live ``Tracer`` generator and writes the
advanced generator back, so N captured steps advance params AND the RNG
chain bitwise identically to N eager steps (pinned in
tests/test_torch_imperative.py).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import VarBase, enabled as _eager_enabled
from .capture import CaptureContext, CaptureError, capturing
from ..core.executor import RNG_VAR, Executor
from ..core.scope import Scope
from ..observe import trace as _tr

__all__ = ["jit", "CapturedFunction"]


def _cache_cap() -> int:
    cap = int(os.environ.get("PADDLE_TPU_CAPTURE_CACHE_SIZE", "16"))
    if cap < 1:
        raise ValueError(
            "PADDLE_TPU_CAPTURE_CACHE_SIZE must be >= 1, got %d" % cap)
    return cap


def _env_buckets():
    spec = os.environ.get("PADDLE_TPU_CAPTURE_BUCKETS", "")
    if not spec:
        return None
    if spec == "pow2":
        return "pow2"
    try:
        out = sorted({int(tok) for tok in spec.split(",") if tok.strip()})
    except ValueError:
        raise ValueError(
            "PADDLE_TPU_CAPTURE_BUCKETS must be 'pow2' or comma-separated "
            "ints, got %r" % spec)
    if not out or any(b < 1 for b in out):
        raise ValueError(
            "PADDLE_TPU_CAPTURE_BUCKETS buckets must be >= 1, got %r" % spec)
    return out


def _bucket_lead(n: int, buckets) -> int:
    if buckets == "pow2":
        b = 1
        while b < n:
            b <<= 1
        return b
    for b in buckets:
        if b >= n:
            return b
    return n  # beyond the largest bucket: exact shape, no padding


def _pad_lead(arr, target: int):
    n = arr.shape[0]
    if n == target:
        return arr
    pad = torch.zeros((target - n,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    return torch.cat([arr, pad], dim=0)


class _Entry:
    """One captured (program, signature, branch) plan."""

    __slots__ = ("program", "fetch_names", "feed_order", "feed_shapes",
                 "feed_values", "state", "guards", "guard_prog",
                 "fetch_slice", "tuple_result", "trainable", "lead",
                 "predicted_bytes", "pass_stats")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class CapturedFunction:
    """An eager callable backed by a signature-keyed cache of captured
    Programs. Construct via :func:`jit`."""

    def __init__(self, fn, buckets=None, autotune: Optional[bool] = None,
                 cache_size: Optional[int] = None,
                 name: Optional[str] = None, exact_numerics: bool = True):
        self._fn = fn
        self.__name__ = name or getattr(fn, "__name__", "captured")
        self.__doc__ = getattr(fn, "__doc__", None)
        self._buckets = _env_buckets() if buckets is None else (
            buckets if buckets == "pow2" else sorted(set(buckets)))
        self._autotune = autotune
        self._exact = bool(exact_numerics)
        self._cap = _cache_cap() if cache_size is None else int(cache_size)
        if self._cap < 1:
            raise ValueError("cache_size must be >= 1, got %d" % self._cap)
        # key -> [entry, ...] (one per captured branch, MRU order)
        self._cache: "OrderedDict[Tuple, List[_Entry]]" = OrderedDict()
        self._n_entries = 0
        self._scope = Scope()
        self._exe = None  # on the guard's place, made at the first replay
        self._rng = None          # replay chain outside imperative.guard
        self._ma = None           # first trace's MemoryAnalysis (BytesPoly)
        self._last_entry: Optional[_Entry] = None
        self.stats = {"captures": 0, "hits": 0,
                      "retraces": {"shape": 0, "bucket": 0, "branch": 0,
                                   "config": 0}}

    # ------------------------------------------------------------- call
    def __call__(self, *args, **kwargs):
        tensors, layout, static_sig = self._split_args(args, kwargs)
        shape_sig = self._shape_sig(tensors)
        key = (shape_sig, static_sig, _config_sig())
        entries = self._cache.get(key)
        if entries is not None:
            self._cache.move_to_end(key)
            entry = self._match(entries, tensors)
            if entry is not None:
                return self._replay(entry, tensors)
            reason = "branch"
        else:
            reason = self._miss_reason(key)
        return self._trace(key, tensors, layout, kwargs, reason)

    # ------------------------------------------------------- signatures
    @staticmethod
    def _split_args(args, kwargs):
        """Positional tensors feed the graph; everything else (plus all
        kwargs) is static and fingerprints the cache key."""
        tensors: List[VarBase] = []
        layout: List[Any] = []
        statics: List[str] = []
        for a in args:
            if isinstance(a, VarBase):
                t = a
            elif isinstance(a, (np.ndarray, torch.Tensor)):
                t = VarBase(a, stop_gradient=True)
            else:
                layout.append(("s", a))
                statics.append(repr(a))
                continue
            layout.append(("t", len(tensors)))
            tensors.append(t)
        for k in sorted(kwargs):
            v = kwargs[k]
            if isinstance(v, (VarBase, np.ndarray, torch.Tensor)):
                raise TypeError(
                    "captured functions take tensor arguments positionally; "
                    "keyword %r is a tensor" % k)
            statics.append("%s=%r" % (k, v))
        return tensors, layout, tuple(statics)

    def _shape_sig(self, tensors) -> Tuple:
        sig = []
        for t in tensors:
            shape = tuple(t.shape)
            if shape and self._buckets is not None:
                shape = (_bucket_lead(shape[0], self._buckets),) + shape[1:]
            sig.append((shape, t.dtype))
        return tuple(sig)

    def _miss_reason(self, key) -> str:
        """Classify a cache miss for the retrace telemetry: the first
        capture ever is 'initial' (not a retrace); after that, a changed
        shape is 'bucket' (bucketing on) or 'shape', and an identical
        signature under different pass/kernel config is 'config'."""
        if not self._cache:
            return "initial"
        shape_sig, static_sig, config_sig = key
        for s, st, cf in self._cache:
            if st == static_sig and cf == config_sig:
                return "bucket" if self._buckets is not None else "shape"
        for s, st, cf in self._cache:
            if s == shape_sig and st == static_sig:
                return "config"
        return "shape"

    # ------------------------------------------------------------ trace
    def _trace(self, key, tensors, layout, kwargs, reason):
        import time

        from ..observe.families import (IMPERATIVE_CAPTURE_SECONDS,
                                        IMPERATIVE_CAPTURED_OPS,
                                        IMPERATIVE_CAPTURES,
                                        IMPERATIVE_RETRACES)

        if not _eager_enabled():
            raise CaptureError(
                "capturing %r needs an active imperative.guard() (the trace "
                "IS an eager execution)" % self.__name__)
        if self._want_autotune():
            self._tune()
        if reason != "initial":
            IMPERATIVE_RETRACES.labels(reason=reason).inc()
            self.stats["retraces"][reason] += 1
        shape_sig = key[0]
        lead = shape_sig[0][0][0] if shape_sig and shape_sig[0][0] else None
        # OOM-before-compile: a NEW bucket prices from the FIRST trace's
        # batch-size-free polynomials — no re-analysis, no compile
        predicted = self._price(lead)

        t0 = time.perf_counter()
        with _tr.trace_span("imperative.capture", fn=self.__name__,
                            reason=reason):
            ctx = CaptureContext(self.__name__)
            ctx.program.exact_numerics = self._exact
            feeds = []
            with capturing(ctx):
                for i, t in enumerate(tensors):
                    want = shape_sig[i][0]
                    v = t
                    if tuple(t.shape) != want:  # pad up to the bucket
                        v = VarBase(_pad_lead(t.value, want[0]), name=t.name,
                                    stop_gradient=t.stop_gradient)
                    ctx.register_feed(v, name=t.name)
                    feeds.append(v)
                call_args = [feeds[s[1]] if s[0] == "t" else s[1]
                             for s in layout]
                result = self._fn(*call_args, **kwargs)
            fetch_names = ctx.fetch_names_for(result)

        program = ctx.program
        from ..analysis import verify_program

        # capture-time validation: findings carry def_site provenance
        # pointing at the USER's eager lines (imperative/ is machinery)
        verify_program(program, fetch_list=fetch_names,
                       raise_on_error=True, site="capture")
        # level-2 TV-checked pass shakedown on a scratch clone: every
        # pass that claims a rewrite is translation-validated against
        # the capture. Speed-mode replays execute the executor's own
        # optimized clone; exact replays keep the unfused sequence and
        # this run is pure validation + the CLI's per-pass op counts.
        from ..core.passes import optimize_program

        scratch = Scope()
        for sname, sv in ctx.state.items():
            scratch.set_var(sname, sv.value)
        _, pass_stats = optimize_program(program, fetch_list=fetch_names,
                                         scope=scratch, level=2, tv=True)
        IMPERATIVE_CAPTURES.inc()
        IMPERATIVE_CAPTURE_SECONDS.observe(time.perf_counter() - t0)
        IMPERATIVE_CAPTURED_OPS.observe(len(program.global_block().ops))
        self.stats["captures"] += 1

        if self._ma is None:
            from ..analysis.memory import MemoryAnalysis

            try:
                self._ma = MemoryAnalysis(program, fetch_names,
                                          site="capture")
            except Exception:
                self._ma = None  # odd program: skip the budget guard
            if predicted is None:
                predicted = self._price(lead)

        entry = _Entry(
            program=program, fetch_names=fetch_names,
            feed_order=list(ctx.feed_order),
            feed_shapes=[tuple(v.shape) for v in feeds],
            feed_values={n: v.value
                         for n, v in zip(ctx.feed_order, feeds)},
            state=dict(ctx.state), guards=list(ctx.guards), guard_prog=None,
            fetch_slice=self._fetch_slices(result, lead),
            tuple_result=isinstance(result, (list, tuple)),
            trainable=bool(ctx.param_grads), lead=lead,
            predicted_bytes=predicted, pass_stats=pass_stats)
        self._insert(key, entry)
        self._last_entry = entry
        return self._slice_result(result, tensors, entry)

    def _price(self, lead) -> Optional[int]:
        if self._ma is None:
            return None
        from ..analysis.memory import device_budget

        predicted = int(self._ma.peak_bytes(lead if lead else 1))
        budget = device_budget()
        if budget is not None and predicted > budget:
            raise MemoryError(
                "captured %r at batch %s predicts peak %d bytes, over the "
                "device budget %d (PADDLE_TPU_DEVICE_HBM_BYTES) — refusing "
                "to compile; use a smaller bucket"
                % (self.__name__, lead, predicted, budget))
        return predicted

    @staticmethod
    def _fetch_slices(result, lead) -> List[bool]:
        vs = result if isinstance(result, (list, tuple)) else [result]
        return [bool(lead) and len(v.shape) >= 1 and v.shape[0] == lead
                for v in vs]

    def _slice_result(self, result, tensors, entry):
        """The trace ran on padded feeds; hand the caller values sliced
        back to the ACTUAL batch (replays slice the same way)."""
        n = tensors[0].shape[0] if tensors and tensors[0].shape else None
        if n is None or entry.lead is None or n == entry.lead:
            return result
        vs = result if isinstance(result, (list, tuple)) else [result]
        out = [VarBase(v.value[:n], stop_gradient=True) if sl else v
               for v, sl in zip(vs, entry.fetch_slice)]
        return type(result)(out) if entry.tuple_result else out[0]

    def _want_autotune(self) -> bool:
        if self._autotune is not None:
            return bool(self._autotune)
        return os.environ.get("PADDLE_TPU_CAPTURE_AUTOTUNE", "") == "1"

    def _tune(self) -> None:
        """The JAX package runs its unified predict-prune-measure
        autotuner (``kernels/autotune.py``) over the fresh capture; the
        port has no such tuner (ROADMAP A7), so this raises rather than
        ignore the request."""
        raise NotImplementedError(
            "imperative.jit(autotune=True) / PADDLE_TPU_CAPTURE_AUTOTUNE=1 "
            "needs the unified autotuner (kernels/autotune.py), which the "
            "port has not yet (ROADMAP A7)")

    # ---------------------------------------------------------- replay
    def _match(self, entries, tensors) -> Optional[_Entry]:
        for entry in entries:
            if not entry.guards:
                return entry
            vals = self._eval_guards(entry, tensors)
            if all(g.matches(v) for g, v in zip(entry.guards, vals)):
                return entry
        return None

    def _eval_guards(self, entry, tensors):
        """Current values of a branch's guard vars: a pruned slice of the
        captured program, run in a THROWAWAY scope on COPIES of state so
        neither the RNG chain nor donated buffers advance."""
        if entry.guard_prog is None:
            entry.guard_prog = entry.program._prune(
                [g.var_name for g in entry.guards])
        scope = Scope()
        for name, v in entry.state.items():
            scope.set_var(name, v.value.clone())
        scope.set_var(RNG_VAR, self._chain_key())
        feed = self._build_feed(entry, tensors)
        return self._executor().run(entry.guard_prog, feed,
                             [g.var_name for g in entry.guards],
                             scope=scope, return_numpy=True)

    def _build_feed(self, entry, tensors) -> Dict[str, Any]:
        feed = {}
        for name, t, shape in zip(entry.feed_order, tensors,
                                  entry.feed_shapes):
            arr = t.value
            if shape and arr.shape[0] != shape[0]:
                arr = _pad_lead(arr, shape[0])
            feed[name] = arr
        return feed

    def _executor(self):
        """The replay executor, on the active guard's place (the card
        outside a guard)."""
        from . import _device

        device = _device()
        if self._exe is None or self._exe.device != device:
            from ..core.place import CPUPlace, CUDAPlace

            self._exe = Executor(CPUPlace() if device.type == "cpu"
                                 else CUDAPlace(device.index or 0))
        return self._exe

    def _chain_key(self):
        from . import _tracer

        if _tracer is not None:
            return _tracer._rng
        if self._rng is None:
            self._rng = torch.Generator()
            self._rng.manual_seed(0)
        return self._rng

    def _store_chain(self, new_key) -> None:
        from . import _tracer

        if _tracer is not None:
            _tracer._rng = new_key
        else:
            self._rng = new_key

    def _replay(self, entry, tensors):
        from ..observe.families import IMPERATIVE_CACHE_HITS

        IMPERATIVE_CACHE_HITS.inc()
        self.stats["hits"] += 1
        self._last_entry = entry
        with _tr.trace_span("imperative.replay", fn=self.__name__):
            feed = self._build_feed(entry, tensors)
            for name, v in entry.state.items():
                self._scope.set_var(name, v.value)
            self._scope.set_var(RNG_VAR, self._chain_key())
            outs = self._executor().run(entry.program, feed,
                                        entry.fetch_names, scope=self._scope,
                                        return_numpy=False)
            # write-back: captured state flows to the SAME eager VarBases
            # the function closes over; the RNG chain advances in place
            for name, v in entry.state.items():
                nv = self._scope.find_var(name)
                if nv is not None:
                    v.value = nv
            self._store_chain(self._scope.find_var(RNG_VAR))
        n = tensors[0].shape[0] if tensors and tensors[0].shape else None
        wrapped = []
        for arr, sl in zip(outs, entry.fetch_slice):
            if sl and n is not None and arr.shape[0] != n:
                arr = arr[:n]
            wrapped.append(VarBase(arr, stop_gradient=True))
        return tuple(wrapped) if entry.tuple_result else wrapped[0]

    # ----------------------------------------------------------- cache
    def _insert(self, key, entry) -> None:
        from ..observe.families import IMPERATIVE_CACHE_EVICTIONS

        self._cache.setdefault(key, []).insert(0, entry)
        self._cache.move_to_end(key)
        self._n_entries += 1
        while self._n_entries > self._cap and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._n_entries -= len(old)
            IMPERATIVE_CACHE_EVICTIONS.inc(len(old))

    @property
    def cache_len(self) -> int:
        return self._n_entries

    @property
    def program(self):
        """The most recently used captured Program (None before any
        call) — the CLI / lint surface."""
        return self._last_entry.program if self._last_entry else None

    # -------------------------------------------------------- predictor
    def as_predictor(self, warmup_batch_sizes: Sequence[int] = ()):
        """Serve the captured program through ``serving``'s Predictor:
        inference-rewritten (is_test flips, dynamic batch fetch dims),
        state snapshotted into the predictor's own scope, outputs bitwise
        the eager function's."""
        entry = self._last_entry
        if entry is None:
            raise CaptureError(
                "call %r once (to capture) before as_predictor()"
                % self.__name__)
        if entry.trainable:
            raise CaptureError(
                "%r captured a backward/optimizer step; only inference "
                "captures can serve through Predictor" % self.__name__)
        from ..inference import Predictor

        return Predictor.from_program(
            entry.program, entry.feed_order, entry.fetch_names,
            {n: v.value.clone() for n, v in entry.state.items()},
            warmup_batch_sizes=warmup_batch_sizes,
            place=self._executor().place,
            batch_major_fetches=[n for n, sl in zip(entry.fetch_names,
                                                    entry.fetch_slice)
                                 if sl])


def jit(fn=None, *, buckets=None, autotune: Optional[bool] = None,
        cache_size: Optional[int] = None, name: Optional[str] = None,
        exact_numerics: bool = True):
    """Decorate an eager function into a :class:`CapturedFunction`.

    ``buckets``: lead-dim bucketing — a sorted int list or ``"pow2"``
    (default: ``PADDLE_TPU_CAPTURE_BUCKETS``; unset = exact shapes).
    ``autotune``: the JAX package runs its unified autotuner on each
    fresh capture (default: ``PADDLE_TPU_CAPTURE_AUTOTUNE=1``); the port
    has none and raises ``NotImplementedError`` when asked.
    ``cache_size``: total cached entries (default
    ``PADDLE_TPU_CAPTURE_CACHE_SIZE``, 16).
    ``exact_numerics`` (default True): replays run the eager dispatch
    sequence op for op, bitwise the eager calls; pass False for the
    level-2 pipeline and, on the card, the CUDA graph (fastest, numerics
    equal only to float tolerance).
    """
    def wrap(f):
        return CapturedFunction(f, buckets=buckets, autotune=autotune,
                                cache_size=cache_size, name=name,
                                exact_numerics=exact_numerics)

    return wrap(fn) if fn is not None else wrap


def _config_sig() -> Tuple:
    """Pass-pipeline + kernel-tier config fingerprint: the same key the
    executor plan cache carries, hoisted into the capture key so a knob
    flip re-captures instead of replaying a stale plan."""
    from ..core.passes import config_key as _passes_key
    from .. import kernels as _kernels

    return (_passes_key(), _kernels.config_key())
