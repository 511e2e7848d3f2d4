"""Executor: run a Program block on one device, on the card as a CUDA
graph.

The port's counterpart of paddle_tpu/core/executor.py. ``run`` prepares
a plan once per (program, version, optimizer and kernel-tier config,
feed signature, fetch names) — the reference's plan-cache key — and
keeps it in an LRU cache (``PADDLE_TPU_EXECUTOR_CACHE_SIZE``, 32):

1. ``verify_program`` on the user's program when
   ``PADDLE_TPU_VALIDATE=1``;
2. the optimizing pass pipeline (core/passes, ``PADDLE_TPU_OPTIMIZE``,
   level 2 by default, 0 bypasses) on a CLONE, skipped for
   ``exact_numerics`` and ``_pre_optimized`` programs;
3. the block analysis of the optimized program (``analyze_block``:
   feeds, read-only state, read-write state, write-only persistables,
   whether the block draws randomness) and its eager step, which runs
   each op's torch lowering in program order.

    inputs  = feed tensors + persistable state read from the Scope
    outputs = fetches (numpy, or tensors on the device under
              ``return_numpy=False``) + persistable state written back
              to the Scope

On the card, a plan of a program that is not ``exact_numerics`` runs
its eager step once, then is captured as a CUDA graph
(core/cuda_graph.py) and replayed by every later run: the counterpart
of the reference's ``jax.jit(step, donate_argnums=(2,))``. A replay
updates the scope's state tensors in place (the reference donates
them), so the scope keeps its tensor objects across steps; fetches are
copies. A plan that cannot be captured raises, naming the op; it never
falls back to eager runs. ``exact_numerics`` programs run their eager
step on the card, as the reference runs them unjitted, and the CPU
runs the eager step. So does a plan that holds, at any depth, an op
that reads a value on the host (the registry's ``host_sync``: a
``while`` loop's condition, ``py_func``, ``print_op``): such a step
cannot be captured, so it runs eagerly at every run, and on the card
``paddle_executor_uncaptured_plans_total{op}`` counts each such plan
and a warning names the op once per process. The eager step's ops return new tensors, written
back to the scope. The RNG chain lives in the scope between runs. The
graphs of one executor share one memory pool (core/cuda_graph.py).

``run_repeated`` runs K steps per call (on the card, K replays with no
host sync between them), identical to K ``run`` calls. With
``FLAGS_check_nan_inf`` (flags.py) a fetched float value that is not
finite raises ``FloatingPointError``. A ``CompiledProgram`` goes to its
mesh engine (parallel/engine.py), which runs this executor's machinery
with the mesh in every lowering context. Under
``Program.set_gradient_accumulation(k)`` a step runs the compute ops on
k slices of the feeds and the optimize-role ops once on the mean
gradients (``_accum_step``).

``run_pipelined`` and ``train_loop`` drive the same steps over a reader
(core/pipeline.py): a ``DevicePrefetcher`` copies batches to the card
on its own thread and stream, each step (or each window of K steps,
``steps_per_call``, core/window_tune.py) is enqueued without waiting for
the card, and its fetches come back as ``FetchHandle``s copied on the
compute stream; nothing waits for the card but a handle's ``wait`` and
the cap of ``max_in_flight`` unresolved handles. So the host's work for
step N+1 runs under step N's graph, and the values are bitwise those of
``run`` called once per batch.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observe import trace as _tr
from ..observe.families import REGISTRY as _METRICS
from ..profiler import RecordEvent
from .cuda_graph import StepGraph, StepTrace, state_changes
from .lowering import (LowerContext, as_torch_dtype, lower_block,
                       lower_ops, release_schedule)
from .place import Place, default_place, require_device
from .program import Program, Variable, default_main_program, op_effects
from .registry import get_op, has_op
from .scope import Scope, global_scope

__all__ = ["Executor", "add_feed_observer", "analyze_block",
           "feed_to_device", "feeds_to_device", "remove_feed_observer",
           "to_numpy", "unstack_singleton_feed", "validate_stacked_feeds"]

RNG_VAR = "@RNG_STATE@"

UNCAPTURED_PLANS = _METRICS.counter(
    "paddle_executor_uncaptured_plans_total",
    "Plans on the card that run eagerly at every run because they hold "
    "an op that reads a value on the host (a while loop's condition, "
    "py_func, print_op), by op type",
    labels=("op",))
_WARNED_UNCAPTURED: set = set()


class _Plan:
    """Prepared context for one (program, feed-signature) pair — the
    analog of the reference's ExecutorPrepareContext (executor.cc:362)
    and of the JAX package's ``_Plan``."""

    def __init__(self, feed_names, fetch_names, const_state, mut_state,
                 pure_written, needs_rng, step, exact, host_sync=()):
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.const_state = const_state      # read-only scope vars
        self.mut_state = mut_state          # read+written scope vars
        self.pure_written = pure_written    # written-only persistables
        self.needs_rng = needs_rng
        self.step = step  # the eager step (``analyze_block``)
        self.exact = exact  # exact_numerics: never captured
        # op types that read on the host, at any depth: never captured
        self.host_sync = list(host_sync)
        self.compiled_sigs = set()  # dispatch signatures already captured
        self.trace = None  # the first eager run's StepTrace on the card:
        #                    set once that run warmed the plan
        self.graph: Optional[StepGraph] = None  # the captured step

    def release(self) -> None:
        """Free the captured graph and its memory pool."""
        if self.graph is not None:
            self.graph.release()
            self.graph = None


class Executor:
    """User-facing executor. ``place=None`` means the card,
    ``CUDAPlace(0)``; pass ``CPUPlace()`` to run on the CPU. Resolving
    the place touches no device; ``run`` raises when the card is asked
    for and absent. ``cache_size`` caps the plan cache (LRU; default
    ``PADDLE_TPU_EXECUTOR_CACHE_SIZE``, 32): an evicted plan frees its
    CUDA graph. The plans' graphs share one memory pool (captured on one
    stream), which holds about the largest graph's temporaries, not
    their sum."""

    def __init__(self, place: Optional[Place] = None,
                 cache_size: Optional[int] = None):
        self.place = default_place() if place is None else place
        self.device = self.place.torch_device()
        if cache_size is None:
            cache_size = int(os.environ.get(
                "PADDLE_TPU_EXECUTOR_CACHE_SIZE", "32"))
        if cache_size < 1:
            raise ValueError("cache_size must be >= 1, got %d" % cache_size)
        self._cache_size = cache_size
        self._cache: "OrderedDict[Tuple, _Plan]" = OrderedDict()
        self._pool = None  # the graphs' memory pool, made at the first
        #                    capture
        self._stream = None  # the side stream every capture runs on

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ) -> List[Any]:
        """Run ``program`` on this executor's device. A feed is a numpy
        array (or anything ``np.asarray`` takes) or a ``torch.Tensor``,
        which moves to the device without a numpy round trip. Fetches
        come back as numpy arrays, or with ``return_numpy=False`` as
        tensors on the executor's device (the reference's device
        arrays); on the card both are copies, which no later step
        changes."""
        from ..compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            # a data-parallel program runs through its mesh engine
            return program._run(self, feed, fetch_list, scope, return_numpy)
        program, scope, feeds, fetch_names = self._args(
            program, feed, fetch_list, scope)
        plan = self._plan(program, feeds, fetch_names, scope)
        t0 = time.perf_counter()
        # the whole step under one profiler marker (the JAX package's)
        with RecordEvent("executor_run"):
            fetches, captured = self._step(plan, program, feeds, scope)
        _record_dispatch(plan, "run", "run", 1, time.perf_counter() - t0,
                         captured)
        return self._finish(plan, fetches, return_numpy, "")

    def run_repeated(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        steps: int = 1,
        return_numpy: bool = True,
        feed_stacked: bool = False,
        reduce_fetches: str = "last",
    ):
        """Run ``steps`` train iterations in one call: ``steps`` of the
        steps ``run`` takes, on the card replays of the plan's CUDA graph
        with no host sync between them (the counterpart of the
        reference's ``lax.scan`` over the step), with a stacked window's
        slices copied into the graph's feeds on the device.

        Semantics: identical to calling ``run`` ``steps`` times — state
        (params, optimizer slots) and the RNG chain advance exactly as
        in the unrolled sequence (dropout masks differ per iteration);
        returned fetches are the LAST step's. With ``feed_stacked=False``
        the same feed dict is re-used every step; with
        ``feed_stacked=True`` every feed value carries a leading
        ``steps`` axis and step i takes slice i. ``reduce_fetches=
        "mean"|"sum"`` aggregates float fetches across the K steps
        instead of returning the last step's values."""
        _check_reduce(reduce_fetches)
        if steps <= 1:
            if feed_stacked:
                feed = unstack_singleton_feed(feed)
            return self.run(program, feed, fetch_list, scope,
                            return_numpy=return_numpy)
        from ..compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            # data-parallel: the engine runs the K steps
            return program._run_repeated(self, feed, fetch_list, scope,
                                         steps, return_numpy, feed_stacked,
                                         reduce_fetches)
        if feed_stacked:
            validate_stacked_feeds(sorted(feed or {}),
                                   [feed[n] for n in sorted(feed or {})],
                                   steps)
        program, scope, feeds, fetch_names = self._args(
            program, feed, fetch_list, scope)
        step_feeds = ({n: t[0] for n, t in feeds.items()} if feed_stacked
                      else feeds)
        plan = self._plan(program, step_feeds, fetch_names, scope)
        t0 = time.perf_counter()
        with RecordEvent("executor_run_repeated[%d]" % steps):
            fetches, captured = self._k_steps(plan, program, feeds, scope,
                                              steps, feed_stacked,
                                              reduce_fetches)
        _record_dispatch(plan, ("run_repeated", steps, feed_stacked,
                                reduce_fetches), "run_repeated", steps,
                         time.perf_counter() - t0, captured)
        return self._finish(plan, fetches, return_numpy,
                            " after %d scanned steps" % steps)

    def _run_eager(self, program=None, feed=None, fetch_list=None,
                   scope=None, return_numpy=True):
        """``run`` through the plan's eager step, never its graph: what a
        replay is held against (tests/test_torch_cuda.py,
        chip_smoke.py)."""
        program, scope, feeds, fetch_names = self._args(
            program, feed, fetch_list, scope)
        plan = self._plan(program, feeds, fetch_names, scope)
        fetches, _ = self._step(plan, program, feeds, scope, eager=True)
        return self._finish(plan, fetches, return_numpy, "")

    # -------------------------------------------------------- pipelined
    def run_pipelined(
        self,
        program: Optional[Program] = None,
        reader=None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        max_in_flight: int = 2,
        prefetch_depth: Optional[int] = None,
        return_numpy: bool = True,
        const_feed_names: Sequence[str] = (),
        const_dedup: Optional[bool] = None,
        steps_per_call: Optional[int] = None,
        reduce_fetches: str = "last",
    ):
        """Overlapped step loop: a generator of ``FetchHandle``s.

        ``reader`` yields feed dicts (a zero-arg callable returning an
        iterable, an iterable, or an already-constructed
        ``DevicePrefetcher``). A background thread converts each batch
        and copies it to this executor's device (``prefetch_depth``
        batches ahead; on the card in pinned memory on its own stream),
        so the loop receives feeds already on the device; each step is
        enqueued without waiting for its results, so step N+1's host
        work (and its batch's copy) runs under step N's CUDA graph. The
        in-flight window (``max_in_flight``) bounds dispatched but
        unresolved steps: before dispatching past the cap, the OLDEST
        handle is waited on.

        Semantics are identical to calling ``run`` once per batch —
        state and the RNG chain advance the same way, fetch values are
        bitwise the same. Feeds repeated across steps (same ndarray
        object, or names in ``const_feed_names``) skip the copy through
        the const-feed dedup cache (``ConstFeedCache``). Pass
        ``const_dedup=False`` when the reader refills ONE preallocated
        ndarray in place each step.

        ``steps_per_call=K > 1``: the prefetch thread stacks K host
        batches (``reader.stack_feed_window``'s layout) into one
        ``WindowFeed`` with one copy per feed per window, and the loop
        runs them as ``run_repeated``'s K steps — K replays with no host
        sync between them (``prefetch_depth`` then counts windows). A
        caller-constructed ``DevicePrefetcher`` hands over per-step
        feeds, so the loop windows them with ``torch.stack``. Each
        window yields ONE handle whose values follow ``reduce_fetches``
        ("last" / "mean" / "sum" over the window's float fetches) and
        whose ``step`` is the window's LAST step index. A ragged window
        (reader ran dry, or a batch's shapes broke the window in
        progress) runs through the per-step path. ``steps_per_call=None``
        resolves automatically: ``PADDLE_TPU_STEPS_PER_CALL`` if set,
        else the tuned ``train_window`` winner for this (program, batch
        shape) when one exists (``core.window_tune``), else 1.

        Abandoning the generator (break / close) stops the prefetch
        thread and drains in-flight work.
        """
        from .pipeline import DevicePrefetcher

        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        if reader is None:
            raise ValueError("run_pipelined needs a reader of feed dicts")
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1, got %d"
                             % max_in_flight)
        _check_reduce(reduce_fetches)
        if steps_per_call is not None and int(steps_per_call) < 1:
            raise ValueError("steps_per_call must be >= 1, got %r"
                             % (steps_per_call,))
        if steps_per_call is None:
            # a malformed PADDLE_TPU_STEPS_PER_CALL raises HERE, with the
            # other argument validation, not from the fill thread
            from .window_tune import env_steps_per_call
            env_steps_per_call()
        require_device(self.device)
        if isinstance(reader, DevicePrefetcher):
            prefetcher = reader
            if prefetcher._closed:
                raise RuntimeError(
                    "DevicePrefetcher is single-use: it was already closed "
                    "or fully consumed; construct a new one per epoch")
            if prefetch_depth is not None \
                    and prefetch_depth != prefetcher._depth:
                raise ValueError(
                    "prefetch_depth=%d conflicts with the already-"
                    "constructed DevicePrefetcher(depth=%d); set depth "
                    "when constructing it" % (prefetch_depth,
                                              prefetcher._depth))
            if prefetcher._device != self.device:
                raise ValueError(
                    "DevicePrefetcher places feeds on %s but this "
                    "executor's place is %s; construct the prefetcher "
                    "with place=executor.place" % (prefetcher._device,
                                                   self.device))
            if const_dedup is not None \
                    and const_dedup != prefetcher._dedup_unmarked:
                raise ValueError(
                    "const_dedup=%r conflicts with the already-"
                    "constructed DevicePrefetcher(const_dedup=%r); set it "
                    "when constructing it" % (const_dedup,
                                              prefetcher._dedup_unmarked))
            if const_feed_names:
                prefetcher.const_cache.mark_constant(*const_feed_names)
        else:
            from .window_tune import resolve_steps_per_call

            prefetcher = DevicePrefetcher(
                reader, place=self.place, program=program,
                depth=2 if prefetch_depth is None else prefetch_depth,
                const_feed_names=const_feed_names,
                const_dedup=True if const_dedup is None else const_dedup,
                # the fill thread resolves K from the first host batch
                # (arg > env > tuned winner > 1) and, for K > 1, stacks
                # K batches into ONE WindowFeed
                window_resolver=lambda feed: resolve_steps_per_call(
                    program, feed, steps_per_call))
        # validation and the prefetcher are eager; only the loop is a
        # generator (iter() starts the fill thread, which must not run
        # for a generator that is never iterated)
        return self._pipelined_loop(program, prefetcher, fetch_list, scope,
                                    max_in_flight, return_numpy,
                                    steps_per_call, reduce_fetches)

    def _pipelined_loop(self, program, prefetcher, fetch_list, scope,
                        max_in_flight, return_numpy, steps_per_call=None,
                        reduce_fetches="last"):
        from ..observe import observe_feed_gap
        from ..observe.families import (PIPELINE_IN_FLIGHT,
                                        PIPELINE_OVERLAP_RATIO,
                                        PIPELINE_WAIT_SECONDS,
                                        PIPELINE_WINDOW_RAGGED,
                                        PIPELINE_WINDOW_SECONDS,
                                        PIPELINE_WINDOW_SIZE,
                                        PIPELINE_WINDOW_STEPS)
        from ..reader import stack_feed_window
        from .pipeline import FetchHandle, WindowFeed
        from .window_tune import WINDOW_OP, resolve_steps_per_call

        fetch_names = _fetch_names(fetch_list)
        window: deque = deque()
        blocked = 0.0
        step_i = 0
        t_loop = time.perf_counter()
        loop_ctx = None
        if _tr.trace_enabled():
            # ONE trace for the whole loop; the fill thread gets it by
            # explicit hand-off (pinned before iter() starts the thread)
            loop_ctx = _tr.current() or prefetcher.trace_ctx \
                or _tr.new_trace()
            if prefetcher.trace_ctx is None:
                prefetcher.trace_ctx = loop_ctx
        att = _tr.attach(loop_ctx)

        def wait_oldest():
            nonlocal blocked
            tw = time.perf_counter()
            with att, _wait_guard(step_i):
                window.popleft().wait()
            dt = time.perf_counter() - tw
            blocked += dt
            PIPELINE_WAIT_SECONDS.observe(dt)
            PIPELINE_IN_FLIGHT.set(len(window))

        def push(plan, fetches, steady, t0, steps, **kw):
            nonlocal step_i
            copies, events = self._handoff(fetches, return_numpy)
            handle = FetchHandle(step_i + steps - 1, plan.fetch_names,
                                 copies, return_numpy,
                                 completion=(steady, "run_pipelined", t0),
                                 block_on=events, steps=steps, **kw)
            window.append(handle)
            PIPELINE_IN_FLIGHT.set(len(window))
            step_i += steps
            return handle

        def dispatch_step(feeds):
            # ONE step, as run() takes it (also the ragged fallback)
            with att:
                _observe_feed(feeds)
                plan = self._plan(program, feeds, fetch_names, scope)
                t0 = time.perf_counter()
                fetches, captured = self._step(plan, program, feeds, scope)
                steady = _record_dispatch(plan, "run", "run_pipelined", 1,
                                          time.perf_counter() - t0,
                                          captured)
                return push(plan, fetches, steady, t0, 1, window=k or 1)

        def dispatch_window(stacked, kk, plan_feed):
            # run_repeated's K steps over a stacked window; ``plan_feed``
            # is a per-step-shaped feed keying the plan the per-step path
            # uses
            with att:
                _observe_feed(plan_feed)
                plan = self._plan(program, plan_feed, fetch_names, scope)
                t0 = time.perf_counter()
                fetches, captured = self._k_steps(
                    plan, program, stacked, scope, kk, True,
                    reduce_fetches)
                dt = time.perf_counter() - t0
                steady = _record_dispatch(
                    plan, ("run_repeated", kk, True, reduce_fetches),
                    "run_pipelined", kk, dt, captured)
                if steady:
                    PIPELINE_WINDOW_SECONDS.labels(
                        phase="dispatch").observe(dt)
                PIPELINE_WINDOW_STEPS.observe(kk)
                obs = PIPELINE_WINDOW_SECONDS.labels(
                    phase="complete").observe if steady else None
                return push(plan, fetches, steady, t0, kk, window_obs=obs)

        def note_k(kk, src):
            nonlocal k
            k = kk
            PIPELINE_WINDOW_SIZE.set(kk)
            if src == "tuned":
                from ..observe.families import KERNEL_DISPATCHES

                KERNEL_DISPATCHES.labels(
                    op=WINDOW_OP,
                    impl="cuda" if kk > 1 else "composed").inc()

        def flush_ragged(fs):
            # batches that never filled a window (reader dry, or a shape
            # change broke the window in progress), one step each
            for f in fs:
                if len(window) >= max_in_flight:
                    wait_oldest()
                PIPELINE_WINDOW_RAGGED.inc()
                yield dispatch_step(f)

        k = None          # resolved from the FIRST hand-off
        buf: list = []    # loop-side window (caller-supplied prefetcher)
        buf_sig = None    # per-feed shape signature of the open window
        feed_iter = iter(prefetcher)
        try:
            while True:
                if len(window) >= max_in_flight:
                    wait_oldest()
                feeds = next(feed_iter, None)
                if feeds is None:
                    yield from flush_ragged(buf)
                    buf = []
                    break
                observe_feed_gap()
                if isinstance(feeds, WindowFeed):
                    if k is None:
                        note_k(*prefetcher.resolved_window)
                    yield dispatch_window(
                        feeds.feeds, feeds.steps,
                        {n: v[0] for n, v in feeds.feeds.items()})
                    continue
                if k is None:
                    note_k(*(prefetcher.resolved_window or
                             resolve_steps_per_call(program, feeds,
                                                    steps_per_call)))
                if k == 1:
                    yield dispatch_step(feeds)
                    continue
                if prefetcher.resolved_window is not None:
                    # the prefetcher owns windowing: a per-step feed from
                    # it IS a ragged step
                    PIPELINE_WINDOW_RAGGED.inc()
                    yield dispatch_step(feeds)
                    continue
                # caller-supplied (unwindowed) prefetcher: window its
                # feeds, already on the device, loop-side
                sig = {n: tuple(np.shape(v)) for n, v in feeds.items()}
                if buf and sig != buf_sig:
                    yield from flush_ragged(buf)
                    buf = []
                buf_sig = sig
                buf.append(feeds)
                if len(buf) == k:
                    handle = dispatch_window(stack_feed_window(buf), k,
                                             buf[0])
                    buf = []
                    yield handle
        finally:
            prefetcher.close()
            # the drain waits count too: a loop with steps <=
            # max_in_flight never stalls IN the loop
            while window:
                tw = time.perf_counter()
                with att, _wait_guard(step_i):
                    window.popleft().wait()
                dt = time.perf_counter() - tw
                blocked += dt
                PIPELINE_WAIT_SECONDS.observe(dt)
            PIPELINE_IN_FLIGHT.set(0)
            wall = time.perf_counter() - t_loop
            if step_i and wall > 0:
                PIPELINE_OVERLAP_RATIO.set(max(0.0, 1.0 - blocked / wall))

    def train_loop(
        self,
        program: Optional[Program] = None,
        reader=None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        max_in_flight: int = 2,
        prefetch_depth: Optional[int] = None,
        return_numpy: bool = True,
        const_feed_names: Sequence[str] = (),
        const_dedup: Optional[bool] = None,
        on_step=None,
        steps_per_call: Optional[int] = None,
        reduce_fetches: str = "last",
    ):
        """Drive ``run_pipelined`` over the whole reader; returns
        ``(n_steps, last_fetch_values)``. ``on_step(step_i, values)`` is
        called per resolved DISPATCH in order — one call per step in the
        per-step loop, one call per window with ``steps_per_call=K > 1``
        (``step_i`` is then the window's last step index and ``values``
        follow ``reduce_fetches``). Resolution trails dispatch by the
        in-flight window, so the callback never serializes the
        pipeline; a var it replaces in the scope (``scope.set_var``) is
        honoured from the next step it has not yet been enqueued for.
        ``n_steps`` counts STEPS, not dispatches."""
        pending: deque = deque()
        last = None
        n = 0

        def _resolve(h):
            vals = h.result()
            if on_step is not None:
                on_step(h.step, vals)
            return vals

        for h in self.run_pipelined(
                program, reader, fetch_list, scope,
                max_in_flight=max_in_flight, prefetch_depth=prefetch_depth,
                return_numpy=return_numpy,
                const_feed_names=const_feed_names, const_dedup=const_dedup,
                steps_per_call=steps_per_call,
                reduce_fetches=reduce_fetches):
            n += h.steps
            pending.append(h)
            if len(pending) > max_in_flight:
                last = _resolve(pending.popleft())
        while pending:
            last = _resolve(pending.popleft())
        return n, last

    def _handoff(self, fetches, return_numpy):
        """A step's fetches as a ``FetchHandle`` holds them, and what it
        waits on. On the card: copies made on the compute stream now,
        before the next step is enqueued (a replay overwrites its
        outputs, K6/K7 update state in place) — into pinned host memory
        with ``return_numpy``, else device clones — and the event
        recorded after them. On the CPU the step has run: its tensors."""
        if self.device.type != "cuda":
            return list(fetches), _completion_probe(self.device)
        if return_numpy:
            out = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
                   for f in fetches]
            for o, f in zip(out, fetches):
                o.copy_(f, non_blocking=True)
        else:
            out = [f.clone() for f in fetches]
        return out, _completion_probe(self.device)

    def close(self):
        """Drop every cached plan, freeing their CUDA graphs and the
        graphs' memory pool."""
        for plan in self._cache.values():
            plan.release()
        self._cache.clear()
        self._pool = None

    # ------------------------------------------------------------ steps
    def _args(self, program, feed, fetch_list, scope):
        """The run's program, scope, feeds on the device and fetch
        names."""
        require_device(self.device)
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        _observe_feed(feed)
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        feeds = {n: feed_to_device(n, v, block.vars.get(n), self.device)
                 for n, v in (feed or {}).items()}
        return program, scope, feeds, fetch_names

    def _graphed(self, plan) -> bool:
        """Whether ``plan`` runs as a CUDA graph: on the card, unless its
        program is ``exact_numerics`` or holds a host-sync op."""
        return self.device.type == "cuda" and not plan.exact and \
            not plan.host_sync

    def _note_uncaptured(self, plan) -> None:
        """Count a new plan that a host-sync op keeps from being
        captured on the card, and name the op once per process."""
        if self.device.type != "cuda" or plan.exact or not plan.host_sync:
            return
        for op in plan.host_sync:
            UNCAPTURED_PLANS.labels(op=op).inc()
        new = [op for op in plan.host_sync if op not in _WARNED_UNCAPTURED]
        if new:
            import warnings

            _WARNED_UNCAPTURED.update(new)
            warnings.warn(
                "a plan holds %s, which read values on the host: it runs "
                "eagerly at every run and is never captured as a CUDA "
                "graph" % new, RuntimeWarning, stacklevel=3)

    def _step(self, plan, program, feeds, scope, eager=False):
        """One step of ``plan`` with state and the RNG chain written back
        to ``scope``: the eager step, or on the card from the plan's
        second run on (unless ``eager``) a replay of its graph. Returns
        (the fetched tensors, whether this step captured the graph); a
        replay's fetches are its output tensors, valid until the next
        replay of any graph of this executor."""
        chain = _chain(scope, program) if plan.needs_rng else None
        captured = False
        if not eager and self._graphed(plan) and \
                plan.trace is not None:
            captured = self._ensure_graph(plan, feeds, scope)
            graph = plan.graph
            graph.replay(feeds, chain)
            # the read-write state is the captured tensors the scope
            # already holds, updated in place
            for n in plan.pure_written:
                scope.set_var(n, graph.written[n])
            fetches = graph.fetches
        else:
            trace = StepTrace() if self._graphed(plan) else None
            state = {n: _require(scope, n)
                     for n in plan.const_state + plan.mut_state}
            with torch.no_grad():
                fetches, written = plan.step(feeds, state, chain,
                                             self.device, trace)
            for n in plan.mut_state + plan.pure_written:
                scope.set_var(n, written[n])
            if trace is not None:
                trace.pure = {n: (tuple(written[n].shape), written[n].dtype)
                              for n in plan.pure_written}
                plan.trace = trace
        if plan.needs_rng:
            scope.set_var(RNG_VAR, chain)
        return fetches, captured

    def _ensure_graph(self, plan, feeds, scope) -> bool:
        """Make ``plan.graph`` a capture of the scope's current state:
        keep it where only vars of the captured shapes were replaced
        (copied into the captured tensors), capture it anew on another
        scope, where a var's shape, dtype or device changed, or where
        the tuned table changed since the capture. Returns whether it
        captured."""
        from ..kernels import tune

        state = {n: _require(scope, n)
                 for n in plan.const_state + plan.mut_state}
        graph = plan.graph
        if graph is not None and graph.bound_to(scope) and \
                graph.tuned_epoch == tune.epoch():
            copy, recapture = state_changes(graph.state, state)
            if not recapture:
                graph.adopt(copy, state, scope)
                return False
        self._release(plan)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        try:
            plan.graph = StepGraph(plan.step, feeds, state, plan.mut_state,
                                   plan.trace, self.device, scope,
                                   self._pool, self._stream)
        finally:
            self._forget_unheld_pool()
        return True

    def _release(self, plan) -> None:
        plan.release()
        self._forget_unheld_pool()

    def _forget_unheld_pool(self) -> None:
        """Drop the pool's handle once no graph holds the pool: the
        allocator frees such a pool, and it cannot be captured into
        again (the next capture makes a new one)."""
        if not any(p.graph is not None for p in self._cache.values()):
            self._pool = None

    def _k_steps(self, plan, program, feeds, scope, steps, feed_stacked,
                 reduce_fetches):
        """K steps, each the step ``run`` takes (on the card the eager
        first run of a new plan, then replays), step i on slice i of a
        stacked window, float fetches summed on the device; nothing
        waits for the card. Non-float fetches report the last step's."""
        acc, captured = None, False
        for i in range(steps):
            sf = ({n: t[i] for n, t in feeds.items()} if feed_stacked
                  else feeds)
            fetches, cap = self._step(plan, program, sf, scope)
            captured |= cap
            if reduce_fetches == "last":
                acc = fetches
            elif acc is None:
                # a replay overwrites its outputs: keep copies
                acc = [f.clone() for f in fetches]
            else:
                acc = [o + n if n.is_floating_point() else n
                       for o, n in zip(acc, fetches)]
        if reduce_fetches == "mean":
            acc = [f / steps if f.is_floating_point() else f for f in acc]
        return acc, captured

    def _finish(self, plan, fetches, return_numpy, nan_suffix):
        """Shared run()/run_repeated() epilogue: numpy conversion and
        FLAGS_check_nan_inf, or on the card copies of the fetched
        tensors (a replay overwrites its outputs, and a state tensor is
        updated in place by the next step)."""
        if return_numpy:
            out = [to_numpy(v) for v in fetches]
            _check_fetches_finite(plan.fetch_names, out, nan_suffix)
            return out
        if self.device.type == "cuda":
            return [v.clone() for v in fetches]
        return list(fetches)

    def _prepare(self, program, feeds, fetch_names, scope):
        """A new plan for (program, feed signature, fetches)."""
        return _prepare(program, sorted(feeds), fetch_names, scope)

    def _plan(self, program, feeds, fetch_names, scope):
        """The cached plan for this run, prepared on a miss."""
        from ..observe.families import (EXECUTOR_CACHE_EVICTIONS,
                                        EXECUTOR_CACHE_HITS,
                                        EXECUTOR_CACHE_MISSES,
                                        EXECUTOR_PREPARE_SECONDS)

        key = _cache_key(program, feeds, fetch_names)
        plan = self._cache.get(key)
        if plan is not None:
            EXECUTOR_CACHE_HITS.inc()
            self._cache.move_to_end(key)
            return plan
        EXECUTOR_CACHE_MISSES.inc()
        t0 = time.perf_counter()
        plan = self._prepare(program, feeds, fetch_names, scope)
        EXECUTOR_PREPARE_SECONDS.observe(time.perf_counter() - t0)
        self._note_uncaptured(plan)
        self._cache[key] = plan
        while len(self._cache) > self._cache_size:
            _, old = self._cache.popitem(last=False)
            self._release(old)
            EXECUTOR_CACHE_EVICTIONS.inc()
        return plan


    def seed_plan(self, program: Program, feed, fetch_list,
                  scope: Optional[Scope] = None) -> bool:
        """Install a prepared plan for (program, feed signature, fetches)
        WITHOUT counting a plan-cache miss: the artifact cold-start path
        (paddle_tpu_torch/export). A loaded artifact seeds every covered
        signature, so its first real run is a cache HIT, and loading
        moves zero ``paddle_executor_cache_misses_total``. The CUDA graph
        stays lazy: the plan is captured at its second run, as every
        plan is. Seeding costs one analysis per signature. Returns True
        when a plan was installed, False when the signature was already
        cached."""
        from ..observe.families import (EXECUTOR_CACHE_EVICTIONS,
                                        EXECUTOR_PREPARE_SECONDS)

        require_device(self.device)
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        feeds = {n: feed_to_device(n, v, block.vars.get(n), self.device)
                 for n, v in (feed or {}).items()}
        key = _cache_key(program, feeds, fetch_names)
        if key in self._cache:
            return False
        t0 = time.perf_counter()
        plan = self._prepare(program, feeds, fetch_names, scope)
        EXECUTOR_PREPARE_SECONDS.observe(time.perf_counter() - t0)
        self._note_uncaptured(plan)
        self._cache[key] = plan
        while len(self._cache) > self._cache_size:
            _, old = self._cache.popitem(last=False)
            self._release(old)
            EXECUTOR_CACHE_EVICTIONS.inc()
        return True

def _chain(scope, program) -> torch.Generator:
    """A copy of the scope's RNG chain (seeded from the program's
    ``random_seed`` on the first run): the scope's generator is never
    advanced in place, so a scope snapshot (a dict of its values)
    replays the same step."""
    rng = torch.Generator()
    saved = scope.find_var(RNG_VAR)
    if saved is None:
        seed = program.random_seed if program.random_seed is not None else 0
        rng.manual_seed(int(seed))
    else:
        rng.set_state(saved.get_state())
    return rng


def _record_dispatch(plan, sig, site, steps, dt, captured):
    """Telemetry shared by run()/run_repeated(): count the steps and
    route the wall time — a call that captured the plan's graph lands
    in the compile histogram (the reference's first dispatch of a
    signature: jax trace + XLA compile), every other one in the run
    histogram's ``dispatch`` phase. Returns True for such a steady-state
    dispatch, whose ``complete`` observation belongs in the run
    histogram too."""
    from ..observe.families import (EXECUTOR_COMPILE_SECONDS,
                                    EXECUTOR_RUN_SECONDS, EXECUTOR_STEPS)

    EXECUTOR_STEPS.inc(steps)
    if captured:
        plan.compiled_sigs.add(sig)
        EXECUTOR_COMPILE_SECONDS.observe(dt)
        return False
    EXECUTOR_RUN_SECONDS.labels(site=site, phase="dispatch").observe(dt)
    return True


def _completion_probe(device):
    """What a handle waits on: on the card an event recorded on the
    compute stream after the step (and its fetches' copies), never a
    state tensor, which K6/K7 update in place at the next step; on the
    CPU nothing, the step having run by the time it returns."""
    if device.type != "cuda":
        return ()
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return (event,)


@contextlib.contextmanager
def _wait_guard(step=None):
    """The ``executor.complete`` trace span around a host wait on a
    step's results (the pipelined loop's window waits); nothing when
    tracing is off."""
    if not _tr.trace_enabled():
        yield
        return
    with _tr.trace_span("executor.complete", step=step):
        yield


def _record_completion(steady, site, dt):
    """The ``complete`` phase: dispatch start to results ready, observed
    when the host waits on a steady-state dispatch."""
    if not steady:
        return
    from ..observe.families import EXECUTOR_RUN_SECONDS

    EXECUTOR_RUN_SECONDS.labels(site=site, phase="complete").observe(dt)


def _check_fetches_finite(fetch_names, values, suffix=""):
    """FLAGS_check_nan_inf guard of the fetches; no-op when the flag is
    off."""
    from ..flags import get_flag

    if not get_flag("check_nan_inf"):
        return
    for name, v in zip(fetch_names, values):
        if np.issubdtype(v.dtype, np.floating) and \
                not np.isfinite(v).all():
            raise FloatingPointError(
                "NaN/Inf in fetched var %r%s "
                "(FLAGS_check_nan_inf)" % (name, suffix))


def validate_stacked_feeds(feed_names, feeds, steps):
    """feed_stacked contract: every feed carries a leading ``steps`` axis."""
    for n, f in zip(feed_names, feeds):
        shape = tuple(np.shape(f))
        if not shape or shape[0] != steps:
            raise ValueError(
                "feed_stacked=True: feed %r must carry a leading "
                "steps axis of %d (got shape %s) — stack K "
                "per-step batches with reader.stack_feed_window"
                % (n, steps, (shape,)))


def unstack_singleton_feed(feed):
    """steps<=1 with feed_stacked: a window of length 1 still carries the
    leading axis — validate it IS length 1 (a K>1 window with steps=1
    must raise, never silently train on slice 0) and drop it."""
    for n, v in (feed or {}).items():
        shape = tuple(np.shape(v))
        if not shape or shape[0] != 1:
            raise ValueError(
                "feed_stacked=True with steps=1: feed %r must carry a "
                "leading axis of 1 (got shape %s)" % (n, (shape,)))
    return {k: v[0] if hasattr(v, "ndim") else np.asarray(v)[0]
            for k, v in (feed or {}).items()}


def _check_reduce(reduce_fetches):
    if reduce_fetches not in ("last", "mean", "sum"):
        raise ValueError("reduce_fetches must be last|mean|sum; got %r"
                         % (reduce_fetches,))


def _cache_key(program, feeds, fetch_names):
    """The reference's plan-cache key: a plan prepared under one program
    version, optimizer config, kernel-tier config (the tier switch and
    the flash env knob), feed signature or fetch list never serves
    another."""
    from .. import kernels
    from .passes import config_key as optimizer_config_key

    sig = tuple(sorted((n, tuple(v.shape), str(v.dtype))
                       for n, v in feeds.items()))
    return (program._serial, program.version, optimizer_config_key(),
            kernels.config_key(), sig, tuple(fetch_names))


def _prepare(program: Program, feed_names, fetch_names, scope,
             mesh_kw=None):
    """Verify (under ``PADDLE_TPU_VALIDATE``), optimize on a clone, then
    analyze: the plan ``run`` caches. ``mesh_kw`` (the engine's mesh and
    axis names) goes to every op's lowering context."""
    from ..analysis import validation_enabled, verify_program
    from .passes import optimize_for_execution

    view = None if scope is None else _HostView(scope)
    if validation_enabled():
        # on the USER program, so findings carry its build-site
        # provenance; once per plan
        verify_program(program, fetch_list=fetch_names, scope=view,
                       raise_on_error=True, site="prepare")
    exact = bool(getattr(program, "exact_numerics", False))
    if not exact and not getattr(program, "_pre_optimized", False):
        program = optimize_for_execution(program, fetch_names, scope=view)
    return _Plan(*analyze_block(program, feed_names, fetch_names, scope,
                                mesh_kw),
                 exact=exact, host_sync=host_sync_ops(program))


class _HostView:
    """The scope as the pass pipeline reads it: the same names, each
    tensor value handed out as a host copy (made once, on first read).
    The copied passes and analyses read scope values with
    ``np.asarray`` (the quantize pass's weights and scales, the range
    engine, translation validation), which a CUDA tensor refuses."""

    def __init__(self, scope):
        self._scope = scope
        self._host: Dict[str, Any] = {}

    def has_var(self, name: str) -> bool:
        return self._scope.has_var(name)

    def find_var(self, name: str):
        if name not in self._host:
            v = self._scope.find_var(name)
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu()
            self._host[name] = v
        return self._host[name]

    def __getattr__(self, name):
        return getattr(self._scope, name)


def host_sync_ops(program: Program, block=None) -> List[str]:
    """The sorted op types of ``block`` (the global block by default)
    and its sub-blocks, at any depth, that read a value on the host
    (the registry's ``host_sync``)."""
    block = program.global_block() if block is None else block
    found = set()
    for op in block.ops:
        if has_op(op.type) and get_op(op.type).host_sync:
            found.add(op.type)
        if "sub_block" in op.attrs:
            found.update(host_sync_ops(
                program, program.block(op.attrs["sub_block"])))
    return sorted(found)


def analyze_block(program: Program, feed_names, fetch_names, scope,
                  mesh_kw=None):
    """Classify block vars into feeds / read-only state / read-write
    state / write-only persistables, and build the step function — the
    same classification as the JAX package's ``analyze_block``.

    Returns (feed_names, fetch_names, const_state, mut_state,
    pure_written, needs_rng, step) where
    ``step(feeds, state, rng, device, graph=None) -> (fetches,
    written)``; ``written`` maps every state name in mut_state +
    pure_written to its new value; ``graph`` is the lowering context's
    CUDA-graph hook (core/cuda_graph.py), None for a plain eager step;
    ``mesh_kw`` the mesh and axis names of the lowering context
    (``LowerContext``), under a ``ParallelEngine``.
    """
    block = program.global_block()
    feed_names = sorted(feed_names)

    produced = set(feed_names)
    external: List[str] = []
    needs_rng = False
    for op in block.ops:
        if not has_op(op.type):
            raise KeyError("op %r has no registered lowering" % op.type)
        if _op_uses_rng(program, op):
            needs_rng = True
        reads, writes = op_effects(program, op)
        for n in reads:
            if n not in produced and n not in external:
                external.append(n)
        produced.update(writes)

    written = []
    seen_w = set()
    for op in block.ops:
        for n in op_effects(program, op)[1]:
            if n in seen_w:
                continue
            var = block.vars.get(n)
            persist = (var is not None and var.persistable) or (
                var is None and scope.has_var(n))
            if persist:
                written.append(n)
                seen_w.add(n)

    for n in fetch_names:
        if n not in produced and n not in external:
            external.append(n)  # fetch straight from scope state

    missing = [n for n in external if not scope.has_var(n)]
    if missing:
        raise RuntimeError(
            "uninitialized variables %s: run the startup program first"
            % missing)

    mut_state = [n for n in external if n in seen_w]
    const_state = [n for n in external if n not in seen_w]
    pure_written = [n for n in written if n not in external]

    amp = bool(getattr(program, "amp", False))
    accum = int(getattr(program, "grad_accum_steps", 1))
    if accum > 1:
        step = _accum_step(block, feed_names, fetch_names, mut_state,
                           pure_written, amp, accum, mesh_kw or {})
        return (feed_names, fetch_names, const_state, mut_state,
                pure_written, needs_rng, step)

    # temporaries leave the env after their last reader, so the step's
    # peak memory is its live set, not every activation it ever made
    release = release_schedule(
        block.ops, set(fetch_names) | set(mut_state) | set(pure_written))

    def step(feeds, state, rng, device, graph=None):
        env: Dict[str, Any] = dict(state)
        env.update(feeds)
        ctx = LowerContext(block, rng, device, amp=amp, graph=graph,
                           **(mesh_kw or {}))
        lower_block(ctx, block, env, release)
        missing_f = [n for n in fetch_names if n not in env]
        if missing_f:
            raise KeyError(
                "fetch vars %s were not produced at the top level — a "
                "var internal to a recompute/control-flow sub-block "
                "cannot be fetched; fetch a segment output or disable "
                "recompute for this run" % missing_f)
        return ([env[n] for n in fetch_names],
                {n: env[n] for n in mut_state + pure_written})

    return (feed_names, fetch_names, const_state, mut_state, pure_written,
            needs_rng, step)


def _accum_step(block, feed_names, fetch_names, mut_state, pure_written,
                amp, k, mesh_kw):
    """The gradient-accumulation step (``Program.set_gradient_accumulation``):
    the compute ops (forward and backward) run on each of k microbatch
    slices of the feeds in turn, the gradients crossing into the
    optimize-role ops are averaged, and those ops run once. The JAX
    package's ``_accum_step`` (a ``lax.scan`` over the slices), the
    analog of the reference's ir/multi_batch_merge_pass.cc. The RNG chain
    runs on across the slices, as the scan carries it."""
    scan_ops = [op for op in block.ops
                if op.attrs.get("__op_role__") != "optimize"]
    apply_ops = [op for op in block.ops
                 if op.attrs.get("__op_role__") == "optimize"]
    written_scan = {n for op in scan_ops for n in op.output_names()}
    read_apply = {n for op in apply_ops for n in op.input_names()}
    # values flowing compute -> update (the gradients, and anything else
    # the apply side reads that the compute side makes)
    boundary = sorted(read_apply & written_scan)
    # only the backward-role outputs (the gradients) are averaged; other
    # crossing values keep their last slice's value
    grad_names = {n for op in scan_ops
                  if op.attrs.get("__op_role__") == "backward"
                  for n in op.output_names()}
    scan_fetch = [n for n in fetch_names
                  if n in written_scan and n not in boundary]
    scan_pure = [n for n in pure_written if n in written_scan]
    ys_names = boundary + scan_fetch + scan_pure

    def step(feeds, state, rng, device, graph=None):
        mb_feeds, mb_size = {}, None
        for name in feed_names:
            f = feeds[name]
            b = f.shape[0] if f.dim() else 0
            if f.dim() == 0 or b % k:
                raise ValueError(
                    "feed %r batch dim %s is not divisible by "
                    "gradient accumulation steps %d" % (name, b, k))
            mb_size = b // k
            mb_feeds[name] = f.reshape((k, mb_size) + tuple(f.shape[1:]))
        ctx = LowerContext(block, rng, device, amp=amp, graph=graph,
                           **mesh_kw)
        carried = dict(state)
        ys: Dict[str, List[Any]] = {n: [] for n in ys_names}
        for i in range(k):
            env = dict(carried)
            env.update((n, mb_feeds[n][i]) for n in feed_names)
            lower_ops(ctx, scan_ops, env)
            carried.update((n, env[n]) for n in mut_state if n in env)
            for n in ys_names:
                ys[n].append(env[n])
        env = dict(carried)
        env.update(feeds)  # the full batch, if the apply side reads one
        for name in ys_names:
            stacked = torch.stack(ys[name])
            # a per-example fetch concatenates back to the full batch; a
            # gradient (and a float fetch) is the slices' mean; anything
            # else keeps the last slice's value
            if name in scan_fetch and stacked.dim() >= 2 and \
                    stacked.shape[1] == mb_size:
                env[name] = stacked.reshape((-1,) + tuple(stacked.shape[2:]))
            elif name in grad_names or (name in scan_fetch
                                        and stacked.is_floating_point()):
                env[name] = torch.mean(stacked, dim=0)
            else:
                env[name] = stacked[-1]
        lower_ops(ctx, apply_ops, env)
        return ([env[n] for n in fetch_names],
                {n: env[n] for n in mut_state + pure_written})

    return step


def _op_uses_rng(program, op) -> bool:
    """Whether ``op`` draws randomness, recursing into its sub-block (a
    recompute segment's dropout)."""
    if get_op(op.type).uses_rng:
        return True
    if "sub_block" in op.attrs:
        return any(_op_uses_rng(program, s)
                   for s in program.block(op.attrs["sub_block"]).ops)
    return False


def _check_int32_range(name: str, lo: int, hi: int) -> None:
    info = np.iinfo(np.int32)
    if lo < info.min or hi > info.max:
        raise OverflowError(
            "feed %r has values in [%d, %d], outside the device int32 "
            "range [%d, %d]" % (name, lo, hi, info.min, info.max))


def feed_to_device(name: str, val, var, device: torch.device) -> torch.Tensor:
    """One feed to a tensor on ``device`` at its on-device dtype. int64
    ids narrow to int32 with an explicit range check, as in the JAX
    package (never a silent wraparound). A ``torch.Tensor`` moves (and
    casts) with ``.to`` wherever it lies, as the reference passes device
    arrays through with a device-side cast; anything else goes through
    numpy."""
    want = as_torch_dtype(var.dtype) if var is not None else None
    if isinstance(val, torch.Tensor):
        t = val
        if t.numel() and t.dtype == torch.int64:
            lo, hi = torch.aminmax(t)
            _check_int32_range(name, int(lo), int(hi))
            t = t.to(torch.int32)
        return t.to(device=device, dtype=want or t.dtype)
    return host_tensor(name, val, var).to(device)


def host_tensor(name: str, val, var) -> torch.Tensor:
    """The host half of ``feed_to_device`` for a value that is not a
    tensor: a CPU tensor at the feed's on-device dtype (int64 narrowed to
    int32 with the range check), which may share memory with ``val``."""
    want = as_torch_dtype(var.dtype) if var is not None else None
    arr = np.asarray(val)
    if arr.size and arr.dtype.kind in "iu" and arr.dtype.itemsize == 8:
        _check_int32_range(name, int(arr.min()), int(arr.max()))
        arr = arr.astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if want is None or t.dtype == want else t.to(want)


def feeds_to_device(feed: Dict[str, Any], var_lookup, device: torch.device,
                    stream=None):
    """A whole feed dict on ``device``, each value as ``feed_to_device``
    converts it (``var_lookup(name)`` gives its var, or None), for the
    ``DevicePrefetcher``'s thread. On the card a host value is converted
    on the host, staged in pinned memory and copied ``non_blocking`` on
    ``stream`` (the caller records an event after the copies and orders
    the step after it); on the CPU it is copied, so a reader may refill
    its buffer. Returns ``(dict, h2d_bytes)``: the bytes staged for the
    copy (a tensor already on ``device`` costs nothing)."""
    out: Dict[str, Any] = {}
    nbytes = 0
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        for n, v in feed.items():
            var = var_lookup(n)
            if isinstance(v, torch.Tensor):
                if v.device != device:
                    nbytes += v.numel() * v.element_size()
                out[n] = feed_to_device(n, v, var, device)
                continue
            host = host_tensor(n, v, var)
            nbytes += host.numel() * host.element_size()
            if device.type == "cuda":
                out[n] = host.pin_memory().to(device, non_blocking=True)
            else:
                out[n] = host.clone()
    return out, nbytes


# feed-observer hook: callables invoked with every raw feed dict an
# Executor converts (run, run_repeated, and each step of run_pipelined,
# which sees the prefetcher's tensors). Process-wide, like the default
# scope.
_FEED_OBSERVERS: List[Any] = []


def add_feed_observer(fn) -> None:
    """Register ``fn(feed_dict)`` to be called with every raw feed an
    executor in this process converts. Pair with
    ``remove_feed_observer``."""
    _FEED_OBSERVERS.append(fn)


def remove_feed_observer(fn) -> None:
    """Unregister a feed observer (no-op if not registered)."""
    try:
        _FEED_OBSERVERS.remove(fn)
    except ValueError:
        pass


def _observe_feed(feed) -> None:
    """Hand ``feed`` to the feed observers; an observer's exception
    propagates (a broken observer fails loudly)."""
    if feed and _FEED_OBSERVERS:
        for obs in list(_FEED_OBSERVERS):
            obs(feed)


def _fetch_names(fetch_list) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor as a host numpy array. numpy has no bfloat16 of
    its own: a bf16 tensor (an AMP fetch) comes back as an
    ``ml_dtypes.bfloat16`` array, bit for bit, as the JAX package's
    fetches do, where ``ml_dtypes`` is installed, and widened exactly to
    float32 where it is not."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _require(scope: Scope, name: str):
    v = scope.find_var(name)
    if v is None:
        raise RuntimeError("variable %r is not initialized in scope" % name)
    return v
