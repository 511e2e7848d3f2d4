"""Executor: run a Program block eagerly on one device.

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
   whether the block draws randomness).

A run then executes each op's torch lowering in program order instead
of tracing one XLA computation. There is no jit and no CUDA graph in
this version.

    inputs  = feed tensors + persistable state read from the Scope
    outputs = fetches (numpy, or tensors on the device under
              ``return_numpy=False``) + persistable state written back
              to the Scope

A training Program (``optimizer.minimize``) runs the same way: params,
optimizer moments, beta powers and a learning rate an op writes are
read-write state, written back after the step; grad vars are
temporaries, released after their last reader like any other. Ops
return new tensors, so the scope's tensors are never updated in place.
The RNG chain lives in the scope between runs.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .lowering import (LowerContext, as_torch_dtype, lower_block,
                       release_schedule)
from .place import Place, default_place, require_device
from .program import Program, Variable, default_main_program, op_effects
from .registry import get_op, has_op
from .scope import Scope, global_scope

__all__ = ["Executor", "analyze_block", "feed_to_device"]

RNG_VAR = "@RNG_STATE@"


class Executor:
    """User-facing executor. ``place=None`` means the card,
    ``CUDAPlace(0)``; pass ``CPUPlace()`` to run on the CPU. Resolving
    the place touches no device; ``run`` raises when the card is asked
    for and absent. ``cache_size`` caps the plan cache (LRU; default
    ``PADDLE_TPU_EXECUTOR_CACHE_SIZE``, 32)."""

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
        self._cache: "OrderedDict[Tuple, tuple]" = OrderedDict()

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
        arrays)."""
        require_device(self.device)
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        block = program.global_block()
        feeds = {n: feed_to_device(n, v, block.vars.get(n), self.device)
                 for n, v in (feed or {}).items()}
        (_, fetch_names, const_state, mut_state, pure_written, needs_rng,
         step) = self._plan(program, feeds, fetch_names, scope)
        rng = None
        if needs_rng:
            # a copy: the scope's generator is never advanced in place, so
            # a scope snapshot (a dict of its values) replays the same step
            rng = torch.Generator()
            saved = scope.find_var(RNG_VAR)
            if saved is None:
                seed = program.random_seed \
                    if program.random_seed is not None else 0
                rng.manual_seed(int(seed))
            else:
                rng.set_state(saved.get_state())
        state = {n: _require(scope, n) for n in const_state + mut_state}
        with torch.no_grad():
            fetches, written = step(feeds, state, rng, self.device)
        for n in mut_state + pure_written:
            scope.set_var(n, written[n])
        if needs_rng:
            scope.set_var(RNG_VAR, rng)
        if not return_numpy:
            return list(fetches)
        return [v.cpu().numpy() for v in fetches]

    def close(self):
        """Drop every cached plan."""
        self._cache.clear()

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
        plan = _prepare(program, sorted(feeds), fetch_names, scope)
        EXECUTOR_PREPARE_SECONDS.observe(time.perf_counter() - t0)
        self._cache[key] = plan
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
            EXECUTOR_CACHE_EVICTIONS.inc()
        return plan


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


def _prepare(program: Program, feed_names, fetch_names, scope):
    """Verify (under ``PADDLE_TPU_VALIDATE``), optimize on a clone, then
    analyze: the plan ``run`` caches."""
    from ..analysis import validation_enabled, verify_program
    from .passes import optimize_for_execution

    if validation_enabled():
        # on the USER program, so findings carry its build-site
        # provenance; once per plan
        verify_program(program, fetch_list=fetch_names, scope=scope,
                       raise_on_error=True, site="prepare")
    if not getattr(program, "exact_numerics", False) and \
            not getattr(program, "_pre_optimized", False):
        program = optimize_for_execution(program, fetch_names, scope=scope)
    return analyze_block(program, feed_names, fetch_names, scope)


def analyze_block(program: Program, feed_names, fetch_names, scope):
    """Classify block vars into feeds / read-only state / read-write
    state / write-only persistables, and build the step function — the
    same classification as the JAX package's ``analyze_block``.

    Returns (feed_names, fetch_names, const_state, mut_state,
    pure_written, needs_rng, step) where
    ``step(feeds, state, rng, device) -> (fetches, written)``; ``written``
    maps every state name in mut_state + pure_written to its new value.
    """
    block = program.global_block()
    feed_names = sorted(feed_names)

    produced = set(feed_names)
    external: List[str] = []
    needs_rng = False
    for op in block.ops:
        if not has_op(op.type):
            raise KeyError("op %r has no registered lowering" % op.type)
        if get_op(op.type).uses_rng:
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

    # temporaries leave the env after their last reader, so the step's
    # peak memory is its live set, not every activation it ever made
    release = release_schedule(
        block.ops, set(fetch_names) | set(mut_state) | set(pure_written))

    def step(feeds, state, rng, device):
        env: Dict[str, Any] = dict(state)
        env.update(feeds)
        ctx = LowerContext(block, rng, device)
        lower_block(ctx, block, env, release)
        missing_f = [n for n in fetch_names if n not in env]
        if missing_f:
            raise KeyError("fetch vars %s were not produced" % missing_f)
        return ([env[n] for n in fetch_names],
                {n: env[n] for n in mut_state + pure_written})

    return (feed_names, fetch_names, const_state, mut_state, pure_written,
            needs_rng, step)


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
    arr = np.asarray(val)
    if arr.size and arr.dtype.kind in "iu" and arr.dtype.itemsize == 8:
        _check_int32_range(name, int(arr.min()), int(arr.max()))
        arr = arr.astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=want or t.dtype)


def _require(scope: Scope, name: str):
    v = scope.find_var(name)
    if v is None:
        raise RuntimeError("variable %r is not initialized in scope" % name)
    return v
